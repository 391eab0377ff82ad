// The tile machinery that the bottleneck chain's forward (fused_block.cu)
// and backward (fused_block_bwd.cu) kernels share: one tiled float32 SIMT
// product, out = A [M, K] x B [K, cols], 256 threads a block, each an
// 8 x 8 (or 4 x 8) micro-tile read from shared memory as float4, K
// advancing 8 deep through two shared-memory stages (conv1x1_stats'); the
// per-tile row partials of the epilogues and the fixed-order passes that
// add partials up (no atomics: every result is deterministic).
#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kBK = 8;         // depth of a k stage
constexpr int kBN = 128;       // columns of a conv kernel's tile

__device__ __forceinline__ float relu_affine(float v, float sc, float sh) {
  return fmaxf(fmaf(v, sc, sh), 0.f);
}

// The backward's mask, a * sc rounded, then + sh rounded, as the plain
// version takes it, so that both zero the same elements.
__device__ __forceinline__ bool positive(float a, float sc, float sh) {
  return __fadd_rn(__fmul_rn(a, sc), sh) > 0.f;
}

// Shared memory of a BM x BN tile: two stages of A [kBK][BM + 4] and of B
// [kBK][BN + 4] (the pad keeps the transposed stores free of bank
// conflicts); the epilogue reuses it for [2][BM][16] row partials.
template <int BM, int BN>
struct Smem {
  static constexpr int kA = kBK * (BM + 4);
  static constexpr int kB = kBK * (BN + 4);
  static constexpr int kStages = 2 * (kA + kB);
  static constexpr int kRed = 2 * BM * 16;
  static constexpr int kFloats = kStages > kRed ? kStages : kRed;
};

// Local row (column) of a thread's i-th micro-tile element: groups of 4
// rows 64 apart, so that 8 neighbouring threads read 128 contiguous bytes.
__device__ __forceinline__ int tile_pos(int i, int t) {
  return (i >> 2) * 64 + t * 4 + (i & 3);
}

// acc += As^T Bs over one kBK-deep stage.
template <int TM, int TN>
__device__ __forceinline__ void mma_stage(float (&acc)[TM][TN],
                                          const float* As, const float* Bs,
                                          int ty, int tx) {
  constexpr int BM = 16 * TM, BN = 16 * TN;
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    float a[TM], b[TN];
#pragma unroll
    for (int g = 0; g < TM / 4; ++g) {
      const float4 v =
          *reinterpret_cast<const float4*>(As + kk * (BM + 4) + g * 64 + ty * 4);
      a[4 * g] = v.x;
      a[4 * g + 1] = v.y;
      a[4 * g + 2] = v.z;
      a[4 * g + 3] = v.w;
    }
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const float4 v =
          *reinterpret_cast<const float4*>(Bs + kk * (BN + 4) + g * 64 + tx * 4);
      b[4 * g] = v.x;
      b[4 * g + 1] = v.y;
      b[4 * g + 2] = v.z;
      b[4 * g + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Loaders (fused_block.cu's). fetch(k0) reads stage k0 from device
// memory into registers; store(s) writes them to a stage buffer. A "row"
// loader fills a [rows][kBK] tile (thread: k offset tid & 7, rows tid >>
// 3 + 32 r) and stores it transposed, [kBK][rows + 4]; a "column" loader
// fills a [kBK][BN] tile (thread: one fixed column tid % BN, k offsets
// tid / BN + (256 / BN) r).

// acc = A B over k in [kb, ke), two shared-memory stages.
template <int TM, int TN, class LA, class LB>
__device__ __forceinline__ void mainloop(float (&acc)[TM][TN], LA& la, LB& lb,
                                         int kb, int ke, float* smem) {
  constexpr int BM = 16 * TM;
  using SM = Smem<BM, 16 * TN>;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float* As = smem;
  float* Bs = smem + 2 * SM::kA;
  la.fetch(kb);
  lb.fetch(kb);
  la.store(As);
  lb.store(Bs);
  __syncthreads();
  int buf = 0;
  for (int k0 = kb; k0 < ke; k0 += kBK) {
    const bool next = k0 + kBK < ke;
    if (next) {
      la.fetch(k0 + kBK);
      lb.fetch(k0 + kBK);
    }
    mma_stage<TM, TN>(acc, As + buf * SM::kA, Bs + buf * SM::kB, ty, tx);
    if (next) {
      la.store(As + (buf ^ 1) * SM::kA);
      lb.store(Bs + (buf ^ 1) * SM::kB);
    }
    __syncthreads();
    buf ^= 1;
  }
}

// The offsets n * M * S + p in an [N, M, S] tensor of a thread's TN tile
// columns (column j = n * S + p), and whether each is inside N * S.
template <int TN>
__device__ __forceinline__ void column_offsets(long (&off)[TN], bool (&ok)[TN],
                                               int j0, int M, int S, int NS) {
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int jg = j0 + tile_pos(j, tx);
    ok[j] = jg < NS;
    const int n = ok[j] ? jg / S : 0;
    off[j] = (long)n * M * S + (jg - n * S);
  }
}

// An epilogue's two per-row partials: put_row_partial stores a thread's
// (s, q) of its local row lr into red (2 * BM * 16 floats of shared
// memory, free once the mainloop has ended); store_row_partials then adds
// each row's 16 column threads in a fixed order into part [2, M, T] at
// tile column jt.
template <int BM>
__device__ __forceinline__ void put_row_partial(float* red, int lr, float s,
                                                float q) {
  const int tx = threadIdx.x & 15;
  red[lr * 16 + tx] = s;
  red[(BM + lr) * 16 + tx] = q;
}

template <int BM>
__device__ __forceinline__ void store_row_partials(float* __restrict__ part,
                                                   int M, int T, int m0,
                                                   int jt, const float* red) {
  const int tid = threadIdx.x;
  __syncthreads();
  if (tid < BM && m0 + tid < M) {
    float ts = 0.f, tq = 0.f;
    for (int t = 0; t < 16; ++t) {
      ts += red[tid * 16 + t];
      tq += red[(BM + tid) * 16 + t];
    }
    part[(long)(m0 + tid) * T + jt] = ts;
    part[((long)M + m0 + tid) * T + jt] = tq;
  }
}

// out[0][m] and out[1][m]: row m's T partials added in tile order (a warp
// a row, each lane a strided run, then the lanes in order).
__global__ void __launch_bounds__(kThreads)
chain_stats_final_kernel(const float* __restrict__ part, float* __restrict__ out,
                   int M, int T) {
  __shared__ float red[2][kThreads];
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  float s = 0.f, q = 0.f;
  if (m < M) {
    for (int t = lane; t < T; t += 32) {
      s += part[(long)m * T + t];
      q += part[((long)M + m) * T + t];
    }
  }
  red[0][threadIdx.x] = s;
  red[1][threadIdx.x] = q;
  __syncthreads();
  if (lane == 0 && m < M) {
    float ts = 0.f, tq = 0.f;
    for (int l = 0; l < 32; ++l) {
      ts += red[0][threadIdx.x + l];
      tq += red[1][threadIdx.x + l];
    }
    out[m] = ts;
    out[M + m] = tq;
  }
}

// out[e] = sum over the splits of part[split][e], in split order, eight
// splits' loads in flight at a time (a small E still spreads over many
// SMs: 64 threads a block).
constexpr int kSumThreads = 64;
__global__ void __launch_bounds__(kSumThreads)
split_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                 long E, int splits) {
  const long e = (long)blockIdx.x * kSumThreads + threadIdx.x;
  if (e >= E) return;
  float s = 0.f;
  int p = 0;
  for (; p + 8 <= splits; p += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = part[(long)(p + u) * E + e];
#pragma unroll
    for (int u = 0; u < 8; ++u) s += v[u];
  }
  for (; p < splits; ++p) s += part[(long)p * E + e];
  out[e] = s;
}

// Launches the fixed-order pass over a product's per-tile row partials
// (part [2, M, T] -> stats [2, M]), after checking the product's launch.
int finish_stats(const float* part, float* stats, int M, int T,
                 cudaStream_t s) {
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  chain_stats_final_kernel<<<(M + 7) / 8, kThreads, 0, s>>>(part, stats, M, T);
  return (int)cudaGetLastError();
}

// The same for split partials (part [splits, E] -> out [E]).
int finish_splits(const float* part, float* out, long E, int splits,
                  cudaStream_t s) {
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  split_sum_kernel<<<(int)((E + kSumThreads - 1) / kSumThreads), kSumThreads,
                     0, s>>>(part, out, E, splits);
  return (int)cudaGetLastError();
}

bool tiles_ok(int M, int N, int S, int T) {
  const long ns = (long)N * S;
  return M > 0 && N > 0 && S > 0 && ns < INT_MAX &&
         T == (int)((ns + kBN - 1) / kBN) && T <= 65535;
}

}  // namespace
