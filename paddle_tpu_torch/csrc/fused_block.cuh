// What the bottleneck chain's forward (fused_block.cu) and backward
// (fused_block_bwd.cu) kernels share: the block size, the folded BN's
// ReLU and mask, the per-tile row partials of an epilogue and the
// fixed-order passes that add partials up (no atomics: every result is
// deterministic).
#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads a block

__device__ __forceinline__ float relu_affine(float v, float sc, float sh) {
  return fmaxf(fmaf(v, sc, sh), 0.f);
}

// The backward's mask, a * sc rounded, then + sh rounded, as the plain
// version takes it, so that both zero the same elements.
__device__ __forceinline__ bool positive(float a, float sc, float sh) {
  return __fadd_rn(__fmul_rn(a, sc), sh) > 0.f;
}

// An epilogue's two per-row partials: a block's threads put their (s, q)
// of local row lr into red [2][BM][16] (shared memory), 16 slots a row;
// store_row_partials then adds each row's slots in a fixed order into
// part [2, M, T] at tile column jt.
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

}  // namespace
