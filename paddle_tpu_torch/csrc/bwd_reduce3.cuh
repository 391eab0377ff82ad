// bwd_reduce3 for Hopper (sm_90a), float32: a split-K product fed by a
// ring of asynchronous copies. Included by fused_block_bwd.cu only.
//
// Replaces the Pallas body _b1a_kernel of bwd_reduce3 in
// paddle_tpu/kernels/fused_block.py:192. For dout, out [N, Cin, S] and a2
// [N, C, S] (K = N*S columns, k = n * S + p):
//   g3 = dout * (out > 0), written once;
//   P = sum_k g3 h2^T [Cin, C], h2 = relu(a2 * sc2 + sh2) recomputed;
//   sum_k g3 [Cin].
//
// What bounds it on the H100 (batch 128; Cin, C, S): 256, 64, 3136 reads
// 1.03 GB and writes 0.41 GB for 13.2 GFLOP, so bytes bound it (0.40 ms
// at 3.35 TB/s; 0.20 ms of float32 FMAs at 67 TFLOP/s); 512, 128, 784
// and 1024, 256, 196 move half those bytes for the same 13.2 GFLOP, so
// bytes and operations bound them about equally (0.20 ms each).
//
// The design:
//   - Tiles: 128 rows of Cin x BN columns of C, BN = 64 where C <= 64
//     (tall tiles: each column's a2 is read, and h2 recomputed, twice at
//     56x56), else 128. 256 threads, thread (ty, tx) = (tid / 16, tid %
//     16) owns rows ty + 16 i (i < 8) and columns tx + 16 j (j < BN /
//     16): an 8 x 8 micro-tile, 8 x 4 at BN 64.
//   - Stages 32 columns deep, in a ring of 4 in dynamic shared memory:
//     dout [128][36], out [128][36], a2 [BN][36] a stage, row-major along
//     k. A 36-float pitch keeps 16-byte rows aligned and puts 8
//     neighbouring rows on 8 distinct groups of 4 banks, so the
//     product's float4 reads along k (a row tx + 16 j a thread) and the
//     copies (8 threads a row's 128 bytes) are free of conflicts. A
//     transposed copy would cost a second pass through shared memory.
//   - cp.async.cg 16-byte copies, 4 neighbouring columns of one channel
//     (S % 4 == 0 keeps them inside one image); cp.async.ca 4-byte copies
//     per element where S % 4 != 0 or a pointer is not 16-byte aligned
//     (template flag WIDE). Columns past the split's end or past N*S, and
//     rows past Cin or C, are zero-filled through the copy's source size.
//   - Stage s + 2's copies start before stage s is computed; a thread
//     waits for its own copies of stage s (cp.async.wait_group 2), converts
//     them in place (g3 = out > 0 ? dout : 0, a select, bit-identical to
//     torch.where; h2 = relu_affine, 0 on zero-filled columns and rows),
//     and one barrier a stage publishes them. With 4 buffers and a
//     distance of 2, the buffer a copy refills was last read two stages
//     back, before the barrier the issuing thread has passed: one barrier
//     a stage suffices.
//   - In flight per SM (one block an SM): two stages, 2 x 40 KB at BN 64,
//     2 x 48 KB at BN 128 (the 36-float pitch's pad aside); the ring takes
//     180 KB / 216 KB of shared memory.
//   - The blocks of the first column tile store g3 (16-byte stores on the
//     wide path) and keep their rows' sums of g3, added over the 8
//     threads of a row by a fixed shuffle order.
//   - Splits of K = N*S, sized by the wrapper's _reduce3_grid: tiles x
//     splits at most one block an SM, in one wave; chunks a multiple of
//     the stage depth (splits_ok below). Each split writes its partial to
//     part[split] [Cin, C + 1]; finish_splits adds them in split order.
//     No atomics: two calls are bit-identical.
//
// Registers (nvcc -Xptxas -v, sm_90a, CUDA 12.8): 254 a thread at BN 128,
// 168 at BN 64, either copy width; no spills, no stack. The ring holds
// the block to one an SM in any case.
//
// What holds it back (PERF.md, row 10): 56x56 runs at ~1.3x its bound,
// device memory at ~2.5 TB/s. 28x28 and 14x14 run at ~2.1x: alone, the
// product takes ~0.29 ms (~45 TFLOP/s; an 8 x 8 micro-tile's 16 shared
// reads a 4-column step) and the copies with their conversion ~0.26-0.29
// ms, but together they contend for the SM's shared-memory pipe
// (scripts/torch_bwd_reduce3_probe.py). Giving the copies and
// conversions to 128 threads of their own beside the 256 of the
// product, on named barriers, was no faster.
#pragma once

#include <cstdint>

#include "fused_block.cuh"

namespace {
namespace reduce3 {

constexpr int kBM = 128;          // rows of Cin a tile
constexpr int kBK = 32;           // columns of K a stage
constexpr int kPitch = kBK + 4;   // floats a row of a stage tile
constexpr int kRing = 4;          // stages in the ring
constexpr int kAhead = 2;         // stages copied ahead of the one computed
constexpr int kRA = kBM / 32;     // rows of the Cin tile a thread copies

template <int BN>
struct Ring {
  static constexpr int kA = kBM * kPitch;   // dout (then g3), and out
  static constexpr int kStage = 2 * kA + BN * kPitch;
  static constexpr int kBytes = kRing * kStage * (int)sizeof(float);
};

// ---- asynchronous copies --------------------------------------------------
__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes, bypassing L1; zero-filled unless ok.
__device__ __forceinline__ void copy16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
// 4 bytes; zero-filled unless ok.
__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void wait_prior() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// ---------------------------------------------------------------------------

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// A thread's 4 columns k..k+3 of a stage: each one's channel-0 offset in
// [N, Cin, S] (x) and [N, C, S] (a) and whether it lies before ke. The
// wide path takes the 4 as one (S % 4 == 0: they share an image).
template <bool WIDE>
struct Cols {
  static constexpr int E = WIDE ? 1 : 4;
  long x[E], a[E];
  bool ok[E];
  __device__ __forceinline__ Cols(int k, int ke, int S, int Cin, int C) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int kk = k + e;
      ok[e] = kk < ke;
      const int n = ok[e] ? kk / S : 0;
      const int p = ok[e] ? kk - n * S : 0;
      x[e] = (long)n * Cin * S + p;
      a[e] = (long)n * C * S + p;
    }
  }
};

// The copies of one stage into buffer st: rows rq + 32 r, columns 4 kq..
template <int BN, bool WIDE>
__device__ __forceinline__ void copy_stage(float* st, const Cols<WIDE>& col,
                                           const float* __restrict__ dout,
                                           const float* __restrict__ out,
                                           const float* __restrict__ a2,
                                           int S, int Cin, int C, int m0,
                                           int n0, int rq, int kq) {
  float* D = st;
  float* O = st + Ring<BN>::kA;
  float* A = st + 2 * Ring<BN>::kA;
#pragma unroll
  for (int r = 0; r < kRA; ++r) {
    const int row = rq + 32 * r, m = m0 + row;
    const long rowoff = (long)(m < Cin ? m : 0) * S;
    const int off = row * kPitch + 4 * kq;
#pragma unroll
    for (int e = 0; e < Cols<WIDE>::E; ++e) {
      const bool ok = m < Cin && col.ok[e];
      const long src = ok ? col.x[e] + rowoff : 0;
      if constexpr (WIDE) {
        copy16(D + off, dout + src, ok);
        copy16(O + off, out + src, ok);
      } else {
        copy4(D + off + e, dout + src, ok);
        copy4(O + off + e, out + src, ok);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < BN / 32; ++r) {
    const int row = rq + 32 * r, c = n0 + row;
    const long rowoff = (long)(c < C ? c : 0) * S;
    const int off = row * kPitch + 4 * kq;
#pragma unroll
    for (int e = 0; e < Cols<WIDE>::E; ++e) {
      const bool ok = c < C && col.ok[e];
      const long src = ok ? col.a[e] + rowoff : 0;
      if constexpr (WIDE)
        copy16(A + off, a2 + src, ok);
      else
        copy4(A + off + e, a2 + src, ok);
    }
  }
}

__device__ __forceinline__ float masked(float o, float d) {
  return o > 0.f ? d : 0.f;
}

// A thread's own copies of a landed stage, converted in place: g3 over
// dout (the first column tile's blocks also store it and add it into rs),
// h2 over a2.
template <int BN, bool WIDE>
__device__ __forceinline__ void transform(float* st, const Cols<WIDE>& col,
                                          const float (&sc)[BN / 32],
                                          const float (&sh)[BN / 32],
                                          float (&rs)[kRA], bool first,
                                          float* __restrict__ g3, int S,
                                          int Cin, int C, int m0, int n0,
                                          int rq, int kq) {
  float* D = st;
  const float* O = st + Ring<BN>::kA;
  float* A = st + 2 * Ring<BN>::kA;
#pragma unroll
  for (int r = 0; r < kRA; ++r) {
    const int row = rq + 32 * r, m = m0 + row;
    const int off = row * kPitch + 4 * kq;
    const float4 d = ld4(D + off), o = ld4(O + off);
    const float4 g = make_float4(masked(o.x, d.x), masked(o.y, d.y),
                                 masked(o.z, d.z), masked(o.w, d.w));
    st4(D + off, g);
    if (first) {
      rs[r] += ((g.x + g.y) + g.z) + g.w;
      if (m < Cin) {
        const long mo = (long)m * S;
        if constexpr (WIDE) {
          if (col.ok[0]) st4(g3 + col.x[0] + mo, g);
        } else {
          const float v[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col.ok[e]) g3[col.x[e] + mo] = v[e];
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < BN / 32; ++r) {
    const int row = rq + 32 * r;
    const int off = row * kPitch + 4 * kq;
    const float4 v = ld4(A + off);
    bool ok[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ok[e] = n0 + row < C && col.ok[WIDE ? 0 : e];
    st4(A + off,
        make_float4(ok[0] ? relu_affine(v.x, sc[r], sh[r]) : 0.f,
                    ok[1] ? relu_affine(v.y, sc[r], sh[r]) : 0.f,
                    ok[2] ? relu_affine(v.z, sc[r], sh[r]) : 0.f,
                    ok[3] ? relu_affine(v.w, sc[r], sh[r]) : 0.f));
  }
}

// acc += G H^T over one stage: G [128][kPitch] (g3), H [BN][kPitch] (h2).
template <int TN>
__device__ __forceinline__ void product(float (&acc)[8][TN], const float* G,
                                        const float* H, int ty, int tx) {
#pragma unroll
  for (int k = 0; k < kBK; k += 4) {
    float4 a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = ld4(G + (ty + 16 * i) * kPitch + k);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float4 b = ld4(H + (tx + 16 * j) * kPitch + k);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
      }
    }
  }
}

// Block (tile, split): tile (tm, tn) of the split's partial part[split]
// [Cin, C + 1]; the blocks with tn == 0 write g3 and their rows' sums of
// g3 into column C.
template <int BN, bool WIDE>
__global__ void __launch_bounds__(kThreads, 1)
bwd_reduce3_kernel(const float* __restrict__ dout,
                   const float* __restrict__ out,
                   const float* __restrict__ a2, const float* __restrict__ sc2,
                   const float* __restrict__ sh2, float* __restrict__ g3,
                   float* __restrict__ part, int Cin, int C, int S, int NS,
                   int chunk, int tiles_m) {
  constexpr int TN = BN / 16, RB = BN / 32;
  extern __shared__ __align__(16) float ring[];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int rq = tid >> 3, kq = tid & 7;
  const int tn = blockIdx.x / tiles_m;
  const int m0 = (blockIdx.x % tiles_m) * kBM, n0 = tn * BN;
  const bool first = tn == 0;
  const int kb = blockIdx.y * chunk, ke = min(NS, kb + chunk);
  const int stages = (ke - kb + kBK - 1) / kBK;
  float sc[RB], sh[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int c = n0 + rq + 32 * r;
    sc[r] = c < C ? __ldg(sc2 + c) : 0.f;
    sh[r] = c < C ? __ldg(sh2 + c) : 0.f;
  }
  float rs[kRA];
#pragma unroll
  for (int r = 0; r < kRA; ++r) rs[r] = 0.f;
  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  auto buffer = [&](int s) { return ring + (s % kRing) * Ring<BN>::kStage; };
  auto fill = [&](int s) {
    if (s < stages)
      copy_stage<BN, WIDE>(buffer(s),
                           Cols<WIDE>(kb + s * kBK + 4 * kq, ke, S, Cin, C),
                           dout, out, a2, S, Cin, C, m0, n0, rq, kq);
    commit();
  };
#pragma unroll
  for (int s = 0; s < kAhead; ++s) fill(s);
  for (int s = 0; s < stages; ++s) {
    fill(s + kAhead);
    wait_prior<kAhead>();
    float* st = buffer(s);
    transform<BN, WIDE>(st, Cols<WIDE>(kb + s * kBK + 4 * kq, ke, S, Cin, C),
                        sc, sh, rs, first, g3, S, Cin, C, m0, n0, rq, kq);
    __syncthreads();
    product<TN>(acc, st, st + 2 * Ring<BN>::kA, ty, tx);
  }

  float* P = part + (long)blockIdx.y * Cin * (C + 1);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= Cin) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < C) P[(long)m * (C + 1) + c] = acc[i][j];
    }
  }
  if (first) {
#pragma unroll
    for (int r = 0; r < kRA; ++r) {
      float v = rs[r];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      const int m = m0 + rq + 32 * r;
      if (kq == 0 && m < Cin) P[(long)m * (C + 1) + C] = v;
    }
  }
}

// The splits of the wrapper's _reduce3_grid (kernels/fused_block.py):
// chunks a multiple of kBK that cover N*S exactly, each split non-empty.
bool splits_ok(long ns, int splits, int chunk) {
  return ns > 0 && ns < INT_MAX && chunk > 0 &&
         chunk % kBK == 0 && splits > 0 && splits <= 65535 &&
         (long)splits * chunk >= ns && (long)(splits - 1) * chunk < ns;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

template <int BN, bool WIDE>
int launch(const float* dout, const float* out, const float* a2,
           const float* sc2, const float* sh2, float* g3, float* part,
           float* red, int Cin, int C, int S, int NS, int splits, int chunk,
           cudaStream_t s) {
  constexpr int kBytes = Ring<BN>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      bwd_reduce3_kernel<BN, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles_m = (Cin + kBM - 1) / kBM;
  const int tiles = tiles_m * ((C + BN - 1) / BN);
  bwd_reduce3_kernel<BN, WIDE><<<dim3(tiles, splits), kThreads, kBytes, s>>>(
      dout, out, a2, sc2, sh2, g3, part, Cin, C, S, NS, chunk, tiles_m);
  return finish_splits(part, red, (long)Cin * (C + 1), splits, s);
}

}  // namespace reduce3
}  // namespace
