// conv1x1_stats for Hopper (sm_90a): the first 1x1 of the bottleneck
// chain, W1 times x on tensor cores in 3xTF32, x streamed through a ring
// of asynchronous copies, y and its per-channel sums written by the same
// launch. Included by fused_block.cu.
//
// Replaces the Pallas body _k1_kernel of paddle_tpu/kernels/
// fused_block.py:568-585 (pallas_call at :790). For x [N, Cin, S] and W1
// [C, Cin]:
//   y[n] = W1 x[n], [N, C, S];
//   sum y and sum y^2 per channel, over n and s.
// That is M = C, K = Cin, N * S columns: bwd_apply3's product
// (bwd_apply3_tc.cuh) with one source of K and nothing done on landing.
//
// What bounds it on the H100 (batch 128; Cin, C, S = 256, 64, 3136 / 512,
// 128, 784 / 1024, 256, 196): x read once and y written once, 513.9 /
// 257.2 / 129.5 MB, 0.1534 / 0.0768 / 0.0387 ms at 3.35 TB/s. The product
// is 13.2 GFLOP at every stage, 0.197 ms at the 67 TFLOP/s float32 FMA
// rate; as three TF32 products, 39.5 GFLOP of tensor-core work, 0.0797 ms
// at the 495 TFLOP/s dense TF32 rate. Bytes bound it at 56x56, operations
// at 28x28 and 14x14. The float32 SIMT kernel this replaces ran its FMAs
// on the CUDA cores (~27 TFLOP/s at 56x56), its loads through registers
// in front of each stage's FMAs.
//
// The design, bwd_apply3's without its second source, landing and mask:
// this kernel calls bwd_apply3_tc.cuh's Tile, Slot, copy_stage and
// product (a kernel template shared by both under a policy compiled
// bwd_apply3 to other SASS, so bwd_apply3 keeps its own kernel).
//   - A block owns BM rows of C and BN = 8192 / BM consecutive columns
//     j = n * S + p of N * S (a tile may hold the end of one image and the
//     start of the next, so S = 196 and 49 leave no column idle): 64 x 128
//     where C <= 64, else 128 x 64 (C = 256 takes two row tiles, adjacent
//     in the grid, so that the second meets x in L2): 3136 / 1568 / 784
//     blocks at the three stages. 8 warps, each 32 x 32.
//   - A = W1 at a row pitch lda, a stage's A rows 16-byte copies along K.
//     The wrapper passes W1 itself where C is a whole number of row tiles,
//     Cin % 16 == 0 and W1 is 16-byte aligned (at all three chain stages),
//     else one zero-padded copy a call: no copy of A is out of bounds.
//   - x streams 16 channels a stage through a ring of 3 in dynamic shared
//     memory, two stages ahead: 16-byte copies of 4 columns where S % 4 ==
//     0 and x is 16-byte aligned (the 4 columns then stay in one image),
//     4-byte copies otherwise; channels past Cin and columns past N * S
//     zero-filled. One barrier a stage: each thread waits for its own
//     copies, the barrier publishes the stage, and only then are the
//     copies of the stage two ahead issued, into the buffer read one stage
//     back.
//   - The product: mma.sync.aligned.m16n8k8.row.col in 3xTF32; each k8
//     step's three products of a tile go into a fresh fragment, added
//     into the float32 accumulators in float32 (the tensor cores truncate
//     as they accumulate; K reaches 1024 here).
//   - The epilogue: y = acc, written once (float2 where WIDE); each row's
//     partial sums of y and y * y (a thread's 8 columns in order, then the
//     row's threads in order) into part [2, C, T], T the column tiles;
//     finish_stats adds them in tile order. Results past C or past N * S
//     are dropped and add nothing. No atomics: two calls are
//     bit-identical.
//
// Registers (nvcc -Xptxas -v, sm_90a, CUDA 12.9): 126-128 a thread in the
// four instances (64- or 128-row tiles, 16- or 4-byte copies), the bound
// two blocks an SM set; no spills, no stack. Shared memory: 49,664 bytes
// a block at 64-row tiles, 52,736 at 128. The SASS holds 48 HMMA and no
// FFMA but the epilogue's 32 (sums of squares). Including
// bwd_apply3_tc.cuh also compiles bwd_apply3's four kernels into
// fused_block.cu's library, where nothing launches them.
//
// What holds it back (scripts/torch_conv1x1_stats_probe.py on an NVIDIA
// H100 80GB HBM3, 700.00 W, the run PERF.md row 17 names): 0.2839 /
// 0.2687 / 0.2626 ms at the three stages, 1.81 TB/s at 56x56 (0.54 of
// the bytes' bound), 139 / 147 / 150 TFLOP/s of TF32. Without the copies
// 16-18% faster; one TF32 product for three 25-34% faster; each mma
// replaced by integer work 9-14% slower. As in bwd_apply3 and the other
// 3xTF32 products, the instructions around the mma (the splits, the
// fragment reads) and the copies' issue and waits hold it, not the
// tensor pipe.
#pragma once

#include <climits>
#include <cstdint>

#include "bwd_apply3_tc.cuh"
#include "fused_block.cuh"

namespace {
namespace conv1x1_stats {

using bwd_apply3::aligned16;
using bwd_apply3::commit;
using bwd_apply3::copy_stage;
using bwd_apply3::kK;
using bwd_apply3::kRing;
using bwd_apply3::product;
using bwd_apply3::Slot;
using bwd_apply3::Tile;
using bwd_apply3::tile_rows;
using bwd_apply3::wait_prior;

// The ring and the row partials (no raw tile).
template <int BM>
constexpr int smem_bytes() {
  return (kRing * Tile<BM>::kStage + Tile<BM>::kRed) * (int)sizeof(float);
}

// Block (row tile blockIdx.x % tiles_m, column tile blockIdx.x / tiles_m):
// y there and its rows' partial sums into part [2, C, T].
template <int BM, bool WIDE>
__global__ void __launch_bounds__(kThreads, 2)
conv1x1_stats_tc_kernel(const float* __restrict__ x,
                        const float* __restrict__ w, float* __restrict__ y,
                        float* __restrict__ part, int Cin, int C, int S,
                        int NS, int lda, int T, int tiles_m) {
  using TL = Tile<BM>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / TL::kWN, wn = warp % TL::kWN;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (blockIdx.x % tiles_m) * BM, jt = blockIdx.x / tiles_m;
  const int j0 = jt * TL::kBN, stages = (Cin + kK - 1) / kK;
  float* red = smem + kRing * TL::kStage;
  auto buffer = [&](int s) { return smem + (s % kRing) * TL::kStage; };
  const Slot<BM, WIDE> sl(j0, Cin, C, S, NS);
  // K = Cin: every row of B is x's (copy_stage's second source unread)
  auto stage = [&](int s) {
    copy_stage<BM, WIDE>(buffer(s), s * kK, w, x, x, sl, m0, lda, Cin, Cin,
                         S);
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  // copies run kRing - 1 stages ahead: stage s + kRing - 1 refills the
  // buffer that stage s - 1 was read from, after the barrier that every
  // thread passes once its product of stage s - 1 is done
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < stages) stage(s);
    commit();
  }
  for (int s = 0; s < stages; ++s) {
    wait_prior<kRing - 2>();
    __syncthreads();
    if (s + kRing - 1 < stages) stage(s + kRing - 1);
    commit();
    product<BM>(acc, buffer(s), wm, wn, g, t);
  }

  // the offsets n * C * S + p of this thread's columns, -1 past N * S
  int off[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = j0 + 32 * wn + 8 * j + 2 * t + c;
      const int n = col / S;
      off[j][c] = col < NS ? n * C * S + (col - n * S) : -1;
    }
  constexpr int kSlots = 4 * TL::kWN;     // partials a row: wn, t
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int lr = 32 * wm + 16 * i + g + 8 * hr, m = m0 + lr;
      float s = 0.f, q = 0.f;
      if (m < C) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float v0 = acc[i][j][2 * hr], v1 = acc[i][j][2 * hr + 1];
          if (off[j][0] >= 0) {
            s += v0;
            q = fmaf(v0, v0, q);
          }
          if (off[j][1] >= 0) {
            s += v1;
            q = fmaf(v1, v1, q);
          }
          if constexpr (WIDE) {
            // S % 4 == 0: columns 2t and 2t + 1 lie in one image
            if (off[j][0] >= 0)
              *reinterpret_cast<float2*>(y + off[j][0] + m * S) =
                  make_float2(v0, v1);
          } else {
            if (off[j][0] >= 0) y[off[j][0] + m * S] = v0;
            if (off[j][1] >= 0) y[off[j][1] + m * S] = v1;
          }
        }
      }
      red[lr * kSlots + 4 * wn + t] = s;
      red[(BM + lr) * kSlots + 4 * wn + t] = q;
    }
  __syncthreads();
  if (tid < BM && m0 + tid < C) {
    float ts = 0.f, tq = 0.f;
#pragma unroll
    for (int e = 0; e < kSlots; ++e) {
      ts += red[tid * kSlots + e];
      tq += red[(BM + tid) * kSlots + e];
    }
    part[(long)(m0 + tid) * T + jt] = ts;
    part[((long)C + m0 + tid) * T + jt] = tq;
  }
}

// ---- launch ----------------------------------------------------------------

// What the wrapper computes: W1 at a row pitch lda, a multiple of 16 >=
// Cin, 16-byte aligned, its rows padded to whole tiles; T the column tiles
// of N * S; every offset inside an int; with wide, S % 4 == 0 and x, y
// 16-byte aligned.
bool grid_ok(const float* x, const float* w, const float* y, int N, int Cin,
             int C, int S, int lda, int T, int wide) {
  if (N <= 0 || Cin <= 0 || C <= 0 || S <= 0) return false;
  const long big = Cin > C ? Cin : C, bm = tile_rows(C), bn = 8192 / bm;
  const long tiles_m = (C + bm - 1) / bm, ns = (long)N * S;
  if (N * big * S >= INT_MAX || tiles_m * bm * lda >= INT_MAX) return false;
  if (lda % kK || lda < Cin || !aligned16(w)) return false;
  if (T != (ns + bn - 1) / bn || tiles_m * T >= INT_MAX) return false;
  return !wide || (S % 4 == 0 && aligned16(x) && aligned16(y));
}

template <int BM, bool WIDE>
int run(const float* x, const float* w, float* y, float* part, float* stats,
        int N, int Cin, int C, int S, int lda, int T, cudaStream_t s) {
  constexpr int bytes = smem_bytes<BM>();
  const cudaError_t e = cudaFuncSetAttribute(
      conv1x1_stats_tc_kernel<BM, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const int tiles_m = (C + BM - 1) / BM;
  conv1x1_stats_tc_kernel<BM, WIDE><<<tiles_m * T, kThreads, bytes, s>>>(
      x, w, y, part, Cin, C, S, N * S, lda, T, tiles_m);
  return finish_stats(part, stats, C, T, s);
}

int launch(const float* x, const float* w, float* y, float* part,
           float* stats, int N, int Cin, int C, int S, int lda, int T,
           int wide, cudaStream_t s) {
  if (tile_rows(C) == 64)
    return wide ? run<64, true>(x, w, y, part, stats, N, Cin, C, S, lda, T, s)
                : run<64, false>(x, w, y, part, stats, N, Cin, C, S, lda, T,
                                 s);
  return wide ? run<128, true>(x, w, y, part, stats, N, Cin, C, S, lda, T, s)
              : run<128, false>(x, w, y, part, stats, N, Cin, C, S, lda, T,
                                s);
}

}  // namespace conv1x1_stats
}  // namespace
