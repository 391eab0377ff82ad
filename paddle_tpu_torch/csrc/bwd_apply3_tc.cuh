// bwd_apply3 for Hopper (sm_90a): the last 1x1's transpose through bn3,
// one stacked product on tensor cores in 3xTF32 fed by a ring of
// asynchronous copies, its masked epilogue and bn2's sums in the same
// launch. Included by fused_block_bwd.cu, and by conv1x1_stats_tc.cuh for
// its Tile, Slot, copy_stage and product.
//
// Replaces the Pallas body _b1b_kernel of bwd_apply3 in
// paddle_tpu/kernels/fused_block.py:224-252 (pallas_call at :261). For
// g3 [N, Cin, S], a2 [N, C, S], bn2's affine sc2, sh2 [C] and bn3's
// backward folded through W3 into amat [C, Cin], bmat [C, C], v0 [C]:
//   h2 = relu(a2 * sc2 + sh2);
//   g2 = (amat g3 + bmat h2 + v0) where a2 * sc2 + sh2 > 0, else 0;
//   bn2's sum g2 and sum g2 * xhat2, xhat2 = a2 * inv2 - m2 * inv2.
// That is one product [amat | bmat] [g3; h2]: M = C, K = Cin + C, N * S
// columns.
//
// What bounds it on the H100 (batch 128; Cin, C, S = 256, 64, 3136 / 512,
// 128, 784 / 1024, 256, 196): the product is 16.4 GFLOP at every stage,
// 0.25 ms at the 67 TFLOP/s float32 FMA rate; as three TF32 products,
// 49.3 GFLOP of tensor-core work, 0.10 ms at the 495 TFLOP/s dense TF32
// rate. g3 and a2 read once and g2 written once: 617 / 308 / 154 MB,
// 0.18 / 0.09 / 0.05 ms at 3.35 TB/s. Bytes bound it at 56x56,
// operations at 28x28 and 14x14; in practice the 3xTF32 mma.sync
// products run at ~155-182 TFLOP/s (PERF.md, lesson 8), ~0.3 ms.
//
// The design:
//   - The stacked operand. The wrapper writes A = [amat | bmat] once a
//     call into a fresh [rows, lda] tensor, zero-padded to whole row
//     tiles and to whole 16-deep stages of K (82 KB-1.3 MB: it stays in
//     L2), so that every copy of A is one 16-byte cp.async from one
//     source, never out of bounds.
//   - A block owns BM rows of C and BN = 8192 / BM consecutive columns
//     j = n * S + p of N * S (a tile may hold the end of one image and
//     the start of the next): 64 x 128 where C <= 64, else 128 x 64 (C
//     = 256 takes two row tiles, adjacent in the grid, so the second
//     meets g3 and a2 in L2). 8 warps, each 32 x 32 (32 accumulators a
//     thread): a block of all 256 rows would need 64 accumulators a
//     thread and leave no room for two blocks an SM under 128 registers.
//   - K streams in stages of 16 through a ring of 3 in dynamic shared
//     memory, two stages ahead: A [BM][16] at a pitch of 20 floats and B
//     [16][BN] at a pitch of BN + 8 (8 mod 32), so that a fragment's 8
//     rows x 4 k (A) or 4 k x 8 columns (B) fall on 32 banks. B's row k
//     is g3's channel k for k < Cin and a2's channel k - Cin below K =
//     Cin + C (a stage that straddles Cin takes each row from its own
//     source), zero-filled past K; 16-byte copies of 4 columns where S %
//     4 == 0 (they stay in one image), 4-byte copies otherwise. Columns
//     past N * S are zero-filled and their results dropped.
//   - h2 built on landing: each thread waits for its own copies, turns
//     the a2 values it copied into h2 = relu_affine(a2) in place, once a
//     value, and keeps the raw a2 of the block's own BM channels in a
//     [BM][BN] tile for the epilogue; one barrier a stage publishes the
//     stage, and only then are the copies of the stage two ahead issued,
//     into the buffer read one stage back, which every thread has left
//     by that barrier. So a2 is read from memory once: the epilogue's
//     mask and xhat2 read the tile. (One stage ahead, as a ring of 2, or
//     three, as a ring of 4, was slower at 28x28 and 14x14:
//     scripts/torch_bwd_apply3_probe.py.)
//   - The product: mma.sync.aligned.m16n8k8.row.col in 3xTF32 with
//     conv3x3_tc.cuh's split, mma0 and mma; each k8 step's three products
//     of a tile go into a fresh fragment, added in float32 (the tensor
//     cores truncate as they accumulate).
//   - The epilogue: g2 = acc + v0 where positive(a2, sc2, sh2) (the plain
//     version's rounding), else 0, written once; each row's partial sums
//     of g2 and g2 * xhat2 (a thread's 8 columns in order, then the
//     row's threads in order) into part [2, C, T], T the column tiles;
//     finish_stats adds them in tile order. No atomics: two calls are
//     bit-identical.
//
// Registers (nvcc -Xptxas -v, sm_90a, CUDA 12.9): 128 a thread in each of
// the four instances (64- or 128-row tiles, 16- or 4-byte copies), the
// bound two blocks an SM set; no spills, no stack. Shared memory: 84,480
// bytes a block at 64-row tiles, 89,600 at 128.
//
// What holds it back (PERF.md, row 11; scripts/torch_bwd_apply3_probe.py):
// the product runs its mma at ~130-150 TFLOP/s of TF32, held back, as
// the other 3xTF32 products are, by the instructions around the mma (a
// build with each mma replaced by integer work is slower, not faster);
// a build without the copies is 15-18% faster: their issue and their
// waits are not all hidden under the product.
#pragma once

#include <climits>
#include <cstdint>

#include "conv3x3_tc.cuh"
#include "fused_block.cuh"

namespace {
namespace bwd_apply3 {

using conv3x3::commit;
using conv3x3::copy16;
using conv3x3::copy4;
using conv3x3::mma;
using conv3x3::mma0;
using conv3x3::split;

// Wait until at most N of this thread's groups of copies are in flight.
template <int N>
__device__ __forceinline__ void wait_prior() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr int kRing = 3;        // stages in the ring
constexpr int kK = 16;          // rows of K a stage: two k8 steps
constexpr int kAP = kK + 4;     // an A stage's row pitch: 20 floats

// The rows of C a block (64 where C <= 64, else 128).
__host__ __device__ inline int tile_rows(int C) { return C <= 64 ? 64 : 128; }

// A block's tile, BM rows x BN columns, and its shared memory: the ring,
// the raw a2 tile, the row partials.
template <int BM>
struct Tile {
  static constexpr int kBN = 8192 / BM;     // columns: 128 or 64
  static constexpr int kWM = BM / 32;       // warps along the rows: 2 or 4
  static constexpr int kWN = 8 / kWM;       // along the columns: 4 or 2
  static constexpr int kBP = kBN + 8;       // B's and the a2 tile's pitch
  static constexpr int kA = BM * kAP;       // floats of a stage's A
  static constexpr int kStage = kA + kK * kBP;
  static constexpr int kRed = 2 * BM * 4 * kWN;
  static constexpr int kFloats = kRing * kStage + BM * kBP + kRed;
  static constexpr int kBytes = kFloats * (int)sizeof(float);
};

// This thread's share of B's copies: column kCols * lane of the tile (4
// columns where WIDE, else 1) in rows row + kRows * e of each stage.
template <int BM, bool WIDE>
struct Slot {
  static constexpr int kCols = WIDE ? 4 : 1;
  static constexpr int kLanes = Tile<BM>::kBN / kCols;
  static constexpr int kRows = kThreads / kLanes;
  static constexpr int kCopies = kK / kRows;
  int lane, row, g3b, a2b;
  bool in;
  __device__ Slot(int j0, int Cin, int C, int S, int NS)
      : lane(threadIdx.x % kLanes), row(threadIdx.x / kLanes) {
    const int j = j0 + kCols * lane;
    in = j < NS;
    const int n = in ? j / S : 0, p = in ? j - n * S : 0;
    g3b = n * Cin * S + p;
    a2b = n * C * S + p;
  }
};

// The copies of the stage at K row k0 into st: A's rows m0 .. m0 + BM - 1
// at columns k0 .. k0 + 15 (16 bytes a copy), then this thread's B slots.
template <int BM, bool WIDE>
__device__ __forceinline__ void copy_stage(float* st, int k0,
                                           const float* __restrict__ amat,
                                           const float* __restrict__ g3,
                                           const float* __restrict__ a2,
                                           const Slot<BM, WIDE>& sl, int m0,
                                           int lda, int Cin, int K, int S) {
  using TL = Tile<BM>;
#pragma unroll
  for (int e = 0; e < BM * 4 / kThreads; ++e) {
    const int q = threadIdx.x + kThreads * e;
    copy16(st + (q >> 2) * kAP + 4 * (q & 3),
           amat + (m0 + (q >> 2)) * lda + k0 + 4 * (q & 3), true);
  }
  float* bs = st + TL::kA;
#pragma unroll
  for (int e = 0; e < Slot<BM, WIDE>::kCopies; ++e) {
    const int r = sl.row + Slot<BM, WIDE>::kRows * e, k = k0 + r;
    const bool ok = sl.in && k < K;
    const float* src = !ok     ? g3
                       : k < Cin ? g3 + (sl.g3b + k * S)
                                 : a2 + (sl.a2b + (k - Cin) * S);
    float* dst = bs + r * TL::kBP + Slot<BM, WIDE>::kCols * sl.lane;
    if constexpr (WIDE) {
      copy16(dst, src, ok);
    } else {
      if (ok)
        copy4(dst, src);
      else
        *dst = 0.f;
    }
  }
}

// This thread's landed a2 values of the stage at k0, turned into h2 in
// place; the raw values of channels m0 .. m0 + BM - 1 kept in the tile
// a2s [BM][kBP] for the epilogue.
template <int BM, bool WIDE>
__device__ __forceinline__ void land(float* st, float* a2s, int k0,
                                     const float* __restrict__ sc2,
                                     const float* __restrict__ sh2,
                                     const Slot<BM, WIDE>& sl, int m0,
                                     int Cin, int K) {
  using TL = Tile<BM>;
  using SL = Slot<BM, WIDE>;
  if (!sl.in) return;
#pragma unroll
  for (int e = 0; e < SL::kCopies; ++e) {
    const int r = sl.row + SL::kRows * e, k = k0 + r;
    if (k < Cin || k >= K) continue;
    const int c = k - Cin;
    const float sc = __ldg(sc2 + c), sh = __ldg(sh2 + c);
    float* v = st + TL::kA + r * TL::kBP + SL::kCols * sl.lane;
    const bool keep = c >= m0 && c < m0 + BM;
    float* raw = a2s + (c - m0) * TL::kBP + SL::kCols * sl.lane;
    if constexpr (WIDE) {
      const float4 a = *reinterpret_cast<const float4*>(v);
      if (keep) *reinterpret_cast<float4*>(raw) = a;
      *reinterpret_cast<float4*>(v) =
          make_float4(relu_affine(a.x, sc, sh), relu_affine(a.y, sc, sh),
                      relu_affine(a.z, sc, sh), relu_affine(a.w, sc, sh));
    } else {
      const float a = *v;
      if (keep) *raw = a;
      *v = relu_affine(a, sc, sh);
    }
  }
}

// acc += the products of one stage in 3xTF32. Warp (wm, wn) owns rows
// 32 wm + 16 i + {g, g + 8} and columns 32 wn + 8 j + {2 t, 2 t + 1} of
// the tile. A[m][k] = the stage's A rows, B[k][col] = its B rows.
template <int BM>
__device__ __forceinline__ void product(float (&acc)[2][4][4],
                                        const float* st, int wm, int wn,
                                        int g, int t) {
  using TL = Tile<BM>;
  const float* ap = st + (32 * wm + g) * kAP + t;
  const float* bp = st + TL::kA + t * TL::kBP + 32 * wn + g;
#pragma unroll
  for (int k = 0; k < kK; k += 8) {
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* a = ap + 16 * i * kAP + k;
      split(a[0], ab[i][0], as[i][0]);
      split(a[8 * kAP], ab[i][1], as[i][1]);
      split(a[4], ab[i][2], as[i][2]);
      split(a[8 * kAP + 4], ab[i][3], as[i][3]);
    }
#pragma unroll
    for (int j0 = 0; j0 < 4; j0 += 2) {
      uint32_t bb[2][2], bs[2][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float* b = bp + k * TL::kBP + 8 * (j0 + jj);
        split(b[0], bb[jj][0], bs[jj][0]);
        split(b[4 * TL::kBP], bb[jj][1], bs[jj][1]);
      }
      float f[2][2][4];
      // one pass a term, the small ones first
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          mma0(f[jj][i], as[i], bb[jj][0], bb[jj][1]);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          mma(f[jj][i], ab[i], bs[jj][0], bs[jj][1]);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma(f[jj][i], ab[i], bb[jj][0], bb[jj][1]);
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j0 + jj][r] += f[jj][i][r];
        }
    }
  }
}

// Block (row tile blockIdx.x % tiles_m, column tile blockIdx.x / tiles_m):
// g2 there and its rows' partial sums into part [2, C, T].
template <int BM, bool WIDE>
__global__ void __launch_bounds__(kThreads, 2)
bwd_apply3_kernel(const float* __restrict__ g3, const float* __restrict__ a2,
                  const float* __restrict__ sc2, const float* __restrict__ sh2,
                  const float* __restrict__ amat,
                  const float* __restrict__ v0, const float* __restrict__ inv2,
                  const float* __restrict__ m2, float* __restrict__ g2,
                  float* __restrict__ part, int Cin, int C, int S, int NS,
                  int lda, int T, int tiles_m) {
  using TL = Tile<BM>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / TL::kWN, wn = warp % TL::kWN;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (blockIdx.x % tiles_m) * BM, jt = blockIdx.x / tiles_m;
  const int j0 = jt * TL::kBN, K = Cin + C, stages = (K + kK - 1) / kK;
  float* a2s = smem + kRing * TL::kStage;
  float* red = a2s + BM * TL::kBP;
  auto buffer = [&](int s) { return smem + (s % kRing) * TL::kStage; };
  const Slot<BM, WIDE> sl(j0, Cin, C, S, NS);
  auto stage = [&](int s) {
    copy_stage<BM, WIDE>(buffer(s), s * kK, amat, g3, a2, sl, m0, lda, Cin,
                         K, S);
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
    land<BM, WIDE>(buffer(s), a2s, s * kK, sc2, sh2, sl, m0, Cin, K);
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
        const float b = __ldg(v0 + m), scm = __ldg(sc2 + m);
        const float shm = __ldg(sh2 + m), im = __ldg(inv2 + m);
        const float xs = -__ldg(m2 + m) * im;
        const float* ar = a2s + lr * TL::kBP + 32 * wn + 2 * t;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float av = ar[8 * j + c];
            v[c] = positive(av, scm, shm) ? acc[i][j][2 * hr + c] + b : 0.f;
            if (off[j][c] >= 0) {
              s += v[c];
              q = fmaf(v[c], fmaf(av, im, xs), q);
            }
          }
          if constexpr (WIDE) {
            // S % 4 == 0: columns 2t and 2t + 1 lie in one image
            if (off[j][0] >= 0)
              *reinterpret_cast<float2*>(g2 + off[j][0] + m * S) =
                  make_float2(v[0], v[1]);
          } else {
#pragma unroll
            for (int c = 0; c < 2; ++c)
              if (off[j][c] >= 0) g2[off[j][c] + m * S] = v[c];
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

inline bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

// What the wrapper computes: A at a row pitch lda, a multiple of 16 >=
// Cin + C, 16-byte aligned, its rows padded to whole tiles; T the column
// tiles of N * S; every offset inside an int; with wide, S % 4 == 0 and
// g3, a2, g2 16-byte aligned.
bool grid_ok(const float* g3, const float* a2, const float* amat,
             const float* g2, int N, int Cin, int C, int S, int lda, int T,
             int wide) {
  if (N <= 0 || Cin <= 0 || C <= 0 || S <= 0) return false;
  const long big = Cin > C ? Cin : C, bm = tile_rows(C), bn = 8192 / bm;
  const long tiles_m = (C + bm - 1) / bm, ns = (long)N * S;
  if (N * big * S >= INT_MAX || tiles_m * bm * lda >= INT_MAX) return false;
  if (lda % kK || lda < (long)Cin + C || !aligned16(amat)) return false;
  if (T != (ns + bn - 1) / bn || tiles_m * T >= INT_MAX) return false;
  return !wide ||
         (S % 4 == 0 && aligned16(g3) && aligned16(a2) && aligned16(g2));
}

template <int BM, bool WIDE>
int run(const float* g3, const float* a2, const float* sc2, const float* sh2,
        const float* amat, const float* v0, const float* inv2,
        const float* m2, float* g2, float* part, float* stats, int N,
        int Cin, int C, int S, int lda, int T, cudaStream_t s) {
  constexpr int bytes = Tile<BM>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      bwd_apply3_kernel<BM, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const int tiles_m = (C + BM - 1) / BM;
  bwd_apply3_kernel<BM, WIDE><<<tiles_m * T, kThreads, bytes, s>>>(
      g3, a2, sc2, sh2, amat, v0, inv2, m2, g2, part, Cin, C, S, N * S, lda,
      T, tiles_m);
  return finish_stats(part, stats, C, T, s);
}

int launch(const float* g3, const float* a2, const float* sc2,
           const float* sh2, const float* amat, const float* v0,
           const float* inv2, const float* m2, float* g2, float* part,
           float* stats, int N, int Cin, int C, int S, int lda, int T,
           int wide, cudaStream_t s) {
  if (tile_rows(C) == 64)
    return wide ? run<64, true>(g3, a2, sc2, sh2, amat, v0, inv2, m2, g2,
                                part, stats, N, Cin, C, S, lda, T, s)
                : run<64, false>(g3, a2, sc2, sh2, amat, v0, inv2, m2, g2,
                                 part, stats, N, Cin, C, S, lda, T, s);
  return wide ? run<128, true>(g3, a2, sc2, sh2, amat, v0, inv2, m2, g2,
                               part, stats, N, Cin, C, S, lda, T, s)
              : run<128, false>(g3, a2, sc2, sh2, amat, v0, inv2, m2, g2,
                                part, stats, N, Cin, C, S, lda, T, s);
}

}  // namespace bwd_apply3
}  // namespace
