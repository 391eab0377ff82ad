// norm_relu_moments for Hopper (sm_90a): the Gram product of h =
// relu(a2 * scale + shift) on tensor cores in 3xTF32, a split-K product
// over the positions fed by a ring of asynchronous copies, each value
// normalized once as it lands. Included by fused_block.cu only.
//
// Replaces the Pallas body _moments_kernel of norm_relu_moments in
// paddle_tpu/kernels/fused_block.py:684-705 (pallas_call at :714). For
// a2 [N, C, S] and scale, shift [C]:
//   h = relu(a2 * scale + shift);
//   M2 = sum_{n,s} h h^T [C, C] and sum h [C],
// from which the chain folds bn3's statistics analytically.
//
// What bounds it on the H100 (batch 128; C, S = 64, 3136 / 128, 784 /
// 256, 196): a2 read once, 102.8 / 51.4 / 25.7 MB, 0.0307 / 0.0153 /
// 0.0077 ms at 3.35 TB/s. M2 is symmetric, so C (C + 1) / 2 products a
// position count: 1.65-1.67 GFLOP a stage, as three TF32 products ~5.0
// GFLOP, 0.0100 ms at the 495 TFLOP/s dense TF32 rate. Bytes bound it
// at 56x56 and 28x28, operations at 14x14; in practice the 3xTF32
// mma.sync products run at 110-182 TFLOP/s (PERF.md, lesson 8).
//
// The design, one launch and a fixed-order pass of the splits:
//   - A split-K product over K = the N * S positions, bwd_final's dW1
//     (bwd_final_tc.cuh) with h on both sides. K is cut into 32-column
//     pieces; a piece may straddle two images, so no position is wasted
//     at S = 196 or 49. Split p takes pieces [p * P / splits, (p + 1) *
//     P / splits) of P; the wrapper's _moments_grid sizes the splits so
//     that tiles x splits fill whole waves of two blocks an SM.
//   - Tiles of the upper triangle only: a block owns 64 rows r0 .. and
//     128 columns c0 .. of M2 (column tile ct takes the row tiles rt <=
//     2 ct + 1, the ones that reach its columns on or above the
//     diagonal) and one split. Its 32 x 32 warp tiles (2 x 4) that lie
//     on or above the diagonal and inside C are dealt out to the 8
//     warps in turn; where there are 3 or fewer (C <= 64, and the second
//     row tile of a diagonal tile) 2 warps share each (4 where there is
//     one), each taking every other k8 step, their accumulators added in
//     a fixed order at the end: more warps compute, spread over the SM's
//     four schedulers. A warp tile on the diagonal takes its B fragments
//     from its own A fragments (the same channels: B's n8 tile 2 i + e
//     is A's m16 tile i, rows e * 8 ..) and skips its two m16 x n8 tiles
//     below the diagonal.
//   - One staged h tile where the rows lie inside the columns (r0 >=
//     c0): the whole of C at C <= 128, and every row tile's diagonal
//     tile. There a2 is read once and both operands read the same
//     rows. Elsewhere a stage holds the 64 rows and the 128 columns.
//     Stages are [row][position] at a pitch of 36 floats (4 mod 32), so
//     that a fragment's 8 rows x 4 positions fall on 32 banks.
//   - Copies and normalization: a2 lands by cp.async in a ring of 3,
//     two stages ahead; 16-byte copies where S % 4 == 0 and a2 is
//     16-byte aligned (4 positions then stay in one image), 4-byte
//     copies otherwise. Each thread waits for its own copies and turns
//     them into h in place, once a value, before the stage's barrier (as
//     bwd_apply3 builds h2). Rows past C and columns past N * S stay 0
//     after normalization (zero-filled, never normalized: relu(0 *
//     scale + shift) = relu(shift) is not 0 where shift > 0).
//   - sum h: in each row tile's diagonal tile, the last warp, which
//     computes no warp tile there, adds up the tile's 64 rows of every
//     stage, a lane two rows, position after position.
//   - The products: mma.sync.aligned.m16n8k8.row.col in 3xTF32 with
//     conv3x3_tc.cuh's split, mma0 and mma; each k8 step's three
//     products of a tile go into a fresh fragment, added in float32 (the
//     tensor cores truncate as they accumulate).
//   - Sums: each split writes its partial M2, every entry above the
//     diagonal also at its mirror, and its row sums into part [splits,
//     C, C + 1]; finish_splits adds them in split order, so M2 comes
//     back exactly symmetric. No atomics: two calls are bit-identical.
//
// What it takes: any C >= 1 and N * S <= INT_MAX - 32 (the column of a
// piece's last position stays an int); every offset into a2 is a long.
//
// Registers (nvcc -Xptxas -v, sm_90a): 124 a thread with
// 16-byte copies, 120 with 4-byte ones, under the bound that two blocks
// an SM set; no spills, no stack. Shared memory: 82,944 bytes a block.
//
// What holds it back (PERF.md, row 15; scripts/
// torch_norm_relu_moments_probe.py): the products run their mma at
// 54-59 TFLOP/s of TF32, every stage alike, with 2-4 computing warps a
// scheduler: latency. Builds without the copies are 11-16% faster,
// without the normalization on landing 10-11%, without the stage's
// barrier 2-8%, with the splits' integer work left out 10-12%, with one
// TF32 product in place of three 21-29%; with each mma replaced by
// integer work 2-11% slower; with the eight fragments of a k8 step in
// flight at once no faster. Twice the splits: 12-13% slower.
#pragma once

#include <climits>
#include <cstdint>

#include "conv3x3_tc.cuh"
#include "fused_block.cuh"

namespace {
namespace moments {

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

constexpr int kRing = 3;                  // stages in the ring
constexpr int kTM = 64;                   // rows of M2 a tile
constexpr int kTN = 128;                  // columns of M2 a tile
constexpr int kK = 32;                    // positions a stage: a piece
constexpr int kPitch = 36;                // 4 mod 32: conflict-free fragments
constexpr int kStage = (kTM + kTN) * kPitch;
constexpr int kSmem = kRing * kStage * (int)sizeof(float);

__host__ __device__ inline int pieces(int NS) { return (NS + kK - 1) / kK; }

// The tiles of M2's upper triangle: column tile ct with row tiles 0 ..
// min(2 ct + 1, row tiles - 1), column tiles in order.
__host__ __device__ inline int tiles(int C) {
  const int tr = (C + kTM - 1) / kTM, tc = (C + kTN - 1) / kTN;
  int n = 0;
  for (int ct = 0; ct < tc; ++ct) n += 2 * ct + 2 < tr ? 2 * ct + 2 : tr;
  return n;
}

// Block b's tile and what a stage holds: rows 0 .. rows - 1, row r the
// channel r0 + r below lo (the tile's own 64 rows, staged apart) and hi
// + r from lo on (the columns, which hold the rows where shared).
struct Tile {
  int r0, c0, rows, lo, hi, a_off;
  bool shared;
  __device__ Tile(int b, int C) {
    const int tr = (C + kTM - 1) / kTM;
    int ct = 0;
    for (;;) {
      const int k = min(2 * ct + 2, tr);
      if (b < k) break;
      b -= k;
      ++ct;
    }
    r0 = b * kTM;
    c0 = ct * kTN;
    shared = r0 >= c0;
    lo = shared ? 0 : kTM;
    rows = lo + min(kTN, (C - c0 + 31) / 32 * 32);
    hi = c0 - lo;
    a_off = shared ? r0 - c0 : 0;   // the staged row of channel r0
  }
  __device__ __forceinline__ int channel(int r) const {
    return r < lo ? r0 + r : hi + r;
  }
};

// A thread's share of a stage: positions kCols * lane .. of rows row +
// kPass * e. WIDE: 16 bytes, 8 lanes a row; else 4 bytes, 32 lanes.
template <bool WIDE>
struct Lanes {
  static constexpr int kCols = WIDE ? 4 : 1;
  static constexpr int kLanes = kK / kCols;
  static constexpr int kPass = kThreads / kLanes;   // rows a pass: 32 or 8
  static constexpr int kPasses = (kTM + kTN) / kPass;
  static constexpr int kInner = (kTM + kTN) / 32;   // passes unrolled: 6
  __device__ __forceinline__ static int lane() {
    return threadIdx.x % kLanes;
  }
  __device__ __forceinline__ static int row() {
    return threadIdx.x / kLanes;
  }
};

// The copies of piece j (positions 32 j .. 32 j + 31 of N * S) into
// stage st, zero where the row's channel is past C or the position past
// N * S (written 0 by the thread where its copy is 4 bytes).
template <bool WIDE>
__device__ __forceinline__ void copy_piece(float* st, int j,
                                           const float* __restrict__ a2,
                                           const Tile& tl, int C, int S,
                                           int NS) {
  using L = Lanes<WIDE>;
  const int col = j * kK + L::kCols * L::lane();
  const bool in = col < NS;
  const int n = in ? col / S : 0;
  const long base = (long)n * C * S + (col - n * S);
#pragma unroll 1
  for (int e0 = 0; e0 < L::kPasses; e0 += L::kInner) {
#pragma unroll
    for (int e = e0; e < e0 + L::kInner; ++e) {
      if (L::kPass * e >= tl.rows) break;
      const int r = L::row() + L::kPass * e, ch = tl.channel(r);
      const bool ok = in && ch < C;
      const float* src = a2 + (ok ? base + (long)ch * S : 0);
      float* dst = st + r * kPitch + L::kCols * L::lane();
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
}

// This thread's landed a2 values of piece j in stage st turned into h in
// place; its zeros left as they are.
template <bool WIDE>
__device__ __forceinline__ void land(float* st, int j,
                                     const float* __restrict__ scale,
                                     const float* __restrict__ shift,
                                     const Tile& tl, int C, int NS) {
  using L = Lanes<WIDE>;
  if (j * kK + L::kCols * L::lane() >= NS) return;
#pragma unroll 1
  for (int e0 = 0; e0 < L::kPasses; e0 += L::kInner) {
#pragma unroll
    for (int e = e0; e < e0 + L::kInner; ++e) {
      if (L::kPass * e >= tl.rows) break;
      const int r = L::row() + L::kPass * e, ch = tl.channel(r);
      if (ch >= C) continue;
      const float sc = __ldg(scale + ch), sh = __ldg(shift + ch);
      float* v = st + r * kPitch + L::kCols * L::lane();
      if constexpr (WIDE) {
        const float4 a = *reinterpret_cast<const float4*>(v);
        *reinterpret_cast<float4*>(v) =
            make_float4(relu_affine(a.x, sc, sh), relu_affine(a.y, sc, sh),
                        relu_affine(a.z, sc, sh), relu_affine(a.w, sc, sh));
      } else {
        *v = relu_affine(*v, sc, sh);
      }
    }
  }
}

// acc += the products of the k8 steps k0, k0 + dk, ... of one stage in
// 3xTF32 over a warp's 32 x 32 tile: rows = staged rows arow + 16 i + {g,
// g + 8}, columns = staged rows brow + 8 j + {2 t, 2 t + 1}; A[row][k] = h
// at position k, B[k][col] = h at position k. DIAG (arow == brow): B's
// fragments are A's, and the m16 x n8 tiles (1, 0) and (1, 1), below the
// diagonal, are skipped.
template <bool DIAG>
__device__ __forceinline__ void gram(float (&acc)[2][4][4], const float* st,
                                     int arow, int brow, int g, int t,
                                     int k0, int dk) {
  const float* ap = st + (arow + g) * kPitch + t;
  const float* bp = st + (brow + g) * kPitch + t;
#pragma unroll 1
  for (int k = k0; k < kK; k += dk) {
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* a = ap + 16 * i * kPitch + k;
      split(a[0], ab[i][0], as[i][0]);
      split(a[8 * kPitch], ab[i][1], as[i][1]);
      split(a[4], ab[i][2], as[i][2]);
      split(a[8 * kPitch + 4], ab[i][3], as[i][3]);
    }
#pragma unroll
    for (int j0 = 0; j0 < 4; j0 += 2) {
      uint32_t bb[2][2], bs[2][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = j0 + jj;
        if constexpr (DIAG) {
          bb[jj][0] = ab[j >> 1][j & 1];
          bb[jj][1] = ab[j >> 1][(j & 1) + 2];
          bs[jj][0] = as[j >> 1][j & 1];
          bs[jj][1] = as[j >> 1][(j & 1) + 2];
        } else {
          const float* b = bp + 8 * j * kPitch + k;
          split(b[0], bb[jj][0], bs[jj][0]);
          split(b[4], bb[jj][1], bs[jj][1]);
        }
      }
      // m16 tile 1 (rows 16..31) meets n8 tiles 0 and 1 below the diagonal
      const int kI = DIAG && j0 == 0 ? 1 : 2;
      float f[2][2][4];
      // one pass a term, the small ones first
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int i = 0; i < kI; ++i)
          mma0(f[jj][i], as[i], bb[jj][0], bb[jj][1]);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int i = 0; i < kI; ++i)
          mma(f[jj][i], ab[i], bs[jj][0], bs[jj][1]);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int i = 0; i < kI; ++i) {
          mma(f[jj][i], ab[i], bb[jj][0], bb[jj][1]);
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j0 + jj][r] += f[jj][i][r];
        }
    }
  }
}

// rs[q] += staged row arow + lane + 32 q of one stage, position after
// position.
__device__ __forceinline__ void row_sums(float (&rs)[2], const float* st,
                                         int arow, int lane, int rows) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int r = arow + lane + 32 * q;
    if (r >= rows) continue;
    const float4* p = reinterpret_cast<const float4*>(st + r * kPitch);
#pragma unroll
    for (int u = 0; u < kK / 4; ++u) {
      const float4 v = p[u];
      rs[q] += v.x;
      rs[q] += v.y;
      rs[q] += v.z;
      rs[q] += v.w;
    }
  }
}

// A warp's share of its block's tile: the computing 32 x 32 warp tiles
// (on or above the diagonal, inside C; rows wr .., columns wc .., as a
// whole on, above or below the diagonal, r0 and c0 being multiples of
// 64), taken in order of (wm, wn) of a 2 x 4 grid, are dealt out to the
// warps in turn; where there are 3 or fewer, Q = 2 (or 4 for one) warps
// share each, warp w taking group q = w / (warp tiles) of its k8 steps,
// every Q-th from the q-th, so that more warps compute and they spread
// over the SM's four schedulers (warp w % 4).
struct Share {
  int wr, wc, arow, brow, q, Q, tiles;
  bool busy, diag;
  __device__ Share(const Tile& tl, int C, int warp) {
    auto computes = [&](int v) {
      const int r = tl.r0 + 32 * (v >> 2), c = tl.c0 + 32 * (v & 3);
      return r < C && c < C && c + 31 >= r;
    };
    tiles = 0;
    for (int v = 0; v < 8; ++v) tiles += computes(v);
    Q = tiles <= 1 ? 4 : tiles <= 3 ? 2 : 1;
    busy = warp < tiles * Q;
    q = busy ? warp / tiles : 0;
    int v = 0;
    for (int k = busy ? warp % tiles : 0;; ++v)
      if (computes(v) && k-- == 0) break;
    wr = tl.r0 + 32 * (v >> 2);
    wc = tl.c0 + 32 * (v & 3);
    diag = wc == wr;
    arow = tl.a_off + 32 * (v >> 2);
    brow = tl.lo + 32 * (v & 3);
  }
};

// Block (tile, split): the split's partial M2 over the tile's entries on
// or above the diagonal, each also written at its mirror below it, and
// where the tile holds its rows' diagonal their sums of h in column C, of
// part[split] [C, C + 1].
template <bool WIDE>
__global__ void __launch_bounds__(kThreads, 2)
moments_tc_kernel(const float* __restrict__ a2,
                  const float* __restrict__ scale,
                  const float* __restrict__ shift, float* __restrict__ part,
                  int C, int S, int NS, int splits) {
  extern __shared__ __align__(16) float ring[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const Tile tl(blockIdx.x, C);
  const Share sh(tl, C, warp);
  // the row sums: the last warp, which computes no warp tile in a tile
  // that holds the diagonal (3 x 2 or 7 warp tiles or fewer there)
  const bool sums = tl.shared && warp == kThreads / 32 - 1;
  const long P = pieces(NS);
  const int jb = (int)(blockIdx.y * P / splits);
  const int stages = (int)((blockIdx.y + 1) * P / splits) - jb;
  auto buffer = [&](int s) { return ring + (s % kRing) * kStage; };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
  float rs[2] = {0.f, 0.f};

  // copies run kRing - 1 stages ahead: stage s + kRing - 1 refills the
  // buffer that stage s - 1 was read from, after the barrier that every
  // thread passes once it is done with stage s - 1
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < stages)
      copy_piece<WIDE>(buffer(s), jb + s, a2, tl, C, S, NS);
    commit();
  }
  for (int s = 0; s < stages; ++s) {
    wait_prior<kRing - 2>();
    land<WIDE>(buffer(s), jb + s, scale, shift, tl, C, NS);
    __syncthreads();
    if (s + kRing - 1 < stages)
      copy_piece<WIDE>(buffer(s + kRing - 1), jb + s + kRing - 1, a2, tl, C,
                       S, NS);
    commit();
    if (sh.busy) {
      if (sh.diag)
        gram<true>(acc, buffer(s), sh.arow, sh.arow, g, t, 8 * sh.q,
                   8 * sh.Q);
      else
        gram<false>(acc, buffer(s), sh.arow, sh.brow, g, t, 8 * sh.q,
                    8 * sh.Q);
    } else if (sums) {
      row_sums(rs, buffer(s), tl.a_off, lane, tl.rows);
    }
  }

  // the groups' accumulators of a warp tile added in group order: groups
  // 1 .. Q - 1 park theirs in the ring, which every copy has left
  if (sh.Q > 1) {
    __syncthreads();
    float* park = ring + warp * 1024 + lane;
    if (sh.busy && sh.q > 0)
#pragma unroll
      for (int e = 0; e < 32; ++e) park[32 * e] = (&acc[0][0][0])[e];
    __syncthreads();
    if (sh.busy && sh.q == 0)
      for (int q = 1; q < sh.Q; ++q)
#pragma unroll
        for (int e = 0; e < 32; ++e)
          (&acc[0][0][0])[e] += park[q * sh.tiles * 1024 + 32 * e];
  }

  float* out = part + (long)blockIdx.y * C * (C + 1);
  if (sh.busy && sh.q == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = sh.wr + 16 * i + g + 8 * (r >> 1);
          const int col = sh.wc + 8 * j + 2 * t + (r & 1);
          if (row <= col && col < C) {
            out[(long)row * (C + 1) + col] = acc[i][j][r];
            if (row < col) out[(long)col * (C + 1) + row] = acc[i][j][r];
          }
        }
  } else if (sums) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int row = tl.r0 + lane + 32 * q;
      if (row < C) out[(long)row * (C + 1) + C] = rs[q];
    }
  }
}

// ---- launches --------------------------------------------------------------

// What the wrapper computes: 1 <= splits <= the pieces of N * S (none
// empty), splits <= 65535; N * S <= INT_MAX - kK; with wide, S % 4 == 0
// and a2 16-byte aligned.
bool grid_ok(const float* a2, int N, int C, int S, int splits, int wide) {
  if (N <= 0 || C <= 0 || S <= 0) return false;
  const long ns = (long)N * S;
  if (ns > INT_MAX - kK) return false;
  if (splits < 1 || splits > 65535 || splits > pieces((int)ns)) return false;
  return !wide ||
         (S % 4 == 0 && reinterpret_cast<uintptr_t>(a2) % 16 == 0);
}

// The splits' partials into part, then added in split order into out
// [C, C + 1].
template <bool WIDE>
int launch(const float* a2, const float* scale, const float* shift,
           float* part, float* out, int N, int C, int S, int splits,
           cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      moments_tc_kernel<WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (e != cudaSuccess) return (int)e;
  moments_tc_kernel<WIDE><<<dim3(tiles(C), splits), kThreads, kSmem, s>>>(
      a2, scale, shift, part, C, S, N * S, splits);
  return finish_splits(part, out, (long)C * (C + 1), splits, s);
}

}  // namespace moments
}  // namespace
