// bwd_final for Hopper (sm_90a): the first 1x1's input gradient dx and its
// weight gradient dW1, both on tensor cores in 3xTF32, da1 folded once.
// Included by fused_block_bwd.cu only; dx runs the kernel of
// conv1x1_tc.cuh, which conv1x1_bn_residual shares.
//
// Replaces the Pallas body _b3_kernel of bwd_final in
// paddle_tpu/kernels/fused_block.py:436-458 (pallas_call at :466). For g3,
// x [N, Cin, S], g1, a1 [N, C, S], bn1 folded into p1, q1, r1 [C] and w1
// [C, Cin]:
//   da1 = g1 * p1 + a1 * q1 + r1;
//   dx = W1^T da1 + g3;
//   dW1 = sum_{n,p} da1 x^T [C, Cin].
//
// What bounds it on the H100 (batch 128; Cin, C, S = 256, 64, 3136 / 512,
// 128, 784 / 1024, 256, 196): two products of 13.2 GFLOP at every stage,
// 0.39 ms at the 67 TFLOP/s float32 FMA rate; as three TF32 products each,
// 78.9 GFLOP of tensor-core work, 0.16 ms at the 495 TFLOP/s dense TF32
// rate. Each tensor read once and dx written once: 1.44 / 0.72 / 0.36 GB,
// 0.43 / 0.21 / 0.11 ms at 3.35 TB/s. Bytes bound it at 56x56 and 28x28,
// operations at 14x14. No one pass can read everything once: dW1's [C,
// Cin] accumulators do not fit a block, so each product reads da1 or its
// two sources, 4C + 3Cin floats a position at least.
//
// The design, two launches and the fixed-order pass of the splits:
//   - dx, da1 folded once: conv1x1_tc.cuh's kernel with the Use Dx
//     below. A block owns 64 consecutive columns j = n * S + p of N * S
//     (a run may hold the end of one image and the start of the next) and
//     all of Cin. It reads g1 and a1 there once, folds da1 into a [C][72]
//     tile in shared memory and writes it once into an [N, C, S] scratch
//     for dW1 (C written and C read back: the bytes of folding again in
//     dW1, which would then need two sources a value). Then it walks Cin
//     in chunks of 128 rows: W1's rows, 16 channels x 128 a stage, come
//     through a ring of 3 stages of 16-byte cp.async (W1 is 64 KB-1 MB
//     and stays in L2); the product with K = C runs on the tile; the
//     epilogue adds g3 and writes dx. The SIMT kernels built each da1
//     value once for each 128 rows of Cin and again for each tile of dW1.
//   - dW1, a split-K product over K = the positions: bwd_mid's tap-gradient
//     product with one tap and no halo. A block owns 64 rows of C, 128 of
//     Cin (32 accumulators a thread) and a split: a run of 32-column pieces
//     of N * S, split p taking pieces [p * P / splits, (p + 1) * P /
//     splits) of P. A piece may straddle two images, so no position is
//     wasted (pieces inside an image would add 14% at S = 196). A stage
//     holds da1 [64][32] and x [128][32], 16-byte cp.async where S % 4 ==
//     0 (4 columns then stay in one image), 4-byte copies otherwise, in a
//     ring of 3. The wrapper's _bwd_final_grid sizes the splits so that
//     tiles x splits fill whole waves of two blocks an SM.
//   - The products: mma.sync.aligned.m16n8k8.row.col in 3xTF32 with
//     conv3x3_tc.cuh's split, mma0 and mma (dx's in conv1x1_tc.cuh);
//     each k8 step's three products of a tile go into a fresh fragment,
//     added in float32 (the tensor cores truncate as they accumulate).
//     dx: A[ci][c] = W1[c][ci] and B[c][j] = da1[c][j], both staged
//     channel-major at a pitch of 8 mod 32 floats; dW1: A[c][j] = da1 and
//     B[j][ci] = x staged [row][position] at a pitch of 36 (4 mod 32), as
//     bwd_mid's tap gradients. Either way a fragment's 8 rows x 4 k (or 4
//     k x 8 columns) fall on 32 banks. 8 warps as 4 x 2 (dx) or 2 x 4
//     (dW1), each 32 x 32. Zero-filled rows past C and Cin and columns
//     past N * S take any shape.
//   - Sums: each split writes its partial dW1 into part [splits, C, Cin];
//     finish_splits adds them in split order. No atomics: two calls are
//     bit-identical.
//
// Registers (nvcc -Xptxas -v, sm_90a): 128 a thread in dx, 113-120 in
// dW1, under the bound that two blocks an SM set; no spills, no stack.
//
// What holds it back (PERF.md, row 13; scripts/torch_bwd_final_probe.py):
// dx at 56x56 moves ~2 TB/s, its blocks, all alike, running their fold,
// products and writes in step, so that memory and products take turns;
// both products, like bwd_mid's, are bound by the instructions around
// the mma (a build with each mma replaced by integer work is no faster).
#pragma once

#include <climits>
#include <cstdint>

#include "conv1x1_tc.cuh"
#include "conv3x3_tc.cuh"
#include "fused_block.cuh"

namespace {
namespace bwd_final {

using conv3x3::commit;
using conv3x3::copy16;
using conv3x3::copy4;
using conv3x3::mma;
using conv3x3::mma0;
using conv3x3::split;
using conv3x3::wait_prior_1;

constexpr int kRing = 3;                 // stages in a ring

// ---- dx --------------------------------------------------------------------

using conv1x1::aligned16;
using conv1x1::kDP;
using conv1x1::kP;

// da1 at columns j0 .. j0 + 63 into the tile d [Cp][kDP] (0 past C and
// past N * S) and into da1 [N, C, S]. WIDE: 16 bytes a thread, column
// group tid % 16 of rows tid / 16 + 16 k; else 4 bytes, column tid % 64 of
// rows tid / 64 + 4 k.
template <bool WIDE>
__device__ __forceinline__ void fold(float* d, const float* __restrict__ g1,
                                     const float* __restrict__ a1,
                                     const float* __restrict__ p,
                                     const float* __restrict__ q,
                                     const float* __restrict__ r,
                                     float* __restrict__ da1, int C, int Cp,
                                     int S, int NS, int j0) {
  constexpr int kCols = WIDE ? 4 : 1, kLanes = kP / kCols;
  constexpr int kRows = kThreads / kLanes;
  const int lane = threadIdx.x % kLanes, row = threadIdx.x / kLanes;
  const int j = j0 + kCols * lane;
  const bool in = j < NS;
  const int n = in ? j / S : 0;
  const int base = n * C * S + (j - n * S);
#pragma unroll 4
  for (int c = row; c < Cp; c += kRows) {
    float v[kCols];
#pragma unroll
    for (int e = 0; e < kCols; ++e) v[e] = 0.f;
    if (in && c < C) {
      const int o = base + c * S;
      const float pc = __ldg(p + c), qc = __ldg(q + c), rc = __ldg(r + c);
      if constexpr (WIDE) {
        const float4 gv = __ldg(reinterpret_cast<const float4*>(g1 + o));
        const float4 av = __ldg(reinterpret_cast<const float4*>(a1 + o));
        v[0] = fmaf(gv.x, pc, fmaf(av.x, qc, rc));
        v[1] = fmaf(gv.y, pc, fmaf(av.y, qc, rc));
        v[2] = fmaf(gv.z, pc, fmaf(av.z, qc, rc));
        v[3] = fmaf(gv.w, pc, fmaf(av.w, qc, rc));
        *reinterpret_cast<float4*>(da1 + o) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
        v[0] = fmaf(__ldg(g1 + o), pc, fmaf(__ldg(a1 + o), qc, rc));
        da1[o] = v[0];
      }
    }
    if constexpr (WIDE)
      *reinterpret_cast<float4*>(d + c * kDP + 4 * lane) =
          make_float4(v[0], v[1], v[2], v[3]);
    else
      d[c * kDP + lane] = v[0];
  }
}

// The Use of dx in conv1x1_tc.cuh's kernel: in0 = g1, in1 = a1, in2..in4
// = p1, q1, r1, aux = da1 (the tile, folded once, also written there for
// dW1), add = g3; M = Cin.
struct Dx {
  static constexpr bool kSplit = false;
  struct Early {};

  template <bool WIDE>
  __device__ static __forceinline__ void tile(
      float* d, const float* __restrict__ g1, const float* __restrict__ a1,
      const float* __restrict__ p, const float* __restrict__ q,
      const float* __restrict__ r, float* __restrict__ da1, int C, int Cp,
      int S, int NS, int j0) {
    fold<WIDE>(d, g1, a1, p, q, r, da1, C, Cp, S, NS, j0);
  }

  template <bool WIDE>
  __device__ static __forceinline__ void fetch(Early&, const int (&)[4][2],
                                               const float* __restrict__, int,
                                               int, int) {}

  // dx = acc + g3 at the chunk's rows ci0 + 16 i + 8 hr.
  template <bool WIDE>
  __device__ static __forceinline__ void epilogue(
      const Early&, const float (&acc)[2][4][4], const int (&off)[4][2],
      const float* __restrict__ g3, const float* __restrict__,
      const float* __restrict__, float* __restrict__ dx, int ci0, int Cin,
      int S) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int ci = ci0 + 16 * i + 8 * hr;
        if (ci >= Cin) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (WIDE) {
            // S % 4 == 0: columns 2t and 2t + 1 lie in one image
            if (off[j][0] < 0) continue;
            const int o = off[j][0] + ci * S;
            const float2 gv = __ldg(reinterpret_cast<const float2*>(g3 + o));
            *reinterpret_cast<float2*>(dx + o) =
                make_float2(acc[i][j][2 * hr] + gv.x,
                            acc[i][j][2 * hr + 1] + gv.y);
          } else {
#pragma unroll
            for (int c = 0; c < 2; ++c)
              if (off[j][c] >= 0) {
                const int o = off[j][c] + ci * S;
                dx[o] = acc[i][j][2 * hr + c] + __ldg(g3 + o);
              }
          }
        }
      }
  }
};

// ---- dW1 -------------------------------------------------------------------

constexpr int kWM = 64;                  // rows of C a block
constexpr int kWN = 128;                 // rows of Cin a block
constexpr int kWK = 32;                  // columns of N * S a stage: a piece
constexpr int kWPitch = 36;              // 4 mod 32: conflict-free fragments
constexpr int kWStage = (kWM + kWN) * kWPitch;
constexpr int kWSmem = kRing * kWStage * (int)sizeof(float);

__host__ __device__ inline int pieces(int NS) { return (NS + kWK - 1) / kWK; }

// The copies of piece j (columns 32 j .. 32 j + 31 of N * S) into stage
// st: rows 0..63 da1 [m0 + r], rows 64..191 x [n0 + r - 64], zero past C,
// Cin and N * S. WIDE: 16 bytes at columns 4 (tid % 8) of rows tid / 8 +
// 32 k; else 4 bytes at column tid % 32 of rows tid / 32 + 8 k (a slot
// outside written 0 by the thread).
template <bool WIDE>
__device__ __forceinline__ void copy_piece(float* st, int j,
                                           const float* __restrict__ da1,
                                           const float* __restrict__ x,
                                           int m0, int n0, int C, int Cin,
                                           int S, int NS) {
  constexpr int kCols = WIDE ? 4 : 1, kLanes = kWK / kCols;
  constexpr int kRows = kThreads / kLanes;
  const int lane = threadIdx.x % kLanes, row = threadIdx.x / kLanes;
  const int col = j * kWK + kCols * lane;
  const bool in = col < NS;
  const int n = in ? col / S : 0, p = col - n * S;
#pragma unroll
  for (int k = 0; k < (kWM + kWN) / kRows; ++k) {
    const int r = row + kRows * k;
    const bool a = k < kWM / kRows;   // r < kWM, known at compile time
    const int ch = a ? m0 + r : n0 + r - kWM;
    const bool ok = in && ch < (a ? C : Cin);
    const float* src =
        a ? da1 + (ok ? (n * C + ch) * S + p : 0)
          : x + (ok ? (n * Cin + ch) * S + p : 0);
    float* dst = st + r * kWPitch + kCols * lane;
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

// acc += the products of one stage in 3xTF32. Warp (wm, wn) owns rows c =
// 32 wm + 16 i + {g, g + 8} and columns ci = 32 wn + 8 j + {2 t, 2 t + 1}.
// A[c][k] = da1 at position k, B[k][ci] = x at position k.
__device__ __forceinline__ void dw_product(float (&acc)[2][4][4],
                                           const float* st, int wm, int wn,
                                           int g, int t) {
  const float* da = st + (32 * wm + g) * kWPitch + t;
  const float* xb = st + (kWM + 32 * wn + g) * kWPitch + t;
#pragma unroll 1
  for (int k = 0; k < kWK; k += 8) {
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* a = da + 16 * i * kWPitch + k;
      split(a[0], ab[i][0], as[i][0]);
      split(a[8 * kWPitch], ab[i][1], as[i][1]);
      split(a[4], ab[i][2], as[i][2]);
      split(a[8 * kWPitch + 4], ab[i][3], as[i][3]);
    }
#pragma unroll
    for (int j0 = 0; j0 < 4; j0 += 2) {
      uint32_t bb[2][2], bs[2][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float* b = xb + 8 * (j0 + jj) * kWPitch + k;
        split(b[0], bb[jj][0], bs[jj][0]);
        split(b[4], bb[jj][1], bs[jj][1]);
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

// Block (C tile + tiles_m * Cin tile, split): the split's partial dW1,
// part[split] [C, Cin].
template <bool WIDE>
__global__ void __launch_bounds__(kThreads, 2)
bwd_final_dw_kernel(const float* __restrict__ da1, const float* __restrict__ x,
                    float* __restrict__ part, int C, int Cin, int S, int NS,
                    int tiles_m, int splits) {
  extern __shared__ __align__(16) float ring[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
  const int m0 = (blockIdx.x % tiles_m) * kWM;
  const int n0 = (blockIdx.x / tiles_m) * kWN;
  const long P = pieces(NS);
  const int jb = (int)(blockIdx.y * P / splits);
  const int stages = (int)((blockIdx.y + 1) * P / splits) - jb;
  auto buffer = [&](int s) { return ring + (s % kRing) * kWStage; };
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  copy_piece<WIDE>(buffer(0), jb, da1, x, m0, n0, C, Cin, S, NS);
  commit();
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages)
      copy_piece<WIDE>(buffer(s + 1), jb + s + 1, da1, x, m0, n0, C, Cin, S,
                       NS);
    commit();
    wait_prior_1();
    __syncthreads();
    dw_product(acc, buffer(s), wm, wn, g, t);
  }

  float* out = part + (long)blockIdx.y * C * Cin;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int c = m0 + 32 * wm + 16 * i + g + 8 * (r >> 1);
        const int ci = n0 + 32 * wn + 8 * j + 2 * t + (r & 1);
        if (c < C && ci < Cin) out[(long)c * Cin + ci] = acc[i][j][r];
      }
}

// ---- launches --------------------------------------------------------------

// What the wrapper computes: W1 at a row pitch ldw >= Cin, a multiple of
// 4, 16-byte aligned; 1 <= splits <= the pieces of N * S (none empty);
// every offset inside an int; C <= conv1x1::kMaxC (the dx kernel's tile
// and ring inside a block's shared memory); with wide, S % 4 == 0 and the activations
// 16-byte aligned.
bool grid_ok(const float* g3, const float* g1, const float* a1,
             const float* x, const float* w1, const float* dx,
             const float* da1, int N, int Cin, int C, int S, int ldw,
             int splits, int wide) {
  if (N <= 0 || Cin <= 0 || C <= 0 || C > conv1x1::kMaxC || S <= 0)
    return false;
  const long big = Cin > C ? Cin : C;
  if ((long)N * big * S >= INT_MAX || (long)C * ldw >= INT_MAX) return false;
  if (ldw < Cin || ldw % 4 || !aligned16(w1)) return false;
  if (splits < 1 || splits > 65535 || splits > pieces(N * S)) return false;
  return !wide || (S % 4 == 0 && aligned16(g3) && aligned16(g1) &&
                   aligned16(a1) && aligned16(x) && aligned16(dx) &&
                   aligned16(da1));
}

// dx and da1: conv1x1_tc.cuh's kernel over 64-column blocks of N * S.
template <bool WIDE>
int input_gradient(const float* g3, const float* g1, const float* a1,
                   const float* p1, const float* q1, const float* r1,
                   const float* w1, float* dx, float* da1, int N, int Cin,
                   int C, int S, int ldw, cudaStream_t s) {
  const int NS = N * S, bytes = conv1x1::smem_bytes(C);
  const cudaError_t e = cudaFuncSetAttribute(
      conv1x1::conv1x1_tc_kernel<Dx, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  conv1x1::conv1x1_tc_kernel<Dx, WIDE>
      <<<(NS + kP - 1) / kP, kThreads, bytes, s>>>(
          g3, g1, a1, p1, q1, r1, w1, dx, da1, Cin, C, S, NS, ldw);
  return (int)cudaGetLastError();
}

// dW1: the splits' partials into wpart, then added in split order.
template <bool WIDE>
int weight_gradient(const float* da1, const float* x, float* wpart,
                    float* dw1, int N, int Cin, int C, int S, int splits,
                    cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      bwd_final_dw_kernel<WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kWSmem);
  if (e != cudaSuccess) return (int)e;
  const int tiles_m = (C + kWM - 1) / kWM;
  const int tiles = tiles_m * ((Cin + kWN - 1) / kWN);
  bwd_final_dw_kernel<WIDE><<<dim3(tiles, splits), kThreads, kWSmem, s>>>(
      da1, x, wpart, C, Cin, S, N * S, tiles_m, splits);
  return finish_splits(wpart, dw1, (long)C * Cin, splits, s);
}

template <bool WIDE>
int launch(const float* g3, const float* g1, const float* a1,
           const float* x, const float* p1, const float* q1,
           const float* r1, const float* w1, float* dx, float* da1,
           float* wpart, float* dw1, int N, int Cin, int C, int S, int ldw,
           int splits, cudaStream_t s) {
  const int err = input_gradient<WIDE>(g3, g1, a1, p1, q1, r1, w1, dx, da1,
                                       N, Cin, C, S, ldw, s);
  return err ? err
             : weight_gradient<WIDE>(da1, x, wpart, dw1, N, Cin, C, S,
                                     splits, s);
}

}  // namespace bwd_final
}  // namespace
