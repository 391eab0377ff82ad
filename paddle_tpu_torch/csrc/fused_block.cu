// Bottleneck-chain forward kernels for Hopper (sm_90a), float32.
//
// Replace the forward TPU kernels of paddle_tpu/kernels/fused_block.py, the
// chain that runs a stride-1 ResNet rest block (1x1 conv + BN + ReLU, 3x3
// conv + BN + ReLU, 1x1 conv + BN, + input, ReLU) with training-mode BN.
// Activations are [N, C, S] with S = H*W:
//   conv1x1_stats (Pallas body _k1_kernel): a1[n] = W1 x[n], W1 [C, Cin],
//     and the per-channel sum and sum of squares of a1;
//   conv3x3_norm_stats (_k2_kernel): a2 = the 3x3 same-padded conv of
//     h1 = relu(a1 * scale + shift), taps [9, Cout, Cin] indexed
//     [(dy+1)*3 + (dx+1)]: a2[p] = sum taps[t] h1[p + dy*W + dx], an
//     out-of-image tap reading 0 (the conv pads h1, not a1); and the sums;
//   norm_relu_moments (_moments_kernel): sum_h [C] and M2 = sum_{n,s} h h^T
//     [C, C] of h = relu(a2 * scale + shift);
//   conv1x1_bn_residual (_assemble_kernel): out[n] = relu((W3 h2[n]) * sc3
//     + sh3 + x[n]), h2 = relu(a2 * sc2 + sh2), W3 [Cout, C].
//
// What bounds them on the H100: operations. At ResNet-50's three chain
// stages (batch 128; Cin, C, S = 256, 64, 3136 / 512, 128, 784 / 1024,
// 256, 196) every stage does the same products: 13.2 GFLOP in
// conv1x1_stats (0.196 ms at the 67 TFLOP/s float32 peak), 29.6 in
// conv3x3_norm_stats (0.442 ms), 1.7 in the moments (M2 is symmetric)
// and 13.2 in conv1x1_bn_residual (0.196 ms; at 56x56 its 925 MB of
// traffic, 0.276 ms, bound it instead).
//
// What the design does about it. The TPU kernels take a whole image a grid
// step, roll it in VMEM for the 3x3 taps and carry the sums from step to
// step of a sequential grid. Here conv1x1_stats is one tiled float32 SIMT
// product on the CUDA cores, out = W1 [C, Cin] x [Cin, N*S], with the
// batch folded into the columns so that S = 196 and 49 do not leave tiles
// empty:
//   - a 256-thread block owns a BM x 128 output tile (BM 64 or 128 by C),
//     each thread an 8 x 8 (or 4 x 8) micro-tile read from shared memory
//     as float4;
//   - K advances 8 deep, two shared-memory stages: the next stage's global
//     loads are issued into registers before the current stage's products;
//     each column loader thread loads one fixed column of B, whose (n, p)
//     it decodes once;
//   - the epilogue writes a1 with each tile's per-channel partial sums
//     into a [2, C, tiles] buffer (a fixed-order tree across the tile's
//     threads), which a second kernel adds in tile order.
// The other three run on the tensor cores in 3xTF32, fed by rings of
// asynchronous copies, their operands normalized once a value: the 3x3
// over halo tiles of h1 (conv3x3_tc.cuh), the moments as a split-K Gram
// product over the upper triangle, h normalized as it lands
// (moments_tc.cuh), the last 1x1 over a tile of h2 built once a block, so
// h2 never reaches device memory (conv1x1_tc.cuh, whose kernel bwd_final's
// dx shares); each header says how and why. No atomics anywhere: every
// result is deterministic. The tile machinery and the finalizing passes
// are in fused_block.cuh, shared with the backward (fused_block_bwd.cu).
#include "fused_block.cuh"
#include "conv1x1_tc.cuh"
#include "conv3x3_tc.cuh"
#include "moments_tc.cuh"

namespace {

// Loaders of the forward (the header says how a loader maps threads).

// A[m][k] = w[m * K + k]: a row-major weight [M, K].
template <int TM>
struct WeightA {
  static constexpr int BM = 16 * TM, R = TM / 2;
  const float* w;
  int M, K, m0, kk, mr;
  float reg[R];
  __device__ WeightA(const float* w_, int M_, int K_, int m0_)
      : w(w_), M(M_), K(K_), m0(m0_), kk(threadIdx.x & 7),
        mr(threadIdx.x >> 3) {}
  __device__ __forceinline__ void fetch(int k0) {
    const int k = k0 + kk;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int m = m0 + mr + 32 * r;
      reg[r] = (m < M && k < K) ? __ldg(w + (long)m * K + k) : 0.f;
    }
  }
  __device__ __forceinline__ void store(float* s) const {
#pragma unroll
    for (int r = 0; r < R; ++r) s[kk * (BM + 4) + mr + 32 * r] = reg[r];
  }
};

// B[k][j] = src[n, k, p] at column j = n * S + p: a [N, K, S] activation
// as K x (N*S).
template <int TN>
struct ActB {
  static constexpr int BN = 16 * TN, R = TN / 2, KS = kThreads / BN;
  const float* src;
  int K, S, col, kr;
  long base;
  bool ok;
  float reg[R];
  __device__ ActB(const float* src_, int K_, int S_, int NS, int j0)
      : src(src_), K(K_), S(S_), col(threadIdx.x % BN), kr(threadIdx.x / BN) {
    const int j = j0 + col;
    ok = j < NS;
    const int n = ok ? j / S : 0;
    base = (long)n * K * S + (j - n * S);
  }
  __device__ __forceinline__ void fetch(int k0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = k0 + kr + KS * r;
      float v = 0.f;
      if (ok && k < K) v = __ldg(src + base + (long)k * S);
      reg[r] = v;
    }
  }
  __device__ __forceinline__ void store(float* s) const {
#pragma unroll
    for (int r = 0; r < R; ++r) s[(kr + KS * r) * (BN + 4) + col] = reg[r];
  }
};

// Writes the tile of y [N, M, S] (column j = n * S + p) and its per-row
// sum and sum of squares into part [2, M, T] at tile column jt.
template <int TM, int TN>
__device__ __forceinline__ void store_with_stats(const float (&acc)[TM][TN],
                                                 float* __restrict__ y,
                                                 float* __restrict__ part,
                                                 int M, int S, int NS, int T,
                                                 int m0, int j0, int jt,
                                                 float* red) {
  constexpr int BM = 16 * TM;
  const int ty = threadIdx.x >> 4;
  long coff[TN];
  bool cok[TN];
  column_offsets<TN>(coff, cok, j0, M, S, NS);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int lr = tile_pos(i, ty);
    const int m = m0 + lr;
    float s = 0.f, q = 0.f;
    if (m < M) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        if (cok[j]) {
          const float v = acc[i][j];
          y[coff[j] + (long)m * S] = v;
          s += v;
          q = fmaf(v, v, q);
        }
      }
    }
    put_row_partial<BM>(red, lr, s, q);
  }
  store_row_partials<BM>(part, M, T, m0, jt, red);
}

// ---------------------------------------------------------------------------
// Kernels. Conv grids: (M tiles, column tiles), M tiles fastest, so the
// blocks that share a column tile of B run together and meet it in L2.
// ---------------------------------------------------------------------------

template <int TM, int TN>
__global__ void __launch_bounds__(kThreads, 2)
conv1x1_stats_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ y, float* __restrict__ part, int M,
                     int K, int S, int NS, int T) {
  constexpr int BM = 16 * TM, BN = 16 * TN;
  __shared__ __align__(16) float smem[Smem<BM, BN>::kFloats];
  const int m0 = blockIdx.x * BM, jt = blockIdx.y, j0 = jt * BN;
  WeightA<TM> la(w, M, K, m0);
  ActB<TN> lb(x, K, S, NS, j0);
  float acc[TM][TN];
  mainloop<TM, TN>(acc, la, lb, 0, K, smem);
  store_with_stats<TM, TN>(acc, y, part, M, S, NS, T, m0, j0, jt, smem);
}

}  // namespace

// x [N, Cin, S], w [C, Cin]; y [N, C, S], part [2, C, T] scratch, stats
// [2, C] (sum, sum of squares); all float32, contiguous; T = ceil(N*S /
// 128). Returns a cudaError_t (0 = launched).
extern "C" int fused_block_conv1x1_stats_f32(const float* x, const float* w,
                                             float* y, float* part,
                                             float* stats, int N, int Cin,
                                             int C, int S, int T,
                                             void* stream) {
  if (Cin <= 0 || !tiles_ok(C, N, S, T)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int NS = N * S;
  if (C <= 64)
    conv1x1_stats_kernel<4, 8><<<dim3((C + 63) / 64, T), kThreads, 0, s>>>(
        x, w, y, part, C, Cin, S, NS, T);
  else
    conv1x1_stats_kernel<8, 8><<<dim3((C + 127) / 128, T), kThreads, 0, s>>>(
        x, w, y, part, C, Cin, S, NS, T);
  return finish_stats(part, stats, C, T, s);
}

// a1 [N, Cin, H*W], taps [9, Cout, Cin] (16-byte aligned), scale/shift
// [Cin]; y [N, Cout, H*W], part [2, Cout, T], stats [2, Cout]; Cin % 8 ==
// 0; T = N * ceil(H * (W + 2) / 224), the column tiles of the padded grid
// (conv3x3_tc.cuh).
extern "C" int fused_block_conv3x3_norm_stats_f32(
    const float* a1, const float* taps, const float* scale,
    const float* shift, float* y, float* part, float* stats, int N, int Cin,
    int Cout, int H, int W, int T, void* stream) {
  if (!conv3x3::grid_ok(taps, N, Cin, Cout, H, W, T))
    return (int)cudaErrorInvalidValue;
  return conv3x3::launch(a1, taps, conv3x3::NormRelu{scale, shift},
                         conv3x3::Stats{y}, part, stats, N, Cin, Cout, H, W,
                         T, static_cast<cudaStream_t>(stream));
}

// a2 [N, C, S], scale/shift [C]; part [splits, C, C + 1] scratch, out
// [C, C + 1]: M2 = sum h h^T in columns 0..C-1, exactly symmetric, sum h
// in column C. Split p takes the 32-column pieces [p * P / splits, (p +
// 1) * P / splits) of N*S; wide: S % 4 == 0 and a2 16-byte aligned
// (moments_tc.cuh).
extern "C" int fused_block_norm_relu_moments_f32(
    const float* a2, const float* scale, const float* shift, float* part,
    float* out, int N, int C, int S, int splits, int wide, void* stream) {
  if (!moments::grid_ok(a2, N, C, S, splits, wide))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return wide ? moments::launch<true>(a2, scale, shift, part, out, N, C, S,
                                      splits, s)
              : moments::launch<false>(a2, scale, shift, part, out, N, C, S,
                                       splits, s);
}

// a2 [N, C, S], x [N, Cout, S], wt [C, ldw] = W3^T, its rows zero-padded
// to ldw >= Cout (a multiple of 4, 16-byte aligned), sc2/sh2 [C], sc3/sh3
// [Cout]; out [N, Cout, S]; splits of Cout's 128-row chunks; wide: S % 4
// == 0 and a2, x, out 16-byte aligned (conv1x1_tc.cuh).
extern "C" int fused_block_conv1x1_bn_residual_f32(
    const float* a2, const float* x, const float* wt, const float* sc2,
    const float* sh2, const float* sc3, const float* sh3, float* out, int N,
    int C, int Cout, int S, int ldw, int splits, int wide, void* stream) {
  if (!conv1x1::bn_residual_ok(a2, x, wt, out, N, C, Cout, S, ldw, splits,
                               wide))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return wide ? conv1x1::bn_residual<true>(a2, x, wt, sc2, sh2, sc3, sh3,
                                           out, N, C, Cout, S, ldw, splits, s)
              : conv1x1::bn_residual<false>(a2, x, wt, sc2, sh2, sc3, sh3,
                                            out, N, C, Cout, S, ldw, splits,
                                            s);
}

// The most channels C that conv1x1_bn_residual and bwd_final's dx take
// (their tile and ring in one block's shared memory): the chain's gate.
extern "C" int fused_block_conv1x1_max_c() { return conv1x1::kMaxC; }
