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
// What bounds them on the H100. At ResNet-50's three chain stages (batch
// 128; Cin, C, S = 256, 64, 3136 / 512, 128, 784 / 1024, 256, 196) every
// stage does the same products: 13.2 GFLOP in conv1x1_stats, 29.6 in
// conv3x3_norm_stats, 1.7 in the moments (M2 is symmetric) and 13.2 in
// conv1x1_bn_residual; as three TF32 products at the 495 TFLOP/s dense
// TF32 rate, 0.080 / 0.179 / 0.010 / 0.080 ms. Bytes bound conv1x1_stats
// at 56x56 (514 MB, 0.153 ms at 3.35 TB/s), conv1x1_bn_residual at 56x56
// and 28x28, the moments at 56x56 and 28x28; each header gives its
// figures.
//
// What the design does about it. The TPU kernels take a whole image a grid
// step, roll it in VMEM for the 3x3 taps and carry the sums from step to
// step of a sequential grid. Here all four run on the tensor cores in
// 3xTF32, fed by rings of asynchronous copies, their operands normalized
// once a value, the batch folded into the columns so that S = 196 and 49
// leave no tile idle: conv1x1_stats as W1 times x streamed through a ring
// (conv1x1_stats_tc.cuh, on bwd_apply3's tile, copies and product), y and
// its per-tile row sums in the same launch; the 3x3 over halo tiles of h1 (conv3x3_tc.cuh);
// the moments as a split-K Gram product over the upper triangle, h
// normalized as it lands (moments_tc.cuh); the last 1x1 over a tile of h2
// built once a block, so h2 never reaches device memory (conv1x1_tc.cuh,
// whose kernel bwd_final's dx shares). Each header says how and why. No
// atomics anywhere: every result is deterministic; per-tile sums are
// added in tile order by the passes of fused_block.cuh, shared with the
// backward (fused_block_bwd.cu).
#include "fused_block.cuh"
#include "conv1x1_tc.cuh"
#include "conv3x3_tc.cuh"
#include "moments_tc.cuh"
#include "conv1x1_stats_tc.cuh"

// x [N, Cin, S], w [rows, lda]: W1 [C, Cin] at row pitch lda (a multiple
// of 16 >= Cin), its rows the row tiles x their 64 or 128 rows, zeros past
// C and past Cin, 16-byte aligned; y [N, C, S], part [2, C, T] scratch,
// stats [2, C] (sum, sum of squares); T the column tiles of N*S
// (conv1x1_stats_tc.cuh: 128 columns where C <= 64, else 64); with wide
// set, S % 4 == 0 and x, y 16-byte aligned. All float32, contiguous.
// Returns a cudaError_t (0 = launched).
extern "C" int fused_block_conv1x1_stats_f32(const float* x, const float* w,
                                             float* y, float* part,
                                             float* stats, int N, int Cin,
                                             int C, int S, int lda, int T,
                                             int wide, void* stream) {
  if (!conv1x1_stats::grid_ok(x, w, y, N, Cin, C, S, lda, T, wide))
    return (int)cudaErrorInvalidValue;
  return conv1x1_stats::launch(x, w, y, part, stats, N, Cin, C, S, lda, T,
                               wide, static_cast<cudaStream_t>(stream));
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
