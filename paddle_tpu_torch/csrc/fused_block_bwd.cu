// Bottleneck-chain backward kernels for Hopper (sm_90a), float32.
//
// Replace the backward TPU kernels of paddle_tpu/kernels/fused_block.py,
// which bottleneck_rest_bwd calls in this order. Activations are [N, C, S]
// (x, g3, dx: [N, Cin, S]); the BN backward is folded into per-channel
// constants outside the kernels (da = g * p + a * q + r; bn3's through W3:
// A = W3^T diag(p3), B = W3^T diag(q3) W3, v0 = W3^T r3):
//   bwd_reduce3 (Pallas body _b1a_kernel): g3 = dout * (out > 0), written
//     once; P = sum_{n,s} g3 h2^T [Cin, C] and sum g3 [Cin], with h2 =
//     relu(a2 * sc2 + sh2) recomputed on load;
//   bwd_apply3 (_b1b_kernel): g2 = (A g3 + B h2 + v0) * (a2 * sc2 + sh2 >
//     0) [N, C, S]; bn2's sum g2 and sum g2 * xhat2, xhat2 = a2 * inv2 - m2
//     * inv2;
//   bwd_mid (_b2_kernel): da2 = g2 * p2 + a2 * q2 + r2; (a) the 3x3's
//     input gradient dh1[p] = sum_t taps[t]^T da2[p - off_t] (da2 padded
//     with 0: an out-of-image source pixel loads 0, not r2), g1 = dh1 *
//     (a1 * sc1 + sh1 > 0) and bn1's sums; (b) the tap gradients dtaps[t]
//     = sum_{n,p} da2[p] h1[p + off_t]^T [9, Cout, Cin] (h1 padded with 0:
//     an out-of-image h1 loads 0, not relu(sh1));
//   bwd_final (_b3_kernel): da1 = g1 * p1 + a1 * q1 + r1; (a) dx = W1^T da1
//     + g3; (b) dW1 = sum_{n,p} da1 x^T [C, Cin].
// off_t = dy * W + dx for tap t = (dy + 1) * 3 + (dx + 1).
//
// What bounds them on the H100. At ResNet-50's three chain stages (batch
// 128; Cin, C, S = 256, 64, 3136 / 512, 128, 784 / 1024, 256, 196) each
// does the same products at every stage: 13.2 GFLOP in bwd_reduce3, 16.4
// in bwd_apply3, 59.2 in bwd_mid and 26.3 in bwd_final, 0.196-0.883 ms at
// the 67 TFLOP/s float32 peak; at 56x56 the bytes of bwd_reduce3 (1.34 GB)
// and bwd_final (1.44 GB) bound them instead.
//
// What the design does about it: bwd_reduce3 is a split-K product fed by
// a ring of asynchronous copies (its note in bwd_reduce3.cuh);
// bwd_apply3, bwd_mid and bwd_final run their products on tensor cores in
// 3xTF32 (their notes in bwd_apply3_tc.cuh: one stacked product [A | B]
// [g3; h2] fed by a ring of asynchronous copies, h2 built on landing, the
// masked epilogue in the same launch, its tile, copies and product shared
// with the forward's conv1x1_stats_tc.cuh; bwd_mid_tc.cuh, whose input
// gradient is conv3x3_tc.cuh's kernel; bwd_final_tc.cuh: da1 folded once
// into a scratch that dW1 reads, dx on conv1x1_tc.cuh's kernel).
//
// The TPU carries its sums across a sequential grid of images; here they
// are partials added in a fixed order: no atomics, every result is
// deterministic. A mask is taken as the plain version takes it, a * sc
// rounded, then + sh rounded (positive, fused_block.cuh), so that both
// zero the same elements.
#include "fused_block.cuh"
#include "bwd_reduce3.cuh"
#include "bwd_mid_tc.cuh"
#include "bwd_final_tc.cuh"
#include "bwd_apply3_tc.cuh"

// dout, out [N, Cin, S], a2 [N, C, S], sc2/sh2 [C]; g3 [N, Cin, S]; part
// [splits, Cin, C + 1] scratch; red [Cin, C + 1]: P in columns 0..C-1, sum
// g3 in column C. All float32, contiguous; with wide set, S % 4 == 0 and
// dout, out, a2 and g3 16-byte aligned. Returns a cudaError_t.
extern "C" int fused_block_bwd_reduce3_f32(
    const float* dout, const float* out, const float* a2, const float* sc2,
    const float* sh2, float* g3, float* part, float* red, int N, int Cin,
    int C, int S, int splits, int chunk, int wide, void* stream) {
  const long ns = (long)N * S;
  if (N <= 0 || Cin <= 0 || C <= 0 || S <= 0 ||
      !reduce3::splits_ok(ns, splits, chunk))
    return (int)cudaErrorInvalidValue;
  if (wide && (S % 4 || !reduce3::aligned16(dout) ||
               !reduce3::aligned16(out) || !reduce3::aligned16(a2) ||
               !reduce3::aligned16(g3)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int NS = (int)ns;
  if (C <= 64)
    return wide ? reduce3::launch<64, true>(dout, out, a2, sc2, sh2, g3, part,
                                            red, Cin, C, S, NS, splits, chunk,
                                            s)
                : reduce3::launch<64, false>(dout, out, a2, sc2, sh2, g3,
                                             part, red, Cin, C, S, NS, splits,
                                             chunk, s);
  return wide ? reduce3::launch<128, true>(dout, out, a2, sc2, sh2, g3, part,
                                           red, Cin, C, S, NS, splits, chunk,
                                           s)
              : reduce3::launch<128, false>(dout, out, a2, sc2, sh2, g3, part,
                                            red, Cin, C, S, NS, splits, chunk,
                                            s);
}

// g3 [N, Cin, S], a2 [N, C, S], sc2/sh2/v0/inv2/m2 [C]; amat = [amat |
// bmat] stacked [rows, lda]: lda a multiple of 16 >= Cin + C, rows the
// row tiles x their 64 or 128 rows, zeros past C and past Cin + C,
// 16-byte aligned; g2 [N, C, S], part [2, C, T] scratch, stats [2, C]
// (sum g2, sum g2 * xhat2); T the column tiles of N*S (bwd_apply3_tc.cuh:
// 128 columns where C <= 64, else 64); with wide set, S % 4 == 0 and g3,
// a2, g2 16-byte aligned.
extern "C" int fused_block_bwd_apply3_f32(
    const float* g3, const float* a2, const float* sc2, const float* sh2,
    const float* amat, const float* v0, const float* inv2, const float* m2,
    float* g2, float* part, float* stats, int N, int Cin, int C, int S,
    int lda, int T, int wide, void* stream) {
  if (!bwd_apply3::grid_ok(g3, a2, amat, g2, N, Cin, C, S, lda, T, wide))
    return (int)cudaErrorInvalidValue;
  return bwd_apply3::launch(g3, a2, sc2, sh2, amat, v0, inv2, m2, g2, part,
                            stats, N, Cin, C, S, lda, T, wide,
                            static_cast<cudaStream_t>(stream));
}

// g2, a2, a1 [N, C, H*W], sc1/sh1/p2/q2/r2/inv1/m1 [C], taps_t [9, C, C]
// = taps[8 - t]^T (16-byte aligned); da2 [N, C, H*W] scratch; g1 [N, C,
// H*W], part [2, C, T] scratch, stats [2, C] (sum g1, sum g1 * xhat1),
// wpart [splits, 9, C, C] scratch, dtaps [9, C, C]; C % 8 == 0; T = N *
// ceil(H * (W + 2) / 224); split p of the tap gradients takes the
// 32-position pieces [p * per, (p + 1) * per) of N * ceil(H * (W + 2) /
// 32) (bwd_mid_tc.cuh).
extern "C" int fused_block_bwd_mid_f32(
    const float* g2, const float* a2, const float* a1, const float* sc1,
    const float* sh1, const float* p2, const float* q2, const float* r2,
    const float* inv1, const float* m1, const float* taps_t, float* da2,
    float* g1, float* part, float* stats, float* wpart, float* dtaps, int N,
    int C, int H, int W, int T, int splits, int per, void* stream) {
  if (!bwd_mid::grid_ok(taps_t, N, C, H, W, T, splits, per))
    return (int)cudaErrorInvalidValue;
  return bwd_mid::launch(g2, a2, a1, sc1, sh1, p2, q2, r2, inv1, m1, taps_t,
                         da2, g1, part, stats, wpart, dtaps, N, C, H, W, T,
                         splits, per, static_cast<cudaStream_t>(stream));
}

// g3, x [N, Cin, S], g1, a1 [N, C, S], p1/q1/r1 [C], w1 [C, Cin] at row
// pitch ldw (a multiple of 4 >= Cin, zeros past Cin, 16-byte aligned); dx
// [N, Cin, S], da1 [N, C, S] scratch, wpart [splits, C, Cin] scratch, dw1
// [C, Cin]; split p of dW1 takes the 32-column pieces [p * P / splits,
// (p + 1) * P / splits) of the P = ceil(N*S / 32) (bwd_final_tc.cuh);
// with wide set, S % 4 == 0 and g3, g1, a1, x, dx, da1 16-byte aligned.
extern "C" int fused_block_bwd_final_f32(
    const float* g3, const float* g1, const float* a1, const float* x,
    const float* p1, const float* q1, const float* r1, const float* w1,
    float* dx, float* da1, float* wpart, float* dw1, int N, int Cin, int C,
    int S, int ldw, int splits, int wide, void* stream) {
  if (!bwd_final::grid_ok(g3, g1, a1, x, w1, dx, da1, N, Cin, C, S, ldw,
                          splits, wide))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return wide ? bwd_final::launch<true>(g3, g1, a1, x, p1, q1, r1, w1, dx, da1,
                                        wpart, dw1, N, Cin, C, S, ldw, splits,
                                        s)
              : bwd_final::launch<false>(g3, g1, a1, x, p1, q1, r1, w1, dx,
                                         da1, wpart, dw1, N, Cin, C, S, ldw,
                                         splits, s);
}
