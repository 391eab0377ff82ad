// Bottleneck-chain kernels for Hopper (sm_90a), forward and backward,
// bfloat16 activations, taps and weights (the bench trains ResNet-50 in
// bf16).
//
// Replace the TPU kernels of paddle_tpu/kernels/fused_block.py as they run
// on bf16 tiles ("activations bf16 (the bench dtype) or f32", :37-38),
// with the float32 kernels' layouts (csrc/fused_block.cu,
// csrc/fused_block_bwd.cu). The forward:
//   conv1x1_stats_bf16 (pallas_call :790, body _k1_kernel :568): y[n] =
//     W1 x[n], x [N, Cin, S], W1 [C, Cin]; the bf16 products summed in
//     float32, y rounded once to bf16; float32 sums of the ROUNDED y;
//   conv3x3_norm_stats_bf16 (:653, _k2_kernel :588): the 3x3 same-padded
//     conv of h = relu(x * sc + sh), taps [9, Cout, Cin] indexed [(dy+1)*3
//     + (dx+1)], an out-of-image tap reading 0; h in float32 (one fma),
//     rounded to bf16 as it lands in shared memory; the nine taps into one
//     float32 accumulator; y rounded once; the sums of the rounded y;
//   norm_relu_moments_bf16 (:714, _moments_kernel :684): sum_h [C] and
//     M2 = sum_{n,s} h h^T [C, C], float32, of h rounded to bf16;
//   conv1x1_bn_residual_bf16 (:756, _assemble_kernel :735): out[n] =
//     relu(fma(W3 h2[n], sc3, sh3) + x[n]), h2 = bf16(relu(a2 * sc2 +
//     sh2)); a3 stays float32; out rounded once to bf16.
// The backward:
//   bwd_reduce3_bf16 (:192, _b1a_kernel :160): g3 = dout where out > 0,
//     exact; P = sum g3 h2^T [Cin, C] and sum g3, float32, h2 = bf16(relu(
//     fma(a2, sc2, sh2)));
//   bwd_apply3_bf16 (:261, _b1b_kernel :224): g2 = bf16(A g3 + B h2 + v0)
//     where h2f = fma(a2, sc2, sh2) > 0, A, B bf16; sum g2 and sum g2 x^2
//     of the rounded g2, float32;
//   bwd_mid_bf16 (:399, _b2_kernel :295): da2 = bf16(fma(g2, p2, a2 * q2)
//     + r2); g1 = bf16(the 3x3's input gradient of da2) where h1f > 0;
//     sum g1, sum g1 x^1; dtaps [9, C, C] = sum da2 h1^T at each tap's
//     shift, h1 = bf16(h1f), float32;
//   bwd_final_bf16 (:466, _b3_kernel :436): da1 = bf16(fma(g1, p1, a1 *
//     q1) + r1); dx = bf16(W1^T da1 + g3); dW1 = sum da1 x^T, float32.
// scale and shift are float32 everywhere, as the Pallas kernels take them;
// every affine rounds where XLA rounds the Pallas kernels' (checked on
// operands where contracting shows): the normalize x * sc + sh one fmaf,
// the folded BN backward g * p + a * q + r as fmaf(g, p, a * q) then + r,
// its product and sum rounded apart (__fmul_rn, __fadd_rn), as nvcc would
// otherwise contract them on its own.
//
// What bounds them on the H100. At ResNet-50's chain stages (batch 128;
// Cin, C, S = 256, 64, 3136 / 512, 128, 784 / 1024, 256, 196), each input
// read once and each output written once in bf16 at 3.35 TB/s, products
// at the 989 TFLOP/s dense bf16 rate:
//   conv1x1_stats: 256.9 / 128.5 / 64.2 MB, 0.0767 / 0.0384 / 0.0192 ms;
//     13.2 GFLOP, 0.0133 ms: bytes;
//   conv3x3_norm_stats: 102.8 / 51.4 / 25.7 MB, 0.0307 / 0.0153 / 0.0077
//     ms; 29.6 GFLOP, 0.0299 ms: bytes at 56x56 (by a hair), operations
//     at 28x28 and 14x14;
//   norm_relu_moments: a2 read, 51.4 / 25.7 / 12.8 MB, 0.0153 / 0.0077 /
//     0.0038 ms; 1.7 GFLOP (M2 is symmetric): bytes;
//   conv1x1_bn_residual: 462.4 / 231.2 / 115.6 MB, 0.1380 / 0.0690 /
//     0.0345 ms: bytes (csrc/conv1x1_bf16_tc.cuh).
//   bwd_reduce3: 668 / 334 / 168 MB, 0.1994 / 0.0998 / 0.0502 ms; 13.2
//     GFLOP: bytes;
//   bwd_apply3: 308 / 154 / 78 MB, 0.0920 / 0.0461 / 0.0232 ms; 16.4
//     GFLOP, 0.0166 ms: bytes;
//   bwd_mid: 205.5 MB at 56x56, 0.0614 ms, 59.2 GFLOP, 0.0599 ms: bytes
//     by a hair; operations at 28x28 and 14x14;
//   bwd_final: 719 / 360 / 182 MB, 0.2148 / 0.1075 / 0.0542 ms; 26.3
//     GFLOP: bytes.
// In bf16 there is no 3xTF32 split: each product is one bf16 product of
// exact operands, so the tensor cores do a third of the float32 kernels'
// work on half their bytes.
//
// What the design does about it: right and simple first; the redesign for
// speed (wgmma fed by TMA, csrc/sm90.cuh) has begun with the products over
// N * S of bwd_reduce3, bwd_mid's tap gradients and bwd_final's dW1
// (csrc/abt_bf16_tc.cuh), and the 1x1 tile of conv1x1_bn_residual and
// bwd_final's dx (csrc/conv1x1_bf16_tc.cuh). One tile product serves the
// rest: 8 warps as 2 (rows) x 4 (columns), each warp
// (BM / 2) x (BN / 4), bf16 mma.sync.m16n8k16 with float32 accumulators,
// both operands from shared memory by ldmatrix (the A rows and, for the
// moments and the 3x3, the B rows K-contiguous; the 1x1s' x [K][columns]
// through ldmatrix.trans). Every operand goes through registers on its way
// to shared memory (load, widen, normalize, round, store), because the 3x3,
// the moments and the residual 1x1 normalize their input as it loads.
//   - conv1x1_stats (c1::conv1x1_bf16_kernel): a block owns BM rows of M (64 where M <= 64, else 128) by 128 columns
//     j = n * S + s of N * S (a tile may hold the end of one image and the
//     start of the next, so S = 196 leaves no column idle), K in stages of
//     32 through two shared buffers, the next stage's loads in registers
//     while the tensor cores take this one: one barrier a stage. A = W at
//     a row pitch lda (zero-padded by the wrapper where M is not whole row
//     tiles or K not whole stages); x's 4 columns an 8-byte load where S %
//     4 == 0, else one by one; K past its end and columns past N * S zero.
//   - conv3x3_norm_stats (c3::conv3x3_bf16_kernel): the float32 kernel's
//     padded grid: each image's output on H rows of W + 2 positions, a
//     block 128 consecutive positions of it by BM output channels; h lands
//     as [position][16 channels] over the halo the nine taps read (128 +
//     2 (W + 2) + 2 positions, zero where the padded plane has no pixel),
//     so tap (dy, dx) is B's rows shifted by dy (W + 2) + dx. Cin in
//     stages of 16; all nine taps' A slices a stage. Positions on the pad
//     columns compute and are dropped: they add nothing to the sums.
//   - norm_relu_moments (mom::moments_bf16_kernel): a block owns a BM x BM
//     tile of M2's upper triangle and a split of N * S in 32-position
//     stages; A and B are the tile's row and column channels of h, both
//     [channel][32 positions]; a diagonal tile loads one and reads it as
//     both, and sums its channels' h for sum_h. Positions past N * S give
//     h = 0, not relu(sh). Each element (i <= j) is written to (i, j) and
//     (j, i) of the split's partial: M2 exactly symmetric.
//   - The backward reuses the 1x1 and 3x3 tiles: bwd_apply3 is the 1x1
//     over K = Cin + C, B's rows g3's, then a2's normalized as they land
//     (c1 mode kApply3: the mask, v0, one rounding and the sums in the
//     epilogue); bwd_mid's input gradient the 3x3 over da2 as it lands,
//     the taps flipped and transposed by the wrapper (c3 mode kInputGrad:
//     h1's mask, one rounding and bn1's sums in the epilogue). da2 and da1
//     are folded once into a bf16 scratch (fold_bf16_kernel).
//   - P and Sum g3 (bwd_reduce3), the nine tap gradients (bwd_mid) and
//     dW1 = Sum da1 x^T (bwd_final) run on one split product on wgmma fed
//     by TMA, csrc/abt_bf16_tc.cuh (abw::): 64-position stages of one
//     image, the transformed operand (g3, h2; h1) made once a stage, the
//     taps all nine in one pass.
//   - conv1x1_bn_residual and bwd_final's dx (W1^T da1 + g3, one rounding)
//     run on the 1x1 tile on wgmma fed by TMA, csrc/conv1x1_bf16_tc.cuh
//     (t1::): W once a block, 64-position stages of B and the addend, the
//     epilogue over the addend's tile in shared memory.
//   - Sums: a partial per tile (a thread's columns in order, then the
//     row's threads in order), then fused_block.cuh's passes in fixed
//     order. No float atomics: two calls on one input give the same bits.
// Shapes: contiguous bf16 tensors, 16-byte aligned; the 3x3's Cin (and
// bwd_mid's C) a multiple of 16; C and Cin at most kMaxC (4096, eight times the widest C
// of ResNet-50's blocks: the moments' split partials grow as splits x C^2,
// 8.6 GB at 128 splits there), the 1x1 tile's K at most t1::kMaxK (256);
// the wgmma kernels' widths multiples of abw::group_of(S); N * S below
// 2^31; each entry point refuses anything else before it launches.
#include <cstdint>

#include "fused_block.cuh"
#include "sm90.cuh"

namespace {

typedef uint16_t bf16;  // the bits of one bfloat16

constexpr int kMaxC = 4096;    // the widest C (and Cin) the kernels take
constexpr int kMaxSplits = 128;  // the moments' most splits of N * S

// bf16 bits -> float; float -> bf16 bits rounded to nearest, ties to even
// (finite values), by integer ops on the bits
__device__ __forceinline__ float bf(bf16 h) {
  return __uint_as_float((uint32_t)h << 16);
}
__device__ __forceinline__ bf16 to_bf(float x) {
  const uint32_t u = __float_as_uint(x);
  return (bf16)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}
__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return (uint32_t)lo | (uint32_t)hi << 16;
}
// h = bf16(relu(v * sc + sh)) of a bf16 v, the affine one fma
__device__ __forceinline__ bf16 norm_bf(bf16 v, float sc, float sh) {
  return to_bf(relu_affine(bf(v), sc, sh));
}
__device__ __forceinline__ uint32_t norm2(uint32_t v, float sc, float sh) {
  return pack(norm_bf((bf16)(v & 0xffffu), sc, sh),
              norm_bf((bf16)(v >> 16), sc, sh));
}

// ---- bf16 tensor-core product and its fragment loads (and a pair's
// rounding to bf16)
// lo and hi rounded to bf16 (to nearest, ties to even: to_bf's rounding
// of finite values) in one instruction, lo in the low half.
__device__ __forceinline__ uint32_t cvt_bf2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
// d += a b over one m16n8k16 tile: a (16 x 16, row) and b (16 x 8, col)
// bf16, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// Four 8 x 8 bf16 matrices from shared memory, lanes 8 j .. 8 j + 7
// giving the 16-byte rows of matrix j; with kTrans each transposed.
template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  if (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(s));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(s));
}
// -----------------------------------------------------------------------------

// acc[MT][NT] += A · B over one k16 step of a warp's tile. A at `a`: the
// warp's first row, [rows][lda] bf16, K contiguous. B at `b`: with kTrans
// [k][ldb] (the warp's columns contiguous, from its first column), else
// [column][ldb] (K contiguous, from its first column). NT is even.
template <int MT, int NT, bool kTrans>
__device__ __forceinline__ void warp_k16(float (&acc)[MT][NT][4],
                                         const bf16* a, int lda,
                                         const bf16* b, int ldb) {
  const int lane = threadIdx.x & 31;
  uint32_t af[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
    ldsm_x4<false>(af[i], a + (16 * i + (lane & 15)) * lda + (lane >> 4) * 8);
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    uint32_t bq[4];
    if (kTrans)
      ldsm_x4<true>(bq, b + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldb +
                            8 * j + (lane >> 4) * 8);
    else
      ldsm_x4<false>(bq, b + (8 * j + (lane & 7) + (lane >> 4) * 8) * ldb +
                             ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      mma_bf16(acc[i][j], af[i], bq[0], bq[1]);
      mma_bf16(acc[i][j + 1], af[i], bq[2], bq[3]);
    }
  }
}

// The columns j = n * S + s of N * S as offsets n * rows * S + s into a
// [N, rows, S] tensor; -1 past N * S.
__device__ __forceinline__ long col_off(long j, long NS, int S, int rows) {
  if (j >= NS) return -1;
  const long n = j / S;
  return n * rows * S + (j - n * S);
}

// A row's (s, q) partials of a thread: 16 a row in red [2][BM][16] (slot
// 4 wn + t), then store_row_partials adds them in slot order.
template <int BM>
__device__ __forceinline__ void put_row(float* red, int lr, int slot, float s,
                                        float q) {
  red[lr * 16 + slot] = s;
  red[(BM + lr) * 16 + slot] = q;
}

namespace c1 {

constexpr int kBN = 128, kBK = 32;
constexpr int kAP = kBK + 8;   // A's row pitch (bf16): 80 bytes
constexpr int kBP = kBN + 8;   // B's row pitch: 272 bytes
// kStats: y = W x and its partial sums; kApply3: B = [g3; h2], h2
// normalized as it lands, g2 = bf16(acc + v0) where h2f > 0, the partial
// sums of the rounded g2 and of g2 x^2. (Modes 1 and 3, conv1x1_bn_residual
// and bwd_final's dx, moved to csrc/conv1x1_bf16_tc.cuh.)
enum { kStats = 0, kApply3 = 2 };

// B's rows k < K1 come from x ([N, K1, S]) as they are; rows K1 <= k < K
// from xn ([N, K - K1, S], row k - K1) normalized by sc, sh of that row.
// The epilogue's e (kApply3: a2) is [N, M, S]; f0 (kApply3: v0) and inv,
// mean (kApply3: x^2 = a2 * inv - mean * inv) are per output row.
struct Args {
  const bf16* x;
  const bf16* xn;
  const bf16* w;
  const float* sc;
  const float* sh;
  const bf16* e;
  const float* f0;
  const float* inv;
  const float* mean;
  bf16* y;
  float* part;
  int N, K1, K, M, S, lda;
};

template <int BM>
constexpr int smem_bytes() {
  return 2 * (BM * kAP + kBK * kBP) * 2;  // two stages of A and B
}

// y = W · B over K, M rows, in the epilogue of kMode.
template <int BM, int kMode, bool kWide>
__global__ void __launch_bounds__(kThreads, 2)
conv1x1_bf16_kernel(const Args a) {
  constexpr int MT = BM / 32, NT = 4, AV = BM * kBK / 8 / kThreads;
  constexpr bool kNorm = kMode == kApply3;  // B has rows normalized
  extern __shared__ float4 smem4[];
  bf16* As = reinterpret_cast<bf16*>(smem4);
  bf16* Bs = As + 2 * BM * kAP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, t = lane & 3;
  const int K = a.K, K1 = a.K1, M = a.M, S = a.S;
  const long NS = (long)a.N * S, j0 = (long)blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  // this thread's loads: 4 columns (group cg) of 4 K rows a stage, at
  // offsets off into x and offn into xn
  const int cg = tid & 31, kr = tid >> 5;
  long off[4], offn[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const long j = j0 + 4 * cg + e;
    off[e] = (kWide && e) ? -1 : col_off(j, NS, S, K1);
    offn[e] = (kWide && e) ? -1 : col_off(j, NS, S, K - K1);
  }
  uint4 ra[AV];
  uint2 rb[4];
  auto read = [&](const bf16* src, const long (&o)[4], long ks) {
    if (kWide) {
      return o[0] >= 0 ? __ldg(reinterpret_cast<const uint2*>(src + o[0] + ks))
                       : make_uint2(0u, 0u);
    }
    bf16 h[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = o[e] >= 0 ? src[o[e] + ks] : 0;
    return make_uint2(pack(h[0], h[1]), pack(h[2], h[3]));
  };
  auto load = [&](int k0) {
#pragma unroll
    for (int v = 0; v < AV; ++v) {
      const int idx = tid + v * kThreads;
      ra[v] = __ldg(reinterpret_cast<const uint4*>(
          a.w + (long)(m0 + (idx >> 2)) * a.lda + k0 + (idx & 3) * 8));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + kr + 8 * i;
      uint2 v = make_uint2(0u, 0u);
      if (k < K1)
        v = read(a.x, off, (long)k * S);
      else if (kNorm && k >= K1 && k < K)
        v = read(a.xn, offn, (long)(k - K1) * S);
      rb[i] = v;
    }
  };
  auto store = [&](int buf, int k0) {
    bf16* as = As + buf * BM * kAP;
    bf16* bs = Bs + buf * kBK * kBP;
#pragma unroll
    for (int v = 0; v < AV; ++v) {
      const int idx = tid + v * kThreads;
      *reinterpret_cast<uint4*>(as + (idx >> 2) * kAP + (idx & 3) * 8) = ra[v];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint2 v = rb[i];
      const int k = k0 + kr + 8 * i;
      if (kNorm && k >= K1 && k < K) {
        const float s = __ldg(a.sc + k - K1), h = __ldg(a.sh + k - K1);
        v = make_uint2(norm2(v.x, s, h), norm2(v.y, s, h));
      }
      *reinterpret_cast<uint2*>(bs + (kr + 8 * i) * kBP + 4 * cg) = v;
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int stages = (K + kBK - 1) / kBK;
  load(0);
  for (int st = 0; st < stages; ++st) {
    const int buf = st & 1;
    store(buf, st * kBK);
    __syncthreads();
    if (st + 1 < stages) load((st + 1) * kBK);
    const bf16* as = As + (buf * BM + wm * (BM / 2)) * kAP;
    const bf16* bs = Bs + buf * kBK * kBP + wn * (kBN / 4);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16)
      warp_k16<MT, NT, true>(acc, as + kk, kAP, bs + kk * kBP, kBP);
  }

  // the epilogue: this thread's 8 columns, then its 2 MT rows
  long oc[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      oc[j][e] = col_off(j0 + wn * (kBN / 4) + 8 * j + 2 * t + e, NS, S, M);
  {
    float* red = reinterpret_cast<float*>(smem4);  // over A, after the loop
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int lr = wm * (BM / 2) + 16 * i + g + 8 * hf, row = m0 + lr;
        float s = 0.f, q = 0.f;
        if (kMode == kStats) {
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              // columns past N * S and rows past M hold 0: they add nothing
              const bf16 yb = to_bf(acc[i][j][2 * hf + e]);
              const float yf = bf(yb);
              if (oc[j][e] >= 0 && row < M) a.y[oc[j][e] + (long)row * S] = yb;
              s += yf;
              q = fmaf(yf, yf, q);
            }
        } else if (row < M) {
          const float s2 = __ldg(a.sc + row), h2 = __ldg(a.sh + row);
          const float v0 = __ldg(a.f0 + row), iv = __ldg(a.inv + row);
          const float xs = -(__ldg(a.mean + row) * iv);
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (oc[j][e] < 0) continue;
              const long o = oc[j][e] + (long)row * S;
              const float av = bf(a.e[o]);
              const bf16 gb =
                  to_bf(fmaf(av, s2, h2) > 0.f ? acc[i][j][2 * hf + e] + v0
                                               : 0.f);
              const float gf = bf(gb);
              a.y[o] = gb;
              s += gf;
              q = fmaf(gf, fmaf(av, iv, xs), q);
            }
        }
        put_row<BM>(red, lr, 4 * wn + t, s, q);
      }
    store_row_partials<BM>(a.part, M, gridDim.x, m0, blockIdx.x, red);
  }
}

inline bool ok(const Args& a, int wide) {
  const long NS = (long)a.N * a.S;
  return a.N > 0 && a.K > 0 && a.M > 0 && a.S > 0 && a.K1 >= 0 &&
         a.K1 <= a.K && a.K1 <= kMaxC && a.K - a.K1 <= kMaxC && a.M <= kMaxC &&
         NS <= INT_MAX - kBN && a.lda % kBK == 0 && a.lda >= a.K &&
         (reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.xn) |
          reinterpret_cast<uintptr_t>(a.w) | reinterpret_cast<uintptr_t>(a.y)) %
                 16 ==
             0 &&
         (!wide || a.S % 4 == 0);
}

template <int BM, int kMode, bool kWide>
int launch_bm(const Args& a, cudaStream_t s) {
  const dim3 grid((unsigned)(((long)a.N * a.S + kBN - 1) / kBN),
                  (unsigned)((a.M + BM - 1) / BM));
  conv1x1_bf16_kernel<BM, kMode, kWide><<<grid, kThreads, smem_bytes<BM>(),
                                          s>>>(a);
  return (int)cudaGetLastError();
}

template <int kMode>
int launch(const Args& a, int wide, cudaStream_t s) {
  if (a.M <= 64)
    return wide ? launch_bm<64, kMode, true>(a, s)
                : launch_bm<64, kMode, false>(a, s);
  return wide ? launch_bm<128, kMode, true>(a, s)
              : launch_bm<128, kMode, false>(a, s);
}

}  // namespace c1

namespace c3 {

constexpr int kBN = 128, kBK = 16;
constexpr int kP = kBK + 8;    // A's and B's row pitch (bf16): 48 bytes
// kNormStats: h = bf16(relu(x * sc + sh)) lands, y = bf16(acc) and its
// partial sums; kInputGrad: x lands as it is (the 3x3's input gradient
// over da2, the taps flipped and transposed), y = bf16(acc) where h1f =
// fma(a1, msc, msh) > 0, the partial sums of y and of y x^1 (x^1 = a1 *
// inv - mean * inv).
enum { kNormStats = 0, kInputGrad = 1 };

__host__ __device__ inline int halo(int W) { return kBN + 2 * (W + 2) + 2; }
template <int BM>
inline int smem_bytes(int W) {
  return (9 * BM + halo(W)) * kP * 2 + halo(W) * 4;
}

template <int BM, int kMode>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ taps,
                    const float* __restrict__ sc, const float* __restrict__ sh,
                    const bf16* __restrict__ a1,
                    const float* __restrict__ msc,
                    const float* __restrict__ msh,
                    const float* __restrict__ inv,
                    const float* __restrict__ mean, bf16* __restrict__ y,
                    float* __restrict__ part, int Cin, int Cout, int H, int W,
                    int chunks) {
  constexpr int MT = BM / 32, NT = 4;
  extern __shared__ float4 smem4[];
  bf16* As = reinterpret_cast<bf16*>(smem4);  // [9][BM][kP]
  bf16* Bs = As + 9 * BM * kP;                // [L][kP]
  const int Wp = W + 2, L = halo(W), S = H * W;
  int* pix = reinterpret_cast<int*>(Bs + L * kP);  // [L]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, t = lane & 3;
  const int n = blockIdx.x / chunks, q0 = (blockIdx.x - n * chunks) * kBN;
  const int m0 = blockIdx.y * BM;
  // halo position i is index q0 + i of the padded plane, (H + 2) rows of
  // W + 2: the pixel there, or -1 on the padding
  for (int i = tid; i < L; i += kThreads) {
    const int gq = q0 + i, r = gq / Wp, c = gq - r * Wp;
    pix[i] = (r >= 1 && r <= H && c >= 1 && c <= W) ? (r - 1) * W + c - 1
                                                     : -1;
  }
  const bf16* xn = x + (long)n * Cin * S;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  for (int ci0 = 0; ci0 < Cin; ci0 += kBK) {
    __syncthreads();  // the last stage's products are done (and pix is set)
    for (int v = tid; v < 9 * BM * 2; v += kThreads) {
      const int tap = v / (2 * BM), rem = v - tap * 2 * BM, row = rem >> 1;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + row < Cout)
        val = __ldg(reinterpret_cast<const uint4*>(
            taps + ((long)tap * Cout + m0 + row) * Cin + ci0 + (rem & 1) * 8));
      *reinterpret_cast<uint4*>(As + (tap * BM + row) * kP + (rem & 1) * 8) =
          val;
    }
    for (int e = tid; e < (kBK / 2) * L; e += kThreads) {
      const int cp = e / L, i = e - cp * L, ci = ci0 + 2 * cp, p = pix[i];
      uint32_t v = 0u;
      if (p >= 0) {
        const bf16* src = xn + (long)ci * S + p;
        v = kMode == kInputGrad
                ? pack(src[0], src[S])
                : pack(norm_bf(src[0], __ldg(sc + ci), __ldg(sh + ci)),
                       norm_bf(src[S], __ldg(sc + ci + 1), __ldg(sh + ci + 1)));
      }
      *reinterpret_cast<uint32_t*>(Bs + i * kP + 2 * cp) = v;
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * Wp + tap % 3;
      warp_k16<MT, NT, false>(acc, As + (tap * BM + wm * (BM / 2)) * kP, kP,
                              Bs + (wn * (kBN / 4) + shift) * kP, kP);
    }
  }

  // the epilogue: positions on the pad columns or past the grid dropped
  int oc[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = q0 + wn * (kBN / 4) + 8 * j + 2 * t + e, r = q / Wp;
      oc[j][e] = (q < H * Wp && q - r * Wp < W) ? r * W + q - r * Wp : -1;
    }
  float* red = reinterpret_cast<float*>(smem4);  // over A, after the loop
  __syncthreads();
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int lr = wm * (BM / 2) + 16 * i + g + 8 * hf, row = m0 + lr;
      float s = 0.f, q = 0.f, ms = 0.f, mh = 0.f, iv = 0.f, xs = 0.f;
      if (kMode == kInputGrad && row < Cout) {
        ms = __ldg(msc + row), mh = __ldg(msh + row), iv = __ldg(inv + row);
        xs = -(__ldg(mean + row) * iv);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (oc[j][e] < 0 || row >= Cout) continue;
          const long o = ((long)n * Cout + row) * S + oc[j][e];
          float v = acc[i][j][2 * hf + e], av = 0.f;
          if (kMode == kInputGrad) {
            av = bf(a1[o]);
            if (!(fmaf(av, ms, mh) > 0.f)) v = 0.f;
          }
          const bf16 yb = to_bf(v);
          const float yf = bf(yb);
          y[o] = yb;
          s += yf;
          q = fmaf(yf, kMode == kInputGrad ? fmaf(av, iv, xs) : yf, q);
        }
      put_row<BM>(red, lr, 4 * wn + t, s, q);
    }
  store_row_partials<BM>(part, Cout, gridDim.x, m0, blockIdx.x, red);
}

template <int BM, int kMode>
int launch_bm(const bf16* x, const bf16* taps, const float* sc,
              const float* sh, const bf16* a1, const float* msc,
              const float* msh, const float* inv, const float* mean, bf16* y,
              float* part, int N, int Cin, int Cout, int H, int W, int chunks,
              cudaStream_t s) {
  const int bytes = smem_bytes<BM>(W);
  cudaFuncSetAttribute(conv3x3_bf16_kernel<BM, kMode>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const dim3 grid((unsigned)(N * chunks), (unsigned)((Cout + BM - 1) / BM));
  conv3x3_bf16_kernel<BM, kMode><<<grid, kThreads, bytes, s>>>(
      x, taps, sc, sh, a1, msc, msh, inv, mean, y, part, Cin, Cout, H, W,
      chunks);
  return (int)cudaGetLastError();
}

template <int kMode>
int launch(const bf16* x, const bf16* taps, const float* sc, const float* sh,
           const bf16* a1, const float* msc, const float* msh,
           const float* inv, const float* mean, bf16* y, float* part, int N,
           int Cin, int Cout, int H, int W, int chunks, cudaStream_t s) {
  return Cout <= 64 ? launch_bm<64, kMode>(x, taps, sc, sh, a1, msc, msh, inv,
                                           mean, y, part, N, Cin, Cout, H, W,
                                           chunks, s)
                    : launch_bm<128, kMode>(x, taps, sc, sh, a1, msc, msh,
                                            inv, mean, y, part, N, Cin, Cout,
                                            H, W, chunks, s);
}

// The entry points' checks: Cin a multiple of 16, both widths within the
// cap, T the column tiles of the padded grid, the block's shared memory.
inline bool ok(int N, int Cin, int Cout, int H, int W, int T) {
  const long chunks = ((long)H * (W + 2) + kBN - 1) / kBN;
  return N > 0 && Cin > 0 && Cout > 0 && H > 0 && W > 0 && Cin % kBK == 0 &&
         Cin <= kMaxC && Cout <= kMaxC && (long)N * chunks == (long)T &&
         (long)H * (W + 2) <= INT_MAX / 2 &&
         (Cout <= 64 ? smem_bytes<64>(W) : smem_bytes<128>(W)) <= 227 * 1024;
}

}  // namespace c3

namespace mom {

constexpr int kBK = 32;
constexpr int kP = kBK + 8;    // row pitch (bf16): 80 bytes

template <int BM>
constexpr int smem_bytes() {
  return 2 * 2 * BM * kP * 2;  // two stages of the row and column channels
}

// Tile `tile` of M2's upper triangle, column tile by column tile: (rt, ct)
// with rt <= ct.
__device__ __forceinline__ void tile_of(int tile, int& rt, int& ct) {
  ct = 0;
  while (tile > ct) tile -= ++ct;
  rt = tile;
}

template <int BM, bool kWide>
__global__ void __launch_bounds__(kThreads, 2)
moments_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ sc,
                    const float* __restrict__ sh, float* __restrict__ part,
                    int N, int C, int S, int pieces, int splits) {
  constexpr int MT = BM / 32, NT = BM / 32, RI = BM / 32;
  extern __shared__ float4 smem4[];
  bf16* As = reinterpret_cast<bf16*>(smem4);  // [2][BM][kP]
  bf16* Bs = As + 2 * BM * kP;                // [2][BM][kP]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, t = lane & 3;
  int rt, ct;
  tile_of(blockIdx.x, rt, ct);
  const bool diag = rt == ct;
  const int ra = rt * BM, rb = ct * BM, split = blockIdx.y;
  const long p0 = (long)split * pieces / splits;
  const long p1 = (long)(split + 1) * pieces / splits;
  const long NS = (long)N * S;
  // this thread's loads: positions 4 pg .. 4 pg + 3 of a stage, of the RI
  // channels r0 + 32 i of the row tile (and of the column tile)
  const int pg = tid & 7, r0 = tid >> 3;
  uint2 xa[RI], xb[RI];
  unsigned valid = 0;   // bit e: position 4 pg + e of the stage is in N * S
  float hsum[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) hsum[i] = 0.f;
  auto read = [&](const long (&off)[4], int c) {
    uint2 v = make_uint2(0u, 0u);
    if (c >= C) return v;
    const long cs = (long)c * S;
    if (kWide) {
      if (off[0] >= 0) v = __ldg(reinterpret_cast<const uint2*>(x + off[0] + cs));
    } else {
      bf16 h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) h[e] = off[e] >= 0 ? x[off[e] + cs] : 0;
      v = make_uint2(pack(h[0], h[1]), pack(h[2], h[3]));
    }
    return v;
  };
  auto load = [&](long piece) {
    const long j = piece * kBK + 4 * pg;
    long off[4];
    valid = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long o = col_off(j + e, NS, S, C);
      off[e] = (kWide && e) ? -1 : o;
      valid |= (o >= 0 ? 1u : 0u) << e;
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      xa[i] = read(off, ra + r0 + 32 * i);
      if (!diag) xb[i] = read(off, rb + r0 + 32 * i);
    }
  };
  // h of 4 positions of channel c, zero past N * S and past C; with
  // `add`, their sum added to `sum` in position order
  auto normed = [&](uint2 v, int c, float& sum, bool add) {
    if (c >= C) return make_uint2(0u, 0u);
    const float s = __ldg(sc + c), h = __ldg(sh + c);
    bf16 o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t w = e < 2 ? v.x : v.y;
      o[e] = (valid >> e & 1u)
                 ? norm_bf((bf16)((e & 1) ? w >> 16 : w & 0xffffu), s, h)
                 : (bf16)0;
      if (add) sum += bf(o[e]);
    }
    return make_uint2(pack(o[0], o[1]), pack(o[2], o[3]));
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = r0 + 32 * i;
      *reinterpret_cast<uint2*>(As + (buf * BM + r) * kP + 4 * pg) =
          normed(xa[i], ra + r, hsum[i], diag);
      if (!diag)
        *reinterpret_cast<uint2*>(Bs + (buf * BM + r) * kP + 4 * pg) =
            normed(xb[i], rb + r, hsum[i], false);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  if (p0 < p1) load(p0);
  for (long pc = p0; pc < p1; ++pc) {
    const int buf = (int)((pc - p0) & 1);
    store(buf);
    __syncthreads();
    if (pc + 1 < p1) load(pc + 1);
    const bf16* a = As + (buf * BM + wm * (BM / 2)) * kP;
    const bf16* b = (diag ? As : Bs) + (buf * BM + wn * (BM / 4)) * kP;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16)
      warp_k16<MT, NT, false>(acc, a + kk, kP, b + kk, kP);
  }

  // M2: (i, j) and (j, i) from one value, i <= j; sum_h in column C
  float* P = part + (long)split * C * (C + 1);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = ra + wm * (BM / 2) + 16 * i + g + 8 * hf;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = rb + wn * (BM / 4) + 8 * j + 2 * t + e;
          if (r >= C || c >= C || (diag && r > c)) continue;
          const float v = acc[i][j][2 * hf + e];
          P[(long)r * (C + 1) + c] = v;
          P[(long)c * (C + 1) + r] = v;
        }
    }
  if (diag) {
    float* red = reinterpret_cast<float*>(smem4);  // [BM][8]
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RI; ++i) red[(r0 + 32 * i) * 8 + pg] = hsum[i];
    __syncthreads();
    if (tid < BM && ra + tid < C) {
      float s = 0.f;
      for (int p = 0; p < 8; ++p) s += red[tid * 8 + p];
      P[(long)(ra + tid) * (C + 1) + C] = s;
    }
  }
}

template <int BM, bool kWide>
int launch_bm(const bf16* x, const float* sc, const float* sh, float* part,
              int N, int C, int S, int splits, cudaStream_t s) {
  const int nt = (C + BM - 1) / BM;
  const int pieces = (int)(((long)N * S + kBK - 1) / kBK);
  const dim3 grid((unsigned)(nt * (nt + 1) / 2), (unsigned)splits);
  moments_bf16_kernel<BM, kWide><<<grid, kThreads, smem_bytes<BM>(), s>>>(
      x, sc, sh, part, N, C, S, pieces, splits);
  return (int)cudaGetLastError();
}

}  // namespace mom

#include "abt_bf16_tc.cuh"
#include "conv1x1_bf16_tc.cuh"

// da = bf16(fma(g, p, a * q) + r) over [N, C, S], the folded BN backward
// as XLA contracts the Pallas kernels' g * p + a * q + r; 4 elements a
// thread where S % 4 == 0 (one channel), else 1.
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
fold_bf16_kernel(const bf16* __restrict__ g, const bf16* __restrict__ a,
                 const float* __restrict__ p, const float* __restrict__ q,
                 const float* __restrict__ r, bf16* __restrict__ da, long E,
                 int C, int S) {
  constexpr int V = kWide ? 4 : 1;
  for (long i = ((long)blockIdx.x * kThreads + threadIdx.x) * V; i < E;
       i += (long)gridDim.x * kThreads * V) {
    const int c = (int)((i / S) % C);
    const float pc = __ldg(p + c), qc = __ldg(q + c), rc = __ldg(r + c);
    bf16 gv[4], av[4], o[4];
    if constexpr (kWide) {
      const uint2 gu = __ldg(reinterpret_cast<const uint2*>(g + i));
      const uint2 au = __ldg(reinterpret_cast<const uint2*>(a + i));
      const uint32_t gw[2] = {gu.x, gu.y}, aw[2] = {au.x, au.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        gv[e] = (bf16)((e & 1) ? gw[e >> 1] >> 16 : gw[e >> 1] & 0xffffu);
        av[e] = (bf16)((e & 1) ? aw[e >> 1] >> 16 : aw[e >> 1] & 0xffffu);
      }
    } else {
      gv[0] = g[i], av[0] = a[i];
    }
#pragma unroll
    for (int e = 0; e < V; ++e)
      o[e] = to_bf(__fadd_rn(fmaf(bf(gv[e]), pc, __fmul_rn(bf(av[e]), qc)),
                             rc));
    if constexpr (kWide)
      *reinterpret_cast<uint2*>(da + i) =
          make_uint2(pack(o[0], o[1]), pack(o[2], o[3]));
    else
      da[i] = o[0];
  }
}

int fold(const bf16* g, const bf16* a, const float* p, const float* q,
         const float* r, bf16* da, int N, int C, int S, cudaStream_t s) {
  const long E = (long)N * C * S;
  const int wide = S % 4 == 0;
  long blocks = (E / (wide ? 4 : 1) + kThreads - 1) / kThreads;
  if (blocks > 65535L * 32) blocks = 65535L * 32;  // then a grid-stride loop
  if (wide)
    fold_bf16_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        g, a, p, q, r, da, E, C, S);
  else
    fold_bf16_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        g, a, p, q, r, da, E, C, S);
  return (int)cudaGetLastError();
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// x [N, Cin, S], w [rows, lda]: W1 [C, Cin] at row pitch lda (a multiple
// of 32 >= Cin), its rows whole row tiles (64 where C <= 64, else 128),
// zeros past C and past Cin; y [N, C, S]; part [2, C, T] scratch, stats
// [2, C] float32 (sum, sum of squares of the rounded y); T = ceil(N * S /
// 128); wide: S % 4 == 0. bf16 tensors 16-byte aligned. Returns a
// cudaError_t (0 = launched).
extern "C" int fused_block_conv1x1_stats_bf16(const bf16* x, const bf16* w,
                                              bf16* y, float* part,
                                              float* stats, int N, int Cin,
                                              int C, int S, int lda, int T,
                                              int wide, void* stream) {
  const c1::Args a{x,       nullptr, w,       nullptr, nullptr, nullptr,
                   nullptr, nullptr, nullptr, y,       part,    N,
                   Cin,     Cin,     C,       S,       lda};
  if (!c1::ok(a, wide) ||
      (long)T != ((long)N * S + c1::kBN - 1) / c1::kBN)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e = c1::launch<c1::kStats>(a, wide, s);
  if (e != 0) return e;
  return finish_stats(part, stats, C, T, s);
}

// x [N, Cin, H*W] raw, taps [9, Cout, Cin], scale/shift [Cin] float32;
// y [N, Cout, H*W]; part [2, Cout, T], stats [2, Cout]; Cin % 16 == 0; T =
// N * ceil(H * (W + 2) / 128), the column tiles of the padded grid.
extern "C" int fused_block_conv3x3_norm_stats_bf16(
    const bf16* x, const bf16* taps, const float* scale, const float* shift,
    bf16* y, float* part, float* stats, int N, int Cin, int Cout, int H,
    int W, int T, void* stream) {
  if (!c3::ok(N, Cin, Cout, H, W, T) || !aligned16(x) || !aligned16(taps) ||
      !aligned16(y))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e = c3::launch<c3::kNormStats>(
      x, taps, scale, shift, nullptr, nullptr, nullptr, nullptr, nullptr, y,
      part, N, Cin, Cout, H, W, T / N, s);
  if (e != 0) return e;
  return finish_stats(part, stats, Cout, T, s);
}

// x [N, C, S] raw a2, scale/shift [C] float32; part [splits, C, C + 1]
// scratch, out [C, C + 1] float32: M2 in columns 0..C-1, exactly
// symmetric, sum h in column C. Split p takes the 32-position pieces [p *
// P / splits, (p + 1) * P / splits) of N * S; wide: S % 4 == 0.
extern "C" int fused_block_norm_relu_moments_bf16(
    const bf16* x, const float* scale, const float* shift, float* part,
    float* out, int N, int C, int S, int splits, int wide, void* stream) {
  const long NS = (long)N * S;
  if (N <= 0 || C <= 0 || S <= 0 || C > kMaxC || NS > INT_MAX - mom::kBK ||
      splits <= 0 || splits > kMaxSplits ||
      splits > (NS + mom::kBK - 1) / mom::kBK || (wide && S % 4) ||
      !aligned16(x))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e;
  if (C <= 64)
    e = wide ? mom::launch_bm<64, true>(x, scale, shift, part, N, C, S,
                                        splits, s)
             : mom::launch_bm<64, false>(x, scale, shift, part, N, C, S,
                                         splits, s);
  else
    e = wide ? mom::launch_bm<128, true>(x, scale, shift, part, N, C, S,
                                         splits, s)
             : mom::launch_bm<128, false>(x, scale, shift, part, N, C, S,
                                          splits, s);
  if (e != 0) return e;
  return finish_splits(part, out, (long)C * (C + 1), splits, s);
}

// a2 [N, C, S] raw, x [N, Cout, S] the residual, w [Cout, lda]: W3 at
// row pitch lda (a multiple of 64 >= C), zeros past C; sc2/sh2 [C],
// sc3/sh3 [Cout] float32; out [N, Cout, S]; C at most t1::kMaxK, C and
// Cout multiples of abw::group_of(S); split p takes the 64-position
// stages [p * Q / splits, (p + 1) * Q / splits) of the Q = N * ceil(S /
// 64), in each row tile of Cout.
extern "C" int fused_block_conv1x1_bn_residual_bf16(
    const bf16* a2, const bf16* x, const bf16* w, const float* sc2,
    const float* sh2, const float* sc3, const float* sh3, bf16* out, int N,
    int C, int Cout, int S, int lda, int splits, void* stream) {
  if (!aligned16(a2) || !aligned16(x)) return (int)cudaErrorInvalidValue;
  return t1::launch<t1::kResidual>(a2, x, w, sc2, sh2, sc3, sh3, out, N,
                                   Cout, C, S, lda, splits,
                                   static_cast<cudaStream_t>(stream));
}

// dout, out [N, Cin, S], a2 [N, C, S] raw, sc2/sh2 [C] float32; g3 [N,
// Cin, S]; part [splits, Cin, C + 1] scratch, red [Cin, C + 1] float32: P
// = sum g3 h2^T in columns 0..C-1, sum g3 in column C. Split p takes the
// 64-position stages [p * Q / splits, (p + 1) * Q / splits) of the Q = N *
// ceil(S / 64) stages; Cin and C multiples of abw::group_of(S).
extern "C" int fused_block_bwd_reduce3_bf16(
    const bf16* dout, const bf16* out, const bf16* a2, const float* sc2,
    const float* sh2, bf16* g3, float* part, float* red, int N, int Cin,
    int C, int S, int splits, void* stream) {
  if (!aligned16(dout) || !aligned16(out) || !aligned16(a2) ||
      !aligned16(g3))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e = abw::launch_reduce3(dout, out, a2, sc2, sh2, g3, part, N, Cin,
                                    C, S, splits, s);
  if (e != 0) return e;
  return finish_splits(part, red, (long)Cin * (C + 1), splits, s);
}

// g3 [N, Cin, S], a2 [N, C, S] raw; w [rows, lda]: [amat | bmat] [C, Cin +
// C] at row pitch lda (a multiple of 32 >= Cin + C), its rows whole row
// tiles (64 where C <= 64, else 128), zeros past C and Cin + C; sc2, sh2,
// v0, inv2, m2 [C] float32; g2 [N, C, S]; part [2, C, T] scratch, stats [2,
// C] (sum g2, sum g2 x^2 of the rounded g2); T = ceil(N * S / 128); wide: S
// % 4 == 0.
extern "C" int fused_block_bwd_apply3_bf16(
    const bf16* g3, const bf16* a2, const float* sc2, const float* sh2,
    const bf16* w, const float* v0, const float* inv2, const float* m2,
    bf16* g2, float* part, float* stats, int N, int Cin, int C, int S,
    int lda, int T, int wide, void* stream) {
  const c1::Args a{g3, a2,   w, sc2, sh2,     a2, v0, inv2,
                   m2, g2, part, N, Cin, Cin + C, C,  S, lda};
  if (!c1::ok(a, wide) || (long)T != ((long)N * S + c1::kBN - 1) / c1::kBN)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e = c1::launch<c1::kApply3>(a, wide, s);
  if (e != 0) return e;
  return finish_stats(part, stats, C, T, s);
}

// g2, a2, a1 [N, C, H*W]; sc1, sh1, p2, q2, r2, inv1, m1 [C] float32;
// taps_t [9, C, C] the taps flipped and transposed (taps_t[t] = taps[8 -
// t]^T); da2 [N, C, H*W] scratch; g1 [N, C, H*W]; part [2, C, T], stats
// [2, C] (sum g1, sum g1 x^1); wpart [splits, 9, C, C] scratch, dtaps [9,
// C, C] float32 (splits of N * ceil(H * W / 64) stages, as bwd_reduce3's).
// C % 16 == 0; W <= abw::kTapMaxW; T = N * ceil(H * (W + 2) / 128).
extern "C" int fused_block_bwd_mid_bf16(
    const bf16* g2, const bf16* a2, const bf16* a1, const float* sc1,
    const float* sh1, const float* p2, const float* q2, const float* r2,
    const float* inv1, const float* m1, const bf16* taps_t, bf16* da2,
    bf16* g1, float* part, float* stats, float* wpart, float* dtaps, int N,
    int C, int H, int W, int T, int splits, void* stream) {
  if (!c3::ok(N, C, C, H, W, T) || !abw::ok(N, C, C, H * W, splits) ||
      W > abw::kTapMaxW || !aligned16(g2) || !aligned16(a2) ||
      !aligned16(a1) ||
      !aligned16(taps_t) || !aligned16(da2) || !aligned16(g1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e = fold(g2, a2, p2, q2, r2, da2, N, C, H * W, s);
  if (e != 0) return e;
  e = c3::launch<c3::kInputGrad>(da2, taps_t, nullptr, nullptr, a1, sc1, sh1,
                                 inv1, m1, g1, part, N, C, C, H, W, T / N, s);
  if (e != 0) return e;
  e = finish_stats(part, stats, C, T, s);
  if (e != 0) return e;
  e = abw::launch_taps(da2, a1, sc1, sh1, wpart, N, C, H, W, splits, s);
  if (e != 0) return e;
  return finish_splits(wpart, dtaps, 9L * C * C, splits, s);
}

// g3, x [N, Cin, S], g1, a1 [N, C, S], p1, q1, r1 [C] float32; w [Cin,
// lda]: W1^T at row pitch lda (a multiple of 64 >= C), zeros past C; dx
// [N, Cin, S]; da1 [N, C, S] scratch; wpart [splits, C, Cin] scratch, dw1
// [C, Cin] float32; C at most t1::kMaxK, Cin and C multiples of
// abw::group_of(S). dx's tile takes tsplits splits of N * ceil(S / 64)
// stages in each row tile of Cin, dW1 splits of them (as bwd_reduce3's).
extern "C" int fused_block_bwd_final_bf16(
    const bf16* g3, const bf16* g1, const bf16* a1, const bf16* x,
    const float* p1, const float* q1, const float* r1, const bf16* w,
    bf16* dx, bf16* da1, float* wpart, float* dw1, int N, int Cin, int C,
    int S, int lda, int splits, int tsplits, void* stream) {
  if (!abw::ok(N, Cin, C, S, splits) || !aligned16(g3) || !aligned16(g1) ||
      !aligned16(a1) || !aligned16(x) || !aligned16(da1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e = fold(g1, a1, p1, q1, r1, da1, N, C, S, s);
  if (e != 0) return e;
  e = t1::launch<t1::kDx>(da1, g3, w, nullptr, nullptr, nullptr, nullptr, dx,
                          N, Cin, C, S, lda, tsplits, s);
  if (e != 0) return e;
  e = abw::launch_dw1(x, da1, wpart, N, Cin, C, S, splits, s);
  if (e != 0) return e;
  return finish_splits(wpart, dw1, (long)C * Cin, splits, s);
}

// The widest C the bf16 kernels take.
extern "C" int fused_block_bf16_max_c() { return kMaxC; }

// The widest K (C) the bf16 1x1 tile holds: the chain's gate in bf16.
extern "C" int fused_block_bf16_conv1x1_max_k() { return t1::kMaxK; }
