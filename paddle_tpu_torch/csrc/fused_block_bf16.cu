// Bottleneck-chain forward kernels for Hopper (sm_90a), bfloat16
// activations, taps and weights (the bench trains ResNet-50 in bf16).
//
// Replace the forward TPU kernels of paddle_tpu/kernels/fused_block.py as
// they run on bf16 tiles ("activations bf16 (the bench dtype) or f32",
// :37-38), with the float32 kernels' layouts (csrc/fused_block.cu):
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
// scale and shift are float32 everywhere, as the Pallas kernels take them;
// the affines are fmaf, as XLA contracts the Pallas kernels' x * sc + sh.
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
//     0.0345 ms: bytes.
// In bf16 there is no 3xTF32 split: each product is one bf16 product of
// exact operands, so the tensor cores do a third of the float32 kernels'
// work on half their bytes.
//
// What the design does about it: right and simple first; the redesign for
// speed (wgmma fed by TMA, csrc/sm90.cuh) is later work. One tile product
// serves all four kernels: 8 warps as 2 (rows) x 4 (columns), each warp
// (BM / 2) x (BN / 4), bf16 mma.sync.m16n8k16 with float32 accumulators,
// both operands from shared memory by ldmatrix (the A rows and, for the
// moments and the 3x3, the B rows K-contiguous; the 1x1s' x [K][columns]
// through ldmatrix.trans). Every operand goes through registers on its way
// to shared memory (load, widen, normalize, round, store), because the 3x3,
// the moments and the residual 1x1 normalize their input as it loads.
//   - conv1x1_stats and conv1x1_bn_residual (c1::conv1x1_bf16_kernel): a
//     block owns BM rows of M (64 where M <= 64, else 128) by 128 columns
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
//   - Sums: a partial per tile (a thread's columns in order, then the
//     row's threads in order), then fused_block.cuh's passes in fixed
//     order. No float atomics: two calls on one input give the same bits.
// Shapes: contiguous bf16 tensors, 16-byte aligned; the 3x3's Cin a
// multiple of 16; C and Cin at most kMaxC (4096, eight times the widest C
// of ResNet-50's blocks: the moments' split partials grow as splits x C^2,
// 8.6 GB at 128 splits there); N * S below 2^31; each entry point refuses
// anything else before it launches.
#include <cstdint>

#include "fused_block.cuh"

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

// ---- bf16 tensor-core product and its fragment loads
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
enum { kStats = 0, kResidual = 1 };

template <int BM>
constexpr int smem_bytes() {
  return 2 * (BM * kAP + kBK * kBP) * 2;  // two stages of A and B
}

// y = W · x over K, M rows (kStats: y and its partial sums; kResidual: x
// normalized as it lands, out = relu(fma(a3, sc3, sh3) + res)).
template <int BM, int kMode, bool kWide>
__global__ void __launch_bounds__(kThreads, 2)
conv1x1_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const float* __restrict__ sc, const float* __restrict__ sh,
                    const bf16* __restrict__ res,
                    const float* __restrict__ sc3,
                    const float* __restrict__ sh3, bf16* __restrict__ y,
                    float* __restrict__ part, int N, int K, int M, int S,
                    int lda) {
  constexpr int MT = BM / 32, NT = 4, AV = BM * kBK / 8 / kThreads;
  extern __shared__ float4 smem4[];
  bf16* As = reinterpret_cast<bf16*>(smem4);
  bf16* Bs = As + 2 * BM * kAP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, t = lane & 3;
  const long NS = (long)N * S, j0 = (long)blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  // this thread's loads: 4 columns (group cg) of 4 K rows a stage
  const int cg = tid & 31, kr = tid >> 5;
  long off[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    off[e] = (kWide && e) ? -1 : col_off(j0 + 4 * cg + e, NS, S, K);
  uint4 ra[AV];
  uint2 rb[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int v = 0; v < AV; ++v) {
      const int idx = tid + v * kThreads;
      ra[v] = __ldg(reinterpret_cast<const uint4*>(
          w + (long)(m0 + (idx >> 2)) * lda + k0 + (idx & 3) * 8));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + kr + 8 * i;
      uint2 v = make_uint2(0u, 0u);
      if (k < K) {
        const long ks = (long)k * S;
        if (kWide) {
          if (off[0] >= 0)
            v = __ldg(reinterpret_cast<const uint2*>(x + off[0] + ks));
        } else {
          bf16 h[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) h[e] = off[e] >= 0 ? x[off[e] + ks] : 0;
          v = make_uint2(pack(h[0], h[1]), pack(h[2], h[3]));
        }
      }
      rb[i] = v;
    }
  };
  auto store = [&](int buf, int k0) {
    bf16* a = As + buf * BM * kAP;
    bf16* b = Bs + buf * kBK * kBP;
#pragma unroll
    for (int v = 0; v < AV; ++v) {
      const int idx = tid + v * kThreads;
      *reinterpret_cast<uint4*>(a + (idx >> 2) * kAP + (idx & 3) * 8) = ra[v];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint2 v = rb[i];
      const int k = k0 + kr + 8 * i;
      if (kMode == kResidual && k < K) {
        const float s = __ldg(sc + k), h = __ldg(sh + k);
        v = make_uint2(norm2(v.x, s, h), norm2(v.y, s, h));
      }
      *reinterpret_cast<uint2*>(b + (kr + 8 * i) * kBP + 4 * cg) = v;
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
    const bf16* a = As + (buf * BM + wm * (BM / 2)) * kAP;
    const bf16* b = Bs + buf * kBK * kBP + wn * (kBN / 4);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16)
      warp_k16<MT, NT, true>(acc, a + kk, kAP, b + kk * kBP, kBP);
  }

  // the epilogue: this thread's 8 columns, then its 2 MT rows
  long oc[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      oc[j][e] = col_off(j0 + wn * (kBN / 4) + 8 * j + 2 * t + e, NS, S, M);
  if (kMode == kStats) {
    float* red = reinterpret_cast<float*>(smem4);  // over A, after the loop
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int lr = wm * (BM / 2) + 16 * i + g + 8 * hf, row = m0 + lr;
        float s = 0.f, q = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // columns past N * S and rows past M hold 0: they add nothing
            const bf16 yb = to_bf(acc[i][j][2 * hf + e]);
            const float yf = bf(yb);
            if (oc[j][e] >= 0 && row < M) y[oc[j][e] + (long)row * S] = yb;
            s += yf;
            q = fmaf(yf, yf, q);
          }
        put_row<BM>(red, lr, 4 * wn + t, s, q);
      }
    store_row_partials<BM>(part, M, gridDim.x, m0, blockIdx.x, red);
  } else {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = m0 + wm * (BM / 2) + 16 * i + g + 8 * hf;
        if (row >= M) continue;
        const float s3 = __ldg(sc3 + row), h3 = __ldg(sh3 + row);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (oc[j][e] < 0) continue;
            const long o = oc[j][e] + (long)row * S;
            const float v = fmaf(acc[i][j][2 * hf + e], s3, h3) + bf(res[o]);
            y[o] = to_bf(fmaxf(v, 0.f));
          }
      }
  }
}

inline bool ok(const void* x, const void* w, const void* y, int N, int K,
               int M, int S, int lda, int wide) {
  const long NS = (long)N * S;
  return N > 0 && K > 0 && M > 0 && S > 0 && K <= kMaxC && M <= kMaxC &&
         NS <= INT_MAX - kBN && lda % kBK == 0 && lda >= K &&
         (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
          reinterpret_cast<uintptr_t>(y)) % 16 == 0 &&
         (!wide || S % 4 == 0);
}

template <int BM, int kMode, bool kWide>
int launch_bm(const bf16* x, const bf16* w, const float* sc, const float* sh,
              const bf16* res, const float* sc3, const float* sh3, bf16* y,
              float* part, int N, int K, int M, int S, int lda,
              cudaStream_t s) {
  const dim3 grid((unsigned)(((long)N * S + kBN - 1) / kBN),
                  (unsigned)((M + BM - 1) / BM));
  conv1x1_bf16_kernel<BM, kMode, kWide><<<grid, kThreads, smem_bytes<BM>(),
                                          s>>>(x, w, sc, sh, res, sc3, sh3, y,
                                               part, N, K, M, S, lda);
  return (int)cudaGetLastError();
}

template <int kMode>
int launch(const bf16* x, const bf16* w, const float* sc, const float* sh,
           const bf16* res, const float* sc3, const float* sh3, bf16* y,
           float* part, int N, int K, int M, int S, int lda, int wide,
           cudaStream_t s) {
  if (M <= 64)
    return wide ? launch_bm<64, kMode, true>(x, w, sc, sh, res, sc3, sh3, y,
                                             part, N, K, M, S, lda, s)
                : launch_bm<64, kMode, false>(x, w, sc, sh, res, sc3, sh3, y,
                                              part, N, K, M, S, lda, s);
  return wide ? launch_bm<128, kMode, true>(x, w, sc, sh, res, sc3, sh3, y,
                                            part, N, K, M, S, lda, s)
              : launch_bm<128, kMode, false>(x, w, sc, sh, res, sc3, sh3, y,
                                             part, N, K, M, S, lda, s);
}

}  // namespace c1

namespace c3 {

constexpr int kBN = 128, kBK = 16;
constexpr int kP = kBK + 8;    // A's and B's row pitch (bf16): 48 bytes

__host__ __device__ inline int halo(int W) { return kBN + 2 * (W + 2) + 2; }
template <int BM>
inline int smem_bytes(int W) {
  return (9 * BM + halo(W)) * kP * 2 + halo(W) * 4;
}

template <int BM>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ taps,
                    const float* __restrict__ sc, const float* __restrict__ sh,
                    bf16* __restrict__ y, float* __restrict__ part, int Cin,
                    int Cout, int H, int W, int chunks) {
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
        v = pack(norm_bf(src[0], __ldg(sc + ci), __ldg(sh + ci)),
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
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (oc[j][e] < 0 || row >= Cout) continue;
          const bf16 yb = to_bf(acc[i][j][2 * hf + e]);
          const float yf = bf(yb);
          y[((long)n * Cout + row) * S + oc[j][e]] = yb;
          s += yf;
          q = fmaf(yf, yf, q);
        }
      put_row<BM>(red, lr, 4 * wn + t, s, q);
    }
  store_row_partials<BM>(part, Cout, gridDim.x, m0, blockIdx.x, red);
}

template <int BM>
int launch_bm(const bf16* x, const bf16* taps, const float* sc,
              const float* sh, bf16* y, float* part, int N, int Cin, int Cout,
              int H, int W, int chunks, cudaStream_t s) {
  const int bytes = smem_bytes<BM>(W);
  cudaFuncSetAttribute(conv3x3_bf16_kernel<BM>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const dim3 grid((unsigned)(N * chunks), (unsigned)((Cout + BM - 1) / BM));
  conv3x3_bf16_kernel<BM><<<grid, kThreads, bytes, s>>>(
      x, taps, sc, sh, y, part, Cin, Cout, H, W, chunks);
  return (int)cudaGetLastError();
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
  if (!c1::ok(x, w, y, N, Cin, C, S, lda, wide) ||
      (long)T != ((long)N * S + c1::kBN - 1) / c1::kBN)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e = c1::launch<c1::kStats>(x, w, nullptr, nullptr, nullptr,
                                       nullptr, nullptr, y, part, N, Cin, C,
                                       S, lda, wide, s);
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
  const int chunks = (int)(((long)H * (W + 2) + c3::kBN - 1) / c3::kBN);
  const int bm = Cout <= 64 ? 64 : 128;
  if (N <= 0 || Cin <= 0 || Cout <= 0 || H <= 0 || W <= 0 ||
      Cin % c3::kBK || Cin > kMaxC || Cout > kMaxC ||
      (long)N * chunks != (long)T || (long)H * (W + 2) > INT_MAX / 2 ||
      (bm == 64 ? c3::smem_bytes<64>(W) : c3::smem_bytes<128>(W)) >
          227 * 1024 ||
      !aligned16(x) || !aligned16(taps) || !aligned16(y))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e = bm == 64 ? c3::launch_bm<64>(x, taps, scale, shift, y, part,
                                             N, Cin, Cout, H, W, chunks, s)
                         : c3::launch_bm<128>(x, taps, scale, shift, y, part,
                                              N, Cin, Cout, H, W, chunks, s);
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

// a2 [N, C, S] raw, x [N, Cout, S] the residual, w [rows, lda]: W3 [Cout,
// C] at row pitch lda (a multiple of 32 >= C), zeros past Cout and C;
// sc2/sh2 [C], sc3/sh3 [Cout] float32; out [N, Cout, S]; wide: S % 4 ==
// 0.
extern "C" int fused_block_conv1x1_bn_residual_bf16(
    const bf16* a2, const bf16* x, const bf16* w, const float* sc2,
    const float* sh2, const float* sc3, const float* sh3, bf16* out, int N,
    int C, int Cout, int S, int lda, int wide, void* stream) {
  if (!c1::ok(a2, w, out, N, C, Cout, S, lda, wide) || !aligned16(x))
    return (int)cudaErrorInvalidValue;
  return c1::launch<c1::kResidual>(a2, w, sc2, sh2, x, sc3, sh3, out, nullptr,
                                   N, C, Cout, S, lda, wide,
                                   static_cast<cudaStream_t>(stream));
}

// The widest C the bf16 kernels take: the chain's gate in bf16.
extern "C" int fused_block_bf16_max_c() { return kMaxC; }
