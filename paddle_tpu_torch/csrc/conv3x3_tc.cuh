// conv3x3_norm_stats for Hopper (sm_90a): the 3x3 same-padded conv on
// tensor cores in 3xTF32, over halo tiles normalized once. Included by
// fused_block.cu only.
//
// Replaces the Pallas body _k2_kernel of conv3x3_norm_stats in
// paddle_tpu/kernels/fused_block.py:644 (pallas_call at :653). For a1
// [N, Cin, H*W], taps [9, Cout, Cin] indexed [ky * 3 + kx], scale and
// shift [Cin]: a2 = the 3x3 conv of h1 = relu(a1 * scale + shift), padded
// with zeros (the conv pads h1, not a1), and each tile's per-channel sum
// and sum of squares of a2 for the fixed-order pass of fused_block.cuh.
//
// What bounds it on the H100 (batch 128; Cin = Cout = C, S = 64, 3136 /
// 128, 784 / 256, 196): 29.6 GFLOP at every stage, 0.44 ms at the 67
// TFLOP/s float32 FMA rate. Done here as three TF32 products, 88.8 GFLOP
// of tensor-core work: 0.18 ms at the 495 TFLOP/s dense TF32 rate; the
// 0.21 GB of a1 and a2 take 0.06 ms at 3.35 TB/s. Operations bound it.
// mma.sync reaches ~310 TFLOP/s of TF32 alone (the wgmma rate is 495;
// scripts/torch_conv3x3_probe.py).
//
// The design:
//   - The padded grid. Each image is computed on a grid of width
//     Wp = W + 2, output position q = y * Wp + x (x < W kept, the two
//     other columns discarded). Output q reads tap (dy, dx) at q + dy *
//     Wp + dx of the zero-bordered h1, so the nine taps are one staged
//     buffer at nine fixed offsets.
//   - A block owns kBM = 64 output channels and a chunk of kBN = 224
//     consecutive positions of one image's grid (28 n8 groups; 1 / 4 / 15
//     chunks an image at 14 / 28 / 56: 14% / 14% / 7% more positions than
//     are kept). Grid: (M tiles x chunks of all images), M tiles fastest,
//     so the blocks that share a halo run together and meet it in L2.
//     Two blocks an SM (128 registers a thread, up to 56 pixels a row:
//     the ring takes 79-88 KB): one block's staging overlaps the other's
//     product. In uncommitted builds, 128-row tiles (112 accumulators a
//     thread, one block an SM) were no faster at 28 and 14, and 64-row
//     tiles at one block an SM were slower at every stage.
//   - The halo of a chunk: three segments, one per dy, each of R = min(Wp,
//     kBN + 2) positions, starting at q0 + dy * Wp; where R = Wp (W <= 224)
//     they overlap into one run of 2 Wp + kBN + 2 positions, so each value
//     is staged once; wider rows stage the three segments apart, so the
//     halo never exceeds 3 (kBN + 2) positions whatever W. Tap (dy, dx)
//     of local position j reads halo slot dy * R + dx + j.
//   - Normalized once: a1 lands in the halo through 4-byte cp.async (rows
//     of 14 or 28 floats are not 16-byte aligned); then each thread turns
//     the values it copied into h1 = relu_affine(a1) in place, once per
//     value. Slots outside the image are written 0, never relu(shift).
//   - Stages of kKC = 8 input channels (one k8 step a tap): the halo
//     [8][P] and the nine taps' A slices [9][64][8] (16-byte copies, rows
//     past Cout zero-filled). A ring of 3 stages in dynamic shared memory,
//     copies one stage ahead; each thread waits for its own copies,
//     normalizes them, and one barrier a stage publishes the stage. The
//     buffer a copy refills was last read two stages back, before the
//     barrier the issuing thread has passed: one barrier a stage suffices.
//   - The product: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 in
//     3xTF32. Each operand x splits into big = x rounded to TF32 (as
//     cvt.rna.tf32.f32, by an integer add and mask: 2 instructions) and
//     small = x - big, exact, which the tensor cores truncate to TF32 (as
//     CUTLASS's fast-f32 split does; an uncommitted build that rounded it
//     with cvt.rna too was slower).
//     Per tap and tile the products small.big, big.small, big.big go into
//     a fresh fragment, added into the float32 accumulators with float32
//     adds: the tensor cores truncate as they accumulate, and summed
//     straight into the accumulators the small terms lost up to an ulp of
//     the accumulator an mma: an earlier build reached 1.6x the 1e-5
//     limit at 56 (chip run 1, PR 9). What 3xTF32 drops, small.small, is ~2^-22 of each product. The
//     split is done in registers as the fragments are read from shared
//     memory: a split copy of either operand would not leave room for
//     three stages at two blocks an SM. 8 warps as 2 (M) x 4 (N), each 32
//     rows x 56 positions: 2 m16 x 7 n8 tiles, 56 accumulators a thread.
//   - Conflict-free fragment reads: the halo's pitch P = 8 (mod 32) puts
//     a B fragment's 4 channel rows x 8 positions on 32 distinct banks at
//     any tap offset; an A row's two halves of 4 channels swap places
//     where bit 2 of the row is set, which does the same for A's 8 rows x
//     4 channels at a pitch of 8.
//   - Why mma.sync and not wgmma: wgmma's TF32 form takes both operands
//     K-major from shared memory, and the halo's shifted windows are
//     position-major; mma.sync takes its fragments from any address, so
//     the taps' offsets cost nothing.
//   - The epilogue writes the kept positions of a2 and each row's partial
//     sum and sum of squares (a thread's 14 positions in order, then its
//     row's 16 threads in order) into part [2, Cout, T], T = N x chunks;
//     finish_stats adds them in tile order. No atomics: two calls are
//     bit-identical.
//
// Registers (nvcc -Xptxas -v, sm_90a, CUDA 12.8): 128 a thread, the
// bound two blocks an SM set; no spills, no stack.
//
// What holds it back (PERF.md, row 14; scripts/torch_conv3x3_probe.py):
// the product alone takes ~0.57 ms a stage, ~175 TFLOP/s of its mma, 55%
// of what mma.sync reaches alone: a tap's 42 mma a warp come with ~140
// other instructions (the splits, the fragment reads, the fresh
// fragments' adds) and their latencies, at 4 warps a scheduler.
//
// One kernel, two uses: conv3x3_kernel<Land, Out> takes what lands in the
// halo through a Land policy (NormRelu: h1 = relu_affine(a1); bwd_mid's
// AsIs: da2 as it is) and writes through an Out policy (Stats: a2 and its
// sums; bwd_mid's MaskedStats: g1 and bn1's sums). bwd_mid's input
// gradient (bwd_mid_tc.cuh) is this product over da2 with the taps
// flipped and each transposed, taps[8 - t]^T, which its wrapper makes.
#pragma once

#include <cstdint>

#include "fused_block.cuh"

namespace {
namespace conv3x3 {

constexpr int kBM = 64;              // output channels of a block
constexpr int kBN = 224;             // positions of a block: 4 warps x 7 n8
constexpr int kMT = 2;               // m16 tiles of a warp (2 x 4 warps)
constexpr int kNT = 7;               // n8 tiles of a warp
constexpr int kJG = 2;               // n8 tiles whose mma chains interleave
constexpr int kKC = 8;               // input channels a stage
constexpr int kA = 9 * kBM * kKC;    // floats of a stage's A slices
constexpr int kRing = 3;             // stages in the ring
constexpr int kMaxHalo = 3 * (kBN + 2);
constexpr int kSlots = (kMaxHalo + kThreads - 1) / kThreads;
constexpr int kMaxSmem = 232448;     // a block's shared memory on sm_90

// The halo's segment length, length and pitch for rows of width W.
__host__ __device__ inline int segment(int W) {
  return W + 2 < kBN + 2 ? W + 2 : kBN + 2;
}
__host__ __device__ inline int halo_len(int R) { return 2 * R + kBN + 2; }
__host__ __device__ inline int halo_pitch(int L) {
  return (L + 23) / 32 * 32 + 8;
}
inline int chunks(int H, int W) {
  return (int)(((long)H * (W + 2) + kBN - 1) / kBN);
}
inline int ring_bytes(int W) {
  return kRing * (kA + kKC * halo_pitch(halo_len(segment(W)))) *
         (int)sizeof(float);
}

// ---- asynchronous copies and the tensor-core product -----------------------
__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes, bypassing L1; zero-filled unless ok.
__device__ __forceinline__ void copy16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
// 4 bytes.
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void wait_prior_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
// big = x rounded to TF32 (to nearest, ties away from zero, as
// cvt.rna.tf32.f32, by integer ops on the bits), small = x - big (exact;
// the tensor cores read its top 19 bits, truncating it to TF32).
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}
// d = a b over one m16n8k8 tile: a (16 x 8, row) and b (8 x 8, col) TF32.
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}
// d += a b over one m16n8k8 tile.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// -----------------------------------------------------------------------------

// Where a block works: its rows, its image, its chunk and its halo, and
// this thread's share of the A copies.
struct Tile {
  int m0, n, q0, jt, R, P, L, Wp;
  long a_src;        // its first A copy: the taps offset at channel 0
  int a_dst, a_tap;  // its offset in a stage, its first tap
  bool a_ok;         // its row is inside Cout
};

// The copies of one stage (input channels c0..c0+7) into buffer st: the
// nine taps' A slices [9][64][8], 16 bytes a copy (thread: half tid % 2
// of row tid % 128 / 2 of taps tid / 128, + 2, + 4, ...; rows past Cout
// zero-filled; the two halves of a row swap places where bit 2 of the
// row is set, so that a fragment's 8 rows x 4 channels fall on 32
// banks), then the halo slots this thread owns (pix < 0: a slot outside
// the image, never copied).
__device__ __forceinline__ void copy_stage(float* st, int c0,
                                           const float* __restrict__ taps,
                                           const float* __restrict__ src,
                                           const int (&pix)[kSlots], int M,
                                           int Cin, int S, const Tile& tl) {
#pragma unroll 1
  for (int tap = 0; tap + tl.a_tap < 9; tap += kThreads / (2 * kBM))
    copy16(st + tl.a_dst + tap * kBM * kKC,
           taps + tl.a_src + (long)tap * M * Cin + c0, tl.a_ok);
  float* hs = st + kA;
#pragma unroll 1
  for (int ch = 0; ch < kKC; ++ch) {
    const float* plane = src + (long)(c0 + ch) * S;
#pragma unroll
    for (int i = 0; i < kSlots; ++i)
      if (pix[i] >= 0)
        copy4(hs + ch * tl.P + threadIdx.x + kThreads * i, plane + pix[i]);
  }
}

// Land policy of the forward: h1 = relu(a1 * scale + shift).
struct NormRelu {
  const float* scale;
  const float* shift;
  __device__ __forceinline__ float2 channel(int c) const {
    return make_float2(__ldg(scale + c), __ldg(shift + c));
  }
  __device__ __forceinline__ float value(float v, float2 k) const {
    return relu_affine(v, k.x, k.y);
  }
};

// The thread's own halo slots of a landed stage, turned in place into
// the product's operand: land.value(v) inside the image, 0 outside.
template <class Land>
__device__ __forceinline__ void normalize(float* st, int c0, const Land& land,
                                          const int (&pix)[kSlots],
                                          const Tile& tl) {
  float* hs = st + kA;
#pragma unroll 1
  for (int ch = 0; ch < kKC; ++ch) {
    const float2 k = land.channel(c0 + ch);
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int h = threadIdx.x + kThreads * i;
      if (h < tl.L) {
        float* v = hs + ch * tl.P + h;
        *v = pix[i] >= 0 ? land.value(*v, k) : 0.f;
      }
    }
  }
}

// acc += the nine taps' products over one stage, in 3xTF32. Warp (wm, wn)
// owns rows 32 wm + 16 i + {g, g + 8} and positions 56 wn + 8 j + {2 t,
// 2 t + 1} (g = lane / 4, t = lane % 4). A tap's three products of a tile
// go into a fresh fragment f, added into acc in float32: the tensor
// cores' accumulation truncates, and summed straight into acc the small
// terms lost up to an ulp of acc an mma (chip run 1, PR 9). kJG n8 tiles
// at a time, so that 4 fragments' mma chains interleave.
__device__ __forceinline__ void product(float (&acc)[kMT][kNT][4],
                                        const float* st, const Tile& tl,
                                        int wm, int wn, int g, int t) {
  const int sw = g & 4;   // the swizzle of A's rows g and g + 8: 0 or 4
  const float* hs = st + kA + t * tl.P + wn * (kNT * 8) + g;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    uint32_t ab[kMT][4], as[kMT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const float* a = st + (tap * kBM + 32 * wm + 16 * i + g) * kKC + sw + t;
      split(a[0], ab[i][0], as[i][0]);
      split(a[8 * kKC], ab[i][1], as[i][1]);
      split(a[4 - 2 * sw], ab[i][2], as[i][2]);
      split(a[8 * kKC + 4 - 2 * sw], ab[i][3], as[i][3]);
    }
    const float* b = hs + (tap / 3) * tl.R + tap % 3;
#pragma unroll
    for (int j0 = 0; j0 < kNT; j0 += kJG) {
      uint32_t bb[kJG][2], bs[kJG][2];
      float f[kJG][kMT][4];
#pragma unroll
      for (int jj = 0; jj < kJG && j0 + jj < kNT; ++jj) {
        split(b[8 * (j0 + jj)], bb[jj][0], bs[jj][0]);
        split(b[4 * tl.P + 8 * (j0 + jj)], bb[jj][1], bs[jj][1]);
      }
      // one pass a term, the small ones first
#pragma unroll
      for (int jj = 0; jj < kJG && j0 + jj < kNT; ++jj)
#pragma unroll
        for (int i = 0; i < kMT; ++i)
          mma0(f[jj][i], as[i], bb[jj][0], bb[jj][1]);
#pragma unroll
      for (int jj = 0; jj < kJG && j0 + jj < kNT; ++jj)
#pragma unroll
        for (int i = 0; i < kMT; ++i)
          mma(f[jj][i], ab[i], bs[jj][0], bs[jj][1]);
#pragma unroll
      for (int jj = 0; jj < kJG && j0 + jj < kNT; ++jj)
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          mma(f[jj][i], ab[i], bb[jj][0], bb[jj][1]);
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j0 + jj][r] += f[jj][i][r];
        }
    }
  }
}

// Out policy of the forward: the kept positions of a2 [N, M, S] and each
// row's partial sum and sum of squares (a thread's 14 positions in order)
// into red, for store_row_partials.
struct Stats {
  float* y;
  __device__ __forceinline__ void store(const float (&acc)[kMT][kNT][4],
                                        const int (&off)[kNT][2],
                                        const Tile& tl, int wm, int wn, int g,
                                        int t, int M, int S,
                                        float* red) const {
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int lr = 32 * wm + 16 * i + g + 8 * hr, m = tl.m0 + lr;
        float* out = y + ((long)tl.n * M + (m < M ? m : 0)) * S;
        float s = 0.f, q = 0.f;
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (off[j][c] >= 0) {
              const float v = acc[i][j][2 * hr + c];
              if (m < M) out[off[j][c]] = v;
              s += v;
              q = fmaf(v, v, q);
            }
        red[lr * 16 + wn * 4 + t] = s;
        red[(kBM + lr) * 16 + wn * 4 + t] = q;
      }
  }
};

// Block (M tile, column tile jt = n * chunks + chunk): the 3x3 of src [N,
// Cin, H*W] (what lands in the halo through land) by taps [9, M, Cin],
// written through out.
template <class Land, class Out>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_kernel(const float* __restrict__ src_all,
               const float* __restrict__ taps, const Land land, const Out out,
               float* __restrict__ part, int M, int Cin, int H, int W,
               int nchunks, int tiles_m, int T) {
  extern __shared__ __align__(16) float ring[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
  Tile tl;
  tl.jt = blockIdx.x / tiles_m;
  tl.m0 = (blockIdx.x - tl.jt * tiles_m) * kBM;
  tl.n = tl.jt / nchunks;
  tl.q0 = (tl.jt - tl.n * nchunks) * kBN;
  tl.Wp = W + 2;
  tl.R = segment(W);
  tl.L = halo_len(tl.R);
  tl.P = halo_pitch(tl.L);
  {
    const int m = tid % (2 * kBM) >> 1, half = tid & 1;
    tl.a_tap = tid / (2 * kBM);
    tl.a_ok = tl.m0 + m < M;
    tl.a_src = ((long)tl.a_tap * M + (tl.a_ok ? tl.m0 + m : 0)) * Cin +
               4 * half;
    tl.a_dst = (tl.a_tap * kBM + m) * kKC + 4 * (half ^ (m >> 2 & 1));
  }
  const int S = H * W;
  const int stage = kA + kKC * tl.P;
  const float* src = src_all + (long)tl.n * Cin * S;

  // the pixel behind each of this thread's halo slots, or -1 outside
  int pix[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int h = tid + kThreads * i;
    pix[i] = -1;
    if (h < tl.L) {
      const int p = tl.q0 + h / tl.R * tl.Wp + h % tl.R;
      const int r = p / tl.Wp, c = p - r * tl.Wp;
      if (r >= 1 && r <= H && c >= 1 && c <= W) pix[i] = (r - 1) * W + c - 1;
    }
  }
  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int stages = Cin / kKC;
  auto buffer = [&](int s) { return ring + (s % kRing) * stage; };
  copy_stage(buffer(0), 0, taps, src, pix, M, Cin, S, tl);
  commit();
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages)
      copy_stage(buffer(s + 1), (s + 1) * kKC, taps, src, pix, M, Cin, S, tl);
    commit();
    wait_prior_1();
    normalize(buffer(s), s * kKC, land, pix, tl);
    __syncthreads();
    product(acc, buffer(s), tl, wm, wn, g, t);
  }

  // epilogue: the kept positions and the rows' partial sums
  int off[kNT][2];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int q = tl.q0 + wn * (kNT * 8) + 8 * j + 2 * t + c;
      const int r = q / tl.Wp, x = q - r * tl.Wp;
      off[j][c] = (r < H && x < W) ? r * W + x : -1;
    }
  __syncthreads();   // every warp is done with the ring: it holds red now
  float* red = ring;
  out.store(acc, off, tl, wm, wn, g, t, M, S, red);
  store_row_partials<kBM>(part, M, T, tl.m0, tl.jt, red);
}

// The kernel over src [N, Cin, H*W] and taps [9, Cout, Cin], then the
// fixed-order pass over its row partials into stats [2, Cout].
template <class Land, class Out>
int launch(const float* src, const float* taps, const Land& land,
           const Out& out, float* part, float* stats, int N, int Cin,
           int Cout, int H, int W, int T, cudaStream_t s) {
  const int bytes = ring_bytes(W);
  const cudaError_t err =
      cudaFuncSetAttribute(conv3x3_kernel<Land, Out>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles_m = (Cout + kBM - 1) / kBM;
  conv3x3_kernel<Land, Out><<<tiles_m * T, kThreads, bytes, s>>>(
      src, taps, land, out, part, Cout, Cin, H, W, chunks(H, W), tiles_m, T);
  return finish_stats(part, stats, Cout, T, s);
}

// What the wrapper's _conv3x3_grid computes: T = N x chunks column tiles,
// tiles x T blocks, a ring inside a block's shared memory; taps 16-byte
// aligned (its rows are, as Cin % 8 == 0).
bool grid_ok(const float* taps, int N, int Cin, int Cout, int H, int W,
             int T) {
  if (N <= 0 || Cin <= 0 || Cin % kKC || Cout <= 0 || H <= 0 || W <= 0)
    return false;
  if ((long)N * H * W >= INT_MAX || (long)H * (W + 2) >= INT_MAX / 2)
    return false;
  return (reinterpret_cast<std::uintptr_t>(taps) & 15) == 0 &&
         (long)T == (long)N * chunks(H, W) &&
         (long)T * ((Cout + kBM - 1) / kBM) < INT_MAX &&
         ring_bytes(W) <= kMaxSmem;
}

}  // namespace conv3x3
}  // namespace
