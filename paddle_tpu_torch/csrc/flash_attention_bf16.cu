// Flash attention in bfloat16 for Hopper (sm_90a): the forward, dQ and
// dK/dV of mixed-precision training, each on the tensor cores as
// mma.sync.m16n8k16 bf16 products with float32 accumulation.
//
// Replaces, for bfloat16 inputs, the three TPU kernels of
// paddle_tpu/kernels/flash_attention.py: the forward _flash_fwd (Pallas
// body _fwd_kernel, pallas_call at :151), and the backward's
// _bwd_dq_kernel (pallas_call at :279) and _bwd_dkv_kernel (pallas_call at
// :298). The Pallas kernels upcast their bf16 tiles to float32, accumulate
// in float32 and write O, dQ, dK and dV in the input dtype; lse and delta
// stay float32. Here the products' operands stay bf16 (the tensor cores
// multiply them exactly and add in float32), and the two tiles that are
// formed in float32 and then multiplied are rounded to bf16 first: P for
// P V and P^T dO (as mha_reference rounds p to v's dtype before p V), and
// dS for dS K and dS^T Q. Everything else is float32: the scores, the
// online softmax's max and sum, p = exp(s - lse), dP, dS before its
// rounding, and the accumulators of O, dQ, dK and dV, each written once as
// bf16. Masks as the f32 kernels (csrc/flash_attention.cu): scores are
// q.k * scale, keys past sk score -inf (the forward) or get p = 0 (the
// backward), keys past the bottom-right aligned causal diagonal score the
// finite kMaskValue. No atomics: two calls are bit-identical.
//
// What bounds them on the H100, at the mixed-precision training step's
// shape (B 8, S 1024, H 8, D 256, causal): the forward's bytes (Q, K, V in
// and O out, 134 MB: 0.040 ms at 3.35 TB/s; its two products, 34.4 GFLOP,
// are 0.035 ms at the 989 TFLOP/s bf16 rate); dQ's operations (three
// products, 51.5 GFLOP: 0.052 ms); dK/dV's operations (four products, 68.7
// GFLOP: 0.069 ms).
//
// These are the simple versions that are right first: mma.sync (not
// wgmma), cp.async (not TMA), and one buffer ring at most. What each
// design does:
//
// Forward (flash_bf16_fwd_kernel): flash-attention-2's layout. A block owns
//   one (batch, head) and 64 query rows, 4 warps of 16 rows each; the block
//   walks the key tiles of 64 keys up to the causal diagonal, heaviest query
//   tile first. A warp's S = Q K^T (16 x 64) stays in registers, where the
//   online softmax runs on it (a row's max and sum across the 4 lanes that hold
//   it by two xor shuffles); its C fragments are, packed to bf16, the A
//   fragments of P V, so P never reaches shared memory. O (16 x D a warp, 128
//   floats a thread at D = 256) stays in registers across the key tiles. Q, K
//   and V of one tile each in shared memory at a pitch of D + 8 (101,376 bytes
//   at D = 256, two blocks an SM): V of tile t lands under Q K^T of t, K of t +
//   1 under the softmax and P V of t.
//
// dQ (flash_bf16_dq_kernel): 8 warps in pairs; a block owns 64 query rows,
//   pair p their 16 rows 16 p .. 16 p + 15, and walks the key tiles of 64 keys.
//   Per tile one warp of the pair computes S = Q K^T and p = exp(s - lse), the
//   other dP = dO V^T, over the same 16 x 64 tile in one C layout: the first
//   hands p (float32) to the second through shared memory, lane for lane, the
//   second forms dS = p (dP - delta) scale, rounds it to bf16 in A-fragment
//   order and hands it back; then each warp of the pair adds dS K into its half
//   of the pair's dQ columns (64 floats a thread at D = 256). Q and dO stay in
//   shared memory; K is double-buffered (K of t + 1 lands under all of t), V
//   single (V of t + 1 lands under dS and dS K of t): 193,536 bytes at D = 256,
//   one block an SM.
//
// dK/dV (flash_bf16_dkv_kernel): dQ's pairs with the roles of the operands
//   swapped. A block owns 64 keys, pair p their 16 keys; K and V stay in shared
//   memory, Q and dO stream past them in double-buffered tiles of 64 query rows
//   (32 at D = 256), from the first tile that sees the block's keys under
//   causal masking to the last. Per tile one warp of the pair computes S^T = K
//   Q^T and p, the other dP^T = V dO^T; p goes across, dS^T comes back; then
//   each warp adds P^T dO into its half of dV's columns and dS^T Q into its
//   half of dK's (2 x 64 floats a thread at D = 256). 147,456 bytes at D = 256,
//   one block an SM.
//
// Fragments: A (16 x 16, row-major) and B (16 x 8, column-major) as PTX's
// m16n8k16 layouts, each 32-bit register two bf16 values of one row (A) or
// column (B), the lower index in the low half. Operands read along a row
// of shared memory (Q, dO, K and V as the first products' A and B) are one
// 32-bit read a register; operands read down a column (V in P V, K in dS
// K, dO and Q in the dK/dV products) two 16-bit reads a register. The
// pitch of D + 8 values (D / 2 + 4 words) puts a quarter warp's reads of
// either kind on distinct banks.
//
// Registers (nvcc -Xptxas -v, sm_90a), at D = 256 / 128 / 64: the forward
// 233 / 167 / 132, dQ 169 / 138 / 118, dK/dV 215 / 192 / 161; no spills,
// no stack.
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

typedef uint16_t bf16;  // the bits of one bfloat16

// ---- asynchronous copies, conversions and the bf16 tensor-core product ----
__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes, bypassing L1; zero-filled unless ok.
__device__ __forceinline__ void copy16(bf16* dst, const bf16* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N of this thread's groups of copies are in flight.
template <int N>
__device__ __forceinline__ void wait_prior() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// lo and hi rounded to bf16 (to nearest, ties to even), lo in the low half.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
// d += a b over one m16n8k16 tile: a (16 x 16, row) and b (16 x 8, col)
// bf16, d float32.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ float shfl_xor(float x, int m) {
  return __shfl_xor_sync(0xffffffffu, x, m);
}
// -----------------------------------------------------------------------------

// Two consecutive bf16 values of one row.
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// Two bf16 values of one column, rows `ld` apart.
__device__ __forceinline__ uint32_t ld_col(const bf16* p, int ld) {
  return static_cast<uint32_t>(p[0]) | static_cast<uint32_t>(p[ld]) << 16;
}

// Rows r0 .. r0 + R - 1 of x (a row every `stride` values) into dst at
// pitch LD, 16 bytes a copy, neighbouring threads on neighbouring chunks
// of a row; rows at or past n zero-filled.
template <int R, int D, int NT>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* x, int r0,
                                          int n, long stride) {
  constexpr int C = D / 8;  // 16-byte chunks a row
  constexpr int LD = D + 8;
  for (int i = threadIdx.x; i < R * C; i += NT) {
    const int r = i / C, c = i - r * C;
    const bool ok = r0 + r < n;
    copy16(dst + r * LD + 8 * c, x + (ok ? (r0 + r) * stride : 0) + 8 * c,
           ok);
  }
}

// s[j] += A B_j^T over D, for the 16 rows of A at `a` (the lane's first row,
// g, at a) and the rows 8 j .. 8 j + 7 of B at `bm`: a 16 x 8 NJ tile of
// row-by-row dot products (Q K^T, dO V^T, K Q^T, V dO^T).
template <int D, int NJ>
__device__ __forceinline__ void row_products(float (&s)[NJ][4], const bf16* a,
                                             const bf16* bm, int g, int t) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 4
  for (int d0 = 0; d0 < D; d0 += 16) {
    const bf16* ap = a + d0 + 2 * t;
    const uint32_t af[4] = {ld32(ap), ld32(ap + 8 * LD), ld32(ap + 8),
                            ld32(ap + 8 * LD + 8)};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const bf16* bp = bm + (8 * j + g) * LD + d0 + 2 * t;
      mma(s[j], af, ld32(bp), ld32(bp + 8));
    }
  }
}

// acc[n] += A_kk B over a k16 step: A's fragment given, B the 16 rows at
// `bm` (row 2 t at bm + 2 t LD), its n8 tiles the columns 8 n + {0..7}
// from bm's column; B read down its columns.
template <int D, int NN>
__device__ __forceinline__ void col_products(float (&acc)[NN][4],
                                             const uint32_t (&a)[4],
                                             const bf16* bm, int g, int t) {
  constexpr int LD = D + 8;
  const bf16* b0 = bm + 2 * t * LD + g;
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    const bf16* bp = b0 + 8 * n;
    mma(acc[n], a, ld_col(bp, LD), ld_col(bp + 8 * LD, LD));
  }
}

// The A fragment of k16 step kk of a 16-row C tile held as float pairs:
// keys (or queries) 16 kk .. 16 kk + 15, rounded to bf16.
template <int NJ>
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4],
                                         const float (&c)[NJ][4], int kk) {
  a[0] = pack2(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack2(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack2(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack2(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

constexpr int kFwdThreads = 128;  // 4 warps of 16 query rows
constexpr int kFwdBQ = 64;        // query rows a block
constexpr int kFwdBK = 64;        // keys a tile

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(bf16) * 3 * 64 * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_bf16_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ o,
           float* __restrict__ lse, int H, int sq, int sk, float scale,
           int causal) {
  constexpr int LD = D + 8;
  constexpr int NT = D / 8;          // n8 tiles of O
  constexpr int NJ = kFwdBK / 8;     // n8 tiles of S
  extern __shared__ float4 smem4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem4);  // [64][LD]
  bf16* sK = sQ + kFwdBQ * LD;                 // [64][LD]
  bf16* sV = sK + kFwdBK * LD;                 // [64][LD]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int hd = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdBQ;  // heaviest first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = 16 * warp + g;  // the lane's rows r_lo and r_lo + 8
  const int q_off = sk - sq;
  const long stride = (long)H * D;  // values between sequence positions
  const bf16* qb = q + ((long)b * sq * H + hd) * D;
  const bf16* kb = k + ((long)b * sk * H + hd) * D;
  const bf16* vb = v + ((long)b * sk * H + hd) * D;

  int n_tiles = (sk + kFwdBK - 1) / kFwdBK;
  if (causal) n_tiles = min(sk - 1, q0 + kFwdBQ - 1 + q_off) / kFwdBK + 1;

  copy_rows<kFwdBQ, D, kFwdThreads>(sQ, qb, q0, sq, stride);
  copy_rows<kFwdBK, D, kFwdThreads>(sK, kb, 0, sk, stride);
  commit();

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // the lane's part of each row's sum

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kFwdBK;
    wait_prior<0>();  // this thread's copies of K (and Q) have landed
    __syncthreads();  // everyone's; and P V of the last tile is done with V
    copy_rows<kFwdBK, D, kFwdThreads>(sV, vb, k0, sk, stride);
    commit();

    float s[NJ][4];
    row_products<D, NJ>(s, sQ + r_lo * LD, sK, g, t);
    __syncthreads();  // every warp's Q K^T is done: K is free
    if (kt + 1 < n_tiles)
      copy_rows<kFwdBK, D, kFwdThreads>(sK, kb, k0 + kFwdBK, sk, stride);
    commit();

    // mask and scale; the rows' new maxima over the 4 lanes of a row
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = q0 + r_lo + 8 * (e >> 1) + q_off;
        const int kpos = k0 + 8 * j + 2 * t + (e & 1);
        float x = s[j][e] * scale;
        if (kpos >= sk) x = -INFINITY;
        else if (causal && kpos > qpos) x = ptt::kMaskValue;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], shfl_xor(mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], shfl_xor(mx[hr], 2));
      const float alpha = (m[hr] == -INFINITY) ? 0.f : expf(m[hr] - mx[hr]);
      m[hr] = mx[hr];
      l[hr] *= alpha;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][2 * hr] *= alpha;
        acc[n][2 * hr + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float p = (x == -INFINITY) ? 0.f : expf(x - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }

    wait_prior<1>();  // this thread's copies of V have landed
    __syncthreads();  // everyone's
#pragma unroll
    for (int kk = 0; kk < kFwdBK / 16; ++kk) {
      uint32_t a[4];
      a_from_c<NJ>(a, s, kk);
      col_products<D, NT>(acc, a, sV + 16 * kk * LD, g, t);
    }
  }
  wait_prior<0>();

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += shfl_xor(l[hr], 1);
    l[hr] += shfl_xor(l[hr], 2);
    const int row = q0 + r_lo + 8 * hr;
    if (row >= sq) continue;
    const float l_safe = (l[hr] == 0.f) ? 1.f : l[hr];
    bf16* orow = o + ((long)b * sq * H + hd) * D + row * stride + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) =
          pack2(acc[n][2 * hr] / l_safe, acc[n][2 * hr + 1] / l_safe);
    if (t == 0) lse[(long)bh * sq + row] = m[hr] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// backward: the warp pairs' exchange
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 256;  // 4 pairs of warps

// p of a pair's 16 x (8 NJ) tile, float32, lane for lane: [pair][j][e][lane]
// at xp; dS rounded to bf16 as A fragments: [pair][kk][r][lane] at xs.
template <int NJ>
__device__ __forceinline__ float* xp_at(float* xp, int pair, int j, int e,
                                        int lane) {
  return xp + ((pair * NJ + j) * 4 + e) * 32 + lane;
}
template <int NJ>
__device__ __forceinline__ uint32_t* xs_at(uint32_t* xs, int pair, int kk,
                                           int r, int lane) {
  return xs + ((pair * (NJ / 2) + kk) * 4 + r) * 32 + lane;
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

constexpr int kDqBQ = 64;  // query rows a block
constexpr int kDqBK = 64;  // keys a tile

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO, two K buffers, V; then p (float) and dS (bf16 pairs)
  return sizeof(bf16) * 5 * 64 * (D + 8) + sizeof(float) * 4 * 64 * 16 +
         sizeof(uint32_t) * 4 * 64 * 8;
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bf16_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, int H, int sq, int sk, float scale,
          int causal) {
  constexpr int LD = D + 8;
  constexpr int NJ = kDqBK / 8;   // n8 tiles of S and dP
  constexpr int NH = D / 16;      // n8 tiles of a warp's half of dQ
  extern __shared__ float4 smem4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem4);  // [64][LD]
  bf16* sdO = sQ + kDqBQ * LD;                 // [64][LD]
  bf16* sK = sdO + kDqBQ * LD;                 // [2][64][LD]
  bf16* sV = sK + 2 * kDqBK * LD;              // [64][LD]
  float* xp = reinterpret_cast<float*>(sV + kDqBK * LD);
  uint32_t* xs = reinterpret_cast<uint32_t*>(xp + 4 * NJ * 4 * 32);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int hd = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kDqBQ;  // heaviest first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int pair = warp & 3, role = warp >> 2;
  const int r_lo = 16 * pair + g;
  const int q_off = sk - sq;
  const long stride = (long)H * D;
  const long head = ((long)b * sq * H + hd) * D;
  const bf16* kb = k + ((long)b * sk * H + hd) * D;
  const bf16* vb = v + ((long)b * sk * H + hd) * D;

  int n_tiles = (sk + kDqBK - 1) / kDqBK;
  if (causal) n_tiles = min(sk - 1, q0 + kDqBQ - 1 + q_off) / kDqBK + 1;

  copy_rows<kDqBQ, D, kBwdThreads>(sQ, q + head, q0, sq, stride);
  copy_rows<kDqBQ, D, kBwdThreads>(sdO, dout + head, q0, sq, stride);
  copy_rows<kDqBK, D, kBwdThreads>(sK, kb, 0, sk, stride);
  copy_rows<kDqBK, D, kBwdThreads>(sV, vb, 0, sk, stride);
  commit();

  // the lane's rows' lse and delta; a row past sq gets p = 0
  float lr[2], dr[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + r_lo + 8 * hr;
    lr[hr] = row < sq ? lse[(long)bh * sq + row] : INFINITY;
    dr[hr] = row < sq ? delta[(long)bh * sq + row] : 0.f;
  }
  float acc[NH][4];
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kDqBK;
    const bf16* sKt = sK + (kt & 1) * kDqBK * LD;
    wait_prior<0>();  // this thread's copies of K and V have landed
    __syncthreads();  // everyone's; dS K of the last tile is done
    if (kt + 1 < n_tiles)
      copy_rows<kDqBK, D, kBwdThreads>(sK + ((kt + 1) & 1) * kDqBK * LD, kb,
                                       k0 + kDqBK, sk, stride);
    commit();

    // role 0: S = Q K^T; role 1: dP = dO V^T
    float s[NJ][4];
    row_products<D, NJ>(s, (role == 0 ? sQ : sdO) + r_lo * LD,
                        role == 0 ? sKt : sV, g, t);
    if (role == 0) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = q0 + r_lo + 8 * (e >> 1) + q_off;
          const int kpos = k0 + 8 * j + 2 * t + (e & 1);
          float p = 0.f;
          if (kpos < sk) {
            float x = s[j][e] * scale;
            if (causal && kpos > qpos) x = ptt::kMaskValue;
            p = expf(x - lr[e >> 1]);
          }
          *xp_at<NJ>(xp, pair, j, e, lane) = p;
        }
    }
    __syncthreads();  // p is across; dO V^T is done with V
    if (kt + 1 < n_tiles)
      copy_rows<kDqBK, D, kBwdThreads>(sV, vb, k0 + kDqBK, sk, stride);
    commit();
    if (role == 1) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = *xp_at<NJ>(xp, pair, j, e, lane) *
                    (s[j][e] - dr[e >> 1]) * scale;
#pragma unroll
      for (int kk = 0; kk < NJ / 2; ++kk) {
        uint32_t a[4];
        a_from_c<NJ>(a, s, kk);
#pragma unroll
        for (int r = 0; r < 4; ++r) *xs_at<NJ>(xs, pair, kk, r, lane) = a[r];
      }
    }
    __syncthreads();  // dS is across

    // dQ[:, role's half] += dS K
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk) {
      uint32_t a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = *xs_at<NJ>(xs, pair, kk, r, lane);
      col_products<D, NH>(acc, a, sKt + 16 * kk * LD + role * (D / 2), g, t);
    }
  }
  wait_prior<0>();

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + r_lo + 8 * hr;
    if (row >= sq) continue;
    bf16* drow = dq + head + row * stride + role * (D / 2) + 2 * t;
#pragma unroll
    for (int n = 0; n < NH; ++n)
      *reinterpret_cast<uint32_t*>(drow + 8 * n) =
          pack2(acc[n][2 * hr], acc[n][2 * hr + 1]);
  }
}

// ---------------------------------------------------------------------------
// dK / dV
// ---------------------------------------------------------------------------

constexpr int kDkvBK = 64;  // keys a block

template <int D>
struct DkvTile {
  static constexpr int kBQ = D == 256 ? 32 : 64;  // query rows a tile
  // K, V, two Q and two dO buffers; then p (float) and dS (bf16 pairs)
  static constexpr size_t kBytes =
      sizeof(bf16) * (2 * 64 + 4 * kBQ) * (D + 8) +
      sizeof(float) * 4 * kBQ * 16 + sizeof(uint32_t) * 4 * kBQ * 8;
};

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bf16_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int sq,
           int sk, float scale, int causal) {
  constexpr int LD = D + 8;
  constexpr int BQ = DkvTile<D>::kBQ;
  constexpr int NJ = BQ / 8;   // n8 tiles of S^T and dP^T
  constexpr int NH = D / 16;   // n8 tiles of a warp's half of dK and dV
  extern __shared__ float4 smem4[];
  bf16* sK = reinterpret_cast<bf16*>(smem4);  // [64][LD]
  bf16* sV = sK + kDkvBK * LD;                 // [64][LD]
  bf16* sQ = sV + kDkvBK * LD;                 // [2][BQ][LD]
  bf16* sdO = sQ + 2 * BQ * LD;                // [2][BQ][LD]
  float* xp = reinterpret_cast<float*>(sdO + 2 * BQ * LD);
  uint32_t* xs = reinterpret_cast<uint32_t*>(xp + 4 * NJ * 4 * 32);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int hd = bh - b * H;
  const int k0 = blockIdx.y * kDkvBK;  // key tile 0, the heaviest, first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int pair = warp & 3, role = warp >> 2;
  const int r_lo = 16 * pair + g;  // the lane's keys k0 + r_lo (+ 8)
  const int q_off = sk - sq;
  const long stride = (long)H * D;
  const long qhead = ((long)b * sq * H + hd) * D;
  const long khead = ((long)b * sk * H + hd) * D;
  const float* lse_bh = lse + (long)bh * sq;
  const float* delta_bh = delta + (long)bh * sq;

  const int n_q = (sq + BQ - 1) / BQ;
  const int it0 = causal ? max(0, k0 - q_off) / BQ : 0;

  copy_rows<kDkvBK, D, kBwdThreads>(sK, k + khead, k0, sk, stride);
  copy_rows<kDkvBK, D, kBwdThreads>(sV, v + khead, k0, sk, stride);
  copy_rows<BQ, D, kBwdThreads>(sQ, q + qhead, it0 * BQ, sq, stride);
  copy_rows<BQ, D, kBwdThreads>(sdO, dout + qhead, it0 * BQ, sq, stride);
  commit();

  float acc_k[NH][4], acc_v[NH][4];
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int it = it0; it < n_q; ++it) {
    const int qs = it * BQ;
    const int buf = (it - it0) & 1;
    const bf16* sQt = sQ + buf * BQ * LD;
    const bf16* sdOt = sdO + buf * BQ * LD;
    wait_prior<0>();  // this thread's copies of Q and dO have landed
    __syncthreads();  // everyone's; the last tile's products are done
    if (it + 1 < n_q) {
      copy_rows<BQ, D, kBwdThreads>(sQ + (buf ^ 1) * BQ * LD, q + qhead,
                                    qs + BQ, sq, stride);
      copy_rows<BQ, D, kBwdThreads>(sdO + (buf ^ 1) * BQ * LD, dout + qhead,
                                    qs + BQ, sq, stride);
    }
    commit();

    // role 0: S^T = K Q^T; role 1: dP^T = V dO^T
    float s[NJ][4];
    row_products<D, NJ>(s, (role == 0 ? sK : sV) + r_lo * LD,
                        role == 0 ? sQt : sdOt, g, t);
    if (role == 0) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = qs + 8 * j + 2 * t + (e & 1);
          const int kpos = k0 + r_lo + 8 * (e >> 1);
          float p = 0.f;
          if (qi < sq && kpos < sk) {
            float x = s[j][e] * scale;
            if (causal && kpos > qi + q_off) x = ptt::kMaskValue;
            p = expf(x - lse_bh[qi]);
          }
          *xp_at<NJ>(xp, pair, j, e, lane) = p;
        }
    }
    __syncthreads();  // p is across
    if (role == 1) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = qs + 8 * j + 2 * t + (e & 1);
          const float dl = qi < sq ? delta_bh[qi] : 0.f;
          s[j][e] = *xp_at<NJ>(xp, pair, j, e, lane) * (s[j][e] - dl) * scale;
        }
#pragma unroll
      for (int kk = 0; kk < NJ / 2; ++kk) {
        uint32_t a[4];
        a_from_c<NJ>(a, s, kk);
#pragma unroll
        for (int r = 0; r < 4; ++r) *xs_at<NJ>(xs, pair, kk, r, lane) = a[r];
      }
    }
    __syncthreads();  // dS^T is across

    // dV[:, role's half] += P^T dO; dK[:, role's half] += dS^T Q
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk) {
      uint32_t ap[4], as[4];
      ap[0] = pack2(*xp_at<NJ>(xp, pair, 2 * kk, 0, lane),
                    *xp_at<NJ>(xp, pair, 2 * kk, 1, lane));
      ap[1] = pack2(*xp_at<NJ>(xp, pair, 2 * kk, 2, lane),
                    *xp_at<NJ>(xp, pair, 2 * kk, 3, lane));
      ap[2] = pack2(*xp_at<NJ>(xp, pair, 2 * kk + 1, 0, lane),
                    *xp_at<NJ>(xp, pair, 2 * kk + 1, 1, lane));
      ap[3] = pack2(*xp_at<NJ>(xp, pair, 2 * kk + 1, 2, lane),
                    *xp_at<NJ>(xp, pair, 2 * kk + 1, 3, lane));
#pragma unroll
      for (int r = 0; r < 4; ++r) as[r] = *xs_at<NJ>(xs, pair, kk, r, lane);
      const int off = 16 * kk * LD + role * (D / 2);
      col_products<D, NH>(acc_v, ap, sdOt + off, g, t);
      col_products<D, NH>(acc_k, as, sQt + off, g, t);
    }
  }
  wait_prior<0>();

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = k0 + r_lo + 8 * hr;
    if (key >= sk) continue;
    const long off = khead + key * stride + role * (D / 2) + 2 * t;
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * n) =
          pack2(acc_k[n][2 * hr], acc_k[n][2 * hr + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * n) =
          pack2(acc_v[n][2 * hr], acc_v[n][2 * hr + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <class K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
int launch_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o,
               float* lse, int B, int H, int sq, int sk, float scale,
               int causal, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<D>();
  const int err = set_smem(flash_bf16_fwd_kernel<D>, smem);
  if (err) return err;
  const dim3 grid(B * H, (sq + kFwdBQ - 1) / kFwdBQ);
  flash_bf16_fwd_kernel<D><<<grid, kFwdThreads, smem, stream>>>(
      q, k, v, o, lse, H, sq, sk, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
              const float* lse, const float* delta, bf16* dq, int B, int H,
              int sq, int sk, float scale, int causal, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  const int err = set_smem(flash_bf16_dq_kernel<D>, smem);
  if (err) return err;
  const dim3 grid(B * H, (sq + kDqBQ - 1) / kDqBQ);
  flash_bf16_dq_kernel<D><<<grid, kBwdThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, H, sq, sk, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
               const float* lse, const float* delta, bf16* dk, bf16* dv,
               int B, int H, int sq, int sk, float scale, int causal,
               cudaStream_t stream) {
  const size_t smem = DkvTile<D>::kBytes;
  const int err = set_smem(flash_bf16_dkv_kernel<D>, smem);
  if (err) return err;
  const dim3 grid(B * H, (sk + kDkvBK - 1) / kDkvBK);
  flash_bf16_dkv_kernel<D><<<grid, kBwdThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, H, sq, sk, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, sq, H, D], k/v [B, sk, H, D], o [B, sq, H, D] bfloat16 (as uint16
// bits), lse [B*H, sq] float32; all contiguous, 16-byte aligned. Returns a
// cudaError_t (0 = launched).
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* o, float* lse,
                                        int B, int H, int sq, int sk, int D,
                                        float scale, int causal,
                                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  switch (D) {
    case 64:
      return launch_fwd<64>(qp, kp, vp, op, lse, B, H, sq, sk, scale,
                            causal, s);
    case 128:
      return launch_fwd<128>(qp, kp, vp, op, lse, B, H, sq, sk, scale,
                             causal, s);
    case 256:
      return launch_fwd<256>(qp, kp, vp, op, lse, B, H, sq, sk, scale,
                             causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dq [B, sq, H, D] from q, k, v, dout (bfloat16) and the forward's lse and
// delta = rowsum(dout * o) ([B*H, sq] float32).
extern "C" int flash_attention_bwd_dq_bf16(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const float* lse,
                                           const float* delta, void* dq,
                                           int B, int H, int sq, int sk,
                                           int D, float scale, int causal,
                                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dp = static_cast<const bf16*>(dout);
  bf16* out = static_cast<bf16*>(dq);
  switch (D) {
    case 64:
      return launch_dq<64>(qp, kp, vp, dp, lse, delta, out, B, H, sq, sk,
                           scale, causal, s);
    case 128:
      return launch_dq<128>(qp, kp, vp, dp, lse, delta, out, B, H, sq, sk,
                            scale, causal, s);
    case 256:
      return launch_dq<256>(qp, kp, vp, dp, lse, delta, out, B, H, sq, sk,
                            scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dk, dv [B, sk, H, D] (bfloat16), as dq.
extern "C" int flash_attention_bwd_dkv_bf16(const void* q, const void* k,
                                            const void* v, const void* dout,
                                            const float* lse,
                                            const float* delta, void* dk,
                                            void* dv, int B, int H, int sq,
                                            int sk, int D, float scale,
                                            int causal, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dp = static_cast<const bf16*>(dout);
  bf16 *dkp = static_cast<bf16*>(dk), *dvp = static_cast<bf16*>(dv);
  switch (D) {
    case 64:
      return launch_dkv<64>(qp, kp, vp, dp, lse, delta, dkp, dvp, B, H, sq,
                            sk, scale, causal, s);
    case 128:
      return launch_dkv<128>(qp, kp, vp, dp, lse, delta, dkp, dvp, B, H, sq,
                             sk, scale, causal, s);
    case 256:
      return launch_dkv<256>(qp, kp, vp, dp, lse, delta, dkp, dvp, B, H, sq,
                             sk, scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
