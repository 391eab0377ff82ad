// Flash attention in bfloat16 for Hopper (sm_90a): the forward, dQ and
// dK/dV of mixed-precision training, bf16 products with float32
// accumulation on the tensor cores: the forward and dK/dV as wgmma.mma_async
// in warp-specialised blocks fed by TMA, dQ as mma.sync.m16n8k16.
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
// GFLOP: 0.069 ms). Only wgmma reaches that rate (mma.sync does not), and
// wgmma reads its B operand, and in the SS form its A, from shared memory
// by descriptor: so the tiles arrive by TMA in the 128-byte swizzle that
// the descriptors read (csrc/sm90.cuh), and P, P^T and dS^T, formed in
// registers, are the RS form's A straight from the accumulators.
//
// Forward (flash_bf16_fwd_kernel): a block owns one (batch, head) and 128
//   query rows, heaviest query tile first, in 384 threads: a producer
//   warpgroup, whose one thread loads Q once and keeps a ring of 2 K and 2
//   V tiles of 64 keys full by TMA (full and empty mbarriers a stage), and
//   two consumer warpgroups of 64 rows each. Per key tile a consumer runs
//   S = Q K^T as D / 16 SS wgmma m64n64k16 (Q and K K-major), the online
//   softmax on S's accumulators (a warp's slice is mma.sync's m16n8 C
//   layout: a row's max and sum across the 4 lanes that hold it by two xor
//   shuffles), then O += P V as 4 RS wgmma m64nDk16, P packed to bf16 from
//   S's accumulators and V MN-major; O stays in registers (D / 2 floats a
//   thread), and a warpgroup releases the key tiles past its causal
//   diagonal unread. setmaxnreg gives the producer 24 registers and each
//   consumer 240. Shared memory at D = 256: Q 64 KB, 2 x (K 32 + V 32) KB:
//   192 KB and its barriers, one block an SM; at every D the same tiles.
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
//   one block an SM. The simple version that is right first: mma.sync (not
//   wgmma), cp.async (not TMA).
//
// dK/dV (flash_bf16_dkv_kernel): a block owns 64 keys of one (batch, head)
//   in 384 threads: a producer warpgroup, whose warp 0 loads K and V once
//   and keeps a ring of 2 Q and 2 dO tiles of 64 query rows full by TMA,
//   from the first tile that sees the block's keys under causal masking to
//   the last, and whose warp 1 copies each tile's lse and delta beside them
//   (the tile's full barriers count its 32 lanes and the TMA bytes); and
//   two consumer warpgroups over the block's 64 keys, each accumulating all
//   D columns of one output (D / 2 floats a thread). Per query tile
//   consumer 0 runs S^T = K Q^T (SS, both K-major), forms p^T = exp(s scale
//   - lse) under the masks, hands p^T (float32) to consumer 1 through
//   shared memory on a named barrier, and adds P^T dO into dV (RS: P^T
//   packed to bf16 from its accumulators, dO MN-major); consumer 1 runs
//   dP^T = V dO^T (SS), forms dS^T = p^T (dP^T - delta) scale in float32,
//   and adds dS^T Q into dK (RS: dS^T packed to bf16, Q MN-major). Shared
//   memory at D = 256: K and V 64 KB, 2 x (Q 32 + dO 32) KB, p^T 16 KB,
//   lse and delta 1 KB: 209 KB and its barriers, one block an SM.
//
// dQ's fragments: A (16 x 16, row-major) and B (16 x 8, column-major) as
// PTX's m16n8k16 layouts, each 32-bit register two bf16 values of one row
// (A) or column (B), the lower index in the low half. Operands read along
// a row of shared memory (Q, dO, K and V as the first products' A and B)
// are one 32-bit read a register; operands read down a column (K in dS K)
// two 16-bit reads a register. The pitch of D + 8 values (D / 2 + 4 words)
// puts a quarter warp's reads of either kind on distinct banks.
//
// Registers (nvcc -Xptxas -v, sm_90a) of dQ at D = 256 / 128 / 64: 169 /
// 138 / 118, no spills, no stack; the forward's and dK/dV's are those of
// the launch bound (168: 384 threads, one block an SM), which setmaxnreg
// moves to 24 (producer) and 240 (consumers).
#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "sm90.cuh"

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
// 2^x (ex2.approx: 2 ulp; 0 for -inf and below the smallest normal).
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
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
// the forward's and dK/dV's warp-specialised blocks
// ---------------------------------------------------------------------------

// A producer warpgroup (TMA, and dK/dV's lse and delta) and two consumer
// warpgroups (wgmma); setmaxnreg moves the producer's registers to the
// consumers: 24 + 2 x 240 = 3 x 168, the 65,536 of an SM over 384 threads.
constexpr int kWsThreads = 384;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kStages = 2;  // tiles in each ring

constexpr float kLog2e = 1.4426950408889634f;

// Bytes of a tile of 64 rows of D values: D / 64 boxes.
template <int D>
constexpr uint32_t tile_bytes() {
  return 64u * D * sizeof(bf16);
}

// The shared address of the dynamic shared memory, rounded up to 1024
// bytes (the 128-byte swizzle's period; each layout asks 1024 more).
__device__ __forceinline__ uint32_t aligned_base(const void* smem) {
  return (sm90::smem_u32(smem) + 1023u) & ~1023u;
}

// The grids of the forward and dK/dV: a block's (batch, head) and tile
// level (0 the heaviest). Heaviest first over all (batch, head)s would
// stream every head's K and V (the forward; Q and dO for dK/dV) once a
// level from device memory, since the blocks in flight span all heads;
// so the heads go in groups whose streamed tensors fit in half the L2
// (kL2Budget), heaviest first within a group: the levels of a group's
// heads run together and read those tensors from L2.
constexpr long kL2Budget = 24l << 20;
struct GridOrder {
  int bh_count, levels, group;  // heads a group, from the host
  __device__ __forceinline__ void at(int i, int& bh, int& level) const {
    const int span = group * levels;
    const int g0 = i / span * group;
    const int size = min(group, bh_count - g0);
    const int j = i - g0 * levels;
    level = j / size;
    bh = g0 + (j - level * size);
  }
};
// The order of bh_count heads in `levels` tile levels, each head
// streaming `bytes` (its K and V, or Q and dO).
inline GridOrder grid_order(int bh_count, int levels, long bytes) {
  const long group = max(1l, min((long)bh_count, kL2Budget / bytes));
  return GridOrder{bh_count, levels, (int)group};
}

// Rows r0 .. r0 + 63 of head hd of batch b of the tensor behind `map`
// into the tile at dst, box by box; their bytes complete on bar.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int r0, int hd,
                                          int b) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    sm90::tma_load_4d(dst + c * sm90::kBoxBytes, map, bar, 64 * c, hd, r0, b);
}

// The A fragment of k16 step kk of a warpgroup's 64 x 64 C tile (the
// thread's 32 accumulators), rounded to bf16: a_from_c on the flat layout.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c)[32],
                                       int kk) {
  a[0] = pack2(c[8 * kk], c[8 * kk + 1]);
  a[1] = pack2(c[8 * kk + 2], c[8 * kk + 3]);
  a[2] = pack2(c[8 * kk + 4], c[8 * kk + 5]);
  a[3] = pack2(c[8 * kk + 6], c[8 * kk + 7]);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

constexpr int kFwdBQ = 128;  // query rows a block: 64 a consumer warpgroup
constexpr int kFwdBK = 64;   // keys a tile

// Shared memory, byte offsets from the aligned base: Q (a tile for each
// consumer), the rings of K and V tiles, the barriers.
template <int D>
struct FwdSmem {
  static constexpr uint32_t kTile = tile_bytes<D>();
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = 2 * kTile;
  static constexpr uint32_t kV = kK + kStages * kTile;
  // full_q, then kStages each of full_k, full_v, empty_k, empty_v
  static constexpr uint32_t kBar = kV + kStages * kTile;
  static constexpr size_t kBytes = kBar + 8 * (1 + 4 * kStages) + 1024;
};

// Key tiles that query rows r0 .. r0 + 63 see: none past sq, all of them,
// or causal up to the diagonal of the last row.
__device__ __forceinline__ int fwd_tiles(int r0, int sq, int sk, int causal) {
  if (r0 >= sq) return 0;
  if (!causal) return (sk + kFwdBK - 1) / kFwdBK;
  return min(sk - 1, min(r0 + 63, sq - 1) + sk - sq) / kFwdBK + 1;
}

// Start S = Q K^T (64 x 64, Q and K K-major) into sc as one group.
template <int D>
__device__ __forceinline__ void start_qk(float (&sc)[32], uint32_t sQ,
                                         uint32_t sK) {
  sm90::wg_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    sm90::wgmma_ss_n64<0>(sc, sm90::desc_k(sQ, ks), sm90::desc_k(sK, ks),
                          ks > 0);
  sm90::wg_commit();
}

// The online softmax over one key tile of S in the log2 domain (the
// thread's 32 accumulators times scale log2(e); its rows at causal
// positions qpos and qpos + 8, its keys k0 + 8 j + 2 t + {0, 1}); MASK
// when a key of the tile is past sk or past a row's diagonal: the rows'
// new maxima over the 4 lanes of a row, alpha = 2^(old max - new max) (0
// from -inf), l = l alpha + the tile's sum; S becomes p.
template <bool MASK>
__device__ __forceinline__ void online_softmax(float (&sc)[32], float (&m)[2],
                                               float (&l)[2],
                                               float (&alpha)[2], int qpos,
                                               int k0, int t, int sk,
                                               int causal, float scale2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * j + e] * scale2;
      if (MASK) {
        const int kpos = k0 + 8 * j + 2 * t + (e & 1);
        if (kpos >= sk) x = -INFINITY;
        else if (causal && kpos > qpos + 8 * (e >> 1)) x = ptt::kMaskValue;
      }
      sc[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mx[hr] = fmaxf(mx[hr], shfl_xor(mx[hr], 1));
    mx[hr] = fmaxf(mx[hr], shfl_xor(mx[hr], 2));
    alpha[hr] = (m[hr] == -INFINITY) ? 0.f : ex2(m[hr] - mx[hr]);
    m[hr] = mx[hr];
    l[hr] *= alpha[hr];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float p = ex2(sc[i] - m[(i >> 1) & 1]);  // 0 from -inf
    sc[i] = p;
    l[(i >> 1) & 1] += p;
  }
}

// Start O += P V (P from registers, V MN-major) as one group.
template <int D>
__device__ __forceinline__ void start_pv(float (&acc)[D / 2],
                                         uint32_t (&pa)[4][4], uint32_t sV) {
  sm90::fence_operands(acc);
  sm90::wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sm90::wgmma_rs<D, 1>(acc, pa[kk], sm90::desc_mn(sV, kk), 1);
  sm90::wg_commit();
  sm90::fence_operands(acc);
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bf16_fwd_kernel(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv,
           const __grid_constant__ CUtensorMap to, float* __restrict__ lse,
           int H, int sq, int sk, float scale, int causal, GridOrder order) {
  using L = FwdSmem<D>;
  constexpr int NO = D / 2;  // O's accumulators a thread
  extern __shared__ float4 smem4[];
  const uint32_t base = aligned_base(smem4);
  const uint32_t full_q = base + L::kBar;
  const auto bar = [&](int kind, int s) {
    return full_q + 8 * (1 + kind * kStages + s);
  };
  enum { kFullK, kFullV, kEmptyK, kEmptyV };

  int bh, level;
  order.at(blockIdx.x, bh, level);
  const int b = bh / H;
  const int hd = bh - b * H;
  // level 0 is the last query tile, the heaviest
  const int q0 = (order.levels - 1 - level) * kFwdBQ;
  const int n_tiles = max(fwd_tiles(q0, sq, sk, causal),
                          fwd_tiles(q0 + 64, sq, sk, causal));
  if (threadIdx.x == 0) {
    sm90::bar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::bar_init(bar(kFullK, s), 1);
      sm90::bar_init(bar(kFullV, s), 1);
      sm90::bar_init(bar(kEmptyK, s), 8);  // each consumer warp once
      sm90::bar_init(bar(kEmptyV, s), 8);
    }
    sm90::bar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // the producer: one thread keeps the rings full, K and V apart (K is
    // released when S is read, V when P V is done)
    sm90::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      sm90::bar_expect_tx(full_q, 2 * L::kTile);
      load_tile<D>(base + L::kQ, &tq, full_q, q0, hd, b);
      load_tile<D>(base + L::kQ + L::kTile, &tq, full_q, q0 + 64, hd, b);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % kStages;
        const uint32_t parity = ((kt / kStages) & 1) ^ 1;
        sm90::bar_wait(bar(kEmptyK, s), parity);
        sm90::bar_expect_tx(bar(kFullK, s), L::kTile);
        load_tile<D>(base + L::kK + s * L::kTile, &tk, bar(kFullK, s),
                     kt * kFwdBK, hd, b);
        sm90::bar_wait(bar(kEmptyV, s), parity);
        sm90::bar_expect_tx(bar(kFullV, s), L::kTile);
        load_tile<D>(base + L::kV + s * L::kTile, &tv, bar(kFullV, s),
                     kt * kFwdBK, hd, b);
      }
    }
    return;
  }

  // a consumer: 64 query rows, warp w their rows 16 w .. 16 w + 15
  sm90::regs_inc<kConsumerRegs>();
  const int c = wg - 1;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 64 * c;
  const int r_lo = 16 * warp + g;  // the thread's rows r0 + r_lo (+ 8)
  const int qpos = r0 + r_lo + sk - sq;
  const int my_tiles = fwd_tiles(r0, sq, sk, causal);
  const float scale2 = scale * kLog2e;
  const uint32_t sQ = base + L::kQ + c * L::kTile;
  const auto sK = [&](int kt) {
    return base + L::kK + (kt % kStages) * L::kTile;
  };
  const auto sV = [&](int kt) {
    return base + L::kV + (kt % kStages) * L::kTile;
  };
  const auto phase = [&](int kt) { return (uint32_t)(kt / kStages) & 1; };
  const auto release = [&](uint32_t mbar) {
    __syncwarp();
    if (lane == 0) sm90::bar_arrive(mbar);
  };
  // the consumers start their products in turns (named barriers 1 + c):
  // one's softmax runs under the other's products; consumer 0 goes first
  // and takes consumer 1's last turn at the end
  const auto my_turn = [&]() { sm90::named_sync(1 + c, 256); };
  const auto your_turn = [&]() { sm90::named_arrive(2 - c, 256); };
  if (c == 1) sm90::named_arrive(1, 256);
  // the tile's softmax, masked only where a key is past sk or past the
  // diagonal of the warpgroup's first row
  const auto softmax = [&](float (&sc)[32], float (&m)[2], float (&l)[2],
                           float (&alpha)[2], int kt) {
    const int k0 = kt * kFwdBK;
    if (k0 + kFwdBK > sk || (causal && k0 + kFwdBK - 1 > r0 + sk - sq))
      online_softmax<true>(sc, m, l, alpha, qpos, k0, t, sk, causal, scale2);
    else
      online_softmax<false>(sc, m, l, alpha, qpos, k0, t, sk, causal, scale2);
  };

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // the rows' maxima, log2 domain
  float l[2] = {0.f, 0.f};  // the thread's part of each row's sum
  sm90::bar_wait(full_q, 0);
  if (my_tiles > 0) {
    float sc[32];       // S of the next tile, then its p
    uint32_t pa[4][4];  // P of this tile, bf16, as P V's A
    float alpha[2];
    sm90::bar_wait(bar(kFullK, 0), 0);
    my_turn();
    start_qk<D>(sc, sQ, sK(0));
    your_turn();
    sm90::wg_wait<0>();
    sm90::fence_operands(sc);
    release(bar(kEmptyK, 0));
    softmax(sc, m, l, alpha, 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_a(pa[kk], sc, kk);

    // S of tile kt + 1 started before P V of tile kt, so that its softmax
    // runs under P V; O is rescaled once P V is done
    for (int kt = 0; kt + 1 < my_tiles; ++kt) {
      sm90::bar_wait(bar(kFullK, (kt + 1) % kStages), phase(kt + 1));
      sm90::bar_wait(bar(kFullV, kt % kStages), phase(kt));
      my_turn();
      start_qk<D>(sc, sQ, sK(kt + 1));
      start_pv<D>(acc, pa, sV(kt));
      your_turn();
      sm90::wg_wait<1>();  // S of tile kt + 1
      sm90::fence_operands(sc);
      release(bar(kEmptyK, (kt + 1) % kStages));
      softmax(sc, m, l, alpha, kt + 1);
      sm90::wg_wait<0>();  // P V of tile kt
      sm90::fence_operands(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) sm90::fence_operands(pa[kk]);
      release(bar(kEmptyV, kt % kStages));
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pack_a(pa[kk], sc, kk);
    }
    const int last = my_tiles - 1;
    sm90::bar_wait(bar(kFullV, last % kStages), phase(last));
    my_turn();
    start_pv<D>(acc, pa, sV(last));
    your_turn();
    sm90::wg_wait<0>();
    sm90::fence_operands(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::fence_operands(pa[kk]);
    release(bar(kEmptyV, last % kStages));
  } else {
    my_turn();
    your_turn();
  }
  // past this warpgroup's causal diagonal: the tiles released unread
  for (int kt = my_tiles; kt < n_tiles; ++kt) {
    my_turn();
    your_turn();
    sm90::bar_wait(bar(kFullK, kt % kStages), phase(kt));
    release(bar(kEmptyK, kt % kStages));
    sm90::bar_wait(bar(kFullV, kt % kStages), phase(kt));
    release(bar(kEmptyV, kt % kStages));
  }
  if (c == 0) my_turn();  // consumer 1's last turn

  // O / l as bf16 into the warpgroup's Q tile (its last S is done), laid
  // out as a TMA load would write it, then stored by TMA: rows past sq are
  // not written
  constexpr float kLn2 = 0.6931471805599453f;
  char* const sO = reinterpret_cast<char*>(smem4) +
                   (sQ - sm90::smem_u32(smem4));
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += shfl_xor(l[hr], 1);
    l[hr] += shfl_xor(l[hr], 2);
    const int r = r_lo + 8 * hr;  // the row in the tile
    const float l_safe = (l[hr] == 0.f) ? 1.f : l[hr];
    const float inv = 1.f / l_safe;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(
          sO + (n >> 3) * sm90::kBoxBytes + r * 128 +
          (((n & 7) ^ (r & 7)) << 4) + 4 * t) =
          pack2(acc[4 * n + 2 * hr] * inv, acc[4 * n + 2 * hr + 1] * inv);
    if (t == 0 && r0 + r < sq)
      lse[(long)bh * sq + r0 + r] = m[hr] * kLn2 + logf(l_safe);
  }
  sm90::fence_proxy_async();
  sm90::named_sync(3 + c, 128);
  if (tid == 0) {
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb)
      sm90::tma_store_4d(&to, sQ + cb * sm90::kBoxBytes, 64 * cb, hd, r0, b);
    sm90::bulk_commit();
    sm90::bulk_wait_read();
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
constexpr int kDkvBQ = 64;  // query rows a tile
constexpr int kPReady = 1;  // named barriers of the two consumers: p^T is
constexpr int kPFree = 2;   // in shared memory; it has been read

// Shared memory, byte offsets from the aligned base: K, V, the rings of Q
// and dO tiles, p^T (float32, [32 accumulators][128 threads]), the rings'
// lse and delta, the barriers.
template <int D>
struct DkvSmem {
  static constexpr uint32_t kTile = tile_bytes<D>();
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kTile;
  static constexpr uint32_t kQ = 2 * kTile;
  static constexpr uint32_t kDo = kQ + kStages * kTile;
  static constexpr uint32_t kP = kDo + kStages * kTile;
  static constexpr uint32_t kL = kP + 32 * 128 * sizeof(float);
  static constexpr uint32_t kDl = kL + kStages * kDkvBQ * sizeof(float);
  // full_kv, full_q[kStages], full_do[kStages], empty[kStages]
  static constexpr uint32_t kBar = kDl + kStages * kDkvBQ * sizeof(float);
  static constexpr size_t kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bf16_dkv_kernel(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv,
           const __grid_constant__ CUtensorMap tdo,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int sq,
           int sk, float scale, int causal, GridOrder order) {
  using L = DkvSmem<D>;
  constexpr int NO = D / 2;  // dV's or dK's accumulators a thread
  extern __shared__ float4 smem4[];
  const uint32_t base = aligned_base(smem4);
  char* const base_ptr = reinterpret_cast<char*>(smem4) +
                    (base - sm90::smem_u32(smem4));
  float* const sP = reinterpret_cast<float*>(base_ptr + L::kP);
  float* const sL = reinterpret_cast<float*>(base_ptr + L::kL);
  float* const sDl = reinterpret_cast<float*>(base_ptr + L::kDl);
  const uint32_t full_kv = base + L::kBar;
  const auto full_q = [&](int s) { return full_kv + 8 * (1 + s); };
  const auto full_do = [&](int s) {
    return full_kv + 8 * (1 + kStages + s);
  };
  const auto empty = [&](int s) {
    return full_kv + 8 * (1 + 2 * kStages + s);
  };

  int bh, level;
  order.at(blockIdx.x, bh, level);
  const int b = bh / H;
  const int hd = bh - b * H;
  const int k0 = level * kDkvBK;  // key tile 0 the heaviest
  const int q_off = sk - sq;
  const int n_q = (sq + kDkvBQ - 1) / kDkvBQ;
  // the first query tile that sees the block's keys
  const int it0 = causal ? max(0, k0 - q_off) / kDkvBQ : 0;
  if (threadIdx.x == 0) {
    sm90::bar_init(full_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      // the TMA thread's arrival with the tile's bytes, and warp 1's 32
      // lanes with its lse (full_q) or delta (full_do)
      sm90::bar_init(full_q(s), 33);
      sm90::bar_init(full_do(s), 33);
      sm90::bar_init(empty(s), 8);  // each consumer warp once
    }
    sm90::bar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  if (wg == 0) {
    // the producer: warp 0's first lane loads K and V once and the Q and
    // dO tiles by TMA; warp 1 copies each tile's lse and delta
    sm90::regs_dec<kProducerRegs>();
    if (warp == 0 && lane == 0) {
      sm90::bar_expect_tx(full_kv, 2 * L::kTile);
      load_tile<D>(base + L::kK, &tk, full_kv, k0, hd, b);
      load_tile<D>(base + L::kV, &tv, full_kv, k0, hd, b);
      for (int it = it0; it < n_q; ++it) {
        const int i = it - it0, s = i % kStages;
        sm90::bar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        sm90::bar_expect_tx(full_q(s), L::kTile);
        load_tile<D>(base + L::kQ + s * L::kTile, &tq, full_q(s),
                     it * kDkvBQ, hd, b);
        sm90::bar_expect_tx(full_do(s), L::kTile);
        load_tile<D>(base + L::kDo + s * L::kTile, &tdo, full_do(s),
                     it * kDkvBQ, hd, b);
      }
    } else if (warp == 1) {
      const float* lse_bh = lse + (long)bh * sq;
      const float* delta_bh = delta + (long)bh * sq;
      for (int it = it0; it < n_q; ++it) {
        const int i = it - it0, s = i % kStages;
        sm90::bar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        for (int r = lane; r < kDkvBQ; r += 32) {
          const int qi = it * kDkvBQ + r;
          sL[s * kDkvBQ + r] = qi < sq ? lse_bh[qi] : 0.f;
          sDl[s * kDkvBQ + r] = qi < sq ? delta_bh[qi] : 0.f;
        }
        sm90::bar_arrive(full_q(s));
        sm90::bar_arrive(full_do(s));
      }
    }
    return;
  }

  // the consumers: the block's 64 keys, warp w their keys 16 w .. 16 w +
  // 15; consumer 0 accumulates dV, consumer 1 dK, all D columns
  sm90::regs_inc<kConsumerRegs>();
  const int c = wg - 1;
  const int tid = threadIdx.x & 127;
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = 16 * warp + g;  // the thread's keys k0 + r_lo (+ 8)
  const float scale2 = scale * kLog2e;
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  sm90::bar_wait(full_kv, 0);

  for (int it = it0; it < n_q; ++it) {
    const int i = it - it0, s = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    const int qs = it * kDkvBQ;
    const uint32_t sQ = base + L::kQ + s * L::kTile;
    const uint32_t sDo = base + L::kDo + s * L::kTile;
    float st[32];  // S^T, then p^T (consumer 0); dP^T, then dS^T (1)
    uint32_t fa[4][4];
    if (c == 0) {
      // S^T = K Q^T, then p^T = exp(s scale - lse) under the masks
      sm90::bar_wait(full_q(s), phase);
      sm90::wg_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        sm90::wgmma_ss_n64<0>(st, sm90::desc_k(base + L::kK, ks),
                              sm90::desc_k(sQ, ks), ks > 0);
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::fence_operands(st);
      // in the log2 domain: p = 2^(s scale log2(e) - lse log2(e)); the
      // masks only on a tile with a query past sq, a key past sk or a key
      // past a query's diagonal
      const float* lse_t = sL + s * kDkvBQ;
      const bool mask = qs + kDkvBQ > sq || k0 + kDkvBK > sk ||
                        (causal && k0 + kDkvBK - 1 > qs + q_off);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          float x = st[4 * j + e] * scale2;
          if (mask) {
            const int qi = qs + col, kpos = k0 + r_lo + 8 * (e >> 1);
            if (qi >= sq || kpos >= sk) x = -INFINITY;
            else if (causal && kpos > qi + q_off) x = ptt::kMaskValue;
          }
          st[4 * j + e] = ex2(x - lse_t[col] * kLog2e);
        }
      // p^T across to consumer 1, once it has read the last tile's
      if (i > 0) sm90::named_sync(kPFree, 256);
#pragma unroll
      for (int e = 0; e < 32; ++e) sP[e * 128 + tid] = st[e];
      sm90::named_arrive(kPReady, 256);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pack_a(fa[kk], st, kk);
      // dV += P^T dO: P^T from registers, dO MN-major
      sm90::bar_wait(full_do(s), phase);
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs<D, 1>(acc, fa[kk], sm90::desc_mn(sDo, kk), 1);
    } else {
      // dP^T = V dO^T, then dS^T = p^T (dP^T - delta) scale
      sm90::bar_wait(full_do(s), phase);
      sm90::wg_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        sm90::wgmma_ss_n64<0>(st, sm90::desc_k(base + L::kV, ks),
                              sm90::desc_k(sDo, ks), ks > 0);
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::fence_operands(st);
      const float* dl_t = sDl + s * kDkvBQ;
      sm90::named_sync(kPReady, 256);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = qs + 8 * j + 2 * t + (e & 1);
          const float dl = qi < sq ? dl_t[qi - qs] : 0.f;
          st[4 * j + e] = sP[(4 * j + e) * 128 + tid] *
                          (st[4 * j + e] - dl) * scale;
        }
      if (it + 1 < n_q) sm90::named_arrive(kPFree, 256);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pack_a(fa[kk], st, kk);
      // dK += dS^T Q: dS^T from registers, Q MN-major
      sm90::bar_wait(full_q(s), phase);
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs<D, 1>(acc, fa[kk], sm90::desc_mn(sQ, kk), 1);
    }
    sm90::wg_commit();
    sm90::wg_wait<0>();
    sm90::fence_operands(acc);
    __syncwarp();
    if (lane == 0) sm90::bar_arrive(empty(s));
  }

  bf16* const out = c == 0 ? dv : dk;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = k0 + r_lo + 8 * hr;
    if (key >= sk) continue;
    bf16* krow = out + (((long)b * sk + key) * H + hd) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(krow + 8 * n) =
          pack2(acc[4 * n + 2 * hr], acc[4 * n + 2 * hr + 1]);
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
  CUtensorMap tq, tk, tv, to;
  int err = sm90::encode_bshd(&tq, q, B, sq, H, D, 64);
  if (!err) err = sm90::encode_bshd(&tk, k, B, sk, H, D, 64);
  if (!err) err = sm90::encode_bshd(&tv, v, B, sk, H, D, 64);
  if (!err) err = sm90::encode_bshd(&to, o, B, sq, H, D, 64);
  if (!err) err = set_smem(flash_bf16_fwd_kernel<D>, FwdSmem<D>::kBytes);
  if (err) return err;
  const GridOrder order = grid_order(B * H, (sq + kFwdBQ - 1) / kFwdBQ,
                                     4l * sk * D);
  flash_bf16_fwd_kernel<D><<<B * H * order.levels, kWsThreads,
                             FwdSmem<D>::kBytes, stream>>>(
      tq, tk, tv, to, lse, H, sq, sk, scale, causal, order);
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
  CUtensorMap tq, tk, tv, tdo;
  int err = sm90::encode_bshd(&tq, q, B, sq, H, D, 64);
  if (!err) err = sm90::encode_bshd(&tk, k, B, sk, H, D, 64);
  if (!err) err = sm90::encode_bshd(&tv, v, B, sk, H, D, 64);
  if (!err) err = sm90::encode_bshd(&tdo, dout, B, sq, H, D, 64);
  if (!err) err = set_smem(flash_bf16_dkv_kernel<D>, DkvSmem<D>::kBytes);
  if (err) return err;
  const GridOrder order = grid_order(B * H, (sk + kDkvBK - 1) / kDkvBK,
                                     4l * sq * D);
  flash_bf16_dkv_kernel<D><<<B * H * order.levels, kWsThreads,
                             DkvSmem<D>::kBytes, stream>>>(
      tq, tk, tv, tdo, lse, delta, dk, dv, H, sq, sk, scale, causal, order);
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
