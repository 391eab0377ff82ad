// Flash attention in bfloat16 for Hopper (sm_90a): the forward, dQ and
// dK/dV of mixed-precision training, bf16 products with float32
// accumulation on the tensor cores, each kernel wgmma.mma_async in
// warp-specialised blocks fed by TMA.
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
// All three blocks have 384 threads: a producer warpgroup, whose TMA
// threads keep rings of 2 tiles full on full and empty mbarriers, and two
// consumer warpgroups; setmaxnreg gives the producer 24 registers and each
// consumer 240. Their grids walk groups of heads whose streamed tiles fit
// in L2, heaviest tile first within a group (GridOrder).
//
// Forward (flash_bf16_fwd_kernel): a block owns one (batch, head) and 128
//   query rows; the producer's one thread loads Q once and keeps a ring of
//   2 K and 2 V tiles of 64 keys full, and the two consumers own 64 rows
//   each. Per key tile a consumer runs S = Q K^T as D / 16 SS wgmma
//   m64n64k16 (Q and K K-major), the online softmax on S's accumulators (a
//   warp's slice is mma.sync's m16n8 C layout: a row's max and sum across
//   the 4 lanes that hold it by two xor shuffles), then O += P V as 4 RS
//   wgmma m64nDk16, P packed to bf16 from S's accumulators and V MN-major;
//   O stays in registers (D / 2 floats a thread), and a warpgroup releases
//   the key tiles past its causal diagonal unread. Shared memory at D =
//   256: Q 64 KB, 2 x (K 32 + V 32) KB: 192 KB and its barriers, one block
//   an SM; at every D the same tiles.
//
// dQ (flash_bf16_dq_kernel): a block owns 64 query rows of one (batch,
//   head); the producer's warp 0 loads Q and dO once and keeps a ring of 3
//   K tiles of 64 keys full, its warp 1 a ring of 1 V tile, from key tile
//   0 to the last under the causal diagonal. Per key tile consumer 0 runs
//   S = Q K^T (SS, both K-major), forms p = 2^(s scale log2(e) - lse
//   log2(e)) under the masks and hands p (float32) to consumer 1 through
//   shared memory on a named barrier; consumer 1 runs dP = dO V^T (SS),
//   forms dS = p (dP - delta) scale in float32, rounds it to bf16 and
//   writes it once into a [64][64] tile in the 128-byte swizzle (K-major,
//   one box), then a proxy fence and a named barrier. Each consumer then
//   adds dS K[:, its half of D] into its half of dQ (D / 4 floats a
//   thread) as 4 wgmma m64n(D/2)k16 with K MN-major: consumer 0 reads dS
//   from the tile (SS), consumer 1 from its registers (RS). Consumer 0
//   starts S of the next tile before it waits for dS of this one, consumer
//   1 dP of the next tile before its dS K; a K tile is released once both
//   halves of dS K are done, the V tile once dP is, and the dS tile is
//   rewritten once consumer 0's dS K is done (named barriers). K is read
//   a tile apart (by S, then by dS K), so its ring is the deeper: 3 and 1
//   ran 8% faster than 2 and 2 in the same shared memory (H100, B 8, S
//   1024, H 8, D 256). Shared memory at D = 256: Q and dO 64 KB, 3 x K 32
//   KB, V 32 KB, p 16 KB, dS 8 KB: 216 KB and its barriers, one block an
//   SM. It streams 64 KB of K and V a tile from L2 (the forward, with 128
//   query rows a block, half of that a row): the ablations of
//   scripts/torch_flash_bf16_probe.py point there (its heads ungrouped,
//   20% slower; without dS K 6% faster, without p's exchange 2%).
//
// dK/dV (flash_bf16_dkv_kernel): a block owns 64 keys of one (batch, head);
//   the producer's warp 0 loads K and V once and keeps a ring of 2 Q and 2
//   dO tiles of 64 query rows full by TMA, from the first tile that sees
//   the block's keys under causal masking to the last, and its warp 1
//   copies each tile's lse and delta beside them (the tile's full barriers
//   count its 32 lanes and the TMA bytes); the two consumers work over the
//   block's 64 keys, each accumulating all D columns of one output (D / 2
//   floats a thread). Per query tile consumer 0 runs S^T = K Q^T (SS, both
//   K-major), forms p^T = exp(s scale - lse) under the masks, hands p^T
//   (float32) to consumer 1 through shared memory on a named barrier, and
//   adds P^T dO into dV (RS: P^T packed to bf16 from its accumulators, dO
//   MN-major); consumer 1 runs dP^T = V dO^T (SS), forms dS^T = p^T (dP^T -
//   delta) scale in float32, and adds dS^T Q into dK (RS: dS^T packed to
//   bf16, Q MN-major). Shared memory at D = 256: K and V 64 KB, 2 x (Q 32 +
//   dO 32) KB, p^T 16 KB, lse and delta 1 KB: 209 KB and its barriers, one
//   block an SM.
//
// Registers (nvcc -Xptxas -v, sm_90a): every kernel at every D has those
// of the launch bound (168: 384 threads, one block an SM), which
// setmaxnreg moves to 24 (producer) and 240 (consumers).
#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "sm90.cuh"

namespace {

typedef uint16_t bf16;  // the bits of one bfloat16

// ---- conversions, shuffles and exponentials --------------------------------
// lo and hi rounded to bf16 (to nearest, ties to even), lo in the low half.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
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

// ---------------------------------------------------------------------------
// the warp-specialised blocks
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
  const uint32_t base = sm90::aligned_base(smem4);
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
// dQ
// ---------------------------------------------------------------------------

constexpr int kDqBQ = 64;  // query rows a block
constexpr int kDqBK = 64;  // keys a tile
constexpr int kDqKStages = 3;  // tiles in the K ring
constexpr int kDqVStages = 1;  // tiles in the V ring
// named barriers of the two consumers: p is in shared memory; it has been
// read; dS is in shared memory; consumer 0's dS K has read it
constexpr int kDqPReady = 1;
constexpr int kDqPFree = 2;
constexpr int kDqSReady = 3;
constexpr int kDqSFree = 4;

// Shared memory, byte offsets from the aligned base: Q, dO, the rings of K
// and V tiles, p (float32, [8 n8 tiles][128 threads][4 accumulators]), dS
// (bf16, one [64][64] box), the barriers.
template <int D>
struct DqSmem {
  static constexpr uint32_t kTile = tile_bytes<D>();
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kDo = kTile;
  static constexpr uint32_t kK = 2 * kTile;
  static constexpr uint32_t kV = kK + kDqKStages * kTile;
  static constexpr uint32_t kP = kV + kDqVStages * kTile;
  static constexpr uint32_t kS = kP + 32 * 128 * sizeof(float);
  // full_qdo, then full and empty of each K stage, then of each V stage
  static constexpr uint32_t kBar = kS + sm90::kBoxBytes;
  static constexpr size_t kBytes =
      kBar + 8 * (1 + 2 * (kDqKStages + kDqVStages)) + 1024;
  // the byte offset of column D / 2 (consumer 1's half of dQ) in a tile:
  // whole boxes, or half a box's row at D = 64
  static constexpr uint32_t kHalf =
      D / 2 >= 64 ? D / 2 / 64 * sm90::kBoxBytes : D / 2 * sizeof(bf16);
};

// Start dQ[:, half] += dS K[:, half] (K MN-major) as one group: dS from
// its tile (SS) or, given its A fragments, from registers (RS).
template <int D>
__device__ __forceinline__ void start_dsk(float (&acc)[D / 4], uint32_t sS,
                                          uint32_t sKh) {
  sm90::fence_operands(acc);
  sm90::wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sm90::wgmma_ss<D / 2, 1>(acc, sm90::desc_k(sS, kk),
                             sm90::desc_mn(sKh, kk), 1);
  sm90::wg_commit();
  sm90::fence_operands(acc);
}
template <int D>
__device__ __forceinline__ void start_dsk(float (&acc)[D / 4],
                                          uint32_t (&da)[4][4], uint32_t sKh) {
  sm90::fence_operands(acc);
  sm90::wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sm90::wgmma_rs<D / 2, 1>(acc, da[kk], sm90::desc_mn(sKh, kk), 1);
  sm90::wg_commit();
  sm90::fence_operands(acc);
}

// p = 2^(s scale log2(e) - lse log2(e)) over one key tile of S (the
// thread's 32 accumulators; its rows' lse log2(e) in l2, +inf past sq,
// which gives p = 0; its keys k0 + 8 j + 2 t + {0, 1}); MASK when a key of
// the tile is past sk (p = 0) or past a row's diagonal (kMaskValue).
template <bool MASK>
__device__ __forceinline__ void dq_probs(float (&sc)[32], const float (&l2)[2],
                                         int qpos, int k0, int t, int sk,
                                         int causal, float scale2) {
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
      sc[4 * j + e] = ex2(x - l2[e >> 1]);
    }
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bf16_dq_kernel(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const __grid_constant__ CUtensorMap tdo,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, int H, int sq, int sk, float scale,
          int causal, GridOrder order) {
  using L = DqSmem<D>;
  constexpr int NA = D / 4;  // dQ's accumulators a thread: half of D
  extern __shared__ float4 smem4[];
  const uint32_t base = sm90::aligned_base(smem4);
  char* const base_ptr = reinterpret_cast<char*>(smem4) +
                         (base - sm90::smem_u32(smem4));
  float4* const sP = reinterpret_cast<float4*>(base_ptr + L::kP);
  const uint32_t full_qdo = base + L::kBar;
  // the rings: tile kt of K in stage kt % kDqKStages, of V kt % kDqVStages
  const auto full_k = [&](int kt) {
    return full_qdo + 8 * (1 + kt % kDqKStages);
  };
  const auto empty_k = [&](int kt) { return full_k(kt) + 8 * kDqKStages; };
  const auto full_v = [&](int kt) {
    return full_qdo + 8 * (1 + 2 * kDqKStages + kt % kDqVStages);
  };
  const auto empty_v = [&](int kt) { return full_v(kt) + 8 * kDqVStages; };
  const auto phase_k = [&](int kt) {
    return (uint32_t)(kt / kDqKStages) & 1;
  };
  const auto phase_v = [&](int kt) {
    return (uint32_t)(kt / kDqVStages) & 1;
  };

  int bh, level;
  order.at(blockIdx.x, bh, level);
  const int b = bh / H;
  const int hd = bh - b * H;
  // level 0 is the last query tile, the heaviest
  const int q0 = (order.levels - 1 - level) * kDqBQ;
  const int q_off = sk - sq;
  // causal needs sq <= sk, so every block sees at least one key tile
  const int n_tiles = causal
                          ? min(sk - 1, q0 + kDqBQ - 1 + q_off) / kDqBK + 1
                          : (sk + kDqBK - 1) / kDqBK;
  if (threadIdx.x == 0) {
    sm90::bar_init(full_qdo, 1);
    for (int s = 0; s < kDqKStages; ++s) {
      sm90::bar_init(full_k(s), 1);
      sm90::bar_init(empty_k(s), 8);  // each consumer warp once
    }
    for (int s = 0; s < kDqVStages; ++s) {
      sm90::bar_init(full_v(s), 1);
      sm90::bar_init(empty_v(s), 4);  // consumer 1's warps
    }
    sm90::bar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  if (wg == 0) {
    // the producer: warp 0's first lane loads Q and dO once and the K
    // ring, warp 1's the V ring (K is released when both halves of dS K
    // are done, V when dP is)
    sm90::regs_dec<kProducerRegs>();
    if (lane == 0 && warp == 0) {
      sm90::bar_expect_tx(full_qdo, 2 * L::kTile);
      load_tile<D>(base + L::kQ, &tq, full_qdo, q0, hd, b);
      load_tile<D>(base + L::kDo, &tdo, full_qdo, q0, hd, b);
      for (int kt = 0; kt < n_tiles; ++kt) {
        sm90::bar_wait(empty_k(kt), phase_k(kt) ^ 1);
        sm90::bar_expect_tx(full_k(kt), L::kTile);
        load_tile<D>(base + L::kK + kt % kDqKStages * L::kTile, &tk,
                     full_k(kt), kt * kDqBK, hd, b);
      }
    } else if (lane == 0 && warp == 1) {
      for (int kt = 0; kt < n_tiles; ++kt) {
        sm90::bar_wait(empty_v(kt), phase_v(kt) ^ 1);
        sm90::bar_expect_tx(full_v(kt), L::kTile);
        load_tile<D>(base + L::kV + kt % kDqVStages * L::kTile, &tv,
                     full_v(kt), kt * kDqBK, hd, b);
      }
    }
    return;
  }

  // the consumers: the block's 64 query rows, warp w their rows 16 w ..
  // 16 w + 15; consumer c accumulates dQ's columns c D / 2 .. c D / 2 +
  // D / 2 - 1
  sm90::regs_inc<kConsumerRegs>();
  const int c = wg - 1;
  const int tid = threadIdx.x & 127;
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = 16 * warp + g;  // the thread's rows q0 + r_lo (+ 8)
  const uint32_t sS = base + L::kS;
  const auto sK = [&](int kt) {
    return base + L::kK + (kt % kDqKStages) * L::kTile;
  };
  const auto sV = [&](int kt) {
    return base + L::kV + (kt % kDqVStages) * L::kTile;
  };
  const auto release = [&](uint32_t mbar) {
    __syncwarp();
    if (lane == 0) sm90::bar_arrive(mbar);
  };
  const uint32_t half = c * L::kHalf;
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  // the rows' lse log2(e) (consumer 0) or delta (consumer 1); a row past
  // sq gets p = 0
  float rv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + r_lo + 8 * hr;
    rv[hr] = row >= sq ? (c == 0 ? INFINITY : 0.f)
                       : (c == 0 ? lse[(long)bh * sq + row] * kLog2e
                                 : delta[(long)bh * sq + row]);
  }
  sm90::bar_wait(full_qdo, 0);

  if (c == 0) {
    // S = Q K^T, p; dS K[:, :D / 2] from the dS tile
    const float scale2 = scale * kLog2e;
    const int qpos = q0 + r_lo + q_off;
    const uint32_t sQ = base + L::kQ;
    float sc[32];  // S, then p
    // p of tile kt into sc and across to consumer 1 (once it has read the
    // last tile's), masked only where a key is past sk or past the
    // diagonal of the block's first row
    const auto probs = [&](int kt) {
      const int k0 = kt * kDqBK;
      if (k0 + kDqBK > sk || (causal && k0 + kDqBK - 1 > q0 + q_off))
        dq_probs<true>(sc, rv, qpos, k0, t, sk, causal, scale2);
      else
        dq_probs<false>(sc, rv, qpos, k0, t, sk, causal, scale2);
      if (kt > 0) sm90::named_sync(kDqPFree, 256);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sP[j * 128 + tid] = make_float4(sc[4 * j], sc[4 * j + 1],
                                        sc[4 * j + 2], sc[4 * j + 3]);
      sm90::named_arrive(kDqPReady, 256);
    };
    sm90::bar_wait(full_k(0), 0);
    start_qk<D>(sc, sQ, sK(0));
    sm90::wg_wait<0>();
    sm90::fence_operands(sc);
    probs(0);
    // S of tile kt + 1 started before dS K of tile kt, so that its p is
    // formed under dS K
    for (int kt = 0; kt + 1 < n_tiles; ++kt) {
      sm90::bar_wait(full_k(kt + 1), phase_k(kt + 1));
      start_qk<D>(sc, sQ, sK(kt + 1));
      sm90::named_sync(kDqSReady, 256);
      start_dsk<D>(acc, sS, sK(kt));
      sm90::wg_wait<1>();  // S of tile kt + 1
      sm90::fence_operands(sc);
      probs(kt + 1);
      sm90::wg_wait<0>();  // dS K of tile kt
      sm90::fence_operands(acc);
      sm90::named_arrive(kDqSFree, 256);
      release(empty_k(kt));
    }
    const int last = n_tiles - 1;
    sm90::named_sync(kDqSReady, 256);
    start_dsk<D>(acc, sS, sK(last));
    sm90::wg_wait<0>();
    sm90::fence_operands(acc);
    release(empty_k(last));
  } else {
    // dP = dO V^T, dS; dS K[:, D / 2:] from registers
    const uint32_t sDo = base + L::kDo;
    char* const sS_ptr = base_ptr + L::kS;
    float dp[32];        // dP, then dS
    uint32_t da[4][4];   // dS, bf16, as dS K's A
    // dS of a tile from dP in dp and p across from consumer 0; the last
    // tile's p is not followed by another
    const auto grads = [&](bool more) {
      sm90::named_sync(kDqPReady, 256);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 p = sP[j * 128 + tid];
        const float pe[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] = pe[e] * (dp[4 * j + e] - rv[e >> 1]) * scale;
      }
      if (more) sm90::named_arrive(kDqPFree, 256);
    };
    // dS rounded to bf16 as A fragments and into the dS tile (K-major,
    // the 128-byte swizzle: row r's chunk j at chunk j ^ (r % 8)), once
    // consumer 0's dS K has read the last tile's
    const auto hand_over = [&](int kt) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pack_a(da[kk], dp, kk);
      if (kt > 0) sm90::named_sync(kDqSFree, 256);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = r_lo + 8 * (r & 1), chunk = 2 * kk + (r >> 1);
          *reinterpret_cast<uint32_t*>(sS_ptr + row * 128 +
                                       ((chunk ^ (row & 7)) << 4) + 4 * t) =
              da[kk][r];
        }
      sm90::fence_proxy_async();
      sm90::named_arrive(kDqSReady, 256);
    };
    const auto start_dp = [&](int kt) {
      sm90::wg_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        sm90::wgmma_ss_n64<0>(dp, sm90::desc_k(sDo, ks),
                              sm90::desc_k(sV(kt), ks), ks > 0);
      sm90::wg_commit();
    };
    sm90::bar_wait(full_v(0), 0);
    start_dp(0);
    sm90::wg_wait<0>();
    sm90::fence_operands(dp);
    release(empty_v(0));
    grads(n_tiles > 1);
    hand_over(0);
    // dP of tile kt + 1 started before dS K of tile kt, so that its dS is
    // formed under dS K
    for (int kt = 0; kt + 1 < n_tiles; ++kt) {
      sm90::bar_wait(full_v(kt + 1), phase_v(kt + 1));
      start_dp(kt + 1);
      start_dsk<D>(acc, da, sK(kt) + half);
      sm90::wg_wait<1>();  // dP of tile kt + 1
      sm90::fence_operands(dp);
      release(empty_v(kt + 1));
      grads(kt + 2 < n_tiles);
      sm90::wg_wait<0>();  // dS K of tile kt
      sm90::fence_operands(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) sm90::fence_operands(da[kk]);
      release(empty_k(kt));
      hand_over(kt + 1);
    }
    const int last = n_tiles - 1;
    start_dsk<D>(acc, da, sK(last) + half);
    sm90::wg_wait<0>();
    sm90::fence_operands(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::fence_operands(da[kk]);
    release(empty_k(last));
  }

  // dQ rounded to bf16, the consumer's half of each row; rows past sq are
  // not written
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + r_lo + 8 * hr;
    if (row >= sq) continue;
    bf16* drow = dq + (((long)b * sq + row) * H + hd) * D + c * (D / 2) + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      *reinterpret_cast<uint32_t*>(drow + 8 * n) =
          pack2(acc[4 * n + 2 * hr], acc[4 * n + 2 * hr + 1]);
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
  const uint32_t base = sm90::aligned_base(smem4);
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
  CUtensorMap tq, tk, tv, tdo;
  int err = sm90::encode_bshd(&tq, q, B, sq, H, D, 64);
  if (!err) err = sm90::encode_bshd(&tk, k, B, sk, H, D, 64);
  if (!err) err = sm90::encode_bshd(&tv, v, B, sk, H, D, 64);
  if (!err) err = sm90::encode_bshd(&tdo, dout, B, sq, H, D, 64);
  if (!err) err = set_smem(flash_bf16_dq_kernel<D>, DqSmem<D>::kBytes);
  if (err) return err;
  const GridOrder order = grid_order(B * H, (sq + kDqBQ - 1) / kDqBQ,
                                     4l * sk * D);
  flash_bf16_dq_kernel<D><<<B * H * order.levels, kWsThreads,
                            DqSmem<D>::kBytes, stream>>>(
      tq, tk, tv, tdo, lse, delta, dq, H, sq, sk, scale, causal, order);
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
