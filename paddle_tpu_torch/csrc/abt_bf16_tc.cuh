// The bf16 backward's split products A·Bᵀ over K = N·S on Hopper's
// warpgroup products, fed by TMA (csrc/sm90.cuh): bwd_reduce3_bf16's P =
// Σ g3 h2ᵀ and Σg3 (reduce3_bf16_kernel<BN, kReduce3>), bwd_final_bf16's
// dW1 = Σ da1 xᵀ (reduce3_bf16_kernel<BN, kDW1>: the same product of raw
// operands), and bwd_mid_bf16's nine tap gradients dtaps[t] = Σ da2 h1ᵀ at
// tap t's shift (taps_bf16_kernel).
// Included by csrc/fused_block_bf16.cu, whose conversions (bf, to_bf,
// norm_bf, pack), ldmatrix (ldsm_x4) and fixed-order passes
// (fused_block.cuh) they use.
//
// Replaces, in bf16, the product of paddle_tpu/kernels/fused_block.py's
// _b1a_kernel (:160, pallas_call :192), the tap gradients of its
// _b2_kernel (:295, pallas_call :399; the JAX kernel's nine products of
// column-shifted da2 and row-shifted h1 at :345-369) and the dW1 of its
// _b3_kernel (:436, pallas_call :466). The earlier design
// (ab::abt_bf16_kernel) ran one tap a block, read da2 and a1 nine times
// with two-byte loads, in 32-position stages of mma.sync through two
// buffers.
//
// What bounds them on the H100 (ResNet-50's chain stages, batch 128):
// reduce3 reads dout, out and a2 and writes g3, 668 / 334 / 168 MB at 56²
// / 28² / 14² (0.1994 / 0.0998 / 0.0502 ms at 3.35 TB/s; its 13.2 GFLOP
// are 0.0133 ms): bytes. dW1 reads x and da1, 257 / 128 / 64 MB (0.0767 /
// 0.0383 / 0.0192 ms) for the same 13.2 GFLOP: bytes. The tap gradients read da2 and a1 once, 102.8 /
// 51.4 / 25.7 MB (0.0307 / 0.0153 / 0.0077 ms), for 29.6 GFLOP (0.0299
// ms at 989 TFLOP/s): bytes by a hair at 56², operations at 28² and 14².
//
// The layout. An operand [N, R, S] (R channels, S positions of an image)
// is read in 64-position stages of one image: a TMA box row is 64 values,
// 128 bytes, written with the 128-byte swizzle, so each stage is one
// K-major tile that wgmma reads by descriptor (desc_k). Stages do not
// cross images: positions past S read 0 or are masked, so S = 196 runs 4
// stages of 64 an image. A tensor map's strides are multiples of 16
// bytes, and a channel row of S = 196 values is 392: so the map views the
// tensor as (k S, R / k, N) with k = 8 / gcd(S, 8) channels a row, and a
// tile of `rows` channels is k boxes, box j holding channels c0 + k i + j
// (smem row j rows / k + i; chan_of maps a row back). R must be a
// multiple of k. Box j's values start at j S + s0, which is off 16 bytes
// for j >= 1 where S % 8 != 0, and the card never completes such a box
// (the mbarrier wait traps): so box j starts skew_of(j) = (j S) % 8
// positions early, and an 8-position box (dense, 16 bytes a row) brings
// the positions past its end into the stage's tail. Where a
// transform reads the tile it gathers each row back by its skew (gather8);
// the tap pass's da2, which wgmma reads as it lands, is moved back in
// place by warps 1-3 first. Past S a box row runs into the next channel
// of its group, which the transforms and the tap pass's masks drop; past
// the last one the map reads zeros.
//
// Both kernels are warp-specialised, one block an SM (its shared memory):
// warp 0's lane 0 keeps the rings full by TMA on full / empty mbarriers;
// each split of N·S's stages runs in one block, its float32 partial
// written to part[split] and the splits added in a fixed order
// (finish_splits): no float atomics, two calls the same bits. The splits
// are sized so that one wave of blocks fills the SMs (a block per SM).
//
// reduce3_bf16_kernel<BN>: a block owns 128 rows of Cin (two consumer
//   warpgroups of 64) by BN channels of C (64, 128 or 256: all of C at
//   ResNet-50's widths, so g3 is made and written by one block) and a
//   split of stages. A stage brings dout, out (128 rows) and a2 (BN rows)
//   into a ring of 4 stages (3 at BN 256); the consumers make g3 = dout
//   where out > 0 in place over dout (exact, 0 past S) and write it out,
//   and h2 = bf16(relu(fma(a2, sc2, sh2))) in place over a2 (0 past S and
//   past C), each once a stage (a row's 8 chunks are 8 lanes of a warp,
//   which read before any writes); then a proxy fence, a named barrier
//   over both warpgroups, and four m64nBNk16 wgmma (both operands K-major)
//   into BN / 2 float32 accumulators a thread. g3 goes out 16 bytes a lane
//   where S % 8 == 0, else read back from the tile in runs of 8 bytes a
//   lane where S % 4 == 0 (whole 32-byte sectors a store, not a 2-byte
//   write per lane into each), else value by value. Σg3: a thread's 8
//   positions of a row a stage, in order, onto its run (in registers, at
//   BN 256 in shared memory), then a row's 8 runs in order. Where Cin has
//   several row tiles (8 at 14²), a2 is read once a row tile: the grid
//   runs a split's row tiles side by side (blockIdx.x fastest), so that
//   the reuse comes from L2. In the kDW1 mode A is x (Cin rows) and B
//   da1 (C rows), both raw: a stage brings x and da1 alone, and where S %
//   8 != 0 the rows of skewed boxes are moved back in place (0 past S);
//   where S % 8 == 0 wgmma reads them as they land. Its partial is written
//   as dW1 [C][Cin]; there is no g3 and no Σg3.
//
// taps_bf16_kernel: a block owns a 64 x 64 tile of (h1 channel, da2
//   channel) for all nine taps and a split of stages. The factoring is the
//   3x3 kernel's halo (c3::conv3x3_bf16_kernel), not the JAX kernel's
//   shifted copies: tap (dy, dx) pairs da2 at position p with h1 at p + dy
//   W + dx, so h1 is the shifted operand, made once and read at nine
//   offsets. The producer brings h1's tiles from c = (W + 64) / 64 stages
//   before the split to c after it (the halo of a row of W), each once,
//   into a ring of 6, and each stage's da2 tile (wgmma's B) into a ring of
//   6, window q + 2 c beside stage q, so that both run as far ahead of
//   the consumers (issuing da2's stage beside the window it centres left
//   h1 only 3 - c windows ahead). Warps 1-3 normalise each h1 tile once
//   (norm_bf, 0 past S) into a ring of 8 position-major tiles ([position]
//   [64 channels], 128 bytes a row, chunk r ^ (position % 8)): transposed
//   so that a shift is a row offset. Three consumer warpgroups own dy =
//   -1, 0, 1, three taps each
//   (96 float32 accumulators a thread); per tap and k16 step each warp
//   gathers its A (16 channels x 16 positions, the RS form's fragments)
//   by ldmatrix.trans, a row address a lane, at position p + dy W + dx,
//   with rows that are off the image, past S, or across a row's edge
//   (dx = -1 at column 0, dx = 1 at column W - 1) pointed at a zero row:
//   the masks cost no arithmetic on the data. Two wgmma k16 steps a group,
//   two groups' fragments in flight. W at most 191 (c <= 3: a window of 7
//   normalised tiles and the next).
//
// Registers (ptxas -v, sm_90a): both kernels have those of their launch
// bounds (taps 128: 512 threads; reduce3 168: 384), moved by setmaxnreg
// to 80 / 144 (taps) and 40 / 232 (reduce3).
#pragma once

namespace abw {

constexpr int kPos = 64;                // positions a stage: one box row
constexpr uint32_t kTile = 64 * 128;    // bytes of a 64-row tile
constexpr int kMaxSplits = 1024;        // splits of N·S's stages

// Channels a row of the operands' tensor maps: 8 / gcd(S, 8).
__host__ __device__ inline int group_of(int S) {
  const int g = S & -S;
  return g >= 8 ? 1 : 8 / g;
}
__host__ __device__ inline int log2_of(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}
// The channel (from the tile's first) that smem row r of a tile of
// `rows` channels holds: box j = r / (rows / k), row i = r % (rows / k),
// channel k i + j; lk = log2(k), lp = log2(rows / k).
__device__ __forceinline__ int chan_of(int r, int lk, int lp) {
  return ((r & ((1 << lp) - 1)) << lk) | (r >> lp);
}

// An mbarrier wait that traps instead of hanging the card: a phase that
// has not ended after 2^26 polls (seconds) is a fault of the pipeline.
__device__ __forceinline__ void wait(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0; !sm90::bar_try_wait(bar, parity); ++polls)
    if (polls == (1u << 26)) __trap();
}

// Stage x of N·S (image x / cpi, positions 64 (x % cpi) ..): n and s0;
// x < 0 or past the last image gives an n outside [0, N), whose boxes the
// map fills with zeros.
__device__ __forceinline__ void stage_of(int x, int cpi, int& n, int& s0) {
  n = x >= 0 ? x / cpi : -((cpi - 1 - x) / cpi);
  s0 = (x - n * cpi) * kPos;
}

// A tile of `rows` channels: its rows x 128 bytes in the 128-byte swizzle
// and its tail, rows x 16 bytes (the 8 values past a box row, of the
// boxes whose row starts off 16 bytes).
__host__ __device__ constexpr uint32_t tile_bytes(int rows) {
  return rows * 128u;
}
__host__ __device__ constexpr uint32_t tail_bytes(int rows) {
  return rows * 16u;
}
// Box j's offset: channel row j S of its group starts (j S) % 8 values off
// 16 bytes, so its box starts that many positions early.
__device__ __forceinline__ int skew_of(int j, int S) { return (j * S) & 7; }

// The `rows` channels c0 .. of stage (n, s0) into the tile at dst (k boxes
// of rows / k rows, box j from position s0 - skew_of(j)) and, for j >= 1
// where S % 8 != 0, the 8 positions past each box into the tail at tdst
// (map: 64-wide boxes, 128-byte swizzle; tmap: 8-wide, dense); their bytes
// complete on bar: tile_bytes(rows) + (k - 1) tail_bytes(rows / k).
__device__ __forceinline__ void load_rows(uint32_t dst, uint32_t tdst,
                                          const CUtensorMap* map,
                                          const CUtensorMap* tmap,
                                          uint32_t bar, int n, int s0, int c0,
                                          int rows, int k, int S) {
  const int per = rows / k;
  for (int j = 0; j < k; ++j) {
    const int x = j * S + s0 - skew_of(j, S);
    sm90::tma_load_4d(dst + j * per * 128, map, bar, x, c0 / k, n, 0);
    if (j > 0)
      sm90::tma_load_4d(tdst + j * tail_bytes(per), tmap, bar, x + kPos,
                        c0 / k, n, 0);
  }
}
__host__ __device__ constexpr uint32_t stage_bytes(int rows, int k) {
  return tile_bytes(rows) + (k - 1) * tail_bytes(rows / k);
}

// 8 bf16 of a 16-byte chunk, and back.
__device__ __forceinline__ void unpack8(const uint4& v, bf16 (&h)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 8; ++e)
    h[e] = (bf16)((e & 1) ? w[e >> 1] >> 16 : w[e >> 1] & 0xffffu);
}
__device__ __forceinline__ uint4 pack8(const bf16 (&h)[8]) {
  return make_uint4(pack(h[0], h[1]), pack(h[2], h[3]), pack(h[4], h[5]),
                    pack(h[6], h[7]));
}

// The address of value x (0 .. 71) of row r of a swizzled tile: x < 64
// in the row's 128 bytes, else in the row's 16-byte tail.
template <class T>
__device__ __forceinline__ T* value_at(T* tile, T* tail, int r, int x) {
  return x < kPos ? tile + r * 128 + ((((x >> 3) ^ r) & 7) << 4) + (x & 7) * 2
                  : tail + r * 16 + (x - kPos) * 2;
}

// Values x0 .. x0 + 7 of row r of a swizzled tile (x >= 64 from the row's
// tail): one 16-byte load where x0 is whole chunks, else two 8-byte, four
// 4-byte or eight 2-byte loads as x0's alignment allows.
__device__ __forceinline__ void gather8(const char* tile, const char* tail,
                                        int r, int x0, bf16 (&h)[8]) {
  const auto at = [&](int x) { return value_at(tile, tail, r, x); };
  if ((x0 & 7) == 0) {
    unpack8(*reinterpret_cast<const uint4*>(at(x0)), h);
  } else if ((x0 & 3) == 0) {
    const uint2 a = *reinterpret_cast<const uint2*>(at(x0));
    const uint2 b = *reinterpret_cast<const uint2*>(at(x0 + 4));
    unpack8(make_uint4(a.x, a.y, b.x, b.y), h);
  } else if ((x0 & 1) == 0) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = *reinterpret_cast<const uint32_t*>(at(x0 + 2 * i));
    unpack8(make_uint4(w[0], w[1], w[2], w[3]), h);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      h[e] = *reinterpret_cast<const bf16*>(at(x0 + e));
  }
}

// ---------------------------------------------------------------------------
// the nine tap gradients
// ---------------------------------------------------------------------------

constexpr int kTapThreads = 512;     // the producer warpgroup and three consumers
constexpr int kTapProducerRegs = 80;   // the TMA warp and the transforms
constexpr int kTapConsumerRegs = 144;  // 80 + 3 x 144 = 4 x 128
constexpr int kTapRaw = 6;    // h1 tiles as TMA lands them
constexpr int kTapNorm = 8;   // normalised, position-major h1 tiles
constexpr int kTapDa = 6;     // da2 tiles
constexpr int kTapMaxW = 191;  // (W + 64) / 64 <= 3: 2 c + 2 <= kTapNorm

struct TapSmem {
  static constexpr uint32_t kRaw = 0;
  static constexpr uint32_t kNorm = kRaw + kTapRaw * kTile;
  static constexpr uint32_t kDa = kNorm + kTapNorm * kTile;
  static constexpr uint32_t kRawTail = kDa + kTapDa * kTile;
  static constexpr uint32_t kDaTail = kRawTail + kTapRaw * tail_bytes(64);
  static constexpr uint32_t kZero = kDaTail + kTapDa * tail_bytes(64);
  // hfull, hempty [kTapRaw]; nfull, nempty [kTapNorm]; dfull, dready,
  // dempty [kTapDa]
  static constexpr uint32_t kBar = kZero + 128;
  static constexpr size_t kBytes =
      kBar + 8 * (2 * kTapRaw + 2 * kTapNorm + 3 * kTapDa) + 1024;
};

struct TapArgs {
  float* part;          // [splits][9][C][C]: dtaps[t][co][ci]
  const float* sc;      // h1's normalize [C]
  const float* sh;
  int N, C, S, W, cpi, stages, splits, tiles, k, lk;
};

__global__ void __launch_bounds__(kTapThreads, 1)
taps_bf16_kernel(const __grid_constant__ CUtensorMap tda,
                 const __grid_constant__ CUtensorMap th1,
                 const __grid_constant__ CUtensorMap tda_tail,
                 const __grid_constant__ CUtensorMap th1_tail,
                 const TapArgs p) {
  using L = TapSmem;
  extern __shared__ float4 smem4[];
  const uint32_t base = sm90::aligned_base(smem4);
  char* const sp = reinterpret_cast<char*>(smem4) +
                   (base - sm90::smem_u32(smem4));
  const auto hfull = [&](int s) { return base + L::kBar + 8 * s; };
  const auto hempty = [&](int s) { return hfull(kTapRaw + s); };
  const auto nfull = [&](int s) { return hfull(2 * kTapRaw + s); };
  const auto nempty = [&](int s) { return nfull(kTapNorm + s); };
  const auto dfull = [&](int s) { return nfull(2 * kTapNorm + s); };
  const auto dready = [&](int s) { return dfull(kTapDa + s); };
  const auto dempty = [&](int s) { return dfull(2 * kTapDa + s); };
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kTapRaw; ++s) {
      sm90::bar_init(hfull(s), 1);
      sm90::bar_init(hempty(s), 96);  // each transform thread
    }
    for (int s = 0; s < kTapNorm; ++s) {
      sm90::bar_init(nfull(s), 96);
      sm90::bar_init(nempty(s), 12);  // each consumer warp
    }
    for (int s = 0; s < kTapDa; ++s) {
      sm90::bar_init(dfull(s), 1);
      sm90::bar_init(dready(s), 96);
      sm90::bar_init(dempty(s), 12);
    }
    sm90::bar_init_fence();
  }
  if (tid < 32) reinterpret_cast<uint32_t*>(sp + L::kZero)[tid] = 0u;
  __syncthreads();

  const int C = p.C, S = p.S, W = p.W, k = p.k;
  const int lp = 6 - p.lk;  // log2(64 / k)
  const int T = p.tiles, rt = blockIdx.x % T, ct = blockIdx.x / T;
  const int ci0 = 64 * rt, co0 = 64 * ct, split = blockIdx.y;
  const int g0 = (int)((long)split * p.stages / p.splits);
  const int nst = (int)((long)(split + 1) * p.stages / p.splits) - g0;
  const int c = (W + 64) / 64;   // h1's halo in stages, each side
  const int windows = nst + 2 * c;  // h1's stages g0 - c .. g0 + nst + c
  const int wg = tid / 128;
  const uint32_t tile = stage_bytes(64, k);

  if (wg == 0) {
    sm90::regs_dec<kTapProducerRegs>();
    const int warp = tid / 32;
    if (warp == 0) {
      if (lane != 0) return;
      // h1's window r, then da2's stage r - 2 c (the first stage that
      // needs window r): both rings run as far ahead of the consumers
      for (int r = 0; r < windows; ++r) {
        int n, s0;
        const int rs = r % kTapRaw;
        wait(hempty(rs), ((r / kTapRaw) & 1) ^ 1);
        sm90::bar_expect_tx(hfull(rs), tile);
        stage_of(g0 - c + r, p.cpi, n, s0);
        load_rows(base + L::kRaw + rs * kTile,
                  base + L::kRawTail + rs * tail_bytes(64), &th1, &th1_tail,
                  hfull(rs), n, s0, ci0, 64, k, S);
        const int q = r - 2 * c;
        if (q < 0) continue;
        const int ds = q % kTapDa;
        wait(dempty(ds), ((q / kTapDa) & 1) ^ 1);
        sm90::bar_expect_tx(dfull(ds), tile);
        stage_of(g0 + q, p.cpi, n, s0);
        load_rows(base + L::kDa + ds * kTile,
                  base + L::kDaTail + ds * tail_bytes(64), &tda, &tda_tail,
                  dfull(ds), n, s0, co0, 64, k, S);
      }
      return;
    }
    // warps 1-3: h1 = bf16(relu(fma(a1, sc, sh))) of each window, once,
    // rows 2 lane and 2 lane + 1 of the tile (0 past C and past S), into
    // the position-major ring at each value's position (box j's values
    // skew_of(j) early, its tail the last of them); warp tw takes the
    // chunks tw, tw + 3, .. of the rows (the tail chunk 8). Then da2's
    // stage, its rows moved back by their box's skew (S % 8 != 0 only).
    const int tw = warp - 1, r0 = 2 * lane;
    const int ch0 = ci0 + chan_of(r0, p.lk, lp);
    const int ch1 = ci0 + chan_of(r0 + 1, p.lk, lp);
    const float sc0 = ch0 < C ? __ldg(p.sc + ch0) : 0.f;
    const float sh0 = ch0 < C ? __ldg(p.sh + ch0) : 0.f;
    const float sc1 = ch1 < C ? __ldg(p.sc + ch1) : 0.f;
    const float sh1 = ch1 < C ? __ldg(p.sh + ch1) : 0.f;
    const int skew = skew_of(r0 >> lp, S);  // rows r0 and r0 + 1 alike
    const uint32_t col = (uint32_t)(lane >> 2), word = 4u * (lane & 3);
    const int chunks = k > 1 ? 9 : 8;
    for (int r = 0; r < windows; ++r) {
      int n, s0;
      stage_of(g0 - c + r, p.cpi, n, s0);
      const int lim = (n >= 0 && n < p.N) ? min(kPos, S - s0) : 0;
      const int rs = r % kTapRaw, ns = r % kTapNorm;
      wait(hfull(rs), (r / kTapRaw) & 1);
      wait(nempty(ns), ((r / kTapNorm) & 1) ^ 1);
      const char* raw = sp + L::kRaw + rs * kTile;
      const char* rtail = sp + L::kRawTail + rs * tail_bytes(64);
      char* nrm = sp + L::kNorm + ns * kTile;
      for (int pc = tw; pc < chunks; pc += 3) {
        bf16 v0[8], v1[8];
        unpack8(*reinterpret_cast<const uint4*>(
                    pc < 8 ? raw + r0 * 128 + ((pc ^ (r0 & 7)) << 4)
                           : rtail + r0 * 16), v0);
        unpack8(*reinterpret_cast<const uint4*>(
                    pc < 8 ? raw + (r0 + 1) * 128 + ((pc ^ ((r0 + 1) & 7)) << 4)
                           : rtail + (r0 + 1) * 16), v1);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int pos = 8 * pc + e - skew;
          if (pos < 0 || pos >= kPos) continue;
          *reinterpret_cast<uint32_t*>(
              nrm + pos * 128 + ((col ^ (uint32_t)(pos & 7)) << 4) + word) =
              pos < lim ? cvt_bf2(relu_affine(bf(v0[e]), sc0, sh0),
                                  relu_affine(bf(v1[e]), sc1, sh1))
                        : 0u;
        }
      }
      sm90::bar_arrive(hempty(rs));
      sm90::bar_arrive(nfull(ns));
      const int q = r - 2 * c;
      if (q < 0) continue;
      const int ds = q % kTapDa;
      wait(dfull(ds), (q / kTapDa) & 1);
      if (k > 1) {
        // da2's rows of boxes j >= 1 (rows 64 / k ..) moved back by their
        // skew in place: four rows a warp a pass, a lane a chunk, every
        // lane's reads before any write
        char* dt = sp + L::kDa + ds * kTile;
        const char* dtail = sp + L::kDaTail + ds * tail_bytes(64);
        const int cc = lane & 7;
        for (int r4 = (64 >> p.lk) + 4 * tw; r4 < 64; r4 += 12) {
          const int rr = r4 + (lane >> 3);
          bf16 v[8];
          gather8(dt, dtail, rr, 8 * cc + skew_of(rr >> lp, S), v);
          __syncwarp();
          *reinterpret_cast<uint4*>(dt + rr * 128 + ((cc ^ (rr & 7)) << 4)) =
              pack8(v);
        }
        sm90::fence_proxy_async();
      }
      sm90::bar_arrive(dready(ds));
    }
    return;
  }

  // a consumer: dy = wg - 2, taps 3 (dy + 1) + (dx + 1); warp w the A
  // rows (h1 channels) 16 w .. 16 w + 15 of each product
  sm90::regs_inc<kTapConsumerRegs>();
  const int cw = wg - 1, dy = cw - 1;
  const int warp = (tid / 32) & 3, g = lane >> 2, t = lane & 3;
  // this lane's ldmatrix row: matrix mj (channel half cb, k half kb), row
  // rr; its 16-byte chunk of a position row
  const int mj = lane >> 3, rr = lane & 7, cb = mj & 1, kb = mj >> 1;
  const uint32_t chunk = (uint32_t)(2 * warp + cb);
  const bf16* const zero =
      reinterpret_cast<const bf16*>(sp + L::kZero + (chunk << 4));
  const char* const norm = sp + L::kNorm;

  float acc[3][32];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[d][e] = 0.f;
  uint32_t fa[2][2][4];   // two groups' A fragments (two k16 steps each)
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) fa[b][s][e] = 0u;
  int ready = -1;  // h1 windows waited for
  for (int q = 0; q < nst; ++q) {
    int n, s0;
    stage_of(g0 + q, p.cpi, n, s0);
    const int i = s0 / kPos;
    while (ready < q + 2 * c) {
      ++ready;
      wait(nfull(ready % kTapNorm), (ready / kTapNorm) & 1);
    }
    const int ds = q % kTapDa;
    wait(dready(ds), (q / kTapDa) & 1);
    const uint32_t dtile = base + L::kDa + ds * kTile;
    // the lane's unshifted position at k16 step ks: pp + 16 ks, its column
    const int pp = s0 + 8 * kb + rr;
    int xc[4];
    xc[0] = pp % W;
#pragma unroll
    for (int ks = 1; ks < 4; ++ks) {
      int v = xc[ks - 1] + 16;
      while (v >= W) v -= W;
      xc[ks] = v;
    }
    // the lane's A row for (ks, dx): h1 at position pp + 16 ks + dy W + dx
    // of the image, or the zero row
    const auto a_row = [&](int ks, int dx) -> const bf16* {
      const int at = pp + 16 * ks, P = at + dy * W + dx;
      const bool ok = at < S && P >= 0 && P < S &&
                      !(dx < 0 && xc[ks] == 0) && !(dx > 0 && xc[ks] == W - 1);
      if (!ok) return zero;
      const int win = (q + c + (P >> 6) - i) & (kTapNorm - 1);
      return reinterpret_cast<const bf16*>(
          norm + win * kTile + (P & 63) * 128 +
          ((chunk ^ (uint32_t)(P & 7)) << 4));
    };
    // six groups (three taps, two k16 steps each), fragments in two
    // buffers: a buffer is reloaded once the group two back has retired
#pragma unroll
    for (int hh = 0; hh < 6; ++hh) {
      const int dxi = hh >> 1, ks = 2 * (hh & 1);
      uint32_t(&a)[2][4] = fa[hh & 1];
      sm90::wg_wait<1>();
      sm90::fence_operands(a[0]);
      sm90::fence_operands(a[1]);
      if (hh == 1 && q > 0) {
        // the last group of stage q - 1 has retired: its da2 tile is free
        __syncwarp();
        if (lane == 0) sm90::bar_arrive(dempty((q - 1) % kTapDa));
      }
      ldsm_x4<true>(a[0], a_row(ks, dxi - 1));
      ldsm_x4<true>(a[1], a_row(ks + 1, dxi - 1));
      sm90::fence_operands(acc[dxi]);
      sm90::wg_fence();
      sm90::wgmma_rs<64, 0>(acc[dxi], a[0], sm90::desc_k(dtile, ks), 1);
      sm90::wgmma_rs<64, 0>(acc[dxi], a[1], sm90::desc_k(dtile, ks + 1), 1);
      sm90::wg_commit();
    }
    // window q (stage g0 + q - c) has been read for the last time
    __syncwarp();
    if (lane == 0) sm90::bar_arrive(nempty(q % kTapNorm));
  }
  sm90::wg_wait<0>();
#pragma unroll
  for (int d = 0; d < 3; ++d) sm90::fence_operands(acc[d]);
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int s = 0; s < 2; ++s) sm90::fence_operands(fa[b][s]);

  // dtaps[t][co][ci] of the split: A's rows are h1 channels (ci), B's da2
  // channels (co), both in the tiles' row order
  float* const part = p.part + (long)split * 9 * C * C;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int ci = ci0 + chan_of(16 * warp + g + 8 * hr, p.lk, lp);
    if (ci >= C) continue;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = co0 + chan_of(8 * jj + 2 * t + e, p.lk, lp);
        if (co >= C) continue;
#pragma unroll
        for (int d = 0; d < 3; ++d)
          part[((long)(3 * cw + d) * C + co) * C + ci] =
              acc[d][4 * jj + 2 * hr + e];
      }
  }
}

// ---------------------------------------------------------------------------
// bwd_reduce3: P = Σ g3 h2ᵀ, Σg3, g3
// ---------------------------------------------------------------------------

constexpr int kR3Threads = 384;    // the producer warpgroup and two consumers
constexpr int kR3ProducerRegs = 40;
constexpr int kR3ConsumerRegs = 232;  // 40 + 2 x 232 <= 3 x 168
constexpr int kR3Rows = 128;       // rows of Cin a block
// the split products of reduce3_bf16_kernel: P, Σg3 and g3 (bwd_reduce3),
// or dW1 of raw operands (bwd_final)
enum { kReduce3 = 0, kDW1 = 1 };

template <int BN>
struct R3Smem {
  static constexpr int kStages = BN == 256 ? 3 : 4;
  static constexpr uint32_t kA = tile_bytes(kR3Rows);   // dout's or out's tile
  static constexpr uint32_t kB = tile_bytes(BN);        // a2's
  static constexpr uint32_t kTailA = tail_bytes(kR3Rows);
  // a stage: dout, out, a2, then their tails
  static constexpr uint32_t kStage = 2 * kA + kB + 2 * kTailA + tail_bytes(BN);
  static constexpr uint32_t kVec = kStages * kStage;  // sc2, sh2 of B's rows
  static constexpr uint32_t kRed = kVec + 2 * BN * 4;  // Σg3 [128][8]
  static constexpr uint32_t kBar = kRed + kR3Rows * 8 * 4;  // full, empty
  static constexpr size_t kBytes = kBar + 8 * 2 * kStages + 1024;
};

struct R3Args {
  bf16* g3;             // [N, Cin, S] (kReduce3)
  float* part;          // [splits][Cin][C + 1]: P, then Σg3 in column C;
                        // kDW1 [splits][C][Cin]
  const float* sc;      // h2's normalize [C] (kReduce3)
  const float* sh;
  int Cin, C, S, cpi, stages, splits, rtiles, k, lk;
};

template <int BN, int kMode>
__global__ void __launch_bounds__(kR3Threads, 1)
reduce3_bf16_kernel(const __grid_constant__ CUtensorMap tdout,
                    const __grid_constant__ CUtensorMap tout,
                    const __grid_constant__ CUtensorMap ta2,
                    const __grid_constant__ CUtensorMap tdout_tail,
                    const __grid_constant__ CUtensorMap tout_tail,
                    const __grid_constant__ CUtensorMap ta2_tail,
                    const R3Args p) {
  using L = R3Smem<BN>;
  constexpr int NS = L::kStages;
  constexpr int HT = BN / 32;   // a thread's h2 chunks a stage
  // the transform's loops unrolled and Σg3's runs in registers where the
  // registers allow; at BN 256 the accumulators take 128 a thread, and
  // unrolled loops spill, so the runs live in shared memory there
  constexpr bool kRunsInSmem = BN == 256;
  constexpr int kUnrollG = kRunsInSmem ? 1 : 4;
  constexpr int kUnrollH = kRunsInSmem ? 1 : HT;
  extern __shared__ float4 smem4[];
  const uint32_t base = sm90::aligned_base(smem4);
  char* const sp = reinterpret_cast<char*>(smem4) +
                   (base - sm90::smem_u32(smem4));
  const auto full = [&](int s) { return base + L::kBar + 8 * s; };
  const auto empty = [&](int s) { return full(NS + s); };
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      sm90::bar_init(full(s), 1);
      sm90::bar_init(empty(s), 8);  // each consumer warp
    }
    sm90::bar_init_fence();
  }
  __syncthreads();

  const int Cin = p.Cin, C = p.C, S = p.S, k = p.k;
  const int rt = blockIdx.x % p.rtiles, ct = blockIdx.x / p.rtiles;
  const int cin0 = kR3Rows * rt, c0 = BN * ct, split = blockIdx.y;
  const int g0 = (int)((long)split * p.stages / p.splits);
  const int nst = (int)((long)(split + 1) * p.stages / p.splits) - g0;
  const int wg = tid / 128;
  // offsets in a stage
  constexpr uint32_t kOut = L::kA, kA2 = 2 * L::kA, kTd = 2 * L::kA + L::kB;
  constexpr uint32_t kTo = kTd + L::kTailA, kTa = kTo + L::kTailA;

  if (wg == 0) {
    sm90::regs_dec<kR3ProducerRegs>();
    if (tid != 0) return;
    const uint32_t bytes = (kMode == kDW1 ? 1 : 2) * stage_bytes(kR3Rows, k) +
                           stage_bytes(BN, k);
    for (int q = 0; q < nst; ++q) {
      const int s = q % NS;
      int n, s0;
      stage_of(g0 + q, p.cpi, n, s0);
      wait(empty(s), ((q / NS) & 1) ^ 1);
      sm90::bar_expect_tx(full(s), bytes);
      const uint32_t st = base + s * L::kStage;
      load_rows(st, st + kTd, &tdout, &tdout_tail, full(s), n, s0, cin0,
                kR3Rows, k, S);
      if (kMode == kReduce3)
        load_rows(st + kOut, st + kTo, &tout, &tout_tail, full(s), n, s0,
                  cin0, kR3Rows, k, S);
      load_rows(st + kA2, st + kTa, &ta2, &ta2_tail, full(s), n, s0, c0, BN,
                k, S);
    }
    return;
  }

  // the consumers: warpgroup cw the A rows (Cin) 64 cw .. 64 cw + 63, and
  // half of B's rows to normalise
  sm90::regs_inc<kR3ConsumerRegs>();
  const int u = tid - 128, cw = u >> 7, uw = u & 127;
  const int warp = (tid / 32) & 3, g = lane >> 2, t = lane & 3;
  const int la = 7 - p.lk, lb = log2_of(BN) - p.lk;  // log2 of box rows
  const bool first = kMode == kReduce3 && ct == 0;  // writes g3 and Σg3
  float* const vec = reinterpret_cast<float*>(sp + L::kVec);
  for (int r = u; kMode == kReduce3 && r < BN; r += 256) {
    const int ch = c0 + chan_of(r, p.lk, lb);
    vec[r] = ch < C ? __ldg(p.sc + ch) : 0.f;   // h2 0 past C
    vec[BN + r] = ch < C ? __ldg(p.sh + ch) : 0.f;
  }
  sm90::named_sync(1, 256);

  // this thread's g3 rows (64 cw + uw / 8 + 16 it) and h2 rows (BN / 2 cw
  // + uw / 8 + 16 it), at chunk uw % 8; rows of box j >= 1 start their
  // box's skew late (S % 8 != 0), so their values are gathered back: a
  // row's 8 chunks are 8 lanes of one warp, which read before any writes
  const int cc = uw & 7;
  // Σg3: the thread's run of each of its 4 rows, in gsum or in red[row][cc]
  float* const red = reinterpret_cast<float*>(sp + L::kRed);
  float gsum[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (kRunsInSmem) {
#pragma unroll
    for (int it = 0; it < 4; ++it)
      red[(64 * cw + (uw >> 3) + 16 * it) * 8 + cc] = 0.f;
  }
  float acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
  for (int q = 0; q < nst; ++q) {
    const int s = q % NS;
    int n, s0;
    stage_of(g0 + q, p.cpi, n, s0);
    const int lim = min(kPos, S - s0);
    wait(full(s), (q / NS) & 1);
    char* const st = sp + s * L::kStage;
    if (kMode == kDW1) {
      // x's and da1's rows of skewed boxes moved back in place, 0 past S
      // (where S % 8 == 0 past S is past the map: TMA reads zeros)
      if (k > 1) {
#pragma unroll 1
        for (int it = 0; it < 4 + HT; ++it) {
          const bool ra = it < 4;
          const int r = ra ? 64 * cw + (uw >> 3) + 16 * it
                           : cw * (BN / 2) + (uw >> 3) + 16 * (it - 4);
          const uint32_t off = ra ? 0u : kA2, toff = ra ? kTd : kTa;
          bf16 v[8];
          gather8(st + off, st + toff, r,
                  8 * cc + skew_of(r >> (ra ? la : lb), S), v);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (8 * cc + e >= lim) v[e] = 0;
          __syncwarp();
          *reinterpret_cast<uint4*>(st + off + r * 128 +
                                    ((cc ^ (r & 7)) << 4)) = pack8(v);
        }
        sm90::fence_proxy_async();
        sm90::named_sync(1, 256);  // both operands are in place
      }
    } else {
      // g3 = dout where out > 0 (0 past S), in place over dout, written out
      // and summed
#pragma unroll kUnrollG
      for (int it = 0; it < 4; ++it) {
        const int m = 64 * cw + (uw >> 3) + 16 * it;
        const int sk = skew_of(m >> la, S);
        bf16 d[8], o[8];
        gather8(st, st + kTd, m, 8 * cc + sk, d);
        gather8(st + kOut, st + kTo, m, 8 * cc + sk, o);
        float run;
        if constexpr (kRunsInSmem)
          run = red[m * 8 + cc];
        else
          run = gsum[it];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          d[e] = (8 * cc + e < lim && bf(o[e]) > 0.f) ? d[e] : (bf16)0;
          run += bf(d[e]);
        }
        if constexpr (kRunsInSmem)
          red[m * 8 + cc] = run;
        else
          gsum[it] = run;
        const uint4 gv = pack8(d);
        if (k > 1) __syncwarp();
        *reinterpret_cast<uint4*>(st + m * 128 + ((cc ^ (m & 7)) << 4)) = gv;
        const int cin = cin0 + chan_of(m, p.lk, la);
        if (first && (S & 7) == 0 && cin < Cin) {
          bf16* const dst = p.g3 + ((long)n * Cin + cin) * S + s0 + 8 * cc;
          if (8 * cc + 8 <= lim) {
            *reinterpret_cast<uint4*>(dst) = gv;
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (8 * cc + e < lim) dst[e] = d[e];
          }
        }
      }
      if (first && (S & 7) != 0) {
        // rows of g3 start off 16 bytes: each row's 8 lanes write it back
        // from the tile as two runs of 4 lanes x 8 bytes where S % 4 == 0
        // (whole 32-byte sectors a store), else value by value
        __syncwarp();
#pragma unroll 1
        for (int it = 0; it < 4; ++it) {
          const int m = 64 * cw + (uw >> 3) + 16 * it;
          const int cin = cin0 + chan_of(m, p.lk, la);
          if (cin >= Cin) continue;
          const char* const row = st + m * 128;
          bf16* const dst = p.g3 + ((long)n * Cin + cin) * S + s0;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int x = (S & 3) == 0 ? 32 * h + 4 * cc : 8 * cc + 4 * h;
            const uint2 v = *reinterpret_cast<const uint2*>(
                row + ((((x >> 3) ^ m) & 7) << 4) + (x & 7) * 2);
            if ((S & 3) == 0 && x + 4 <= lim) {
              *reinterpret_cast<uint2*>(dst + x) = v;
            } else {
              const bf16 hv[4] = {(bf16)(v.x & 0xffffu), (bf16)(v.x >> 16),
                                  (bf16)(v.y & 0xffffu), (bf16)(v.y >> 16)};
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (x + e < lim) dst[x + e] = hv[e];
            }
          }
        }
      }
      // h2 = bf16(relu(fma(a2, sc2, sh2))) (0 past S and past C) in place
#pragma unroll kUnrollH
      for (int it = 0; it < HT; ++it) {
        const int r = cw * (BN / 2) + (uw >> 3) + 16 * it;
        const float sc = vec[r], sh = vec[BN + r];
        bf16 a[8];
        gather8(st + kA2, st + kTa, r, 8 * cc + skew_of(r >> lb, S), a);
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int x = 8 * cc + 2 * i;
          w[i] = cvt_bf2(x < lim ? relu_affine(bf(a[2 * i]), sc, sh) : 0.f,
                         x + 1 < lim ? relu_affine(bf(a[2 * i + 1]), sc, sh)
                                     : 0.f);
        }
        const uint4 hv = make_uint4(w[0], w[1], w[2], w[3]);
        if (k > 1) __syncwarp();
        *reinterpret_cast<uint4*>(st + kA2 + r * 128 + ((cc ^ (r & 7)) << 4)) =
            hv;
      }
      sm90::fence_proxy_async();
      sm90::named_sync(1, 256);  // both halves of h2 and g3 are in place
    }
    const uint32_t sa = base + s * L::kStage + cw * 64 * 128;
    const uint32_t sb = base + s * L::kStage + kA2;
    sm90::fence_operands(acc);
    sm90::wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      sm90::wgmma_ss<BN, 0>(acc, sm90::desc_k(sa, ks), sm90::desc_k(sb, ks),
                            1);
    sm90::wg_commit();
    sm90::wg_wait<1>();  // the products of stage q - 1 have retired
    if (q > 0) {
      __syncwarp();
      if (lane == 0) sm90::bar_arrive(empty((q - 1) % NS));
    }
  }
  sm90::wg_wait<0>();
  sm90::fence_operands(acc);

  // P [Cin][C + 1], or dW1 [C][Cin]
  const int ld = kMode == kDW1 ? 1 : C + 1, cs = kMode == kDW1 ? Cin : 1;
  float* const part =
      p.part + (long)split * Cin * (kMode == kDW1 ? C : C + 1);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int cin = cin0 + chan_of(64 * cw + 16 * warp + g + 8 * hr, p.lk, la);
    if (cin >= Cin) continue;
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + chan_of(8 * jj + 2 * t + e, p.lk, lb);
        if (col < C)
          part[(long)cin * ld + (long)col * cs] = acc[4 * jj + 2 * hr + e];
      }
  }
  if (first) {
    // Σg3 of each row: its 8 threads' runs in chunk order
    if constexpr (!kRunsInSmem) {
#pragma unroll
      for (int it = 0; it < 4; ++it)
        red[(64 * cw + (uw >> 3) + 16 * it) * 8 + cc] = gsum[it];
    }
    sm90::named_sync(1, 256);
    if (u < kR3Rows) {
      const int cin = cin0 + chan_of(u, p.lk, la);
      if (cin < Cin) {
        float sum = 0.f;
        for (int q = 0; q < 8; ++q) sum += red[u * 8 + q];
        part[(long)cin * (C + 1) + C] = sum;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the host side
// ---------------------------------------------------------------------------

// A map over [N, R, S] bf16 as (k S, R / k, N, 1) (R a multiple of k =
// group_of(S)), boxes of 64 positions by rows / k channel rows in the
// 128-byte swizzle, or (tail) of 8 positions, dense.
inline int encode_rows(CUtensorMap* map, const void* base, int N, int R,
                       int S, int rows, bool tail) {
  const int k = group_of(S);
  const cuuint64_t dims[4] = {(cuuint64_t)k * S, (cuuint64_t)(R / k),
                              (cuuint64_t)N, 1};
  const cuuint64_t strides[3] = {2ull * k * S, 2ull * R * S,
                                 2ull * R * S * N};
  const cuuint32_t box[4] = {(cuuint32_t)(tail ? 8 : kPos),
                             (cuuint32_t)(rows / k), 1, 1};
  return sm90::encode_4d(map, base, dims, strides, box, !tail);
}

// Stages of N·S: ceil(S / 64) an image.
inline long stages_of(int N, int S) { return (long)N * ((S + kPos - 1) / kPos); }

// The checks of a split product over N·S: widths within the cap and
// multiples of group_of(S), splits within the stages.
inline bool ok(int N, int R1, int R2, int S, int splits) {
  const int k = group_of(S);
  const long st = stages_of(N, S);
  return N > 0 && R1 > 0 && R2 > 0 && S > 0 && R1 <= kMaxC && R2 <= kMaxC &&
         R1 % k == 0 && R2 % k == 0 && (long)N * S <= INT_MAX / 2 &&
         (long)k * S <= INT_MAX / 2 && splits > 0 && splits <= kMaxSplits &&
         splits <= st && st <= INT_MAX / 2;
}

// The nine tap gradients of da2 and h1 = bf16(relu(fma(a1, sc, sh))) [N,
// C, H*W] into part [splits][9][C][C] (C % 16 == 0, W <= kTapMaxW).
inline int launch_taps(const bf16* da2, const bf16* a1, const float* sc,
                       const float* sh, float* part, int N, int C, int H,
                       int W, int splits, cudaStream_t s) {
  const int S = H * W;
  if (!ok(N, C, C, S, splits) || C % 16 || W > kTapMaxW)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tda, th1, tda_tail, th1_tail;
  if (encode_rows(&tda, da2, N, C, S, 64, false) ||
      encode_rows(&th1, a1, N, C, S, 64, false) ||
      encode_rows(&tda_tail, da2, N, C, S, 64, true) ||
      encode_rows(&th1_tail, a1, N, C, S, 64, true))
    return (int)cudaErrorInvalidValue;
  const int T = (C + 63) / 64, k = group_of(S);
  const TapArgs p{part, sc, sh, N, C, S, W, (S + kPos - 1) / kPos,
                  (int)stages_of(N, S), splits, T, k, log2_of(k)};
  cudaFuncSetAttribute(taps_bf16_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)TapSmem::kBytes);
  taps_bf16_kernel<<<dim3((unsigned)(T * T), (unsigned)splits), kTapThreads,
                     TapSmem::kBytes, s>>>(tda, th1, tda_tail, th1_tail, p);
  return (int)cudaGetLastError();
}

template <int BN, int kMode>
int launch_reduce3_bn(const CUtensorMap (&maps)[6], const R3Args& p,
                      int ctiles, cudaStream_t s) {
  cudaFuncSetAttribute(reduce3_bf16_kernel<BN, kMode>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)R3Smem<BN>::kBytes);
  reduce3_bf16_kernel<BN, kMode><<<dim3((unsigned)(p.rtiles * ctiles),
                                        (unsigned)p.splits),
                                   kR3Threads, R3Smem<BN>::kBytes, s>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], p);
  return (int)cudaGetLastError();
}

// The tile rows of C (B's) of a split product: all of C up to 256 (64,
// 128 or 256 rows), else 256-row tiles.
inline int b_rows(int C) { return C <= 64 ? 64 : C <= 128 ? 128 : 256; }

// Σ over N·S of A's rows (Cin, 128 a tile) by B's (C, b_rows(C) a tile),
// maps[0, 1, 2] A, A's second operand (kReduce3: out) and B, then their
// tails, in the kernel of kMode with its grid.
template <int kMode>
int launch_split(const CUtensorMap (&maps)[6], const R3Args& p, int C,
                 cudaStream_t s) {
  const int bn = b_rows(C), ctiles = (C + bn - 1) / bn;
  if (bn == 64) return launch_reduce3_bn<64, kMode>(maps, p, ctiles, s);
  if (bn == 128) return launch_reduce3_bn<128, kMode>(maps, p, ctiles, s);
  return launch_reduce3_bn<256, kMode>(maps, p, ctiles, s);
}

// g3 [N, Cin, S] and part [splits][Cin][C + 1] from dout, out [N, Cin, S]
// and h2 = bf16(relu(fma(a2, sc, sh))), a2 [N, C, S]; B's tile all of C
// up to 256 (64, 128 or 256 rows), else 256-row tiles.
inline int launch_reduce3(const bf16* dout, const bf16* out, const bf16* a2,
                          const float* sc, const float* sh, bf16* g3,
                          float* part, int N, int Cin, int C, int S,
                          int splits, cudaStream_t s) {
  if (!ok(N, Cin, C, S, splits)) return (int)cudaErrorInvalidValue;
  const int bn = b_rows(C);
  CUtensorMap maps[6];
  for (int tail = 0; tail < 2; ++tail)
    if (encode_rows(&maps[3 * tail], dout, N, Cin, S, kR3Rows, tail) ||
        encode_rows(&maps[3 * tail + 1], out, N, Cin, S, kR3Rows, tail) ||
        encode_rows(&maps[3 * tail + 2], a2, N, C, S, bn, tail))
      return (int)cudaErrorInvalidValue;
  const int k = group_of(S);
  const R3Args p{g3, part, sc, sh, Cin, C, S, (S + kPos - 1) / kPos,
                 (int)stages_of(N, S), splits, (Cin + kR3Rows - 1) / kR3Rows,
                 k, log2_of(k)};
  return launch_split<kReduce3>(maps, p, C, s);
}

// part [splits][C][Cin]: dW1 = Σ da1 xᵀ of x [N, Cin, S] and da1 [N, C,
// S], each split's stages as launch_reduce3's.
inline int launch_dw1(const bf16* x, const bf16* da1, float* part, int N,
                      int Cin, int C, int S, int splits, cudaStream_t s) {
  if (!ok(N, Cin, C, S, splits)) return (int)cudaErrorInvalidValue;
  const int bn = b_rows(C);
  CUtensorMap maps[6];
  for (int tail = 0; tail < 2; ++tail) {
    if (encode_rows(&maps[3 * tail], x, N, Cin, S, kR3Rows, tail) ||
        encode_rows(&maps[3 * tail + 2], da1, N, C, S, bn, tail))
      return (int)cudaErrorInvalidValue;
    maps[3 * tail + 1] = maps[3 * tail];  // no second A operand
  }
  const int k = group_of(S);
  const R3Args p{nullptr, part, nullptr, nullptr, Cin, C, S,
                 (S + kPos - 1) / kPos, (int)stages_of(N, S), splits,
                 (Cin + kR3Rows - 1) / kR3Rows, k, log2_of(k)};
  return launch_split<kDW1>(maps, p, C, s);
}

}  // namespace abw
