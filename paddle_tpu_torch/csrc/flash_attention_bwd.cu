// Flash-attention backward for Hopper (sm_90a): dQ and dK/dV, each on the
// tensor cores in 3xTF32 with the probabilities and dS formed in
// registers.
//
// Replaces the two TPU kernels of paddle_tpu/kernels/flash_attention.py
// _flash_bwd_pallas: _bwd_dq_kernel (:178-215, pallas_call at :279; dQ =
// sum over keys of dS K, one pass over the key tiles per query tile) and
// _bwd_dkv_kernel (pallas_call at :298; dV = P^T dO and dK = dS^T Q, one
// pass over the query tiles per key tile). Both recompute the
// probabilities from the forward's row logsumexp:
//   s = scale * q.k (causal entries above the bottom-right aligned diagonal
//   set to kMaskValue), p = exp(s - lse), dp = dO.v,
//   dS = p * (dp - delta) * scale, delta = rowsum(dO * O).
// This is the flash-attention-2 split the TPU kernels use: each output
// tile is owned by one block that sums over the other axis in a fixed
// order, so there are no atomics and results are identical run to run.
// Rows past sq and keys past sk are loaded as zeros and get p = 0, so they
// add nothing and are not stored.
//
// What bounds it on the H100: operations. Per visible (query, key) pair
// dQ does 6 D flops (s, dp, dQ) and dK/dV 8 D (s, dp, dV, dK). At a
// training step's shape (B 8, S 1024, H 8, D 256, causal) dQ's 51.6 GFLOP
// are 0.77 ms at the 67 TFLOP/s float32 FMA rate; as three TF32 products
// each, 154.8 GFLOP of tensor-core work, 0.31 ms at the 495 TFLOP/s dense
// TF32 rate. dK/dV's 68.8 GFLOP are 1.03 ms in float32, 206.4 GFLOP of
// TF32 work, 0.42 ms; its 403 MB (q, k, v, dO, lse, delta in, dK, dV
// out) take 0.12 ms at 3.35 TB/s.
//
// dQ (flash_bwd_dq_kernel), on the forward's design (csrc/flash_attention.cu):
//   - A block owns one (batch, head) and a tile of kBQ = 64 query rows; 8
//     warps. Q and dO land once by 16-byte cp.async and stay, with the
//     rows' lse and delta in registers; the block walks the key tiles of
//     kBK = 32 keys up to the causal diagonal. Query tiles launch
//     heaviest first (block y takes tile n_q - 1 - y). At B 1, S 1024 the
//     grid is 128 blocks on 132 SMs.
//   - Shared memory at D = 256: Q and dO at a pitch of D + 16 floats, K
//     and V of 32 keys at D with their 16-byte chunks swizzled, and the
//     dS tile at 48: 217,088 bytes, one block an SM. Key tiles of 64
//     would not fit with both K and V, so the tiles are of 32, and K and V
//     take turns in one buffer each: K of tile t lands under dO V^T of
//     tile t; V of tile t + 1 is issued once dO V^T of t is done and
//     lands under Q K^T and dS K of t; K of t + 1 is issued once dS K of
//     t is done. Three barriers a key tile.
//   - The products: mma.sync m16n8k8 TF32 in 3xTF32 with a fresh fragment
//     a k8 step (csrc/tf32_mma.cuh), 16-byte fragment reads by a k order
//     permuted within each k16 block. S = Q K^T and dP = dO V^T are
//     computed by the same warps over the same warp tile (4 (rows) x 2
//     (keys) warps, 16 rows x 16 keys each), so their C fragments share
//     one layout and p = exp(s - lse) and dS = p (dp - delta) scale are
//     elementwise on registers: no pass over shared memory for the
//     softmax. Only dS goes to shared memory, as the A operand of dQ +=
//     dS K (2 x 4 warps, 32 rows x D / 4 columns each, n order permuted
//     as the forward's P V; 64 accumulators a thread at D = 256, kept in
//     registers across the key tiles).
//   - K plays two roles. In Q K^T it is read along its rows (lanes g, t:
//     row g, chunk t of a k16 block; a quarter warp's rows are 2 p and 2
//     p + 1 of an aligned 8); in dS K down its rows (row 4 t + 2 st + e,
//     the lane's NT = D / 32 columns from column D / 4 wn + NT g). One
//     XOR swizzle of the chunks (kv_swizzle) puts both reads of a quarter
//     warp (a half warp for the 8-byte reads at D = 64) on 32 distinct
//     banks, so K needs no padding; V, read along its rows only, shares
//     the layout. What conflicts is dS's float2 stores, two ways, four
//     stores a thread a key tile.
//   - The epilogue stores dQ for rows < sq as 16-byte writes. No atomics:
//     two calls are bit-identical.
//   Registers (nvcc -Xptxas -v, sm_90a, CUDA 12.8): 247 / 148 / 132 a
//   thread at D = 256 / 128 / 64; no spills, no stack.
//   What holds it back (PERF.md, row 2; scripts/torch_flash_bwd_probe.py):
//   as the forward, one block of 8 warps an SM, so the mma chains'
//   latency is poorly hidden, and a build with each mma replaced by
//   integer work is no faster; the copies the single K and V buffers
//   leave between barriers cost ~5%. At B 1 the last query tile's walk
//   over S / 32 key tiles sets the time.
//
// dK/dV (flash_bwd_dkv_kernel) is dQ's design with the operands' roles
// swapped: K and V stay, Q and dO stream past them.
//   - A block owns one (batch, head) and a tile of kBK = 32 keys; 8 warps.
//     K and V land once by 16-byte cp.async and stay; the block walks the
//     query tiles of kBQ = 64 rows from the first that sees its keys
//     (causal: the tile of row k0 - (sk - sq)) to the last. Key tile 0,
//     the heaviest under causal masking, launches first. At B 1, S 1024
//     the grid is 256 blocks on 132 SMs.
//   - Shared memory at D = 256: K and V at a pitch of D + 16 floats (as
//     dQ's Q and dO), Q and dO of one query tile at D with their chunks
//     swizzled (as dQ's K and V: kv_swizzle repeats every 16 rows, and a
//     64-row tile is copied as two of 32, since copy_rows swizzles at 8
//     threads a row), P^T and dS^T at kLP = 80 floats (16 mod 32), and the
//     tile's lse and delta: 221,696 bytes, one block an SM. Q and dO take
//     turns with their copies, one buffer each: dP^T = V dO_t^T runs
//     while Q_t lands; then S^T = K Q_t^T, P^T and dS^T formed and
//     stored, dV += P^T dO_t; dO_{t+1} is issued with its lse and delta
//     (4-byte copies: a row of lse starts at bh sq floats, not 16-byte
//     aligned where sq % 4 != 0) and lands under dK += dS^T Q_t; Q_{t+1}
//     is issued once dK is done. Four barriers a query tile; S^T and dV
//     run with no copy in flight.
//   - The products: dQ's tile_product and k8 fragments. S^T and dP^T are
//     computed by the same warps over the same warp tile (2 (keys) x 4
//     (queries) warps, 16 keys x 16 queries each), so p = exp(s - lse)
//     and dS = p (dp - delta) scale are elementwise on registers, lse and
//     delta indexed by the column (the query). dV += P^T dO and dK +=
//     dS^T Q (accumulate_dkv) run on 2 (keys) x 4 (column quarters)
//     warps, 16 keys x D / 4 columns each, over a k extent of 64 queries:
//     A = P^T or dS^T read along its rows, B = dO or Q read down its rows
//     as dQ's dS K reads K, so the one swizzle puts both reads of Q and of
//     dO on 32 banks. dV and dK hold [1][D / 32][4] accumulators each, 64
//     a thread at D = 256, in registers across the walk; kJG = 2 n8 tiles
//     a step, as dQ (4 or 8 give the same bits in the same time).
//     (4 warps on dV and 4 on dK, 16 x D / 2 each, would hold as many
//     accumulators but leave no product for dO's copy to land under.)
//   - The epilogue stores dK and dV for keys < sk as 16-byte writes, the
//     columns permuted as dQ's. No atomics: two calls are bit-identical.
//   Registers (nvcc -Xptxas -v, sm_90a, CUDA 12.8): 204 / 146 / 130 a
//   thread at D = 256 / 128 / 64; no spills, no stack. 144 / 96 / 72 HMMA;
//   72 FFMA at every D, none in the products.
//   What holds it back (PERF.md, row 3; scripts/torch_flash_bwd_probe.py):
//   as dQ, the instructions around the mma (fragment reads, splits,
//   fresh-fragment adds) of one block of 8 warps an SM, at 132 TFLOP/s of
//   TF32 (B 8, S 1024): a build with each mma replaced by integer work is
//   7% slower, one without the streamed copies 3% faster. At B 1 the
//   heaviest key tile's walk over S / 64 query tiles sets the time.
#include <cmath>

#include "common.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 32;        // key rows per tile
constexpr int kThreads = 256;  // 8 warps

// ---- dQ on the tensor cores ------------------------------------------------

constexpr int kLS = kBK + 16;  // dS's pitch: 16 mod 32
constexpr int kJG = 2;         // n8 tiles a step whose mma chains interleave

// The dQ kernel's shared memory, in floats: Q, dO, K, V, dS.
template <int D>
struct DqSmem {
  static constexpr int kLQ = D + 16;   // Q's and dO's pitch: 16 mod 32
  static constexpr int kQ = kBQ * kLQ;
  static constexpr int kK = kBK * D;   // K's and V's: D, chunks swizzled
  static constexpr int kS = kBQ * kLS;
  static constexpr int kFloats = 2 * kQ + 2 * kK + kS;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

// K's and V's 16-byte chunk c of key row r sits at chunk c ^ kv_swizzle(r):
// bit 2 of the mask is bit 3 ^ bit 0 of r, so the two rows of a quarter
// warp's reads along the rows (Q K^T, dO V^T: rows 2 p and 2 p + 1 of an
// aligned 8, 4 consecutive chunks each) land on opposite halves of the
// banks; bit 0 (D = 256) or bit 1 (D <= 128) is bit 2 of r, so that with
// bit 2 it sends dS K's reads down the rows (rows 4 t + const, chunks 2 g
// + {0, 1}, g or half of g / 2, as the forward's V) to 32 banks too.
template <int D>
__device__ __forceinline__ int kv_swizzle(int r) {
  const int lo = (r >> 2) & 1;
  return (D == 256 ? lo : lo << 1) | (((r >> 3) ^ r) & 1) << 2;
}

// Rows r0 .. r0 + ROWS - 1 of x (a row every `stride` floats) into dst at
// pitch LD, 16 bytes a copy, rows at or past n zero-filled. T = 256 / ROWS
// threads share a row: thread i copies chunks i % T + T e of row i / T,
// at constant offsets of two base addresses. Where SWZ (K, V; T = 8),
// chunk c lands at c ^ kv_swizzle(row) = (c % 8 ^ sw) + 8 (c / 8).
template <int D, int ROWS, int LD, bool SWZ>
__device__ __forceinline__ void copy_rows(float* dst, const float* x, int r0,
                                          int n, long stride) {
  constexpr int T = kThreads / ROWS;
  const int r = threadIdx.x / T, c0 = threadIdx.x % T;
  const bool ok = r0 + r < n;
  const float* src = x + (ok ? (r0 + r) * stride : 0) + 4 * c0;
  float* d = dst + r * LD + 4 * (SWZ ? c0 ^ kv_swizzle<D>(r) : c0);
#pragma unroll
  for (int e = 0; e < D / (4 * T); ++e)
    copy16(d + 4 * T * e, src + 4 * T * e, ok);
}

// c = A B^T over a key tile, A (Q or dO) at pitch D + 16, B (K or V)
// swizzled: warp (sm, sn) owns rows 16 sm + {g, g + 8} and keys 16 sn +
// 8 j + {2 t, 2 t + 1}; both k8 steps of a k16 block at once. The lane's
// B rows 16 sn + 8 j + g hold chunk d0 / 4 + t of k16 block d0 at
// (d0 / 4 + t) ^ sw: floats (d0 ^ 4 (sw & 4)) + 4 (t ^ (sw & 3)).
template <int D>
__device__ __forceinline__ void tile_product(float (&c)[1][2][4],
                                             const float* sA, const float* sB,
                                             int sm, int sn, int g, int t) {
  constexpr int LD = D + 16;
  const float* pa = sA + (16 * sm + g) * LD + 4 * t;
  const float* pb[2][2];  // [j][k16 block's parity]
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = 16 * sn + 8 * j + g, sw = kv_swizzle<D>(r);
#pragma unroll
    for (int u = 0; u < 2; ++u)
      pb[j][u] = sB + r * D + 16 * (u ^ (sw >> 2)) + 4 * (t ^ (sw & 3));
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) c[0][j][r] = 0.f;
#pragma unroll 1
  for (int d1 = 0; d1 < D; d1 += 32) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float4 av[2], bv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        av[h] = *reinterpret_cast<const float4*>(pa + 8 * h * LD + d1 +
                                                 16 * u);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        bv[j] = *reinterpret_cast<const float4*>(pb[j][u] + d1);
      uint32_t ab[2][1][4], as[2][1][4], bb[2][2][2], bs[2][2][2];
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        a_frag(av[0], av[1], st, ab[st][0], as[st][0]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          split(part(bv[j], 2 * st), bb[st][j][0], bs[st][j][0]);
          split(part(bv[j], 2 * st + 1), bb[st][j][1], bs[st][j][1]);
        }
      }
      mma3<2, 1, 2, 2>(c, ab, as, bb, bs, 0);
    }
  }
}

// acc += dS K over a key tile: warp (wm, wn) owns rows 32 wm + 16 i + {g,
// g + 8} and, in n8 tile j, the columns D / 4 wn + NT (2 t + c) + j, c =
// 0, 1 (fragment slots 2 t and 2 t + 1), NT = D / 32. kJG n8 tiles at a
// time. b0 of k8 step st comes from key row k0 + 4 t + 2 st, b1 from the
// next, whose swizzles differ in bit 0 of the row alone.
template <int D>
__device__ __forceinline__ void accumulate_dq(float (&acc)[2][D / 32][4],
                                              const float* sS,
                                              const float* sK, int wm, int wn,
                                              int g, int t) {
  constexpr int NT = D / 32;
  const float* pa = sS + (32 * wm + g) * kLS + 4 * t;
  const int col = wn * (D / 4) + NT * g;  // the lane's first column
  const int sw[2] = {kv_swizzle<D>(4 * t), kv_swizzle<D>(4 * t + 1)};
#pragma unroll 1
  for (int k0 = 0; k0 < kBK; k0 += 16) {
    float4 pv[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        pv[i][h] = *reinterpret_cast<const float4*>(
            pa + (16 * i + 8 * h) * kLS + k0);
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      uint32_t ab[1][2][4], as[1][2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        a_frag(pv[i][0], pv[i][1], st, ab[0][i], as[0][i]);
      float kb[2][NT];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float* row = sK + (k0 + 4 * t + 2 * st + e) * D;
        if constexpr (NT >= 4) {
#pragma unroll
          for (int c = 0; c < NT / 4; ++c) {
            const float4 x = *reinterpret_cast<const float4*>(
                row + 4 * ((col / 4 + c) ^ sw[e]));
            kb[e][4 * c] = x.x;
            kb[e][4 * c + 1] = x.y;
            kb[e][4 * c + 2] = x.z;
            kb[e][4 * c + 3] = x.w;
          }
        } else {
          const float2 x = *reinterpret_cast<const float2*>(
              row + 4 * ((col / 4) ^ sw[e]) + col % 4);
          kb[e][0] = x.x;
          kb[e][1] = x.y;
        }
      }
#pragma unroll
      for (int j0 = 0; j0 < NT; j0 += kJG) {
        uint32_t bb[1][kJG][2], bs[1][kJG][2];
#pragma unroll
        for (int j = 0; j < kJG; ++j) {
          split(kb[0][j0 + j], bb[0][j][0], bs[0][j][0]);
          split(kb[1][j0 + j], bb[0][j][1], bs[0][j][1]);
        }
        mma3<1, 2, kJG, NT>(acc, ab, as, bb, bs, j0);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int sq, int sk, float scale, int causal) {
  constexpr int LQ = DqSmem<D>::kLQ;
  constexpr int NT = D / 32;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [kBQ][LQ]
  float* sO = sQ + DqSmem<D>::kQ;                // [kBQ][LQ] dO
  float* sK = sO + DqSmem<D>::kQ;                // [kBK][D], swizzled
  float* sV = sK + DqSmem<D>::kK;                // [kBK][D], swizzled
  float* sS = sV + DqSmem<D>::kK;                // [kBQ][kLS] dS

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heaviest first
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int sm = warp >> 1, sn = warp & 1;  // S, dP, dS: 4 (rows) x 2 (keys)
  const int wm = warp >> 2, wn = warp & 3;  // dQ: 2 (rows) x 4 (columns)
  const int q_off = sk - sq;
  const long stride = (long)H * D;  // floats between sequence positions
  const float* qb = q + ((long)b * sq * H + h) * D;
  const float* ob = dout + ((long)b * sq * H + h) * D;
  const float* kb = k + ((long)b * sk * H + h) * D;
  const float* vb = v + ((long)b * sk * H + h) * D;

  // key tiles past the causal diagonal of this query tile are skipped
  int n_tiles = (sk + kBK - 1) / kBK;
  if (causal) n_tiles = min(sk - 1, q0 + kBQ - 1 + q_off) / kBK + 1;

  copy_rows<D, kBQ, LQ, false>(sQ, qb, q0, sq, stride);
  copy_rows<D, kBQ, LQ, false>(sO, ob, q0, sq, stride);
  copy_rows<D, kBK, D, true>(sV, vb, 0, sk, stride);
  commit();
  copy_rows<D, kBK, D, true>(sK, kb, 0, sk, stride);
  commit();

  // the lane's two rows of the score tile, their lse and delta
  int qrow[2];
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    qrow[hr] = q0 + 16 * sm + g + 8 * hr;
    const bool ok = qrow[hr] < sq;
    row_lse[hr] = ok ? lse[(long)bh * sq + qrow[hr]] : 0.f;
    row_delta[hr] = ok ? delta[(long)bh * sq + qrow[hr]] : 0.f;
  }
  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
  wait_prior<1>();  // this thread's copies of Q, dO and V
  __syncthreads();  // everyone's

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    float dp[1][2][4], s[1][2][4];
    tile_product<D>(dp, sO, sV, sm, sn, g, t);  // K lands under it
    wait_prior<0>();  // this thread's copies of K
    __syncthreads();  // everyone's; and dO V^T is done with V
    if (kt + 1 < n_tiles) copy_rows<D, kBK, D, true>(sV, vb, k0 + kBK, sk,
                                                     stride);
    commit();
    tile_product<D>(s, sQ, sK, sm, sn, g, t);

    // p and dS on the fragments; dS to shared memory, dS K's A operand
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 16 * sm + g + 8 * hr;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = 16 * sn + 8 * j + 2 * t;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + c + e;
          ds[e] = 0.f;
          if (qrow[hr] < sq && kpos < sk) {
            float x = s[0][j][2 * hr + e] * scale;
            if (causal && kpos > qrow[hr] + q_off) x = ptt::kMaskValue;
            const float p = expf(x - row_lse[hr]);
            ds[e] = p * (dp[0][j][2 * hr + e] - row_delta[hr]) * scale;
          }
        }
        *reinterpret_cast<float2*>(sS + r * kLS + c) =
            make_float2(ds[0], ds[1]);
      }
    }
    __syncthreads();  // dS is in sS
    accumulate_dq<D>(acc, sS, sK, wm, wn, g, t);  // V lands under both
    wait_prior<0>();  // this thread's copies of the next V
    __syncthreads();  // everyone's; and dS K is done with K and dS
    if (kt + 1 < n_tiles) copy_rows<D, kBK, D, true>(sK, kb, k0 + kBK, sk,
                                                     stride);
    commit();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 32 * wm + 16 * i + g + 8 * hr;
      if (q0 + r >= sq) continue;
      float out[2 * NT];
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int j = 0; j < NT; ++j) out[NT * c + j] = acc[i][j][2 * hr + c];
      float* orow = dq + (q0 + r) * stride + ((long)b * sq * H + h) * D +
                    wn * (D / 4) + 2 * NT * t;
#pragma unroll
      for (int c = 0; c < 2 * NT; c += 4)
        *reinterpret_cast<float4*>(orow + c) =
            make_float4(out[c], out[c + 1], out[c + 2], out[c + 3]);
    }
}
// -----------------------------------------------------------------------------

// ---- dK/dV on the tensor cores ---------------------------------------------

constexpr int kLP = kBQ + 16;  // P^T's and dS^T's pitch: 16 mod 32

// The dK/dV kernel's shared memory, in floats: K, V, Q, dO, P^T, dS^T,
// lse and delta.
template <int D>
struct DkvSmem {
  static constexpr int kLK = D + 16;   // K's and V's pitch: 16 mod 32
  static constexpr int kK = kBK * kLK;
  static constexpr int kQ = kBQ * D;   // Q's and dO's: D, chunks swizzled
  static constexpr int kP = kBK * kLP;
  static constexpr int kFloats = 2 * kK + 2 * kQ + 2 * kP + 2 * kBQ;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

// Query rows q0 .. q0 + kBQ - 1 of x into dst, chunks swizzled: two
// copies of 32 rows, as copy_rows swizzles at 8 threads a row (kBK rows);
// kv_swizzle(r + 32) = kv_swizzle(r).
template <int D>
__device__ __forceinline__ void copy_query_rows(float* dst, const float* x,
                                                int q0, int n, long stride) {
  copy_rows<D, kBK, D, true>(dst, x, q0, n, stride);
  copy_rows<D, kBK, D, true>(dst + kBK * D, x, q0 + kBK, n, stride);
}

// lse and delta of query rows q0 .. q0 + kBQ - 1 into st[0, kBQ) and
// st[kBQ, 2 kBQ), 4 bytes a copy, zero past sq.
__device__ __forceinline__ void copy_stats(float* st, const float* lse,
                                           const float* delta, int q0,
                                           int sq) {
  const int i = threadIdx.x;
  if (i < 2 * kBQ) {
    const int r = i % kBQ;
    const bool ok = q0 + r < sq;
    copy4(st + i, (i < kBQ ? lse : delta) + (ok ? q0 + r : 0), ok);
  }
}

// acc += A B over a query tile: A (P^T or dS^T, [kBK][kLP]) read along
// its rows, B (dO or Q, [kBQ][D], swizzled) down its rows, as
// accumulate_dq reads dS and K, over the tile's 64 queries. Warp (wm, wn)
// owns keys 16 wm + {g, g + 8} and, in n8 tile j, the columns D / 4 wn +
// NT (2 t + c) + j, c = 0, 1, NT = D / 32; kJG n8 tiles at a time.
template <int D>
__device__ __forceinline__ void accumulate_dkv(float (&acc)[1][D / 32][4],
                                               const float* sA,
                                               const float* sB, int wm,
                                               int wn, int g, int t) {
  constexpr int NT = D / 32;
  const float* pa = sA + (16 * wm + g) * kLP + 4 * t;
  const int col = wn * (D / 4) + NT * g;  // the lane's first column
  const int sw[2] = {kv_swizzle<D>(4 * t), kv_swizzle<D>(4 * t + 1)};
#pragma unroll 1
  for (int k0 = 0; k0 < kBQ; k0 += 16) {
    float4 pv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      pv[h] = *reinterpret_cast<const float4*>(pa + 8 * h * kLP + k0);
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      uint32_t ab[1][1][4], as[1][1][4];
      a_frag(pv[0], pv[1], st, ab[0][0], as[0][0]);
      float bv[2][NT];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float* row = sB + (k0 + 4 * t + 2 * st + e) * D;
        if constexpr (NT >= 4) {
#pragma unroll
          for (int c = 0; c < NT / 4; ++c) {
            const float4 x = *reinterpret_cast<const float4*>(
                row + 4 * ((col / 4 + c) ^ sw[e]));
            bv[e][4 * c] = x.x;
            bv[e][4 * c + 1] = x.y;
            bv[e][4 * c + 2] = x.z;
            bv[e][4 * c + 3] = x.w;
          }
        } else {
          const float2 x = *reinterpret_cast<const float2*>(
              row + 4 * ((col / 4) ^ sw[e]) + col % 4);
          bv[e][0] = x.x;
          bv[e][1] = x.y;
        }
      }
#pragma unroll
      for (int j0 = 0; j0 < NT; j0 += kJG) {
        uint32_t bb[1][kJG][2], bs[1][kJG][2];
#pragma unroll
        for (int j = 0; j < kJG; ++j) {
          split(bv[0][j0 + j], bb[0][j][0], bs[0][j][0]);
          split(bv[1][j0 + j], bb[0][j][1], bs[0][j][1]);
        }
        mma3<1, 1, kJG, NT>(acc, ab, as, bb, bs, j0);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int sq, int sk,
                     float scale, int causal) {
  constexpr int LK = DkvSmem<D>::kLK;
  constexpr int NT = D / 32;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);  // [kBK][LK]
  float* sV = sK + DkvSmem<D>::kK;               // [kBK][LK]
  float* sQ = sV + DkvSmem<D>::kK;               // [kBQ][D], swizzled
  float* sO = sQ + DkvSmem<D>::kQ;               // [kBQ][D] dO, swizzled
  float* sP = sO + DkvSmem<D>::kQ;               // [kBK][kLP] P^T
  float* sS = sP + DkvSmem<D>::kP;               // [kBK][kLP] dS^T
  float* sL = sS + DkvSmem<D>::kP;               // lse, delta [kBQ] each

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * kBK;  // key tile 0, the heaviest, first
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // keys 16 wm + ...; S^T's and dP^T's queries 16 wn + ..., dV's and
  // dK's columns D / 4 wn + ...
  const int wm = warp >> 2, wn = warp & 3;
  const int q_off = sk - sq;
  const long stride = (long)H * D;  // floats between sequence positions
  const float* qb = q + ((long)b * sq * H + h) * D;
  const float* ob = dout + ((long)b * sq * H + h) * D;
  const float* kb = k + ((long)b * sk * H + h) * D;
  const float* vb = v + ((long)b * sk * H + h) * D;
  const float* lse_bh = lse + (long)bh * sq;
  const float* delta_bh = delta + (long)bh * sq;

  // query tiles that end before this key tile's diagonal see none of it:
  // the first useful row is k0 - q_off (always < sq, since k0 < sk)
  const int n_q = (sq + kBQ - 1) / kBQ;
  const int first = causal ? max(0, k0 - q_off) / kBQ : 0;

  copy_rows<D, kBK, LK, false>(sV, vb, k0, sk, stride);
  copy_query_rows<D>(sO, ob, first * kBQ, sq, stride);
  copy_stats(sL, lse_bh, delta_bh, first * kBQ, sq);
  commit();
  copy_rows<D, kBK, LK, false>(sK, kb, k0, sk, stride);
  copy_query_rows<D>(sQ, qb, first * kBQ, sq, stride);
  commit();

  int key[2];  // the lane's two keys of the score tile
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) key[hr] = k0 + 16 * wm + g + 8 * hr;
  float acc_v[1][NT][4], acc_k[1][NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc_v[0][j][r] = acc_k[0][j][r] = 0.f;
  wait_prior<1>();  // this thread's copies of V, dO, lse and delta
  __syncthreads();  // everyone's

  for (int qt = first; qt < n_q; ++qt) {
    const int q0 = qt * kBQ;
    float dp[1][2][4], s[1][2][4];
    tile_product<D>(dp, sV, sO, wm, wn, g, t);  // Q lands under it
    wait_prior<0>();  // this thread's copies of Q (and K)
    __syncthreads();  // everyone's
    tile_product<D>(s, sK, sQ, wm, wn, g, t);

    // p and dS on the fragments; P^T and dS^T to shared memory, the A
    // operands of dV and dK
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = 16 * wn + 8 * j + 2 * t;  // the lane's queries q0 + c + e
      const float2 l2 = *reinterpret_cast<const float2*>(sL + c);
      const float2 d2 = *reinterpret_cast<const float2*>(sL + kBQ + c);
      const float col_lse[2] = {l2.x, l2.y}, col_delta[2] = {d2.x, d2.y};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 16 * wm + g + 8 * hr;
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qrow = q0 + c + e;
          p[e] = ds[e] = 0.f;
          if (qrow < sq && key[hr] < sk) {
            float x = s[0][j][2 * hr + e] * scale;
            if (causal && key[hr] > qrow + q_off) x = ptt::kMaskValue;
            p[e] = expf(x - col_lse[e]);
            ds[e] = p[e] * (dp[0][j][2 * hr + e] - col_delta[e]) * scale;
          }
        }
        *reinterpret_cast<float2*>(sP + r * kLP + c) = make_float2(p[0], p[1]);
        *reinterpret_cast<float2*>(sS + r * kLP + c) =
            make_float2(ds[0], ds[1]);
      }
    }
    __syncthreads();  // P^T and dS^T are in shared memory
    accumulate_dkv<D>(acc_v, sP, sO, wm, wn, g, t);
    __syncthreads();  // dV is done with dO, the formation with lse, delta
    if (qt + 1 < n_q) {
      copy_query_rows<D>(sO, ob, q0 + kBQ, sq, stride);
      copy_stats(sL, lse_bh, delta_bh, q0 + kBQ, sq);
    }
    commit();
    accumulate_dkv<D>(acc_k, sS, sQ, wm, wn, g, t);  // dO lands under it
    wait_prior<0>();  // this thread's copies of the next dO
    __syncthreads();  // everyone's; and dK is done with Q and dS^T
    if (qt + 1 < n_q) copy_query_rows<D>(sQ, qb, q0 + kBQ, sq, stride);
    commit();
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = 16 * wm + g + 8 * hr;
    if (k0 + r >= sk) continue;
    float ok[2 * NT], ov[2 * NT];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        ok[NT * c + j] = acc_k[0][j][2 * hr + c];
        ov[NT * c + j] = acc_v[0][j][2 * hr + c];
      }
    const long off = ((long)b * sk * H + h) * D + (k0 + r) * stride +
                     wn * (D / 4) + 2 * NT * t;
#pragma unroll
    for (int c = 0; c < 2 * NT; c += 4) {
      *reinterpret_cast<float4*>(dk + off + c) =
          make_float4(ok[c], ok[c + 1], ok[c + 2], ok[c + 3]);
      *reinterpret_cast<float4*>(dv + off + c) =
          make_float4(ov[c], ov[c + 1], ov[c + 2], ov[c + 3]);
    }
  }
}
// -----------------------------------------------------------------------------

template <int D>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* delta,
              float* dq, int B, int H, int sq, int sk, float scale,
              int causal, cudaStream_t stream) {
  const size_t smem = DqSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (sq + kBQ - 1) / kBQ);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, H, sq, sk, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* delta,
               float* dk, float* dv, int B, int H, int sq, int sk,
               float scale, int causal, cudaStream_t stream) {
  const size_t smem = DkvSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (sk + kBK - 1) / kBK);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, H, sq, sk, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q, dout, dq [B, sq, H, D]; k, v [B, sk, H, D]; lse, delta [B*H, sq]; all
// float32, contiguous, 16-byte aligned; causal needs sq <= sk. Return a
// cudaError_t (0 = launched).
extern "C" int flash_attention_bwd_dq_f32(const float* q, const float* k,
                                          const float* v, const float* dout,
                                          const float* lse, const float* delta,
                                          float* dq, int B, int H, int sq,
                                          int sk, int D, float scale,
                                          int causal, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, delta, dq, B, H, sq, sk, scale,
                           causal, s);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, delta, dq, B, H, sq, sk,
                            scale, causal, s);
    case 256:
      return launch_dq<256>(q, k, v, dout, lse, delta, dq, B, H, sq, sk,
                            scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_attention_bwd_dkv_f32(const float* q, const float* k,
                                           const float* v, const float* dout,
                                           const float* lse,
                                           const float* delta, float* dk,
                                           float* dv, int B, int H, int sq,
                                           int sk, int D, float scale,
                                           int causal, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, H, sq, sk,
                            scale, causal, s);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, H, sq, sk,
                             scale, causal, s);
    case 256:
      return launch_dkv<256>(q, k, v, dout, lse, delta, dk, dv, B, H, sq, sk,
                             scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
