// Flash-attention forward for Hopper (sm_90a): both products on tensor
// cores in 3xTF32, K and V landing by asynchronous copies under the other
// product.
//
// Replaces the TPU kernel paddle_tpu/kernels/flash_attention.py:_flash_fwd
// (Pallas body _fwd_kernel, :68-124; pallas_call at :151): online-softmax
// attention over [B, S, H, D] inputs with a causal block skip, bottom-right
// aligned (query row i sits at key position i + sk - sq), returning O and
// the row logsumexp.
//
// What bounds it on the H100: operations. At a training step's shape (B 8,
// S 1024, H 8, D 256, causal) the two products are 4 D flops per visible
// (query, key) pair, 34.4 GFLOP: 0.51 ms at the 67 TFLOP/s float32 FMA
// rate. Done here as three TF32 products each, 103.2 GFLOP of tensor-core
// work: 0.21 ms at the 495 TFLOP/s dense TF32 rate. Q, K, V read once and
// O written once are 0.27 GB, 0.08 ms at 3.35 TB/s. The chain's
// 3xTF32 mma.sync products run at ~130-180 TFLOP/s of TF32, bound by the
// instructions around the mma (PERF.md, lesson 8).
//
// The design:
//   - A block owns one (batch, head) and a tile of kBQ = 64 query rows; 8
//     warps. Q lands once by 16-byte cp.async; then the block walks the
//     key tiles of kBK = 64 keys with the online-softmax recurrence, so
//     the [S, S] score matrix never reaches device memory. Under causal
//     masking it stops at the diagonal: key tiles past it are never
//     loaded.
//   - Heaviest first: the grid is (B * H, query tiles), and block y takes
//     query tile n_q - 1 - y, so under causal masking the blocks that walk
//     the most key tiles launch first and the light ones fill the tail.
//     At B 1 (a prefill bucket of S <= 1024, H 8) the grid is 8 x S / 64
//     <= 128 blocks, fewer than the 132 SMs, all in flight at once: the
//     last query tile's walk over S / 64 key tiles sets the time.
//   - Shared memory at D = 256: Q and K at a pitch of D + 16 floats, V at
//     D with its 16-byte chunks swizzled, the score / probability tile P
//     at 80, and the rows' running max, sum and rescale: 226,048 bytes,
//     one block an SM. There is no room for a second K or V buffer (a
//     ring), so K and V take turns: V of tile t is issued before Q K^T of
//     tile t and lands under it; K of tile t + 1 is issued right after the
//     barrier that ends Q K^T of tile t and lands under the softmax and
//     P V. Keys past sk land as zeros (the copy's zero fill), and so do
//     rows of Q past sq. A thread copies 16-byte chunks of one row, so
//     that its copies' addresses are constant offsets of one or two bases.
//   - The products: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 in
//     3xTF32 (csrc/tf32_mma.cuh's split, mma0, mma and mma3): each
//     operand x splits into big = x rounded to TF32 and small = x - big,
//     and each k8 step's products small.big, big.small, big.big of a tile
//     go into a fresh fragment, added into the float32 accumulators with
//     float32 adds (the tensor cores truncate as they accumulate: PERF.md,
//     lesson 7). Both products take 8 warps as 2 (rows) x 4: S = Q K^T a
//     warp tile of 32 rows x 16 keys (2 m16 x 2 n8, both k8 steps of a
//     k16 block at once: 8 mma chains interleaved), O += P V one of 32
//     rows x D / 4 columns (2 m16 x D / 32 n8, 2 n8 at a time; 64
//     accumulators a thread at D = 256, kept in registers across the key
//     tiles), so that each A fragment serves two or more n8 tiles and each
//     B fragment two m16 tiles.
//   - Wide fragment reads: within each k16 block the product's k order is
//     permuted (step s, slot t <- element 4 t + 2 s; slot t + 4 <- 4 t + 2
//     s + 1), so that a lane's A values of two k8 steps, and its B values
//     of Q K^T, are 4 consecutive floats of one row: one 16-byte read where
//     the PTX layout would take four 4-byte ones. The pitch of Q, K and P
//     is 16 mod 32 floats, which puts each quarter warp's 16-byte reads on
//     32 distinct banks. P V's B operand, V, is read down its rows: its n
//     order is permuted instead (tile j, slot g <- column D / 4 wn + NT g
//     + j, NT = D / 32), so that a lane reads NT consecutive floats of a
//     row, and V's 16-byte chunks are XOR-swizzled by bits 2-3 of the row,
//     which puts those reads on distinct banks too. The epilogue's columns
//     follow: a lane holds 2 NT consecutive floats of a row of O.
//   - The masks, as the old kernel and _fwd_kernel have them: scores are
//     Q K^T * scale; keys past sk score -inf; keys past the causal
//     diagonal score the finite kMaskValue. The softmax row pass (a warp
//     owns 8 rows, a lane 2 keys, the 8 rows' reductions interleaved)
//     keeps the running max m and sum l and the rescale alpha = exp(m_prev
//     - m_new) in shared memory; P V first scales the accumulators by
//     alpha. Three barriers a key tile.
//   - The epilogue: O = acc / l_safe (a row whose sum is 0 divides by 1),
//     stored for rows < sq as 16-byte writes; lse = m + log(l_safe). No
//     atomics: two calls are bit-identical.
//
// Registers (nvcc -Xptxas -v, sm_90a, CUDA 12.8): 240 / 180 / 166 a
// thread at D = 256 / 128 / 64, one block an SM; no spills, no stack. (A
// build whose copy loops computed each copy's address from its row
// spilled at 255.)
//
// What holds it back (PERF.md, row 1; scripts/torch_flash_fwd_probe.py):
// one block of 8 warps an SM, 2 a scheduler, so the mma chains' latency
// is poorly hidden: the tensor cores run well under what mma.sync reaches
// alone, and a build with each mma replaced by integer work is slower,
// not faster (as for the chain's 3xTF32 products, PERF.md lesson 8). The
// softmax pass and the copies, which the single K and V buffers leave
// between barriers, are each worth a few percent (the probe's builds
// without them).
#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kBQ = 64;        // query rows a block
constexpr int kBK = 64;        // keys a tile
constexpr int kThreads = 256;  // 8 warps: 2 (rows) x 4 (keys or columns)
constexpr int kLP = kBK + 16;  // P's pitch: 16 mod 32
constexpr int kJG = 2;         // n8 tiles of P V whose mma chains interleave

// A block's shared memory, in floats: Q, K, V, P, then the rows' running
// max, sum and rescale.
template <int D>
struct Smem {
  static constexpr int kLQ = D + 16;   // Q's and K's pitch: 16 mod 32
  static constexpr int kQ = kBQ * kLQ;
  static constexpr int kK = kBK * kLQ;
  static constexpr int kV = kBK * D;
  static constexpr int kP = kBQ * kLP;
  static constexpr int kFloats = kQ + kK + kV + kP + 3 * kBQ;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

// V's 16-byte chunk c of key row r sits at chunk c ^ swizzle(r). A lane
// of P V reads, from rows whose bits 2-3 are its t, the chunks 2 g + {0,
// 1} (D = 256), g (D = 128) or half of g / 2 (D = 64): these XOR masks
// put a quarter warp's (half warp's at D = 64) reads on 32 banks.
template <int D>
__device__ __forceinline__ int swizzle(int r) {
  const int q = (r >> 2) & 3;
  return D == 256 ? (q & 1) | (q & 2) << 1 : q << 1;
}

// Rows r0 .. r0 + 63 of x (a row every `stride` floats) into dst at pitch
// LD, 16 bytes a copy, rows at or past n zero-filled. Thread i copies
// chunks i % 4 + 4 e of row i / 4, so that its copies' addresses differ
// by constants from two base addresses. Where SWZ (V), chunk c lands at
// c ^ swizzle(row) = (c % 4 ^ sw % 4) + 4 (e ^ sw / 4).
template <int D, int LD, bool SWZ>
__device__ __forceinline__ void copy_tile(float* dst, const float* x, int r0,
                                          int n, long stride) {
  const int r = threadIdx.x >> 2, c0 = threadIdx.x & 3;
  const bool ok = r0 + r < n;
  const float* src = x + (ok ? (r0 + r) * stride : 0) + 4 * c0;
  const int sw = SWZ ? swizzle<D>(r) : 0;
  float* d = dst + r * LD + 4 * (c0 ^ (sw & 3));
#pragma unroll
  for (int e = 0; e < D / 16; ++e)
    copy16(d + 16 * (e ^ (sw >> 2)), src + 16 * e, ok);
}

// s = Q K^T over a key tile: warp (wm, wn) owns rows 32 wm + 16 i + {g,
// g + 8} and keys 16 wn + 8 j + {2 t, 2 t + 1}; both k8 steps of a k16
// block at once.
template <int D>
__device__ __forceinline__ void scores(float (&s)[2][2][4], const float* sQ,
                                       const float* sK, int wm, int wn, int g,
                                       int t) {
  constexpr int LD = Smem<D>::kLQ;
  const float* qa = sQ + (32 * wm + g) * LD + 4 * t;
  const float* kb = sK + (16 * wn + g) * LD + 4 * t;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[i][j][r] = 0.f;
#pragma unroll 2
  for (int d0 = 0; d0 < D; d0 += 16) {
    float4 qv[2][2], kv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        qv[i][h] = *reinterpret_cast<const float4*>(
            qa + (16 * i + 8 * h) * LD + d0);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      kv[j] = *reinterpret_cast<const float4*>(kb + 8 * j * LD + d0);
    uint32_t ab[2][2][4], as[2][2][4], bb[2][2][2], bs[2][2][2];
#pragma unroll
    for (int st = 0; st < 2; ++st) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        a_frag(qv[i][0], qv[i][1], st, ab[st][i], as[st][i]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        split(part(kv[j], 2 * st), bb[st][j][0], bs[st][j][0]);
        split(part(kv[j], 2 * st + 1), bb[st][j][1], bs[st][j][1]);
      }
    }
    mma3<2, 2, 2, 2>(s, ab, as, bb, bs, 0);
  }
}

// acc += P V over a key tile: warp (wm, wn) owns rows 32 wm + 16 i + {g,
// g + 8} and, in n8 tile j, the columns D / 4 wn + NT (2 t + c) + j, c =
// 0, 1 (fragment slots 2 t and 2 t + 1). kJG n8 tiles at a time.
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[2][D / 32][4],
                                           const float* sP, const float* sV,
                                           int wm, int wn, int g, int t) {
  constexpr int NT = D / 32;
  const float* pa = sP + (32 * wm + g) * kLP + 4 * t;
  const int col = wn * (D / 4) + NT * g;   // the lane's first column
  const int sw = swizzle<D>(4 * t);        // every row it reads has bits t
#pragma unroll 1
  for (int k0 = 0; k0 < kBK; k0 += 16) {
    float4 pv[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        pv[i][h] = *reinterpret_cast<const float4*>(
            pa + (16 * i + 8 * h) * kLP + k0);
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      uint32_t ab[1][2][4], as[1][2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        a_frag(pv[i][0], pv[i][1], st, ab[0][i], as[0][i]);
      // b0 from key row k0 + 4 t + 2 st, b1 from the next
      float vb[2][NT];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float* row = sV + (k0 + 4 * t + 2 * st + e) * D;
        if constexpr (NT >= 4) {
#pragma unroll
          for (int c = 0; c < NT / 4; ++c) {
            const float4 x = *reinterpret_cast<const float4*>(
                row + 4 * ((col / 4 + c) ^ sw));
            vb[e][4 * c] = x.x;
            vb[e][4 * c + 1] = x.y;
            vb[e][4 * c + 2] = x.z;
            vb[e][4 * c + 3] = x.w;
          }
        } else {
          const float2 x = *reinterpret_cast<const float2*>(
              row + 4 * ((col / 4) ^ sw) + col % 4);
          vb[e][0] = x.x;
          vb[e][1] = x.y;
        }
      }
#pragma unroll
      for (int j0 = 0; j0 < NT; j0 += kJG) {
        uint32_t bb[1][kJG][2], bs[1][kJG][2];
#pragma unroll
        for (int j = 0; j < kJG; ++j) {
          split(vb[0][j0 + j], bb[0][j][0], bs[0][j][0]);
          split(vb[1][j0 + j], bb[0][j][1], bs[0][j][1]);
        }
        mma3<1, 2, kJG, NT>(acc, ab, as, bb, bs, j0);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ lse, int H, int sq, int sk,
                    float scale, int causal) {
  constexpr int LQ = Smem<D>::kLQ;
  constexpr int NT = D / 32;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [kBQ][LQ]
  float* sK = sQ + Smem<D>::kQ;                  // [kBK][LQ]
  float* sV = sK + Smem<D>::kK;                  // [kBK][D], swizzled
  float* sP = sV + Smem<D>::kV;                  // [kBQ][kLP] scores, then p
  float* sM = sP + Smem<D>::kP;                  // [kBQ] running max
  float* sL = sM + kBQ;                          // [kBQ] running sum
  float* sA = sL + kBQ;                          // [kBQ] this tile's rescale

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heaviest first
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
  const int q_off = sk - sq;
  const long stride = (long)H * D;  // floats between sequence positions
  const float* qb = q + ((long)b * sq * H + h) * D;
  const float* kb = k + ((long)b * sk * H + h) * D;
  const float* vb = v + ((long)b * sk * H + h) * D;

  int n_tiles = (sk + kBK - 1) / kBK;
  if (causal) {
    const int last_key = min(sk - 1, q0 + kBQ - 1 + q_off);
    n_tiles = last_key / kBK + 1;
  }

  copy_tile<D, LQ, false>(sQ, qb, q0, sq, stride);
  copy_tile<D, LQ, false>(sK, kb, 0, sk, stride);
  commit();
  if (tid < kBQ) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }
  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    wait_prior<0>();  // this thread's copies of K (and Q) have landed
    __syncthreads();  // everyone's; and P V of the last tile is done
    copy_tile<D, D, true>(sV, vb, k0, sk, stride);
    commit();

    float s[2][2][4];
    scores<D>(s, sQ, sK, wm, wn, g, t);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 32 * wm + 16 * i + g + 8 * hr;
        const int qpos = q0 + r + q_off;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = 16 * wn + 8 * j + 2 * t;
          auto masked = [&](int e) {
            const int kpos = k0 + c + e;
            if (kpos >= sk) return -INFINITY;
            if (causal && kpos > qpos) return ptt::kMaskValue;
            return s[i][j][2 * hr + e] * scale;
          };
          *reinterpret_cast<float2*>(sP + r * kLP + c) =
              make_float2(masked(0), masked(1));
        }
      }
    __syncthreads();  // the scores are in sP; K is free
    if (kt + 1 < n_tiles) copy_tile<D, LQ, false>(sK, kb, k0 + kBK, sk, stride);
    commit();

    // online softmax: warp w owns rows 8w .. 8w+7, lane the keys lane and
    // lane + 32; the rows' reductions interleaved
    {
      constexpr int R = kBQ / 8;
      const int r0 = warp * R;
      float x0[R], x1[R], mx[R], mp[R], ps[R];
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        x0[rr] = sP[(r0 + rr) * kLP + lane];
        x1[rr] = sP[(r0 + rr) * kLP + lane + 32];
        mx[rr] = fmaxf(x0[rr], x1[rr]);
        mp[rr] = sM[r0 + rr];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int rr = 0; rr < R; ++rr)
          mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], o));
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        mx[rr] = fmaxf(mp[rr], mx[rr]);
        x0[rr] = (x0[rr] == -INFINITY) ? 0.f : expf(x0[rr] - mx[rr]);
        x1[rr] = (x1[rr] == -INFINITY) ? 0.f : expf(x1[rr] - mx[rr]);
        ps[rr] = x0[rr] + x1[rr];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int rr = 0; rr < R; ++rr)
          ps[rr] += __shfl_xor_sync(0xffffffffu, ps[rr], o);
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const int r = r0 + rr;
        sP[r * kLP + lane] = x0[rr];
        sP[r * kLP + lane + 32] = x1[rr];
        if (lane == 0) {
          const float alpha =
              (mp[rr] == -INFINITY) ? 0.f : expf(mp[rr] - mx[rr]);
          sA[r] = alpha;
          sL[r] = sL[r] * alpha + ps[rr];
          sM[r] = mx[rr];
        }
      }
    }
    wait_prior<1>();  // this thread's copies of V have landed
    __syncthreads();  // everyone's, and the probabilities

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float a = sA[32 * wm + 16 * i + g + 8 * hr];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          acc[i][j][2 * hr] *= a;
          acc[i][j][2 * hr + 1] *= a;
        }
      }
    accumulate<D>(acc, sP, sV, wm, wn, g, t);
  }
  // the last tile's sums were written before its last barrier

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 32 * wm + 16 * i + g + 8 * hr;
      if (q0 + r >= sq) continue;
      const float l = sL[r];
      const float l_safe = (l == 0.f) ? 1.f : l;
      float out[2 * NT];
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          out[NT * c + j] = acc[i][j][2 * hr + c] / l_safe;
      float* orow = o + (q0 + r) * stride + ((long)b * sq * H + h) * D +
                    wn * (D / 4) + 2 * NT * t;
#pragma unroll
      for (int c = 0; c < 2 * NT; c += 4)
        *reinterpret_cast<float4*>(orow + c) =
            make_float4(out[c], out[c + 1], out[c + 2], out[c + 3]);
    }
  if (tid < kBQ && q0 + tid < sq) {
    const float l = sL[tid];
    const float l_safe = (l == 0.f) ? 1.f : l;
    lse[(long)bh * sq + q0 + tid] = sM[tid] + logf(l_safe);
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, float* lse,
           int B, int H, int sq, int sk, float scale, int causal,
           cudaStream_t stream) {
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (sq + kBQ - 1) / kBQ);
  flash_fwd_tc_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, lse, H, sq, sk, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, sq, H, D], k/v [B, sk, H, D], o [B, sq, H, D], lse [B*H, sq]; all
// float32, contiguous, 16-byte aligned. Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_fwd_f32(const float* q, const float* k,
                                       const float* v, float* o, float* lse,
                                       int B, int H, int sq, int sk, int D,
                                       float scale, int causal, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, lse, B, H, sq, sk, scale, causal, s);
    case 128:
      return launch<128>(q, k, v, o, lse, B, H, sq, sk, scale, causal, s);
    case 256:
      return launch<256>(q, k, v, o, lse, B, H, sq, sk, scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
