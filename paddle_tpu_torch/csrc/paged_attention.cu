// Paged decode attention for Hopper (sm_90a), float32 and bfloat16.
//
// Replaces the TPU kernel paddle_tpu/kernels/flash_attention.py:
// _paged_attention_pallas (Pallas body _paged_kernel): one query token per
// slot attends to its own keys, which live in fixed-size pages of a shared
// pool and are found through the slot's block table. Keys at or past the
// slot's context length are skipped, a table id out of range reads the
// null block 0, and a slot of length 0 (an idle slot) writes zeros.
//
// What bounds it on the H100: bytes. A decode step does 4*D flops per cached
// key while reading 2*D*4 bytes of K and V for it, so at 3.35 TB/s the pool
// read is the roof: 16.6 us for 8 slots of 3382 keys in all at H 8, D 256
// (55.5 MB). Two things stand between a kernel and that roof: the card's
// 132 SMs must all be reading whatever the slots' lengths are, and each SM
// must keep about 25 KB or more in flight (Little's law at ~1 us).
//
// What the design does about it (the flash-decoding split):
//  * Split each slot's keys. The grid is (slot, head, split), one
//    dimension: block b owns the P consecutive key positions
//    [split * P, split * P + P) of its (slot, head), where P and the number
//    of splits, ceil(MB * BS / P), come from the tensors' shapes alone (the
//    host never reads the lengths). A block whose split starts at or past
//    its slot's length returns at once; a long slot is read by many SMs.
//  * Read K and V in one pass with no block barrier in the key loop. Each
//    warp takes kInFlight consecutive keys a round, issues all their K and
//    V loads (float4, streaming, 1 KB a row at D 256) before it uses any,
//    then carries its own online softmax: the running max m, the running
//    sum l, and acc for the lane's D / 32 columns. The scores are warp
//    reductions (a lane's fmaf chain, then ptt::warp_sum).
//  * The warps' states merge in warp order through shared memory into the
//    block's partial (m, l, acc[D]). A slot with one live split writes its
//    output there; otherwise the block writes its partial to the scratch,
//    takes a ticket for its (slot, head) with an integer fetch_add of
//    acquire-release order (no full fence), and the block that draws the
//    last ticket reads the live splits' partials eight at a time, all in
//    flight together, rescales and adds them in split order, divides by l
//    (by 1 where l = 0), writes out, and sets the ticket back to 0 for the
//    next call on the stream. No float atomics: two calls give the same
//    bits. One launch a call.
//
// bfloat16 (q, the pools and the output; the TPU kernel's bf16 inputs,
// which a decode step under Float16Transpiler feeds it): the same kernel
// on the element type. A lane loads its D / 32 contiguous values of a K
// or V row in one vector (16 bytes, 8 values, at D 256; 8 bytes at D 128)
// and widens them to float32 as it uses them; the scores, the online
// softmax, P.V, the partials in the scratch and their combine are the
// float32 kernel's, and each output value is rounded once to bfloat16, to
// nearest with ties to even, as the Pallas kernel rounds acc / l to q's
// dtype. The pools' bytes are half the float32 kernel's, and so is its
// bound.
#include <cuda/atomic>

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

typedef uint16_t bf16;  // the bits of one bfloat16

// the pools' rows are read once: streaming loads; q is read by every split
template <class V>
__device__ __forceinline__ V ld(const V* p, bool stream) {
  return stream ? __ldcs(p) : *p;
}

// rounded to nearest, ties to even; a NaN stays a (quiet) NaN
__device__ __forceinline__ uint32_t narrow_bf16(float x) {
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (u >> 16) | 0x40u;
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

// One D-wide row of element type T spread over a warp: a lane holds C =
// D / 32 of its values, as Raw when loaded and as float32 once widened.
// col4(lane, j) is the float4 column (values 4 col4 .. 4 col4 + 3 of the
// row) of the lane's values 4 j .. 4 j + 3.
template <class T, int D>
struct Row;

template <int D>
struct Row<float, D> {
  static constexpr int C = D / 32;
  struct Raw {
    float4 v[D / 128];
  };
  __device__ static int col4(int lane, int j) { return lane + 32 * j; }
  __device__ static Raw load(const float* row, int lane, bool stream) {
    const float4* r = reinterpret_cast<const float4*>(row);
    Raw out;
#pragma unroll
    for (int w = 0; w < D / 128; ++w) out.v[w] = ld(r + lane + 32 * w, stream);
    return out;
  }
  __device__ static Raw zero() {
    Raw out;
#pragma unroll
    for (int w = 0; w < D / 128; ++w)
      out.v[w] = make_float4(0.f, 0.f, 0.f, 0.f);
    return out;
  }
  __device__ static void widen(const Raw& r, float (&x)[C]) {
#pragma unroll
    for (int w = 0; w < D / 128; ++w) {
      x[4 * w] = r.v[w].x;
      x[4 * w + 1] = r.v[w].y;
      x[4 * w + 2] = r.v[w].z;
      x[4 * w + 3] = r.v[w].w;
    }
  }
  __device__ static void store4(float* row, int c, float4 v) {
    reinterpret_cast<float4*>(row)[c] = v;
  }
};

template <int D>
struct Row<bf16, D> {
  static constexpr int C = D / 32;
  static_assert(C == 4 || C == 8, "bf16 rows are 128 or 256 wide");
  // one 16-byte load at D 256, one 8-byte load at D 128
  struct Raw {
    uint32_t w[C / 2];
  };
  __device__ static int col4(int lane, int j) { return lane * (C / 4) + j; }
  __device__ static Raw load(const bf16* row, int lane, bool stream) {
    Raw out;
    if constexpr (C == 8) {
      const uint4 r = ld(reinterpret_cast<const uint4*>(row) + lane, stream);
      out.w[0] = r.x;
      out.w[1] = r.y;
      out.w[2] = r.z;
      out.w[3] = r.w;
    } else {
      const uint2 r = ld(reinterpret_cast<const uint2*>(row) + lane, stream);
      out.w[0] = r.x;
      out.w[1] = r.y;
    }
    return out;
  }
  __device__ static Raw zero() {
    Raw out;
#pragma unroll
    for (int k = 0; k < C / 2; ++k) out.w[k] = 0u;
    return out;
  }
  __device__ static void widen(const Raw& r, float (&x)[C]) {
#pragma unroll
    for (int k = 0; k < C / 2; ++k) {
      x[2 * k] = __uint_as_float(r.w[k] << 16);
      x[2 * k + 1] = __uint_as_float(r.w[k] & 0xffff0000u);
    }
  }
  __device__ static void store4(bf16* row, int c, float4 v) {
    reinterpret_cast<uint2*>(row)[c] =
        make_uint2(narrow_bf16(v.x) | narrow_bf16(v.y) << 16,
                   narrow_bf16(v.z) | narrow_bf16(v.w) << 16);
  }
};

constexpr int kWarps = 4;     // warps a block
constexpr int kThreads = kWarps * 32;
// keys a warp loads before it uses any: at 4 or 8 the register cap below
// spills and a call takes 1.4-2.8x as long; 1 runs within 2% of 2
// (scripts/torch_paged_decode_probe.py)
constexpr int kInFlight = 2;
constexpr int kCombine = 8;  // partials the combining block reads at once
// at most 64 registers a thread: 8 blocks an SM, so that the 1024 blocks
// of 8 slots x 8 heads x 16 splits are resident at once (uncapped, 72
// registers, 7 blocks an SM: 6% slower where every slot holds 1024 keys)
constexpr int kBlocksPerSM = 8;

template <class T, int D>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                   const T* __restrict__ v_pool,
                   const int* __restrict__ block_tables,
                   const int* __restrict__ context_lens,
                   T* __restrict__ out, int* __restrict__ tickets,
                   float* __restrict__ part, int H, int NB, int BS, int MB,
                   int P, int n_split, float scale) {
  using R = Row<T, D>;
  constexpr int C = R::C;  // values of one row a lane
  constexpr int U = kInFlight;

  const int split = blockIdx.x % n_split;
  const int sh = blockIdx.x / n_split;  // slot * H + head
  const int slot = sh / H;
  const int h = sh % H;
  const int ctx = min(max(context_lens[slot], 0), MB * BS);
  const int k0 = split * P;
  T* orow = out + (long)sh * D;
  if (ctx == 0) {  // an idle slot: split 0 writes zeros
    if (split == 0)
      for (int i = threadIdx.x; i < D / 4; i += kThreads)
        R::store4(orow, i, make_float4(0.f, 0.f, 0.f, 0.f));
    return;
  }
  if (k0 >= ctx) return;  // past the slot's keys
  const int k1 = min(k0 + P, ctx);
  const int n_live = (ctx + P - 1) / P;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long row_stride = (long)H * D;
  const long page_stride = (long)BS * row_stride;
  const int* table = block_tables + (long)slot * MB;

  float qv[C], acc[C];
  R::widen(R::load(q + (long)sh * D, lane, false), qv);
#pragma unroll
  for (int i = 0; i < C; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int j0 = k0 + warp * U; j0 < k1; j0 += kWarps * U) {
    typename R::Raw kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pos = j0 + u;
      if (pos < k1) {
        int blk = table[pos / BS];
        // an out-of-range id reads the null block instead of stray memory
        if (blk < 0 || blk >= NB) blk = 0;
        const long off =
            blk * page_stride + (pos % BS) * row_stride + (long)h * D;
        kr[u] = R::load(k_pool + off, lane, true);
        vr[u] = R::load(v_pool + off, lane, true);
      } else {
        kr[u] = vr[u] = R::zero();
      }
    }
    float s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kx[C];
      R::widen(kr[u], kx);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < C; ++i) dot = fmaf(qv[i], kx[i], dot);
      s[u] = dot;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) s[u] = ptt::warp_sum(s[u]) * scale;
    float cm = -INFINITY;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (j0 + u < k1) cm = fmaxf(cm, s[u]);
    const float m_new = fmaxf(m, cm);
    const float alpha = (m == -INFINITY) ? 0.f : expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < C; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float p = (j0 + u < k1) ? expf(s[u] - m_new) : 0.f;
      l += p;
      float vx[C];
      R::widen(vr[u], vx);
#pragma unroll
      for (int i = 0; i < C; ++i) acc[i] = fmaf(p, vx[i], acc[i]);
    }
    m = m_new;
  }

  // the warps' states, merged in warp order into the block's partial
  __shared__ float4 s_acc[kWarps][D / 4];
  __shared__ float s_m[kWarps], s_l[kWarps];
  __shared__ int s_last;
#pragma unroll
  for (int j = 0; j < C / 4; ++j)
    s_acc[warp][R::col4(lane, j)] = make_float4(
        acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  __syncthreads();
  float bm = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) bm = fmaxf(bm, s_m[w]);
  float bl = 0.f;
  float4 ba = make_float4(0.f, 0.f, 0.f, 0.f);
  const int c = threadIdx.x;  // the float4 column this thread merges
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    // a warp that held no key has m = -inf: its factor is 0
    const float f = (s_m[w] == -INFINITY) ? 0.f : expf(s_m[w] - bm);
    bl = fmaf(s_l[w], f, bl);
    if (c < D / 4) {
      const float4 a = s_acc[w][c];
      ba.x = fmaf(a.x, f, ba.x);
      ba.y = fmaf(a.y, f, ba.y);
      ba.z = fmaf(a.z, f, ba.z);
      ba.w = fmaf(a.w, f, ba.w);
    }
  }
  if (n_live == 1) {  // the slot's only live split: the output itself
    if (c < D / 4) {
      const float d = (bl == 0.f) ? 1.f : bl;
      R::store4(orow, c, make_float4(ba.x / d, ba.y / d, ba.z / d, ba.w / d));
    }
    return;
  }

  // the partial to the scratch, then a ticket; the last block combines
  const long n_pairs = gridDim.x / n_split;
  float4* pacc = reinterpret_cast<float4*>(part) + (long)sh * n_split * (D / 4);
  float* pml = part + n_pairs * n_split * D + 2L * sh * n_split;
  if (c < D / 4) pacc[(long)split * (D / 4) + c] = ba;
  if (c == 0) {
    pml[2 * split] = bm;
    pml[2 * split + 1] = bl;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // release: the block's partial, ordered before by the barrier, is
    // visible before its ticket; acquire: the other splits' partials are
    // visible to the block that draws the last one (and, past the barrier
    // below, to all its threads)
    cuda::atomic_ref<int, cuda::thread_scope_device> ticket(tickets[sh]);
    s_last = ticket.fetch_add(1, cuda::memory_order_acq_rel) == n_live - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // the live splits' partials kCombine at a time, all their reads in
  // flight together (the columns' into registers, the (m, l) pairs, which
  // lie together, into shared memory), added in split order with an online
  // rescale; a live split holds a key, so its m is finite, and past n_live
  // m = -inf adds 0
  __shared__ float s_ml[2 * kCombine];
  float gm = -INFINITY, gl = 0.f;
  float4 ga = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i0 = 0; i0 < n_live; i0 += kCombine) {
    float4 ai[kCombine];
#pragma unroll
    for (int j = 0; j < kCombine; ++j)
      ai[j] = (i0 + j < n_live && c < D / 4)
                  ? __ldcg(pacc + (long)(i0 + j) * (D / 4) + c)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    if (threadIdx.x < 2 * kCombine) {
      const bool live = i0 + threadIdx.x / 2 < n_live;
      const bool is_m = (threadIdx.x & 1) == 0;
      s_ml[threadIdx.x] = live ? __ldcg(pml + 2 * i0 + threadIdx.x)
                               : (is_m ? -INFINITY : 0.f);
    }
    __syncthreads();
    float cm = gm;
#pragma unroll
    for (int j = 0; j < kCombine; ++j) cm = fmaxf(cm, s_ml[2 * j]);
    const float alpha = (gm == -INFINITY) ? 0.f : expf(gm - cm);
    gl *= alpha;
    ga.x *= alpha;
    ga.y *= alpha;
    ga.z *= alpha;
    ga.w *= alpha;
#pragma unroll
    for (int j = 0; j < kCombine; ++j) {
      const float f = expf(s_ml[2 * j] - cm);
      gl = fmaf(s_ml[2 * j + 1], f, gl);
      ga.x = fmaf(ai[j].x, f, ga.x);
      ga.y = fmaf(ai[j].y, f, ga.y);
      ga.z = fmaf(ai[j].z, f, ga.z);
      ga.w = fmaf(ai[j].w, f, ga.w);
    }
    gm = cm;
    __syncthreads();  // s_ml is rewritten by the next chunk
  }
  if (c < D / 4) {
    const float d = (gl == 0.f) ? 1.f : gl;
    R::store4(orow, c, make_float4(ga.x / d, ga.y / d, ga.z / d, ga.w / d));
  }
  if (threadIdx.x == 0) tickets[sh] = 0;
}

template <class T, int D>
int launch(const T* q, const T* k_pool, const T* v_pool,
           const int* block_tables, const int* context_lens, T* out,
           int* tickets, float* part, int S, int H, int NB, int BS, int MB,
           int P, float scale, cudaStream_t stream) {
  const int n_split = (MB * BS + P - 1) / P;
  const long blocks = (long)S * H * n_split;
  if (P < 1 || blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  paged_split_kernel<T, D><<<(unsigned)blocks, kThreads, 0, stream>>>(
      q, k_pool, v_pool, block_tables, context_lens, out, tickets, part, H,
      NB, BS, MB, P, n_split, scale);
  return (int)cudaGetLastError();
}

template <class T>
int dispatch(const T* q, const T* k_pool, const T* v_pool,
             const int* block_tables, const int* context_lens, T* out,
             int* tickets, float* part, int S, int H, int D, int NB, int BS,
             int MB, int P, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 128:
      return launch<T, 128>(q, k_pool, v_pool, block_tables, context_lens,
                            out, tickets, part, S, H, NB, BS, MB, P, scale,
                            s);
    case 256:
      return launch<T, 256>(q, k_pool, v_pool, block_tables, context_lens,
                            out, tickets, part, S, H, NB, BS, MB, P, scale,
                            s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [S, H, D], k_pool/v_pool [NB, BS, H, D], out [S, H, D] float32;
// block_tables [S, MB] and context_lens [S] int32; all contiguous, the
// float tensors 16-byte aligned. P: keys a split (a block), n_split =
// ceil(MB * BS / P). tickets: S * H ints, 0 before the call and 0 after
// it; part: S * H * n_split * (D + 2) floats, 16-byte aligned. Returns a
// cudaError_t (0 = launched).
extern "C" int paged_decode_attention_f32(const float* q, const float* k_pool,
                                          const float* v_pool,
                                          const int* block_tables,
                                          const int* context_lens, float* out,
                                          int* tickets, float* part, int S,
                                          int H, int D, int NB, int BS, int MB,
                                          int P, float scale, void* stream) {
  return dispatch<float>(q, k_pool, v_pool, block_tables, context_lens, out,
                         tickets, part, S, H, D, NB, BS, MB, P, scale,
                         stream);
}

// As paged_decode_attention_f32 with q, the pools and out bfloat16 (their
// bits as uint16); the scratch is float32 as there.
extern "C" int paged_decode_attention_bf16(const bf16* q, const bf16* k_pool,
                                           const bf16* v_pool,
                                           const int* block_tables,
                                           const int* context_lens, bf16* out,
                                           int* tickets, float* part, int S,
                                           int H, int D, int NB, int BS,
                                           int MB, int P, float scale,
                                           void* stream) {
  return dispatch<bf16>(q, k_pool, v_pool, block_tables, context_lens, out,
                        tickets, part, S, H, D, NB, BS, MB, P, scale, stream);
}
