// Paged decode attention for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel paddle_tpu/kernels/flash_attention.py:
// _paged_attention_pallas (Pallas body _paged_kernel): one query token per
// slot attends to its own keys, which live in fixed-size pages of a shared
// pool and are found through the slot's block table. Keys at or past the
// slot's context length are skipped, and a slot of length 0 (an idle slot,
// whose table points at the null block 0) writes zeros.
//
// What bounds it on the H100: bytes. A decode step does 4*D flops per cached
// key while reading 2*D*4 bytes of K and V for it, so at 3.35 TB/s the pool
// read is the roof; for 8 slots x 1024 keys x 8 heads x D = 256 that is
// about 134 MB per layer call.
//
// What the design does about it: each block owns one (slot, head), so each
// cached K/V row is read exactly once, in place, through the block table;
// nothing is gathered into a copy (the gather-based XLA fallback does, and
// the decode step's profile in docs/performance.md blames it). Keys are
// walked in chunks of 64: each warp first issues the loads of all its
// chunk keys (two float4 per lane per key at D = 256) before reducing any of
// them, so a block keeps 64 KB of K reads in flight, and the V pass has
// every thread stream one float column of each row, coalesced. The
// online-softmax recurrence across chunks follows _paged_kernel: the
// running max, the running sum and the output column stay in registers,
// and a zero sum divides by 1.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kChunk = 64;  // keys per chunk

template <int D>
__global__ void __launch_bounds__(D)
paged_decode_kernel(const float* __restrict__ q,
                    const float* __restrict__ k_pool,
                    const float* __restrict__ v_pool,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ context_lens,
                    float* __restrict__ out, int NB, int BS, int MB,
                    float scale) {
  constexpr int NW = D / 32;            // warps per block
  constexpr int KPW = kChunk / NW;      // chunk keys per warp
  constexpr int V4 = D / 128;           // float4 of one row per lane

  __shared__ long s_row[kChunk];   // pool offset (floats) of each chunk key
  __shared__ float s_score[kChunk];
  __shared__ float s_p[kChunk];

  const int slot = blockIdx.x;
  const int h = blockIdx.y;
  const int H = gridDim.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long row_stride = (long)H * D;
  const long page_stride = (long)BS * row_stride;

  const float4* qrow =
      reinterpret_cast<const float4*>(q + ((long)slot * H + h) * D);
  float4 qv[V4];
#pragma unroll
  for (int u = 0; u < V4; ++u) qv[u] = qrow[lane + 32 * u];

  const int ctx = min(max(context_lens[slot], 0), MB * BS);
  const int* table = block_tables + (long)slot * MB;
  float m = -INFINITY, l = 0.f, acc = 0.f;

  for (int c0 = 0; c0 < ctx; c0 += kChunk) {
    const int nk = min(kChunk, ctx - c0);
    if (tid < kChunk) {
      long off = 0;
      if (tid < nk) {
        const int pos = c0 + tid;
        int blk = table[pos / BS];
        // an out-of-range id reads the null block instead of stray memory
        if (blk < 0 || blk >= NB) blk = 0;
        off = blk * page_stride + (pos % BS) * row_stride + (long)h * D;
      }
      s_row[tid] = off;
    }
    __syncthreads();

    // scores: warp w takes keys w, w + NW, ...; all loads before any reduce
    float4 kreg[KPW][V4];
#pragma unroll
    for (int t = 0; t < KPW; ++t) {
      const int j = warp + t * NW;
      const float4* krow = reinterpret_cast<const float4*>(k_pool + s_row[j]);
#pragma unroll
      for (int u = 0; u < V4; ++u)
        kreg[t][u] = (j < nk) ? krow[lane + 32 * u]
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int t = 0; t < KPW; ++t) {
      float part = 0.f;
#pragma unroll
      for (int u = 0; u < V4; ++u) part = ptt::dot4(qv[u], kreg[t][u], part);
      part = ptt::warp_sum(part);
      const int j = warp + t * NW;
      if (lane == 0) s_score[j] = (j < nk) ? part * scale : -INFINITY;
    }
    __syncthreads();

    // every thread derives the same chunk max; the first 64 write p
    float cm = -INFINITY;
    for (int j = 0; j < nk; ++j) cm = fmaxf(cm, s_score[j]);
    const float m_new = fmaxf(m, cm);
    const float alpha = (m == -INFINITY) ? 0.f : expf(m - m_new);
    if (tid < kChunk) s_p[tid] = (tid < nk) ? expf(s_score[tid] - m_new) : 0.f;
    __syncthreads();

    // acc = acc * alpha + p @ v: thread tid owns output column tid
    float a = 0.f, psum = 0.f;
#pragma unroll 16
    for (int j = 0; j < kChunk; ++j) {
      if (j < nk) {
        const float p = s_p[j];
        a = fmaf(p, v_pool[s_row[j] + tid], a);
        psum += p;
      }
    }
    acc = acc * alpha + a;
    l = l * alpha + psum;
    m = m_new;
    __syncthreads();  // s_row / s_score / s_p are rewritten by the next chunk
  }
  const float l_safe = (l == 0.f) ? 1.f : l;
  out[((long)slot * H + h) * D + tid] = acc / l_safe;
}

template <int D>
int launch(const float* q, const float* k_pool, const float* v_pool,
           const int* block_tables, const int* context_lens, float* out, int S,
           int H, int NB, int BS, int MB, float scale, cudaStream_t stream) {
  const dim3 grid(S, H);
  paged_decode_kernel<D><<<grid, D, 0, stream>>>(
      q, k_pool, v_pool, block_tables, context_lens, out, NB, BS, MB, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [S, H, D], k_pool/v_pool [NB, BS, H, D], out [S, H, D] float32;
// block_tables [S, MB] and context_lens [S] int32; all contiguous, the
// float tensors 16-byte aligned. Returns a cudaError_t (0 = launched).
extern "C" int paged_decode_attention_f32(const float* q, const float* k_pool,
                                          const float* v_pool,
                                          const int* block_tables,
                                          const int* context_lens, float* out,
                                          int S, int H, int D, int NB, int BS,
                                          int MB, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 128:
      return launch<128>(q, k_pool, v_pool, block_tables, context_lens, out, S,
                         H, NB, BS, MB, scale, s);
    case 256:
      return launch<256>(q, k_pool, v_pool, block_tables, context_lens, out, S,
                         H, NB, BS, MB, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
