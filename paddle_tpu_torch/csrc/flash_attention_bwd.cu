// Flash-attention backward for Hopper (sm_90a), float32: dQ and dK/dV.
//
// Replaces the two TPU kernels of paddle_tpu/kernels/flash_attention.py
// _flash_bwd_pallas: _bwd_dq_kernel (dQ = sum over keys of dS K, one pass
// over the key tiles per query tile) and _bwd_dkv_kernel (dV = P^T dO and
// dK = dS^T Q, one pass over the query tiles per key tile). Both recompute
// the probabilities from the forward's row logsumexp:
//   s = scale * q.k (causal entries above the bottom-right aligned diagonal
//   set to kMaskValue), p = exp(s - lse), dp = dO.v,
//   dS = p * (dp - delta) * scale, delta = rowsum(dO * O).
// This is the flash-attention-2 split the TPU kernels use: each output
// tile is owned by one block that sums over the other axis in a fixed
// order, so there are no atomics and results are identical run to run.
//
// What bounds it on the H100: operations. Per visible (query, key) pair
// the dQ kernel does 6*D flops (s, dp, dQ) and the dK/dV kernel 8*D (s,
// dp, dV, dK): 14*D, 3.5x the forward's 4*D, on the f32 CUDA cores (67
// TFLOP/s; no tensor cores in full float32), while each pass reads
// O(S*D) bytes per tile row.
//
// What the design does about it: the same 64 x 32 (query x key) score
// tile as the forward kernel, computed twice per step (s = Q K^T and
// dp = dO V^T) by a 16 x 16 thread grid with a 4 x 2 micro-tile each,
// reading shared memory as float4 from rows padded by 4 floats so that
// the column-parallel loads hit distinct banks. The dQ kernel keeps its
// 64-row Q and dO tiles and lse/delta in shared memory and the dQ
// accumulator in registers (4 rows x D/16 columns a thread), and streams
// 32-row K and V tiles up to the causal diagonal. The dK/dV kernel keeps
// its 32-row K and V tiles in shared memory and dK, dV in registers
// (2 rows x D/16 columns each a thread), and streams 64-row Q and dO
// tiles from the first one that reaches its keys. At D = 256 a kernel
// holds two 64-row and two 32-row tiles plus the P and dS tiles, 217 KB,
// above the 48 KB static limit, hence cudaFuncSetAttribute; nothing else
// fits beside it, so one block runs per SM. The ragged edge is masked as
// the forward masks it: rows past sq and keys past sk are loaded as zeros
// and get p = 0, so they add nothing and are not stored.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 32;        // key rows per tile
constexpr int kThreads = 256;  // 16 x 16 thread grid over the tiles
constexpr int kPad = 4;        // floats of padding per Q/dO/K/V row
constexpr int kLDP = kBK + 1;  // row stride of the P and dS tiles

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kBQ * (D + kPad) + 2 * kBK * (D + kPad) +
                          2 * kBQ * kLDP + 2 * kBQ);
}

// Shared-memory layout of both kernels.
template <int D>
struct Tiles {
  float* q;      // [kBQ][D + kPad]
  float* dout;   // [kBQ][D + kPad]
  float* k;      // [kBK][D + kPad]
  float* v;      // [kBK][D + kPad]
  float* p;      // [kBQ][kLDP]
  float* ds;     // [kBQ][kLDP]
  float* lse;    // [kBQ]
  float* delta;  // [kBQ]

  __device__ explicit Tiles(float* base) {
    constexpr int LD = D + kPad;
    q = base;
    dout = q + kBQ * LD;
    k = dout + kBQ * LD;
    v = k + kBK * LD;
    p = v + kBK * LD;
    ds = p + kBQ * kLDP;
    lse = ds + kBQ * kLDP;
    delta = lse + kBQ;
  }
};

// Copy rows [row0, row0 + ROWS) of a [S, H, D] head slice (row stride
// H*D floats) into a padded shared tile; rows at or past n_rows are zeros.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int n_rows,
                                          long row_stride, int tid) {
  constexpr int D4 = D / 4;
  constexpr int LD = D + kPad;
  for (int i = tid; i < ROWS * D4; i += kThreads) {
    const int r = i / D4;
    const int c = (i - r * D4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const float4*>(src + (row0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = val;
  }
}

// lse and delta of query rows [q0, q0 + kBQ) of one (batch, head); zeros
// past sq.
__device__ __forceinline__ void load_row_stats(float* s_lse, float* s_delta,
                                               const float* lse,
                                               const float* delta, int q0,
                                               int sq, int tid) {
  if (tid < kBQ) {
    const bool ok = q0 + tid < sq;
    s_lse[tid] = ok ? lse[q0 + tid] : 0.f;
    s_delta[tid] = ok ? delta[q0 + tid] : 0.f;
  }
}

// One 64 x 32 step: s = Q K^T and dp = dO V^T for the thread's rows
// ty*4 + i and key columns tx + 16j, then p and dS into shared memory.
template <int D>
__device__ __forceinline__ void probs_and_ds(const Tiles<D>& t, int q0, int k0,
                                             int sq, int sk, int q_off,
                                             float scale, int causal, int tx,
                                             int ty) {
  constexpr int LD = D + kPad;
  float s[4][2], dp[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 qv[4], ov[4], kv[2], vv[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = *reinterpret_cast<const float4*>(t.q + (ty * 4 + i) * LD + d);
      ov[i] = *reinterpret_cast<const float4*>(t.dout + (ty * 4 + i) * LD + d);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      kv[j] = *reinterpret_cast<const float4*>(t.k + (tx + 16 * j) * LD + d);
      vv[j] = *reinterpret_cast<const float4*>(t.v + (tx + 16 * j) * LD + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] = ptt::dot4(qv[i], kv[j], s[i][j]);
        dp[i][j] = ptt::dot4(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int qrow = q0 + r;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tx + 16 * j;
      const int kpos = k0 + c;
      float p = 0.f, ds = 0.f;
      if (qrow < sq && kpos < sk) {
        float val = s[i][j] * scale;
        if (causal && kpos > qrow + q_off) val = ptt::kMaskValue;
        p = expf(val - t.lse[r]);
        ds = p * (dp[i][j] - t.delta[r]) * scale;
      }
      t.p[r * kLDP + c] = p;
      t.ds[r * kLDP + c] = ds;
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
  constexpr int LD = D + kPad;
  constexpr int NJ = D / 64;  // float4 output columns per thread
  extern __shared__ float4 smem4[];
  const Tiles<D> t(reinterpret_cast<float*>(smem4));

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q_off = sk - sq;
  const long row_stride = (long)H * D;
  const float* qb = q + ((long)b * sq * H + h) * D;
  const float* ob = dout + ((long)b * sq * H + h) * D;
  const float* kb = k + ((long)b * sk * H + h) * D;
  const float* vb = v + ((long)b * sk * H + h) * D;

  load_rows<D, kBQ>(t.q, qb, q0, sq, row_stride, tid);
  load_rows<D, kBQ>(t.dout, ob, q0, sq, row_stride, tid);
  load_row_stats(t.lse, t.delta, lse + (long)bh * sq, delta + (long)bh * sq,
                 q0, sq, tid);

  float4 acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);

  // key tiles past the causal diagonal of this query tile are skipped
  int n_tiles = (sk + kBK - 1) / kBK;
  if (causal) n_tiles = min(sk - 1, q0 + kBQ - 1 + q_off) / kBK + 1;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done with K/V/dS
    load_rows<D, kBK>(t.k, kb, k0, sk, row_stride, tid);
    load_rows<D, kBK>(t.v, vb, k0, sk, row_stride, tid);
    __syncthreads();
    probs_and_ds<D>(t, q0, k0, sq, sk, q_off, scale, causal, tx, ty);
    __syncthreads();
    // dQ += dS K: rows ty*4 + i, columns tx*4 + 64j
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = t.ds[(ty * 4 + i) * kLDP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(t.k + kk * LD + tx * 4 + 64 * j);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j].x = fmaf(dsv[i], kv.x, acc[i][j].x);
          acc[i][j].y = fmaf(dsv[i], kv.y, acc[i][j].y);
          acc[i][j].z = fmaf(dsv[i], kv.z, acc[i][j].z);
          acc[i][j].w = fmaf(dsv[i], kv.w, acc[i][j].w);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= sq) continue;
    float* row = dq + ((long)b * sq * H + h) * D + (q0 + r) * row_stride;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      *reinterpret_cast<float4*>(row + tx * 4 + 64 * j) = acc[i][j];
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
  constexpr int LD = D + kPad;
  constexpr int NJ = D / 64;
  extern __shared__ float4 smem4[];
  const Tiles<D> t(reinterpret_cast<float*>(smem4));

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * kBK;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q_off = sk - sq;
  const long row_stride = (long)H * D;
  const float* qb = q + ((long)b * sq * H + h) * D;
  const float* ob = dout + ((long)b * sq * H + h) * D;
  const float* kb = k + ((long)b * sk * H + h) * D;
  const float* vb = v + ((long)b * sk * H + h) * D;
  const float* lse_bh = lse + (long)bh * sq;
  const float* delta_bh = delta + (long)bh * sq;

  load_rows<D, kBK>(t.k, kb, k0, sk, row_stride, tid);
  load_rows<D, kBK>(t.v, vb, k0, sk, row_stride, tid);

  float4 acc_k[2][NJ], acc_v[2][NJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      acc_k[i][j] = acc_v[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);

  // query tiles that end before this key tile's diagonal see none of it:
  // the first useful row is k0 - q_off (always < sq, since k0 < sk)
  const int n_q = (sq + kBQ - 1) / kBQ;
  const int first = causal ? max(0, k0 - q_off) / kBQ : 0;

  for (int qt = first; qt < n_q; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();  // the previous tile's readers are done with Q/dO/P/dS
    load_rows<D, kBQ>(t.q, qb, q0, sq, row_stride, tid);
    load_rows<D, kBQ>(t.dout, ob, q0, sq, row_stride, tid);
    load_row_stats(t.lse, t.delta, lse_bh, delta_bh, q0, sq, tid);
    __syncthreads();
    probs_and_ds<D>(t, q0, k0, sq, sk, q_off, scale, causal, tx, ty);
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q: key rows ty*2 + i, columns tx*4 + 64j
#pragma unroll 4
    for (int qq = 0; qq < kBQ; ++qq) {
      float pv[2], dsv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        pv[i] = t.p[qq * kLDP + ty * 2 + i];
        dsv[i] = t.ds[qq * kLDP + ty * 2 + i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx * 4 + 64 * j;
        const float4 ov = *reinterpret_cast<const float4*>(t.dout + qq * LD + c);
        const float4 qv = *reinterpret_cast<const float4*>(t.q + qq * LD + c);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc_v[i][j].x = fmaf(pv[i], ov.x, acc_v[i][j].x);
          acc_v[i][j].y = fmaf(pv[i], ov.y, acc_v[i][j].y);
          acc_v[i][j].z = fmaf(pv[i], ov.z, acc_v[i][j].z);
          acc_v[i][j].w = fmaf(pv[i], ov.w, acc_v[i][j].w);
          acc_k[i][j].x = fmaf(dsv[i], qv.x, acc_k[i][j].x);
          acc_k[i][j].y = fmaf(dsv[i], qv.y, acc_k[i][j].y);
          acc_k[i][j].z = fmaf(dsv[i], qv.z, acc_k[i][j].z);
          acc_k[i][j].w = fmaf(dsv[i], qv.w, acc_k[i][j].w);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty * 2 + i;
    if (k0 + r >= sk) continue;
    const long off = ((long)b * sk * H + h) * D + (k0 + r) * row_stride;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      *reinterpret_cast<float4*>(dk + off + tx * 4 + 64 * j) = acc_k[i][j];
      *reinterpret_cast<float4*>(dv + off + tx * 4 + 64 * j) = acc_v[i][j];
    }
  }
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* delta,
              float* dq, int B, int H, int sq, int sk, float scale,
              int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
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
  const size_t smem = smem_bytes<D>();
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
