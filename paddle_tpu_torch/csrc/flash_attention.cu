// Flash-attention forward for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel paddle_tpu/kernels/flash_attention.py:_flash_fwd
// (Pallas body _fwd_kernel): online-softmax attention over [B, S, H, D]
// inputs with a causal block skip, bottom-right aligned (query row i sits at
// key position i + sk - sq), returning O and the row logsumexp.
//
// What bounds it on the H100: operations. At the serving path's shapes
// (D = 256, S up to 1024, causal) each query tile does 4*D flops per visible
// (query, key) pair and reads K/V once per tile, so the f32 CUDA-core rate
// (67 TFLOP/s, no tensor cores in f32) is the roof, not the 3.35 TB/s HBM.
//
// What the design does about it: one block per (batch*head, 64-row query
// tile) keeps its Q tile, one 32-row K and V tile and the probability tile
// in shared memory (141 KB at D = 256, above the 48 KB static limit, hence
// cudaFuncSetAttribute) and walks the key tiles with the online-softmax
// recurrence, so the [S, S] score matrix never reaches device memory. Each
// thread keeps a 4x2 score micro-tile and a 4 x D/16 output micro-tile in
// registers, reading shared memory as float4 so that every load feeds 8 to
// 16 FMAs; K rows are padded by 4 floats so the column-parallel score loads
// hit distinct banks. Key tiles past the causal diagonal are never loaded.
// Unlike the TPU kernel, which takes only sequence lengths that its blocks
// divide, the ragged edge is masked here: rows past sq are computed but not
// stored, keys past sk are loaded as zeros and scored -inf. Scores above the
// diagonal get the finite kMaskValue, and a row whose sum is 0 divides by 1,
// as _fwd_kernel does.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // key rows per tile (= warp width: one lane per key)
constexpr int kThreads = 256;  // 16 x 16 thread grid over the tiles
constexpr int kPad = 4;        // floats of padding per Q/K row

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + kPad) + kBK * (D + kPad) + kBK * D +
                          kBQ * (kBK + 1) + 3 * kBQ);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int H, int sq, int sk, float scale,
                 int causal) {
  constexpr int LDQ = D + kPad;
  constexpr int LDK = D + kPad;
  constexpr int LDV = D;
  constexpr int LDP = kBK + 1;
  constexpr int D4 = D / 4;     // float4 per row
  constexpr int NJ = D / 64;    // float4 output columns per thread

  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [kBQ][LDQ]
  float* sK = sQ + kBQ * LDQ;                    // [kBK][LDK]
  float* sV = sK + kBK * LDK;                    // [kBK][LDV]
  float* sP = sV + kBK * LDV;                    // [kBQ][LDP] scores, then p
  float* sM = sP + kBQ * LDP;                    // [kBQ] running max
  float* sL = sM + kBQ;                          // [kBQ] running sum
  float* sA = sL + kBQ;                          // [kBQ] this tile's rescale

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q_off = sk - sq;
  const long row_stride = (long)H * D;  // floats between sequence positions
  const float* qb = q + ((long)b * sq * H + h) * D;
  const float* kb = k + ((long)b * sk * H + h) * D;
  const float* vb = v + ((long)b * sk * H + h) * D;

  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < kBQ * D4; i += kThreads) {
    const int r = i / D4;
    const int c = (i - r * D4) * 4;
    float4 val = zero4;
    if (q0 + r < sq)
      val = *reinterpret_cast<const float4*>(qb + (q0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(sQ + r * LDQ + c) = val;
  }
  if (tid < kBQ) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }

  float4 acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = zero4;

  int n_tiles = (sk + kBK - 1) / kBK;
  if (causal) {
    const int last_key = min(sk - 1, q0 + kBQ - 1 + q_off);
    n_tiles = last_key / kBK + 1;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's readers are done with sK/sV/sP
    for (int i = tid; i < kBK * D4; i += kThreads) {
      const int r = i / D4;
      const int c = (i - r * D4) * 4;
      float4 kv = zero4, vv = zero4;
      if (k0 + r < sk) {
        kv = *reinterpret_cast<const float4*>(kb + (k0 + r) * row_stride + c);
        vv = *reinterpret_cast<const float4*>(vb + (k0 + r) * row_stride + c);
      }
      *reinterpret_cast<float4*>(sK + r * LDK + c) = kv;
      *reinterpret_cast<float4*>(sV + r * LDV + c) = vv;
    }
    __syncthreads();

    // scores: rows ty*4 + i, key columns tx and tx + 16
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sQ + (ty * 4 + i) * LDQ + d);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        kv[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * LDK + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = ptt::dot4(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qpos = q0 + r + q_off;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        float val = s[i][j] * scale;
        if (kpos >= sk)
          val = -INFINITY;
        else if (causal && kpos > qpos)
          val = ptt::kMaskValue;
        sP[r * LDP + c] = val;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows 8w .. 8w+7, lane = key column
#pragma unroll
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * (kBQ / 8) + rr;
      const float x = sP[r * LDP + lane];
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, ptt::warp_max(x));
      const float p = (x == -INFINITY) ? 0.f : expf(x - m_new);
      const float psum = ptt::warp_sum(p);
      sP[r * LDP + lane] = p;
      if (lane == 0) {
        const float alpha = (m_prev == -INFINITY) ? 0.f : expf(m_prev - m_new);
        sA[r] = alpha;
        sL[r] = sL[r] * alpha + psum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v: rows ty*4 + i, columns tx*4 + 64*j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sA[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[i][j].x *= a;
        acc[i][j].y *= a;
        acc[i][j].z *= a;
        acc[i][j].w *= a;
      }
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 vv =
            *reinterpret_cast<const float4*>(sV + kk * LDV + tx * 4 + 64 * j);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j].x = fmaf(pv[i], vv.x, acc[i][j].x);
          acc[i][j].y = fmaf(pv[i], vv.y, acc[i][j].y);
          acc[i][j].z = fmaf(pv[i], vv.z, acc[i][j].z);
          acc[i][j].w = fmaf(pv[i], vv.w, acc[i][j].w);
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= sq) continue;
    const float l = sL[r];
    const float l_safe = (l == 0.f) ? 1.f : l;
    float* orow = o + ((long)b * sq * H + h) * D + (q0 + r) * row_stride;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float4 out;
      out.x = acc[i][j].x / l_safe;
      out.y = acc[i][j].y / l_safe;
      out.z = acc[i][j].z / l_safe;
      out.w = acc[i][j].w / l_safe;
      *reinterpret_cast<float4*>(orow + tx * 4 + 64 * j) = out;
    }
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
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(q, k, v, o, lse, H,
                                                         sq, sk, scale, causal);
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
