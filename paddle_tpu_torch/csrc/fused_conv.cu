// Conv-epilogue kernels for Hopper (sm_90a), float32.
//
// Replace the TPU kernels of paddle_tpu/kernels/fused_conv.py:
//   channel_stats (Pallas body _stats_kernel): per-channel sum and sum of
//     squares of a raw conv output a [N, C, S] (S = H*W), over the batch
//     and the image;
//   apply_epilogue (_apply_kernel): y = a * scale[c] + shift[c], then ReLU
//     if asked;
//   apply_epilogue with an addend (_apply_add_kernel): y = a * scale[c] +
//     shift[c] + addend, then ReLU if asked.
//
// What bounds them on the H100: bytes. They do 2 to 4 flops per element
// and move 4 (stats), 8 (apply) or 12 (apply with an addend) bytes for it,
// so the reads and writes at 3.35 TB/s are the roof: at the ResNet-50 stem,
// [128, 64, 112, 112], stats reads 411 MB (0.123 ms) and apply moves
// 822 MB (0.245 ms).
//
// What the design does about it. The TPU kernel holds a whole image in
// VMEM and walks the batch as a sequential grid, carrying the sums from
// step to step; an SM cannot hold an image, and blocks run in no order.
// So every kernel here walks rows: a row is one (n, c) plane of S
// contiguous floats, and a warp takes one row at a time, reading it as
// float4 where it can. S = 49 and 196 are not multiples of 4, so a row can
// start in the middle of a 16-byte vector: a scalar head up to the next
// 16-byte boundary, float4 through the middle, a scalar tail (the base
// pointers are 16-byte aligned; the wrappers check it). Apply reads each
// element once and writes it once, and loads its channel's scale and
// shift once per row. Stats is deterministic, with no atomics: block
// (c, p) sums the rows of channel c in batch slice p in a fixed order
// (each lane, then a fixed shuffle tree, then the warps in order) into one
// partial, and a second small kernel adds each channel's partials in
// order. Slicing the batch gives C x P blocks: at the stem, 64 channels
// alone would fill only 64 of the 132 SMs.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

// A row of S floats at float offset `off` from a 16-byte aligned base:
// `head` scalars up to the first 16-byte boundary, `nvec` float4, then
// `tail` scalars.
struct RowSplit {
  int head, nvec, tail;
};

__device__ __forceinline__ RowSplit split_row(long off, int S) {
  RowSplit r;
  r.head = min(S, (int)((4 - (off & 3)) & 3));
  r.nvec = (S - r.head) >> 2;
  r.tail = S - r.head - 4 * r.nvec;
  return r;
}

__device__ __forceinline__ void acc(float v, float& s1, float& s2) {
  s1 += v;
  s2 = fmaf(v, v, s2);
}

// Partial sums of channel blockIdx.x over the rows of batch slice
// blockIdx.y: part[0][c][p] = sum, part[1][c][p] = sum of squares.
__global__ void __launch_bounds__(kThreads)
stats_partial_kernel(const float* __restrict__ a, float* __restrict__ part,
                     int N, int C, int S, int rows_per, int P) {
  const int c = blockIdx.x;
  const int p = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_end = min(N, (p + 1) * rows_per);
  float s1 = 0.f, s2 = 0.f;
  for (int n = p * rows_per + warp; n < n_end; n += kWarps) {
    const long off = ((long)n * C + c) * S;
    const float* row = a + off;
    const RowSplit r = split_row(off, S);
    if (lane < r.head) acc(row[lane], s1, s2);
    const float4* body = reinterpret_cast<const float4*>(row + r.head);
    for (int i = lane; i < r.nvec; i += 32) {
      const float4 v = body[i];
      acc(v.x, s1, s2);
      acc(v.y, s1, s2);
      acc(v.z, s1, s2);
      acc(v.w, s1, s2);
    }
    if (lane < r.tail) acc(row[r.head + 4 * r.nvec + lane], s1, s2);
  }
  s1 = ptt::warp_sum(s1);
  s2 = ptt::warp_sum(s2);
  __shared__ float sh[2][kWarps];
  if (lane == 0) {
    sh[0][warp] = s1;
    sh[1][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t1 = 0.f, t2 = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      t1 += sh[0][w];
      t2 += sh[1][w];
    }
    part[(long)c * P + p] = t1;
    part[((long)C + c) * P + p] = t2;
  }
}

// out[0][c] and out[1][c]: each channel's partials added in slice order.
__global__ void stats_final_kernel(const float* __restrict__ part,
                                   float* __restrict__ out, int C, int P) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float t1 = 0.f, t2 = 0.f;
  for (int p = 0; p < P; ++p) {
    t1 += part[(long)c * P + p];
    t2 += part[((long)C + c) * P + p];
  }
  out[c] = t1;
  out[C + c] = t2;
}

template <bool ADD, bool RELU>
__device__ __forceinline__ float epi(float v, float sc, float sh, float d) {
  float o = fmaf(v, sc, sh);
  if constexpr (ADD) o += d;
  if constexpr (RELU) o = fmaxf(o, 0.f);
  return o;
}

// y = a * scale[c] + shift[c] (+ addend) (ReLU), one warp per (n, c) row,
// the warps of the grid striding over the N * C rows.
template <bool ADD, bool RELU>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const float* __restrict__ a, const float* __restrict__ addend,
             const float* __restrict__ scale, const float* __restrict__ shift,
             float* __restrict__ y, int C, int S, long rows) {
  const int lane = threadIdx.x & 31;
  const long stride = (long)gridDim.x * kWarps;
  for (long r = (long)blockIdx.x * kWarps + (threadIdx.x >> 5); r < rows;
       r += stride) {
    const int c = (int)(r % C);
    const float sc = scale[c], sh = shift[c];
    const long off = r * S;
    const RowSplit rs = split_row(off, S);
    const float* ar = a + off;
    float* yr = y + off;
    const float* dr = ADD ? addend + off : nullptr;
    if (lane < rs.head)
      yr[lane] = epi<ADD, RELU>(ar[lane], sc, sh, ADD ? dr[lane] : 0.f);
    const float4* av = reinterpret_cast<const float4*>(ar + rs.head);
    float4* yv = reinterpret_cast<float4*>(yr + rs.head);
    for (int i = lane; i < rs.nvec; i += 32) {
      const float4 v = av[i];
      float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (ADD) d = reinterpret_cast<const float4*>(dr + rs.head)[i];
      float4 o;
      o.x = epi<ADD, RELU>(v.x, sc, sh, d.x);
      o.y = epi<ADD, RELU>(v.y, sc, sh, d.y);
      o.z = epi<ADD, RELU>(v.z, sc, sh, d.z);
      o.w = epi<ADD, RELU>(v.w, sc, sh, d.w);
      yv[i] = o;
    }
    if (lane < rs.tail) {
      const int j = rs.head + 4 * rs.nvec + lane;
      yr[j] = epi<ADD, RELU>(ar[j], sc, sh, ADD ? dr[j] : 0.f);
    }
  }
}

template <bool ADD>
int launch_apply(const float* a, const float* addend, const float* scale,
                 const float* shift, float* y, int N, int C, int S, int relu,
                 int grid, cudaStream_t s) {
  if (N <= 0 || C <= 0 || S <= 0 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  const long rows = (long)N * C;
  if (relu)
    apply_kernel<ADD, true><<<grid, kThreads, 0, s>>>(a, addend, scale, shift,
                                                      y, C, S, rows);
  else
    apply_kernel<ADD, false><<<grid, kThreads, 0, s>>>(a, addend, scale,
                                                       shift, y, C, S, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// a [N, C, S] float32, contiguous, 16-byte aligned; part [2, C, P] and
// out [2, C] float32 scratch and result; batch slice p holds rows
// [p * rows_per, min(N, (p + 1) * rows_per)). Launches the partial and the
// final kernel on `stream`. Returns a cudaError_t (0 = launched).
extern "C" int fused_conv_channel_stats_f32(const float* a, float* part,
                                            float* out, int N, int C, int S,
                                            int rows_per, int P,
                                            void* stream) {
  if (N <= 0 || C <= 0 || S <= 0 || rows_per <= 0 || P <= 0 || P > 65535 ||
      (long)rows_per * P < N)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  stats_partial_kernel<<<dim3(C, P), kThreads, 0, s>>>(a, part, N, C, S,
                                                       rows_per, P);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  stats_final_kernel<<<(C + 255) / 256, 256, 0, s>>>(part, out, C, P);
  return (int)cudaGetLastError();
}

// a, y [N, C, S]; scale, shift [C]; all float32, contiguous, 16-byte
// aligned. relu: 0 or 1. grid: blocks of 256 threads (8 warps, one row
// each at a time).
extern "C" int fused_conv_apply_f32(const float* a, const float* scale,
                                    const float* shift, float* y, int N,
                                    int C, int S, int relu, int grid,
                                    void* stream) {
  return launch_apply<false>(a, nullptr, scale, shift, y, N, C, S, relu, grid,
                             static_cast<cudaStream_t>(stream));
}

// As fused_conv_apply_f32, plus the residual addend [N, C, S].
extern "C" int fused_conv_apply_add_f32(const float* a, const float* addend,
                                        const float* scale, const float* shift,
                                        float* y, int N, int C, int S,
                                        int relu, int grid, void* stream) {
  return launch_apply<true>(a, addend, scale, shift, y, N, C, S, relu, grid,
                            static_cast<cudaStream_t>(stream));
}
