// Asynchronous copies and the 3xTF32 tensor-core product of the attention
// kernels (csrc/flash_attention.cu, csrc/flash_attention_bwd.cu) and the
// LSTM's sequence kernels and products (csrc/fused_lstm.cu).
//
// A copy of csrc/conv3x3_tc.cuh's helpers, so that those libraries build
// without the bottleneck chain's headers; conv3x3_tc.cuh keeps its own.
// The products are mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32
// in 3xTF32: each operand x splits into big = x rounded to TF32 and small
// = x - big, and each k8 step's products small.big, big.small, big.big of
// a tile go into a fresh fragment, added into the float32 accumulators
// with float32 adds (the tensor cores truncate as they accumulate:
// PERF.md, lesson 7).
//
// Wide fragment reads: within each k16 block the product's k order is
// permuted (step s, slot t <- element 4 t + 2 s; slot t + 4 <- 4 t + 2 s
// + 1), so that a lane's A values of two k8 steps are 4 consecutive
// floats of one row, one 16-byte read (a_frag below).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// ---- asynchronous copies and the tensor-core product -----------------------
__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes, bypassing L1; zero-filled unless ok.
__device__ __forceinline__ void copy16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
// 4 bytes, through L1 (.cg copies 16 bytes only); zero-filled unless ok.
__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N of this thread's groups of copies are in flight.
template <int N>
__device__ __forceinline__ void wait_prior() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// big = x rounded to TF32 (to nearest, ties away from zero, as
// cvt.rna.tf32.f32, by integer ops on the bits), small = x - big (exact;
// the tensor cores read its top 19 bits, truncating it to TF32).
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}
// d = a b over one m16n8k8 tile: a (16 x 8, row) and b (8 x 8, col) TF32.
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}
// d += a b over one m16n8k8 tile.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// -----------------------------------------------------------------------------

__device__ __forceinline__ float part(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// The A fragment of k8 step s from a lane's 16-byte reads of rows g and
// g + 8 (lo, hi) of a k16 block, split into big and small.
__device__ __forceinline__ void a_frag(const float4& lo, const float4& hi,
                                       int s, uint32_t (&ab)[4],
                                       uint32_t (&as)[4]) {
  split(part(lo, 2 * s), ab[0], as[0]);
  split(part(hi, 2 * s), ab[1], as[1]);
  split(part(lo, 2 * s + 1), ab[2], as[2]);
  split(part(hi, 2 * s + 1), ab[3], as[3]);
}

// acc += the 3xTF32 products of NS k8 steps over MT x JG tiles (n8
// tiles j0 .. j0 + JG - 1 of acc): each step's products of a tile go into
// a fresh fragment f, the small terms first. The NS x MT x JG fragments'
// mma chains interleave, and the adds acc += f follow them all, a step at
// a time.
template <int NS, int MT, int JG, int NT>
__device__ __forceinline__ void mma3(float (&acc)[MT][NT][4],
                                     const uint32_t (&ab)[NS][MT][4],
                                     const uint32_t (&as)[NS][MT][4],
                                     const uint32_t (&bb)[NS][JG][2],
                                     const uint32_t (&bs)[NS][JG][2], int j0) {
  float f[NS][MT][JG][4];
#pragma unroll
  for (int st = 0; st < NS; ++st)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < JG; ++j)
        mma0(f[st][i][j], as[st][i], bb[st][j][0], bb[st][j][1]);
#pragma unroll
  for (int st = 0; st < NS; ++st)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < JG; ++j)
        mma(f[st][i][j], ab[st][i], bs[st][j][0], bs[st][j][1]);
#pragma unroll
  for (int st = 0; st < NS; ++st)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < JG; ++j)
        mma(f[st][i][j], ab[st][i], bb[st][j][0], bb[st][j][1]);
#pragma unroll
  for (int st = 0; st < NS; ++st)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < JG; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j0 + j][r] += f[st][i][j][r];
}

}  // namespace
