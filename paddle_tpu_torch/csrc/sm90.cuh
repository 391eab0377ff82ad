// Hopper's asynchronous units in raw PTX, for the hand-written kernels
// of sm_90a (csrc/flash_attention_bf16.cu, csrc/abt_bf16_tc.cuh): the
// Tensor Memory Accelerator
// (TMA) tile loads, mbarriers, named barriers, warpgroup matrix products
// (wgmma.mma_async) and setmaxnreg, and the host's encoding of a tensor
// map over a bfloat16 tensor of four dimensions.
//
// The tiles these pieces move and multiply have one layout: a tile of R
// rows of D bfloat16 values (a row one sequence position of one head) is
// D / 64 boxes, each box [R][64] values, 128 bytes a row, written by TMA
// with the 128-byte swizzle (the 16-byte chunk c of row r lands at chunk
// c ^ (r % 8) of the row: the XOR of address bits 4-6 with bits 7-9, so
// every box starts on 1024 bytes). wgmma reads such a tile by a matrix
// descriptor (desc_k, desc_mn below) in either of its orientations:
//
// * K-major, the dot-product axis along the row (Q and K in Q K^T; K and
//   Q in K Q^T; V and dO in V dO^T; dS as the A of dS K): rows 8 apart
//   are 1024 bytes apart
//   (the stride byte offset); a k16 step is 32 bytes into the row, and
//   every fourth step starts the next box;
// * MN-major, the dot-product axis down the rows (V in P V, dO in P^T dO,
//   Q in dS^T Q, K in dS K; the transpose bit of B set): a k16 step is 16
//   rows, 2048 bytes, further down; N runs along the rows, 64 values to a
//   box, so the leading byte offset is the box's size, and 8 rows are 1024
//   bytes (the stride byte offset). A B of N = 32 starting half a row into
//   its box (dS K's second half at D = 64) is read the same way: the
//   swizzle is a function of the address, whose bits 7-9 stay the row's.
//
// The accumulators of m64nNk16 are float32, N / 2 a thread: warp w of the
// warpgroup holds rows 16 w .. 16 w + 15 in the m16n8 C layout of
// mma.sync, d[4 j + e] at row 16 w + g + 8 (e >> 1), column 8 j + 2 t +
// (e & 1) (g = lane / 4, t = lane % 4). In the RS form A comes from
// registers in mma.sync's m16n8k16 A layout, so a C tile packed to bf16
// (pack_a in flash_attention_bf16.cu) is the A operand of the next product.
//
// scripts/emulate_flash_bf16_cpu.py replaces the block of PTX below with
// C++ models for g++ (the TMA box load writing the swizzle, wgmma reading
// through the descriptors, the mbarriers' phases) and keeps the
// descriptor arithmetic after it.
#pragma once

#include <cstdint>

// ---- Hopper's asynchronous units ----------------------------------------
#include <cuda.h>
#include <cuda_runtime.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers: `count` arrivals (and the bytes announced by expect_tx) end a
// phase; a wait on parity p returns once the phase of that parity is over.
__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// Make the initialised barriers visible to the other threads and to TMA.
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// One arrival that also announces `bytes` still to land by TMA.
__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool bar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  while (!bar_try_wait(bar, parity)) {
  }
}

// Order this thread's generic-proxy writes to shared memory before later
// async-proxy reads of it (wgmma, a TMA store).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` (1-15; 0 is __syncthreads) over `threads` threads:
// sync waits for all of them, arrive counts this thread and goes on.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// One TMA box of a 4-D tensor map into shared memory at dst, at the
// coordinates (c0 innermost); its bytes complete on the mbarrier at bar.
// Coordinates past a dimension's end read zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// The box at src (laid out as a load of the same map writes it) to the
// coordinates (c0 innermost) of a 4-D tensor map; coordinates past a
// dimension's end are not written. bulk_commit makes the stores started
// since the last one a group; bulk_wait_read waits until every group has
// read its shared memory.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// The warpgroup's register budget, moved between warpgroups; executed by
// all four warps of a warpgroup.
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Before the first wgmma after registers it reads (accumulators, A) were
// written by other instructions.
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
// The wgmmas started since the last commit become one group.
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N groups are in flight; only then are their
// accumulators to be read.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of the accumulators
// across a wgmma, a commit or a wait.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for an RS product's A registers, which stay the product's
// until its wait.
__device__ __forceinline__ void fence_operands(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define SM90_F8(d, i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// The products, bf16 operands and float32 accumulators. TB is the
// transpose bit of B: 0 for a K-major B, 1 for an MN-major one.

// d (+)= a b over one m64n64k16 step, both operands by their descriptors.
template <int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : SM90_F8(d, 0), SM90_F8(d, 8), SM90_F8(d, 16), SM90_F8(d, 24)
        : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
}

// d (+)= a b over one m64n32k16 step, both operands by their descriptors.
template <int TB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
        : SM90_F8(d, 0), SM90_F8(d, 8)
        : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
}

// d (+)= a b over one m64n128k16 step, both operands by their descriptors.
template <int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        : SM90_F8(d, 0), SM90_F8(d, 8), SM90_F8(d, 16), SM90_F8(d, 24),
          SM90_F8(d, 32), SM90_F8(d, 40), SM90_F8(d, 48), SM90_F8(d, 56)
        : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
}

// d (+)= a b over one m64n256k16 step, both operands by their descriptors.
template <int TB>
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
        : SM90_F8(d, 0), SM90_F8(d, 8), SM90_F8(d, 16), SM90_F8(d, 24),
          SM90_F8(d, 32), SM90_F8(d, 40), SM90_F8(d, 48), SM90_F8(d, 56),
          SM90_F8(d, 64), SM90_F8(d, 72), SM90_F8(d, 80), SM90_F8(d, 88),
          SM90_F8(d, 96), SM90_F8(d, 104), SM90_F8(d, 112), SM90_F8(d, 120)
        : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
}

// d (+)= a b over one m64n32k16 step: a from registers (the A fragments of
// the warp's 16 rows), b by its descriptor; accumulate selects d + a b.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : SM90_F8(d, 0), SM90_F8(d, 8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
          "n"(TB));
}

// d (+)= a b over one m64n64k16 step: a from registers (the A fragments of
// the warp's 16 rows), b by its descriptor; accumulate selects d + a b.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : SM90_F8(d, 0), SM90_F8(d, 8), SM90_F8(d, 16), SM90_F8(d, 24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
          "n"(TB));
}

// d (+)= a b over one m64n128k16 step: a from registers (the A fragments of
// the warp's 16 rows), b by its descriptor; accumulate selects d + a b.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : SM90_F8(d, 0), SM90_F8(d, 8), SM90_F8(d, 16), SM90_F8(d, 24),
          SM90_F8(d, 32), SM90_F8(d, 40), SM90_F8(d, 48), SM90_F8(d, 56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
          "n"(TB));
}

// d (+)= a b over one m64n256k16 step: a from registers (the A fragments of
// the warp's 16 rows), b by its descriptor; accumulate selects d + a b.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : SM90_F8(d, 0), SM90_F8(d, 8), SM90_F8(d, 16), SM90_F8(d, 24),
          SM90_F8(d, 32), SM90_F8(d, 40), SM90_F8(d, 48), SM90_F8(d, 56),
          SM90_F8(d, 64), SM90_F8(d, 72), SM90_F8(d, 80), SM90_F8(d, 88),
          SM90_F8(d, 96), SM90_F8(d, 104), SM90_F8(d, 112), SM90_F8(d, 120)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
          "n"(TB));
}

#undef SM90_F8

// A tensor map over a bfloat16 tensor at `base` of four dimensions
// (innermost first, dims), the byte strides of the outer three (multiples
// of 16) and boxes of `box` values written with the 128-byte swizzle
// (box[0] 64: one 128-byte row) or, with swizzle false, densely; a box
// past a dimension's end is zero-filled. A box's innermost coordinate
// must fall on 16 bytes: the card never completes one that does not.
// Returns a CUresult (0 = encoded). The driver's entry point is found
// through the runtime, so the library needs no -lcuda.
inline int encode_4d(CUtensorMap* map, const void* base,
                     const cuuint64_t (&dims)[4],
                     const cuuint64_t (&strides)[3],
                     const cuuint32_t (&box)[4], bool swizzle = true) {
  typedef CUresult (*Encode)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
      CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess ||
        fn == nullptr)
      return (int)CUDA_ERROR_NOT_FOUND;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return (int)encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                     const_cast<void*>(base), dims, strides, box, unit,
                     CU_TENSOR_MAP_INTERLEAVE_NONE,
                     swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_NONE,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A tensor map over a contiguous [B, S, H, D] bfloat16 tensor at `base`,
// dimensions (D, H, S, B) innermost first, with boxes of {64 values of D,
// 1 head, `rows` positions, 1 batch} written with the 128-byte swizzle:
// a box past S (or past the tensor) is zero-filled inside its own (b, h).
// Returns a CUresult (0 = encoded). The driver's entry point is found
// through the runtime, so the library needs no -lcuda.
inline int encode_bshd(CUtensorMap* map, const void* base, int B, int S,
                       int H, int D, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * D, 2ull * H * D, 2ull * S * H * D};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return encode_4d(map, base, dims, strides, box);
}

}  // namespace sm90
// -----------------------------------------------------------------------------

namespace sm90 {

// Bytes of one box: 64 rows of 128 bytes.
constexpr uint32_t kBoxBytes = 64 * 128;

// The shared address of the dynamic shared memory, rounded up to 1024
// bytes (the 128-byte swizzle's period; each layout asks 1024 more).
__device__ __forceinline__ uint32_t aligned_base(const void* smem) {
  return (smem_u32(smem) + 1023u) & ~1023u;
}

// The matrix descriptor of a tile at shared address `addr` with the
// 128-byte swizzle: leading and stride byte offsets in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3fff) << 16 |
         (uint64_t)((sbo >> 4) & 0x3fff) << 32 | 1ull << 62;
}
// k16 step ks of a K-major tile of 64 rows at `tile` (boxes of 64 values
// of the dot-product axis, one after another): 32 bytes a step inside a
// box, the next box every 4 steps; 8-row groups 1024 bytes apart (the
// leading byte offset is not read under a swizzle and is 1 by rule).
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int ks) {
  return make_desc(tile + (ks >> 2) * kBoxBytes + (ks & 3) * 32, 16, 1024);
}
// k16 step ks of an MN-major B: the tile's rows are the dot-product axis,
// 16 of them (2048 bytes) a step; its columns, N, run 64 to a box, boxes
// kBoxBytes apart (the leading byte offset), rows 8 apart 1024 bytes apart
// (the stride byte offset).
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int ks) {
  return make_desc(tile + ks * 2048, kBoxBytes, 1024);
}

// d (+)= a b over one m64nNk16 step, both operands by their descriptors,
// N = 32, 64, 128 or 256.
template <int N, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 32)
    wgmma_ss_n32<TB>(d, da, db, accumulate);
  else if constexpr (N == 64)
    wgmma_ss_n64<TB>(d, da, db, accumulate);
  else if constexpr (N == 128)
    wgmma_ss_n128<TB>(d, da, db, accumulate);
  else
    wgmma_ss_n256<TB>(d, da, db, accumulate);
}

// d (+)= a b over one m64nNk16 step, a from registers, N = 32, 64, 128 or
// 256.
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  if constexpr (N == 32)
    wgmma_rs_n32<TB>(d, a, db, accumulate);
  else if constexpr (N == 64)
    wgmma_rs_n64<TB>(d, a, db, accumulate);
  else if constexpr (N == 128)
    wgmma_rs_n128<TB>(d, a, db, accumulate);
  else
    wgmma_rs_n256<TB>(d, a, db, accumulate);
}

}  // namespace sm90
