// Helpers shared by the hand-written attention kernels.
#pragma once

#include <cfloat>
#include <cuda_runtime.h>

namespace ptt {

// The TPU kernels mask with a finite value instead of -inf
// (paddle_tpu/kernels/flash_attention.py DEFAULT_MASK_VALUE): a row whose
// visible keys are all masked still has a finite maximum.
constexpr float kMaskValue = -0.7f * FLT_MAX;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

}  // namespace ptt
