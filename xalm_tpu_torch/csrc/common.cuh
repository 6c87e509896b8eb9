// Shared helpers for the xalm_tpu_torch CUDA kernels (sm_90a).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define XQ_EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float xq_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float xq_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Dynamic shared memory above 48 KB needs an opt-in per kernel.
template <typename K>
static cudaError_t xq_allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The `i8` row scheme of the int8 KV cache (``_quant_rows_f32``): scale =
// absmax / 127 by IEEE division (1 for an all-zero row), code = round half
// to even of v / scale, again by IEEE division (v * (1 / scale) differs in
// the last bit and flips codes on ties), clamped to +-127. Built without
// --use_fast_math, so this matches torch.round / torch.clamp bit for bit.
__device__ __forceinline__ float xq_row_scale(float amax) {
  return amax > 0.f ? __fdiv_rn(amax, 127.0f) : 1.0f;
}

__device__ __forceinline__ signed char xq_code(float v, float scale) {
  return (signed char)fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f);
}
