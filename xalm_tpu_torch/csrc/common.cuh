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

// The four int8 codes of word (the low byte first) as f32, exactly: v + 128
// as the low byte of the f32 2^23 + (v + 128), less 2^23 + 128. Byte
// permutes and adds: an int-to-float conversion (16 a clock an SM) would
// take an issue slot a weight byte, near the byte rate of an SM's share of
// HBM. gemv.cuh's cores, csrc/qmatmul.cu's tiled GEMM (its int8 A
// fragments) and the int8 flash-decode (csrc/attention.cu) widen by it.
__device__ __forceinline__ void xq_i8x4_to_f32(uint32_t word, float* f) {
  const uint32_t u = word ^ 0x80808080u;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + e)) - 8388736.0f;
}

// A float KV cache's element: bf16 (rounded to nearest even on store) or
// f32 (stored as it is), and back to f32 on load
template <typename CT>
__device__ __forceinline__ CT xq_to_cache(float v) {
  if constexpr (sizeof(CT) == 4) return v;
  else return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float xq_from_cache(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float xq_from_cache(float v) { return v; }

// The current device's SM count (the launch plans that size a grid to the card)
inline int xq_device_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Shared memory above 48 KB a block needs an opt-in per kernel, and the
// 48 KB count the kernel's static shared memory too: a kernel with a few
// static bytes and exactly 48 KB of dynamic memory does not launch without
// it. Opting in from 32 KB leaves room for any static part up to 16 KB.
template <typename K>
static cudaError_t xq_allow_smem(K kernel, int bytes) {
  if (bytes <= 32 * 1024) return cudaSuccess;
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
