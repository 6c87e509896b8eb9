// Warp GEMV core shared by csrc/qmatmul.cu (the M <= 8 route) and
// csrc/fused_decode.cu (every weight phase of the megakernel).
//
// One warp owns two output rows. Each lane streams 16 bytes of each row
// per step (16 int8 or 8 bf16 weights), both rows' loads in flight, and
// multiplies them by the bf16 activations the block staged in shared
// memory; products of bf16 values and int8/bf16 weights are exact in f32
// and summed in f32. The caller reduces the lanes and applies the scale.
#pragma once

#include "common.cuh"

template <typename WT>
__device__ __forceinline__ void xq_unpack16(const int4& raw, float* out) {
  if constexpr (sizeof(WT) == 1) {
    const int8_t* p = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int e = 0; e < 16; ++e) out[e] = (float)p[e];
  } else {
    const __nv_bfloat16* p = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = __bfloat162float(p[e]);
  }
}

// acc[r][m] += sum over n in [n_begin, n_end) of xs[m * ldx + n - n_begin] * w_r[n]
// for the weight rows w_0 and w_1 (nullptr: a row past the end, adding 0)
// and the first M <= MAXM activation rows. Lane l starts at n_begin + l * EPL
// and strides 32 * EPL; n_begin and n_end - n_begin are multiples of EPL
// (16 bytes of weights), and ldx of 8 (16 bytes of bf16).
template <typename WT, int MAXM>
__device__ __forceinline__ void xq_gemv2(const __nv_bfloat16* xs, int ldx, const WT* w0,
                                         const WT* w1, int n_begin, int n_end, int M, int lane,
                                         float (&acc)[2][MAXM]) {
  constexpr int EPL = 16 / sizeof(WT);  // weights per 16-byte load
  const WT* rows[2] = {w0, w1};
  for (int n0 = n_begin + lane * EPL; n0 < n_end; n0 += 32 * EPL) {
    float wf[2][EPL];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int4 raw = make_int4(0, 0, 0, 0);
      if (rows[r] != nullptr) raw = __ldg(reinterpret_cast<const int4*>(rows[r] + n0));
      xq_unpack16<WT>(raw, wf[r]);
    }
#pragma unroll
    for (int m = 0; m < MAXM; ++m) {
      if (m >= M) break;
      float xf[EPL];
      const int4* xp = reinterpret_cast<const int4*>(xs + (size_t)m * ldx + (n0 - n_begin));
#pragma unroll
      for (int c = 0; c < EPL / 8; ++c) {
        const int4 raw = xp[c];
        const __nv_bfloat16* p = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int e = 0; e < 8; ++e) xf[c * 8 + e] = __bfloat162float(p[e]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][m] += xf[e] * wf[r][e];
    }
  }
}
