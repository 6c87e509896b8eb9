// Warp GEMV cores shared by csrc/qmatmul.cu (the M <= 8 routes) and
// csrc/fused_decode.cu (every weight phase of the megakernel). xq_gemv_word
// is one step of a lane of xq_gemv2 for one row, on weights already in
// registers (the streamed GEMV's, landed in shared memory by bulk copies).
//
// One warp owns two output rows. In xq_gemv2 each lane streams 16 bytes of
// each row per step (16 int8 or fp8, 8 bf16 or 4 f32 weights), both rows'
// loads in flight, and multiplies them by the activations the block staged
// in shared memory: bf16 for int8/fp8/bf16 weights (products exact in f32),
// f32 for f32 weights (the TPU kernel's f32 compute dtype), summed in f32.
// The caller reduces the lanes and applies the scale. fp8 weights (e4m3 or
// e5m2) widen exactly: the card's cvt turns two codes into two f16 values,
// which hold every finite code of both formats (the TPU kernel's
// _f8_to_bf16 gets the same values by bit surgery), then to f32.
//
// The int8-activation cores (the TPU kernel's a8 and q4 branches) take the
// activations as int8 codes (quantised per row by the caller) and multiply
// with __dp4a, s8 x s8 -> s32, so every sum is an exact integer:
// - xq_gemv2_s8: int8 weight rows, one int32 sum per (row, activation row)
//   over the whole contraction (at most K * 127^2 = 2.3e8 < 2^31 at
//   K = 14336);
// - xq_gemv2_q4: packed-q4 rows (two signed nibbles per byte, split-half
//   k-order), one exact int32 dot per group of codes, turned to f32 and
//   multiplied by that (row, group)'s scale once the group is complete, and
//   summed in f32 in the reference's group order.
#pragma once

#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include <type_traits>

#include "common.cuh"

// fp8 weight types and the interpretation the conversion takes
template <typename WT>
struct xq_fp8 {
  static constexpr bool value = false;
};
template <>
struct xq_fp8<__nv_fp8_e4m3> {
  static constexpr bool value = true;
  static constexpr __nv_fp8_interpretation_t kind = __NV_E4M3;
};
template <>
struct xq_fp8<__nv_fp8_e5m2> {
  static constexpr bool value = true;
  static constexpr __nv_fp8_interpretation_t kind = __NV_E5M2;
};

template <typename WT>
__device__ __forceinline__ void xq_unpack16(const int4& raw, float* out) {
  if constexpr (xq_fp8<WT>::value) {
    const __nv_fp8x2_storage_t* p = reinterpret_cast<const __nv_fp8x2_storage_t*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) {  // the low byte is the first code
      const __half2 h(__nv_cvt_fp8x2_to_halfraw2(p[e], xq_fp8<WT>::kind));
      const float2 f = __half22float2(h);
      out[2 * e] = f.x;
      out[2 * e + 1] = f.y;
    }
  } else if constexpr (sizeof(WT) == 1) {
    const int8_t* p = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int e = 0; e < 16; ++e) out[e] = (float)p[e];
  } else if constexpr (sizeof(WT) == 2) {
    const __nv_bfloat16* p = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = __bfloat162float(p[e]);
  } else {
    const float* p = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = p[e];
  }
}

// The activations' type in shared memory for weights of type WT: bf16, or
// f32 for f32 weights (int8, fp8 and bf16 weights take bf16)
template <typename WT>
using xq_act_t = typename std::conditional<sizeof(WT) == 4, float, __nv_bfloat16>::type;

template <typename XT>
__device__ __forceinline__ XT xq_from_float(float v) {
  if constexpr (sizeof(XT) == 4) return v;
  else return __float2bfloat16_rn(v);
}

// acc[r][m] += sum over n in [n_begin, n_end) of xs[m * ldx + n - n_begin] * w_r[n]
// for the weight rows w_0 and w_1 (nullptr: a row past the end, adding 0)
// and the first M <= MAXM activation rows. Lane l starts at n_begin + l * EPL
// and strides 32 * EPL; n_begin and n_end - n_begin are multiples of EPL
// (16 bytes of weights), and ldx a multiple of 16 bytes of activations
// (EPL activations of type XT are 4 to 32 bytes: read as 16-byte words).
template <typename WT, int MAXM, typename XT = __nv_bfloat16>
__device__ __forceinline__ void xq_gemv2(const XT* xs, int ldx, const WT* w0,
                                         const WT* w1, int n_begin, int n_end, int M, int lane,
                                         float (&acc)[2][MAXM]) {
  constexpr int EPL = 16 / sizeof(WT);  // weights per 16-byte load
  constexpr int XPW = 16 / sizeof(XT);  // activations per 16-byte word
  static_assert(EPL % XPW == 0, "a lane's activations are whole 16-byte words");
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
      for (int c = 0; c < EPL / XPW; ++c) {
        const int4 raw = xp[c];
        if constexpr (sizeof(XT) == 4) {
          const float* p = reinterpret_cast<const float*>(&raw);
#pragma unroll
          for (int e = 0; e < XPW; ++e) xf[c * XPW + e] = p[e];
        } else {
          const __nv_bfloat16* p = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
          for (int e = 0; e < XPW; ++e) xf[c * XPW + e] = __bfloat162float(p[e]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][m] += xf[e] * wf[r][e];
    }
  }
}

// acc[m] += sum over e < EPL of xs[m * ldx + e] * w[e], w the EPL weights
// of the 16-byte word raw, for the first M <= MAXM activation rows: one
// step of a lane of xq_gemv2 for one row, on weights already in registers
// (the streamed GEMV's, landed in shared memory). xs is 16-byte aligned.
template <typename WT, int MAXM, typename XT>
__device__ __forceinline__ void xq_gemv_word(const XT* xs, int ldx, const int4& raw, int M,
                                             float (&acc)[MAXM]) {
  constexpr int EPL = 16 / sizeof(WT);
  constexpr int XPW = 16 / sizeof(XT);
  float wf[EPL];
  xq_unpack16<WT>(raw, wf);
#pragma unroll
  for (int m = 0; m < MAXM; ++m) {
    if (m >= M) break;
    float xf[EPL];
    const int4* xp = reinterpret_cast<const int4*>(xs + (size_t)m * ldx);
#pragma unroll
    for (int c = 0; c < EPL / XPW; ++c) {
      const int4 rx = xp[c];
      if constexpr (sizeof(XT) == 4) {
        const float* p = reinterpret_cast<const float*>(&rx);
#pragma unroll
        for (int e = 0; e < XPW; ++e) xf[c * XPW + e] = p[e];
      } else {
        const __nv_bfloat16* p = reinterpret_cast<const __nv_bfloat16*>(&rx);
#pragma unroll
        for (int e = 0; e < XPW; ++e) xf[c * XPW + e] = __bfloat162float(p[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[m] += xf[e] * wf[e];
  }
}

// acc[r][m] += sum over n in [n_begin, n_end) of xs[m * ldx + n - n_begin] * w_r[n],
// int8 codes times int8 weights, exact in int32 (per lane; the caller adds
// the lanes). Lane l starts at n_begin + 16 l and strides 512; n_begin and
// n_end - n_begin are multiples of 16, and so is ldx.
template <int MAXM>
__device__ __forceinline__ void xq_gemv2_s8(const int8_t* xs, int ldx, const int8_t* w0,
                                            const int8_t* w1, int n_begin, int n_end, int M,
                                            int lane, int (&acc)[2][MAXM]) {
  const int8_t* rows[2] = {w0, w1};
  for (int n0 = n_begin + lane * 16; n0 < n_end; n0 += 512) {
    int4 wr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      wr[r] = make_int4(0, 0, 0, 0);
      if (rows[r] != nullptr) wr[r] = __ldg(reinterpret_cast<const int4*>(rows[r] + n0));
    }
#pragma unroll
    for (int m = 0; m < MAXM; ++m) {
      if (m >= M) break;
      const int4 xv = *reinterpret_cast<const int4*>(xs + (size_t)m * ldx + (n0 - n_begin));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        int a = __dp4a(wr[r].x, xv.x, acc[r][m]);
        a = __dp4a(wr[r].y, xv.y, a);
        a = __dp4a(wr[r].z, xv.z, a);
        acc[r][m] = __dp4a(wr[r].w, xv.w, a);
      }
    }
  }
}

// Packed-q4 rows w_r (K/2 bytes each; the low nibble of byte j is code
// k = j, the high nibble code k = j + K/2) with group scales s_r (K/g
// floats: npg = K/2g groups for each half), against int8 codes: xlo holds
// x's columns [p0, p1) and xhi its columns [K/2 + p0, K/2 + p1), row m at
// m * ldx; p0 and p1 are multiples of the group g (a multiple of 128).
// For each group q in [p0/g, p1/g), all 32 lanes take g/128 words of the
// group's g bytes (word c * 32 + lane, so each load is one 128-byte line
// per warp; up to four words of both rows in flight), __dp4a each word's
// nibbles (masked into the high half of each byte, so the dot is 16x the
// codes' dot, exact) against the codes, and add the lanes
// (__reduce_add_sync). Then, in every lane,
//     acc[r][m] += f32(dot of low group q) * s_r[q]
// and lane 0 keeps the high group's term f32(dot) * s_r[npg + q] in
// hterm[(r * MAXM + m) * npg + q]: the reference adds the high groups after
// all the low ones, so the caller adds hterm[0..npg) to acc in that order
// once the row is complete. Every multiply and add rounds on its own (no
// FMA contraction), as the plain version's separate f32 operations.
template <int MAXM>
__device__ __forceinline__ void xq_gemv2_q4(const int8_t* xlo, const int8_t* xhi, int ldx,
                                            const int8_t* w0, const int8_t* w1,
                                            const float* s0, const float* s1, int p0, int p1,
                                            int group, int npg, int M, int lane,
                                            float (&acc)[2][MAXM], float* hterm) {
  const int8_t* rows[2] = {w0, w1};
  const float* sc[2] = {s0, s1};
  const int words = group >> 7;  // 4-byte words of a group per lane
  for (int q = p0 / group; q < p1 / group; ++q) {
    int il[2][MAXM], ih[2][MAXM];
#pragma unroll
    for (int m = 0; m < MAXM; ++m) il[0][m] = il[1][m] = ih[0][m] = ih[1][m] = 0;
    for (int c0 = 0; c0 < words; c0 += 4) {  // up to 4 words of both rows in flight
      unsigned int wv[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          wv[j][r] = c0 + j < words && rows[r] != nullptr
                         ? (unsigned int)__ldg(reinterpret_cast<const int*>(
                               rows[r] + q * group + ((c0 + j) * 32 + lane) * 4))
                         : 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c0 + j >= words) break;
        const int off = q * group + ((c0 + j) * 32 + lane) * 4;  // byte of the packed row
        const int lo16[2] = {(int)((wv[j][0] << 4) & 0xF0F0F0F0u), (int)((wv[j][1] << 4) & 0xF0F0F0F0u)};
        const int hi16[2] = {(int)(wv[j][0] & 0xF0F0F0F0u), (int)(wv[j][1] & 0xF0F0F0F0u)};
#pragma unroll
        for (int m = 0; m < MAXM; ++m) {
          if (m >= M) break;
          const int xl = *reinterpret_cast<const int*>(xlo + (size_t)m * ldx + (off - p0));
          const int xh = *reinterpret_cast<const int*>(xhi + (size_t)m * ldx + (off - p0));
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            il[r][m] = __dp4a(lo16[r], xl, il[r][m]);
            ih[r][m] = __dp4a(hi16[r], xh, ih[r][m]);
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MAXM; ++m) {
      if (m >= M) break;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int lo = __reduce_add_sync(0xffffffffu, il[r][m]) >> 4;
        const int hi = __reduce_add_sync(0xffffffffu, ih[r][m]) >> 4;
        if (rows[r] == nullptr) continue;  // uniform over the warp
        acc[r][m] = __fadd_rn(acc[r][m], __fmul_rn((float)lo, __ldg(sc[r] + q)));
        if (lane == 0) hterm[(r * MAXM + m) * npg + q] = __fmul_rn((float)hi, __ldg(sc[r] + npg + q));
      }
    }
  }
}

// The q4 row's f32 sum once every group is in: the low groups' acc, then
// the high groups' terms in order (lane 0, after xq_gemv2_q4 and __syncwarp)
template <int MAXM>
__device__ __forceinline__ float xq_q4_finish(float acc, const float* hterm, int r, int m, int npg) {
  for (int q = 0; q < npg; ++q) acc = __fadd_rn(acc, hterm[(r * MAXM + m) * npg + q]);
  return acc;
}
