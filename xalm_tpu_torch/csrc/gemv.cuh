// Warp GEMV cores shared by csrc/qmatmul.cu (the M <= 8 routes) and
// csrc/fused_decode.cu (every weight phase of the megakernel). xq_gemv_word
// is one step of a lane of xq_gemv2 for one row, on weights already in
// registers (the streamed GEMV's, landed in shared memory by bulk copies).
//
// One warp owns two output rows. In xq_gemv2 each lane streams 16 bytes of
// each row per step (16 int8 or fp8, 8 bf16 or 4 f32 weights), and
// multiplies them by the activations the block staged in shared memory:
// bf16 for int8/fp8/bf16 weights (products exact in f32), f32 for f32
// weights (the TPU kernel's f32 compute dtype), summed in f32. The caller
// reduces the lanes and applies the scale. int8 weights widen by byte
// permutes and adds (xq_i8x4_to_f32); fp8 weights (e4m3 or e5m2) widen
// exactly: the card's cvt turns two codes into two f16 values, which hold
// every finite code of both formats (the TPU kernel's _f8_to_bf16 gets the
// same values by bit surgery), then to f32.
//
// The cores load a lane's weight words ahead of the products that use
// them: xq_gemv2 one step (16 bytes of both rows) ahead, xq_gemv2_s8 two,
// and xq_gemv2_q4<MAXM, true> (the megakernel's) the next chunk of up to
// four words of both rows before the group's reductions and scale loads.
// At 16 warps an SM that keeps 32-48 KB an SM in flight (Little's law at
// 3.35 TB/s over 132 SMs: ~25 KB an SM a microsecond of latency). The
// summation order is that of a core loading each step's words just before
// its products, so the outputs do not depend on how far ahead the loads
// run. The q4 GEMV and kernel 8's q4 experts keep xq_gemv2_q4<MAXM, false>,
// each chunk loaded just before its dots: on an H100 they ran 3-12 % slower
// with the chunk ahead (PERF.md section 6).
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

// The four int8 codes of word (the low byte first) as f32, exactly: v + 128
// as the low byte of the f32 2^23 + (v + 128), less 2^23 + 128. Byte
// permutes and adds: an int-to-float conversion (16 a clock an SM) would
// take an issue slot a weight byte, near the byte rate of an SM's share of
// HBM. csrc/qmatmul.cu's tiled GEMM widens its int8 A fragments by it too.
__device__ __forceinline__ void xq_i8x4_to_f32(uint32_t word, float* f) {
  const uint32_t u = word ^ 0x80808080u;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + e)) - 8388736.0f;
}

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
    const uint32_t w[4] = {(uint32_t)raw.x, (uint32_t)raw.y, (uint32_t)raw.z, (uint32_t)raw.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) xq_i8x4_to_f32(w[j], out + 4 * j);
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

// A lane's 16-byte word at element n of row w: zeros for a row past the end
// (nullptr) or from n_end on (a load ahead of the lane's last step)
template <typename WT>
__device__ __forceinline__ int4 xq_word(const WT* w, int n, int n_end) {
  return w != nullptr && n < n_end ? __ldg(reinterpret_cast<const int4*>(w + n))
                                   : make_int4(0, 0, 0, 0);
}

// acc[r][m] += sum over n in [n_begin, n_end) of xs[m * ldx + n - n_begin] * w_r[n]
// for the weight rows w_0 and w_1 (nullptr: a row past the end, adding 0)
// and the first M <= MAXM activation rows. Lane l starts at n_begin + l * EPL
// and strides 32 * EPL, its next step's words of both rows in flight while
// it multiplies this step's; n_begin and n_end - n_begin are multiples of
// EPL (16 bytes of weights), and ldx a multiple of 16 bytes of activations
// (EPL activations of type XT are 4 to 32 bytes: read as 16-byte words).
template <typename WT, int MAXM, typename XT = __nv_bfloat16>
__device__ __forceinline__ void xq_gemv2(const XT* xs, int ldx, const WT* w0,
                                         const WT* w1, int n_begin, int n_end, int M, int lane,
                                         float (&acc)[2][MAXM]) {
  constexpr int EPL = 16 / sizeof(WT);  // weights per 16-byte load
  constexpr int XPW = 16 / sizeof(XT);  // activations per 16-byte word
  static_assert(EPL % XPW == 0, "a lane's activations are whole 16-byte words");
  const WT* rows[2] = {w0, w1};
  int n0 = n_begin + lane * EPL;
  int4 cur[2], nxt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) cur[r] = xq_word(rows[r], n0, n_end);
  for (; n0 < n_end; n0 += 32 * EPL) {
    float wf[2][EPL];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      nxt[r] = xq_word(rows[r], n0 + 32 * EPL, n_end);
      xq_unpack16<WT>(cur[r], wf[r]);
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
#pragma unroll
    for (int r = 0; r < 2; ++r) cur[r] = nxt[r];
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
// the lanes). Lane l starts at n_begin + 16 l and strides 512, the words of
// its next two steps in flight (its products are cheap: four __dp4a a
// word and activation row); n_begin and n_end - n_begin are multiples of
// 16, and so is ldx.
template <int MAXM>
__device__ __forceinline__ void xq_gemv2_s8(const int8_t* xs, int ldx, const int8_t* w0,
                                            const int8_t* w1, int n_begin, int n_end, int M,
                                            int lane, int (&acc)[2][MAXM]) {
  constexpr int AHEAD = 2;
  const int8_t* rows[2] = {w0, w1};
  int n0 = n_begin + lane * 16;
  int4 buf[AHEAD + 1][2];
#pragma unroll
  for (int k = 0; k < AHEAD; ++k)
#pragma unroll
    for (int r = 0; r < 2; ++r) buf[k][r] = xq_word(rows[r], n0 + 512 * k, n_end);
  for (; n0 < n_end; n0 += 512) {
#pragma unroll
    for (int r = 0; r < 2; ++r) buf[AHEAD][r] = xq_word(rows[r], n0 + 512 * AHEAD, n_end);
#pragma unroll
    for (int m = 0; m < MAXM; ++m) {
      if (m >= M) break;
      const int4 xv = *reinterpret_cast<const int4*>(xs + (size_t)m * ldx + (n0 - n_begin));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        int a = __dp4a(buf[0][r].x, xv.x, acc[r][m]);
        a = __dp4a(buf[0][r].y, xv.y, a);
        a = __dp4a(buf[0][r].z, xv.z, a);
        acc[r][m] = __dp4a(buf[0][r].w, xv.w, a);
      }
    }
#pragma unroll
    for (int k = 0; k < AHEAD; ++k)
#pragma unroll
      for (int r = 0; r < 2; ++r) buf[k][r] = buf[k + 1][r];
  }
}

// Packed-q4 rows w_r (K/2 bytes each; the low nibble of byte j is code
// k = j, the high nibble code k = j + K/2) with group scales s_r (K/g
// floats: npg = K/2g groups for each half), against int8 codes: xlo holds
// x's columns [p0, p1) and xhi its columns [K/2 + p0, K/2 + p1), row m at
// m * ldx; p0 and p1 are multiples of the group g (a multiple of 128).
// For each group q in [p0/g, p1/g), all 32 lanes take g/128 words of the
// group's g bytes (word c * 32 + lane, so each load is one 128-byte line
// per warp; chunks of up to four words of both rows, with AHEAD the next
// chunk, of this group or the next, loaded once this chunk's dots are
// issued, so the group's reductions and scale loads run under it), __dp4a
// each word's nibbles (masked into the high half of each byte, so the dot is 16x the
// codes' dot, exact) against the codes, and add the lanes
// (__reduce_add_sync). Then, in every lane,
//     acc[r][m] += f32(dot of low group q) * s_r[q]
// and lane 0 keeps the high group's term f32(dot) * s_r[npg + q] in
// hterm[(r * MAXM + m) * npg + q]: the reference adds the high groups after
// all the low ones, so the caller adds hterm[0..npg) to acc in that order
// once the row is complete. Every multiply and add rounds on its own (no
// FMA contraction), as the plain version's separate f32 operations.
template <int MAXM, bool AHEAD = false>
__device__ __forceinline__ void xq_gemv2_q4(const int8_t* xlo, const int8_t* xhi, int ldx,
                                            const int8_t* w0, const int8_t* w1,
                                            const float* s0, const float* s1, int p0, int p1,
                                            int group, int npg, int M, int lane,
                                            float (&acc)[2][MAXM], float* hterm) {
  const int8_t* rows[2] = {w0, w1};
  const float* sc[2] = {s0, s1};
  const int words = group >> 7;  // 4-byte words of a group per lane
  const int qend = p1 / group;
  // the chunk of words c0 .. c0 + 3 of group q (zeros past the group, past
  // the last group or for a row past the end)
  auto load = [&](int q, int c0, unsigned int (&wv)[4][2]) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        wv[j][r] = q < qend && c0 + j < words && rows[r] != nullptr
                       ? (unsigned int)__ldg(reinterpret_cast<const int*>(
                             rows[r] + q * group + ((c0 + j) * 32 + lane) * 4))
                       : 0u;
  };
  unsigned int wv[4][2];
  if constexpr (AHEAD) load(p0 / group, 0, wv);
  for (int q = p0 / group; q < qend; ++q) {
    int il[2][MAXM], ih[2][MAXM];
#pragma unroll
    for (int m = 0; m < MAXM; ++m) il[0][m] = il[1][m] = ih[0][m] = ih[1][m] = 0;
    for (int c0 = 0; c0 < words; c0 += 4) {
      if constexpr (!AHEAD) load(q, c0, wv);
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
      if constexpr (AHEAD) {
        if (c0 + 4 < words) load(q, c0 + 4, wv);
        else load(q + 1, 0, wv);
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
