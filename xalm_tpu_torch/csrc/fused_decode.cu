// Whole-step decode megakernel for Hopper (sm_90a).
//
// Replaces xalm_tpu/ops/fused_decode.py::_kernel (through fused_decode_step)
// for an i8 body with per-row f32 scales, a StreamingLLM cache of bf16 or of
// int8 codes with per-row f32 scale planes (the TPU kernel's `quant`
// branch), 1 <= B <= 8 rows at t = 1, head_dim 128, and its two folds: the
// embed fold (the bf16 embed row gathered and the rope trig computed in the
// kernel) and the i8-head fold (final norm, i8 classifier, first-occurrence
// argmax). The two cache kinds are two instantiations of one kernel.
//
// One cooperative, persistent launch per decode step. The grid is exactly
// the blocks that can be co-resident (occupancy API x SM count), so every
// block can wait at a grid barrier for all the others; the L layers loop
// inside the kernel and barriers separate the phases. Per layer:
//
//   1. rmsnorm(x) * attn_norm, cast to bf16, times wqkv -> qkv (GEMV);
//   2. per (row, kv head): clip, rope (q pre-scaled by 1/sqrt(hd)), the K/V
//      rows rounded to bf16 and inserted at kv_pos (dropped at the kv_pos
//      == S sentinel), and for rows with `rotate` the KV_SINKS sink keys
//      rotated by one position (each product and the sum rounded as the
//      plain version's separate f32 operations, then rounded to bf16).
//      int8 cache: q stays unscaled; the K and V rows are quantised (absmax
//      by warp shuffles and a named barrier over the item's 128 threads,
//      since the two items of a block may run different numbers of
//      iterations) and their codes and scales written; the sinks are
//      dequantised with their scales, rotated and requantised;
//   3. split flash-decode over (row, kv head, 128-key chunk): f32 scores
//      over the cache rows, chunk max and exp-sum, un-normalised P.V.
//      int8 cache: the row scales factor out of both dots, as in
//      csrc/attention.cu's xq_flash_decode_q (bf16 q times the codes, times
//      k_scale / sqrt(hd); bf16(p * v_scale) times the V codes);
//   4. combine the chunks' (max, sum, acc) partials -> attn (B, QD) f32;
//   5. bf16(attn) times wo, plus the residual;
//   6. rmsnorm(x) * mlp_norm times w13, SiLU(gate) * up on each chunk pair
//      (a warp owns a gate row and the up row c13 rows after it) -> act;
//   7. bf16(act) times w2, plus the residual.
//
// With the head fold, one more phase runs the final norm and the i8 head
// GEMV, writes the logits and each block's argmax partial, and after one
// more barrier block 0 reduces the partials to the first-occurrence argmax.
//
// The GEMV phases use the warp core of gemv.cuh (csrc/qmatmul.cu's M <= 8
// route): a warp per output row pair, 16-byte int8 loads through the
// read-only path, the activations normalised and cast to bf16 once per
// block into shared memory (in column chunks when B rows of the
// contraction do not fit in 64 KB). Every block reaches every barrier,
// with or without work.
//
// Memory discipline: the workspace (allocated once by the wrapper) holds the
// barrier word, the x residual (B, N) f32, qkv, the rotated q, the
// attention partials, attn, act and the argmax partials; the kernel
// allocates nothing. Anything another block wrote in this launch (x, qkv,
// q, partials, attn, act, and the cache rows and sinks just written) is
// read with __ldcg, past the SM's L1, which is not coherent across SMs:
// x is re-read in phases 1, 5, 6 and 7 of every layer, and a stale L1 line
// would be a silent error. __ldg and the read-only path are for the
// weights, norms, scales and step inputs, which nothing writes.
//
// What bounds it on the H100: the weight bytes. The 7B layer stack is 6.98
// GB of int8 (2.08 ms at 3.35 TB/s), the i8 head 0.13 GB more; the K and V
// cache rows at kv_len 520 are 68 MB in bf16 (2 x 32 layers x 520 rows x
// 1024 values x 2 B), 34 MB of int8 codes plus 1 MB of scales in the int8
// cache. Compute is B FMAs per weight byte on the
// CUDA cores. Each grid barrier costs one atomic per block and a spin on
// one word (measured by xq_grid_barrier_bench, PERF.md); a step has 1 + 7L
// of them (+1 with the head fold): 225 at 32 layers. No wgmma, TMA or
// cross-barrier weight prefetch yet: the weight stream stops at every
// barrier and restarts cold.
//
// Limits (cudaErrorInvalidValue): head_dim != 128, a cache neither bf16 nor
// int8 with scale planes, B outside 1..8, a GQA group outside 1..8, widths
// that are not multiples of 16, or a device where not one block can be
// resident.

#include <math.h>

#include "gemv.cuh"

namespace {

constexpr int MK_THREADS = 256;
constexpr int MK_WARPS = MK_THREADS / 32;
constexpr int MK_MAX_B = 8;
constexpr int MK_MAX_G = 8;
constexpr int MK_HD = 128;
constexpr int MK_CHUNK = 128;                 // key rows per flash-decode work item
constexpr int MK_SMEM = 64 * 1024;            // the GEMV's bf16 activations, or attention scratch
constexpr int MK_XS = MK_SMEM / 2;            // bf16 elements of staged activations
constexpr int MK_MAX_GRID = 4096;             // argmax partial slots
constexpr int KV_SINKS = 2;

struct MkArgs {
  const int* meta;  // (5B): kv_pos | kv_len | rotate | token | pos
  const float* x0;  // (B, N), unused with the embed fold
  const float* cexp_p;  // (B, hd) cos/sin at each row's position, unused with the embed fold
  const float* sexp_p;
  const float* c1;  // (hd) +1-position rotation of the sinks
  const float* s1;
  const float* freqs;  // (hd/2) rope frequencies (embed fold)
  const __nv_bfloat16* embed;  // (Ve, N) (embed fold)
  const float* attn_norm;  // (L, N)
  const float* mlp_norm;
  const int8_t* wqkv;  // (L, DQ, N)
  const float* sqkv;   // (L, DQ)
  const int8_t* wo;    // (L, N, QD)
  const float* so;
  const int8_t* w13;   // (L, 2H, N), chunk-interleaved
  const float* s13;
  const int8_t* w2;    // (L, N, H)
  const float* s2;
  const float* out_norm;  // (N) (head fold)
  const int8_t* wcls;     // (V, N)
  const float* swcls;     // (V)
  void* ck;  // (L, B, KH, S, hd) bf16 or int8, updated in place
  void* cv;
  float* ks;  // (L, B, KH, S) row scales of an int8 cache, updated in place
  float* vs;
  float* xout;    // (B, N)
  float* logits;  // (B, V) (head fold)
  int* token;     // (B) (head fold)
  unsigned char* work;
  int L, B, N, KH, G, H, S, V, c13;
  float eps, clip, sm_scale;
};

// byte offsets of the workspace regions, the same on the host and the card
struct WsLayout {
  size_t x, qkv, q, pm, pl, pacc, attn, act, amv, ami, total;
};

__host__ __device__ inline size_t ws_take(size_t& off, size_t bytes) {
  const size_t at = off;
  off += (bytes + 255) / 256 * 256;
  return at;
}

__host__ __device__ inline WsLayout ws_layout(int B, int N, int KH, int G, int S, int H) {
  const size_t HQ = (size_t)KH * G, DQ = (size_t)KH * (G + 2) * MK_HD;
  const size_t NS = (S + MK_CHUNK - 1) / MK_CHUNK;
  WsLayout o;
  size_t off = 256;  // the barrier word
  o.x = ws_take(off, (size_t)B * N * 4);
  o.qkv = ws_take(off, (size_t)B * DQ * 4);
  o.q = ws_take(off, (size_t)B * HQ * MK_HD * 4);
  o.pm = ws_take(off, (size_t)B * HQ * NS * 4);
  o.pl = ws_take(off, (size_t)B * HQ * NS * 4);
  o.pacc = ws_take(off, (size_t)B * HQ * NS * MK_HD * 4);
  o.attn = ws_take(off, (size_t)B * HQ * MK_HD * 4);
  o.act = ws_take(off, (size_t)B * H * 4);
  o.amv = ws_take(off, (size_t)MK_MAX_GRID * MK_MAX_B * 4);
  o.ami = ws_take(off, (size_t)MK_MAX_GRID * MK_MAX_B * 4);
  o.total = off;
  return o;
}

// Grid barrier (the cooperative-groups scheme): block 0 adds 2^31 - (n - 1)
// and every other block 1, so the word's top bit flips exactly when the
// last block arrives and its low bits return to where they were; the word
// needs no reset between barriers or launches.
__device__ __forceinline__ void grid_sync(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned int old = atomicAdd(bar, add);
    unsigned int cur;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(cur) : "l"(bar) : "memory");
    } while (((old ^ cur) & 0x80000000u) == 0);
    __threadfence();
  }
  __syncthreads();
}

// 1/sqrt(mean(x_b^2) + eps) of each of the B rows of x, into rinv[b]
__device__ void rows_rms(const float* x, int B, int N, float eps, float* rinv, float* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int b = 0; b < B; ++b) {
    const float4* xr = reinterpret_cast<const float4*>(x + (size_t)b * N);
    float ss = 0.f;
    for (int i = tid; i < N / 4; i += MK_THREADS) {
      const float4 v = __ldcg(xr + i);
      ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
    }
    ss = xq_warp_sum(ss);
    if (lane == 0) red[warp] = ss;
    __syncthreads();
    if (tid == 0) {
      float t = 0.f;
      for (int w = 0; w < MK_WARPS; ++w) t += red[w];
      rinv[b] = 1.0f / sqrtf(t / (float)N + eps);
    }
    __syncthreads();
  }
}

// Output rows of pair p: (2p, 2p + 1), or for the chunk-interleaved w13
// (c13 > 0) the gate row of chunk p / c13 and its up row c13 rows later.
__device__ __forceinline__ void pair_rows(int p, int c13, int& r0, int& r1) {
  if (c13 > 0) {
    const int c = p / c13, i = p - c * c13;
    r0 = c * 2 * c13 + i;
    r1 = r0 + c13;
  } else {
    r0 = 2 * p;
    r1 = r0 + 1;
  }
}

// One GEMV phase over the D rows of w (D, K) int8: the block stages
// bf16(src(b, n)) for its B rows into shared memory, each warp dots its row
// pairs, and lane 0 calls epi(p, r0, r1, b, s0, s1) with the two rows' f32
// sums (s1 is meaningless when r1 >= D). src returns 4 columns at n.
template <typename Src, typename Epi>
__device__ void gemv_phase(const int8_t* __restrict__ w, int D, int K, int c13, int B,
                           __nv_bfloat16* xs, Src src, Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int npairs = c13 > 0 ? D / 2 : (D + 1) / 2;
  int kc = MK_XS / B / 512 * 512;  // staged columns per row (a multiple of 32 lanes x 16)
  kc = K < kc ? K : kc;
  auto stage = [&](int c0, int c1) {
    __syncthreads();  // the previous chunk's readers are done
    const int len4 = (c1 - c0) >> 2;
    for (int i = threadIdx.x; i < B * len4; i += MK_THREADS) {
      const int b = i / len4, n = c0 + (i - b * len4) * 4;
      const float4 v = src(b, n);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 packed;
      packed.x = *reinterpret_cast<const unsigned int*>(&lo);
      packed.y = *reinterpret_cast<const unsigned int*>(&hi);
      *reinterpret_cast<uint2*>(xs + (size_t)b * kc + (n - c0)) = packed;
    }
    __syncthreads();
  };
  auto finish = [&](int p, int r0, int r1, float (&acc)[2][MK_MAX_B]) {
#pragma unroll
    for (int b = 0; b < MK_MAX_B; ++b) {
      if (b >= B) break;
      const float s0 = xq_warp_sum(acc[0][b]);
      const float s1 = xq_warp_sum(acc[1][b]);
      if (lane == 0) epi(p, r0, r1, b, s0, s1);
    }
  };
  auto row_ptr = [&](int r) -> const int8_t* { return r < D ? w + (size_t)r * K : nullptr; };

  if (kc == K) {  // the whole contraction fits: stage once, warps stride over the pairs
    stage(0, K);
    for (int p = blockIdx.x * MK_WARPS + warp; p < npairs; p += gridDim.x * MK_WARPS) {
      int r0, r1;
      pair_rows(p, c13, r0, r1);
      float acc[2][MK_MAX_B];
#pragma unroll
      for (int b = 0; b < MK_MAX_B; ++b) acc[0][b] = acc[1][b] = 0.f;
      xq_gemv2<int8_t, MK_MAX_B>(xs, kc, row_ptr(r0), row_ptr(r1), 0, K, B, lane, acc);
      finish(p, r0, r1, acc);
    }
    return;
  }
  // column chunks: the block walks groups of MK_WARPS pairs, re-staging each chunk
  const int ngroups = (npairs + MK_WARPS - 1) / MK_WARPS;
  for (int g = blockIdx.x; g < ngroups; g += gridDim.x) {
    const int p = g * MK_WARPS + warp;
    int r0 = D, r1 = D;
    if (p < npairs) pair_rows(p, c13, r0, r1);
    float acc[2][MK_MAX_B];
#pragma unroll
    for (int b = 0; b < MK_MAX_B; ++b) acc[0][b] = acc[1][b] = 0.f;
    for (int c0 = 0; c0 < K; c0 += kc) {
      const int c1 = c0 + kc < K ? c0 + kc : K;
      stage(c0, c1);
      if (p < npairs) xq_gemv2<int8_t, MK_MAX_B>(xs, kc, row_ptr(r0), row_ptr(r1), c0, c1, B, lane, acc);
    }
    if (p < npairs) finish(p, r0, r1, acc);
  }
}

__device__ __forceinline__ float clip_to(float v, float c) { return fminf(fmaxf(v, -c), c); }

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// max of |v| over the 128 threads of one half of the block (a phase-2
// item), the same value in each: warp shuffles, then named barrier 1 + half
// (barrier 0 is __syncthreads), so the other half need not take part
__device__ float half_absmax(float v, float* red4, int half) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const float m = xq_warp_max(fabsf(v));
  asm volatile("bar.sync %0, 128;" ::"r"(half + 1) : "memory");  // red4 is free
  if (lane == 0) red4[w] = m;
  asm volatile("bar.sync %0, 128;" ::"r"(half + 1) : "memory");
  return fmaxf(fmaxf(red4[0], red4[1]), fmaxf(red4[2], red4[3]));
}

template <bool QUANT>
__global__ void __launch_bounds__(MK_THREADS, 2) fused_decode_kernel(const MkArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[MK_WARPS];
  __shared__ float hred[2][4];
  __shared__ float rinv[MK_MAX_B];
  __shared__ float best_v[MK_WARPS][MK_MAX_B];
  __shared__ int best_i[MK_WARPS][MK_MAX_B];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = a.B, N = a.N, KH = a.KH, G = a.G, H = a.H, S = a.S;
  const int HQ = KH * G, QD = HQ * MK_HD, DQ = KH * (G + 2) * MK_HD, H2 = 2 * H;
  const int NS = (S + MK_CHUNK - 1) / MK_CHUNK;
  const WsLayout ws = ws_layout(B, N, KH, G, S, H);
  unsigned int* bar = reinterpret_cast<unsigned int*>(a.work);
  float* x = reinterpret_cast<float*>(a.work + ws.x);
  float* qkv = reinterpret_cast<float*>(a.work + ws.qkv);
  float* qr = reinterpret_cast<float*>(a.work + ws.q);
  float* pm = reinterpret_cast<float*>(a.work + ws.pm);
  float* pl = reinterpret_cast<float*>(a.work + ws.pl);
  float* pacc = reinterpret_cast<float*>(a.work + ws.pacc);
  float* attn = reinterpret_cast<float*>(a.work + ws.attn);
  float* act = reinterpret_cast<float*>(a.work + ws.act);
  float* amv = reinterpret_cast<float*>(a.work + ws.amv);
  int* ami = reinterpret_cast<int*>(a.work + ws.ami);
  const int* kv_pos = a.meta;
  const int* kv_len = a.meta + B;
  const int* rotate = a.meta + 2 * B;
  const int* token = a.meta + 3 * B;
  const int* pos = a.meta + 4 * B;

  // ---- phase 0: the residual x from x0 or the embed rows
  for (int i = blockIdx.x * MK_THREADS + tid; i < B * N; i += gridDim.x * MK_THREADS) {
    const int b = i / N, n = i - b * N;
    __stcg(x + i, a.embed != nullptr ? __bfloat162float(a.embed[(size_t)__ldg(token + b) * N + n])
                                     : __ldg(a.x0 + i));
  }
  grid_sync(bar);

  const float* rv = rinv;  // captured as a pointer: the values are per phase
  auto normed = [&](const float* nw) {
    return [=](int b, int n) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(x + (size_t)b * N + n));
      const float4 g = __ldg(reinterpret_cast<const float4*>(nw + n));
      const float r = rv[b];
      return make_float4(v.x * r * g.x, v.y * r * g.y, v.z * r * g.z, v.w * r * g.w);
    };
  };
  auto plain = [](const float* src, int ld) {
    return [=](int b, int n) {
      return __ldcg(reinterpret_cast<const float4*>(src + (size_t)b * ld + n));
    };
  };

  __nv_bfloat16* const ckf = static_cast<__nv_bfloat16*>(a.ck);
  __nv_bfloat16* const cvf = static_cast<__nv_bfloat16*>(a.cv);
  signed char* const ckq = static_cast<signed char*>(a.ck);
  signed char* const cvq = static_cast<signed char*>(a.cv);

  for (int l = 0; l < a.L; ++l) {
    const size_t lsc = (size_t)l * B * KH * S;  // this layer's scale plane (x hd: its cache plane)
    // ---- phase 1: rmsnorm + wqkv
    rows_rms(x, B, N, a.eps, rinv, red);
    {
      const float* sc = a.sqkv + (size_t)l * DQ;
      gemv_phase(a.wqkv + (size_t)l * DQ * N, DQ, N, 0, B, xs, normed(a.attn_norm + (size_t)l * N),
                 [&](int, int r0, int r1, int b, float s0, float s1) {
                   __stcg(qkv + (size_t)b * DQ + r0, s0 * __ldg(sc + r0));
                   if (r1 < DQ) __stcg(qkv + (size_t)b * DQ + r1, s1 * __ldg(sc + r1));
                 });
    }
    grid_sync(bar);

    // ---- phase 2: rope, clip, ring insert, sink rotation; two (row, kv head) items per block
    for (int it = blockIdx.x * 2 + (tid >> 7); it < B * KH; it += gridDim.x * 2) {
      const int b = it / KH, j = it - b * KH, i = tid & (MK_HD - 1);
      float c, s;
      if (a.freqs != nullptr) {
        const float ang = (float)__ldg(pos + b) * __ldg(a.freqs + (i >> 1));
        sincosf(ang, &s, &c);
      } else {
        c = __ldg(a.cexp_p + b * MK_HD + i);
        s = __ldg(a.sexp_p + b * MK_HD + i);
      }
      const float* y = qkv + (size_t)b * DQ + (size_t)j * (G + 2) * MK_HD;
      auto rope = [&](const float* v) {
        const float u = clip_to(__ldcg(v + i), a.clip);
        const float p = clip_to(__ldcg(v + (i ^ 1)), a.clip);
        return u * c + ((i & 1) ? p : -p) * s;
      };
      for (int g = 0; g < G; ++g) {
        const float qv = rope(y + g * MK_HD);
        __stcg(qr + ((size_t)b * HQ + j * G + g) * MK_HD + i, QUANT ? qv : qv * a.sm_scale);
      }
      const float kr = rope(y + G * MK_HD);
      const float vr = clip_to(__ldcg(y + (G + 1) * MK_HD + i), a.clip);
      const size_t srow = lsc + ((size_t)b * KH + j) * S;  // scale index of the stripe's row 0
      const size_t stripe = srow * MK_HD;
      const int kvp = __ldg(kv_pos + b);
      if constexpr (QUANT) {
        const int half = tid >> 7;
        const float ksc = xq_row_scale(half_absmax(kr, hred[half], half));
        const float vsc = xq_row_scale(half_absmax(vr, hred[half], half));
        if (kvp >= 0 && kvp < S) {
          ckq[stripe + (size_t)kvp * MK_HD + i] = xq_code(kr, ksc);
          cvq[stripe + (size_t)kvp * MK_HD + i] = xq_code(vr, vsc);
          if (i == 0) {
            __stcg(a.ks + srow + kvp, ksc);
            __stcg(a.vs + srow + kvp, vsc);
          }
        }
        if (__ldg(rotate + b) != 0) {  // uniform over the item
          // dequantise the sinks (every read before the first barrier of
          // the reduces below, every write after it), rotate, requantise
          float v[KV_SINKS], sw[KV_SINKS];
#pragma unroll
          for (int r = 0; r < KV_SINKS; ++r) {
            const float sc = __ldcg(a.ks + srow + r);
            const signed char* row = ckq + stripe + (size_t)r * MK_HD;
            v[r] = __fmul_rn((float)__ldcg(row + i), sc);
            const float p = __fmul_rn((float)__ldcg(row + (i ^ 1)), sc);
            sw[r] = (i & 1) ? p : -p;
          }
          const float c1 = __ldg(a.c1 + i), s1 = __ldg(a.s1 + i);
#pragma unroll
          for (int r = 0; r < KV_SINKS; ++r) {
            const float rot = __fadd_rn(__fmul_rn(v[r], c1), __fmul_rn(sw[r], s1));
            const float sc = xq_row_scale(half_absmax(rot, hred[half], half));
            ckq[stripe + (size_t)r * MK_HD + i] = xq_code(rot, sc);
            if (i == 0) __stcg(a.ks + srow + r, sc);
          }
        }
        continue;
      }
      if (kvp >= 0 && kvp < S) {
        ckf[stripe + (size_t)kvp * MK_HD + i] = __float2bfloat16_rn(kr);
        cvf[stripe + (size_t)kvp * MK_HD + i] = __float2bfloat16_rn(vr);
      }
      if (__ldg(rotate + b) != 0) {  // uniform over the item's four warps
        float v[KV_SINKS], sw[KV_SINKS];
#pragma unroll
        for (int r = 0; r < KV_SINKS; ++r) {
          const unsigned short* row =
              reinterpret_cast<const unsigned short*>(ckf + stripe + (size_t)r * MK_HD);
          v[r] = __bfloat162float(__ushort_as_bfloat16(__ldcg(row + i)));
          const float p = __bfloat162float(__ushort_as_bfloat16(__ldcg(row + (i ^ 1))));
          sw[r] = (i & 1) ? p : -p;
        }
        __syncwarp();  // the lane pair (i, i ^ 1) shares a warp: reads before writes
        const float c1 = __ldg(a.c1 + i), s1 = __ldg(a.s1 + i);
#pragma unroll
        for (int r = 0; r < KV_SINKS; ++r)
          ckf[stripe + (size_t)r * MK_HD + i] =
              __float2bfloat16_rn(__fadd_rn(__fmul_rn(v[r], c1), __fmul_rn(sw[r], s1)));
      }
    }
    grid_sync(bar);

    // ---- phase 3: split flash-decode, one (row, kv head, chunk) item per block
    {
      float* qs = reinterpret_cast<float*>(smem);  // (G, hd)
      float* sc = qs + MK_MAX_G * MK_HD;            // (G, chunk) scores, then p
      float* accs = sc + MK_MAX_G * MK_CHUNK;       // (warps, G, hd) partial P.V
      float* ml = accs + MK_WARPS * MK_MAX_G * MK_HD;  // (G) max, (G) sum
      for (int it = blockIdx.x; it < B * KH * NS; it += gridDim.x) {
        const int b = it / (KH * NS), j = (it / NS) % KH, ch = it % NS;
        const int r0 = ch * MK_CHUNK;
        const int n = min(MK_CHUNK, __ldg(kv_len + b) - r0);
        if (n <= 0) continue;  // uniform over the block
        const size_t srow = lsc + ((size_t)b * KH + j) * S + r0;  // scale index of the chunk's row 0
        const size_t stripe = (lsc + ((size_t)b * KH + j) * S) * MK_HD;
        __syncthreads();  // the previous item's scratch is consumed
        for (int e = tid; e < G * MK_HD; e += MK_THREADS) {
          const float qv = __ldcg(qr + ((size_t)b * HQ + j * G) * MK_HD + e);
          qs[e] = QUANT ? bf16_round(qv) : qv;
        }
        __syncthreads();
        // scores: two threads per key row, 64 dims each, f32 dots (int8:
        // exact bf16 x code products, then times k_scale / sqrt(hd))
        {
          const int row = tid >> 1, half = tid & 1;
          float s[MK_MAX_G];
#pragma unroll
          for (int g = 0; g < MK_MAX_G; ++g) s[g] = 0.f;
          if (QUANT && row < n) {
            const int4* kr =
                reinterpret_cast<const int4*>(ckq + stripe + (size_t)(r0 + row) * MK_HD + half * 64);
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              const int4 raw = __ldcg(kr + cc);
              const signed char* kp = reinterpret_cast<const signed char*>(&raw);
              float kf[16];
#pragma unroll
              for (int e = 0; e < 16; ++e) kf[e] = (float)kp[e];
#pragma unroll
              for (int g = 0; g < MK_MAX_G; ++g) {
                if (g >= G) break;
                const float* qg = qs + g * MK_HD + half * 64 + cc * 16;
#pragma unroll
                for (int e = 0; e < 16; ++e) s[g] += qg[e] * kf[e];
              }
            }
          } else if (row < n) {
            const int4* kr =
                reinterpret_cast<const int4*>(ckf + stripe + (size_t)(r0 + row) * MK_HD + half * 64);
#pragma unroll
            for (int cc = 0; cc < 8; ++cc) {
              const int4 raw = __ldcg(kr + cc);
              const __nv_bfloat16* kp = reinterpret_cast<const __nv_bfloat16*>(&raw);
              float kf[8];
#pragma unroll
              for (int e = 0; e < 8; ++e) kf[e] = __bfloat162float(kp[e]);
#pragma unroll
              for (int g = 0; g < MK_MAX_G; ++g) {
                if (g >= G) break;
                const float* qg = qs + g * MK_HD + half * 64 + cc * 8;
#pragma unroll
                for (int e = 0; e < 8; ++e) s[g] += qg[e] * kf[e];
              }
            }
          }
          const float f = QUANT && row < n ? __fmul_rn(__ldcg(a.ks + srow + row), a.sm_scale) : 1.f;
#pragma unroll
          for (int g = 0; g < MK_MAX_G; ++g) {
            if (g >= G) break;
            s[g] += __shfl_xor_sync(0xffffffffu, s[g], 1);
            if (row < n && half == 0) sc[g * MK_CHUNK + row] = QUANT ? s[g] * f : s[g];
          }
        }
        __syncthreads();
        // chunk max and exp-sum per query head, one warp each (int8: keep
        // bf16(p * v_scale) for P.V; the sum is of p)
        for (int g = warp; g < G; g += MK_WARPS) {
          float mx = -INFINITY;
          for (int r = lane; r < n; r += 32) mx = fmaxf(mx, sc[g * MK_CHUNK + r]);
          mx = xq_warp_max(mx);
          float sum = 0.f;
          for (int r = lane; r < n; r += 32) {
            const float p = expf(sc[g * MK_CHUNK + r] - mx);
            sc[g * MK_CHUNK + r] = QUANT ? bf16_round(__fmul_rn(p, __ldcg(a.vs + srow + r))) : p;
            sum += p;
          }
          sum = xq_warp_sum(sum);
          if (lane == 0) {
            ml[g] = mx;
            ml[MK_MAX_G + g] = sum;
          }
        }
        __syncthreads();
        // un-normalised P.V: warp w takes rows w, w + 8, ..., a lane 4 dims
        {
          float acc[MK_MAX_G][4];
#pragma unroll
          for (int g = 0; g < MK_MAX_G; ++g)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
          for (int r = warp; r < n; r += MK_WARPS) {
            float vf[4];
            if constexpr (QUANT) {
              const int raw = __ldcg(
                  reinterpret_cast<const int*>(cvq + stripe + (size_t)(r0 + r) * MK_HD + lane * 4));
              const signed char* vp = reinterpret_cast<const signed char*>(&raw);
#pragma unroll
              for (int e = 0; e < 4; ++e) vf[e] = (float)vp[e];
            } else {
              const uint2 raw = __ldcg(
                  reinterpret_cast<const uint2*>(cvf + stripe + (size_t)(r0 + r) * MK_HD + lane * 4));
              const __nv_bfloat16* vp = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
              for (int e = 0; e < 4; ++e) vf[e] = __bfloat162float(vp[e]);
            }
#pragma unroll
            for (int g = 0; g < MK_MAX_G; ++g) {
              if (g >= G) break;
              const float p = sc[g * MK_CHUNK + r];
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[g][e] += p * vf[e];
            }
          }
#pragma unroll
          for (int g = 0; g < MK_MAX_G; ++g) {
            if (g >= G) break;
#pragma unroll
            for (int e = 0; e < 4; ++e) accs[(warp * MK_MAX_G + g) * MK_HD + lane * 4 + e] = acc[g][e];
          }
        }
        __syncthreads();
        for (int e = tid; e < G * MK_HD; e += MK_THREADS) {
          const int g = e / MK_HD, d = e - g * MK_HD;
          float t = 0.f;
          for (int w = 0; w < MK_WARPS; ++w) t += accs[(w * MK_MAX_G + g) * MK_HD + d];
          const size_t part = ((size_t)b * HQ + j * G + g) * NS + ch;
          __stcg(pacc + part * MK_HD + d, t);
          if (d == 0) {
            __stcg(pm + part, ml[g]);
            __stcg(pl + part, ml[MK_MAX_G + g]);
          }
        }
      }
    }
    grid_sync(bar);

    // ---- phase 4: combine the chunk partials, two (row, head) items per block
    for (int it = blockIdx.x * 2 + (tid >> 7); it < B * HQ; it += gridDim.x * 2) {
      const int b = it / HQ, d = tid & (MK_HD - 1);
      const int kvl = __ldg(kv_len + b);
      const int nsb = kvl <= 0 ? 0 : min(NS, (kvl + MK_CHUNK - 1) / MK_CHUNK);
      const size_t p0 = (size_t)it * NS;  // it == b * HQ + head
      float mx = -INFINITY;
      for (int s = 0; s < nsb; ++s) mx = fmaxf(mx, __ldcg(pm + p0 + s));
      float l = 0.f, acc = 0.f;
      for (int s = 0; s < nsb; ++s) {
        const float w = expf(__ldcg(pm + p0 + s) - mx);
        l += w * __ldcg(pl + p0 + s);
        acc += w * __ldcg(pacc + (p0 + s) * MK_HD + d);
      }
      __stcg(attn + (size_t)it * MK_HD + d, l > 0.f ? acc / l : 0.f);
    }
    grid_sync(bar);

    // ---- phase 5: wo + residual
    {
      const float* sc = a.so + (size_t)l * N;
      gemv_phase(a.wo + (size_t)l * N * QD, N, QD, 0, B, xs, plain(attn, QD),
                 [&](int, int r0, int r1, int b, float s0, float s1) {
                   float* xr = x + (size_t)b * N;
                   __stcg(xr + r0, __ldcg(xr + r0) + s0 * __ldg(sc + r0));
                   if (r1 < N) __stcg(xr + r1, __ldcg(xr + r1) + s1 * __ldg(sc + r1));
                 });
    }
    grid_sync(bar);

    // ---- phase 6: rmsnorm + w13, SiLU(gate) * up
    rows_rms(x, B, N, a.eps, rinv, red);
    {
      const float* sc = a.s13 + (size_t)l * H2;
      gemv_phase(a.w13 + (size_t)l * H2 * N, H2, N, a.c13, B, xs, normed(a.mlp_norm + (size_t)l * N),
                 [&](int p, int r0, int r1, int b, float s0, float s1) {
                   const float gt = s0 * __ldg(sc + r0), up = s1 * __ldg(sc + r1);
                   __stcg(act + (size_t)b * H + p, gt / (1.0f + expf(-gt)) * up);
                 });
    }
    grid_sync(bar);

    // ---- phase 7: w2 + residual (and the output rows after the last layer)
    {
      const float* sc = a.s2 + (size_t)l * N;
      float* xo = l == a.L - 1 ? a.xout : nullptr;
      gemv_phase(a.w2 + (size_t)l * N * H, N, H, 0, B, xs, plain(act, H),
                 [&](int, int r0, int r1, int b, float s0, float s1) {
                   float* xr = x + (size_t)b * N;
                   const float v0 = __ldcg(xr + r0) + s0 * __ldg(sc + r0);
                   __stcg(xr + r0, v0);
                   if (xo != nullptr) xo[(size_t)b * N + r0] = v0;
                   if (r1 < N) {
                     const float v1 = __ldcg(xr + r1) + s1 * __ldg(sc + r1);
                     __stcg(xr + r1, v1);
                     if (xo != nullptr) xo[(size_t)b * N + r1] = v1;
                   }
                 });
    }
    grid_sync(bar);
  }

  if (a.wcls == nullptr) return;

  // ---- head fold: final norm, i8 head, logits and a first-occurrence argmax
  float bv[MK_MAX_B];
  int bi[MK_MAX_B];
#pragma unroll
  for (int b = 0; b < MK_MAX_B; ++b) {
    bv[b] = -INFINITY;
    bi[b] = 0x7fffffff;
  }
  rows_rms(x, B, N, a.eps, rinv, red);
  gemv_phase(a.wcls, a.V, N, 0, B, xs, normed(a.out_norm),
             [&](int, int r0, int r1, int b, float s0, float s1) {
               const float v0 = s0 * __ldg(a.swcls + r0);
               a.logits[(size_t)b * a.V + r0] = v0;
               if (v0 > bv[b] || (v0 == bv[b] && r0 < bi[b])) {
                 bv[b] = v0;
                 bi[b] = r0;
               }
               if (r1 < a.V) {
                 const float v1 = s1 * __ldg(a.swcls + r1);
                 a.logits[(size_t)b * a.V + r1] = v1;
                 if (v1 > bv[b] || (v1 == bv[b] && r1 < bi[b])) {
                   bv[b] = v1;
                   bi[b] = r1;
                 }
               }
             });
  if (lane == 0) {
#pragma unroll
    for (int b = 0; b < MK_MAX_B; ++b) {
      best_v[warp][b] = bv[b];
      best_i[warp][b] = bi[b];
    }
  }
  __syncthreads();
  if (tid < B) {
    float v = -INFINITY;
    int idx = 0x7fffffff;
    for (int w = 0; w < MK_WARPS; ++w) {
      const float wv = best_v[w][tid];
      const int wi = best_i[w][tid];
      if (wv > v || (wv == v && wi < idx)) {
        v = wv;
        idx = wi;
      }
    }
    __stcg(amv + (size_t)blockIdx.x * MK_MAX_B + tid, v);
    __stcg(ami + (size_t)blockIdx.x * MK_MAX_B + tid, idx);
  }
  grid_sync(bar);
  if (blockIdx.x == 0 && tid < B) {
    float v = -INFINITY;
    int idx = 0x7fffffff;
    for (int k = 0; k < (int)gridDim.x; ++k) {
      const float kv = __ldcg(amv + (size_t)k * MK_MAX_B + tid);
      const int ki = __ldcg(ami + (size_t)k * MK_MAX_B + tid);
      if (kv > v || (kv == v && ki < idx)) {
        v = kv;
        idx = ki;
      }
    }
    a.token[tid] = idx == 0x7fffffff ? 0 : idx;
  }
}

__global__ void __launch_bounds__(MK_THREADS, 2) grid_barrier_kernel(unsigned int* bar, int iters) {
  for (int i = 0; i < iters; ++i) grid_sync(bar);
}

// blocks of MK_THREADS threads with MK_SMEM bytes that fit on one SM, per
// device (0: none), and the device's SM count
struct Occupancy {
  int blocks_per_sm = -1, sms = 0;
};

// the cooperative grid of fused_decode_kernel<QUANT> on the current device:
// the co-resident blocks, found once per device and cache kind
template <bool QUANT>
cudaError_t grid_of(int* grid) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  static Occupancy cache[64];
  if (dev < 0 || dev >= 64) return cudaErrorInvalidValue;
  Occupancy& occ = cache[dev];
  if (occ.blocks_per_sm < 0) {
    int coop = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&occ.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(fused_decode_kernel<QUANT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MK_SMEM);
    if (e != cudaSuccess) return e;
    int n = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fused_decode_kernel<QUANT>, MK_THREADS,
                                                      MK_SMEM);
    if (e != cudaSuccess) return e;
    occ.blocks_per_sm = coop ? n : 0;
  }
  if (occ.blocks_per_sm < 1) return cudaErrorInvalidValue;  // no co-resident grid
  *grid = occ.blocks_per_sm * occ.sms;
  if (*grid > MK_MAX_GRID) *grid = MK_MAX_GRID;
  return cudaSuccess;
}

}  // namespace

// bytes of the workspace: the barrier word (zeroed once by the caller and
// left balanced by every complete launch) and the cross-phase buffers
XQ_EXPORT long long xq_fused_decode_workspace(int B, int N, int KH, int G, int S, int H) {
  return (long long)ws_layout(B, N, KH, G, S, H).total;
}

// blocks in the cooperative grid of the bf16-cache kernel on the current
// device (<= 0: none fit)
XQ_EXPORT int xq_fused_decode_grid() {
  int grid = 0;
  return grid_of<false>(&grid) == cudaSuccess ? grid : 0;
}

// ptr: meta, x0, cexp_p, sexp_p, c1, s1, freqs, embed, attn_norm, mlp_norm,
//      wqkv, sqkv, wo, so, w13, s13, w2, s2, out_norm, wcls, swcls, ck, cv,
//      xout, logits, token, work, k_scale, v_scale (null where a fold is
//      off; the scale planes with an int8 cache only)
// dim: L, B, N, KH, G, hd, H, S, V, c13, cache kind (1 bf16, 2 int8)
XQ_EXPORT int xq_fused_decode(void* const* ptr, const int* dim, float eps, float clip,
                              float sm_scale, void* stream) {
  MkArgs a;
  a.meta = (const int*)ptr[0];
  a.x0 = (const float*)ptr[1];
  a.cexp_p = (const float*)ptr[2];
  a.sexp_p = (const float*)ptr[3];
  a.c1 = (const float*)ptr[4];
  a.s1 = (const float*)ptr[5];
  a.freqs = (const float*)ptr[6];
  a.embed = (const __nv_bfloat16*)ptr[7];
  a.attn_norm = (const float*)ptr[8];
  a.mlp_norm = (const float*)ptr[9];
  a.wqkv = (const int8_t*)ptr[10];
  a.sqkv = (const float*)ptr[11];
  a.wo = (const int8_t*)ptr[12];
  a.so = (const float*)ptr[13];
  a.w13 = (const int8_t*)ptr[14];
  a.s13 = (const float*)ptr[15];
  a.w2 = (const int8_t*)ptr[16];
  a.s2 = (const float*)ptr[17];
  a.out_norm = (const float*)ptr[18];
  a.wcls = (const int8_t*)ptr[19];
  a.swcls = (const float*)ptr[20];
  a.ck = ptr[21];
  a.cv = ptr[22];
  a.xout = (float*)ptr[23];
  a.logits = (float*)ptr[24];
  a.token = (int*)ptr[25];
  a.work = (unsigned char*)ptr[26];
  a.ks = (float*)ptr[27];
  a.vs = (float*)ptr[28];
  a.L = dim[0];
  a.B = dim[1];
  a.N = dim[2];
  a.KH = dim[3];
  a.G = dim[4];
  const int hd = dim[5];
  a.H = dim[6];
  a.S = dim[7];
  a.V = dim[8];
  a.c13 = dim[9];
  const int cache_kind = dim[10];
  const bool quant = cache_kind == 2;
  a.eps = eps;
  a.clip = clip;
  a.sm_scale = sm_scale;
  const bool embed_fold = a.embed != nullptr, head_fold = a.wcls != nullptr;
  const bool ok = hd == MK_HD && (cache_kind == 1 || (quant && a.ks && a.vs)) && a.L >= 1 && a.B >= 1 && a.B <= MK_MAX_B &&
                  a.KH >= 1 && a.G >= 1 && a.G <= MK_MAX_G && a.N >= 16 && a.N % 16 == 0 &&
                  a.H >= 16 && a.H % 16 == 0 && a.c13 >= 1 && a.H % a.c13 == 0 && a.S >= 1 &&
                  (embed_fold ? a.freqs != nullptr : (a.x0 && a.cexp_p && a.sexp_p)) &&
                  (!head_fold || (a.V >= 1 && a.out_norm && a.swcls && a.logits && a.token)) &&
                  a.work != nullptr;
  if (!ok) return (int)cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t e = quant ? grid_of<true>(&grid) : grid_of<false>(&grid);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&a};
  const void* kernel = quant ? (const void*)fused_decode_kernel<true>
                             : (const void*)fused_decode_kernel<false>;
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(MK_THREADS), args, MK_SMEM,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller raises
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// `iters` grid barriers alone, on the megakernel's grid: the cost of one
// barrier is the event time over iters (chip_smoke.py)
XQ_EXPORT int xq_grid_barrier_bench(void* work, int iters, void* stream) {
  int grid = 0;
  cudaError_t e = grid_of<false>(&grid);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(grid_barrier_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MK_SMEM);
  if (e != cudaSuccess) return (int)e;
  unsigned int* bar = (unsigned int*)work;
  void* args[] = {&bar, &iters};
  e = cudaLaunchCooperativeKernel((const void*)grid_barrier_kernel, dim3(grid), dim3(MK_THREADS),
                                  args, MK_SMEM, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}
