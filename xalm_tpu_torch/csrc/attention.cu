// Decode ring update, flash-decode and causal flash-prefill attention over
// the stacked StreamingLLM cache, bf16 or int8 with per-row scales, for
// Hopper (sm_90a).
//
// The cache pointers given to every function are one layer of the
// (L, B, KH, S, hd) planes (the caller offsets by the layer), S being the
// physical window (padded to a multiple of 32).
//
// 1. xq_kv_update replaces xalm_tpu/ops/pallas_attention.py::_update_kernel.
//    Grid (B, KH), one thread per head dim. Writes the new K/V row (f32 ->
//    bf16) at kv_pos (dropped when kv_pos >= S: the sentinel), then, for
//    wrapped rows, rotates the KV_SINKS sink keys by one position with the
//    interleaved-pair rope: out = v*cexp + swap(v)*sexp, swap[2j] = -v[2j+1],
//    swap[2j+1] = v[2j], each product and the sum rounded separately as in
//    the plain version. Bound: bytes, and at a few KB per layer it is launch
//    latency; it stays a separate launch before attention on the same stream
//    because fusing it into attention would race on the row being written.
//
// 2. xq_flash_decode replaces _attn_kernel. The TPU grid walks the
//    sequence in order carrying a running max and sum; blocks on the card
//    run in no order, so the sequence is split into 128-row chunks, one
//    block per (batch, kv head, chunk): phase 1 scores the chunk for the
//    head's G query heads (f32 dots over the bf16 cache, one thread per key
//    row, q broadcast from shared memory: no shuffle chains on the critical
//    path), phase 2 takes each head's chunk max and exp-sums, phase 3 forms
//    the un-normalised P.V, each warp over a quarter of the rows (coalesced
//    8-byte loads, several rows in flight), summed across the warps.
//    A second small kernel combines the chunks' (max, sum, acc) partials.
//    Chunks past kv_len exit at once; kv_len == 0 gives 0, not NaN. Bound:
//    bytes (the cache rows up to kv_len, read once).
//
// 3. xq_kv_update_q replaces _insert_q_kernel and _sink_q_kernel in one
//    launch, over an int8 cache with per-row f32 scale planes (L, B, KH, S).
//    Grid (B, KH), one thread per head dim (128). Quantises the new K and V
//    rows (absmax by warp shuffles and a 4-warp shared-memory reduce; the
//    scale and codes by IEEE division, common.cuh) and writes codes and
//    scales at kv_pos (dropped at kv_pos >= S); then, for wrapped rows,
//    dequantises the KV_SINKS sink keys with their stored scales, rotates
//    them by one position (each product and the sum rounded as the plain
//    version's separate f32 operations) and requantises them. Bit-equal to
//    the plain version: absmax is order-free. Bound: launch latency, as 1.
//
// 4. xq_flash_decode_q replaces _attn_q_kernel: the split-chunk design of
//    2 over int8 codes, the row scales factored out of both dots as in the
//    TPU kernel. Phase 1: one thread per key row, q cast to bf16 in shared
//    memory, 16 codes per 16-byte load, score = (q . codes) * (k_scale *
//    1/sqrt(hd)). Phase 2: the chunk max, p = exp(score - max), the sum of
//    p, and bf16(p * v_scale) kept for phase 3, which sums it times the V
//    codes (4 codes per lane, a warp per row). The combine kernel of 2 is
//    shared. Bound: bytes (the code rows and their scales up to kv_len, half
//    the bytes of the bf16 cache).
//
// 5. xq_flash_prefill replaces _prefill_kernel. One block per (batch, kv
//    head, q tile of 64 rows = tq positions x G heads); four warps own 16
//    rows each. Loops over 64-key tiles up to the tile's causal limit
//    (later tiles are skipped), S = Q.K^T on bf16 WMMA fragments with f32
//    accumulation, the online softmax in f32 (each row's state in a lane
//    pair), p cast to bf16 before P.V on WMMA, the output accumulator in
//    registers. Bound: operations at T = 512 (tensor cores), bytes at small
//    T. Simple first: no TMA / wgmma / pipelining yet.

#include <math.h>
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int KV_SINKS = 2;

__global__ void kv_update_kernel(__nv_bfloat16* __restrict__ ck, __nv_bfloat16* __restrict__ cv,
                                 const float* __restrict__ knew, const float* __restrict__ vnew,
                                 const int* __restrict__ kv_pos, const int* __restrict__ rotate,
                                 const float* __restrict__ cexp, const float* __restrict__ sexp,
                                 int KH, int S, int hd) {
  const int b = blockIdx.x, h = blockIdx.y, i = threadIdx.x;
  const size_t stripe = ((size_t)b * KH + h) * S * hd;
  const size_t src = ((size_t)b * KH + h) * hd + i;
  const int kvp = kv_pos[b];
  if (kvp >= 0 && kvp < S) {
    ck[stripe + (size_t)kvp * hd + i] = __float2bfloat16_rn(knew[src]);
    cv[stripe + (size_t)kvp * hd + i] = __float2bfloat16_rn(vnew[src]);
  }
  if (rotate[b] == 0) return;  // uniform over the block
  __syncthreads();
  float v[KV_SINKS], sw[KV_SINKS];
#pragma unroll
  for (int r = 0; r < KV_SINKS; ++r) {
    const __nv_bfloat16* row = ck + stripe + (size_t)r * hd;
    v[r] = __bfloat162float(row[i]);
    const float p = __bfloat162float(row[i ^ 1]);
    sw[r] = (i & 1) ? p : -p;
  }
  __syncthreads();
  const float c = cexp[i], s = sexp[i];
#pragma unroll
  for (int r = 0; r < KV_SINKS; ++r)
    ck[stripe + (size_t)r * hd + i] =
        __float2bfloat16_rn(__fadd_rn(__fmul_rn(v[r], c), __fmul_rn(sw[r], s)));
}

constexpr int FD_HD = 128;
constexpr int FD_THREADS = 128;
constexpr int FD_CHUNK = 128;  // key rows per block: one per thread in phase 1

template <int G>
__global__ void __launch_bounds__(FD_THREADS) flash_decode_split_kernel(
    const float* __restrict__ q, const __nv_bfloat16* __restrict__ ck,
    const __nv_bfloat16* __restrict__ cv, const int* __restrict__ kv_len,
    float* __restrict__ pm, float* __restrict__ pl, float* __restrict__ pacc,
    int KH, int S, float sm_scale) {
  __shared__ __align__(16) float qs[G][FD_HD];
  __shared__ float sc[G][FD_CHUNK];
  __shared__ float red[FD_THREADS / 32][G][FD_HD];
  __shared__ float mrow[G], lrow[G];
  const int H = KH * G;
  const int b = blockIdx.x / KH, h = blockIdx.x % KH;
  const int split = blockIdx.y, NS = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = split * FD_CHUNK;
  const int n = min(FD_CHUNK, kv_len[b] - r0);  // rows of this chunk (<= 0: none)
  const size_t part0 = ((size_t)b * H + (size_t)h * G) * NS + split;  // head gi at + gi*NS

  if (n <= 0) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const size_t pi = part0 + (size_t)gi * NS;
      pacc[pi * FD_HD + tid] = 0.f;
      if (tid == 0) {
        pm[pi] = -INFINITY;
        pl[pi] = 0.f;
      }
    }
    return;
  }
  const size_t stripe = ((size_t)b * KH + h) * S * FD_HD;
  for (int i = tid; i < G * FD_HD; i += FD_THREADS)
    qs[i / FD_HD][i % FD_HD] = q[((size_t)b * H + (size_t)h * G) * FD_HD + i] * sm_scale;
  __syncthreads();

  // phase 1: thread r scores key row r for the G heads; f32 dots, 16-byte
  // loads, q broadcast from shared memory
  if (tid < n) {
    const int4* krow = reinterpret_cast<const int4*>(ck + stripe + (size_t)(r0 + tid) * FD_HD);
    float s[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) s[gi] = 0.f;
#pragma unroll
    for (int c = 0; c < FD_HD / 8; ++c) {  // all 16 loads of the row in flight
      const int4 raw = __ldg(krow + c);
      const __nv_bfloat16* kp = reinterpret_cast<const __nv_bfloat16*>(&raw);
      float kf[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) kf[e] = __bfloat162float(kp[e]);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float4 qa = *reinterpret_cast<const float4*>(&qs[gi][c * 8]);
        const float4 qb = *reinterpret_cast<const float4*>(&qs[gi][c * 8 + 4]);
        s[gi] += qa.x * kf[0] + qa.y * kf[1] + qa.z * kf[2] + qa.w * kf[3] +
                 qb.x * kf[4] + qb.y * kf[5] + qb.z * kf[6] + qb.w * kf[7];
      }
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) sc[gi][tid] = s[gi];
  }
  __syncthreads();

  // phase 2: per query head, the chunk max and exp-sum
  for (int gi = warp; gi < G; gi += FD_THREADS / 32) {
    float mx = -INFINITY;
    for (int r = lane; r < n; r += 32) mx = fmaxf(mx, sc[gi][r]);
    mx = xq_warp_max(mx);
    float sum = 0.f;
    for (int r = lane; r < n; r += 32) {
      const float p = expf(sc[gi][r] - mx);
      sc[gi][r] = p;
      sum += p;
    }
    sum = xq_warp_sum(sum);
    if (lane == 0) {
      mrow[gi] = mx;
      lrow[gi] = sum;
    }
  }
  __syncthreads();

  // phase 3: un-normalised P.V; warp w takes rows w, w+4, ... with the
  // lane's 4 dims (8-byte loads, unrolled so several rows are in flight),
  // then the four warps' partial sums add up through shared memory
  float acc[G][4];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[gi][e] = 0.f;
#pragma unroll 8
  for (int r = warp; r < n; r += FD_THREADS / 32) {
    const uint2 raw =
        *reinterpret_cast<const uint2*>(cv + stripe + (size_t)(r0 + r) * FD_HD + lane * 4);
    const __nv_bfloat16* vp = reinterpret_cast<const __nv_bfloat16*>(&raw);
    float vf[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) vf[e] = __bfloat162float(vp[e]);
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const float p = sc[gi][r];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[gi][e] += p * vf[e];
    }
  }
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[warp][gi][lane * 4 + e] = acc[gi][e];
  __syncthreads();
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < FD_THREADS / 32; ++w) a += red[w][gi][tid];
    const size_t pi = part0 + (size_t)gi * NS;
    pacc[pi * FD_HD + tid] = a;
    if (tid == 0) {
      pm[pi] = mrow[gi];
      pl[pi] = lrow[gi];
    }
  }
}

template <int G>
cudaError_t launch_flash_decode_split(dim3 grid, cudaStream_t s, const float* q,
                                      const __nv_bfloat16* ck, const __nv_bfloat16* cv,
                                      const int* kv_len, float* pm, float* pl, float* pacc,
                                      int KH, int S, float sm_scale) {
  flash_decode_split_kernel<G><<<grid, FD_THREADS, 0, s>>>(q, ck, cv, kv_len, pm, pl, pacc, KH,
                                                          S, sm_scale);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(FD_HD) flash_decode_combine_kernel(
    const float* __restrict__ pm, const float* __restrict__ pl, const float* __restrict__ pacc,
    float* __restrict__ out, int NS) {
  const size_t bh = blockIdx.x;
  const int t = threadIdx.x;
  float mx = -INFINITY;
  for (int s = 0; s < NS; ++s) mx = fmaxf(mx, pm[bh * NS + s]);
  float l = 0.f, a = 0.f;
  if (mx != -INFINITY) {
    for (int s = 0; s < NS; ++s) {
      const float m = pm[bh * NS + s];
      if (m == -INFINITY) continue;
      const float w = expf(m - mx);
      l += w * pl[bh * NS + s];
      a += w * pacc[(bh * NS + s) * FD_HD + t];
    }
  }
  out[bh * FD_HD + t] = l > 0.f ? a / l : 0.f;  // kv_len == 0 -> 0
}

// max of |v| over the block (blockDim.x a multiple of 32, <= 1024), the
// same value in every thread; red holds 32 floats
__device__ float block_absmax(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  float m = xq_warp_max(fabsf(v));
  __syncthreads();  // red is free: the previous call's readers are done
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
  for (int w = 1; w < nw; ++w) m = fmaxf(m, red[w]);
  return m;
}

__global__ void kv_update_q_kernel(signed char* __restrict__ ck, signed char* __restrict__ cv,
                                   float* __restrict__ ks, float* __restrict__ vs,
                                   const float* __restrict__ knew, const float* __restrict__ vnew,
                                   const int* __restrict__ kv_pos, const int* __restrict__ rotate,
                                   const float* __restrict__ cexp, const float* __restrict__ sexp,
                                   int KH, int S, int hd) {
  __shared__ float red[32];
  const int b = blockIdx.x, h = blockIdx.y, i = threadIdx.x;
  const size_t row0 = ((size_t)b * KH + h) * S;  // scale index of the stripe's row 0
  const size_t stripe = row0 * hd;
  const size_t src = ((size_t)b * KH + h) * hd + i;
  const int kvp = kv_pos[b];
  const float kn = knew[src], vn = vnew[src];
  const float ksc = xq_row_scale(block_absmax(kn, red));
  const float vsc = xq_row_scale(block_absmax(vn, red));
  if (kvp >= 0 && kvp < S) {
    ck[stripe + (size_t)kvp * hd + i] = xq_code(kn, ksc);
    cv[stripe + (size_t)kvp * hd + i] = xq_code(vn, vsc);
    if (i == 0) {
      ks[row0 + kvp] = ksc;
      vs[row0 + kvp] = vsc;
    }
  }
  if (rotate[b] == 0) return;  // uniform over the block
  // a rotated row is never the inserted one (kv_pos >= KV_SINKS once wrapped)
  float v[KV_SINKS], sw[KV_SINKS];
#pragma unroll
  for (int r = 0; r < KV_SINKS; ++r) {
    const float sc = ks[row0 + r];
    const signed char* row = ck + stripe + (size_t)r * hd;
    v[r] = __fmul_rn((float)row[i], sc);
    const float p = __fmul_rn((float)row[i ^ 1], sc);
    sw[r] = (i & 1) ? p : -p;
  }
  const float c = cexp[i], s = sexp[i];
#pragma unroll
  for (int r = 0; r < KV_SINKS; ++r) {
    const float rot = __fadd_rn(__fmul_rn(v[r], c), __fmul_rn(sw[r], s));
    const float sc = xq_row_scale(block_absmax(rot, red));  // its barriers order reads before writes
    ck[stripe + (size_t)r * hd + i] = xq_code(rot, sc);
    if (i == 0) ks[row0 + r] = sc;
  }
}

template <int G>
__global__ void __launch_bounds__(FD_THREADS) flash_decode_q_split_kernel(
    const float* __restrict__ q, const signed char* __restrict__ ck,
    const signed char* __restrict__ cv, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ kv_len, float* __restrict__ pm,
    float* __restrict__ pl, float* __restrict__ pacc, int KH, int S, float sm_scale) {
  __shared__ __align__(16) float qs[G][FD_HD];
  __shared__ float sc[G][FD_CHUNK];
  __shared__ float red[FD_THREADS / 32][G][FD_HD];
  __shared__ float mrow[G], lrow[G];
  const int H = KH * G;
  const int b = blockIdx.x / KH, h = blockIdx.x % KH;
  const int split = blockIdx.y, NS = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = split * FD_CHUNK;
  const int n = min(FD_CHUNK, kv_len[b] - r0);  // rows of this chunk (<= 0: none)
  const size_t part0 = ((size_t)b * H + (size_t)h * G) * NS + split;  // head gi at + gi*NS

  if (n <= 0) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const size_t pi = part0 + (size_t)gi * NS;
      pacc[pi * FD_HD + tid] = 0.f;
      if (tid == 0) {
        pm[pi] = -INFINITY;
        pl[pi] = 0.f;
      }
    }
    return;
  }
  const size_t srow = ((size_t)b * KH + h) * S + r0;  // scale index of the chunk's row 0
  const size_t stripe = srow * FD_HD;
  for (int i = tid; i < G * FD_HD; i += FD_THREADS)
    qs[i / FD_HD][i % FD_HD] =
        __bfloat162float(__float2bfloat16_rn(q[((size_t)b * H + (size_t)h * G) * FD_HD + i]));
  __syncthreads();

  // phase 1: thread r scores key row r for the G heads: bf16 q times the
  // codes (exact products, f32 sums), then times k_scale / sqrt(hd)
  if (tid < n) {
    const int4* krow = reinterpret_cast<const int4*>(ck + stripe + (size_t)tid * FD_HD);
    float s[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) s[gi] = 0.f;
#pragma unroll
    for (int c = 0; c < FD_HD / 16; ++c) {  // all 8 loads of the row in flight
      const int4 raw = __ldg(krow + c);
      const signed char* kp = reinterpret_cast<const signed char*>(&raw);
      float kf[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) kf[e] = (float)kp[e];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
#pragma unroll
        for (int e = 0; e < 16; e += 4) {
          const float4 qa = *reinterpret_cast<const float4*>(&qs[gi][c * 16 + e]);
          s[gi] += qa.x * kf[e] + qa.y * kf[e + 1] + qa.z * kf[e + 2] + qa.w * kf[e + 3];
        }
      }
    }
    const float f = __fmul_rn(__ldg(ks + srow + tid), sm_scale);
#pragma unroll
    for (int gi = 0; gi < G; ++gi) sc[gi][tid] = s[gi] * f;
  }
  __syncthreads();

  // phase 2: per query head, the chunk max and the sum of p; keep
  // bf16(p * v_scale) for P.V
  for (int gi = warp; gi < G; gi += FD_THREADS / 32) {
    float mx = -INFINITY;
    for (int r = lane; r < n; r += 32) mx = fmaxf(mx, sc[gi][r]);
    mx = xq_warp_max(mx);
    float sum = 0.f;
    for (int r = lane; r < n; r += 32) {
      const float p = expf(sc[gi][r] - mx);
      sc[gi][r] = __bfloat162float(__float2bfloat16_rn(__fmul_rn(p, __ldg(vs + srow + r))));
      sum += p;
    }
    sum = xq_warp_sum(sum);
    if (lane == 0) {
      mrow[gi] = mx;
      lrow[gi] = sum;
    }
  }
  __syncthreads();

  // phase 3: un-normalised P.V over the codes; warp w takes rows w, w+4,
  // ... with the lane's 4 codes (one 4-byte load)
  float acc[G][4];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[gi][e] = 0.f;
#pragma unroll 8
  for (int r = warp; r < n; r += FD_THREADS / 32) {
    const int raw = __ldg(reinterpret_cast<const int*>(cv + stripe + (size_t)r * FD_HD + lane * 4));
    const signed char* vp = reinterpret_cast<const signed char*>(&raw);
    float vf[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) vf[e] = (float)vp[e];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const float p = sc[gi][r];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[gi][e] += p * vf[e];
    }
  }
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[warp][gi][lane * 4 + e] = acc[gi][e];
  __syncthreads();
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < FD_THREADS / 32; ++w) a += red[w][gi][tid];
    const size_t pi = part0 + (size_t)gi * NS;
    pacc[pi * FD_HD + tid] = a;
    if (tid == 0) {
      pm[pi] = mrow[gi];
      pl[pi] = lrow[gi];
    }
  }
}

template <int G>
cudaError_t launch_flash_decode_q_split(dim3 grid, cudaStream_t s, const float* q,
                                        const signed char* ck, const signed char* cv,
                                        const float* ks, const float* vs, const int* kv_len,
                                        float* pm, float* pl, float* pacc, int KH, int S,
                                        float sm_scale) {
  flash_decode_q_split_kernel<G><<<grid, FD_THREADS, 0, s>>>(q, ck, cv, ks, vs, kv_len, pm, pl,
                                                            pacc, KH, S, sm_scale);
  return cudaGetLastError();
}

constexpr int PF_HD = 128;
constexpr int PF_ROWS = 64;  // query rows per block (tq positions x G heads)
constexpr int PF_KT = 64;    // keys per tile
constexpr int LDQ = PF_HD + 8;  // bf16 row stride of the Q/K/V tiles
constexpr int LDP = PF_KT + 8;  // bf16 row stride of P
constexpr int LDS = PF_KT + 4;  // f32 row stride of the staged scores
constexpr int LDO = PF_HD + 4;  // f32 row stride of the staged P.V
constexpr int PF_SMEM = 3 * PF_ROWS * LDQ * 2 + 4 * 16 * LDP * 2 + 4 * 16 * LDO * 4;

__global__ void __launch_bounds__(128) flash_prefill_kernel(
    const float* __restrict__ q, const __nv_bfloat16* __restrict__ ck,
    const __nv_bfloat16* __restrict__ cv, const int* __restrict__ pos, float* __restrict__ out,
    int T, int H, int KH, int S, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + PF_ROWS * LDQ;
  __nv_bfloat16* Vs = Ks + PF_KT * LDQ;
  __nv_bfloat16* Ps = Vs + PF_KT * LDQ;
  float* Os = reinterpret_cast<float*>(Ps + 4 * 16 * LDP);  // scores alias its front
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / KH, h = blockIdx.x % KH;
  const int g = H / KH, tq = PF_ROWS / g;
  const int q0 = blockIdx.y * tq;
  const int pb = pos[b];
  const size_t stripe = ((size_t)b * KH + h) * S * PF_HD;

  // Q tile: row R = t_local * G + gi, cast to bf16; rows past T (a last,
  // partial tile) are zero and never written out
  for (int c = tid; c < PF_ROWS * (PF_HD / 4); c += 128) {
    const int R = c / (PF_HD / 4), col = (c % (PF_HD / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + R / g < T)
      v = *reinterpret_cast<const float4*>(
          q + (((size_t)b * T + q0 + R / g) * H + (size_t)h * g + R % g) * PF_HD + col);
    __nv_bfloat16* d = Qs + R * LDQ + col;
    d[0] = __float2bfloat16_rn(v.x);
    d[1] = __float2bfloat16_rn(v.y);
    d[2] = __float2bfloat16_rn(v.z);
    d[3] = __float2bfloat16_rn(v.w);
  }

  // this lane's row of the warp's 16 and its half of the columns
  const int r = lane >> 1, half = lane & 1;
  const int R = warp * 16 + r;
  const int qpos = pb + q0 + R / g;  // sees keys <= qpos
  float m_run = -INFINITY, l_run = 0.f;
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  __nv_bfloat16* Pw = Ps + warp * 16 * LDP;
  float* Ow = Os + warp * 16 * LDO;
  const int kend = pb + min(q0 + tq, T);  // keys >= kend are invisible to the tile

  for (int k0 = 0; k0 < kend; k0 += PF_KT) {
    __syncthreads();  // the previous tile is consumed (and Q is in place)
    for (int c = tid; c < PF_KT * (PF_HD / 8); c += 128) {
      const int row = c / (PF_HD / 8), col = (c % (PF_HD / 8)) * 8;
      const int key = k0 + row;
      int4 kv = make_int4(0, 0, 0, 0), vv = make_int4(0, 0, 0, 0);
      if (key < S) {
        kv = *reinterpret_cast<const int4*>(ck + stripe + (size_t)key * PF_HD + col);
        vv = *reinterpret_cast<const int4*>(cv + stripe + (size_t)key * PF_HD + col);
      }
      *reinterpret_cast<int4*>(Ks + row * LDQ + col) = kv;
      *reinterpret_cast<int4*>(Vs + row * LDQ + col) = vv;
    }
    __syncthreads();

    // S = Q_w . K^T (16 x 64), staged in the warp's O region
#pragma unroll
    for (int n = 0; n < PF_KT / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc;
      wmma::fill_fragment(sacc, 0.f);
#pragma unroll
      for (int kk = 0; kk < PF_HD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kb;
        wmma::load_matrix_sync(a, Qs + warp * 16 * LDQ + kk, LDQ);
        wmma::load_matrix_sync(kb, Ks + n * 16 * LDQ + kk, LDQ);
        wmma::mma_sync(sacc, a, kb, sacc);
      }
      wmma::store_matrix_sync(Ow + n * 16, sacc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax in f32 for (row r, keys half*32 .. +32)
    const float* srow = Ow + r * LDS + half * 32;
    float sv[32];
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int key = k0 + half * 32 + j;
      sv[j] = key <= qpos ? srow[j] * sm_scale : -INFINITY;
      mt = fmaxf(mt, sv[j]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    const float m_new = fmaxf(m_run, mt);
    const float alpha = m_new == -INFINITY ? 1.f : expf(m_run - m_new);
    float psum = 0.f;
    __nv_bfloat16* prow = Pw + r * LDP + half * 32;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = sv[j] == -INFINITY ? 0.f : expf(sv[j] - m_new);
      psum += p;
      prow[j] = __float2bfloat16_rn(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l_run = l_run * alpha + psum;
    m_run = m_new;
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] *= alpha;
    __syncwarp();

    // P.V (16 x 128) on bf16 fragments, staged, then added to the registers
#pragma unroll
    for (int n = 0; n < PF_HD / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> pacc;
      wmma::fill_fragment(pacc, 0.f);
#pragma unroll
      for (int kk = 0; kk < PF_KT; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vb;
        wmma::load_matrix_sync(a, Pw + kk, LDP);
        wmma::load_matrix_sync(vb, Vs + kk * LDQ + n * 16, LDQ);
        wmma::mma_sync(pacc, a, vb, pacc);
      }
      wmma::store_matrix_sync(Ow + n * 16, pacc, LDO, wmma::mem_row_major);
    }
    __syncwarp();
    const float* orow = Ow + r * LDO + half * 64;
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] += orow[i];
    __syncwarp();  // the next tile's scores overwrite Ow
  }

  if (q0 + R / g >= T) return;
  const float ldiv = l_run > 0.f ? l_run : 1.f;
  float* dst = out + (((size_t)b * T + q0 + R / g) * H + (size_t)h * g + R % g) * PF_HD + half * 64;
#pragma unroll
  for (int i = 0; i < 64; i += 4)
    *reinterpret_cast<float4*>(dst + i) =
        make_float4(o[i] / ldiv, o[i + 1] / ldiv, o[i + 2] / ldiv, o[i + 3] / ldiv);
}

}  // namespace

XQ_EXPORT int xq_kv_update(void* ck, void* cv, const void* knew, const void* vnew,
                           const void* kv_pos, const void* rotate, const void* cexp,
                           const void* sexp, int B, int KH, int S, int hd, void* stream) {
  if (hd < 2 || hd > 1024 || hd % 2 != 0) return (int)cudaErrorInvalidValue;
  kv_update_kernel<<<dim3(B, KH), hd, 0, static_cast<cudaStream_t>(stream)>>>(
      (__nv_bfloat16*)ck, (__nv_bfloat16*)cv, (const float*)knew, (const float*)vnew,
      (const int*)kv_pos, (const int*)rotate, (const float*)cexp, (const float*)sexp, KH, S, hd);
  return (int)cudaGetLastError();
}

// f32 elements of the flash-decode workspace: per (batch, head, chunk) the
// partial max, the partial sum and the FD_HD-wide partial accumulator
XQ_EXPORT long long xq_flash_decode_workspace(int B, int H, int S) {
  const long long ns = (S + FD_CHUNK - 1) / FD_CHUNK;
  return (long long)B * H * ns * (FD_HD + 2);
}

XQ_EXPORT int xq_flash_decode(const void* q, const void* ck, const void* cv, const void* kv_len,
                              void* work, void* out, int B, int H, int KH, int S, int hd,
                              float sm_scale, void* stream) {
  if (hd != FD_HD || KH < 1 || H % KH != 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int NS = (S + FD_CHUNK - 1) / FD_CHUNK;
  const size_t parts = (size_t)B * H * NS;
  float* pm = (float*)work;
  float* pl = pm + parts;
  float* pacc = pl + parts;
  const dim3 grid(B * KH, NS);
  const float* qf = (const float*)q;
  const auto* k = (const __nv_bfloat16*)ck;
  const auto* v = (const __nv_bfloat16*)cv;
  const int* kl = (const int*)kv_len;
  cudaError_t e;
  switch (H / KH) {  // the GQA group size, a compile-time constant inside
    case 1: e = launch_flash_decode_split<1>(grid, s, qf, k, v, kl, pm, pl, pacc, KH, S, sm_scale); break;
    case 2: e = launch_flash_decode_split<2>(grid, s, qf, k, v, kl, pm, pl, pacc, KH, S, sm_scale); break;
    case 4: e = launch_flash_decode_split<4>(grid, s, qf, k, v, kl, pm, pl, pacc, KH, S, sm_scale); break;
    case 8: e = launch_flash_decode_split<8>(grid, s, qf, k, v, kl, pm, pl, pacc, KH, S, sm_scale); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  flash_decode_combine_kernel<<<B * H, FD_HD, 0, s>>>(pm, pl, pacc, (float*)out, NS);
  return (int)cudaGetLastError();
}

XQ_EXPORT int xq_flash_prefill(const void* q, const void* ck, const void* cv, const void* pos,
                               void* out, int B, int T, int H, int KH, int S, int hd,
                               float sm_scale, void* stream) {
  if (hd != PF_HD || KH < 1 || H % KH != 0 || PF_ROWS % (H / KH) != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = xq_allow_smem(flash_prefill_kernel, PF_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int tq = PF_ROWS / (H / KH);
  flash_prefill_kernel<<<dim3(B * KH, (T + tq - 1) / tq), 128, PF_SMEM, static_cast<cudaStream_t>(stream)>>>(
      (const float*)q, (const __nv_bfloat16*)ck, (const __nv_bfloat16*)cv, (const int*)pos,
      (float*)out, T, H, KH, S, sm_scale);
  return (int)cudaGetLastError();
}

XQ_EXPORT int xq_kv_update_q(void* ck, void* cv, void* ks, void* vs, const void* knew,
                             const void* vnew, const void* kv_pos, const void* rotate,
                             const void* cexp, const void* sexp, int B, int KH, int S, int hd,
                             void* stream) {
  if (hd < 32 || hd > 1024 || hd % 32 != 0) return (int)cudaErrorInvalidValue;
  kv_update_q_kernel<<<dim3(B, KH), hd, 0, static_cast<cudaStream_t>(stream)>>>(
      (signed char*)ck, (signed char*)cv, (float*)ks, (float*)vs, (const float*)knew,
      (const float*)vnew, (const int*)kv_pos, (const int*)rotate, (const float*)cexp,
      (const float*)sexp, KH, S, hd);
  return (int)cudaGetLastError();
}

// workspace: xq_flash_decode_workspace (the same partials)
XQ_EXPORT int xq_flash_decode_q(const void* q, const void* ck, const void* cv, const void* ks,
                                const void* vs, const void* kv_len, void* work, void* out, int B,
                                int H, int KH, int S, int hd, float sm_scale, void* stream) {
  if (hd != FD_HD || KH < 1 || H % KH != 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int NS = (S + FD_CHUNK - 1) / FD_CHUNK;
  const size_t parts = (size_t)B * H * NS;
  float* pm = (float*)work;
  float* pl = pm + parts;
  float* pacc = pl + parts;
  const dim3 grid(B * KH, NS);
  const float* qf = (const float*)q;
  const auto* k = (const signed char*)ck;
  const auto* v = (const signed char*)cv;
  const auto* kss = (const float*)ks;
  const auto* vss = (const float*)vs;
  const int* kl = (const int*)kv_len;
  cudaError_t e;
  switch (H / KH) {  // the GQA group size, a compile-time constant inside
    case 1: e = launch_flash_decode_q_split<1>(grid, s, qf, k, v, kss, vss, kl, pm, pl, pacc, KH, S, sm_scale); break;
    case 2: e = launch_flash_decode_q_split<2>(grid, s, qf, k, v, kss, vss, kl, pm, pl, pacc, KH, S, sm_scale); break;
    case 4: e = launch_flash_decode_q_split<4>(grid, s, qf, k, v, kss, vss, kl, pm, pl, pacc, KH, S, sm_scale); break;
    case 8: e = launch_flash_decode_q_split<8>(grid, s, qf, k, v, kss, vss, kl, pm, pl, pacc, KH, S, sm_scale); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  flash_decode_combine_kernel<<<B * H, FD_HD, 0, s>>>(pm, pl, pacc, (float*)out, NS);
  return (int)cudaGetLastError();
}
