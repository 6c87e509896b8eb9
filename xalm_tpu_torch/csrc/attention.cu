// Decode ring update, flash-decode and causal flash-prefill attention over
// the stacked StreamingLLM cache, bf16, f32 or int8 with per-row scales, for
// Hopper (sm_90a). The float kernels (1, 2, 5) take a bf16 or an f32 cache
// (the TPU kernels' supported_cache_dtype), the cache type a template
// parameter of 1 and 2, and of 5 a kernel of its own (5b).
//
// The cache pointers given to every function are one layer of the
// (L, B, KH, S, hd) planes (the caller offsets by the layer), S being the
// physical window (padded to a multiple of 32).
//
// 1. xq_kv_update replaces xalm_tpu/ops/pallas_attention.py::_update_kernel.
//    Grid (B, KH), one thread per head dim. Writes the new K/V row (f32 ->
//    bf16, or as it is in an f32 cache) at kv_pos (dropped when kv_pos >= S:
//    the sentinel), then, for wrapped rows, rotates the KV_SINKS sink keys
//    by one position with the interleaved-pair rope: out = v*cexp +
//    swap(v)*sexp, swap[2j] = -v[2j+1], swap[2j+1] = v[2j], each product
//    and the sum rounded separately as in the plain version. Bound: bytes, and at a few KB per layer it is launch
//    latency; it stays a separate launch before attention on the same stream
//    because fusing it into attention would race on the row being written.
//
// 2. xq_flash_decode replaces _attn_kernel. The TPU grid walks the
//    sequence in order carrying a running max and sum; blocks on the card
//    run in no order, so the sequence is split into 128-row chunks, one
//    block per (batch, kv head, chunk): phase 1 scores the chunk for the
//    head's G query heads (f32 dots over the bf16 or f32 cache, one thread
//    per key row, 16-byte loads, q broadcast from shared memory: no shuffle
//    chains on the critical path), phase 2 takes each head's chunk max and
//    exp-sums, phase 3 forms the un-normalised P.V, each warp over a quarter
//    of the rows (coalesced loads of a lane's 4 or 8 values, several rows in
//    flight), summed across the warps.
//    A second small kernel combines the chunks' (max, sum, acc) partials.
//    Chunks past kv_len exit at once; kv_len == 0 gives 0, not NaN. The
//    GQA group G = H / KH and the head dim HD are template parameters,
//    instantiated for each G in 1..8 (Qwen2.5-7B has G = 7, Qwen2.5-14B
//    G = 5) and HD in {96, 128, 256} (Phi-3; Llama, Mistral and Qwen; Gemma
//    and Gemma-2), dispatched at run time. In phase 3 a lane holds 4 of a
//    V row's dims (HD 96: lanes 24..31 idle) or 8 (HD 256). Bound: bytes
//    (the cache rows up to kv_len, read once).
//
// 3. xq_kv_update_q replaces _insert_q_kernel and _sink_q_kernel in one
//    launch, over an int8 cache with per-row f32 scale planes (L, B, KH, S).
//    Grid (B, KH), one thread per head dim (96, 128 or 256: any multiple of
//    32 up to 1024). Quantises the new K and V
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
//    the bytes of the bf16 cache). G in 1..8 and HD in {96, 128, 256}, as in
//    2 (a lane holds 4 V codes, or 8 at HD 256).
//
// 5. xq_flash_prefill replaces _prefill_kernel (FlashAttention-3's shape,
//    in its simple form; the Hopper pieces are hopper.cuh's). One block per
//    (batch x kv head, 2 * 64 / G whole query positions): two warpgroups
//    of 64 query rows each (row R = t_local * G + gi; for a group that does
//    not divide 64, G = 3, 5, 6, 7, the last 64 mod G rows of each are
//    padding, never written). A ring of 64-key K and V tiles, stages
//    tiles ahead of the one being multiplied (the last warp done with a
//    stage refills it, so no warp waits on another), is filled by TMA
//    from the layer's (B * KH, S, hd) view (a 3-D tensor map: keys past S
//    read as zeros, never the next stripe), in 64-column (128-byte
//    swizzled) panels: hd 96 takes two, the second half zeros. Each
//    warpgroup casts its Q rows to bf16 into the same swizzled layout, then
//    per key tile up to the block's causal limit (later tiles are never
//    loaded): S = Q . K^T by wgmma m64n64k16 from shared memory (both
//    K-major: the cache rows are the B operand as they lie), the causal mask
//    and the online softmax in f32 on the accumulator registers (a row's
//    state in the 4 lanes that hold it), p cast to bf16 at the running max
//    straight into the register A operand of the second wgmma, O += P . V
//    (m64n{hd}k16, V MN-major through the transpose bit). The two
//    warpgroups overlap each other (one's softmax, the other's products);
//    within one the steps run in order: ptxas serialises the wgmmas
//    (C7514) when the softmax reads S while P . V is in flight. O stays in
//    registers (hd / 2 floats a thread: 128 at hd 256, with S and P more
//    than the 168 a block with a producer warp allows: see PF_THREADS). No
//    S, P or O passes through shared memory. Blocks start with the last
//    (longest) query tiles so the causal tail does not idle SMs. Shared
//    memory: Q and 3 stages, 128 KB at hd 96 and 128; Q and 2 stages, 193 KB
//    at hd 256. Bound: operations at T = 512 (989 TFLOP/s bf16), bytes at
//    small T.
//
// 5b. xq_flash_prefill over an f32 cache replaces _prefill_kernel with its
//    f32 compute_dtype: nothing is rounded to bf16, so the bf16 WMMA tiles
//    cannot serve and TF32 would round; flash_prefill_f32_kernel runs both
//    dots in f32 FMA on the CUDA cores (see its note), the same rows,
//    causal limit and online softmax. Bound: f32 operations at T = 512
//    (67 TFLOP/s).

#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int KV_SINKS = 2;

template <typename CT>
__global__ void kv_update_kernel(CT* __restrict__ ck, CT* __restrict__ cv,
                                 const float* __restrict__ knew, const float* __restrict__ vnew,
                                 const int* __restrict__ kv_pos, const int* __restrict__ rotate,
                                 const float* __restrict__ cexp, const float* __restrict__ sexp,
                                 int KH, int S, int hd) {
  const int b = blockIdx.x, h = blockIdx.y, i = threadIdx.x;
  const size_t stripe = ((size_t)b * KH + h) * S * hd;
  const size_t src = ((size_t)b * KH + h) * hd + i;
  const int kvp = kv_pos[b];
  if (kvp >= 0 && kvp < S) {
    ck[stripe + (size_t)kvp * hd + i] = xq_to_cache<CT>(knew[src]);
    cv[stripe + (size_t)kvp * hd + i] = xq_to_cache<CT>(vnew[src]);
  }
  if (rotate[b] == 0) return;  // uniform over the block
  __syncthreads();
  float v[KV_SINKS], sw[KV_SINKS];
#pragma unroll
  for (int r = 0; r < KV_SINKS; ++r) {
    const CT* row = ck + stripe + (size_t)r * hd;
    v[r] = xq_from_cache(row[i]);
    const float p = xq_from_cache(row[i ^ 1]);
    sw[r] = (i & 1) ? p : -p;
  }
  __syncthreads();
  const float c = cexp[i], s = sexp[i];
#pragma unroll
  for (int r = 0; r < KV_SINKS; ++r)
    ck[stripe + (size_t)r * hd + i] =
        xq_to_cache<CT>(__fadd_rn(__fmul_rn(v[r], c), __fmul_rn(sw[r], s)));
}

constexpr int FD_THREADS = 128;
constexpr int FD_CHUNK = 128;  // key rows per block: one per thread in phase 1
constexpr int FD_MAX_G = 8;    // GQA groups 1..8, one instantiation each

// launch(std::integral_constant<int, G>{}) for the GQA group g, so that G is
// a compile-time constant inside the kernel it launches, then
// cudaGetLastError(); a g outside 1..FD_MAX_G launches nothing and gives
// cudaErrorInvalidValue
template <int G = 1, typename Launch>
cudaError_t for_group(int g, Launch launch) {
  if constexpr (G > FD_MAX_G) {
    return cudaErrorInvalidValue;
  } else {
    if (g != G) return for_group<G + 1>(g, launch);
    launch(std::integral_constant<int, G>{});
    return cudaGetLastError();
  }
}

// launch(std::integral_constant<int, HD>{}) for the head dims the attention
// kernels are built for (Phi-3's 96; 128; Gemma's 256), returning what it
// returns; any other hd gives cudaErrorInvalidValue
template <typename Launch>
cudaError_t for_head_dim(int hd, Launch launch) {
  switch (hd) {
    case 96: return launch(std::integral_constant<int, 96>{});
    case 128: return launch(std::integral_constant<int, 128>{});
    case 256: return launch(std::integral_constant<int, 256>{});
    default: return cudaErrorInvalidValue;
  }
}

// phase 3 of the flash-decodes: a lane holds VPL consecutive dims of a V
// row, the first HD / VPL lanes of each warp (HD 96: 24 lanes of 4)
template <int HD>
__host__ __device__ constexpr int fd_vpl() { return HD == 256 ? 8 : 4; }

// VPL consecutive values of a float cache row as f32: 8 or 16 bytes of
// bf16, 16 or 32 of f32
template <typename CT, int VPL>
__device__ __forceinline__ void load_cache(const CT* p, float* out) {
  if constexpr (sizeof(CT) == 4) {
#pragma unroll
    for (int c = 0; c < VPL / 4; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(p + 4 * c);
      out[4 * c] = v.x;
      out[4 * c + 1] = v.y;
      out[4 * c + 2] = v.z;
      out[4 * c + 3] = v.w;
    }
  } else if constexpr (VPL == 8) {
    const int4 raw = *reinterpret_cast<const int4*>(p);
    const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = __bfloat162float(v[e]);
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = __bfloat162float(v[e]);
  }
}

template <int VPL>
__device__ __forceinline__ void load_s8(const signed char* p, float* out) {
  if constexpr (VPL == 8) {
    const int2 raw = __ldg(reinterpret_cast<const int2*>(p));
    const signed char* v = reinterpret_cast<const signed char*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = (float)v[e];
  } else {
    const int raw = __ldg(reinterpret_cast<const int*>(p));
    const signed char* v = reinterpret_cast<const signed char*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = (float)v[e];
  }
}

template <int G, int HD, typename CT>
__global__ void __launch_bounds__(FD_THREADS) flash_decode_split_kernel(
    const float* __restrict__ q, const CT* __restrict__ ck,
    const CT* __restrict__ cv, const int* __restrict__ kv_len,
    float* __restrict__ pm, float* __restrict__ pl, float* __restrict__ pacc,
    int KH, int S, float sm_scale) {
  constexpr int VPL = fd_vpl<HD>(), NL = HD / VPL;
  __shared__ __align__(16) float qs[G][HD];
  __shared__ float sc[G][FD_CHUNK];
  __shared__ float red[FD_THREADS / 32][G][HD];
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
      for (int d = tid; d < HD; d += FD_THREADS) pacc[pi * HD + d] = 0.f;
      if (tid == 0) {
        pm[pi] = -INFINITY;
        pl[pi] = 0.f;
      }
    }
    return;
  }
  const size_t stripe = ((size_t)b * KH + h) * S * HD;
  for (int i = tid; i < G * HD; i += FD_THREADS)
    qs[i / HD][i % HD] = q[((size_t)b * H + (size_t)h * G) * HD + i] * sm_scale;
  __syncthreads();

  // phase 1: thread r scores key row r for the G heads; f32 dots, 16-byte
  // loads (8 bf16 or 4 f32 values), q broadcast from shared memory
  if (tid < n) {
    constexpr int PER = 16 / sizeof(CT);
    const int4* krow = reinterpret_cast<const int4*>(ck + stripe + (size_t)(r0 + tid) * HD);
    float s[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) s[gi] = 0.f;
#pragma unroll
    for (int c = 0; c < HD / PER; ++c) {  // every load of the row in flight
      const int4 raw = __ldg(krow + c);
      float kf[PER];
      load_cache<CT, PER>(reinterpret_cast<const CT*>(&raw), kf);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
#pragma unroll
        for (int e = 0; e < PER; e += 4) {
          const float4 qa = *reinterpret_cast<const float4*>(&qs[gi][c * PER + e]);
          s[gi] += qa.x * kf[e] + qa.y * kf[e + 1] + qa.z * kf[e + 2] + qa.w * kf[e + 3];
        }
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
  // lane's VPL dims (unrolled so several rows are in flight), then the four
  // warps' partial sums add up through shared memory
  float acc[G][VPL];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int e = 0; e < VPL; ++e) acc[gi][e] = 0.f;
  if (lane < NL) {
#pragma unroll 8
    for (int r = warp; r < n; r += FD_THREADS / 32) {
      float vf[VPL];
      load_cache<CT, VPL>(cv + stripe + (size_t)(r0 + r) * HD + lane * VPL, vf);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float p = sc[gi][r];
#pragma unroll
        for (int e = 0; e < VPL; ++e) acc[gi][e] += p * vf[e];
      }
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int e = 0; e < VPL; ++e) red[warp][gi][lane * VPL + e] = acc[gi][e];
  }
  __syncthreads();
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const size_t pi = part0 + (size_t)gi * NS;
    for (int d = tid; d < HD; d += FD_THREADS) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < FD_THREADS / 32; ++w) a += red[w][gi][d];
      pacc[pi * HD + d] = a;
    }
    if (tid == 0) {
      pm[pi] = mrow[gi];
      pl[pi] = lrow[gi];
    }
  }
}

// one block of hd threads per (batch, head): the chunks' partials combined
__global__ void __launch_bounds__(1024) flash_decode_combine_kernel(
    const float* __restrict__ pm, const float* __restrict__ pl, const float* __restrict__ pacc,
    float* __restrict__ out, int NS) {
  const size_t bh = blockIdx.x;
  const int t = threadIdx.x, hd = blockDim.x;
  float mx = -INFINITY;
  for (int s = 0; s < NS; ++s) mx = fmaxf(mx, pm[bh * NS + s]);
  float l = 0.f, a = 0.f;
  if (mx != -INFINITY) {
    for (int s = 0; s < NS; ++s) {
      const float m = pm[bh * NS + s];
      if (m == -INFINITY) continue;
      const float w = expf(m - mx);
      l += w * pl[bh * NS + s];
      a += w * pacc[(bh * NS + s) * hd + t];
    }
  }
  out[bh * hd + t] = l > 0.f ? a / l : 0.f;  // kv_len == 0 -> 0
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

template <int G, int HD>
__global__ void __launch_bounds__(FD_THREADS) flash_decode_q_split_kernel(
    const float* __restrict__ q, const signed char* __restrict__ ck,
    const signed char* __restrict__ cv, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ kv_len, float* __restrict__ pm,
    float* __restrict__ pl, float* __restrict__ pacc, int KH, int S, float sm_scale) {
  constexpr int VPL = fd_vpl<HD>(), NL = HD / VPL;
  __shared__ __align__(16) float qs[G][HD];
  __shared__ float sc[G][FD_CHUNK];
  __shared__ float red[FD_THREADS / 32][G][HD];
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
      for (int d = tid; d < HD; d += FD_THREADS) pacc[pi * HD + d] = 0.f;
      if (tid == 0) {
        pm[pi] = -INFINITY;
        pl[pi] = 0.f;
      }
    }
    return;
  }
  const size_t srow = ((size_t)b * KH + h) * S + r0;  // scale index of the chunk's row 0
  const size_t stripe = srow * HD;
  for (int i = tid; i < G * HD; i += FD_THREADS)
    qs[i / HD][i % HD] =
        __bfloat162float(__float2bfloat16_rn(q[((size_t)b * H + (size_t)h * G) * HD + i]));
  __syncthreads();

  // phase 1: thread r scores key row r for the G heads: bf16 q times the
  // codes (exact products, f32 sums), then times k_scale / sqrt(hd)
  if (tid < n) {
    const int4* krow = reinterpret_cast<const int4*>(ck + stripe + (size_t)tid * HD);
    float s[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) s[gi] = 0.f;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {  // every load of the row in flight
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
  // ... with the lane's VPL codes (one 4- or 8-byte load)
  float acc[G][VPL];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int e = 0; e < VPL; ++e) acc[gi][e] = 0.f;
  if (lane < NL) {
#pragma unroll 8
    for (int r = warp; r < n; r += FD_THREADS / 32) {
      float vf[VPL];
      load_s8<VPL>(cv + stripe + (size_t)r * HD + lane * VPL, vf);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float p = sc[gi][r];
#pragma unroll
        for (int e = 0; e < VPL; ++e) acc[gi][e] += p * vf[e];
      }
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int e = 0; e < VPL; ++e) red[warp][gi][lane * VPL + e] = acc[gi][e];
  }
  __syncthreads();
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const size_t pi = part0 + (size_t)gi * NS;
    for (int d = tid; d < HD; d += FD_THREADS) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < FD_THREADS / 32; ++w) a += red[w][gi][d];
      pacc[pi * HD + d] = a;
    }
    if (tid == 0) {
      pm[pi] = mrow[gi];
      pl[pi] = lrow[gi];
    }
  }
}

constexpr int PF_ROWS = 64;  // query rows of a warpgroup (of a block, f32 cache)
constexpr int PF_KT = 64;    // keys per tile
// two warpgroups a block and no producer warp: a ninth warp would put three
// on one of the SM's four register files and cap every thread at 168
// registers, short of hd 256's O tile (128 floats) with S and P beside it
constexpr int PF_THREADS = 256;

// 64-column (128-byte) panels of a row of hd bf16 values, ring stages, and
// the dynamic shared memory of a block: Q (128 rows), the K and V tiles of
// each stage, 2 barriers and a counter a stage, and the slack to align to 1024
template <int HD>
__host__ __device__ constexpr int pf_panels() { return (HD + 63) / 64; }
template <int HD>
__host__ __device__ constexpr int pf_stages() { return HD == 256 ? 2 : 3; }
template <int HD>
__host__ __device__ constexpr int pf_smem() {
  return pf_panels<HD>() * (2 * PF_ROWS * 128 + pf_stages<HD>() * 2 * PF_KT * 128) +
         3 * pf_stages<HD>() * 8 + 1024;
}

// A block's query positions at GQA group g (two warpgroups of PF_ROWS / g
// whole positions), a T-row chunk's blocks, and the first position of block
// y: the longest tiles (the largest q0, the most visible keys) launch first,
// so the causal tail does not leave SMs idle
__host__ __device__ inline int pf_tq(int g) { return 2 * (PF_ROWS / g); }
__host__ __device__ inline int pf_blocks(int T, int g) { return (T + pf_tq(g) - 1) / pf_tq(g); }
__host__ __device__ inline int pf_q0(int T, int g, int y) {
  return (pf_blocks(T, g) - 1 - y) * pf_tq(g);
}

template <int HD>
__global__ void __launch_bounds__(PF_THREADS, 1) flash_prefill_kernel(
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const float* __restrict__ q, const int* __restrict__ pos, float* __restrict__ out, int T,
    int H, int KH, float sm_scale) {
  constexpr int NP = pf_panels<HD>(), ST = pf_stages<HD>();
  constexpr int QP = 2 * PF_ROWS * 128;  // bytes of a Q panel (the block's 128 rows)
  constexpr int TP = PF_KT * 128;        // bytes of a K or V panel
  constexpr int STAGE = 2 * NP * TP;     // K panels, then V panels
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = xq_align1024(smem_raw);
  unsigned char* kv = qs + NP * QP;
  uint64_t* fullk = reinterpret_cast<uint64_t*>(kv + ST * STAGE);
  uint64_t* fullv = fullk + ST;
  int* released = reinterpret_cast<int*>(fullv + ST);  // warps done with each stage, ever
  const int bh = blockIdx.x, b = bh / KH, h = bh % KH;
  const int g = H / KH, tqw = PF_ROWS / g;  // whole positions of a warpgroup
  const int q0 = pf_q0(T, g, blockIdx.y);
  const int pb = pos[b];
  const int kend = pb + min(q0 + 2 * tqw, T);  // keys >= kend are invisible to the block
  const int ntiles = (kend + PF_KT - 1) / PF_KT;
  // the copies of key tile j into stage j % ST (its previous tile released)
  auto load = [&](int j) {
    const int s = j % ST;
    unsigned char* st = kv + s * STAGE;
    xq_mbar_expect_tx(&fullk[s], NP * TP);
    for (int p = 0; p < NP; ++p) xq_tma_3d(st + p * TP, &tk, 64 * p, j * PF_KT, bh, &fullk[s]);
    xq_mbar_expect_tx(&fullv[s], NP * TP);
    for (int p = 0; p < NP; ++p)
      xq_tma_3d(st + (NP + p) * TP, &tv, 64 * p, j * PF_KT, bh, &fullv[s]);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      xq_mbar_init(&fullk[s], 1);
      xq_mbar_init(&fullv[s], 1);
      released[s] = 0;
    }
    xq_mbar_fence_init();
    for (int j = 0; j < ST && j < ntiles; ++j) load(j);
  }
  __syncthreads();

  const int t = threadIdx.x % 128, c = threadIdx.x / 128, warp = t / 32, lane = t % 32;
  // this warpgroup's 64 Q rows as bf16, 16-byte chunk ch of row r at chunk
  // ch ^ (r % 8) of its panel row (the TMA's 128-byte swizzle)
  unsigned char* qw = qs + c * PF_ROWS * 128;
  constexpr int CH = HD / 8;
  for (int i = t; i < PF_ROWS * CH; i += 128) {
    const int r = i / CH, ch = i % CH, tl = r / g, tpos = q0 + c * tqw + tl;
    float4 v0 = make_float4(0.f, 0.f, 0.f, 0.f), v1 = v0;
    if (tl < tqw && tpos < T) {
      const float* src = q + (((size_t)b * T + tpos) * H + (size_t)h * g + r % g) * HD + ch * 8;
      v0 = *reinterpret_cast<const float4*>(src);
      v1 = *reinterpret_cast<const float4*>(src + 4);
    }
    *reinterpret_cast<uint4*>(qw + (ch / 8) * QP + r * 128 + (((ch % 8) ^ (r & 7)) * 16)) =
        make_uint4(xq_bf16x2(v0.x, v0.y), xq_bf16x2(v0.z, v0.w), xq_bf16x2(v1.x, v1.y),
                   xq_bf16x2(v1.z, v1.w));
  }
  xq_fence_proxy_async();  // the writes, before wgmma reads them
  xq_bar_sync(1 + c, 128);

  // this thread's rows 16 warp + lane / 4 + 8 hh of the warpgroup's 64
  int qpos[2];
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) qpos[hh] = pb + q0 + c * tqw + (16 * warp + lane / 4 + 8 * hh) / g;
  float o[HD / 2];
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) o[j] = 0.f;
  const uint32_t qa = xq_smem(qw);

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % ST, ph = (it / ST) & 1, k0 = it * PF_KT;
    const uint32_t ka = xq_smem(kv + s * STAGE), va = ka + NP * TP;
    float sc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = 0.f;
    xq_mbar_wait(&fullk[s], ph);
    xq_fence_regs(sc);
    xq_wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)  // 16 values (32 bytes) of depth a step
      xq_wgmma_bf16_ss_n64(sc, xq_desc(qa + (ks / 4) * QP + (ks % 4) * 32, 16, 1024),
                           xq_desc(ka + (ks / 4) * TP + (ks % 4) * 32, 16, 1024));
    xq_wgmma_commit();
    xq_wgmma_wait<0>();
    xq_fence_regs(sc);

    // online softmax: element j is row hh = (j / 2) % 2, key k0 + 8 (j / 4) + 2 (lane % 4) + j % 2
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int hh = (j >> 1) & 1, key = k0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
      sc[j] = key <= qpos[hh] ? sc[j] * sm_scale : -INFINITY;
      mt[hh] = fmaxf(mt[hh], sc[j]);
    }
    float alpha[2], m_new[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(0xffffffffu, mt[hh], 1));
      mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(0xffffffffu, mt[hh], 2));
      m_new[hh] = fmaxf(m_run[hh], mt[hh]);
      alpha[hh] = m_new[hh] == -INFINITY ? 1.f : expf(m_run[hh] - m_new[hh]);
    }
    uint32_t pa[4][4];  // the P . V k-steps' A operands: keys 16 kk .. 16 kk + 15
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const int hh = (j >> 1) & 1;
      const float p0 = sc[j] == -INFINITY ? 0.f : expf(sc[j] - m_new[hh]);
      const float p1 = sc[j + 1] == -INFINITY ? 0.f : expf(sc[j + 1] - m_new[hh]);
      psum[hh] += p0 + p1;
      pa[j >> 3][(j >> 1) & 3] = xq_bf16x2(p0, p1);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      psum[hh] += __shfl_xor_sync(0xffffffffu, psum[hh], 1);
      psum[hh] += __shfl_xor_sync(0xffffffffu, psum[hh], 2);
      l_run[hh] = l_run[hh] * alpha[hh] + psum[hh];
      m_run[hh] = m_new[hh];
    }
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) o[j] *= alpha[(j >> 1) & 1];

    xq_mbar_wait(&fullv[s], ph);
    xq_fence_regs(o);
    xq_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PF_KT / 16; ++kk) {  // V rows 16 kk ..: 16 keys of 128 bytes
      const uint64_t dv = xq_desc(va + kk * 16 * 128, TP, 1024);
      if constexpr (HD == 96) xq_wgmma_bf16_rs_n96(o, pa[kk], dv);
      else if constexpr (HD == 128) xq_wgmma_bf16_rs_n128(o, pa[kk], dv);
      else xq_wgmma_bf16_rs_n256(o, pa[kk], dv);
    }
    xq_wgmma_commit();
    xq_wgmma_wait<0>();
    xq_fence_regs(o);
    // the last of the 8 warps done with this stage refills it with tile
    // it + ST: no warp waits for another to free a stage
    __syncwarp();
    if (lane == 0 && it + ST < ntiles) {
      __threadfence_block();
      if (atomicAdd(&released[s], 1) == 8 * (it / ST) + 7) load(it + ST);
    }
    __syncwarp();
  }

  // O / l: element j is row hh = (j / 2) % 2, column 8 (j / 4) + 2 (lane % 4) + j % 2
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * warp + lane / 4 + 8 * hh, tl = r / g, tpos = q0 + c * tqw + tl;
    if (tl >= tqw || tpos >= T) continue;
    const float ldiv = l_run[hh] > 0.f ? l_run[hh] : 1.f;
    float* dst = out + (((size_t)b * T + tpos) * H + (size_t)h * g + r % g) * HD + 2 * (lane & 3);
#pragma unroll
    for (int qq = 0; qq < HD / 8; ++qq)
      *reinterpret_cast<float2*>(dst + 8 * qq) =
          make_float2(o[4 * qq + 2 * hh] / ldiv, o[4 * qq + 2 * hh + 1] / ldiv);
  }
}

// Flash prefill over a bf16 cache: tensor maps of the layer's K and V as
// (B * KH, S, hd) (64-column boxes of 64 keys), then one block per (batch x
// kv head, 2 * 64 / G positions), the last query tiles first
template <int HD>
cudaError_t launch_flash_prefill(const float* q, const __nv_bfloat16* ck, const __nv_bfloat16* cv,
                                 const int* pos, float* out, int B, int T, int H, int KH, int S,
                                 float sm_scale, cudaStream_t s) {
  CUtensorMap tk, tv;
  const uint64_t dims[3] = {(uint64_t)HD, (uint64_t)S, (uint64_t)B * KH};
  const uint64_t strides[2] = {(uint64_t)HD * 2, (uint64_t)S * HD * 2};
  const uint32_t box[3] = {64, PF_KT, 1};
  if (!xq_tensor_map(&tk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ck, dims, strides, box) ||
      !xq_tensor_map(&tv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, cv, dims, strides, box))
    return cudaErrorInvalidConfiguration;
  cudaError_t e = xq_allow_smem(flash_prefill_kernel<HD>, pf_smem<HD>());
  if (e != cudaSuccess) return e;
  const dim3 grid(B * KH, pf_blocks(T, H / KH));
  flash_prefill_kernel<HD><<<grid, PF_THREADS, pf_smem<HD>(), s>>>(tk, tv, q, pos, out, T, H, KH,
                                                            sm_scale);
  return cudaGetLastError();
}

// The f32-cache prefill: the row layout, causal limit and online softmax of
// flash_prefill_kernel, with both dots in f32 FMA (no bf16 rounding of q,
// k, v or p; no TF32). 256 threads as 16 x 16: thread (ty, tx) owns rows
// 4 ty .. 4 ty + 3, the keys tx + 16 j of a tile and the float4 columns
// tx + 16 j of the output. Q, K and V tiles are f32 in shared memory, so a
// key tile is 32 rows at HD 256 (64 at 96 and 128): 139 KB there, 116 KB
// at HD 128, 92 KB at 96.
template <int HD>
__host__ __device__ constexpr int pf32_kt() { return HD == 256 ? 32 : 64; }
template <int HD>
__host__ __device__ constexpr int pf32_smem() {
  return ((PF_ROWS + 2 * pf32_kt<HD>()) * (HD + 4) + PF_ROWS * (pf32_kt<HD>() + 4)) * 4;
}

template <int HD>
__global__ void __launch_bounds__(256) flash_prefill_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ ck, const float* __restrict__ cv,
    const int* __restrict__ pos, float* __restrict__ out, int T, int H, int KH, int S,
    float sm_scale) {
  constexpr int KT = pf32_kt<HD>(), LD = HD + 4, LDP = KT + 4;
  constexpr int KPT = KT / 16;          // keys of a tile per thread
  constexpr int NC = HD / 4;            // float4 columns of a row
  constexpr int CPT = (NC + 15) / 16;   // float4 output columns per thread (HD 96: 2 or 1)
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // (PF_ROWS, LD)
  float* Ks = Qs + PF_ROWS * LD;                // (KT, LD)
  float* Vs = Ks + KT * LD;                     // (KT, LD)
  float* Ps = Vs + KT * LD;                     // (PF_ROWS, LDP)
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.x / KH, h = blockIdx.x % KH;
  const int g = H / KH, tq = PF_ROWS / g;  // rows tq * g .. PF_ROWS - 1 stay empty
  const int q0 = blockIdx.y * tq;
  const int pb = pos[b];
  const size_t stripe = ((size_t)b * KH + h) * S * HD;

  for (int c = tid; c < PF_ROWS * NC; c += 256) {
    const int R = c / NC, col = (c % NC) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (R < tq * g && q0 + R / g < T)
      v = *reinterpret_cast<const float4*>(
          q + (((size_t)b * T + q0 + R / g) * H + (size_t)h * g + R % g) * HD + col);
    *reinterpret_cast<float4*>(Qs + R * LD + col) = v;
  }

  float m_run[4], l_run[4], o[4][CPT][4];
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
    qpos[i] = pb + q0 + (ty * 4 + i) / g;  // sees keys <= qpos
#pragma unroll
    for (int j = 0; j < CPT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][j][e] = 0.f;
  }
  const int kend = pb + min(q0 + tq, T);  // keys >= kend are invisible to the tile

  for (int k0 = 0; k0 < kend; k0 += KT) {
    __syncthreads();  // the previous tile is consumed (and Q is in place)
    for (int c = tid; c < KT * NC; c += 256) {
      const int row = c / NC, col = (c % NC) * 4, key = k0 + row;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (key < S) {
        kv = *reinterpret_cast<const float4*>(ck + stripe + (size_t)key * HD + col);
        vv = *reinterpret_cast<const float4*>(cv + stripe + (size_t)key * HD + col);
      }
      *reinterpret_cast<float4*>(Ks + row * LD + col) = kv;
      *reinterpret_cast<float4*>(Vs + row * LD + col) = vv;
    }
    __syncthreads();

    // scores of rows 4 ty + i against keys k0 + tx + 16 j
    float sc[4][KPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float4 kb = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          sc[i][j] = fmaf(qa[i].w, kb.w, fmaf(qa[i].z, kb.z, fmaf(qa[i].y, kb.y,
                                                                  fmaf(qa[i].x, kb.x, sc[i][j]))));
      }
    }

    // online softmax: a row's 16 threads are one half of a warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        sc[i][j] = k0 + tx + 16 * j <= qpos[i] ? sc[i][j] * sm_scale : -INFINITY;
        mt = fmaxf(mt, sc[i][j]);
      }
#pragma unroll
      for (int o2 = 8; o2 > 0; o2 >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o2));
      const float m_new = fmaxf(m_run[i], mt);
      const float alpha = m_new == -INFINITY ? 1.f : expf(m_run[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p = sc[i][j] == -INFINITY ? 0.f : expf(sc[i][j] - m_new);
        psum += p;
        Ps[(ty * 4 + i) * LDP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int o2 = 8; o2 > 0; o2 >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o2);
      l_run[i] = l_run[i] * alpha + psum;
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < CPT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][j][e] *= alpha;
    }
    __syncwarp();  // a row's p comes from its own half-warp

    // P.V: o[i][j] += sum over the tile's keys of p * V[key][(tx + 16 j) * 4 ..]
#pragma unroll 4
    for (int k = 0; k < KT; ++k) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * LDP + k];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + 16 * j;
        if (c >= NC) break;
        const float4 v = *reinterpret_cast<const float4*>(Vs + k * LD + c * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i][j][0] = fmaf(p[i], v.x, o[i][j][0]);
          o[i][j][1] = fmaf(p[i], v.y, o[i][j][1]);
          o[i][j][2] = fmaf(p[i], v.z, o[i][j][2]);
          o[i][j][3] = fmaf(p[i], v.w, o[i][j][3]);
        }
      }
    }
    __syncwarp();  // the next tile's p overwrites Ps
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int R = ty * 4 + i;
    if (R >= tq * g || q0 + R / g >= T) continue;
    const float ldiv = l_run[i] > 0.f ? l_run[i] : 1.f;
    float* dst = out + (((size_t)b * T + q0 + R / g) * H + (size_t)h * g + R % g) * HD;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tx + 16 * j;
      if (c >= NC) break;
      *reinterpret_cast<float4*>(dst + c * 4) = make_float4(o[i][j][0] / ldiv, o[i][j][1] / ldiv,
                                                            o[i][j][2] / ldiv, o[i][j][3] / ldiv);
    }
  }
}

}  // namespace

// launch(CT{}) for a float cache of bf16 (f32 == 0) or f32 values,
// returning what it returns
template <typename Launch>
cudaError_t for_cache(int f32, Launch launch) {
  if (f32) return launch(float{});
  return launch(__nv_bfloat16{});
}

// ck/cv: one layer of a bf16 (f32 == 0) or f32 cache
XQ_EXPORT int xq_kv_update(void* ck, void* cv, const void* knew, const void* vnew,
                           const void* kv_pos, const void* rotate, const void* cexp,
                           const void* sexp, int B, int KH, int S, int hd, int f32, void* stream) {
  if (hd < 2 || hd > 1024 || hd % 2 != 0) return (int)cudaErrorInvalidValue;
  return (int)for_cache(f32, [&](auto t) {
    using CT = decltype(t);
    kv_update_kernel<CT><<<dim3(B, KH), hd, 0, static_cast<cudaStream_t>(stream)>>>(
        (CT*)ck, (CT*)cv, (const float*)knew, (const float*)vnew, (const int*)kv_pos,
        (const int*)rotate, (const float*)cexp, (const float*)sexp, KH, S, hd);
    return cudaGetLastError();
  });
}

// f32 elements of the flash-decode workspace: per (batch, head, chunk) the
// partial max, the partial sum and the hd-wide partial accumulator
XQ_EXPORT long long xq_flash_decode_workspace(int B, int H, int S, int hd) {
  const long long ns = (S + FD_CHUNK - 1) / FD_CHUNK;
  return (long long)B * H * ns * (hd + 2);
}

XQ_EXPORT int xq_flash_decode(const void* q, const void* ck, const void* cv, const void* kv_len,
                              void* work, void* out, int B, int H, int KH, int S, int hd,
                              float sm_scale, int f32, void* stream) {
  if (KH < 1 || H % KH != 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int NS = (S + FD_CHUNK - 1) / FD_CHUNK;
  const size_t parts = (size_t)B * H * NS;
  float* pm = (float*)work;
  float* pl = pm + parts;
  float* pacc = pl + parts;
  const dim3 grid(B * KH, NS);
  const float* qf = (const float*)q;
  const int* kl = (const int*)kv_len;
  const cudaError_t e = for_cache(f32, [&](auto t) {
    using CT = decltype(t);
    return for_head_dim(hd, [&](auto d) {
      return for_group(H / KH, [&](auto g) {
        flash_decode_split_kernel<decltype(g)::value, decltype(d)::value, CT>
            <<<grid, FD_THREADS, 0, s>>>(qf, (const CT*)ck, (const CT*)cv, kl, pm, pl, pacc, KH,
                                         S, sm_scale);
      });
    });
  });
  if (e != cudaSuccess) return (int)e;
  flash_decode_combine_kernel<<<B * H, hd, 0, s>>>(pm, pl, pacc, (float*)out, NS);
  return (int)cudaGetLastError();
}

XQ_EXPORT int xq_flash_prefill(const void* q, const void* ck, const void* cv, const void* pos,
                               void* out, int B, int T, int H, int KH, int S, int hd,
                               float sm_scale, int f32, void* stream) {
  if (KH < 1 || H % KH != 0 || H / KH > FD_MAX_G || T < 1) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return (int)for_head_dim(hd, [&](auto d) {
    constexpr int HD = decltype(d)::value;
    if (f32) {
      const int tq = PF_ROWS / (H / KH);
      const dim3 grid(B * KH, (T + tq - 1) / tq);
      cudaError_t e = xq_allow_smem(flash_prefill_f32_kernel<HD>, pf32_smem<HD>());
      if (e != cudaSuccess) return e;
      flash_prefill_f32_kernel<HD><<<grid, 256, pf32_smem<HD>(), s>>>(
          (const float*)q, (const float*)ck, (const float*)cv, (const int*)pos, (float*)out, T, H,
          KH, S, sm_scale);
      return cudaGetLastError();
    }
    return launch_flash_prefill<HD>((const float*)q, (const __nv_bfloat16*)ck,
                                    (const __nv_bfloat16*)cv, (const int*)pos, (float*)out, B, T,
                                    H, KH, S, sm_scale, s);
  });
}

// xq_flash_prefill's blocks over a bf16 cache for a T-row chunk: *tq
// query positions a block, q0s[y] the first position of block y for each
// of the chunk's blocks (at most cap); cudaErrorInvalidValue for a shape it
// refuses. ops/attention.py's prefill_plan is held to it on the card.
XQ_EXPORT int xq_flash_prefill_plan(int T, int H, int KH, int hd, void* tq, void* q0s, int cap) {
  if (KH < 1 || H % KH != 0 || H / KH < 1 || H / KH > FD_MAX_G || T < 1)
    return (int)cudaErrorInvalidValue;
  return (int)for_head_dim(hd, [&](auto) {
    const int g = H / KH, n = pf_blocks(T, g);
    if (n > cap) return cudaErrorInvalidValue;
    *(int*)tq = pf_tq(g);
    for (int y = 0; y < n; ++y) ((int*)q0s)[y] = pf_q0(T, g, y);
    return cudaSuccess;
  });
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
  if (KH < 1 || H % KH != 0) return (int)cudaErrorInvalidValue;
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
  const cudaError_t e = for_head_dim(hd, [&](auto d) {
    return for_group(H / KH, [&](auto g) {
      flash_decode_q_split_kernel<decltype(g)::value, decltype(d)::value>
          <<<grid, FD_THREADS, 0, s>>>(qf, k, v, kss, vss, kl, pm, pl, pacc, KH, S, sm_scale);
    });
  });
  if (e != cudaSuccess) return (int)e;
  flash_decode_combine_kernel<<<B * H, hd, 0, s>>>(pm, pl, pacc, (float*)out, NS);
  return (int)cudaGetLastError();
}
