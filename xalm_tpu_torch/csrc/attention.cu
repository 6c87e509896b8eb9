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
// 1. xq_kv_update replaces xalm_tpu/ops/pallas_attention.py::_update_kernel
//    as a launch of its own, for the one path that attends densely after it
//    (Gemma-2's attention cap); every other float-cache decode step updates
//    in item 2's launch (xq_fused_decode_attention). Grid (B, KH), one
//    thread per head dim. Writes the new K/V row (f32 -> bf16, or as it is
//    in an f32 cache) at kv_pos (dropped when kv_pos >= S: the sentinel),
//    then, for wrapped rows, rotates the KV_SINKS sink keys by one position
//    with the interleaved-pair rope: out = v*cexp + swap(v)*sexp, swap[2j]
//    = -v[2j+1], swap[2j+1] = v[2j], each product and the sum rounded
//    separately as in the plain version. Bound: bytes, and at a few KB per
//    layer it is launch latency (1.6 us on the device, 21 us of the host's
//    launch a call on an H100): the reason it rides in item 2's launch.
//
// 2. xq_fused_decode_attention replaces _attn_kernel, with item 1 in its
//    launch (below). The TPU grid walks the
//    sequence in order carrying a running max and sum; blocks on the card
//    run in no order. One launch a call, flash_decode_cluster_kernel: grid
//    (P, B x KH) in clusters of the P blocks of one (batch, kv head), P
//    about the SMs over B x KH, 1 to 16 (fc_splits: 16 at Mistral's 8 kv
//    heads, B = 1; a cluster above 8 is non-portable, and the launcher asks
//    the card whether one fits). The host never reads kv_len (a CUDA graph
//    can replay the launch): each block reads kv_len[b] and takes rows
//    [floor(p n / P), floor((p + 1) n / P)), floor(n / P) or ceil(n / P)
//    of them, so every block has rows once kv_len >= P and S only bounds
//    the indexing. A producer warp brings the block's K and V rows by 1-D
//    bulk copies (hopper.cuh) into a ring of 3 stages of at most 16 KB a
//    plane (full and empty mbarriers), all of a short block's rows before
//    any score: V lands while K is scored. Eight consumer warps score f32
//    q (in registers, a lane's VPL dims) against the K rows in shared
//    memory (a warp reads a row: no bank conflict), NR rows x G heads at a
//    time, the lanes' partial dots summed by a scatter reduction (one
//    shuffle a sum, not five); each warp keeps an online softmax per head
//    in f32 (nothing rounded to bf16, as the plain version) and adds p
//    times the V rows (p broadcast from shared memory). The warps' partials
//    merge at the block's max (shuffles over a head's lanes); each block
//    then stores its partial of every output slice into the shared memory
//    of the block that normalises that slice (distributed shared memory,
//    stores only: nothing waits on a peer's reply), and after one
//    cluster.sync() each block combines the P partials of its slice. A
//    relaxed cluster arrive at the start (waited on before the stores)
//    makes sure every peer is running. No global partials and no counters:
//    nothing is left between launches. kv_len == 0 gives 0, not NaN. The
//    GQA group G = H / KH and the head dim HD are template parameters,
//    instantiated for each G in 1..8 (Qwen2.5-7B has G = 7, Qwen2.5-14B G
//    = 5) and HD in {96, 128, 256} (Phi-3; Llama, Mistral and Qwen; Gemma
//    and Gemma-2), dispatched at run time; a lane holds 4 of a row's dims
//    (HD 96: lanes 24..31 idle) or 8 (HD 256). Bound: bytes (the cache
//    rows up to kv_len, read once: 3.2 MB, 0.96 us at Mistral's shapes and
//    kv_len 777); at such sizes the launch, one dependent trip to memory
//    and the cluster's barrier, which the design takes once each.
//    Item 1 rides in this launch (the port's fused_decode_attention over a
//    float cache, the JAX function of that name whole; kv_pos at the
//    sentinel S and rotate 0 give the attention alone): each row the update writes (the new K and V rows at
//    kv_pos, the sink keys where rotate is set) has one owner, the block
//    whose row range holds it (the last block for a row at or past n, which
//    no block reads; ops/attention.py decode_row_owner), so the block that
//    writes a row is the only one that reads it. Its producer warp writes
//    them with item 1's arithmetic (a row a warp, lane l dims l + 32 k:
//    bit-equal) before the copy of the first stage that holds one (at the
//    latest once the ring's first stages are out, while the producer would
//    only wait for a free slot), behind a fence.proxy.async.global (the generic stores, then the bulk
//    copy's read of the same bytes), as item 4 does. Rows are rotated one
//    by one, so sinks split over two blocks (n < 2P) rotate in their owners.
//
// 3. xq_kv_update_q replaces _insert_q_kernel and _sink_q_kernel as a
//    launch of their own, over an int8 cache with per-row f32 scale planes
//    (L, B, KH, S), for the one path that attends densely after them
//    (Gemma-2's attention cap); every other int8 decode step inserts in
//    item 4's launch. Grid (B, KH), one thread per head dim (96, 128 or
//    256: any multiple of 32 up to 1024). Quantises the new K and V rows
//    (absmax by warp shuffles and a 4-warp shared-memory reduce; the scale
//    and codes by IEEE division, common.cuh) and writes codes and scales at
//    kv_pos (dropped at kv_pos >= S); then, for wrapped rows, dequantises
//    the KV_SINKS sink keys with their stored scales, rotates them by one
//    position (each product and the sum rounded as the plain version's
//    separate f32 operations) and requantises them. Bit-equal to the plain
//    version: absmax is order-free. Bound: launch latency, as 1.
//
// 4. xq_flash_decode_q replaces _attn_q_kernel and, given the new rows,
//    _insert_q_kernel and _sink_q_kernel too: the whole of the TPU's
//    fused_decode_attention_q in one launch, flash_decode_q_cluster_kernel,
//    on kernel 3's skeleton. Grid (P, B x KH) in clusters of the P blocks of
//    one (batch, kv head), P kernel 3's count capped at the window's
//    128-row chunks (fq_splits). The unit of work is the plain version's
//    128-row chunk: each block reads kv_len[b] (the host never does) and
//    takes the whole chunks [floor(p C / P), floor((p + 1) C / P)) of the C
//    live ones. The block whose chunks hold kv_pos (the last chunk's block
//    for a row past them, block 0 when none is live) quantises the new K and
//    V rows into the cache, and the block of chunk 0 re-rotates the sinks,
//    with kv_update_q_kernel's arithmetic by its producer warp (a row a
//    warp: lane l holds dims l + 32 k, a pair's partner one lane over):
//    the block that writes a row is the only block that reads it, so
//    nothing races. The writes go just before the copy of the first plane
//    that holds one of the rows, behind a fence.proxy.async.global (the
//    generic stores, then the bulk copy's read of the same bytes), so the
//    insert in the block's last chunk overlaps the copies of its first
//    ones. The producer warp brings each chunk's K plane by TMA (boxes of
//    128 rows x 128 bytes, 128-byte swizzled: hd 96 reads zeros past its
//    row, hd 256 takes two boxes) and then its V plane by one 1-D bulk copy,
//    each with its 128 row scales (a bulk copy; a short chunk's in whole
//    4-row groups of 16 bytes, the rows past kv_len masked), into a ring of
//    4 slots (3 at HD 256: 99 KB, two blocks an SM) under full and empty
//    mbarriers. Eight consumer warps take 16 rows of each chunk. They score
//    on the tensor cores, mma.sync m16n8k16 in bf16: the codes widened
//    exactly (byte permutes, then bf16 pairs) as A, q rounded to bf16 as B
//    (heads past G zero), so every product is the plain version's exact
//    one, summed in f32 (the tensor cores' sums round toward zero, a few
//    ulps of a score; the output stays within 1e-3 of each row's max of the
//    plain version, chip_smoke.py phase 3); the swizzle keeps the fragment reads
//    off shared memory's bank conflicts. Then times k_scale / sqrt(hd); the
//    chunk's max of each head meets in shared memory (one named barrier a
//    chunk); p = exp(score - chunk max) and bf16(p * v_scale) as the plain
//    version rounds them, that times beta = exp(chunk max - running max),
//    the old terms times alpha = exp(old max - running max), and P.V over
//    the V codes (f32 FMAs, a lane's VPL dims of a row). All
//    warps share the running max, so their partials add; the cluster
//    combines the P blocks' partials at their common max (fc_combine, as
//    kernel 3). No workspace and no counters: a CUDA graph replays the
//    launch; kv_len == 0 gives 0. Bound: bytes (the code rows and their
//    scales up to kv_len, half the bytes of the bf16 cache); at a few MB the
//    launch, one dependent trip to memory, the cluster's barrier and the
//    per-chunk chain of the consumer warps (a chunk of a block at a time)
//    set the time. The host encodes the tensor map of the layer's K codes
//    each call. G in 1..8 and HD in {96, 128, 256}, as in 2 (a lane of P.V
//    holds 4 codes of a row, or 8 at HD 256).
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
//    f32 compute_dtype: nothing is rounded to bf16, so the bf16 tiles cannot
//    serve, and one TF32 product (three digits) would miss the f32 plain
//    version by 1e-4 of a row's max. flash_prefill_tf32x3_kernel runs both
//    dots in split TF32 on the tensor cores (three TF32 products a step,
//    mma.sync; see its note) on a TMA ring, the same rows, causal limit and
//    online softmax: against f64 its rows land within 2.5-3.5e-6 of their
//    max on an H100, the plain f32 version's within 1.7-3.4e-6 (hopper.cuh).
//    Bound: operations at T = 512, three TF32 products at 494.7 TFLOP/s
//    (hd 256, pos 1024: 0.065 ms; f32 FMA: 0.160).

#include <cooperative_groups.h>
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

constexpr int FD_MAX_G = 8;    // GQA groups 1..8, one instantiation each

// launch(std::integral_constant<int, G>{}) for the GQA group g, so that G is
// a compile-time constant inside the kernel it launches, then what it
// returns or, where it returns nothing, cudaGetLastError(); a g outside
// 1..FD_MAX_G launches nothing and gives cudaErrorInvalidValue
template <int G = 1, typename Launch>
cudaError_t for_group(int g, Launch launch) {
  if constexpr (G > FD_MAX_G) {
    return cudaErrorInvalidValue;
  } else {
    if (g != G) return for_group<G + 1>(g, launch);
    using Ret = decltype(launch(std::integral_constant<int, G>{}));
    if constexpr (std::is_void_v<Ret>) {
      launch(std::integral_constant<int, G>{});
      return cudaGetLastError();
    } else {
      return launch(std::integral_constant<int, G>{});
    }
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

// the flash-decodes' lanes: a lane holds VPL consecutive dims of a row (of
// q, K and V in kernels 3 and 7), the first HD / VPL lanes of
// each warp (HD 96: 24 lanes of 4)
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

// VPL consecutive int8 codes as f32 (one 4- or 8-byte load; shared memory),
// widened by byte permutes (xq_i8x4_to_f32: an int-to-float conversion a
// code would set the pace of kernel 7's P.V)
template <int VPL>
__device__ __forceinline__ void load_s8(const signed char* p, float* out) {
  if constexpr (VPL == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    xq_i8x4_to_f32(raw.x, out);
    xq_i8x4_to_f32(raw.y, out + 4);
  } else {
    xq_i8x4_to_f32(*reinterpret_cast<const uint32_t*>(p), out);
  }
}

// ---- kernel 3: one launch a call, the live rows split over a cluster

constexpr int FC_STAGES = 3;       // the ring of K/V row stages
constexpr int FC_PLANE = 16384;    // bytes of K rows (and of V rows) a stage holds, at most
constexpr int FC_MAX_SPLITS = 16;  // blocks a (batch, kv head): the largest cluster (non-portable)

// The consumer warps a block, and a producer warp. Two blocks an SM fit
// where a thread needs at most 113 registers (G <= 6; ptxas's report), which
// 8 clusters of 16 (Mistral-7B's 8 kv heads at B = 1) need: an H100 holds 7
// such clusters at one block an SM, 14 at two (cudaOccupancyMaxActiveClusters).
constexpr int FC_WARPS = 8;
constexpr int FC_THREADS = (FC_WARPS + 1) * 32;

// The GQA group rounded up to a power of two: the heads of a lane's
// partial dots (the padding heads' are zero and never used)
__host__ __device__ constexpr int fc_gp(int g) { return g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : 8; }

// Key rows a warp scores at once: NR * fc_gp(G) <= 32 partial dots a lane,
// and a stage's FC_WARPS x NR rows within FC_PLANE bytes (a power of two)
template <int G, int HD, typename CT>
__host__ __device__ constexpr int fc_nr() {
  constexpr int fit = FC_PLANE / (FC_WARPS * HD * (int)sizeof(CT));
  constexpr int nr = fit >= 8 ? 8 : fit >= 4 ? 4 : fit >= 2 ? 2 : 1;
  return nr < 32 / fc_gp(G) ? nr : 32 / fc_gp(G);
}

template <int G, int HD, typename CT>
__host__ __device__ constexpr int fc_rows() { return FC_WARPS * fc_nr<G, HD, CT>(); }

// Dynamic shared memory: the ring (K and V planes of each stage), whose
// bytes take the warps' accumulators (FC_WARPS x G x HD f32) once drained
template <int G, int HD, typename CT>
__host__ __device__ constexpr int fc_smem() {
  constexpr int ring = FC_STAGES * 2 * fc_rows<G, HD, CT>() * HD * (int)sizeof(CT);
  constexpr int warps = FC_WARPS * G * HD * 4;
  return ring > warps ? ring : warps;
}

// One halving exchange of xq_warp_sum_scatter at offset O, then the next:
// a lane keeps the half of its 2 HALF values that its bit O selects and
// adds the partner's copy of it (template recursion: every index is known
// at compile time, so v stays in registers)
template <int V, int HALF, int O>
__device__ __forceinline__ void xq_scatter_halves(float (&v)[V], int lane) {
  if constexpr (HALF >= 1) {
    const bool up = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const float send = up ? v[i] : v[i + HALF];
      const float keep = up ? v[i + HALF] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    xq_scatter_halves<V, HALF / 2, O / 2>(v, lane);
  }
}

// The warp's sum of each of a lane's V partial sums v[0..V) (V a power of
// two up to 32): the first log2 V exchanges halve the values a lane holds
// (it keeps the half that its bit of the offset selects, and adds the
// partner's copy of it), the rest add the one value left. V - 1 + 5 -
// log2 V shuffles for V sums, where a full reduction of each takes 5 V.
// Lane l ends with the sum of value e = l >> (5 - log2 V), bit for bit the
// same in every lane that shares e.
template <int V>
__device__ __forceinline__ float xq_warp_sum_scatter(float (&v)[V], int lane) {
  xq_scatter_halves<V, V / 2, 16>(v, lane);
  float s = v[0];
#pragma unroll
  for (int o = 16 / V; o >= 1; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// The cluster's combine of kernels 3 and 7, once each block's partial is in
// its shared memory: each head's max pm[g] and sum pl[g], and acc(i), the
// un-normalised sum of output i < G x HD. Each block pushes acc(i) to the
// block that normalises output i (block i / per takes outputs [i0, i0 +
// per)) and pm, pl to every block, through distributed shared memory (stores
// only: nothing waits on a peer's reply); after one cluster.sync() each
// block weighs the P partials of its slice at the heads' common max (16
// lanes a head, the ranks past P idle) and writes out[i0 + j] (out: the
// (batch, kv head)'s G x HD outputs), 0 where the sum is 0 (kv_len 0). gm,
// gs and ga take the pushed partials, wt (FC_MAX_SPLITS x G floats) the
// ranks' weights, pl the heads' totals: all this block's shared memory.
template <int G, int HD, int NT, typename Acc>
__device__ __forceinline__ void fc_combine(const float* pm, float* pl, Acc acc, float (*gm)[G],
                                           float (*gs)[G], float* ga, float* wt,
                                           float* __restrict__ out) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int P = gridDim.x, p = blockIdx.x, tid = threadIdx.x, warp = tid >> 5;
  const int per = (G * HD + P - 1) / P;
  xq_cluster_wait();  // every peer has started
  for (int i = tid; i < G * HD; i += NT)
    *cluster.map_shared_rank(&ga[p * per + i % per], i / per) = acc(i);
  for (int t = tid; t < P * G; t += NT) {
    *cluster.map_shared_rank(&gm[p][t % G], t / G) = pm[t % G];
    *cluster.map_shared_rank(&gs[p][t % G], t / G) = pl[t % G];
  }
  cluster.sync();  // every block's partial of this block's slice is here

  const int i0 = p * per, cnt = max(0, min(per, G * HD - i0));
  if (warp < (FC_MAX_SPLITS * G + 31) / 32) {
    const int g = tid / FC_MAX_SPLITS, r = tid % FC_MAX_SPLITS;
    const float m = g < G && r < P ? gm[r][g] : -INFINITY;
    float mx = m;
#pragma unroll
    for (int o = FC_MAX_SPLITS / 2; o >= 1; o /= 2)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float f = m == -INFINITY ? 0.f : expf(m - mx);
    float l = m == -INFINITY ? 0.f : f * gs[r][g];
#pragma unroll
    for (int o = FC_MAX_SPLITS / 2; o >= 1; o /= 2) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (g < G) {
      wt[r * G + g] = f;
      if (r == 0) pl[g] = l;  // the block's own sum is no longer read: the slice's total
    }
  }
  __syncthreads();
  for (int j = tid; j < cnt; j += NT) {
    const int g = (i0 + j) / HD;
    float a0 = 0.f, a1 = 0.f;  // two chains, added at the end
    int r = 0;
    for (; r + 1 < P; r += 2) {
      a0 += wt[r * G + g] * ga[r * per + j];
      a1 += wt[(r + 1) * G + g] * ga[(r + 1) * per + j];
    }
    if (r < P) a0 += wt[r * G + g] * ga[r * per + j];
    const float l = pl[g];
    out[i0 + j] = l > 0.f ? (a0 + a1) / l : 0.f;  // kv_len 0 -> 0
  }
}

// kv_update_kernel's arithmetic by one warp (lane l holds dims l + 32 k,
// a pair's partner one lane over) on the rows of one (batch, kv head)
// stripe that this block owns: the new K and V rows knew, vnew (HD f32
// each) stored at row kvp (none where kvp < 0), then the sink keys whose
// bit is set in `sinks` rotated by one position, each product and the sum
// rounded as the plain version's separate f32 operations: bit-equal
template <int HD, typename CT>
__device__ __forceinline__ void fc_update_rows(CT* stk, CT* stv, const float* __restrict__ knew,
                                               const float* __restrict__ vnew, int kvp, int sinks,
                                               const float* __restrict__ cexp,
                                               const float* __restrict__ sexp, int lane) {
  constexpr int K = HD / 32;
  if (kvp >= 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane + 32 * k;
      stk[(size_t)kvp * HD + d] = xq_to_cache<CT>(knew[d]);
      stv[(size_t)kvp * HD + d] = xq_to_cache<CT>(vnew[d]);
    }
    __syncwarp();  // the inserted row, before the sinks are read
  }
  float v[KV_SINKS][K], sw[KV_SINKS][K];
#pragma unroll
  for (int r = 0; r < KV_SINKS; ++r) {
    if (!((sinks >> r) & 1)) continue;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane + 32 * k;
      v[r][k] = xq_from_cache(stk[(size_t)r * HD + d]);
      const float p = xq_from_cache(stk[(size_t)r * HD + (d ^ 1)]);
      sw[r][k] = (d & 1) ? p : -p;
    }
  }
  __syncwarp();  // every lane has read the sinks before any writes them
#pragma unroll
  for (int r = 0; r < KV_SINKS; ++r) {
    if (!((sinks >> r) & 1)) continue;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane + 32 * k;
      stk[(size_t)r * HD + d] =
          xq_to_cache<CT>(__fadd_rn(__fmul_rn(v[r][k], cexp[d]), __fmul_rn(sw[r][k], sexp[d])));
    }
  }
}

// Grid (P, B * KH), clusters of the P blocks of one (batch, kv head); block
// p attends over rows [floor(p n / P), floor((p + 1) n / P)), n = kv_len[b]
// read here (the host never reads it), and the cluster combines the P
// partials through distributed shared memory (see the note, item 2).
// Kernel 2's update rides in the launch: each row it writes (the
// new K and V rows at kv_pos, dropped at kv_pos >= S; the sink keys where
// rotate[b] is set) is written by the block whose range holds it, the last
// block for a row past n (which no block reads), so the block that writes a
// row is the only one that reads it.
template <int G, int HD, typename CT>
__global__ void __launch_bounds__(FC_THREADS) flash_decode_cluster_kernel(
    const float* __restrict__ q, CT* ck, CT* cv, const float* __restrict__ knew,
    const float* __restrict__ vnew, const int* __restrict__ kv_pos,
    const int* __restrict__ rotate, const float* __restrict__ cexp,
    const float* __restrict__ sexp, const int* __restrict__ kv_len, float* __restrict__ out,
    int KH, int S, float sm_scale) {
  constexpr int VPL = fd_vpl<HD>(), NL = HD / VPL;
  constexpr int GP = fc_gp(G), NR = fc_nr<G, HD, CT>(), V = NR * GP;
  constexpr int LOG_V = V >= 32 ? 5 : V >= 16 ? 4 : V >= 8 ? 3 : V >= 4 ? 2 : V >= 2 ? 1 : 0;
  constexpr int R = fc_rows<G, HD, CT>(), PLANE = R * HD;
  constexpr int W = FC_WARPS, NT = FC_THREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  CT* ring = reinterpret_cast<CT*>(smem);        // [FC_STAGES][K, V][R][HD]
  float* wacc = reinterpret_cast<float*>(smem);  // [W][G][HD], the ring drained
  __shared__ uint64_t full[FC_STAGES], empty[FC_STAGES];
  __shared__ __align__(16) float pb[W][32];  // a warp's p, row r head g at r GP + g
  __shared__ float ab[W][GP];                // and each head's rescale
  __shared__ float wm[W][G], wl[W][G], fac[W][G];
  __shared__ float pm[G], pl[G];                    // the block's partial: max, sum of p
  // the P blocks' partials of this block's slice of the G x HD outputs,
  // pushed here by each block (itself too): max and sum of each head, and
  // the un-normalised P.V of the slice, rank by rank
  __shared__ float gm[FC_MAX_SPLITS][G], gs[FC_MAX_SPLITS][G];
  __shared__ float ga[G * HD + FC_MAX_SPLITS];
  const int P = gridDim.x, p = blockIdx.x;
  const int b = blockIdx.y / KH, h = blockIdx.y % KH, H = KH * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = min(max(kv_len[b], 0), S);
  // kernel 2's row and rotation flag, read beside kv_len so that their trips
  // to memory overlap rather than delay the producer's first copy
  const int kp = kv_pos[b];
  const bool rot = rotate[b] != 0;
  const int r0 = (int)((long long)p * n / P), r1 = (int)((long long)(p + 1) * n / P);
  const int nst = (r1 - r0 + R - 1) / R;  // stages of this block's rows
  const size_t first = (((size_t)b * KH + h) * S + r0) * HD;

  if (tid == 0) {
    for (int s = 0; s < FC_STAGES; ++s) {
      xq_mbar_init(&full[s], 1);
      xq_mbar_init(&empty[s], W);
    }
    xq_mbar_fence_init();
  }
  xq_cluster_arrive_relaxed();  // this block has started: peers may write its shared memory
  __syncthreads();  // the barriers' initialisation, seen by every thread

  if (warp == W) {
    // the producer warp: stage it's K and V rows, two bulk copies (the rows
    // are contiguous in the (B, KH, S, hd) stripe), once the consumers have
    // released the round before in its slot; the rows this block writes
    // (kernel 2) before the copy of the first stage that holds one, and no
    // later than once the ring's first FC_STAGES copies are out, when the
    // producer would only wait for a slot (a row past n: nobody reads it)
    int kvp = -1, sinks = 0, at = nst;  // the stage before whose copy the writes go
    const auto owns = [&](int r) { return r < n ? r0 <= r && r < r1 : p == P - 1; };
    if (kp >= 0 && kp < S && owns(kp)) {
      kvp = kp;
      if (kp < n) at = (kp - r0) / R;
    }
#pragma unroll
    for (int r = 0; r < KV_SINKS; ++r) {
      if (rot && owns(r)) {
        sinks |= 1 << r;
        if (r < n) at = min(at, (r - r0) / R);
      }
    }
    at = min(at, FC_STAGES);
    for (int it = 0; it <= nst; ++it) {
      if ((kvp >= 0 || sinks != 0) && it == at) {
        const size_t src = ((size_t)b * KH + h) * HD;
        const size_t stripe = ((size_t)b * KH + h) * S * HD;
        fc_update_rows<HD, CT>(ck + stripe, cv + stripe, knew + src, vnew + src, kvp, sinks, cexp,
                               sexp, lane);
        xq_fence_proxy_async_global();  // this lane's stores, before the copies read them
        __syncwarp();
      }
      if (it == nst || lane != 0) continue;
      const int s = it % FC_STAGES;
      if (it >= FC_STAGES) xq_mbar_wait(&empty[s], (it / FC_STAGES - 1) & 1);
      const uint32_t bytes = (uint32_t)min(R, r1 - r0 - it * R) * HD * sizeof(CT);
      CT* dst = ring + (size_t)s * 2 * PLANE;
      xq_mbar_expect_tx(&full[s], 2 * bytes);
      xq_bulk_g2s(dst, ck + first + (size_t)it * PLANE, bytes, &full[s]);
      xq_bulk_g2s(dst + PLANE, cv + first + (size_t)it * PLANE, bytes, &full[s]);
    }
  } else {
    // the G heads' q, scaled, in registers: lane l holds dims [l VPL, (l + 1) VPL)
    float qr[G][VPL];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float* qg = q + ((size_t)b * H + (size_t)h * G + g) * HD + lane * VPL;
#pragma unroll
      for (int e = 0; e < VPL; e += 4) {
        const float4 v = lane < NL ? *reinterpret_cast<const float4*>(qg + e)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
        qr[g][e] = v.x * sm_scale;
        qr[g][e + 1] = v.y * sm_scale;
        qr[g][e + 2] = v.z * sm_scale;
        qr[g][e + 3] = v.w * sm_scale;
      }
    }
    // after the scatter sum this lane holds row rl, head gl of the warp's NR x GP
    const int el = lane >> (5 - LOG_V), rl = el / GP, gl = el % GP;
    const bool rep = (lane & ((1 << (5 - LOG_V)) - 1)) == 0;  // the first lane holding el
    float m_run = -INFINITY, l_run = 0.f;                      // head gl's, over rows rl
    float acc[G][VPL];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < VPL; ++e) acc[g][e] = 0.f;
    for (int it = 0; it < nst; ++it) {
      const int s = it % FC_STAGES;
      xq_mbar_wait(&full[s], (it / FC_STAGES) & 1);
      const int gv = min(NR, min(R, r1 - r0 - it * R) - warp * NR);  // warp's rows (<= 0: none)
      if (gv > 0) {
        const CT* kst = ring + (size_t)s * 2 * PLANE + (size_t)warp * NR * HD + lane * VPL;
        const CT* vst = kst + PLANE;
        // scores: the lane's dims of each row's dot with each head, summed over the warp
        float v[V];
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          float kf[VPL];
          if (lane < NL && r < gv) {
            load_cache<CT, VPL>(kst + r * HD, kf);
          } else {
#pragma unroll
            for (int e = 0; e < VPL; ++e) kf[e] = 0.f;
          }
#pragma unroll
          for (int g = 0; g < GP; ++g) {
            float d = 0.f;
            if (g < G) {
#pragma unroll
              for (int e = 0; e < VPL; ++e) d += qr[g < G ? g : 0][e] * kf[e];
            }
            v[r * GP + g] = d;
          }
        }
        const float sc = xq_warp_sum_scatter<V>(v, lane);
        // the online softmax of head gl over these rows (the rows' lanes differ in the top bits)
        const bool live = rl < gv && gl < G;
        float mx = live ? sc : -INFINITY;
#pragma unroll
        for (int o = 16; o >= 32 / NR; o /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m_run, mx);
        const float alpha = m_new == -INFINITY ? 1.f : expf(m_run - m_new);
        const float pr = live ? expf(sc - m_new) : 0.f;
        l_run = l_run * alpha + pr;
        m_run = m_new;
        if (rep) {
          pb[warp][el] = pr;
          if (rl == 0) ab[warp][gl] = alpha;
        }
        __syncwarp();
        // P.V: the lane's dims of each V row, p broadcast from shared memory
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float a = ab[warp][g];
#pragma unroll
          for (int e = 0; e < VPL; ++e) acc[g][e] *= a;
        }
#pragma unroll
        for (int r = 0; r < NR; ++r) {  // rows past gv: p is 0 and V reads as 0
          float vf[VPL];
          if (lane < NL && r < gv) {
            load_cache<CT, VPL>(vst + r * HD, vf);
          } else {
#pragma unroll
            for (int e = 0; e < VPL; ++e) vf[e] = 0.f;
          }
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float pg = pb[warp][r * GP + g];
#pragma unroll
            for (int e = 0; e < VPL; ++e) acc[g][e] += pg * vf[e];
          }
        }
      }
      __syncwarp();
      if (lane == 0) xq_mbar_arrive(&empty[s]);  // the warp is done with stage s
    }

    // the warp's partial (max, sum, acc) into shared memory
#pragma unroll
    for (int o = 16; o >= 32 / NR; o /= 2) l_run += __shfl_xor_sync(0xffffffffu, l_run, o);
    if (rep && rl == 0 && gl < G) {
      wm[warp][gl] = m_run;
      wl[warp][gl] = l_run;
    }
    xq_bar_sync(1, W * 32);  // every consumer warp is done with the ring
    if (lane < NL) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < VPL; e += 4)
          *reinterpret_cast<float4*>(wacc + (warp * G + g) * HD + lane * VPL + e) =
              make_float4(acc[g][e], acc[g][e + 1], acc[g][e + 2], acc[g][e + 3]);
    }
  }
  __syncthreads();
  // the warps' partials merged into the block's, at the block's max: W
  // lanes a head (W divides 32), the max and the sum by shuffles
  if (warp < (W * G + 31) / 32) {
    const int g = tid / W, w = tid % W;
    const float m = g < G ? wm[w][g] : -INFINITY;
    float mx = m;
#pragma unroll
    for (int o = W / 2; o >= 1; o /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float f = m == -INFINITY ? 0.f : expf(m - mx);
    float l = g < G ? f * wl[w][g] : 0.f;
#pragma unroll
    for (int o = W / 2; o >= 1; o /= 2) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (g < G) {
      fac[w][g] = f;
      if (w == 0) {
        pm[g] = mx;
        pl[g] = l;
      }
    }
  }
  __syncthreads();
  fc_combine<G, HD, NT>(
      pm, pl,
      [&](int i) {
        float a = 0.f;
#pragma unroll
        for (int w = 0; w < W; ++w) a += fac[w][i / HD] * wacc[w * G * HD + i];
        return a;
      },
      gm, gs, ga, wacc, out + ((size_t)b * H + (size_t)h * G) * HD);
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

// ---- kernel 7 with kernels 5-6: one launch a call, an int8 cache's chunks
// split over a cluster (see the note, item 4)

constexpr int FQ_CHUNK = 128;  // key rows a chunk, the softmax's unit (ops/attention.py _DECODE_KEYS)
constexpr int FQ_WARPS = 8;    // consumer warps, FQ_WROWS rows of each chunk apiece
constexpr int FQ_WROWS = FQ_CHUNK / FQ_WARPS;
constexpr int FQ_THREADS = (FQ_WARPS + 1) * 32;  // and a producer warp

// The ring: a slot holds one plane of a chunk, its K codes (a TMA box a
// 128-byte panel of the rows, 128-byte swizzled: hd 96 pads each row to 128
// with zeros) or its V codes (one bulk copy, rows of HD bytes as they lie),
// with the plane's 128 row scales in a scale slot beside; 4 slots (two
// chunks) at HD 96 and 128, 3 at HD 256 (99 KB), so that two blocks fit an
// SM
template <int HD>
__host__ __device__ constexpr int fq_slots() { return HD == 256 ? 3 : 4; }
template <int HD>
__host__ __device__ constexpr int fq_panels() { return (HD + 127) / 128; }
template <int HD>
__host__ __device__ constexpr int fq_slot_bytes() { return FQ_CHUNK * 128 * fq_panels<HD>(); }

// Dynamic shared memory: the code slots (whose bytes take the warps'
// accumulators, FQ_WARPS x G x HD f32, once drained), the scale slots, and
// the slack to align the slots to 1024 bytes (the swizzle's period)
template <int G, int HD>
__host__ __device__ constexpr int fq_smem() {
  static_assert(FQ_WARPS * G * HD * 4 <= fq_slots<HD>() * fq_slot_bytes<HD>(),
                "the accumulators fit in the drained ring");
  return fq_slots<HD>() * (fq_slot_bytes<HD>() + FQ_CHUNK * 4) + 1024;
}

// Two blocks an SM wherever a lane's accumulators (G VPL floats) leave room
// for it in the 96 registers a thread that two blocks of nine warps allow
// (five warps on one of the SM's four register files): 8 clusters of 16
// (Mistral-7B's 8 kv heads at B = 1) need two
template <int G, int HD>
__host__ __device__ constexpr int fq_min_blocks() { return G * fd_vpl<HD>() <= 32 ? 2 : 1; }

// D (16 x 8, f32) += A (16 x 16, bf16) * B (16 x 8, bf16), one warp, in
// registers: lane l holds a = A(l/4, 2 (l%4) .. +1), A(l/4 + 8, ..),
// A(l/4, 2 (l%4) + 8 .. +9), A(l/4 + 8, ..); b = B(2 (l%4) .. +1, l/4),
// B(2 (l%4) + 8 .. +9, l/4); d = D(l/4, 2 (l%4) .. +1), D(l/4 + 8, ..)
__device__ __forceinline__ void fq_mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// element g of a register array, g known only at run time (a select chain:
// the array stays in registers)
template <int N>
__device__ __forceinline__ float fq_pick(const float (&a)[N], int g) {
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) v = i == g ? a[i] : v;
  return v;
}

// kv_update_q_kernel's insert by one warp: the HD-value f32 row src (lane l
// holds dims l + 32 k) quantised into codes at dst and its scale at *scale
// (absmax is order-free; scale and codes by IEEE division: bit-equal)
template <int HD>
__device__ __forceinline__ void fq_insert_row(signed char* dst, float* scale,
                                              const float* __restrict__ src, int lane) {
  float v[HD / 32], m = 0.f;
#pragma unroll
  for (int k = 0; k < HD / 32; ++k) {
    v[k] = src[lane + 32 * k];
    m = fmaxf(m, fabsf(v[k]));
  }
  const float sc = xq_row_scale(xq_warp_max(m));
#pragma unroll
  for (int k = 0; k < HD / 32; ++k) dst[lane + 32 * k] = xq_code(v[k], sc);
  if (lane == 0) *scale = sc;
}

// kv_update_q_kernel's sink rotation by one warp: the code row at row with
// its scale dequantised, rotated by one position (dim d's partner d ^ 1 is
// lane l ^ 1's; each product and the sum rounded as the plain version's
// separate f32 operations) and requantised in place
template <int HD>
__device__ __forceinline__ void fq_rotate_row(signed char* row, float* scale,
                                              const float* __restrict__ cexp,
                                              const float* __restrict__ sexp, int lane) {
  const float sc = *scale;
  float rot[HD / 32], m = 0.f;
#pragma unroll
  for (int k = 0; k < HD / 32; ++k) {
    const int d = lane + 32 * k;
    const float v = __fmul_rn((float)row[d], sc);
    const float pv = __shfl_xor_sync(0xffffffffu, v, 1);
    rot[k] = __fadd_rn(__fmul_rn(v, cexp[d]), __fmul_rn((d & 1) ? pv : -pv, sexp[d]));
    m = fmaxf(m, fabsf(rot[k]));
  }
  const float nsc = xq_row_scale(xq_warp_max(m));
  __syncwarp();  // every lane has read the row and its scale
#pragma unroll
  for (int k = 0; k < HD / 32; ++k) row[lane + 32 * k] = xq_code(rot[k], nsc);
  if (lane == 0) *scale = nsc;
}

// Grid (P, B * KH), clusters of the P blocks of one (batch, kv head); block
// p takes the whole 128-row chunks [floor(p C / P), floor((p + 1) C / P)),
// C = ceil(n / 128), n = kv_len[b] clamped to [0, S] and read here (the
// host never reads it). With knew set, the block whose chunks hold kv_pos
// (the last chunk's block past them, block 0 when n = 0) first inserts the
// quantised K and V rows there, and the block of chunk 0 re-rotates the
// sinks where rotate[b] is set: the block that writes a row is the only one
// that reads it. The cluster combines the P partials (fc_combine).
template <int G, int HD>
__global__ void __launch_bounds__(FQ_THREADS, (fq_min_blocks<G, HD>()))
    flash_decode_q_cluster_kernel(const __grid_constant__ CUtensorMap tk,
                                  const float* __restrict__ q, signed char* ck, signed char* cv,
                                  float* ks, float* vs, const float* __restrict__ knew,
                                  const float* __restrict__ vnew, const int* __restrict__ kv_pos,
                                  const int* __restrict__ rotate, const float* __restrict__ cexp,
                                  const float* __restrict__ sexp, const int* __restrict__ kv_len,
                                  float* __restrict__ out, int KH, int S, float sm_scale) {
  constexpr int VPL = fd_vpl<HD>(), NL = HD / VPL, GP = fc_gp(G);
  constexpr int NS = fq_slots<HD>(), SLOT = fq_slot_bytes<HD>(), KP = fq_panels<HD>();
  constexpr int W = FQ_WARPS, NT = FQ_THREADS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* slots = xq_align1024(smem_raw);  // [NS][SLOT] codes
  float* scales = reinterpret_cast<float*>(slots + NS * SLOT);  // [NS][FQ_CHUNK]
  float* wacc = reinterpret_cast<float*>(slots);                // [W][G][HD], the ring drained
  __shared__ uint64_t full[NS], empty[NS];
  __shared__ float wmx[2][W][GP];          // each warp's max of each head over its rows, by chunk parity
  __shared__ float pb[W][FQ_WROWS * GP];  // a warp's beta bf16(p v_scale), row r head g at r GP + g
  __shared__ float wl[W][G];
  __shared__ float pm[G], pl[G];  // the block's partial: max, sum of p
  // the P blocks' partials of this block's slice of the G x HD outputs
  // (fc_combine): max and sum of each head, and the slice's P.V, rank by rank
  __shared__ float gm[FC_MAX_SPLITS][G], gs[FC_MAX_SPLITS][G];
  __shared__ float ga[G * HD + FC_MAX_SPLITS];
  const int P = gridDim.x, p = blockIdx.x;
  const int b = blockIdx.y / KH, h = blockIdx.y % KH, H = KH * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = min(max(kv_len[b], 0), S);
  const int C = (n + FQ_CHUNK - 1) / FQ_CHUNK;
  const int c0 = (int)((long long)p * C / P), nch = (int)((long long)(p + 1) * C / P) - c0;
  const size_t row0 = ((size_t)b * KH + h) * S;  // the stripe's row 0 in the scale planes

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      xq_mbar_init(&full[s], 1);
      xq_mbar_init(&empty[s], W);
    }
    xq_mbar_fence_init();
  }
  xq_cluster_arrive_relaxed();  // this block has started: peers may write its shared memory
  __syncthreads();

  if (warp == W) {
    // the producer warp: the copies of the block's chunks, each chunk's K
    // plane (TMA) and then its V plane (a bulk copy), and the rows this
    // block writes (kernels 5-6) just before the copy of the first plane
    // that holds one
    bool ins = false, rot = false;
    int first = 0;  // the plane before whose copy the writes go
    const int kvp = knew != nullptr ? kv_pos[b] : -1;
    if (knew != nullptr) {
      // the block whose chunk range holds row r (the last chunk's past them;
      // block 0 when no row is live)
      const auto chunk = [&](int r) { return min(r / FQ_CHUNK, C - 1); };
      const auto owns = [&](int r) { return C == 0 ? p == 0 : c0 <= chunk(r) && chunk(r) < c0 + nch; };
      ins = kvp >= 0 && kvp < S && owns(kvp);
      rot = rotate[b] != 0 && owns(0);
      first = rot || C == 0 ? 0 : 2 * (chunk(kvp) - c0);
    }
    for (int j = 0; j <= 2 * nch; ++j) {
      if ((ins || rot) && j == first) {
        const size_t src = ((size_t)b * KH + h) * HD;
        if (ins) {
          fq_insert_row<HD>(ck + (row0 + kvp) * HD, ks + row0 + kvp, knew + src, lane);
          fq_insert_row<HD>(cv + (row0 + kvp) * HD, vs + row0 + kvp, vnew + src, lane);
          __syncwarp();  // the inserted row, before the sinks are read
        }
        if (rot) {
#pragma unroll
          for (int r = 0; r < KV_SINKS; ++r)
            fq_rotate_row<HD>(ck + (row0 + r) * HD, ks + row0 + r, cexp, sexp, lane);
        }
        xq_fence_proxy_async_global();  // this lane's stores, before the copies read them
        __syncwarp();
      }
      if (j == 2 * nch || lane != 0) continue;
      const int s = j % NS;
      if (j >= NS) xq_mbar_wait(&empty[s], (j / NS - 1) & 1);
      const int r0 = (c0 + j / 2) * FQ_CHUNK, nc = min(FQ_CHUNK, n - r0);
      // the scales of whole 4-row groups (a copy is 16-byte granular): S is
      // a multiple of 4, so they lie in the plane; rows past n are masked
      const uint32_t sb = (uint32_t)((nc + 3) & ~3) * 4;
      unsigned char* dst = slots + (size_t)s * SLOT;
      if (j & 1) {  // V: the live rows as they lie
        const uint32_t cb = (uint32_t)nc * HD;
        xq_mbar_expect_tx(&full[s], cb + sb);
        xq_bulk_g2s(dst, cv + (row0 + r0) * HD, cb, &full[s]);
      } else {  // K: KP boxes of 128 rows x 128 bytes (past S, or past HD, zeros)
        xq_mbar_expect_tx(&full[s], SLOT + sb);
        for (int k = 0; k < KP; ++k)
          xq_tma_3d(dst + k * FQ_CHUNK * 128, &tk, 128 * k, r0, b * KH + h, &full[s]);
      }
      xq_bulk_g2s(scales + s * FQ_CHUNK, ((j & 1) ? vs : ks) + row0 + r0, sb, &full[s]);
    }
  } else {
    // scores on the tensor cores: D (16 rows x 8 heads) = the warp's 16 K
    // rows of a chunk (A, the codes widened exactly to bf16) times q (B,
    // rounded to bf16, heads past G zero), mma m16n8k16 a 16-dim step. Lane
    // (r, c) = (lane / 4, lane % 4) takes dims 16 t + 4 c .. + 3 of step t
    // as its A columns 2 c, 2 c + 1, 2 c + 8, 2 c + 9 and, for head r, the
    // same dims of q as its B rows; it ends with rows r and r + 8, heads
    // 2 c and 2 c + 1.
    const int r = lane >> 2, c = lane & 3;
    const int h0 = 2 * c, h1 = 2 * c + 1;
    uint32_t qb[HD / 16][2];
#pragma unroll
    for (int t = 0; t < HD / 16; ++t) {
      const float4 v = r < G ? *reinterpret_cast<const float4*>(
                                   q + ((size_t)b * H + (size_t)h * G + r) * HD + 16 * t + 4 * c)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      qb[t][0] = xq_bf16x2(v.x, v.y);
      qb[t][1] = xq_bf16x2(v.z, v.w);
    }
    float mrun[G];      // each head's running max over the block's chunks (every lane the same)
    float l_run[2] = {0.f, 0.f};  // heads h0, h1: the sum of p over rows r and r + 8, at mrun
    float acc[G][VPL];  // P.V: the lane's VPL dims of each head
#pragma unroll
    for (int g = 0; g < G; ++g) {
      mrun[g] = -INFINITY;
#pragma unroll
      for (int e = 0; e < VPL; ++e) acc[g][e] = 0.f;
    }
    const int rw = warp * FQ_WROWS + r;  // the chunk rows of this lane's scores: rw, rw + 8
    for (int it = 0; it < nch; ++it) {
      const int nc = min(FQ_CHUNK, n - (c0 + it) * FQ_CHUNK);  // the chunk's live rows
      const int sk = (2 * it) % NS, sv = (2 * it + 1) % NS;
      xq_mbar_wait(&full[sk], (2 * it / NS) & 1);
      const unsigned char* kst = slots + (size_t)sk * SLOT;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int t = 0; t < HD / 16; ++t) {
        // 16-byte chunk t % 8 of a 128-byte panel row lies at chunk (t % 8) ^ (row % 8)
        const unsigned char* pa =
            kst + (t / 8) * FQ_CHUNK * 128 + rw * 128 + ((((t & 7) ^ (rw & 7)) << 4) | (c << 2));
        float f0[4], f1[4];
        xq_i8x4_to_f32(*reinterpret_cast<const uint32_t*>(pa), f0);
        xq_i8x4_to_f32(*reinterpret_cast<const uint32_t*>(pa + 8 * 128), f1);
        const uint32_t a[4] = {xq_bf16x2(f0[0], f0[1]), xq_bf16x2(f1[0], f1[1]),
                               xq_bf16x2(f0[2], f0[3]), xq_bf16x2(f1[2], f1[3])};
        fq_mma_bf16(d, a, qb[t][0], qb[t][1]);
      }
      // times k_scale / sqrt(hd); rows past the chunk's live ones and heads
      // past G out
      const float* kscale = scales + sk * FQ_CHUNK;
      const float s0 = __fmul_rn(kscale[rw], sm_scale), s1 = __fmul_rn(kscale[rw + 8], sm_scale);
      const bool l0 = rw < nc, l1 = rw + 8 < nc;
      float sc[4] = {l0 && h0 < G ? d[0] * s0 : -INFINITY, l0 && h1 < G ? d[1] * s0 : -INFINITY,
                     l1 && h0 < G ? d[2] * s1 : -INFINITY, l1 && h1 < G ? d[3] * s1 : -INFINITY};
      __syncwarp();
      if (lane == 0) xq_mbar_arrive(&empty[sk]);  // the K plane is done
      // heads h0, h1: the max over the warp's rows (lanes 4 apart hold other rows)
      float mx0 = fmaxf(sc[0], sc[2]), mx1 = fmaxf(sc[1], sc[3]);
#pragma unroll
      for (int o = 4; o < 32; o *= 2) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
      }
      if (r == 0) {
        if (h0 < G) wmx[it & 1][warp][h0] = mx0;
        if (h1 < G) wmx[it & 1][warp][h1] = mx1;
      }
      xq_bar_sync(1, W * 32);  // every warp's maxima of this chunk
      // the chunk's max mc of each head; the running max m' = max(m, mc);
      // the old terms weigh alpha = exp(m - m'), this chunk's beta = exp(mc - m')
      float mc[G], alpha[G], beta[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        mc[g] = wmx[it & 1][0][g];
#pragma unroll
        for (int w = 1; w < W; ++w) mc[g] = fmaxf(mc[g], wmx[it & 1][w][g]);
        const float mn = fmaxf(mrun[g], mc[g]);
        alpha[g] = expf(mrun[g] - mn);
        beta[g] = expf(mc[g] - mn);
        mrun[g] = mn;
      }
      // p = exp(score - the chunk's max), as the plain version's chunks
      const float m0 = fq_pick(mc, h0), m1 = fq_pick(mc, h1);
      const float b0 = fq_pick(beta, h0), b1 = fq_pick(beta, h1);
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pr[i] = sc[i] == -INFINITY ? 0.f : expf(sc[i] - ((i & 1) ? m1 : m0));
      l_run[0] = l_run[0] * fq_pick(alpha, h0) + b0 * (pr[0] + pr[2]);
      l_run[1] = l_run[1] * fq_pick(alpha, h1) + b1 * (pr[1] + pr[3]);
      xq_mbar_wait(&full[sv], ((2 * it + 1) / NS) & 1);
      const signed char* vst = reinterpret_cast<const signed char*>(slots + (size_t)sv * SLOT);
      const float* vscale = scales + sv * FQ_CHUNK;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = rw + 8 * (i >> 1), g = (i & 1) ? h1 : h0;
        if (sc[i] != -INFINITY)
          pb[warp][(row - warp * FQ_WROWS) * GP + g] =
              ((i & 1) ? b1 : b0) *
              __bfloat162float(__float2bfloat16_rn(__fmul_rn(pr[i], vscale[row])));
      }
      __syncwarp();
      // P.V over the V codes: the lane's dims of each of the warp's live rows
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < VPL; ++e) acc[g][e] *= alpha[g];
      const int live = min(FQ_WROWS, nc - warp * FQ_WROWS);
      if (lane < NL) {
#pragma unroll 4
        for (int rr = 0; rr < live; ++rr) {
          float vf[VPL];
          load_s8<VPL>(vst + (warp * FQ_WROWS + rr) * HD + lane * VPL, vf);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float pg = pb[warp][rr * GP + g];
#pragma unroll
            for (int e = 0; e < VPL; ++e) acc[g][e] += pg * vf[e];
          }
        }
      }
      __syncwarp();
      if (lane == 0) xq_mbar_arrive(&empty[sv]);  // the V plane is done
    }

    // the warp's partial (every warp at the block's running max) into shared memory
#pragma unroll
    for (int o = 4; o < 32; o *= 2) {
      l_run[0] += __shfl_xor_sync(0xffffffffu, l_run[0], o);
      l_run[1] += __shfl_xor_sync(0xffffffffu, l_run[1], o);
    }
    if (r == 0) {
      if (h0 < G) wl[warp][h0] = l_run[0];
      if (h1 < G) wl[warp][h1] = l_run[1];
    }
    if (warp == 0 && lane < G) pm[lane] = fq_pick(mrun, lane);
    xq_bar_sync(1, W * 32);  // every consumer warp is done with the ring
    if (lane < NL) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < VPL; e += 4)
          *reinterpret_cast<float4*>(wacc + (warp * G + g) * HD + lane * VPL + e) =
              make_float4(acc[g][e], acc[g][e + 1], acc[g][e + 2], acc[g][e + 3]);
    }
  }
  __syncthreads();
  if (tid < G) {
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) l += wl[w][tid];
    pl[tid] = l;
  }
  __syncthreads();
  fc_combine<G, HD, NT>(
      pm, pl,
      [&](int i) {
        float a = 0.f;
#pragma unroll
        for (int w = 0; w < W; ++w) a += wacc[w * G * HD + i];
        return a;
      },
      gm, gs, ga, wacc, out + ((size_t)b * H + (size_t)h * G) * HD);
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
// flash_prefill_kernel, both products in split TF32 on mma.sync m16n8k8
// (xq_mma_tf32x3: three TF32 products a step, f32 sums in chains of at
// most 24 steps, hopper.cuh). ROWS query rows a block, 16 a row group
// (rows 16 r + l / 4 and + 8 of lane l); PAIR warps share a row group, each
// taking HD / PAIR of Q's, K's and O's columns (at hd 256, where one warp's
// O would hold 128 floats a thread and leave an SM 4 warps: the pair's
// partial scores meet through shared memory, and both run the softmax on
// the same sums). Q f32 in shared memory (rows of HD + 4 floats: the
// fragment reads fall on 32 banks), split in registers per k-step; K and V
// f32 tiles of KT keys on a TMA ring (32-f32 swizzled panels of the (hd, S,
// B * KH) view, zeros past S), split in registers as each lane reads its
// fragment. S = Q K^T leaves the scores in the accumulator layout; P . V
// takes them as its A operand with the keys of each 8-key step permuted (A
// column j holds key 2 j, column j + 4 key 2 j + 1: the two a lane already
// holds), the V rows read in the same order. Neither P nor O passes
// through shared memory.
template <int HD>
__host__ __device__ constexpr int pf32_rows() { return HD == 256 ? 64 : 128; }
template <int HD>
__host__ __device__ constexpr int pf32_kt() { return HD == 256 ? 32 : 64; }
template <int HD>
__host__ __device__ constexpr int pf32_stages() { return HD == 96 ? 3 : 2; }
template <int HD>
__host__ __device__ constexpr int pf32_pair() { return HD == 256 ? 2 : 1; }
template <int HD>
__host__ __device__ constexpr int pf32_threads() { return pf32_rows<HD>() * 2 * pf32_pair<HD>(); }
template <int HD>
__host__ __device__ constexpr int pf32_xch() {  // floats of the pairs' score exchange
  return pf32_pair<HD>() > 1 ? pf32_threads<HD>() * pf32_kt<HD>() / 2 : 0;
}
template <int HD>
__host__ __device__ constexpr int pf32_smem() {
  // Q, the score exchange, the K and V tiles of each stage, 2 barriers and
  // a counter a stage, and the slack to align the ring to 1024
  return (pf32_rows<HD>() * (HD + 4) + pf32_xch<HD>()) * 4 +
         pf32_stages<HD>() * 2 * pf32_kt<HD>() * HD * 4 + 3 * pf32_stages<HD>() * 8 + 1024;
}

// A block's query positions at GQA group g, a T-row chunk's blocks, and the
// first position of block y, the longest tiles first
template <int HD>
__host__ __device__ inline int pf32_tq(int g) { return pf32_rows<HD>() / g; }
template <int HD>
__host__ __device__ inline int pf32_blocks(int T, int g) {
  return (T + pf32_tq<HD>(g) - 1) / pf32_tq<HD>(g);
}

template <int HD>
__global__ void __launch_bounds__(pf32_threads<HD>(), 1) flash_prefill_tf32x3_kernel(
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const float* __restrict__ q, const int* __restrict__ pos, float* __restrict__ out, int T,
    int H, int KH, float sm_scale) {
  constexpr int ROWS = pf32_rows<HD>(), KT = pf32_kt<HD>(), ST = pf32_stages<HD>();
  constexpr int PAIR = pf32_pair<HD>(), NW = ROWS / 16 * PAIR, NP = HD / 32, LDQ = HD + 4;
  constexpr int NPW = NP / PAIR, NTW = HD / 8 / PAIR;  // a warp's panels and O column blocks
  constexpr int PANEL = KT * 128;     // bytes of a 32-column panel of a tile
  constexpr int TILE = NP * PANEL;    // bytes of a K or V tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* kv = xq_align1024(smem_raw);  // ST stages of (K tile, V tile)
  float* Qs = reinterpret_cast<float*>(kv + ST * 2 * TILE);
  float* xch = Qs + ROWS * LDQ;  // (warp, score, lane)
  uint64_t* fullk = reinterpret_cast<uint64_t*>(xch + pf32_xch<HD>());
  uint64_t* fullv = fullk + ST;
  int* released = reinterpret_cast<int*>(fullv + ST);  // warps done with each stage, ever
  const int bh = blockIdx.x, b = bh / KH, h = bh % KH;
  const int g = H / KH, tq = ROWS / g;  // rows tq * g .. ROWS - 1 stay empty
  const int q0 = (pf32_blocks<HD>(T, g) - 1 - blockIdx.y) * tq;
  const int pb = pos[b];
  const int kend = pb + min(q0 + tq, T);  // keys >= kend are invisible to the block
  const int ntiles = (kend + KT - 1) / KT;
  auto load = [&](int j) {  // key tile j into stage j % ST (its previous tile released)
    const int s = j % ST;
    unsigned char* st = kv + s * 2 * TILE;
    xq_mbar_expect_tx(&fullk[s], TILE);
    for (int p = 0; p < NP; ++p) xq_tma_3d(st + p * PANEL, &tk, 32 * p, j * KT, bh, &fullk[s]);
    xq_mbar_expect_tx(&fullv[s], TILE);
    for (int p = 0; p < NP; ++p)
      xq_tma_3d(st + TILE + p * PANEL, &tv, 32 * p, j * KT, bh, &fullv[s]);
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
  for (int c = threadIdx.x; c < ROWS * (HD / 4); c += blockDim.x) {
    const int R = c / (HD / 4), col = (c % (HD / 4)) * 4, tl = R / g;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tl < tq && q0 + tl < T)
      v = *reinterpret_cast<const float4*>(
          q + (((size_t)b * T + q0 + tl) * H + (size_t)h * g + R % g) * HD + col);
    *reinterpret_cast<float4*>(Qs + R * LDQ + col) = v;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, lr = lane / 4, lc = lane % 4;
  const int rg = warp / PAIR, half = warp % PAIR;  // row group; which columns of the pair
  const float* qw = Qs + (16 * rg + lr) * LDQ + lc;  // this lane's A reads, row lr, column lc
  int qpos[2];
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) qpos[hh] = pb + q0 + (16 * rg + lr + 8 * hh) / g;
  float o[NTW][4];  // O column blocks half * NTW ..
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % ST, ph = (it / ST) & 1, k0 = it * KT;
    const unsigned char* kt = kv + s * 2 * TILE;
    const unsigned char* vt = kt + TILE;
    float sc[KT / 8][4];
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
    xq_mbar_wait(&fullk[s], ph);
    // S = Q . K^T over this warp's panels, 32 columns of Q and K at a time
    // (4 k-steps: 12 steps into a fresh chain, then IEEE adds); k-step ks
    // takes columns 8 ks .. 8 ks + 7
#pragma unroll 1
    for (int p = half * NPW; p < (half + 1) * NPW; ++p) {
      const unsigned char* kp = kt + p * PANEL;
      float part[KT / 8][4];
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        const int ks = 4 * p + k4;
        uint32_t ab[4], as[4];
        xq_tf32_split(qw[8 * ks], ab[0], as[0]);
        xq_tf32_split(qw[8 * ks + 8 * LDQ], ab[1], as[1]);
        xq_tf32_split(qw[8 * ks + 4], ab[2], as[2]);
        xq_tf32_split(qw[8 * ks + 8 * LDQ + 4], ab[3], as[3]);
        const int c0 = 8 * k4 + lc;
#pragma unroll
        for (int n = 0; n < KT / 8; ++n) {  // keys 8 n + lr of the tile
          const int r = 8 * n + lr;
          uint32_t bb0, bs0, bb1, bs1;
          xq_tf32_split(*reinterpret_cast<const float*>(kp + xq_sw128_f32(r, c0)), bb0, bs0);
          xq_tf32_split(*reinterpret_cast<const float*>(kp + xq_sw128_f32(r, c0 + 4)), bb1, bs1);
          xq_mma_tf32x3(part[n], ab, as, bb0, bb1, bs0, bs1);
        }
      }
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] += part[n][e];
    }
    if constexpr (PAIR > 1) {  // the pair's two partial sums, added in either order alike
      float* mine = xch + warp * (KT / 2) * 32 + lane;
      const float* theirs = xch + (warp ^ 1) * (KT / 2) * 32 + lane;
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(4 * n + e) * 32] = sc[n][e];
      xq_bar_sync(1 + rg, 64);
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] += theirs[(4 * n + e) * 32];
      xq_bar_sync(1 + rg, 64);  // read before the next tile's writes
    }

    // online softmax: sc[n][e] is row hh = e / 2, key k0 + 8 n + 2 lc + e % 2
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1, key = k0 + 8 * n + 2 * lc + (e & 1);
        sc[n][e] = key <= qpos[hh] ? sc[n][e] * sm_scale : -INFINITY;
        mt[hh] = fmaxf(mt[hh], sc[n][e]);
      }
    float alpha[2], m_new[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(0xffffffffu, mt[hh], 1));
      mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(0xffffffffu, mt[hh], 2));
      m_new[hh] = fmaxf(m_run[hh], mt[hh]);
      alpha[hh] = m_new[hh] == -INFINITY ? 1.f : expf(m_run[hh] - m_new[hh]);
    }
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        sc[n][e] = sc[n][e] == -INFINITY ? 0.f : expf(sc[n][e] - m_new[hh]);
        psum[hh] += sc[n][e];
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      psum[hh] += __shfl_xor_sync(0xffffffffu, psum[hh], 1);
      psum[hh] += __shfl_xor_sync(0xffffffffu, psum[hh], 2);
      l_run[hh] = l_run[hh] * alpha[hh] + psum[hh];
      m_run[hh] = m_new[hh];
    }

    // O = alpha O + P . V: 8-key step kk, A column lc holding key 8 kk + 2 lc
    // and column lc + 4 key 8 kk + 2 lc + 1; B = V rows in that order. Each
    // 8-column block of O takes the tile's steps in a fresh chain (at most
    // 24), then one IEEE fma
    uint32_t pb[KT / 8][4], ps[KT / 8][4];
#pragma unroll
    for (int kk = 0; kk < KT / 8; ++kk) {
      xq_tf32_split(sc[kk][0], pb[kk][0], ps[kk][0]);
      xq_tf32_split(sc[kk][2], pb[kk][1], ps[kk][1]);
      xq_tf32_split(sc[kk][1], pb[kk][2], ps[kk][2]);
      xq_tf32_split(sc[kk][3], pb[kk][3], ps[kk][3]);
    }
    xq_mbar_wait(&fullv[s], ph);
#pragma unroll
    for (int n = 0; n < NTW; ++n) {  // output columns 8 (half * NTW + n) + lr
      const int nb = half * NTW + n;
      const unsigned char* vp = vt + (nb / 4) * PANEL;
      const int c = 8 * (nb % 4) + lr;
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < KT / 8; ++kk) {
        const int r = 8 * kk + 2 * lc;
        uint32_t bb0, bs0, bb1, bs1;
        xq_tf32_split(*reinterpret_cast<const float*>(vp + xq_sw128_f32(r, c)), bb0, bs0);
        xq_tf32_split(*reinterpret_cast<const float*>(vp + xq_sw128_f32(r + 1, c)), bb1, bs1);
        xq_mma_tf32x3(part, pb[kk], ps[kk], bb0, bb1, bs0, bs1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = fmaf(o[n][e], alpha[e >> 1], part[e]);
    }
    // the last of the NW warps done with this stage refills it with tile
    // it + ST: no warp waits for another to free a stage
    __syncwarp();
    if (lane == 0 && it + ST < ntiles) {
      __threadfence_block();
      if (atomicAdd(&released[s], 1) == NW * (it / ST) + NW - 1) load(it + ST);
    }
    __syncwarp();
  }

  // O / l: o[n][e] is row hh = e / 2, column 8 (half * NTW + n) + 2 lc + e % 2
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int R = 16 * rg + lr + 8 * hh, tl = R / g;
    if (tl >= tq || q0 + tl >= T) continue;
    const float ldiv = l_run[hh] > 0.f ? l_run[hh] : 1.f;
    float* dst = out + (((size_t)b * T + q0 + tl) * H + (size_t)h * g + R % g) * HD +
                 8 * half * NTW + 2 * lc;
#pragma unroll
    for (int n = 0; n < NTW; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(o[n][2 * hh] / ldiv, o[n][2 * hh + 1] / ldiv);
  }
}

// Flash prefill over an f32 cache: tensor maps of the layer's K and V as
// (B * KH, S, hd) (32-column f32 boxes of KT keys), then one block per
// (batch x kv head, ROWS / G positions), the last query tiles first
template <int HD>
cudaError_t launch_flash_prefill_f32(const float* q, const float* ck, const float* cv,
                                     const int* pos, float* out, int B, int T, int H, int KH,
                                     int S, float sm_scale, cudaStream_t s) {
  CUtensorMap tk, tv;
  const uint64_t dims[3] = {(uint64_t)HD, (uint64_t)S, (uint64_t)B * KH};
  const uint64_t strides[2] = {(uint64_t)HD * 4, (uint64_t)S * HD * 4};
  const uint32_t box[3] = {32, pf32_kt<HD>(), 1};
  if (!xq_tensor_map(&tk, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, ck, dims, strides, box) ||
      !xq_tensor_map(&tv, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, cv, dims, strides, box))
    return cudaErrorInvalidConfiguration;
  cudaError_t e = xq_allow_smem(flash_prefill_tf32x3_kernel<HD>, pf32_smem<HD>());
  if (e != cudaSuccess) return e;
  const dim3 grid(B * KH, pf32_blocks<HD>(T, H / KH));
  flash_prefill_tf32x3_kernel<HD><<<grid, pf32_threads<HD>(), pf32_smem<HD>(), s>>>(
      tk, tv, q, pos, out, T, H, KH, sm_scale);
  return cudaGetLastError();
}

// Kernel 3's blocks a (batch, kv head) for B x KH on a card of `sms` SMs:
// about one block an SM over the whole grid, 1 to FC_MAX_SPLITS (the
// largest cluster). The host never reads kv_len: each block splits it on
// the card.
int fc_splits(int B, int KH, int sms) {
  return max(1, min(FC_MAX_SPLITS, sms / max(1, B * KH)));
}

// The launch of `kern` (a cluster kernel of kernels 3 and 7: `threads` a
// block, `smem` bytes of dynamic shared memory) for P blocks a cluster and
// nbh (batch, kv head) pairs into cfg (attr its cluster dimension). Sets the
// kernel's shared-memory and cluster-size attributes and asks the card, once
// per cluster size (fits: the kernel's answers, 1 fits, -1 not), whether one
// such cluster fits (cudaOccupancyMaxActiveClusters);
// cudaErrorInvalidConfiguration if not.
template <typename K>
cudaError_t cluster_config(K kern, int threads, int smem, int P, int nbh, cudaStream_t s,
                           int (&fits)[FC_MAX_SPLITS + 1], cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute& attr) {
  cfg = {};
  cfg.gridDim = dim3(P, nbh);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = P;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (P < 1 || P > FC_MAX_SPLITS) return cudaErrorInvalidValue;
  if (fits[P] == 0) {
    cudaError_t e = xq_allow_smem(kern, smem);
    if (e == cudaSuccess && P > 8)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    int n = 0;
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
    if (e != cudaSuccess) return e;
    fits[P] = n > 0 ? 1 : -1;
  }
  return fits[P] > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <int G, int HD, typename CT>
cudaError_t fc_config(int P, int nbh, cudaStream_t s, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute& attr) {
  static int fits[FC_MAX_SPLITS + 1];
  return cluster_config(flash_decode_cluster_kernel<G, HD, CT>, FC_THREADS,
                        fc_smem<G, HD, CT>(), P, nbh, s, fits, cfg, attr);
}

// Kernel 7's blocks a (batch, kv head): kernel 3's count (fc_splits), at
// most the S-row window's chunks. Each block takes whole chunks of the live
// rows, which it splits on the card.
int fq_splits(int B, int KH, int S, int sms) {
  return max(1, min(fc_splits(B, KH, sms), (S + FQ_CHUNK - 1) / FQ_CHUNK));
}

template <int G, int HD>
cudaError_t fq_config(int P, int nbh, cudaStream_t s, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute& attr) {
  static int fits[FC_MAX_SPLITS + 1];
  return cluster_config(flash_decode_q_cluster_kernel<G, HD>, FQ_THREADS, fq_smem<G, HD>(), P,
                        nbh, s, fits, cfg, attr);
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

// Kernels 2 and 3 in one launch (the port's fused_decode_attention) over
// one layer of a bf16 (f32 == 0) or f32 cache (ck, cv): the new K and V
// rows (knew, vnew, (B, KH, hd) f32) stored at kv_pos (dropped at kv_pos >=
// S, the sentinel) and the sink keys re-rotated where rotate is set (cexp,
// sexp), each row by the block that reads it, before it reads it; then q
// attends over the first kv_len rows.
XQ_EXPORT int xq_fused_decode_attention(const void* q, void* ck, void* cv, const void* knew,
                                        const void* vnew, const void* kv_pos, const void* rotate,
                                        const void* cexp, const void* sexp, const void* kv_len,
                                        void* out, int B, int H, int KH, int S, int hd,
                                        float sm_scale, int f32, void* stream) {
  if (B < 1 || KH < 1 || H % KH != 0 || S < 1 || hd % 32 != 0 || knew == nullptr ||
      vnew == nullptr || kv_pos == nullptr || rotate == nullptr)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int P = fc_splits(B, KH, xq_device_sms());
  return (int)for_cache(f32, [&](auto t) {
    using CT = decltype(t);
    return for_head_dim(hd, [&](auto d) {
      return for_group(H / KH, [&](auto g) {
        constexpr int G = decltype(g)::value, HD = decltype(d)::value;
        cudaLaunchConfig_t cfg;
        cudaLaunchAttribute attr;
        const cudaError_t e = fc_config<G, HD, CT>(P, B * KH, s, cfg, attr);
        if (e != cudaSuccess) return e;
        const cudaError_t l = cudaLaunchKernelEx(
            &cfg, flash_decode_cluster_kernel<G, HD, CT>, (const float*)q, (CT*)ck, (CT*)cv,
            (const float*)knew, (const float*)vnew, (const int*)kv_pos, (const int*)rotate,
            (const float*)cexp, (const float*)sexp, (const int*)kv_len, (float*)out, KH, S,
            sm_scale);
        return l != cudaSuccess ? l : cudaGetLastError();
      });
    });
  });
}

// xq_fused_decode_attention's launch over a bf16 (f32 == 0) or an f32 cache on the
// current device: plan (3 ints) = {blocks a (batch, kv head), which are one
// cluster; key rows a stage; stages}; cudaErrorInvalidValue for a shape it
// refuses, cudaErrorInvalidConfiguration where the card cannot hold such a
// cluster. ops/attention.py's decode_plan is held to it on the card.
XQ_EXPORT int xq_flash_decode_plan(int B, int H, int KH, int hd, int f32, void* plan) {
  if (B < 1 || KH < 1 || H % KH != 0) return (int)cudaErrorInvalidValue;
  const int P = fc_splits(B, KH, xq_device_sms());
  return (int)for_cache(f32, [&](auto t) {
    using CT = decltype(t);
    return for_head_dim(hd, [&](auto d) {
      return for_group(H / KH, [&](auto g) {
        constexpr int G = decltype(g)::value, HD = decltype(d)::value;
        cudaLaunchConfig_t cfg;
        cudaLaunchAttribute attr;
        const cudaError_t e = fc_config<G, HD, CT>(P, B * KH, nullptr, cfg, attr);
        if (e != cudaSuccess) return e;
        int* out = (int*)plan;
        out[0] = P;
        out[1] = fc_rows<G, HD, CT>();
        out[2] = FC_STAGES;
        return cudaSuccess;
      });
    });
  });
}

XQ_EXPORT int xq_flash_prefill(const void* q, const void* ck, const void* cv, const void* pos,
                               void* out, int B, int T, int H, int KH, int S, int hd,
                               float sm_scale, int f32, void* stream) {
  if (KH < 1 || H % KH != 0 || H / KH > FD_MAX_G || T < 1) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return (int)for_head_dim(hd, [&](auto d) {
    constexpr int HD = decltype(d)::value;
    if (f32)
      return launch_flash_prefill_f32<HD>((const float*)q, (const float*)ck, (const float*)cv,
                                          (const int*)pos, (float*)out, B, T, H, KH, S, sm_scale,
                                          s);
    return launch_flash_prefill<HD>((const float*)q, (const __nv_bfloat16*)ck,
                                    (const __nv_bfloat16*)cv, (const int*)pos, (float*)out, B, T,
                                    H, KH, S, sm_scale, s);
  });
}

// xq_flash_prefill's blocks over a bf16 (f32 == 0) or an f32 cache for a
// T-row chunk: *tq query positions a block, q0s[y] the first position of
// block y for each of the chunk's blocks (at most cap);
// cudaErrorInvalidValue for a shape it refuses. ops/attention.py's
// prefill_plan is held to it on the card.
XQ_EXPORT int xq_flash_prefill_plan(int T, int H, int KH, int hd, int f32, void* tq, void* q0s,
                                    int cap) {
  if (KH < 1 || H % KH != 0 || H / KH < 1 || H / KH > FD_MAX_G || T < 1)
    return (int)cudaErrorInvalidValue;
  return (int)for_head_dim(hd, [&](auto d) {
    constexpr int HD = decltype(d)::value;
    const int g = H / KH, n = f32 ? pf32_blocks<HD>(T, g) : pf_blocks(T, g);
    const int step = f32 ? pf32_tq<HD>(g) : pf_tq(g);
    if (n > cap) return cudaErrorInvalidValue;
    *(int*)tq = step;
    for (int y = 0; y < n; ++y) ((int*)q0s)[y] = (n - 1 - y) * step;
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

// Kernel 7 over one layer of an int8 cache (codes ck, cv; scale planes ks,
// vs), with kernels 5-6 in the same launch where knew is set: the new K and
// V rows (knew, vnew) quantised in at kv_pos and the sinks re-rotated where
// rotate is set (cexp, sexp), before the rows are read. knew null: attention
// alone (vnew, kv_pos, rotate, cexp and sexp unread). S must be a multiple
// of 4 (a chunk's scales are copied in 16-byte groups).
XQ_EXPORT int xq_flash_decode_q(const void* q, void* ck, void* cv, void* ks, void* vs,
                                const void* knew, const void* vnew, const void* kv_pos,
                                const void* rotate, const void* cexp, const void* sexp,
                                const void* kv_len, void* out, int B, int H, int KH, int S, int hd,
                                float sm_scale, void* stream) {
  if (B < 1 || KH < 1 || H % KH != 0 || S < 4 || S % 4 != 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int P = fq_splits(B, KH, S, xq_device_sms());
  return (int)for_head_dim(hd, [&](auto d) {
    return for_group(H / KH, [&](auto g) {
      constexpr int G = decltype(g)::value, HD = decltype(d)::value;
      cudaLaunchConfig_t cfg;
      cudaLaunchAttribute attr;
      const cudaError_t e = fq_config<G, HD>(P, B * KH, s, cfg, attr);
      if (e != cudaSuccess) return e;
      // the layer's K codes as (B * KH, S, HD) bytes, boxes of 128 rows x
      // 128 bytes, 128-byte swizzled (bytes past HD or rows past S: zeros)
      CUtensorMap tk;
      const uint64_t dims[3] = {(uint64_t)HD, (uint64_t)S, (uint64_t)B * KH};
      const uint64_t strides[2] = {(uint64_t)HD, (uint64_t)S * HD};
      const uint32_t box[3] = {128, FQ_CHUNK, 1};
      if (!xq_tensor_map(&tk, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, ck, dims, strides, box))
        return cudaErrorInvalidConfiguration;
      const cudaError_t l = cudaLaunchKernelEx(
          &cfg, flash_decode_q_cluster_kernel<G, HD>, tk, (const float*)q, (signed char*)ck,
          (signed char*)cv, (float*)ks, (float*)vs, (const float*)knew, (const float*)vnew,
          (const int*)kv_pos, (const int*)rotate, (const float*)cexp, (const float*)sexp,
          (const int*)kv_len, (float*)out, KH, S, sm_scale);
      return l != cudaSuccess ? l : cudaGetLastError();
    });
  });
}

// xq_flash_decode_q's launch on the current device: plan (3 ints) =
// {blocks a (batch, kv head), which are one cluster; key rows a chunk; ring
// slots}; cudaErrorInvalidValue for a shape it refuses,
// cudaErrorInvalidConfiguration where the card cannot hold such a cluster.
// ops/attention.py's decode_q_plan is held to it on the card.
XQ_EXPORT int xq_flash_decode_q_plan(int B, int H, int KH, int S, int hd, void* plan) {
  if (B < 1 || KH < 1 || H % KH != 0 || S < 4 || S % 4 != 0) return (int)cudaErrorInvalidValue;
  const int P = fq_splits(B, KH, S, xq_device_sms());
  return (int)for_head_dim(hd, [&](auto d) {
    return for_group(H / KH, [&](auto g) {
      constexpr int G = decltype(g)::value, HD = decltype(d)::value;
      cudaLaunchConfig_t cfg;
      cudaLaunchAttribute attr;
      const cudaError_t e = fq_config<G, HD>(P, B * KH, nullptr, cfg, attr);
      if (e != cudaSuccess) return e;
      int* out = (int*)plan;
      out[0] = P;
      out[1] = FQ_CHUNK;
      out[2] = fq_slots<HD>();
      return cudaSuccess;
    });
  });
}
