// Whole-step decode megakernel for Hopper (sm_90a).
//
// Replaces xalm_tpu/ops/fused_decode.py::_kernel (through fused_decode_step)
// for an i8 body with per-row f32 scales, a StreamingLLM cache of bf16, of
// f32 or of int8 codes with per-row f32 scale planes (the TPU kernel's
// `quant` branch), 1 <= B <= 8 rows at t = 1, head_dim 128 or 256 (a template
// parameter, dispatched at launch), and its two folds: the embed fold (the bf16 embed row gathered,
// times the embed scale, and the rope trig computed in the kernel) and the
// i8-head fold (final norm, i8 classifier, first-occurrence argmax). The three
// cache kinds and the two head dims are instantiations of one kernel, and
// at head_dim 128 so is the choice of the Gemma folds' code (FAM): with it
// compiled in, the kernel ran 4-5 % slower on models that use none of them
// (PERF.md). The family folds are run-time options (null pointers or zeros
// when off) of every instantiation that has their code: the Qwen folds of
// all, the Gemma folds of FAM's:
//   - the Qwen2 qkv bias (the TPU kernel's has_bias, added to each qkv row in
//     phase 1's epilogue, after the scale);
//   - the Qwen3 per-head q/k RMS norms (its has_qk: phase 2 norms each query
//     head and the K head over their hd lanes after the clip, before rope;
//     V is not normed);
//   - Gemma's embed scale (its ES: the gathered embed row times it) and
//     tanh-approximate gelu in place of SiLU (its act == "gelu");
//   - Gemma-2's attention softcap (its asc: each score s, after the
//     1/sqrt(hd) scale, becomes tanh(s / asc) * asc in phase 3), logit
//     softcap (its lsc: each logit of the head fold, before the argmax) and
//     post-norms (its has_pn: the wo and w2 outputs RMS-normed with
//     post_attn_norm / post_mlp_norm before their residual adds). A post-norm
//     needs the whole output row, which is spread over the blocks, so phase
//     5 (and 7) writes the projection p to the workspace instead of adding
//     it. The next phase, which starts after a barrier anyway, takes p's
//     rms in every block and reads x + p * rsqrt(mean(p^2) + eps) * w in
//     place of x for its own rms and staging, and the phase after it, which
//     does not read x, stores that sum into x (a grid-stride slice per
//     block). The last layer's sum goes to xout (and into the head fold)
//     the same way. No barrier is added: 1 + 7L a step, as without them.
//
// Its weight phases come in three bodies, one instantiation each (times the
// three cache kinds and three (head_dim, FAM) pairs, (128, no), (128, yes) and
// (256, yes): twenty-seven; the nine of the f32 cache build as a library of
// their own, fused_decode_f32.cu, beside the others): the i8 body times bf16
// activations; the a8 body (the TPU
// kernel's _a8dot) and the q4 body (its _q4dot), which quantise each phase's
// f32 input row (the normed x, attn, act; the normed x of the i8 head) to
// int8 codes with its absmax / 127 -- every block takes the amax of the rows
// it stages itself, so no grid barrier is added -- and run __dp4a s8 x s8
// dots: a8 over int8 rows, f32(sum) * row scale * x's scale; q4 over packed
// rows (K/2 bytes) with (D, K/group) group scales, each group's exact int32
// dot scaled in f32 and summed in the reference's group order, then times
// x's scale (gemv.cuh). The i8 head runs the a8 body under a8 and q4.
//
// One cooperative, persistent launch per decode step. The grid is exactly
// the blocks that can be co-resident (occupancy API x SM count), so every
// block can wait at a grid barrier for all the others; the L layers loop
// inside the kernel and barriers separate the phases. Per layer:
//
//   1. rmsnorm(x) * attn_norm, cast to bf16, times wqkv -> qkv (GEMV),
//      plus the qkv bias;
//   2. per (row, kv head): clip, the q/k norms (each head's sum of squares
//      by warp shuffles and a named barrier over the item's hd threads: two
//      items a block at hd 128, one at hd 256),
//      rope (q pre-scaled by 1/sqrt(hd)), the K/V
//      rows rounded to bf16 (an f32 cache: stored as they are) and inserted
//      at kv_pos (dropped at the kv_pos == S sentinel), and for rows with
//      `rotate` the KV_SINKS sink keys rotated by one position (each product
//      and the sum rounded as the plain version's separate f32 operations,
//      then rounded to bf16, or not in an f32 cache).
//      int8 cache: q stays unscaled; the K and V rows are quantised (absmax
//      by warp shuffles and a named barrier over the item's hd threads,
//      since the two items of a block may run different numbers of
//      iterations) and their codes and scales written; the sinks are
//      dequantised with their scales, rotated and requantised;
//   3. split flash-decode over (row, kv head, 128-key chunk): f32 scores
//      over the cache rows (two threads a row, hd / 2 dims each; the
//      softcap), chunk max and exp-sum, un-normalised P.V over 128-dim
//      slices of the rows (two at hd 256).
//      int8 cache: the row scales factor out of both dots, as in
//      csrc/attention.cu's xq_flash_decode_q (bf16 q times the codes, times
//      k_scale / sqrt(hd); bf16(p * v_scale) times the V codes);
//   4. combine the chunks' (max, sum, acc) partials -> attn (B, QD) f32;
//   5. bf16(attn) times wo, plus the residual (post-norms: into p);
//   6. rmsnorm(x) * mlp_norm times w13, SiLU(gate) * up (or gelu) on each
//      chunk pair (a warp owns a gate row and the up row c13 rows after
//      it) -> act;
//   7. bf16(act) times w2, plus the residual (post-norms: into p).
//
// With the head fold, one more phase runs the final norm and the i8 head
// GEMV, writes the logits and each block's argmax partial, and after one
// more barrier block 0 reduces the partials to the first-occurrence argmax.
//
// The GEMV phases use the warp cores of gemv.cuh (csrc/qmatmul.cu's M <= 8
// route): a warp per output row pair, 16-byte int8 loads through the
// read-only path, each lane's weight words one or two steps ahead of the
// products that use them (the q4 core: the next chunk of words before its
// group's reductions and scale loads), the activations normalised and cast
// to bf16 once per block into shared memory (in column chunks when B rows
// of the contraction do not fit in 64 KB). Every block reaches every
// barrier, with or without work.
//
// Memory discipline: the workspace (allocated once by the wrapper) holds the
// barrier word, the x residual (B, N) f32, qkv, the rotated q, the
// attention partials, attn, act, the two post-norm projections and the
// argmax partials; the kernel
// allocates nothing. Anything another block wrote in this launch (x, qkv,
// q, partials, attn, act, and the cache rows and sinks just written) is
// read with __ldcg, past the SM's L1, which is not coherent across SMs:
// x is re-read in phases 1, 5, 6 and 7 of every layer, and a stale L1 line
// would be a silent error. __ldg and the read-only path are for the
// weights, norms, scales and step inputs, which nothing writes.
//
// What bounds it on the H100: the weight bytes. The 7B layer stack is 6.98
// GB of int8 (2.08 ms at 3.35 TB/s), 3.49 GB packed in q4 plus 54.5 MB of
// group-512 scales (1.06 ms), the i8 head 0.13 GB more; the K and V
// cache rows at kv_len 520 are 68 MB in bf16 (2 x 32 layers x 520 rows x
// 1024 values x 2 B), 136 MB in f32 (four 16-byte loads a key row's half
// where bf16 takes two), 34 MB of int8 codes plus 1 MB of scales in the int8
// cache; Gemma-2-9B's 42 layers are 8.33 GB (2.49 ms), its i8 head 0.92 GB.
// Compute is B FMAs per weight byte on the CUDA cores (the folds add a
// tanh per score, per logit and per gate, and two row norms per layer: no
// weight bytes). Each grid barrier costs one atomic per block and a spin on
// one word (measured by xq_grid_barrier_bench, PERF.md); a step has 1 + 7L
// of them (+1 with the head fold): 225 at 32 layers. What keeps the
// weight stream from the byte rate is the bytes in flight (Little's law at
// 3.35 TB/s over 132 SMs: ~25 KB an SM a microsecond of latency) and the
// gaps at the barriers, where it stops. The design: (1) each lane keeps
// two or three steps of 16-byte words of its two rows in flight (gemv.cuh's
// cores: 32-48 KB an SM at 16 warps), and the int8 codes widen by byte
// permutes rather than the int-to-float conversion, whose rate (16 a clock
// an SM) is near the SM's share of the byte rate; (2) in the q4 body the
// stream does not restart cold after a barrier: the rows a block streams
// in a phase are fixed before the phase (walk_pairs' deal; nothing writes
// the weights), so before the barrier in front of each GEMV phase every
// block asks for the first MK_PF bytes of its first rows of that phase to
// be brought into L2 (prefetch_pairs: one bulk prefetch a row, no shared
// memory, no barrier), and during phases 2-4, which read no weights, for
// its wo rows whole (Mistral's wo: 16.8 MB of the 50 MB L2). The i8 and a8
// bodies make no prefetch: on an H100 they ran faster without it (PERF.md
// section 6). No wgmma or TMA: B <= 8 rows of activations use a weight byte
// at most 8 times, far below the tensor cores' ~295 operations a byte.
//
// Limits (cudaErrorInvalidValue): head_dim other than 128 and 256 (Phi-3's
// 96 decodes on the per-layer kernels), a cache kind this library was not
// built for (or int8 without scale planes), B outside 1..8, a GQA group
// outside 1..8, widths that are not multiples of 16, a q4 group that is not
// a multiple of 128 dividing every half contraction width, or whose
// high-group terms and one group of codes per row exceed the block's 64 KB
// of shared memory (at 7B widths every group from 128 up fits at B = 8), or
// a device where not one block can be resident.

#include <math.h>

#include "gemv.cuh"
#include "hopper.cuh"

namespace {

constexpr int MK_THREADS = 256;
constexpr int MK_WARPS = MK_THREADS / 32;
constexpr int MK_MAX_B = 8;
constexpr int MK_MAX_G = 8;
constexpr int MK_MAX_HD = 256;
constexpr int MK_SLICE = 128;                 // dims of a P.V slice in phase 3
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
  const int8_t* wqkv;  // (L, DQ, N), q4: (L, DQ, N/2) packed
  const float* sqkv;   // (L, DQ), q4: (L, DQ, N/group)
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
  const float* bqkv;    // (L, DQ) Qwen2 qkv bias in wqkv's row order, or null
  const float* q_norm;  // (L, hd) Qwen3 per-head q RMS-norm weights, or null (with k_norm)
  const float* k_norm;
  const float* post_attn_norm;  // (L, N) Gemma-2 post-norms, or null (with post_mlp_norm)
  const float* post_mlp_norm;
  float* xout;    // (B, N)
  float* logits;  // (B, V) (head fold)
  int* token;     // (B) (head fold)
  unsigned char* work;
  int L, B, N, KH, G, H, S, V, c13;  // head_dim is the kernel's HD
  int group;  // q4 body: codes per group scale (the weights are packed rows)
  int gelu;   // 1: tanh-approximate gelu(gate) * up (Gemma), 0: SiLU
  float eps, clip, sm_scale;
  float embed_scale;    // the embed fold's row times this (Gemma: sqrt(dim))
  float attn_softcap;   // 0: none
  float logit_softcap;  // 0: none
};

// byte offsets of the workspace regions, the same on the host and the card
struct WsLayout {
  size_t x, qkv, q, pm, pl, pacc, attn, act, pa, pd, amv, ami, total;
};

__host__ __device__ inline size_t ws_take(size_t& off, size_t bytes) {
  const size_t at = off;
  off += (bytes + 255) / 256 * 256;
  return at;
}

__host__ __device__ inline WsLayout ws_layout(int B, int N, int KH, int G, int S, int H, int hd) {
  const size_t HQ = (size_t)KH * G, DQ = (size_t)KH * (G + 2) * hd;
  const size_t NS = (S + MK_CHUNK - 1) / MK_CHUNK;
  WsLayout o;
  size_t off = 256;  // the barrier word
  o.x = ws_take(off, (size_t)B * N * 4);
  o.qkv = ws_take(off, (size_t)B * DQ * 4);
  o.q = ws_take(off, (size_t)B * HQ * hd * 4);
  o.pm = ws_take(off, (size_t)B * HQ * NS * 4);
  o.pl = ws_take(off, (size_t)B * HQ * NS * 4);
  o.pacc = ws_take(off, (size_t)B * HQ * NS * hd * 4);
  o.attn = ws_take(off, (size_t)B * HQ * hd * 4);
  o.act = ws_take(off, (size_t)B * H * 4);
  o.pa = ws_take(off, (size_t)B * N * 4);  // post-norms: the wo projection
  o.pd = ws_take(off, (size_t)B * N * 4);  // post-norms: the w2 projection
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

// 1/sqrt(mean(x_b^2) + eps) of each of the B rows of x, into rinv[b]; src(b,
// n) returns the row's 4 values at n
template <typename Src>
__device__ void rows_rms(Src src, int B, int N, float eps, float* rinv, float* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int b = 0; b < B; ++b) {
    float ss = 0.f;
    for (int i = tid; i < N / 4; i += MK_THREADS) {
      const float4 v = src(b, 4 * i);
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

// The weight-phase bodies: int8 weights times bf16 activations (the TPU
// kernel's default), int8 weights times int8 activation codes (a8, its
// _a8dot), packed-q4 weights times int8 codes (q4, its _q4dot).
enum Body { BODY_BF16 = 0, BODY_A8 = 1, BODY_Q4 = 2 };

// bytes of a q4 phase's high-group terms: per warp, 2 rows x MK_MAX_B x npg
__host__ __device__ inline int q4_hterm_bytes(int K, int group) {
  return MK_WARPS * 2 * MK_MAX_B * (K / 2 / group) * (int)sizeof(float);
}

// One GEMV phase over the D rows of w and their scales sc: int8 rows of K
// with (D) row scales, or for BODY_Q4 packed rows of K/2 bytes with (D,
// K/group) group scales. The block stages its B activation rows src(b, n)
// (src returns 4 columns at n) into shared memory: as bf16, or for a8/q4
// as int8 codes of the f32 rows, quantised with each row's absmax, which
// the block takes itself (every block stages the whole row, so no grid
// barrier is needed). Each warp dots its row pairs, and lane 0 calls
// epi(p, r0, r1, b, v0, v1) with the two rows' finished values (v1 is
// meaningless when r1 >= D): bf16: sum * scale; a8: f32(sum) * scale *
// x's scale; q4: (group sums in order) * x's scale, each product and sum
// rounded on its own.
template <typename T>
struct PairAcc {
  T v[2][MK_MAX_B];
};

// A phase's walk over its D rows in pairs: when the K columns fit in one
// chunk the block stages them once and its warps stride over the pairs;
// otherwise the block walks groups of MK_WARPS pairs and re-stages each
// chunk of columns for them. stage(c0, c1) stages columns [c0, c1) (every
// thread calls it), run(acc, r0, r1, c0, c1) adds them into the pair's
// accumulators, finish(p, r0, r1, acc) hands the pair's rows on.
template <typename T, typename Stage, typename Run, typename Finish>
__device__ void walk_pairs(int D, int K, int chunk, int c13, Stage stage, Run run, Finish finish) {
  const int warp = threadIdx.x >> 5;
  const int npairs = c13 > 0 ? D / 2 : (D + 1) / 2;
  if (chunk >= K) {
    stage(0, K);
    for (int p = blockIdx.x * MK_WARPS + warp; p < npairs; p += gridDim.x * MK_WARPS) {
      int r0, r1;
      pair_rows(p, c13, r0, r1);
      PairAcc<T> acc = {};
      run(acc, r0, r1, 0, K);
      finish(p, r0, r1, acc);
    }
    return;
  }
  const int ngroups = (npairs + MK_WARPS - 1) / MK_WARPS;
  for (int g = blockIdx.x; g < ngroups; g += gridDim.x) {
    const int p = g * MK_WARPS + warp;
    int r0 = D, r1 = D;
    if (p < npairs) pair_rows(p, c13, r0, r1);
    PairAcc<T> acc = {};
    for (int c0 = 0; c0 < K; c0 += chunk) {
      const int c1 = c0 + chunk < K ? c0 + chunk : K;
      stage(c0, c1);
      if (p < npairs) run(acc, r0, r1, c0, c1);
    }
    if (p < npairs) finish(p, r0, r1, acc);
  }
}

// bytes of each of a block's first rows of a GEMV phase brought into L2
// before the barrier in front of the phase (prefetch_pairs)
constexpr size_t MK_PF = 2048;

// The first rows of a phase's weights that this block will stream, into
// L2 ahead of the phase (hopper.cuh's xq_prefetch_l2: a hint, no shared
// memory, no barrier): the rows of the pairs walk_pairs deals the block
// first (p = blockIdx.x * MK_WARPS + warp, each warp's first pair), the
// first len bytes of each row (the row where it is shorter); one thread a
// row. The rows D of rowb bytes, c13 as for pair_rows. The q4 body's
// alone: the i8 and a8 bodies ran slower with it on an H100.
// ops/fused_decode.py's prefetch_rows mirrors it.
template <int BODY>
__device__ __forceinline__ void prefetch_pairs(const int8_t* w, int D, size_t rowb, int c13,
                                               size_t len) {
  if constexpr (BODY != BODY_Q4) return;
  const int tid = threadIdx.x;
  const int npairs = c13 > 0 ? D / 2 : (D + 1) / 2;
  const int p = blockIdx.x * MK_WARPS + tid / 2;
  if (tid >= 2 * MK_WARPS || p >= npairs) return;
  int r0, r1;
  pair_rows(p, c13, r0, r1);
  const int r = tid & 1 ? r1 : r0;
  if (r >= D) return;
  xq_prefetch_l2(w + (size_t)r * rowb, (uint32_t)(len < rowb ? len : rowb));
}

// One GEMV phase over the D rows of w and their scales sc: int8 rows of K
// with (D) row scales, or for BODY_Q4 packed rows of K/2 bytes with (D,
// K/group) group scales. The block stages its B activation rows src(b, n)
// (src returns 4 columns at n) into shared memory: as bf16, or for a8/q4
// as int8 codes of the f32 rows, quantised with each row's absmax, which
// the block takes itself (every block stages the whole row, so no grid
// barrier is needed). Each warp dots its row pairs, and lane 0 calls
// epi(p, r0, r1, b, v0, v1) with the two rows' finished values (v1 is
// meaningless when r1 >= D): bf16: sum * scale; a8: f32(sum) * scale *
// x's scale; q4: (group sums in order) * x's scale, each product and sum
// rounded on its own.
template <int MODE, typename Src, typename Epi>
__device__ void gemv_phase(const int8_t* __restrict__ w, const float* __restrict__ sc, int D,
                           int K, int c13, int B, int group, unsigned char* smem, float* red,
                           float* sxs, Src src, Epi epi) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kb = MODE == BODY_Q4 ? K / 2 : K;  // bytes of a weight row
  const int ng = MODE == BODY_Q4 ? K / group : 1;  // scales of a weight row
  const int npg = MODE == BODY_Q4 ? K / 2 / group : 0;
  auto row_ptr = [&](int r) -> const int8_t* { return r < D ? w + (size_t)r * kb : nullptr; };
  auto sc_ptr = [&](int r) -> const float* { return r < D ? sc + (size_t)r * ng : nullptr; };

  if constexpr (MODE != BODY_BF16) {
    // x's row scales: absmax / 127 of each f32 row (1 for an all-zero row)
    for (int b = 0; b < B; ++b) {
      float m = 0.f;
      for (int i = tid; i < K / 4; i += MK_THREADS) {
        const float4 v = src(b, 4 * i);
        m = fmaxf(fmaxf(m, fmaxf(fabsf(v.x), fabsf(v.y))), fmaxf(fabsf(v.z), fabsf(v.w)));
      }
      m = xq_warp_max(m);
      if (lane == 0) red[warp] = m;
      __syncthreads();
      if (tid == 0) {
        float t = 0.f;
        for (int i = 0; i < MK_WARPS; ++i) t = fmaxf(t, red[i]);
        sxs[b] = xq_row_scale(t);
      }
      __syncthreads();
    }
  }
  // stage B rows of columns [c0, c1) of src, 4 at a time, as put(b, o, v)
  // at offset o into the chunk
  auto stage_rows = [&](int c0, int c1, auto put) {
    __syncthreads();  // the previous chunk's readers are done
    const int len4 = (c1 - c0) >> 2;
    for (int i = tid; i < B * len4; i += MK_THREADS) {
      const int b = i / len4, o = (i - b * len4) * 4;
      put(b, o, src(b, c0 + o));
    }
  };
  auto codes = [&](int b, float4 v) {
    const float s = sxs[b];
    return make_char4(xq_code(v.x, s), xq_code(v.y, s), xq_code(v.z, s), xq_code(v.w, s));
  };

  if constexpr (MODE == BODY_BF16) {
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
    const int kc = MK_XS / B / 512 * 512;  // staged columns per row (32 lanes x 16 a step)
    const int ldx = K < kc ? K : kc;
    walk_pairs<float>(
        D, K, kc, c13,
        [&](int c0, int c1) {
          stage_rows(c0, c1, [&](int b, int o, float4 v) {
            const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
            const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
            uint2 packed;
            packed.x = *reinterpret_cast<const unsigned int*>(&lo);
            packed.y = *reinterpret_cast<const unsigned int*>(&hi);
            *reinterpret_cast<uint2*>(xs + (size_t)b * ldx + o) = packed;
          });
          __syncthreads();
        },
        [&](PairAcc<float>& acc, int r0, int r1, int c0, int c1) {
          xq_gemv2<int8_t, MK_MAX_B>(xs, ldx, row_ptr(r0), row_ptr(r1), c0, c1, B, lane, acc.v);
        },
        [&](int p, int r0, int r1, PairAcc<float>& acc) {
#pragma unroll
          for (int b = 0; b < MK_MAX_B; ++b) {
            if (b >= B) break;
            const float s0 = xq_warp_sum(acc.v[0][b]);
            const float s1 = xq_warp_sum(acc.v[1][b]);
            if (lane == 0)
              epi(p, r0, r1, b, __fmul_rn(s0, __ldg(sc + r0)),
                  r1 < D ? __fmul_rn(s1, __ldg(sc + r1)) : 0.f);
          }
        });
  } else if constexpr (MODE == BODY_A8) {
    int8_t* xs = reinterpret_cast<int8_t*>(smem);
    const int kc = MK_SMEM / B / 512 * 512;  // staged codes per row (32 lanes x 16 a step)
    const int ldx = K < kc ? K : kc;
    walk_pairs<int>(
        D, K, kc, c13,
        [&](int c0, int c1) {
          stage_rows(c0, c1, [&](int b, int o, float4 v) {
            *reinterpret_cast<char4*>(xs + (size_t)b * ldx + o) = codes(b, v);
          });
          __syncthreads();
        },
        [&](PairAcc<int>& acc, int r0, int r1, int c0, int c1) {
          xq_gemv2_s8<MK_MAX_B>(xs, ldx, row_ptr(r0), row_ptr(r1), c0, c1, B, lane, acc.v);
        },
        [&](int p, int r0, int r1, PairAcc<int>& acc) {
#pragma unroll
          for (int b = 0; b < MK_MAX_B; ++b) {
            if (b >= B) break;
            const int s0 = __reduce_add_sync(0xffffffffu, acc.v[0][b]);
            const int s1 = __reduce_add_sync(0xffffffffu, acc.v[1][b]);
            if (lane == 0) {
              const float v0 = __fmul_rn(__fmul_rn((float)s0, __ldg(sc + r0)), sxs[b]);
              const float v1 = r1 < D ? __fmul_rn(__fmul_rn((float)s1, __ldg(sc + r1)), sxs[b]) : 0.f;
              epi(p, r0, r1, b, v0, v1);
            }
          }
        });
  } else {
    // q4: the high groups' terms first in shared memory, then the codes of
    // x's columns [p0, p1) and [K/2 + p0, K/2 + p1) for each row; a chunk
    // of packed bytes is whole groups
    float* hterm = reinterpret_cast<float*>(smem) + warp * 2 * MK_MAX_B * npg;
    int8_t* xs = reinterpret_cast<int8_t*>(smem + q4_hterm_bytes(K, group));
    const int kh = K / 2;
    const int pc = (MK_SMEM - q4_hterm_bytes(K, group)) / (2 * B) / group * group;
    const int ldx = 2 * (kh < pc ? kh : pc);  // a row's low and high codes
    walk_pairs<float>(
        D, kh, pc, c13,
        [&](int p0, int p1) {
          for (int half = 0; half < 2; ++half)
            stage_rows(half * kh + p0, half * kh + p1, [&](int b, int o, float4 v) {
              *reinterpret_cast<char4*>(xs + (size_t)b * ldx + half * (ldx / 2) + o) = codes(b, v);
            });
          __syncthreads();
        },
        [&](PairAcc<float>& acc, int r0, int r1, int p0, int p1) {
          xq_gemv2_q4<MK_MAX_B, true>(xs, xs + ldx / 2, ldx, row_ptr(r0), row_ptr(r1), sc_ptr(r0),
                                sc_ptr(r1), p0, p1, group, npg, B, lane, acc.v, hterm);
        },
        [&](int p, int r0, int r1, PairAcc<float>& acc) {
          __syncwarp();  // lane 0 wrote the terms; it alone reads them
          if (lane == 0) {
#pragma unroll
            for (int b = 0; b < MK_MAX_B; ++b) {
              if (b >= B) break;
              const float v0 = __fmul_rn(xq_q4_finish<MK_MAX_B>(acc.v[0][b], hterm, 0, b, npg), sxs[b]);
              const float v1 =
                  r1 < D ? __fmul_rn(xq_q4_finish<MK_MAX_B>(acc.v[1][b], hterm, 1, b, npg), sxs[b]) : 0.f;
              epi(p, r0, r1, b, v0, v1);
            }
          }
          __syncwarp();
        });
  }
}

__device__ __forceinline__ float clip_to(float v, float c) { return fminf(fmaxf(v, -c), c); }

// one element of a float cache, read past L1 (another block may have
// written it in this launch)
__device__ __forceinline__ float cache_ldcg(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ float cache_ldcg(const float* p) { return __ldcg(p); }

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the max (MAX) or the sum of v over the HD threads of one phase-2 item
// (half the block at hd 128, all of it at 256), the same value in each: warp
// shuffles, then named barrier 1 + item (barrier 0 is __syncthreads), so
// the block's other item need not take part; red holds HD / 32 floats
template <bool MAX, int HD>
__device__ float item_reduce(float v, float* red, int item) {
  constexpr int NW = HD / 32;
  const int lane = threadIdx.x & 31, w = (threadIdx.x & (HD - 1)) >> 5;
  const float m = MAX ? xq_warp_max(v) : xq_warp_sum(v);
  asm volatile("bar.sync %0, %1;" ::"r"(item + 1), "n"(HD) : "memory");  // red is free
  if (lane == 0) red[w] = m;
  asm volatile("bar.sync %0, %1;" ::"r"(item + 1), "n"(HD) : "memory");
  float t = red[0];
#pragma unroll
  for (int k = 1; k < NW; ++k) t = MAX ? fmaxf(t, red[k]) : t + red[k];
  return t;
}

template <int HD>
__device__ float item_absmax(float v, float* red, int item) {
  return item_reduce<true, HD>(fabsf(v), red, item);
}

// x + p * r * w, each product and the sum rounded on its own, so that the
// phase that reads it and the phase that stores it agree bit for bit
__device__ __forceinline__ float post_add(float x, float p, float r, float w) {
  return __fadd_rn(x, __fmul_rn(__fmul_rn(p, r), w));
}

// the tanh softcap c * tanh(v / c) (c == 0: none)
__device__ __forceinline__ float softcap(float v, float c) {
  return c != 0.f ? tanhf(v * (1.0f / c)) * c : v;
}

// tanh-approximate gelu: 0.5 g (1 + tanh(sqrt(2 / pi) (g + 0.044715 g^3)))
__device__ __forceinline__ float gelu_tanh(float g) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * g * (1.0f + tanhf(k * (g + 0.044715f * g * g * g)));
}

// The cache kinds, as the wrapper passes them: bf16, int8 codes with row
// scales, f32
enum CacheKind { CK_BF16 = 1, CK_I8 = 2, CK_F32 = 3 };

// a float cache's element type (the int8 kind's codes are signed char)
template <int CK>
using cache_t = typename std::conditional<CK == CK_F32, float, __nv_bfloat16>::type;

// the dots of one key row's half (HH dims, at half * HH) with the G query
// heads of qs (G, 2 * HH): f32 sums of bf16 or f32 values, or of int8 codes
// times bf16 q, every load of the half row in flight
template <int CK, int HH>
__device__ __forceinline__ void score_row(const void* krow, const float* qs, int half, int G,
                                          float (&s)[MK_MAX_G]) {
  constexpr int PER = CK == CK_I8 ? 16 : CK == CK_F32 ? 4 : 8;  // values a 16-byte load holds
  const int4* kr = reinterpret_cast<const int4*>(krow) + half * (HH / PER);
#pragma unroll
  for (int cc = 0; cc < HH / PER; ++cc) {
    const int4 raw = __ldcg(kr + cc);
    float kf[PER];
    if constexpr (CK == CK_I8) {
      const signed char* kp = reinterpret_cast<const signed char*>(&raw);
#pragma unroll
      for (int e = 0; e < PER; ++e) kf[e] = (float)kp[e];
    } else {
      const cache_t<CK>* kp = reinterpret_cast<const cache_t<CK>*>(&raw);
#pragma unroll
      for (int e = 0; e < PER; ++e) kf[e] = xq_from_cache(kp[e]);
    }
#pragma unroll
    for (int g = 0; g < MK_MAX_G; ++g) {
      if (g >= G) break;
      const float* qg = qs + g * 2 * HH + half * HH + cc * PER;
#pragma unroll
      for (int e = 0; e < PER; ++e) s[g] += qg[e] * kf[e];
    }
  }
}

template <int CK, int BODY, int HD, bool FAM>
__global__ void __launch_bounds__(MK_THREADS, 2) fused_decode_kernel(const MkArgs a) {
  constexpr bool QUANT = CK == CK_I8;
  using CT = cache_t<CK>;  // a float cache's element
  constexpr int HEAD = BODY == BODY_BF16 ? BODY_BF16 : BODY_A8;  // the i8 head's body
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[MK_WARPS];
  __shared__ float sxs[MK_MAX_B];  // x's row scales of the current a8/q4 phase
  constexpr int hd = HD;
  constexpr int ipb = MK_THREADS / HD;  // phase-2 and phase-4 items a block: 2 at hd 128, 1 at 256
  __shared__ float hred[ipb][HD / 32];
  __shared__ float rinv[MK_MAX_B];
  __shared__ float prinv[MK_MAX_B];  // 1/rms of the post-norm projection rows
  __shared__ float best_v[MK_WARPS][MK_MAX_B];
  __shared__ int best_i[MK_WARPS][MK_MAX_B];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = a.B, N = a.N, KH = a.KH, G = a.G, H = a.H, S = a.S;
  const int HQ = KH * G, QD = HQ * hd, DQ = KH * (G + 2) * hd, H2 = 2 * H;
  const int NS = (S + MK_CHUNK - 1) / MK_CHUNK;
  const int gq = a.group;  // q4 group (0: int8 rows)
  const bool pn = FAM && a.post_attn_norm != nullptr;
  // bytes of a weight row and scales of a row, by contraction width K
  auto rowb = [&](int K) { return (size_t)(BODY == BODY_Q4 ? K / 2 : K); };
  auto rows = [&](int K) { return (size_t)(BODY == BODY_Q4 ? K / gq : 1); };
  const WsLayout ws = ws_layout(B, N, KH, G, S, H, hd);
  unsigned int* bar = reinterpret_cast<unsigned int*>(a.work);
  float* x = reinterpret_cast<float*>(a.work + ws.x);
  float* qkv = reinterpret_cast<float*>(a.work + ws.qkv);
  float* qr = reinterpret_cast<float*>(a.work + ws.q);
  float* pm = reinterpret_cast<float*>(a.work + ws.pm);
  float* pl = reinterpret_cast<float*>(a.work + ws.pl);
  float* pacc = reinterpret_cast<float*>(a.work + ws.pacc);
  float* attn = reinterpret_cast<float*>(a.work + ws.attn);
  float* act = reinterpret_cast<float*>(a.work + ws.act);
  float* pa = reinterpret_cast<float*>(a.work + ws.pa);
  float* pd = reinterpret_cast<float*>(a.work + ws.pd);
  float* amv = reinterpret_cast<float*>(a.work + ws.amv);
  int* ami = reinterpret_cast<int*>(a.work + ws.ami);
  const int* kv_pos = a.meta;
  const int* kv_len = a.meta + B;
  const int* rotate = a.meta + 2 * B;
  const int* token = a.meta + 3 * B;
  const int* pos = a.meta + 4 * B;

  // ---- phase 0: the residual x from x0 or the embed rows (times the embed scale)
  for (int i = blockIdx.x * MK_THREADS + tid; i < B * N; i += gridDim.x * MK_THREADS) {
    const int b = i / N, n = i - b * N;
    __stcg(x + i, a.embed != nullptr
                      ? __bfloat162float(a.embed[(size_t)__ldg(token + b) * N + n]) *
                            (FAM ? a.embed_scale : 1.f)
                      : __ldg(a.x0 + i));
  }
  prefetch_pairs<BODY>(a.wqkv, DQ, rowb(N), 0, MK_PF);
  grid_sync(bar);

  const float* rv = rinv;  // captured as pointers: the values are per phase
  const float* prv = prinv;
  auto plain = [](const float* src, int ld) {
    return [=](int b, int n) {
      return __ldcg(reinterpret_cast<const float4*>(src + (size_t)b * ld + n));
    };
  };
  // x with a pending projection pp added, normed (w: its norm weights,
  // prinv its rows' 1/rms), or x itself (w null)
  auto resid = [=](const float* pp, const float* w) {
    return [=](int b, int n) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(x + (size_t)b * N + n));
      if (!FAM || w == nullptr) return v;
      const float4 p = __ldcg(reinterpret_cast<const float4*>(pp + (size_t)b * N + n));
      const float4 g = __ldg(reinterpret_cast<const float4*>(w + n));
      const float r = prv[b];
      return make_float4(post_add(v.x, p.x, r, g.x), post_add(v.y, p.y, r, g.y),
                         post_add(v.z, p.z, r, g.z), post_add(v.w, p.w, r, g.w));
    };
  };
  // the normed row rinv * src * nw (src as for rows_rms)
  auto normed = [=](auto src, const float* nw) {
    return [=](int b, int n) {
      const float4 v = src(b, n);
      const float4 g = __ldg(reinterpret_cast<const float4*>(nw + n));
      const float r = rv[b];
      return make_float4(v.x * r * g.x, v.y * r * g.y, v.z * r * g.z, v.w * r * g.w);
    };
  };
  // post-norms: the 1/rms of the rows of a pending projection pp into prinv
  auto pending_rms = [&](const float* pp) { rows_rms(plain(pp, N), B, N, a.eps, prinv, red); };
  // post-norms: store x + the pending projection pp normed with w, a
  // grid-stride slice per block (to out: x itself, or xout)
  auto settle = [&](const float* pp, const float* w, float* out) {
    for (int i = blockIdx.x * MK_THREADS + tid; i < B * N; i += gridDim.x * MK_THREADS) {
      const int b = i / N, n = i - b * N;
      __stcg(out + i, post_add(__ldcg(x + i), __ldcg(pp + i), prinv[b], __ldg(w + n)));
    }
  };

  CT* const ckf = static_cast<CT*>(a.ck);
  CT* const cvf = static_cast<CT*>(a.cv);
  signed char* const ckq = static_cast<signed char*>(a.ck);
  signed char* const cvq = static_cast<signed char*>(a.cv);

  for (int l = 0; l < a.L; ++l) {
    const size_t lsc = (size_t)l * B * KH * S;  // this layer's scale plane (x hd: its cache plane)
    // the previous layer's post-ffn projection, still pending in pd
    const float* pmn = pn && l > 0 ? a.post_mlp_norm + (size_t)(l - 1) * N : nullptr;
    // ---- phase 1: rmsnorm + wqkv (+ the qkv bias)
    if (pmn != nullptr) pending_rms(pd);
    rows_rms(resid(pd, pmn), B, N, a.eps, rinv, red);
    const float* bias = a.bqkv != nullptr ? a.bqkv + (size_t)l * DQ : nullptr;
    auto put_qkv = [&](int b, int r, float v) {
      __stcg(qkv + (size_t)b * DQ + r, bias != nullptr ? __fadd_rn(v, __ldg(bias + r)) : v);
    };
    gemv_phase<BODY>(a.wqkv + l * DQ * rowb(N), a.sqkv + l * DQ * rows(N), DQ, N, 0, B, gq, smem,
                     red, sxs, normed(resid(pd, pmn), a.attn_norm + (size_t)l * N),
                     [&](int, int r0, int r1, int b, float v0, float v1) {
                       put_qkv(b, r0, v0);
                       if (r1 < DQ) put_qkv(b, r1, v1);
                     });
    grid_sync(bar);

    // ---- phase 2: clip, q/k norm, rope, ring insert, sink rotation; one
    // (row, kv head) item per hd threads. Post-norms: x takes the pending
    // projection (nothing reads x in this phase). Phases 2-4 read no
    // weights: the block's first wo rows go to L2 meanwhile, whole
    prefetch_pairs<BODY>(a.wo + l * N * rowb(QD), N, rowb(QD), 0, rowb(QD));
    if (pmn != nullptr) settle(pd, pmn, x);
    const float* qn = a.q_norm != nullptr ? a.q_norm + (size_t)l * hd : nullptr;
    const float* kn = a.k_norm != nullptr ? a.k_norm + (size_t)l * hd : nullptr;
    for (int it = blockIdx.x * ipb + tid / hd; it < B * KH; it += gridDim.x * ipb) {
      const int b = it / KH, j = it - b * KH, i = tid & (hd - 1), item = tid / hd;
      float* hr = hred[item];
      float c, s;
      if (a.freqs != nullptr) {
        const float ang = (float)__ldg(pos + b) * __ldg(a.freqs + (i >> 1));
        sincosf(ang, &s, &c);
      } else {
        c = __ldg(a.cexp_p + b * hd + i);
        s = __ldg(a.sexp_p + b * hd + i);
      }
      const float* y = qkv + (size_t)b * DQ + (size_t)j * (G + 2) * hd;
      // lane i of a head: clipped, RMS-normed over the head's hd lanes with
      // the weights w (Qwen3; none when w is null), then rotated with its
      // pair partner, the neighbouring lane of the same warp
      auto rope = [&](const float* v, const float* w) {
        float u = clip_to(__ldcg(v + i), a.clip);
        if (w != nullptr) {
          const float ms = item_reduce<false, HD>(u * u, hr, item) / (float)hd;
          u = u * (1.0f / sqrtf(ms + a.eps)) * __ldg(w + i);
        }
        const float p = __shfl_xor_sync(0xffffffffu, u, 1);
        return u * c + ((i & 1) ? p : -p) * s;
      };
      for (int g = 0; g < G; ++g) {
        const float qv = rope(y + g * hd, qn);
        __stcg(qr + ((size_t)b * HQ + j * G + g) * hd + i, QUANT ? qv : qv * a.sm_scale);
      }
      const float kr = rope(y + G * hd, kn);
      const float vr = clip_to(__ldcg(y + (G + 1) * hd + i), a.clip);
      const size_t srow = lsc + ((size_t)b * KH + j) * S;  // scale index of the stripe's row 0
      const size_t stripe = srow * hd;
      const int kvp = __ldg(kv_pos + b);
      if constexpr (QUANT) {
        const float ksc = xq_row_scale(item_absmax<HD>(kr, hr, item));
        const float vsc = xq_row_scale(item_absmax<HD>(vr, hr, item));
        if (kvp >= 0 && kvp < S) {
          ckq[stripe + (size_t)kvp * hd + i] = xq_code(kr, ksc);
          cvq[stripe + (size_t)kvp * hd + i] = xq_code(vr, vsc);
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
            const signed char* row = ckq + stripe + (size_t)r * hd;
            v[r] = __fmul_rn((float)__ldcg(row + i), sc);
            const float p = __fmul_rn((float)__ldcg(row + (i ^ 1)), sc);
            sw[r] = (i & 1) ? p : -p;
          }
          const float c1 = __ldg(a.c1 + i), s1 = __ldg(a.s1 + i);
#pragma unroll
          for (int r = 0; r < KV_SINKS; ++r) {
            const float rot = __fadd_rn(__fmul_rn(v[r], c1), __fmul_rn(sw[r], s1));
            const float sc = xq_row_scale(item_absmax<HD>(rot, hr, item));
            ckq[stripe + (size_t)r * hd + i] = xq_code(rot, sc);
            if (i == 0) __stcg(a.ks + srow + r, sc);
          }
        }
        continue;
      }
      // a float cache: the rows and the rotated sinks rounded to bf16, or
      // stored as they are in an f32 cache
      if (kvp >= 0 && kvp < S) {
        ckf[stripe + (size_t)kvp * hd + i] = xq_to_cache<CT>(kr);
        cvf[stripe + (size_t)kvp * hd + i] = xq_to_cache<CT>(vr);
      }
      if (__ldg(rotate + b) != 0) {  // uniform over the item's warps
        float v[KV_SINKS], sw[KV_SINKS];
#pragma unroll
        for (int r = 0; r < KV_SINKS; ++r) {
          const CT* row = ckf + stripe + (size_t)r * hd;
          v[r] = cache_ldcg(row + i);
          const float p = cache_ldcg(row + (i ^ 1));
          sw[r] = (i & 1) ? p : -p;
        }
        __syncwarp();  // the lane pair (i, i ^ 1) shares a warp: reads before writes
        const float c1 = __ldg(a.c1 + i), s1 = __ldg(a.s1 + i);
#pragma unroll
        for (int r = 0; r < KV_SINKS; ++r)
          ckf[stripe + (size_t)r * hd + i] =
              xq_to_cache<CT>(__fadd_rn(__fmul_rn(v[r], c1), __fmul_rn(sw[r], s1)));
      }
    }
    grid_sync(bar);

    // ---- phase 3: split flash-decode, one (row, kv head, chunk) item per block
    {
      float* qs = reinterpret_cast<float*>(smem);   // (G, hd)
      float* sc = qs + MK_MAX_G * MK_MAX_HD;         // (G, chunk) scores, then p
      float* accs = sc + MK_MAX_G * MK_CHUNK;        // (warps, G, MK_SLICE) partial P.V
      float* ml = accs + MK_WARPS * MK_MAX_G * MK_SLICE;  // (G) max, (G) sum
      for (int it = blockIdx.x; it < B * KH * NS; it += gridDim.x) {
        const int b = it / (KH * NS), j = (it / NS) % KH, ch = it % NS;
        const int r0 = ch * MK_CHUNK;
        const int n = min(MK_CHUNK, __ldg(kv_len + b) - r0);
        if (n <= 0) continue;  // uniform over the block
        const size_t srow = lsc + ((size_t)b * KH + j) * S + r0;  // scale index of the chunk's row 0
        const size_t stripe = (lsc + ((size_t)b * KH + j) * S) * hd;
        __syncthreads();  // the previous item's scratch is consumed
        for (int e = tid; e < G * hd; e += MK_THREADS) {
          const float qv = __ldcg(qr + ((size_t)b * HQ + j * G) * hd + e);
          qs[e] = QUANT ? bf16_round(qv) : qv;
        }
        __syncthreads();
        // scores: two threads per key row, hd / 2 dims each, f32 dots (int8:
        // exact bf16 x code products, then times k_scale / sqrt(hd)), then
        // the softcap
        {
          const int row = tid >> 1, half = tid & 1;
          float s[MK_MAX_G];
#pragma unroll
          for (int g = 0; g < MK_MAX_G; ++g) s[g] = 0.f;
          if (row < n) {
            const size_t at = stripe + (size_t)(r0 + row) * hd;
            const void* krow = QUANT ? (const void*)(ckq + at) : (const void*)(ckf + at);
            score_row<CK, HD / 2>(krow, qs, half, G, s);
          }
          const float f = QUANT && row < n ? __fmul_rn(__ldcg(a.ks + srow + row), a.sm_scale) : 1.f;
#pragma unroll
          for (int g = 0; g < MK_MAX_G; ++g) {
            if (g >= G) break;
            s[g] += __shfl_xor_sync(0xffffffffu, s[g], 1);
            if (row < n && half == 0)
              sc[g * MK_CHUNK + row] = FAM ? softcap(QUANT ? s[g] * f : s[g], a.attn_softcap)
                                           : QUANT ? s[g] * f : s[g];
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
        // un-normalised P.V over 128-dim slices of the rows: warp w takes
        // rows w, w + 8, ..., a lane 4 dims of the slice
#pragma unroll
        for (int d0 = 0; d0 < HD; d0 += MK_SLICE) {
          __syncthreads();  // p is in place; the previous slice's partials are consumed
          float acc[MK_MAX_G][4];
#pragma unroll
          for (int g = 0; g < MK_MAX_G; ++g)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
          for (int r = warp; r < n; r += MK_WARPS) {
            float vf[4];
            const size_t at = stripe + (size_t)(r0 + r) * hd + d0 + lane * 4;
            if constexpr (QUANT) {
              const int raw = __ldcg(reinterpret_cast<const int*>(cvq + at));
              const signed char* vp = reinterpret_cast<const signed char*>(&raw);
#pragma unroll
              for (int e = 0; e < 4; ++e) vf[e] = (float)vp[e];
            } else if constexpr (CK == CK_F32) {
              const float4 raw = __ldcg(reinterpret_cast<const float4*>(cvf + at));
              vf[0] = raw.x;
              vf[1] = raw.y;
              vf[2] = raw.z;
              vf[3] = raw.w;
            } else {
              const uint2 raw = __ldcg(reinterpret_cast<const uint2*>(cvf + at));
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
            for (int e = 0; e < 4; ++e)
              accs[(warp * MK_MAX_G + g) * MK_SLICE + lane * 4 + e] = acc[g][e];
          }
          __syncthreads();
          for (int e = tid; e < G * MK_SLICE; e += MK_THREADS) {
            const int g = e / MK_SLICE, d = e - g * MK_SLICE;
            float t = 0.f;
            for (int w = 0; w < MK_WARPS; ++w) t += accs[(w * MK_MAX_G + g) * MK_SLICE + d];
            const size_t part = ((size_t)b * HQ + j * G + g) * NS + ch;
            __stcg(pacc + part * hd + d0 + d, t);
            if (d0 == 0 && d == 0) {
              __stcg(pm + part, ml[g]);
              __stcg(pl + part, ml[MK_MAX_G + g]);
            }
          }
        }
      }
    }
    grid_sync(bar);

    // ---- phase 4: combine the chunk partials, one (row, head) item per hd threads
    for (int it = blockIdx.x * ipb + tid / hd; it < B * HQ; it += gridDim.x * ipb) {
      const int b = it / HQ, d = tid & (hd - 1);
      const int kvl = __ldg(kv_len + b);
      const int nsb = kvl <= 0 ? 0 : min(NS, (kvl + MK_CHUNK - 1) / MK_CHUNK);
      const size_t p0 = (size_t)it * NS;  // it == b * HQ + head
      float mx = -INFINITY;
      for (int s = 0; s < nsb; ++s) mx = fmaxf(mx, __ldcg(pm + p0 + s));
      float l = 0.f, acc = 0.f;
      for (int s = 0; s < nsb; ++s) {
        const float w = expf(__ldcg(pm + p0 + s) - mx);
        l += w * __ldcg(pl + p0 + s);
        acc += w * __ldcg(pacc + (p0 + s) * hd + d);
      }
      __stcg(attn + (size_t)it * hd + d, l > 0.f ? acc / l : 0.f);
    }
    grid_sync(bar);

    // ---- phase 5: wo + residual (post-norms: the projection into pa)
    gemv_phase<BODY>(a.wo + l * N * rowb(QD), a.so + l * N * rows(QD), N, QD, 0, B, gq, smem, red,
                     sxs, plain(attn, QD), [&](int, int r0, int r1, int b, float v0, float v1) {
                       float* xr = (pn ? pa : x) + (size_t)b * N;
                       __stcg(xr + r0, pn ? v0 : __ldcg(xr + r0) + v0);
                       if (r1 < N) __stcg(xr + r1, pn ? v1 : __ldcg(xr + r1) + v1);
                     });
    prefetch_pairs<BODY>(a.w13 + l * H2 * rowb(N), H2, rowb(N), a.c13, MK_PF);
    grid_sync(bar);

    // ---- phase 6: rmsnorm + w13, SiLU(gate) * up (or gelu); post-norms:
    // over x plus the normed attention projection
    const float* pan = pn ? a.post_attn_norm + (size_t)l * N : nullptr;
    if (pan != nullptr) pending_rms(pa);
    rows_rms(resid(pa, pan), B, N, a.eps, rinv, red);
    gemv_phase<BODY>(a.w13 + l * H2 * rowb(N), a.s13 + l * H2 * rows(N), H2, N, a.c13, B, gq, smem,
                     red, sxs, normed(resid(pa, pan), a.mlp_norm + (size_t)l * N),
                     [&](int p, int, int, int b, float gt, float up) {
                       __stcg(act + (size_t)b * H + p,
                              (FAM && a.gelu ? gelu_tanh(gt) : gt / (1.0f + expf(-gt))) * up);
                     });
    prefetch_pairs<BODY>(a.w2 + l * N * rowb(H), N, rowb(H), 0, MK_PF);
    grid_sync(bar);

    // ---- phase 7: w2 + residual (and the output rows after the last
    // layer); post-norms: x takes the pending attention projection first
    // (nothing reads x in this phase), the w2 output goes to pd
    if (pan != nullptr) settle(pa, pan, x);
    {
      float* xo = l == a.L - 1 && !pn ? a.xout : nullptr;
      gemv_phase<BODY>(a.w2 + l * N * rowb(H), a.s2 + l * N * rows(H), N, H, 0, B, gq, smem, red,
                       sxs, plain(act, H), [&](int, int r0, int r1, int b, float v0, float v1) {
                         float* xr = (pn ? pd : x) + (size_t)b * N;
                         const float x0 = pn ? v0 : __ldcg(xr + r0) + v0;
                         __stcg(xr + r0, x0);
                         if (xo != nullptr) xo[(size_t)b * N + r0] = x0;
                         if (r1 < N) {
                           const float x1 = pn ? v1 : __ldcg(xr + r1) + v1;
                           __stcg(xr + r1, x1);
                           if (xo != nullptr) xo[(size_t)b * N + r1] = x1;
                         }
                       });
    }
    if (l + 1 < a.L) prefetch_pairs<BODY>(a.wqkv + (l + 1) * DQ * rowb(N), DQ, rowb(N), 0, MK_PF);
    else if (a.wcls != nullptr) prefetch_pairs<BODY>(a.wcls, a.V, N, 0, MK_PF);
    grid_sync(bar);
  }

  // post-norms: the last layer's ffn projection is still pending in pd
  const float* plast = pn ? a.post_mlp_norm + (size_t)(a.L - 1) * N : nullptr;
  if (plast != nullptr) {
    pending_rms(pd);
    settle(pd, plast, a.xout);
  }
  if (a.wcls == nullptr) return;

  // ---- head fold: final norm, i8 head, logits (softcapped) and a
  // first-occurrence argmax
  float bv[MK_MAX_B];
  int bi[MK_MAX_B];
#pragma unroll
  for (int b = 0; b < MK_MAX_B; ++b) {
    bv[b] = -INFINITY;
    bi[b] = 0x7fffffff;
  }
  rows_rms(resid(pd, plast), B, N, a.eps, rinv, red);
  gemv_phase<HEAD>(a.wcls, a.swcls, a.V, N, 0, B, 0, smem, red, sxs,
                   normed(resid(pd, plast), a.out_norm),
                   [&](int, int r0, int r1, int b, float v0, float v1) {
                     if (FAM) v0 = softcap(v0, a.logit_softcap);
                     a.logits[(size_t)b * a.V + r0] = v0;
                     if (v0 > bv[b] || (v0 == bv[b] && r0 < bi[b])) {
                       bv[b] = v0;
                       bi[b] = r0;
                     }
                     if (r1 < a.V) {
                       if (FAM) v1 = softcap(v1, a.logit_softcap);
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

#ifndef XQ_MK_F32_CACHE
__global__ void __launch_bounds__(MK_THREADS, 2) grid_barrier_kernel(unsigned int* bar, int iters) {
  for (int i = 0; i < iters; ++i) grid_sync(bar);
}
#endif

// blocks of MK_THREADS threads with MK_SMEM bytes that fit on one SM, per
// device (0: none), and the device's SM count
struct Occupancy {
  int blocks_per_sm = -1, sms = 0;
};

// the cooperative grid of fused_decode_kernel<CK, BODY, HD, FAM> on the
// current device: the co-resident blocks, found once per device and
// instantiation
template <int CK, int BODY, int HD, bool FAM>
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
    e = cudaFuncSetAttribute(fused_decode_kernel<CK, BODY, HD, FAM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MK_SMEM);
    if (e != cudaSuccess) return e;
    int n = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fused_decode_kernel<CK, BODY, HD, FAM>, MK_THREADS,
                                                      MK_SMEM);
    if (e != cudaSuccess) return e;
    occ.blocks_per_sm = coop ? n : 0;
  }
  if (occ.blocks_per_sm < 1) return cudaErrorInvalidValue;  // no co-resident grid
  *grid = occ.blocks_per_sm * occ.sms;
  if (*grid > MK_MAX_GRID) *grid = MK_MAX_GRID;
  return cudaSuccess;
}

// the cache kinds this library's instantiations take: fused_decode_f32.cu
// builds this source again with XQ_MK_F32_CACHE for the f32 kind, so that
// nvcc compiles those nine instantiations beside the other eighteen
bool this_library_kind(int kind) {
#ifdef XQ_MK_F32_CACHE
  return kind == CK_F32;
#else
  return kind == CK_BF16 || kind == CK_I8;
#endif
}

}  // namespace

// bytes of the workspace: the barrier word (zeroed once by the caller and
// left balanced by every complete launch) and the cross-phase buffers
XQ_EXPORT long long xq_fused_decode_workspace(int B, int N, int KH, int G, int S, int H, int hd) {
  return (long long)ws_layout(B, N, KH, G, S, H, hd).total;
}

#ifndef XQ_MK_F32_CACHE
// blocks in the cooperative grid of the bf16-cache kernel on the current
// device (<= 0: none fit)
XQ_EXPORT int xq_fused_decode_grid() {
  int grid = 0;
  return grid_of<CK_BF16, BODY_BF16, 128, false>(&grid) == cudaSuccess ? grid : 0;
}
#endif

// ptr: meta, x0, cexp_p, sexp_p, c1, s1, freqs, embed, attn_norm, mlp_norm,
//      wqkv, sqkv, wo, so, w13, s13, w2, s2, out_norm, wcls, swcls, ck, cv,
//      xout, logits, token, work, k_scale, v_scale, bqkv, q_norm, k_norm,
//      post_attn_norm, post_mlp_norm (null where a fold is off; the scale
//      planes with an int8 cache only)
// dim: L, B, N, KH, G, hd, H, S, V, c13, cache kind (1 bf16, 2 int8, 3 f32;
//      each library takes its own, this_library_kind),
//      body (0 bf16 activations, 1 a8, 2 q4), q4 group (0 unless q4),
//      act (0 SiLU, 1 tanh-approximate gelu)
// embed_scale multiplies the embed fold's rows; the softcaps are 0 when off
XQ_EXPORT int xq_fused_decode(void* const* ptr, const int* dim, float eps, float clip,
                              float sm_scale, float embed_scale, float attn_softcap,
                              float logit_softcap, void* stream) {
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
  a.bqkv = (const float*)ptr[29];
  a.q_norm = (const float*)ptr[30];
  a.k_norm = (const float*)ptr[31];
  a.post_attn_norm = (const float*)ptr[32];
  a.post_mlp_norm = (const float*)ptr[33];
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
  const bool quant = cache_kind == CK_I8;
  const int body = dim[11];
  a.group = dim[12];
  a.gelu = dim[13];
  a.eps = eps;
  a.clip = clip;
  a.sm_scale = sm_scale;
  a.embed_scale = embed_scale;
  a.attn_softcap = attn_softcap;
  a.logit_softcap = logit_softcap;
  const bool embed_fold = a.embed != nullptr, head_fold = a.wcls != nullptr;
  const bool ok = (hd == 128 || hd == 256) && this_library_kind(cache_kind) &&
                  (!quant || (a.ks && a.vs)) &&
                  a.L >= 1 && a.B >= 1 && a.B <= MK_MAX_B &&
                  a.KH >= 1 && a.G >= 1 && a.G <= MK_MAX_G && a.N >= 16 && a.N % 16 == 0 &&
                  a.H >= 16 && a.H % 16 == 0 && a.c13 >= 1 && a.H % a.c13 == 0 && a.S >= 1 &&
                  (embed_fold ? a.freqs != nullptr : (a.x0 && a.cexp_p && a.sexp_p)) &&
                  (!head_fold || (a.V >= 1 && a.out_norm && a.swcls && a.logits && a.token)) &&
                  a.work != nullptr && body >= BODY_BF16 && body <= BODY_Q4 &&
                  (a.q_norm == nullptr) == (a.k_norm == nullptr) &&
                  (a.post_attn_norm == nullptr) == (a.post_mlp_norm == nullptr) &&
                  (a.gelu == 0 || a.gelu == 1) && attn_softcap >= 0.f && logit_softcap >= 0.f;
  if (!ok) return (int)cudaErrorInvalidValue;
  if (body == BODY_Q4) {
    // packed rows of every contraction width, and each phase's high-group
    // terms plus one group of codes per row in the block's shared memory
    const int g = a.group, QD = a.KH * a.G * hd;
    if (g < 128 || g % 128 != 0) return (int)cudaErrorInvalidValue;
    const int widths[3] = {a.N, QD, a.H};
    for (int K : widths)
      if (K % (2 * g) != 0 || q4_hterm_bytes(K, g) + 2 * a.B * g > MK_SMEM)
        return (int)cudaErrorInvalidValue;
  } else if (a.group != 0) {
    return (int)cudaErrorInvalidValue;
  }
  int grid = 0;
  cudaError_t e;
  const void* kernel;
  // the Gemma folds' instantiation: at hd 256 always (only Gemma models
  // have it), at hd 128 when one of them is on
  const bool fam = hd == 256 || a.gelu || embed_scale != 1.f || attn_softcap != 0.f ||
                   logit_softcap != 0.f || a.post_attn_norm != nullptr;
#define XQ_BODY(CK, BD, HD, F)                          \
  e = grid_of<CK, BD, HD, F>(&grid);                    \
  kernel = (const void*)fused_decode_kernel<CK, BD, HD, F>;
#define XQ_HD(CK, BD)                                   \
  if (hd == 256) { XQ_BODY(CK, BD, 256, true) }         \
  else if (fam) { XQ_BODY(CK, BD, 128, true) }          \
  else { XQ_BODY(CK, BD, 128, false) }
#define XQ_CK(CK)                                       \
  if (body == BODY_Q4) { XQ_HD(CK, BODY_Q4) }           \
  else if (body == BODY_A8) { XQ_HD(CK, BODY_A8) }      \
  else { XQ_HD(CK, BODY_BF16) }
#ifdef XQ_MK_F32_CACHE
  XQ_CK(CK_F32)
#else
  if (quant) { XQ_CK(CK_I8) }
  else { XQ_CK(CK_BF16) }
#endif
#undef XQ_CK
#undef XQ_HD
#undef XQ_BODY
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(MK_THREADS), args, MK_SMEM,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller raises
    return (int)e;
  }
  return (int)cudaGetLastError();
}

#ifndef XQ_MK_F32_CACHE
// `iters` grid barriers alone, on the megakernel's grid: the cost of one
// barrier is the event time over iters (chip_smoke.py)
XQ_EXPORT int xq_grid_barrier_bench(void* work, int iters, void* stream) {
  int grid = 0;
  cudaError_t e = grid_of<CK_BF16, BODY_BF16, 128, false>(&grid);
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
#endif
