// Stacked dequant matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel xalm_tpu/ops/pallas_matmul.py::_kernel (through
// pallas_qmatmul_stacked / pallas_qmatmul), i8, bf16, f32 and fp8 weights:
//
//     y[m, d] = epi[d] * sum_n cd(rmsnorm?(x)[m, n]) * W[d, n]
//
// x is f32 (M, N); W is one layer of the stacked (L, D, N) weights, int8,
// bf16, f32 or fp8 (e4m3, e5m2: the TPU kernel's _f8_to_bf16 branch; the
// caller offsets the pointer by the layer); epi is the i8
// per-row f32 scale, the q8 fixed 1/100, or 1. As in the TPU kernel, x is
// cast to the compute dtype cd *after* the optional rmsnorm prologue: bf16
// for int8, fp8 and bf16 weights (each fp8 code widened exactly, gemv.cuh;
// exact in bf16; products of two bf16 values are
// exact in f32, summed in f32; the scale multiplies the f32 result), f32 for
// f32 weights (no bf16 rounding: the GEMV multiplies in f32 FMA on the CUDA
// cores, the tiled GEMM in split TF32 on the tensor cores, three TF32
// products a step, each within about 2^-18 of the f32 product where one
// TF32 product, three digits, would be 2^-9 off; against f64 its rows land
// within 1.1-1.7e-6 of their max on an H100, cuBLAS f32's within 2.0-4.2e-6:
// hopper.cuh).
//
// What bounds it on the H100:
// - Decode (M <= 8): bytes. Each weight byte is used M times, far below the
//   ~295 operations per byte where the tensor cores would become the limit,
//   so the time is the weight stream over 3.35 TB/s, and what keeps a
//   kernel from it is bytes in flight (Little's law: ~25 KB an SM at a
//   microsecond of latency). Design for bf16 and f32 weights
//   (gemv_stream_kernel): one block an SM, the D rows dealt evenly (w2's
//   4096 rows 31 or 32 a block) and within the block each warp a
//   contiguous run of them (3 or 4), streamed through a ring of its own:
//   two stages of 8 KB (128 KB a block in flight), each one 1-D bulk copy
//   (hopper.cuh, an mbarrier a stage) of whole rows where they fit (a bf16
//   row of 4096 is 8 KB: one a stage; an i8 one 4 KB: two) or a segment of
//   a longer one (an f32 w2 row of 57 KB: seven). Each lane of the warp
//   takes 16-byte words of the landed stage (gemv.cuh's xq_gemv_word
//   against x in shared memory); at a row's end the warp's shuffle sum,
//   times the scale, is the output; the warp refills the stage itself. No
//   warp waits for another after the prologue (the rmsnorm and x's staging,
//   once a block, under the first copies): a ring shared by the warps, each
//   stage read by all eight and refilled by the last, was consumer-bound
//   (its waits and releases a stage cost more than its copy), and copies of
//   1 KB do not reach the byte rate (chip_smoke.py --kernel-ms, the
//   bulk_copy line). int8 and fp8 rows keep gemv_kernel (gemv.cuh's
//   xq_gemv2: one warp a row pair streaming from global, x staged a 16-row
//   block; on the streamed kernel int8 ran 1.6-1.8x slower, its widening
//   on the critical path of each stage: chip_smoke.py --kernel-ms), 16
//   codes a 16-byte load; the widening (8 cvt instructions a load) stays
//   under the byte rate.
// - Prefill (M up to 512): operations at M >= ~300, bytes below. Design: a
//   first pass writes bf16(rmsnorm?(x)) once (one block per row); then a
//   64x64-output-tile GEMM on bf16 WMMA (mma.sync) tensor-core fragments,
//   int8 weight tiles widened to bf16 in shared memory. Simple and right
//   first: no TMA, no wgmma, no multi-stage pipeline yet.
// - f32 weights: the GEMV route stages x as f32 (4N bytes a row: 57 KB at
//   N = 14336, beside 6 stages) and takes 4 weights a 16-byte word; at M =
//   1 it is bound by the 4-byte weights. Where x does not fit (or M > 8)
//   gemm_tf32x3_kernel runs, bound by operations at
//   M = 512: three TF32 products a step at 494.7 TFLOP/s (w13: 0.730 ms;
//   the f32 FMA peak, 67 TFLOP/s, would allow no less than 1.795).
//   prep_x_tf32_kernel writes x's big and small parts once; then the W8A8
//   GEMM's skeleton: a TMA ring of 3 stages of 32 f32 of depth (x's two
//   parts, 128 rows each, and a 128-row weight tile, 128-byte swizzle,
//   zeros past M, D and N), a splitter warpgroup that writes each landed
//   weight tile's small part beside it (the landed tile is its big part),
//   and two consumer warpgroups of 64 x rows, each k-step of 8 three wgmma
//   m64n128k8 from shared memory (tf32 wgmma takes only K-major operands,
//   which both are as they lie). A stage's 12 steps sum into a fresh
//   accumulator, added to the block's sums with IEEE adds (hopper.cuh: the
//   tensor cores' sums lose toward zero). N must be a multiple of 4 (the
//   maps' rows).
//
// xq_qmatmul_multi replaces the same TPU kernel through
// pallas_qmatmul_stacked_multi (the gathered top-k expert matmul of
// Mixtral's decode step):
//
//     y[e*m + r, d] = epi_idx[d] * sum_n bf16(x_e[r, n]) * W[idx][d, n],
//     idx = idxs[e]
//
// over the k experts of the (L*E, D, N) flattened expert stack, with x
// shared by the experts (gate/up) or one m-row group per expert (down).
// It is the same weight stream as the GEMV route, k experts' worth: bytes
// bound. Design: a (row tile, expert) grid; each block reads its expert's
// index from device memory (the TPU kernel's scalar prefetch), so the
// router's choice never reaches the host and one launch covers all k
// experts; weight offsets are 64-bit (the flat stack passes 2^31 bytes);
// x is staged into shared memory as bf16 in column chunks (14336-wide down
// rows and up to 8 rows at a time); the warp core (gemv.cuh's) and the
// scale epilogue (gemv_store) are the GEMV route's. f32 experts stage x as
// f32 (the TPU kernel's compute dtype for f32 weights).
//
// xq_qmatmul_multi_q4 is the same gathered matmul over packed-q4 expert
// stacks (pallas_matmul.py :350-355, :381-386, :419-420): x quantised per
// row first (quant_x_kernel; with x shared, the m rows once and their scales
// for every expert, else each of the k*m rows on its own), then the (row
// tile, expert) grid of xq_qmatmul_multi over the gathered (LE, D, N/2)
// packed rows and (LE, D, N/g) group scales with the q4 GEMV's core
// (xq_gemv2_q4): bit-equal to the plain version. Bound by bytes: k experts'
// packed rows and group scales (w13 g128 at Mixtral widths, k = 2: 124.8
// MB). The expert index is read on the card, and the codes' and the scales'
// offsets are 64-bit (Mixtral's packed w13 stack is 15.0 GB).
//
// The same TPU kernel's two int8-activation branches (pallas_matmul.py
// :116-147 packed q4, :161-167 W8A8) quantise x per row first:
// quant_x_kernel, one block per row, writes int8 codes (round half to even
// of x / (absmax / 127), both IEEE divisions, clipped to +-127) and the row
// scale into scratch the wrapper allocates; the output is multiplied by
// that scale last, as the reference does after its kernel.
//
// xq_qmatmul_q4 (M < 256, launched in blocks of up to 8 rows): the packed
// q4 GEMV. Bound by bytes: the packed row is half the i8 row's bytes, plus
// 4 bytes of scale per group. Design: gemv.cuh's xq_gemv2_q4 over the
// codes staged in shared memory, one warp per output row pair; each group
// of codes is an exact int32 __dp4a dot (512 x 8 x 127 at group 512 is far
// below 2^31), scaled in f32 once complete and summed in group order, so
// the result is bit-equal to the plain version.
//
// xq_qmatmul_a8 (W8A8, the 256- and 512-row prefill chunks): bound by
// operations at M = 512 (1979 dense s8 TOP/s; w2: 0.030 ms, w13: 0.061).
// quant_x_kernel writes x's codes, then gemm_a8_kernel, warp-specialised on
// the Hopper machinery of hopper.cuh: a producer warp keeps a ring of
// STAGES shared-memory stages full by TMA (a 128-row x-code box and a
// BN-row weight box, 128 bytes of depth each, 128-byte swizzle, zeros past
// M, D and K: the ragged edges need no branch in the main loop), and two
// consumer warpgroups each multiply their 64 x rows by the BN weight rows
// with wgmma m64n128k32 s8 x s8 -> s32 from shared memory (four k-steps a
// stage; both operands K-major, as s8 wgmma requires), the int32 sums in
// registers (exact: K * 127^2 = 2.3e8 < 2^31 at K = 14336). The epilogue
// turns each sum to f32 and multiplies by the weight's row scale (or the q8
// 1/100) and then by x's row scale, each product rounded on its own:
// bit-equal to the plain version. Tiles: 128 x 128 outputs, or 128 x 256
// where that still gives every SM of the card a block (w13, not w2 or wo:
// D = 4096 at 128 x 256 would give M = 512 only 64 blocks on an H100's
// 132); blocks walk the M tiles of one weight tile first, so each weight
// tile streams from device memory once and is reused from L2 (a8_plan
// below; xq_qmatmul_a8_plan reports it). K must be a multiple of 64.

#include <math.h>
#include <mma.h>

#include "gemv.cuh"
#include "hopper.cuh"

using namespace nvcuda;

namespace {

constexpr int GV_THREADS = 256;
constexpr int GV_WARPS = GV_THREADS / 32;
constexpr int GV_RPW = 2;  // output rows per warp (xq_gemv2's pair)
constexpr int GV_MAX_M = 8;
constexpr int GV_MAX_SMEM = 160 * 1024;  // the bf16 copy of x held in shared memory

// x staged in shared memory as bf16 (int8/bf16 weights) or f32 (f32 weights)
bool use_gemv(int M, int N, int xbytes) { return M <= GV_MAX_M && M * N * xbytes <= GV_MAX_SMEM; }

// rmsnorm scale of one row, by the whole block: 1/sqrt(mean(x^2) + eps)
__device__ float block_rms(const float* __restrict__ xm, int n, float eps, float* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  float ss = 0.f;
  for (int i = tid; i < n; i += blockDim.x) {
    const float v = xm[i];
    ss += v * v;
  }
  ss = xq_warp_sum(ss);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < nwarps; ++i) t += red[i];
  __syncthreads();  // red is reused by the next call
  return 1.0f / sqrtf(t / (float)n + eps);
}

// The GEMV epilogue of one warp: y[m * D + d] = epi[d] * (its lanes' sum of
// acc[r][m]) for its rows d = row0 + r < D and the first M activation rows;
// epi is the row scale, the q8 fixed scale, or 1.
__device__ __forceinline__ void gemv_store(float (&acc)[GV_RPW][GV_MAX_M], int row0, int M, int D,
                                           int lane, const float* __restrict__ scale, float qscale,
                                           float* __restrict__ y) {
#pragma unroll
  for (int r = 0; r < GV_RPW; ++r) {
    const int d = row0 + r;
#pragma unroll
    for (int m = 0; m < GV_MAX_M; ++m) {
      if (m >= M) break;
      float s = xq_warp_sum(acc[r][m]);
      if (lane == 0 && d < D) {
        if (scale != nullptr) s *= scale[d];
        else if (qscale != 0.f) s *= qscale;
        y[(size_t)m * D + d] = s;
      }
    }
  }
}

template <typename WT>
__global__ void __launch_bounds__(GV_THREADS) gemv_kernel(
    const float* __restrict__ x, const float* __restrict__ norm_w, float eps,
    const WT* __restrict__ w, const float* __restrict__ scale, float qscale,
    float* __restrict__ y, int M, int N, int D) {
  using XT = xq_act_t<WT>;
  extern __shared__ __align__(16) unsigned char smem[];
  XT* xs = reinterpret_cast<XT*>(smem);  // (M, N)
  __shared__ float red[GV_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // prologue: cd(rmsnorm?(x)) into shared memory, once per block
  for (int m = 0; m < M; ++m) {
    const float* xm = x + (size_t)m * N;
    const float r = norm_w != nullptr ? block_rms(xm, N, eps, red) : 1.f;
    for (int i = tid; i < N; i += GV_THREADS) {
      float v = xm[i];
      if (norm_w != nullptr) v = v * r * norm_w[i];
      xs[(size_t)m * N + i] = xq_from_float<XT>(v);
    }
  }
  __syncthreads();

  const int row0 = (blockIdx.x * GV_WARPS + warp) * GV_RPW;
  float acc[GV_RPW][GV_MAX_M] = {};
  xq_gemv2<WT, GV_MAX_M, XT>(xs, N, row0 < D ? w + (size_t)row0 * N : nullptr,
                             row0 + 1 < D ? w + (size_t)(row0 + 1) * N : nullptr, 0, N, M, lane,
                             acc);
  gemv_store(acc, row0, M, D, lane, scale, qscale, y);
}

// The streamed GEMV (M <= 8; see the note): one block an SM, its rows
// [d0, d1) dealt evenly, and within the block each warp a contiguous run of
// them, streamed through a ring of its own: GS_WARP_SLOTS slots of `slot`
// bytes, each filled by one bulk copy of whole rows (as many as fit) or of
// a segment of a longer row, refilled by the warp itself once it has read
// it. No warp waits for another after the prologue.
constexpr int GS_WARP_SLOTS = 2;  // a warp's stages in flight
constexpr int GS_SLOT = 8192;     // bytes of a stage, at most
constexpr int GS_SMEM = 227 * 1024;  // a block's shared memory on the H100 (232448 bytes)
constexpr int GS_RESERVE = 1024;     // of it, the kernel's static bytes

struct GsShape {
  int rps, nseg, segb;  // rows a stage, segments a row, bytes a segment
};

// A row of rowb bytes in stages of at most `slot` bytes: as many whole rows
// a stage as fit, else nseg segments of segb bytes (a multiple of 16; the
// last one shorter)
__host__ __device__ inline GsShape gs_shape(int rowb, int slot) {
  GsShape g{slot / rowb, 1, rowb};
  if (g.rps == 0) {
    g.rps = 1;
    g.nseg = (rowb + slot - 1) / slot;
    g.segb = ((rowb + g.nseg - 1) / g.nseg + 15) / 16 * 16;
  }
  return g;
}

template <typename WT>
__global__ void __launch_bounds__(GV_THREADS, 1) gemv_stream_kernel(
    const float* __restrict__ x, const float* __restrict__ norm_w, float eps,
    const WT* __restrict__ w, const float* __restrict__ scale, float qscale,
    float* __restrict__ y, int M, int N, int D, int slot) {
  using XT = xq_act_t<WT>;
  constexpr int EPL = 16 / sizeof(WT);  // weights a 16-byte word
  // [GV_WARPS][GS_WARP_SLOTS][slot], then x (M, N)
  extern __shared__ __align__(128) unsigned char smem[];
  XT* xs = reinterpret_cast<XT*>(smem + (size_t)GV_WARPS * GS_WARP_SLOTS * slot);
  __shared__ uint64_t full[GV_WARPS][GS_WARP_SLOTS];
  __shared__ float red[GV_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d0 = (int)((long long)blockIdx.x * D / gridDim.x);
  const int d1 = (int)((long long)(blockIdx.x + 1) * D / gridDim.x);
  const int e0 = d0 + (d1 - d0) * warp / GV_WARPS, e1 = d0 + (d1 - d0) * (warp + 1) / GV_WARPS;
  const int rowb = N * (int)sizeof(WT);  // a multiple of 16
  const GsShape sh = gs_shape(rowb, slot);
  const int nit = sh.nseg > 1 ? (e1 - e0) * sh.nseg : (e1 - e0 + sh.rps - 1) / sh.rps;
  const unsigned char* wb = reinterpret_cast<const unsigned char*>(w);
  unsigned char* ring = smem + (size_t)warp * GS_WARP_SLOTS * slot;

  // stage `it` of this warp: its first row, the byte of that row it starts
  // at, its rows and its bytes (contiguous in memory)
  auto stage = [&](int it, int& r0, int& off, int& nr, int& bytes) {
    if (sh.nseg > 1) {
      r0 = e0 + it / sh.nseg;
      off = (it % sh.nseg) * sh.segb;
      nr = 1;
      bytes = min(sh.segb, rowb - off);
    } else {
      r0 = e0 + it * sh.rps;
      off = 0;
      nr = min(sh.rps, e1 - r0);
      bytes = nr * rowb;
    }
  };
  auto load = [&](int it) {  // lane 0: one bulk copy into slot it % GS_WARP_SLOTS
    int r0, off, nr, bytes;
    stage(it, r0, off, nr, bytes);
    const int k = it % GS_WARP_SLOTS;
    xq_mbar_expect_tx(&full[warp][k], (uint32_t)bytes);
    xq_bulk_g2s(ring + (size_t)k * slot, wb + (size_t)r0 * rowb + off, (uint32_t)bytes,
                &full[warp][k]);
  };
  if (lane == 0) {
    for (int k = 0; k < GS_WARP_SLOTS; ++k) xq_mbar_init(&full[warp][k], 1);
    xq_mbar_fence_init();
    for (int it = 0; it < min(GS_WARP_SLOTS, nit); ++it) load(it);  // before any arithmetic
  }

  // prologue, under the first stages' copies: cd(rmsnorm?(x)) into shared
  // memory, once a block
  for (int m = 0; m < M; ++m) {
    const float* xm = x + (size_t)m * N;
    const float r = norm_w != nullptr ? block_rms(xm, N, eps, red) : 1.f;
    for (int i = tid; i < N; i += GV_THREADS) {
      float v = xm[i];
      if (norm_w != nullptr) v = v * r * norm_w[i];
      xs[(size_t)m * N + i] = xq_from_float<XT>(v);
    }
  }
  __syncthreads();

  float acc[GV_MAX_M] = {};
  for (int it = 0; it < nit; ++it) {
    const int k = it % GS_WARP_SLOTS;
    int r0, off, nr, bytes;
    stage(it, r0, off, nr, bytes);
    xq_mbar_wait(&full[warp][k], (it / GS_WARP_SLOTS) & 1);
    const unsigned char* st = ring + (size_t)k * slot;
    const int words = (sh.nseg > 1 ? bytes : rowb) / 16;
    const XT* xc = xs + off / (int)sizeof(WT);
    const bool ends = sh.nseg == 1 || it % sh.nseg == sh.nseg - 1;  // the rows end here
    for (int r = 0; r < nr; ++r) {
      const unsigned char* row = st + (size_t)r * rowb;
#pragma unroll 4
      for (int j = lane; j < words; j += 32)  // a warp reads 512 contiguous bytes a step
        xq_gemv_word<WT, GV_MAX_M, XT>(xc + j * EPL, N,
                                       *reinterpret_cast<const int4*>(row + j * 16), M, acc);
      if (ends) {
        const int d = r0 + r;
#pragma unroll
        for (int m = 0; m < GV_MAX_M; ++m) {
          if (m >= M) break;
          float v = xq_warp_sum(acc[m]);
          if (scale != nullptr) v *= scale[d];
          else if (qscale != 0.f) v *= qscale;
          if (lane == 0) y[(size_t)m * D + d] = v;
          acc[m] = 0.f;
        }
      }
    }
    __syncwarp();  // every lane has read the slot: refill it
    if (lane == 0 && it + GS_WARP_SLOTS < nit) load(it + GS_WARP_SLOTS);
  }
}

// Bulk copies alone, no arithmetic (xq_bulk_stream_bench): each block
// streams per_block bytes of src through nst stages of copy_bytes, one bulk
// copy a stage, the last warp done with a stage refilling it, each thread
// reading its 16-byte words of every landed stage
constexpr int BENCH_MAX_STAGES = 6;

__global__ void __launch_bounds__(GV_THREADS) bulk_stream_bench_kernel(
    const unsigned char* __restrict__ src, long long per_block, int copy_bytes, int nst,
    float* __restrict__ sink) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t full[BENCH_MAX_STAGES];
  __shared__ int released[BENCH_MAX_STAGES];
  const int tid = threadIdx.x, lane = tid & 31;
  const unsigned char* base = src + (size_t)blockIdx.x * per_block;
  const int nit = (int)(per_block / copy_bytes);
  auto load = [&](int it) {
    const int s = it % nst;
    xq_mbar_expect_tx(&full[s], (uint32_t)copy_bytes);
    xq_bulk_g2s(smem + (size_t)s * copy_bytes, base + (size_t)it * copy_bytes,
                (uint32_t)copy_bytes, &full[s]);
  };
  if (tid == 0) {
    for (int s = 0; s < nst; ++s) {
      xq_mbar_init(&full[s], 1);
      released[s] = 0;
    }
    xq_mbar_fence_init();
    for (int it = 0; it < min(nst, nit); ++it) load(it);
  }
  __syncthreads();
  float acc = 0.f;
  for (int it = 0; it < nit; ++it) {
    const int s = it % nst;
    xq_mbar_wait(&full[s], (it / nst) & 1);
    const float4* st = reinterpret_cast<const float4*>(smem + (size_t)s * copy_bytes);
    for (int j = tid; j < copy_bytes / 16; j += GV_THREADS) acc += st[j].x;
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(&released[s], 1) == GV_WARPS * (it / nst) + GV_WARPS - 1 && it + nst < nit)
        load(it + nst);
    }
    __syncwarp();
  }
  if (acc == 1.5f) sink[0] = acc;  // keeps the reads
}

// cd(rmsnorm?(x)) for the tiled paths: one block per row
template <typename XT>
__global__ void __launch_bounds__(256) prep_x_kernel(
    const float* __restrict__ x, const float* __restrict__ norm_w, float eps,
    XT* __restrict__ xb, int N) {
  __shared__ float red[8];
  const float* xm = x + (size_t)blockIdx.x * N;
  const float r = norm_w != nullptr ? block_rms(xm, N, eps, red) : 1.f;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float v = xm[i];
    if (norm_w != nullptr) v = v * r * norm_w[i];
    xb[(size_t)blockIdx.x * N + i] = xq_from_float<XT>(v);
  }
}

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDT = BK + 8;  // bf16 tile row stride (80 bytes: 32-byte aligned fragments)
constexpr int LDC = BN + 4;  // f32 output staging stride

template <typename WT>
__global__ void __launch_bounds__(128) gemm_kernel(
    const __nv_bfloat16* __restrict__ xb, const WT* __restrict__ w,
    const float* __restrict__ scale, float qscale, float* __restrict__ y,
    int M, int N, int D) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * LDT];
  __shared__ __align__(128) __nv_bfloat16 Bs[BN * LDT];
  __shared__ __align__(128) float Cs[BM * LDC];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 2x2 warps, 32x32 outputs each
  const int m0 = blockIdx.y * BM, d0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < N; k0 += BK) {
    // activations: 64 rows x 32 bf16 = 4 x 16 bytes per row
    for (int c = tid; c < BM * 4; c += 128) {
      const int row = c >> 2, col = (c & 3) * 8;
      int4 v = make_int4(0, 0, 0, 0);
      if (m0 + row < M) v = *reinterpret_cast<const int4*>(xb + (size_t)(m0 + row) * N + k0 + col);
      *reinterpret_cast<int4*>(As + row * LDT + col) = v;
    }
    // weights: widened to bf16 in shared memory (int8 and fp8 exactly)
    if constexpr (sizeof(WT) == 1) {
      const int row = tid >> 1, col = (tid & 1) * 16;  // 64 rows x 2 x 16 bytes
      int4 raw = make_int4(0, 0, 0, 0);
      if (d0 + row < D) raw = __ldg(reinterpret_cast<const int4*>(w + (size_t)(d0 + row) * N + k0 + col));
      float f[16];
      xq_unpack16<WT>(raw, f);
      __align__(16) __nv_bfloat16 tmp[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) tmp[e] = __float2bfloat16_rn(f[e]);
      *reinterpret_cast<int4*>(Bs + row * LDT + col) = *reinterpret_cast<const int4*>(tmp);
      *reinterpret_cast<int4*>(Bs + row * LDT + col + 8) = *reinterpret_cast<const int4*>(tmp + 8);
    } else {
      for (int c = tid; c < BN * 4; c += 128) {
        const int row = c >> 2, col = (c & 3) * 8;
        int4 v = make_int4(0, 0, 0, 0);
        if (d0 + row < D) v = __ldg(reinterpret_cast<const int4*>(w + (size_t)(d0 + row) * N + k0 + col));
        *reinterpret_cast<int4*>(Bs + row * LDT + col) = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * LDT + kk, LDT);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], Bs + (wn * 32 + j * 16) * LDT + kk, LDT);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += 128) {
    const int r = idx / BN, c = idx % BN;
    const int m = m0 + r, d = d0 + c;
    if (m < M && d < D) {
      float v = Cs[r * LDC + c];
      if (scale != nullptr) v *= scale[d];
      else if (qscale != 0.f) v *= qscale;
      y[(size_t)m * D + d] = v;
    }
  }
}

// rmsnorm?(x) split for the f32 GEMM, one block per row: xb = big (the f32
// value itself), xs = small (xq_tf32_split), each (M, N)
__global__ void __launch_bounds__(256) prep_x_tf32_kernel(
    const float* __restrict__ x, const float* __restrict__ norm_w, float eps,
    float* __restrict__ xb, float* __restrict__ xs, int N) {
  __shared__ float red[8];
  const float* xm = x + (size_t)blockIdx.x * N;
  const float r = norm_w != nullptr ? block_rms(xm, N, eps, red) : 1.f;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float v = xm[i];
    if (norm_w != nullptr) v = v * r * norm_w[i];
    uint32_t big, small;
    xq_tf32_split(v, big, small);
    xb[(size_t)blockIdx.x * N + i] = __uint_as_float(big);
    xs[(size_t)blockIdx.x * N + i] = __uint_as_float(small);
  }
}

// f32 GEMM tiles: x rows a block (two consumer warpgroups of 64), weight
// rows a block, f32 of depth a stage (one 128-byte swizzle row), stages
constexpr int T3_BM = 128, T3_BN = 128, T3_BK = 32, T3_STAGES = 3;
// threads: two consumer warpgroups (0..255), then a splitter warpgroup
// (256..383) whose first thread also issues the copies
constexpr int T3_CONSUMERS = 256, T3_THREADS = T3_CONSUMERS + 128;
// a stage: x's big and small parts (128 rows each), the weight tile as it
// landed (its big part as the tensor cores read it) and its small part
constexpr int T3_TILE = T3_BM * T3_BK * 4;  // 16 KB; T3_BN == T3_BM
constexpr int T3_STAGE = 4 * T3_TILE;
constexpr int T3_SMEM = T3_STAGES * T3_STAGE + 3 * T3_STAGES * 8 + 1024;

// Block (m tile, weight tile) of y = x . w^T in split TF32: per k-step of 8
// the warpgroup's 64 x rows by the 128 weight rows three times, wgmma
// m64n128k8 from shared memory (x_small w, x_big w_small, x_big w), a
// stage's 12 products into a fresh accumulator, added to the block's sums
// with IEEE adds (hopper.cuh: the tensor cores' sums lose toward zero).
// full[s]: the stage's copies landed; ready[s]: the splitter warpgroup has
// written w's small part (the tensor cores read the landed w as its big
// part); empty[s]: the 8 consumer warps are done with it.
__global__ void __launch_bounds__(T3_THREADS, 1) gemm_tf32x3_kernel(
    const __grid_constant__ CUtensorMap txb, const __grid_constant__ CUtensorMap txs,
    const __grid_constant__ CUtensorMap tw, float* __restrict__ y, int M, int N, int D) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = xq_align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T3_STAGES * T3_STAGE);
  uint64_t* ready = full + T3_STAGES;
  uint64_t* empty = ready + T3_STAGES;
  const int m0 = blockIdx.x * T3_BM, d0 = blockIdx.y * T3_BN;
  const int KT = (N + T3_BK - 1) / T3_BK;  // a last part stage reads zeros past N
  if (threadIdx.x == 0) {
    for (int s = 0; s < T3_STAGES; ++s) {
      xq_mbar_init(&full[s], 1);
      xq_mbar_init(&ready[s], 4);  // each splitter warp once
      xq_mbar_init(&empty[s], 8);  // each consumer warp once
    }
    xq_mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= T3_CONSUMERS) {
    const int t = threadIdx.x - T3_CONSUMERS;
    auto issue = [&](int kt) {  // stage kt % STAGES's copies (its previous round released)
      const int s = kt % T3_STAGES;
      if (kt >= T3_STAGES) xq_mbar_wait(&empty[s], (kt / T3_STAGES - 1) & 1);
      unsigned char* st = ring + s * T3_STAGE;
      xq_mbar_expect_tx(&full[s], 3 * T3_TILE);
      xq_tma_2d(st, &txb, kt * T3_BK, m0, &full[s]);
      xq_tma_2d(st + T3_TILE, &txs, kt * T3_BK, m0, &full[s]);
      xq_tma_2d(st + 2 * T3_TILE, &tw, kt * T3_BK, d0, &full[s]);
    };
    if (t == 0)
      for (int kt = 0; kt < T3_STAGES - 1 && kt < KT; ++kt) issue(kt);
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % T3_STAGES;
      xq_mbar_wait(&full[s], (kt / T3_STAGES) & 1);
      const float4* wb = reinterpret_cast<const float4*>(ring + s * T3_STAGE + 2 * T3_TILE);
      float4* ws = reinterpret_cast<float4*>(ring + s * T3_STAGE + 3 * T3_TILE);
      // the swizzle moves whole 16-byte chunks, so small lies where big does
      for (int i = t; i < T3_TILE / 16; i += 128) {
        const float4 v = wb[i];
        ws[i] = make_float4(v.x - xq_tf32_trunc(v.x), v.y - xq_tf32_trunc(v.y),
                            v.z - xq_tf32_trunc(v.z), v.w - xq_tf32_trunc(v.w));
      }
      xq_fence_proxy_async();  // the writes, before wgmma reads them
      __syncwarp();
      if (t % 32 == 0) xq_mbar_arrive(&ready[s]);
      // the refill of stage kt - 1 waits for its consumers, who need
      // nothing more from this warpgroup to finish it
      if (t == 0 && kt + T3_STAGES - 1 < KT) issue(kt + T3_STAGES - 1);
    }
  } else {
    const int c = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
    float acc[64], part[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0.f;
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % T3_STAGES, ph = (kt / T3_STAGES) & 1;
      xq_mbar_wait(&full[s], ph);
      xq_mbar_wait(&ready[s], ph);
      const uint32_t xb = xq_smem(ring + s * T3_STAGE + c * 64 * 128);
      const uint32_t xs = xb + T3_TILE, wb = xq_smem(ring + s * T3_STAGE + 2 * T3_TILE);
      const uint32_t ws = wb + T3_TILE;
      xq_fence_regs(part);
      xq_wgmma_fence();
#pragma unroll
      for (int k = 0; k < T3_BK / 8; ++k) {  // 8 f32 (32 bytes) of depth a step
        xq_wgmma_tf32_ss_n128(part, xq_desc(xs + 32 * k, 16, 1024), xq_desc(wb + 32 * k, 16, 1024),
                              k > 0);  // the stage's first product starts the chain
        xq_wgmma_tf32_ss_n128(part, xq_desc(xb + 32 * k, 16, 1024), xq_desc(ws + 32 * k, 16, 1024),
                              1);
        xq_wgmma_tf32_ss_n128(part, xq_desc(xb + 32 * k, 16, 1024), xq_desc(wb + 32 * k, 16, 1024),
                              1);
      }
      xq_wgmma_commit();
      xq_wgmma_wait<0>();
      xq_fence_regs(part);
      if (lane == 0) xq_mbar_arrive(&empty[s]);  // done with the stage
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] += part[j];
    }

    // element j of acc is row 16 warp + lane / 4 + 8 ((j / 2) % 2), column
    // 8 (j / 4) + 2 (lane % 4) + j % 2 of the warpgroup's tile
    const int ra = m0 + c * 64 + warp * 16 + lane / 4;
    const bool pairs = (D & 1) == 0;  // float2 stores: (m * D + d) stays even
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = ra + 8 * h;
      if (m >= M) continue;
      float* yr = y + (size_t)m * D;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int d = d0 + 8 * q + 2 * (lane % 4);
        if (d >= D) continue;
        const float v0 = acc[4 * q + 2 * h], v1 = acc[4 * q + 2 * h + 1];
        if (pairs) {
          *reinterpret_cast<float2*>(yr + d) = make_float2(v0, v1);
        } else {
          yr[d] = v0;
          if (d + 1 < D) yr[d + 1] = v1;
        }
      }
    }
  }
}

// The f32 GEMM: x split into its big and small parts (scratch xb: 2 M N
// floats), then tensor maps of both parts and of the weights (32-f32
// boxes of 128 rows) and the grid of (m tiles, weight tiles), m tiles first
cudaError_t launch_gemm_tf32x3(const float* x, const float* nw, float eps, const float* w,
                               float* y, float* xb, int M, int N, int D, cudaStream_t s) {
  float* xs = xb + (size_t)M * N;
  prep_x_tf32_kernel<<<M, 256, 0, s>>>(x, nw, eps, xb, xs, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  CUtensorMap txb, txs, tw;
  const uint64_t xdims[2] = {(uint64_t)N, (uint64_t)M}, wdims[2] = {(uint64_t)N, (uint64_t)D};
  const uint64_t stride[1] = {(uint64_t)N * 4};
  const uint32_t box[2] = {T3_BK, T3_BM};
  if (!xq_tensor_map(&txb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, xb, xdims, stride, box) ||
      !xq_tensor_map(&txs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, xs, xdims, stride, box) ||
      !xq_tensor_map(&tw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, w, wdims, stride, box))
    return cudaErrorInvalidConfiguration;
  e = xq_allow_smem(gemm_tf32x3_kernel, T3_SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + T3_BM - 1) / T3_BM, (D + T3_BN - 1) / T3_BN);
  gemm_tf32x3_kernel<<<grid, T3_THREADS, T3_SMEM, s>>>(txb, txs, tw, y, M, N, D);
  return cudaGetLastError();
}

template <typename WT>
int launch_gemv(const float* x, const float* nw, float eps, const WT* w, const float* scale,
                float qscale, float* y, int M, int N, int D, cudaStream_t s) {
  if (M < 1 || M > GV_MAX_M || N % 16 != 0) return (int)cudaErrorInvalidValue;
  const int smem = M * N * (int)sizeof(xq_act_t<WT>);
  cudaError_t e = xq_allow_smem(gemv_kernel<WT>, smem);
  if (e != cudaSuccess) return (int)e;
  const int rows_per_block = GV_WARPS * GV_RPW;
  gemv_kernel<WT><<<(D + rows_per_block - 1) / rows_per_block, GV_THREADS, smem, s>>>(
      x, nw, eps, w, scale, qscale, y, M, N, D);
  return (int)cudaGetLastError();
}

// The streamed GEMV's launch for x (M, N) by w (D, N), wbytes an element of
// w and xbytes one of x in shared memory, on a card of `sms` SMs: plan =
// {blocks, bytes a stage, rows a stage, segments a row}. One block an SM
// (D rows dealt evenly; fewer blocks where D is smaller); each warp's two
// stages of 8 KB (128 KB a block in flight), or of what shared memory
// holds beside x in whole KB (4 KB at the largest x the route takes).
// False for a shape the GEMV route does not take.
bool gs_plan(int M, int N, int D, int wbytes, int xbytes, int sms, int* plan) {
  if (M < 1 || M > GV_MAX_M || D < 1 || N < 16 || N % 16 != 0 || !use_gemv(M, N, xbytes))
    return false;
  const int fit = (GS_SMEM - GS_RESERVE - M * N * xbytes) / (GV_WARPS * GS_WARP_SLOTS) / 1024;
  const int slot = fit * 1024 < GS_SLOT ? fit * 1024 : GS_SLOT;
  const GsShape sh = gs_shape(N * wbytes, slot);
  plan[0] = D < sms ? D : sms;
  plan[1] = slot;
  plan[2] = sh.rps;
  plan[3] = sh.nseg;
  return true;
}

template <typename WT>
int launch_gemv_stream(const float* x, const float* nw, float eps, const WT* w,
                       const float* scale, float qscale, float* y, int M, int N, int D,
                       cudaStream_t s) {
  static bool allowed = false;  // opted in to the most dynamic shared memory
  using XT = xq_act_t<WT>;
  int plan[4];
  if (!gs_plan(M, N, D, (int)sizeof(WT), (int)sizeof(XT), xq_device_sms(), plan))
    return (int)cudaErrorInvalidValue;
  if (!allowed) {
    const cudaError_t e = xq_allow_smem(gemv_stream_kernel<WT>, GS_SMEM - GS_RESERVE);
    if (e != cudaSuccess) return (int)e;
    allowed = true;
  }
  const int smem = GV_WARPS * GS_WARP_SLOTS * plan[1] + M * N * (int)sizeof(XT);
  gemv_stream_kernel<WT><<<plan[0], GV_THREADS, smem, s>>>(x, nw, eps, w, scale, qscale, y, M, N,
                                                            D, plan[1]);
  return (int)cudaGetLastError();
}

template <typename WT>
int launch_gemm(const float* x, const float* nw, float eps, const WT* w, const float* scale,
                float qscale, float* y, void* xb, int M, int N, int D, cudaStream_t s) {
  if constexpr (sizeof(WT) == 4) {
    // the tensor maps' row stride: a multiple of 16 bytes
    if (M < 1 || D < 1 || N < 4 || N % 4 != 0) return (int)cudaErrorInvalidValue;
    return (int)launch_gemm_tf32x3(x, nw, eps, w, y, (float*)xb, M, N, D, s);
  } else {
    if (M < 1 || N % BK != 0) return (int)cudaErrorInvalidValue;
    using XT = xq_act_t<WT>;
    prep_x_kernel<XT><<<M, 256, 0, s>>>(x, nw, eps, (XT*)xb, N);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    dim3 grid((D + BN - 1) / BN, (M + BM - 1) / BM);
    gemm_kernel<WT><<<grid, 128, 0, s>>>((const __nv_bfloat16*)xb, w, scale, qscale, y, M, N, D);
    return (int)cudaGetLastError();
  }
}

constexpr int MX_SMEM = 48 * 1024;  // x chunk of the multi kernel: (<= 8 rows, nc), bf16 or f32
constexpr int MX_MAX_M = 256;       // m < 256 and k * m <= 512, as the TPU wrapper asserts
constexpr int MX_MAX_KM = 512;

template <typename WT>
__global__ void __launch_bounds__(GV_THREADS) qmatmul_multi_kernel(
    const float* __restrict__ x, const WT* __restrict__ w, const float* __restrict__ scale,
    float qscale, const int* __restrict__ idxs, float* __restrict__ y, int m, int shared_x,
    int N, int D, int LE, int nc) {
  using XT = xq_act_t<WT>;
  extern __shared__ __align__(16) unsigned char smem[];
  XT* xs = reinterpret_cast<XT*>(smem);  // (<= GV_MAX_M, nc)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int e = blockIdx.y;
  const int idx = idxs[e];
  const int row0 = (blockIdx.x * GV_WARPS + warp) * GV_RPW;
  const float* xe = x + (shared_x ? (size_t)0 : (size_t)e * m * N);
  float* ye = y + (size_t)e * m * D;
  if (idx < 0 || idx >= LE) {  // an index outside the stack: NaN rows, never a stray read
    for (int i = tid; i < m * GV_WARPS * GV_RPW; i += GV_THREADS) {
      const int d = blockIdx.x * GV_WARPS * GV_RPW + i % (GV_WARPS * GV_RPW);
      if (d < D) ye[(size_t)(i / (GV_WARPS * GV_RPW)) * D + d] = NAN;
    }
    return;
  }
  const WT* we = w + (size_t)idx * D * N;
  const float* se = scale != nullptr ? scale + (size_t)idx * D : nullptr;
  const WT* w0 = row0 < D ? we + (size_t)row0 * N : nullptr;
  const WT* w1 = row0 + 1 < D ? we + (size_t)(row0 + 1) * N : nullptr;

  for (int m0 = 0; m0 < m; m0 += GV_MAX_M) {
    const int mb = min(GV_MAX_M, m - m0);
    float acc[GV_RPW][GV_MAX_M] = {};
    for (int c0 = 0; c0 < N; c0 += nc) {
      const int cw = min(nc, N - c0);
      __syncthreads();  // every warp is done with the previous chunk
      for (int i = tid; i < mb * cw; i += GV_THREADS) {
        const int r = i / cw, c = i - r * cw;
        xs[(size_t)r * nc + c] = xq_from_float<XT>(xe[(size_t)(m0 + r) * N + c0 + c]);
      }
      __syncthreads();
      xq_gemv2<WT, GV_MAX_M, XT>(xs, nc, w0, w1, c0, c0 + cw, mb, lane, acc);
    }
    gemv_store(acc, row0, mb, D, lane, se, qscale, ye + (size_t)m0 * D);
  }
}

template <typename WT>
int launch_multi(const float* x, const WT* w, const float* scale, float qscale, const int* idxs,
                 float* y, int k, int m, int shared_x, int N, int D, int LE, cudaStream_t s) {
  if (k < 1 || m < 1 || m >= MX_MAX_M || k * m > MX_MAX_KM || N < 16 || N % 16 != 0 || D < 1 ||
      LE < 1)
    return (int)cudaErrorInvalidValue;
  const int mb = m < GV_MAX_M ? m : GV_MAX_M;
  const int xbytes = (int)sizeof(xq_act_t<WT>);
  const int chunk = MX_SMEM / (mb * xbytes) / 512 * 512;  // a multiple of 512: whole lane strides
  const int nc = N < chunk ? N : chunk;
  const int smem = mb * nc * xbytes;
  const int rows_per_block = GV_WARPS * GV_RPW;
  dim3 grid((D + rows_per_block - 1) / rows_per_block, k);
  qmatmul_multi_kernel<WT><<<grid, GV_THREADS, smem, s>>>(x, w, scale, qscale, idxs, y, m,
                                                          shared_x, N, D, LE, nc);
  return (int)cudaGetLastError();
}

// x's rows to int8 codes and f32 row scales, one block per row
__global__ void __launch_bounds__(256) quant_x_kernel(const float* __restrict__ x,
                                                      int8_t* __restrict__ xq,
                                                      float* __restrict__ sx, int N) {
  __shared__ float red[8];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* xm = x + (size_t)blockIdx.x * N;
  float a = 0.f;
  for (int i = tid; i < N; i += 256) a = fmaxf(a, fabsf(xm[i]));
  a = xq_warp_max(a);
  if (lane == 0) red[warp] = a;
  __syncthreads();
  float amax = 0.f;
  for (int w = 0; w < 8; ++w) amax = fmaxf(amax, red[w]);
  const float s = xq_row_scale(amax);
  for (int i = tid; i < N; i += 256) xq[(size_t)blockIdx.x * N + i] = xq_code(xm[i], s);
  if (tid == 0) sx[blockIdx.x] = s;
}

constexpr int Q4_MAX_M = GV_MAX_M;

size_t q4_smem(int M, int N, int group) {
  const int npg = N / 2 / group;
  return (size_t)M * N + (size_t)GV_WARPS * 2 * Q4_MAX_M * npg * sizeof(float);
}

__global__ void __launch_bounds__(GV_THREADS) gemv_q4_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ sx, const int8_t* __restrict__ w,
    const float* __restrict__ scale, float* __restrict__ y, int M, int N, int D, int group) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* xs = reinterpret_cast<int8_t*>(smem);  // (M, N) codes
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kh = N / 2, npg = kh / group, ng = N / group;
  float* hterm = reinterpret_cast<float*>(smem + (size_t)M * N) + warp * 2 * Q4_MAX_M * npg;
  for (int i = tid; i < M * N / 16; i += GV_THREADS)
    reinterpret_cast<int4*>(xs)[i] = reinterpret_cast<const int4*>(xq)[i];
  __syncthreads();

  const int row0 = (blockIdx.x * GV_WARPS + warp) * GV_RPW;
  float acc[GV_RPW][Q4_MAX_M] = {};
  const bool in0 = row0 < D, in1 = row0 + 1 < D;
  xq_gemv2_q4<Q4_MAX_M>(xs, xs + kh, N, in0 ? w + (size_t)row0 * kh : nullptr,
                        in1 ? w + (size_t)(row0 + 1) * kh : nullptr,
                        in0 ? scale + (size_t)row0 * ng : nullptr,
                        in1 ? scale + (size_t)(row0 + 1) * ng : nullptr, 0, kh, group, npg, M,
                        lane, acc, hterm);
  __syncwarp();
  if (lane != 0) return;
#pragma unroll
  for (int r = 0; r < GV_RPW; ++r) {
    const int d = row0 + r;
    if (d >= D) break;
    for (int m = 0; m < M; ++m)
      y[(size_t)m * D + d] = __fmul_rn(xq_q4_finish<Q4_MAX_M>(acc[r][m], hterm, r, m, npg), sx[m]);
  }
}

// The gathered q4 expert matmul: xq (m or k*m, N) codes and sx their row
// scales (quant_x_kernel's), w the (LE, D, N/2) packed stack, scale its
// (LE, D, N/g) group scales, y (k*m, D). Block (row tile, expert e): the
// rows of expert idxs[e], m activation rows in groups of up to 8, each
// group's codes staged whole (N bytes a row) after the warps' hterm planes.
__global__ void __launch_bounds__(GV_THREADS) qmatmul_multi_q4_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ sx, const int8_t* __restrict__ w,
    const float* __restrict__ scale, const int* __restrict__ idxs, float* __restrict__ y, int m,
    int shared_x, int N, int D, int LE, int group) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kh = N / 2, npg = kh / group, ng = N / group;
  float* hterm = reinterpret_cast<float*>(smem) + warp * 2 * Q4_MAX_M * npg;
  int8_t* xs = reinterpret_cast<int8_t*>(smem + (size_t)GV_WARPS * 2 * Q4_MAX_M * npg * 4);
  const int e = blockIdx.y;
  const int idx = idxs[e];
  const int row0 = (blockIdx.x * GV_WARPS + warp) * GV_RPW;
  float* ye = y + (size_t)e * m * D;
  if (idx < 0 || idx >= LE) {  // an index outside the stack: NaN rows, never a stray read
    for (int i = tid; i < m * GV_WARPS * GV_RPW; i += GV_THREADS) {
      const int d = blockIdx.x * GV_WARPS * GV_RPW + i % (GV_WARPS * GV_RPW);
      if (d < D) ye[(size_t)(i / (GV_WARPS * GV_RPW)) * D + d] = NAN;
    }
    return;
  }
  const int8_t* we = w + (size_t)idx * D * kh;  // 64-bit: the stack passes 2^31 bytes
  const float* se = scale + (size_t)idx * D * ng;
  const bool in0 = row0 < D, in1 = row0 + 1 < D;
  const int xr0 = shared_x ? 0 : e * m;  // x's first row (and row scale) for this expert
  for (int m0 = 0; m0 < m; m0 += Q4_MAX_M) {
    const int mb = min(Q4_MAX_M, m - m0);
    __syncthreads();  // every warp is done with the previous group's codes
    const int4* src = reinterpret_cast<const int4*>(xq + (size_t)(xr0 + m0) * N);
    for (int i = tid; i < mb * N / 16; i += GV_THREADS) reinterpret_cast<int4*>(xs)[i] = src[i];
    __syncthreads();
    float acc[GV_RPW][Q4_MAX_M] = {};
    xq_gemv2_q4<Q4_MAX_M>(xs, xs + kh, N, in0 ? we + (size_t)row0 * kh : nullptr,
                          in1 ? we + (size_t)(row0 + 1) * kh : nullptr,
                          in0 ? se + (size_t)row0 * ng : nullptr,
                          in1 ? se + (size_t)(row0 + 1) * ng : nullptr, 0, kh, group, npg, mb,
                          lane, acc, hterm);
    __syncwarp();
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < GV_RPW; ++r) {
        const int d = row0 + r;
        if (d >= D) break;
        for (int mm = 0; mm < mb; ++mm)
          ye[(size_t)(m0 + mm) * D + d] = __fmul_rn(
              xq_q4_finish<Q4_MAX_M>(acc[r][mm], hterm, r, mm, npg), sx[xr0 + m0 + mm]);
      }
    }
    __syncwarp();  // lane 0 is done with hterm before the next group refills it
  }
}

// W8A8 tiles: x rows a block (two consumer warpgroups of 64), bytes of
// depth a stage (one 128-byte swizzle row), the weight rows of a wgmma and
// the K granule the wrappers require
constexpr int A8_BM = 128, A8_BK = 128, A8_WN = 128, A8_KSTEP = 64;
// the block: two consumer warpgroups (threads 0..255, warpgroup-aligned as
// wgmma requires) and a producer warp (256..287). Nine warps put three on
// one of the SM's four register files, which caps a thread at 168
// registers (setmaxnreg does not lift ptxas's allocation): room for the
// 128 x 256 tile's 128 accumulators a thread
constexpr int A8_CONSUMERS = 256, A8_THREADS = A8_CONSUMERS + 32;

template <int BN>
__host__ __device__ constexpr int a8_stages() { return BN == 256 ? 4 : 5; }
template <int BN>
__host__ __device__ constexpr int a8_smem() {
  // the ring, its 2 * STAGES barriers, and the slack to align it to 1024
  return a8_stages<BN>() * (A8_BM + BN) * A8_BK + 2 * a8_stages<BN>() * 8 + 1024;
}

// Block (m tile, weight tile) of y = (xq . w^T) * epi * sx. Warpgroups 0
// and 1 consume: warpgroup c multiplies x rows 64 c .. 64 c + 63 of the tile
// by all BN weight rows, BN / 128 wgmma n128 products a k-step; warp 8
// produces (one thread issues the copies).
template <int BN>
__global__ void __launch_bounds__(A8_THREADS, 1) gemm_a8_kernel(
    const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
    const float* __restrict__ sx, const float* __restrict__ scale, float qscale,
    float* __restrict__ y, int M, int N, int D) {
  constexpr int STAGES = a8_stages<BN>(), NB = BN / A8_WN;
  constexpr int A_BYTES = A8_BM * A8_BK, STAGE = (A8_BM + BN) * A8_BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = xq_align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  const int m0 = blockIdx.x * A8_BM, d0 = blockIdx.y * BN;
  const int KT = (N + A8_BK - 1) / A8_BK;  // a last half stage reads zeros past K
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      xq_mbar_init(&full[s], 1);
      xq_mbar_init(&empty[s], 8);  // each consumer warp releases a stage once
    }
    xq_mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= A8_CONSUMERS) {
    if (threadIdx.x == A8_CONSUMERS) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) xq_mbar_wait(&empty[s], (kt / STAGES - 1) & 1);
        unsigned char* st = ring + s * STAGE;
        xq_mbar_expect_tx(&full[s], STAGE);
        xq_tma_2d(st, &tx, kt * A8_BK, m0, &full[s]);
        xq_tma_2d(st + A_BYTES, &tw, kt * A8_BK, d0, &full[s]);
      }
    }
  } else {
    const int c = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
    int acc[NB][64];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[nb][j] = 0;
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % STAGES;
      xq_mbar_wait(&full[s], (kt / STAGES) & 1);
      const uint32_t a = xq_smem(ring + s * STAGE + c * 64 * A8_BK);
      const uint32_t b = xq_smem(ring + s * STAGE + A_BYTES);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) xq_fence_regs(acc[nb]);
      xq_wgmma_fence();
#pragma unroll
      for (int k = 0; k < A8_BK / 32; ++k)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          xq_wgmma_s8_ss_n128(acc[nb], xq_desc(a + 32 * k, 16, 1024),
                              xq_desc(b + nb * A8_WN * A8_BK + 32 * k, 16, 1024));
      xq_wgmma_commit();
      xq_wgmma_wait<1>();  // the previous stage's products are done: release it
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) xq_fence_regs(acc[nb]);
      if (kt > 0 && lane == 0) xq_mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
    xq_wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) xq_fence_regs(acc[nb]);

    // epilogue: element j of acc[nb] is row 16 warp + lane / 4 + 8 ((j / 2) % 2),
    // column 128 nb + 8 (j / 4) + 2 (lane % 4) + j % 2 of the warpgroup's tile
    const int ra = m0 + c * 64 + warp * 16 + lane / 4;
    const bool pairs = (D & 1) == 0;  // float2 stores: (m * D + d) stays even
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = ra + 8 * h;
      if (m >= M) continue;
      const float sm = sx[m];
      float* yr = y + (size_t)m * D;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int d = d0 + nb * A8_WN + 8 * q + 2 * (lane % 4);
          if (d >= D) continue;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = (float)acc[nb][4 * q + 2 * h + e];
            const int de = d + e < D ? d + e : d;
            if (scale != nullptr) v[e] = __fmul_rn(v[e], scale[de]);
            else if (qscale != 0.f) v[e] = __fmul_rn(v[e], qscale);
            v[e] = __fmul_rn(v[e], sm);
          }
          if (pairs) {
            *reinterpret_cast<float2*>(yr + d) = make_float2(v[0], v[1]);
          } else {
            yr[d] = v[0];
            if (d + 1 < D) yr[d + 1] = v[1];
          }
        }
    }
  }
}

// W8A8 launch: the tensor maps of x's codes (M, N) and the weights (D, N),
// 128-byte boxes of 128 rows and of BN rows, then the grid of (m tiles,
// weight tiles), the m tiles first
template <int BN>
cudaError_t launch_gemm_a8(const int8_t* xq, const float* sx, const int8_t* w,
                           const float* scale, float qscale, float* y, int M, int N, int D,
                           cudaStream_t s) {
  CUtensorMap tx, tw;
  const uint64_t xdims[2] = {(uint64_t)N, (uint64_t)M}, wdims[2] = {(uint64_t)N, (uint64_t)D};
  const uint64_t stride[1] = {(uint64_t)N};
  const uint32_t xbox[2] = {A8_BK, A8_BM}, wbox[2] = {A8_BK, BN};
  if (!xq_tensor_map(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, xq, xdims, stride, xbox) ||
      !xq_tensor_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, wdims, stride, wbox))
    return cudaErrorInvalidConfiguration;
  cudaError_t e = xq_allow_smem(gemm_a8_kernel<BN>, a8_smem<BN>());
  if (e != cudaSuccess) return e;
  const dim3 grid((M + A8_BM - 1) / A8_BM, (D + BN - 1) / BN);
  gemm_a8_kernel<BN>
      <<<grid, A8_THREADS, a8_smem<BN>(), s>>>(tx, tw, sx, scale, qscale, y, M, N, D);
  return cudaGetLastError();
}

}  // namespace

// Packed-q4 matmul: x (M, N) f32 with M < 256, w one layer's (D, N/2)
// packed rows, scale its (D, N/group) f32 group scales, xq (M, N) int8 and
// sx (M) f32 scratch for x's codes and row scales, y (M, D) f32.
XQ_EXPORT int xq_qmatmul_q4(const void* x, const void* w, const void* scale, void* xq, void* sx,
                            void* y, int M, int N, int D, int group, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (M < 1 || M >= 256 || D < 1 || group < 128 || group % 128 != 0 || N % (2 * group) != 0 ||
      q4_smem(GV_MAX_M, N, group) > 200 * 1024)
    return (int)cudaErrorInvalidValue;
  auto* codes = (int8_t*)xq;
  auto* rs = (float*)sx;
  quant_x_kernel<<<M, 256, 0, s>>>((const float*)x, codes, rs, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = xq_allow_smem(gemv_q4_kernel, (int)q4_smem(GV_MAX_M, N, group));
  if (e != cudaSuccess) return (int)e;
  const int rows_per_block = GV_WARPS * GV_RPW;
  for (int m0 = 0; m0 < M; m0 += GV_MAX_M) {
    const int mb = M - m0 < GV_MAX_M ? M - m0 : GV_MAX_M;
    gemv_q4_kernel<<<(D + rows_per_block - 1) / rows_per_block, GV_THREADS, q4_smem(mb, N, group), s>>>(
        codes + (size_t)m0 * N, rs + m0, (const int8_t*)w, (const float*)scale,
        (float*)y + (size_t)m0 * D, mb, N, D, group);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

namespace {

// The W8A8 GEMM's blocks for x (M, N) by w (D, N) on a card of `sms` SMs:
// plan = {weight rows a block, blocks along M, blocks along D}. 128 x 256
// tiles where they still give every SM a block, else 128 x 128. False for
// a shape the kernel does not take.
bool a8_plan(int M, int N, int D, int sms, int* plan) {
  if (M < 1 || D < 1 || N < A8_KSTEP || N % A8_KSTEP != 0) return false;
  const int mt = (M + A8_BM - 1) / A8_BM;
  plan[0] = mt * ((D + 255) / 256) >= sms ? 256 : 128;
  plan[1] = mt;
  plan[2] = (D + plan[0] - 1) / plan[0];
  return true;
}

}  // namespace

// W8A8 matmul: x (M, N) f32, w one layer's (D, N) int8 rows, scale its (D)
// f32 row scales or null (then qscale, or 1 where qscale is 0), xq/sx
// scratch as above, y (M, D) f32. Blocks as xq_qmatmul_a8_plan gives them.
XQ_EXPORT int xq_qmatmul_a8(const void* x, const void* w, const void* scale, float qscale,
                            void* xq, void* sx, void* y, int M, int N, int D, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  int plan[3];
  if (!a8_plan(M, N, D, xq_device_sms(), plan)) return (int)cudaErrorInvalidValue;
  auto* codes = (int8_t*)xq;
  auto* rs = (float*)sx;
  quant_x_kernel<<<M, 256, 0, s>>>((const float*)x, codes, rs, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const auto* wq = (const int8_t*)w;
  const auto* sc = (const float*)scale;
  if (plan[0] == 256)
    return (int)launch_gemm_a8<256>(codes, rs, wq, sc, qscale, (float*)y, M, N, D, s);
  return (int)launch_gemm_a8<128>(codes, rs, wq, sc, qscale, (float*)y, M, N, D, s);
}

// xq_qmatmul_a8's blocks on the current device: plan (3 ints) = {weight
// rows a block, blocks along M, blocks along D}; cudaErrorInvalidValue for
// a shape it refuses. ops/qmatmul.py's a8_plan is held to it on the card.
XQ_EXPORT int xq_qmatmul_a8_plan(int M, int N, int D, void* plan) {
  return a8_plan(M, N, D, xq_device_sms(), (int*)plan) ? (int)cudaSuccess
                                                    : (int)cudaErrorInvalidValue;
}

// The weight types of kernels 1 and 8, as the wrappers pass them
enum WKind { W_I8 = 0, W_BF16 = 1, W_F32 = 2, W_E4M3 = 3, W_E5M2 = 4 };

// xq_qmatmul's streamed GEMV for x (M, N) by (D, N) weights of w_kind
// (bf16 or f32: the kinds that take it) on the current device: plan
// (4 ints) = {blocks, bytes a stage, rows a stage, segments a row};
// cudaErrorInvalidValue where xq_qmatmul takes another route.
// ops/qmatmul.py's gemv_plan is held to it on the card.
XQ_EXPORT int xq_gemv_plan(int M, int N, int D, int w_kind, void* plan) {
  if (w_kind != W_BF16 && w_kind != W_F32) return (int)cudaErrorInvalidValue;
  const int wbytes = w_kind == W_F32 ? 4 : 2;
  return gs_plan(M, N, D, wbytes, wbytes, xq_device_sms(), (int*)plan)
             ? (int)cudaSuccess
             : (int)cudaErrorInvalidValue;
}

// The gathered top-k expert matmul: x (m or k*m, N) f32, w the (LE, D, N)
// int8, bf16 or f32 expert stack (w_kind), scale its (LE, D) row scales or
// null, idxs (k,) int32 on the device, y (k*m, D) f32. One launch.
XQ_EXPORT int xq_qmatmul_multi(const void* x, const void* w, int w_kind, const void* scale,
                               float qscale, const void* idxs, void* y, int k, int m,
                               int shared_x, int N, int D, int LE, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const float* xf = (const float*)x;
  const float* sc = (const float*)scale;
  const int* ix = (const int*)idxs;
  float* yf = (float*)y;
  if (w_kind == W_BF16)
    return launch_multi(xf, (const __nv_bfloat16*)w, sc, qscale, ix, yf, k, m, shared_x, N, D, LE, s);
  if (w_kind == W_F32)
    return launch_multi(xf, (const float*)w, sc, qscale, ix, yf, k, m, shared_x, N, D, LE, s);
  if (w_kind == W_E4M3)
    return launch_multi(xf, (const __nv_fp8_e4m3*)w, sc, qscale, ix, yf, k, m, shared_x, N, D, LE, s);
  if (w_kind == W_E5M2)
    return launch_multi(xf, (const __nv_fp8_e5m2*)w, sc, qscale, ix, yf, k, m, shared_x, N, D, LE, s);
  return launch_multi(xf, (const int8_t*)w, sc, qscale, ix, yf, k, m, shared_x, N, D, LE, s);
}

// The gathered packed-q4 expert matmul: x (m or k*m, N) f32, w the (LE, D,
// N/2) packed stack, scale its (LE, D, N/group) f32 group scales, idxs (k,)
// int32 on the device, xq (m or k*m, N) int8 and sx (m or k*m) f32 scratch
// for x's codes and row scales, y (k*m, D) f32.
XQ_EXPORT int xq_qmatmul_multi_q4(const void* x, const void* w, const void* scale,
                                  const void* idxs, void* xq, void* sx, void* y, int k, int m,
                                  int shared_x, int N, int D, int LE, int group, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int mb = m < Q4_MAX_M ? m : Q4_MAX_M;
  if (k < 1 || m < 1 || m >= MX_MAX_M || k * m > MX_MAX_KM || D < 1 || LE < 1 || group < 128 ||
      group % 128 != 0 || N % (2 * group) != 0 || q4_smem(mb, N, group) > 200 * 1024)
    return (int)cudaErrorInvalidValue;
  auto* codes = (int8_t*)xq;
  auto* rs = (float*)sx;
  quant_x_kernel<<<shared_x ? m : k * m, 256, 0, s>>>((const float*)x, codes, rs, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int smem = (int)q4_smem(mb, N, group);
  e = xq_allow_smem(qmatmul_multi_q4_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int rows_per_block = GV_WARPS * GV_RPW;
  dim3 grid((D + rows_per_block - 1) / rows_per_block, k);
  qmatmul_multi_q4_kernel<<<grid, GV_THREADS, smem, s>>>(
      codes, rs, (const int8_t*)w, (const float*)scale, (const int*)idxs, (float*)y, m, shared_x,
      N, D, LE, group);
  return (int)cudaGetLastError();
}

namespace {

// One wgmma m64n128k8 (both operands in shared memory, 128-byte swizzle, as
// gemm_tf32x3_kernel issues it) and one mma.sync m16n8k8 (registers, as
// the f32-cache flash prefill issues it) on raw f32 bit patterns: d = a .
// b^T (64 x 128 of a (64, 8) and b (128, 8)) and dm = the first 16 rows of
// a times the first 8 rows of b (16 x 8). One warpgroup.
__global__ void __launch_bounds__(128) tf32_probe_kernel(const float* __restrict__ a,
                                                         const float* __restrict__ b,
                                                         float* __restrict__ d,
                                                         float* __restrict__ dm) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sa = xq_align1024(smem_raw);  // 64 rows of 128 bytes
  unsigned char* sb = sa + 64 * 128;           // 128 rows of 128 bytes
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  for (int i = t; i < (64 + 128) * 32; i += 128) {
    const int r = i / 32, k = i % 32;
    const bool in_a = r < 64;
    const int rr = in_a ? r : r - 64;
    const float v = k < 8 ? (in_a ? a[rr * 8 + k] : b[rr * 8 + k]) : 0.f;
    *reinterpret_cast<float*>((in_a ? sa : sb) + xq_sw128_f32(rr, k)) = v;
  }
  xq_fence_proxy_async();
  __syncthreads();
  float acc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.f;
  xq_fence_regs(acc);
  xq_wgmma_fence();
  xq_wgmma_tf32_ss_n128(acc, xq_desc(xq_smem(sa), 16, 1024), xq_desc(xq_smem(sb), 16, 1024), 1);
  xq_wgmma_commit();
  xq_wgmma_wait<0>();
  xq_fence_regs(acc);
#pragma unroll
  for (int j = 0; j < 64; ++j)
    d[(16 * warp + lane / 4 + 8 * ((j / 2) % 2)) * 128 + 8 * (j / 4) + 2 * (lane % 4) + j % 2] =
        acc[j];
  if (warp == 0) {
    const int g = lane / 4, q = lane % 4;
    const uint32_t af[4] = {__float_as_uint(a[g * 8 + q]), __float_as_uint(a[(g + 8) * 8 + q]),
                            __float_as_uint(a[g * 8 + q + 4]),
                            __float_as_uint(a[(g + 8) * 8 + q + 4])};
    float dd[4] = {0.f, 0.f, 0.f, 0.f};
    xq_mma_tf32(dd, af, __float_as_uint(b[g * 8 + q]), __float_as_uint(b[g * 8 + q + 4]));
    dm[g * 8 + 2 * q] = dd[0];
    dm[g * 8 + 2 * q + 1] = dd[1];
    dm[(g + 8) * 8 + 2 * q] = dd[2];
    dm[(g + 8) * 8 + 2 * q + 1] = dd[3];
  }
}

}  // namespace

// How the tensor cores read raw f32 operands as TF32: a (64, 8), b (128, 8)
// f32 -> d (64, 128) by tf32 wgmma, dm (16, 8) by tf32 mma.sync (see
// tf32_probe_kernel). The kernels above rely on the answer (hopper.cuh).
// Bulk copies alone: `blocks` blocks stream `bytes` of src (a multiple of
// blocks x copy_bytes) through `stages` stages of copy_bytes (a multiple of
// 16, stages x copy_bytes at most 96 KB), one bulk copy a stage; sink one
// float. chip_smoke.py --kernel-ms times it by copy size.
XQ_EXPORT int xq_bulk_stream_bench(const void* src, long long bytes, int copy_bytes, int stages,
                                   int blocks, void* sink, void* stream) {
  if (copy_bytes < 16 || copy_bytes % 16 != 0 || stages < 1 || stages > BENCH_MAX_STAGES ||
      blocks < 1 || stages * copy_bytes > 96 * 1024 || bytes % ((long long)blocks * copy_bytes))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = xq_allow_smem(bulk_stream_bench_kernel, 96 * 1024);
  if (e != cudaSuccess) return (int)e;
  bulk_stream_bench_kernel<<<blocks, GV_THREADS, stages * copy_bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      (const unsigned char*)src, bytes / blocks, copy_bytes, stages, (float*)sink);
  return (int)cudaGetLastError();
}

XQ_EXPORT int xq_tf32_probe(const void* a, const void* b, void* d, void* dm, void* stream) {
  tf32_probe_kernel<<<1, 128, (64 + 128) * 128 + 1024, static_cast<cudaStream_t>(stream)>>>(
      (const float*)a, (const float*)b, (float*)d, (float*)dm);
  return (int)cudaGetLastError();
}

// Bytes of the scratch the tiled route needs for cd(rmsnorm?(x)): bf16, or
// for f32 weights its big and small TF32 parts (f32 each); 0 where the GEMV
// route runs (M <= GV_MAX_M and x fits in shared memory)
XQ_EXPORT long long xq_qmatmul_scratch(int M, int N, int w_kind) {
  const int xbytes = w_kind == W_F32 ? 4 : 2;
  return use_gemv(M, N, xbytes) ? 0 : (long long)M * N * (w_kind == W_F32 ? 8 : 2);
}

XQ_EXPORT int xq_qmatmul(const void* x, const void* norm_w, float eps, const void* w,
                         int w_kind, const void* scale, float qscale, void* y, void* xb,
                         int M, int N, int D, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const float* xf = (const float*)x;
  const float* nw = (const float*)norm_w;
  const float* sc = (const float*)scale;
  float* yf = (float*)y;
  if (use_gemv(M, N, w_kind == W_F32 ? 4 : 2)) {
    if (w_kind == W_BF16) return launch_gemv_stream(xf, nw, eps, (const __nv_bfloat16*)w, sc, qscale, yf, M, N, D, s);
    if (w_kind == W_F32) return launch_gemv_stream(xf, nw, eps, (const float*)w, sc, qscale, yf, M, N, D, s);
    if (w_kind == W_E4M3) return launch_gemv(xf, nw, eps, (const __nv_fp8_e4m3*)w, sc, qscale, yf, M, N, D, s);
    if (w_kind == W_E5M2) return launch_gemv(xf, nw, eps, (const __nv_fp8_e5m2*)w, sc, qscale, yf, M, N, D, s);
    return launch_gemv(xf, nw, eps, (const int8_t*)w, sc, qscale, yf, M, N, D, s);
  }
  if (xb == nullptr) return (int)cudaErrorInvalidValue;
  if (w_kind == W_BF16) return launch_gemm(xf, nw, eps, (const __nv_bfloat16*)w, sc, qscale, yf, xb, M, N, D, s);
  if (w_kind == W_F32) return launch_gemm(xf, nw, eps, (const float*)w, sc, qscale, yf, xb, M, N, D, s);
  if (w_kind == W_E4M3) return launch_gemm(xf, nw, eps, (const __nv_fp8_e4m3*)w, sc, qscale, yf, xb, M, N, D, s);
  if (w_kind == W_E5M2) return launch_gemm(xf, nw, eps, (const __nv_fp8_e5m2*)w, sc, qscale, yf, xb, M, N, D, s);
  return launch_gemm(xf, nw, eps, (const int8_t*)w, sc, qscale, yf, xb, M, N, D, s);
}
