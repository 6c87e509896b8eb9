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
// - Prefill (M up to 512, and M <= 8 where x is too wide for the GEMV's
//   shared memory): operations at M >= ~300 (w13 at M = 512: 0.122 ms at
//   989 TFLOP/s), bytes below (M = 16: the weights over 3.35 TB/s, 35 us
//   for w13). gemm_bf16w_kernel, weight-stationary: the weights are the
//   wgmma's A operand (64 rows a consumer warpgroup, two warpgroups a
//   block) and the token rows its N (16, 32, 64 or 128: M = 16 runs n16 and
//   reads each weight row once, with no padded product). prep_x_kernel first
//   writes bf16(rmsnorm?(x)) once, laid out as the x tiles will lie in
//   shared memory (the 128-byte swizzle applied) and with each 64-column
//   chunk permuted (gw_column) so that the 16 columns of a k16 step's A
//   fragments that a quad lane holds are 16 contiguous weights of its row:
//   one 16-byte load of int8 or fp8 codes a row a chunk (two of bf16). Then
//   one persistent block an SM walks (weight band, token tile, K split)
//   tiles with up to 8 stages in flight across tile boundaries, each stage
//   128 bytes of each of the tile's 128 weight rows by TMA (128 one-byte or
//   64 bf16 weights) and x's tile over the same columns by one bulk copy a
//   64-column chunk: the copies a stage are the weight rows and one or two,
//   whatever the token tile (with x in 128-row TMA boxes and 64-byte weight
//   rows, the first version of this kernel moved a stage every ~0.7 us an
//   SM whatever its bytes: the copy engine's rate is by the box row). Each
//   consumer warpgroup widens its weight rows of a landed chunk in
//   registers (int8 exactly, by byte permutes and adds; fp8 by the card's
//   cvt), packs them to bf16 pairs and issues four wgmma m64nNk16 with A
//   from registers and the x chunk as B (K-major) from shared memory,
//   widening the next chunk while they run; the last of the 8 warps done
//   with a stage refills it. Chains of 8 chunks are added to the tile's
//   sums with IEEE adds (the tensor cores' f32 sums lose toward zero,
//   hopper.cuh: one chain over w2's K = 14336 lost 2.2e-5 of a row on an
//   H100). The epilogue multiplies by the row scale, the q8 1/100 or 1 and
//   stores from the registers. Tiles (gw_plan): the token tile with the
//   fewest waves of tiles over the SMs times the bytes a tile streams (a
//   stage lands at about 34 GB/s an SM on an H100: chip_smoke.py
//   --kernel-ms, stage_gb_s_per_sm);
//   the contraction split in two, four ... while the tiles leave SMs idle
//   (w2 and wo at M = 16: 32 bands), the splits adding into y in a fixed
//   order.
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
// Each block reads its expert's index from device memory (the TPU kernel's
// scalar prefetch), so the router's choice never reaches the host and one
// launch covers all k experts; weight offsets are 64-bit (the flat stack
// passes 2^31 bytes); an index outside the stack gives NaN rows and no
// read. It is the same weight stream as the GEMV route, k experts' worth:
// bound by bytes (Mixtral's w13 at k = 2, 234.9 MB: 70.3 us at 3.35 TB/s;
// w2 35.1 us), about 14 weight bytes a clock an SM. Design for int8 and q8
// experts (multi_stream_kernel), the packed-q4 stream's skeleton (below):
// one persistent block an SM of 16 warps (8 where 16 rings do not fit
// beside x), sms / k blocks an expert, each warp a contiguous band of its
// block's rows streamed through a ring of its own, two stages of whole rows
// (w13's 4 KB rows one a stage) or of a long row's equal segments in whole
// 128 bytes (w2's 14 KB rows in three), one bulk copy a stage; x's m rows
// staged once a block as the f32 values of bf16(x) (57 KB a row at w2's N
// = 14336) while the first copies are in flight, in a layout that keeps a
// quarter warp's reads on distinct banks (ms_x_index); each lane takes
// 16-byte words of the landed stage, the codes widened exactly by byte
// permutes (xq_i8x4_to_f32), four f32 FMA chains a word and row of x, the
// lanes summed at a row's end, times the row scale (i8) or the q8 1/100.
// It takes the m <= 8 rows that fit beside its rings in one launch (w13 up
// to 8, w2 up to 3); everything else keeps qmatmul_multi_kernel: a (16-row
// tile, expert) grid, x staged into shared memory in column chunks behind a
// block barrier, gemv.cuh's xq_gemv2 core and gemv_store's epilogue (f32
// experts stage x as f32, the TPU kernel's compute dtype for f32 weights).
// The split was measured, Mixtral's widths, k = 2, H100 80GB HBM3 at 700 W,
// chip_smoke.py --kernel-ms against the older kernel in the same call
// (device ms; events where marked): int8 w13 m = 1, 4, 8 0.0842 / 0.1557 /
// 0.3276 against 0.1058 / 0.2348 / 0.4257, w2 m = 1, 3 0.0457 / 0.0964
// against 0.0678 / 0.1022; but w2 m = 4 and 8 as launches of 3 rows, each
// reading the weights again, 0.1569 / 0.2749 against 0.1319 / 0.2292
// (events). bf16 experts on the same stream (eight weights a 16-byte
// word), in a variant of it: w2 m = 1 0.0845 against 0.0889, w13 m = 1 0.1589 against
// 0.1581, w13 m = 8 0.5077 against 0.4036, w2 m = 4 0.2841 against 0.1338
// (events); so they keep the older kernel. The other route measured for the
// int8 products, the codes widened exactly to bf16 and multiplied on the
// tensor cores (mma.sync m16n8k16, the weights as A, x as B, D's diagonal
// the dot), ran slower at m = 1: w13 0.1149 against the FMAs' 0.0862, w2
// 0.0659 against 0.0449 (an earlier call). Its lanes spend the same byte
// permutes widening the codes and then pack them to bf16 pairs, and all
// but the diagonal of each mma is wasted on one row of x; so the FMAs were
// kept.
//
// The same TPU kernel's two int8-activation branches (pallas_matmul.py
// :116-147 packed q4, :161-167 W8A8) quantise x per row first: int8 codes
// (round half to even of x / (absmax / 127), both IEEE divisions, clipped
// to +-127) and the row scale; the output is multiplied by that scale last,
// as the reference does after its kernel. W8A8 writes them to scratch the
// wrapper allocates (quant_x_kernel, one block per row); the q4 stream
// makes them in its own prologue.
//
// xq_qmatmul_q4 (the packed q4 GEMV, M < 256) and xq_qmatmul_multi_q4 (the
// gathered q4 experts, pallas_matmul.py :350-355, :381-386, :419-420, over
// the (LE, D, N/2) packed stack and its (LE, D, N/g) group scales): each
// group of g codes of each half of a packed row (two signed nibbles a byte,
// split-half k-order) is an exact int32 __dp4a dot against x's codes,
// turned to f32 and multiplied by its group scale, the terms summed in f32
// with every low-half group in order before the high-half ones (the
// reference's order), times x's row scale: bit-equal to the plain version.
// Bound by bytes: the packed rows (half an i8 row's) and 4 bytes of scale a
// group (Mistral's w13 at g512: 59.6 MB, 17.8 us at 3.35 TB/s; Mixtral's
// w13 g128 at k = 2: 124.8 MB, 37.3 us). The kernels this stream replaced
// (a warp a row pair loading 4-byte words from global memory, after a
// separate quantising launch) reached 24-44 % of that (PERF.md section 6). Design (q4_stream), the packed-q4
// stream, as gemv_stream_kernel streams bf16 rows:
// - One persistent block an SM of 16 warps (8 where 16 rings do not fit
//   beside x: q4_plan). The GEMV deals D rows over the blocks; the gathered
//   experts give sms / k blocks to each expert, so that a block stages one
//   expert's rows of x (per-expert x has k * m rows). Each warp owns a
//   contiguous band of its block's rows and streams it through a ring of
//   its own, two stages: a stage is one bulk copy of whole packed rows (up
//   to 8 KB: three 2 KB rows at N = 4096 and 16 warps) or of one of a
//   longer row's equal segments of whole groups, and one of those rows'
//   group scales widened to 16-byte bounds (q4_scale_cap). The expert index
//   is read on the card before the first copy (outside the stack: NaN
//   rows, no read); the codes' and the scales' offsets are 64-bit
//   (Mixtral's packed w13 stack is 15.0 GB).
// - x's codes and row scales are made in the kernel's prologue by every
//   block (at most 8 rows, read from L2), with quant_x_kernel's arithmetic;
//   the quotients without a division an element (q4_code). A load waits
//   behind the bulk copies in flight to its SM, so x is read first: a
//   single row is held in registers, each warp's first stage is issued
//   right after its loads and the second once the codes are written; more
//   rows are read twice and the copies wait for their codes.
// - gemv.cuh's xq_q4_piece64: lane l takes 64 bytes of each 2 KB step of
//   the landed row (four 16-byte words, in an order that keeps the shared
//   memory reads conflict-free), 8 __dp4a a word and activation row, and a
//   group of g = 64 L bytes is L lanes' sums (L - 1 shuffles); the lanes
//   write the group terms to shared memory, and once the row is complete
//   lane m adds its row's in the reference's order (xq_q4_row_sum). Groups
//   other than 128 .. 2048 bytes in powers of two take xq_q4_piece16 (16
//   bytes a lane, 128-byte chunks summed into groups in order).
// Where 8 rows of x do not fit beside the rings (Gemma-7B's w2, N = 24576),
// fewer rows a launch (q4_plan): column chunks would have to keep every
// band row's terms (2 M x N/2g floats a row) across chunks, more shared
// memory than they free. M > 8 runs launches of up to 8 rows.
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

#include "gemv.cuh"
#include "hopper.cuh"

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

// The tiled GEMM of int8, fp8 and bf16 weights (gemm_bf16w_kernel; see the
// note): tiles of GW_RB weight rows by nt token rows; a stage 128 bytes of
// each weight row (128 one-byte or 64 bf16 weights: GW_BK bytes) and the x
// tile over the same columns; up to GW_MAX_STAGES stages; two consumer
// warpgroups of 64 weight rows each
constexpr int GW_RB = 128, GW_BK = 128, GW_MAX_STAGES = 8, GW_THREADS = 256;
constexpr int GW_SMEM = 227 * 1024;  // a block's dynamic shared memory on the H100
constexpr int GW_NTS[4] = {16, 32, 64, 128};  // token rows a tile (the wgmma's N)
constexpr int GW_COUNTERS = 1024;  // the K splits' turn counters in the scratch, at most
// 64-column chunks of a stage a chain of products runs over before it is
// added to the tile's sums (32 k16 steps: the tensor cores' sums lose
// toward zero along a chain, hopper.cuh)
constexpr int GW_CHAIN = 8;

// the contraction column that slot u (0..63) of a 64-column chunk of x's
// scratch holds: k16 step s = u / 16, position kk = u % 16 of the step's
// A fragment, which lane t = (kk % 8) / 2 of a quad holds as its value
// (kk % 2) + 2 (kk / 8), i.e. weight column 16 t + 4 s + that of the chunk
__host__ __device__ inline int gw_column(int u) {
  const int s = u >> 4, kk = u & 15;
  return 16 * ((kk & 7) >> 1) + 4 * s + (kk & 1) + 2 * (kk >> 3);
}

// cd(rmsnorm?(x)) for the tiled GEMM, bf16, laid out as the x tiles'
// shared-memory images, one block per row m < mtiles * nt (rows past M
// zero): tile (m / nt, chunk c) of 64 columns at ((m / nt) * nc + c) * nt *
// 128 bytes, its row m % nt at 128 (m % nt) bytes, in the 128-byte swizzle
// (16-byte chunk q at q ^ (m % 8)); slot u of a row holds column c * 64 +
// gw_column(u) of x, zero past N. A stage's x tile is then one contiguous
// bulk copy a chunk.
__global__ void __launch_bounds__(256) prep_x_kernel(
    const float* __restrict__ x, const float* __restrict__ norm_w, float eps,
    __nv_bfloat16* __restrict__ xb, int M, int N, int nt, int nc) {
  __shared__ float red[8];
  const int m = blockIdx.x, r = m % nt;
  const bool live = m < M;
  const float* xm = x + (size_t)(live ? m : 0) * N;
  const float rs = live && norm_w != nullptr ? block_rms(xm, N, eps, red) : 1.f;
  __nv_bfloat16* tile = xb + (size_t)(m / nt) * nc * nt * 64 + (size_t)r * 64;
  for (int i = threadIdx.x; i < nc * 64; i += blockDim.x) {
    const int c = i >> 6, u = i & 63;
    const int n = c * 64 + gw_column(u);
    float v = 0.f;
    if (live && n < N) {
      v = xm[n];
      if (norm_w != nullptr) v = v * rs * norm_w[n];
    }
    tile[(size_t)c * nt * 64 + (((u >> 3) ^ (r & 7)) << 3) + (u & 7)] = __float2bfloat16_rn(v);
  }
}

// four weights of one 32-bit word (int8 or fp8 codes: exact in bf16), as
// two bf16 pairs, the lower two in lo
template <typename WT>
__device__ __forceinline__ void gw_widen4(uint32_t word, uint32_t& lo, uint32_t& hi) {
  if constexpr (xq_fp8<WT>::value) {
    const float2 a = __half22float2(
        __half2(__nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(word & 0xffffu), xq_fp8<WT>::kind)));
    const float2 b = __half22float2(
        __half2(__nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(word >> 16), xq_fp8<WT>::kind)));
    lo = xq_bf16x2(a.x, a.y);
    hi = xq_bf16x2(b.x, b.y);
  } else {
    // the codes exactly as f32 (gemv.cuh's byte permutes and adds); each
    // bf16 is the f32's upper half (exact: 8 significant bits)
    float f[4];
    xq_i8x4_to_f32(word, f);
    lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
    hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
  }
}

// The thread's A fragments for the four k16 steps of 64-column chunk h of
// a landed weight tile (a[s]: rows r and r + 8, the columns the quad lane t
// holds, gw_column): 16 weights of each row at columns 64 h + 16 t ..
// 64 h + 16 t + 15, in 128-byte rows. One-byte weights unswizzled (128
// columns a row, two chunks); bf16 under the 128-byte swizzle (64 columns,
// chunks 2t ^ (r % 8) and 2t + 1 ^ (r % 8): a load phase's two rows take
// the even and the odd ones).
template <typename WT>
__device__ __forceinline__ void gw_load_a(const unsigned char* wt, int r, int t, int h,
                                          uint32_t (&a)[4][4]) {
  if constexpr (sizeof(WT) == 1) {
    const uint4 q0 = *reinterpret_cast<const uint4*>(wt + r * 128 + 64 * h + 16 * t);
    const uint4 q1 = *reinterpret_cast<const uint4*>(wt + (r + 8) * 128 + 64 * h + 16 * t);
    const uint32_t w0[4] = {q0.x, q0.y, q0.z, q0.w}, w1[4] = {q1.x, q1.y, q1.z, q1.w};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      gw_widen4<WT>(w0[s], a[s][0], a[s][2]);
      gw_widen4<WT>(w1[s], a[s][1], a[s][3]);
    }
  } else {
    const int sw = r & 7;  // rows r and r + 8 share their swizzle
    const unsigned char* p0 = wt + r * 128;
    const unsigned char* p1 = wt + (r + 8) * 128;
    const uint4 lo0 = *reinterpret_cast<const uint4*>(p0 + (((2 * t) ^ sw) << 4));
    const uint4 hi0 = *reinterpret_cast<const uint4*>(p0 + (((2 * t + 1) ^ sw) << 4));
    const uint4 lo1 = *reinterpret_cast<const uint4*>(p1 + (((2 * t) ^ sw) << 4));
    const uint4 hi1 = *reinterpret_cast<const uint4*>(p1 + (((2 * t + 1) ^ sw) << 4));
    const uint32_t w0[8] = {lo0.x, lo0.y, lo0.z, lo0.w, hi0.x, hi0.y, hi0.z, hi0.w};
    const uint32_t w1[8] = {lo1.x, lo1.y, lo1.z, lo1.w, hi1.x, hi1.y, hi1.z, hi1.w};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      a[s][0] = w0[2 * s];
      a[s][1] = w1[2 * s];
      a[s][2] = w0[2 * s + 1];
      a[s][3] = w1[2 * s + 1];
    }
  }
}

// One persistent block an SM (or fewer) walks tiles blockIdx.x, + gridDim.x,
// ... of tiles = bands x mtiles x ks, (band, m tile, K split) with the K
// split fastest, then the m tiles: the blocks in flight share their weight
// bands. A tile is GW_RB weight rows (band) by NT token rows (m tile) over
// kts stages of the contraction (split). `stages` stages are in flight,
// across tile boundaries: each the weight tile by TMA (GW_RB rows of 128
// bytes) and the x tile's chunks (NT x 128 bytes each, laid out in the
// scratch as they land) by one bulk copy each, so that a stage is GW_RB +
// 1 or 2 copies, whatever NT. The last of the 8 consumer warps done with a
// slot refills it (a count in shared memory), so that no warp waits for
// another (a slot refilled by thread 0 once an mbarrier had counted the 8
// releases, or by a producer warp waiting on it, ran 1.2-2.4x slower on an
// H100). Consumer warpgroup c widens its 64 weight rows of a chunk of the
// landed stage into A fragments in registers (the next chunk's while this
// one's products run) and multiplies them by the x chunk, B from shared
// memory, four wgmma m64nNTk16 a chunk, each issued behind the previous
// chunk's, chains of GW_CHAIN chunks added to the tile's sums with IEEE
// adds (the tensor cores' sums lose toward zero: hopper.cuh). y = sum
// times the row scale, the q8 scale or 1, stored from the registers. With
// K splits (ks > 1) the splits of a tile add into y in their order, split
// s once counters[tile] reads s (zeroed by the launcher; the last split
// sets it back to 0): the sums do not depend on which block finishes
// first. The splits of a tile are consecutive tiles, so each waits only on
// tiles of lower index, taken by the persistent blocks, all resident, no
// later than its own.
template <typename WT, int NT>
__global__ void __launch_bounds__(GW_THREADS, 1) gemm_bf16w_kernel(
    const __nv_bfloat16* __restrict__ xb, const __grid_constant__ CUtensorMap tw,
    const float* __restrict__ scale, float qscale, float* __restrict__ y,
    unsigned int* __restrict__ counters, int M, int D, int nc, int mtiles, int ks, int kts,
    int tiles, int stages) {
  constexpr int XC = GW_BK / 64 / (int)sizeof(WT);  // 64-column chunks a stage
  constexpr int X_CHUNK = NT * 128;
  constexpr int STAGE = XC * X_CHUNK + GW_RB * GW_BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = xq_align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * STAGE);
  // the consumer warps' releases of each slot, over the block's rounds
  int* released = reinterpret_cast<int*>(full + GW_MAX_STAGES);
  const int tid = threadIdx.x, c = tid / 128, warp = tid % 128 / 32, lane = tid % 32;
  const int mine = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total = mine * kts;  // the block's stages, over all its tiles
  auto tile_of = [&](int j, int& band, int& mt, int& split) {
    const int tl = blockIdx.x + j * gridDim.x;
    split = tl % ks;
    mt = tl / ks % mtiles;
    band = tl / ks / mtiles;
  };
  auto issue = [&](int i) {  // the block's stage i into ring slot i % stages
    int band, mt, split;
    tile_of(i / kts, band, mt, split);
    const int s = i % stages, kt = split * kts + i % kts;
    unsigned char* st = ring + s * STAGE;
    xq_mbar_expect_tx(&full[s], STAGE);
    xq_tma_2d(st + XC * X_CHUNK, &tw, kt * (GW_BK / (int)sizeof(WT)), band * GW_RB, &full[s]);
    const __nv_bfloat16* xt = xb + ((size_t)mt * nc + (size_t)kt * XC) * NT * 64;
#pragma unroll
    for (int h = 0; h < XC; ++h)
      xq_bulk_g2s(st + h * X_CHUNK, xt + (size_t)h * NT * 64, X_CHUNK, &full[s]);
  };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      xq_mbar_init(&full[s], 1);
      released[s] = 0;
    }
    xq_mbar_fence_init();
    for (int i = 0; i < stages && i < total; ++i) issue(i);
  }
  __syncthreads();

  const int r = 64 * c + 16 * warp + lane / 4;  // the thread's rows r and r + 8 of the tile
  float acc[NT / 2], part[NT / 2];
  uint32_t a0[4][4], a1[4][4];
  int i = 0;  // the block's current stage
  // stage st's slot is done with in this warp: the last of the 8 warps to
  // say so refills it
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      const int n = atomicAdd(&released[st % stages], 1);
      if (n == 8 * (st / stages) + 7 && st + stages < total) issue(st + stages);
    }
    __syncwarp();
  };
  // chunk q (of the tile's kts * XC) from the fragments cur: four products
  // into the chain, issued behind the previous chunk's; once that one is
  // done (and its stage, if it was the stage's last chunk, released), the
  // next chunk's fragments go into nxt (the previous chunk's registers)
  // while this chunk's products run. A chain's last chunk waits for its
  // products and adds the chain to acc.
  const int nq = kts * XC;
  auto step = [&](uint32_t (&cur)[4][4], uint32_t (&nxt)[4][4], int q) {
    const int h = q % XC;
    const uint32_t xt = xq_smem(ring + (i % stages) * STAGE + h * X_CHUNK);
    const bool first = q % GW_CHAIN == 0, last = q + 1 == nq || (q + 1) % GW_CHAIN == 0;
    xq_fence_regs(part);
    xq_wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)  // 16 bf16 (32 bytes) of depth a step
      xq_wgmma_bf16_rs_kmajor<NT>(part, cur[k], xq_desc(xt + 32 * k, 16, 1024),
                                  !(first && k == 0));
    xq_wgmma_commit();
    if (last) {
      xq_wgmma_wait<0>();
      xq_fence_regs(part);
#pragma unroll
      for (int e = 0; e < NT / 2; ++e) acc[e] += part[e];
    } else {
      xq_wgmma_wait<1>();  // the previous chunk's products are done
      xq_fence_regs(part);
    }
    // the previous chunk's stage, if it ended there and its chain did not
    if (q > 0 && (q - 1) % XC == XC - 1 && !first) release(i - 1);
    if (h == XC - 1) {  // this stage's last chunk
      if (last) release(i);
      ++i;
    }
    if (q + 1 < nq) {
      const int hn = (q + 1) % XC;
      if (hn == 0) xq_mbar_wait(&full[i % stages], (i / stages) & 1);
      gw_load_a<WT>(ring + (i % stages) * STAGE + XC * X_CHUNK, r, lane % 4, hn, nxt);
    }
  };
  for (int j = 0; j < mine; ++j) {
#pragma unroll
    for (int e = 0; e < NT / 2; ++e) acc[e] = 0.f;
    xq_mbar_wait(&full[i % stages], (i / stages) & 1);
    gw_load_a<WT>(ring + (i % stages) * STAGE + XC * X_CHUNK, r, lane % 4, 0, a0);
    for (int q = 0; q < nq; q += 2) {
      step(a0, a1, q);
      if (q + 1 < nq) step(a1, a0, q + 1);
    }

    // element e of acc: weight row r + 8 ((e / 2) % 2), token row 8 (e / 4)
    // + 2 (lane % 4) + e % 2 of the tile
    int band, mt, split;
    tile_of(j, band, mt, split);
    unsigned int* turn = counters + (blockIdx.x + j * gridDim.x) / ks;
    if (ks > 1) {  // wait for this split's turn at the tile
      if (tid == 0) {
        const long long t0 = clock64();
        unsigned int cur;
        do {
          asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(cur) : "l"(turn) : "memory");
          if (clock64() - t0 > XQ_MBAR_TIMEOUT_CYCLES) __trap();
        } while (cur != (unsigned int)split);
      }
      __syncthreads();
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int d = band * GW_RB + r + 8 * hh;
      if (d >= D) continue;
      const float epi = scale != nullptr ? scale[d] : qscale != 0.f ? qscale : 1.f;
#pragma unroll
      for (int q = 0; q < NT / 8; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = mt * NT + 8 * q + 2 * (lane % 4) + e;
          if (m >= M) continue;
          float* yp = y + (size_t)m * D + d;
          const float v = acc[4 * q + 2 * hh + e] * epi;
          __stcg(yp, split > 0 ? __ldcg(yp) + v : v);
        }
    }
    if (ks > 1) {  // hand the tile to the next split
      __threadfence();
      __syncthreads();
      if (tid == 0) atomicExch(turn, split + 1 < ks ? split + 1 : 0);
    }
  }
}

// The tiled GEMM's launch for x (M, N) by (D, N) weights of wbytes a weight
// on a card of `sms` SMs: plan = {token rows a tile, weight rows a tile,
// tiles along M, tiles along D, K splits, stages, blocks}. The token tile
// (the wgmma's N: 16, 32, 64 or 128, at most M rounded up to a power of two
// past 16) with the least waves x bytes a tile streams a column (GW_RB
// weights and nt bf16 of x: on an H100 a stage lands at about 34 GB/s an
// SM, chip_smoke.py --kernel-ms's stage_gb_s_per_sm), the wider on a tie; K split in two while
// that still leaves the card short of blocks (splits of at least 4
// stages); stages as shared memory holds, at most GW_MAX_STAGES; one block
// an SM, fewer where the tiles are. False for a shape the kernel does not
// take (N a multiple of 32).
bool gw_plan(int M, int N, int D, int wbytes, int sms, int* plan) {
  if (M < 1 || D < 1 || N < 32 || N % 32 != 0 || sms < 1) return false;
  const int bands = (D + GW_RB - 1) / GW_RB, kt = (N * wbytes + GW_BK - 1) / GW_BK;
  int cap = 16;
  while (cap < M && cap < 128) cap *= 2;
  int nt = 16;
  long long best = -1;
  for (int nt_try : GW_NTS) {
    if (nt_try > cap) break;
    const long long tiles = (long long)bands * ((M + nt_try - 1) / nt_try);
    const long long cost = (tiles + sms - 1) / sms * (GW_RB * wbytes + 2 * nt_try);
    if (best < 0 || cost <= best) {
      best = cost;
      nt = nt_try;
    }
  }
  const int mtiles = (M + nt - 1) / nt;
  int ks = 1;
  while ((long long)bands * mtiles * ks * 2 <= sms && kt % (2 * ks) == 0 && kt / (2 * ks) >= 4 &&
         bands * mtiles <= GW_COUNTERS)
    ks *= 2;
  const int stage = GW_BK / 64 / wbytes * nt * 128 + GW_RB * GW_BK;
  const int stages = (GW_SMEM - 1024 - GW_MAX_STAGES * (8 + 4)) / stage;
  const long long tiles = (long long)bands * mtiles * ks;
  plan[0] = nt;
  plan[1] = GW_RB;
  plan[2] = mtiles;
  plan[3] = bands;
  plan[4] = ks;
  plan[5] = stages < GW_MAX_STAGES ? stages : GW_MAX_STAGES;
  plan[6] = (int)(tiles < sms ? tiles : sms);
  return true;
}

// bytes of the tiled GEMM's dynamic shared memory: the ring, its barriers
// and release counts, and the slack to align it to 1024
int gw_smem(int nt, int wbytes, int stages) {
  return stages * (GW_BK / 64 / wbytes * nt * 128 + GW_RB * GW_BK) + GW_MAX_STAGES * (8 + 4) +
         1024;
}

template <typename WT, int NT>
cudaError_t launch_gemm_bf16w(const __nv_bfloat16* xb, const CUtensorMap& tw, const float* scale,
                              float qscale, float* y, unsigned int* counters, int M, int D,
                              int nc, const int* plan, int kts, cudaStream_t s) {
  const int smem = gw_smem(NT, (int)sizeof(WT), plan[5]);
  cudaError_t e = xq_allow_smem(gemm_bf16w_kernel<WT, NT>, smem);
  if (e != cudaSuccess) return e;
  const int tiles = plan[2] * plan[3] * plan[4];
  gemm_bf16w_kernel<WT, NT><<<plan[6], GW_THREADS, smem, s>>>(
      xb, tw, scale, qscale, y, counters, M, D, nc, plan[2], plan[4], kts, tiles, plan[5]);
  return cudaGetLastError();
}

// bytes of the tiled GEMM's x scratch: the x tiles of M rows rounded up to
// 128 (any token tile divides it) by N rounded up to 128 columns (a stage's
// chunks), bf16; the K splits' counters follow it
size_t gw_x_bytes(int M, int N) {
  return (size_t)((M + 127) / 128 * 128) * ((N + 127) / 128 * 128) * 2;
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
    int plan[7];
    if (!gw_plan(M, N, D, (int)sizeof(WT), xq_device_sms(), plan)) return (int)cudaErrorInvalidValue;
    // x's 64-column chunks: a stage's (two of one-byte weights' 128 columns)
    // times the stages
    const int nt = plan[0], nc = (N * (int)sizeof(WT) + GW_BK - 1) / GW_BK * (GW_BK / 64 / (int)sizeof(WT));
    auto* xbf = (__nv_bfloat16*)xb;
    prep_x_kernel<<<plan[2] * nt, 256, 0, s>>>(x, nw, eps, xbf, M, N, nt, nc);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    // the weights (D, N) in boxes of 128 bytes of 128 rows: one-byte codes
    // unswizzled, bf16 in the 128-byte swizzle; zeros past N and D
    CUtensorMap tw;
    const uint64_t wdims[2] = {(uint64_t)N, (uint64_t)D}, wstride[1] = {(uint64_t)N * sizeof(WT)};
    const uint32_t wbox[2] = {GW_BK / (uint32_t)sizeof(WT), GW_RB};
    if (!xq_tensor_map(&tw, sizeof(WT) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                       2, w, wdims, wstride, wbox,
                       sizeof(WT) == 1 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidConfiguration;
    auto* turns = reinterpret_cast<unsigned int*>((unsigned char*)xb + gw_x_bytes(M, N));
    if (plan[4] > 1) {  // the K splits' turns start at 0
      e = cudaMemsetAsync(turns, 0, (size_t)plan[2] * plan[3] * sizeof(unsigned int), s);
      if (e != cudaSuccess) return (int)e;
    }
    const int kts = (N * (int)sizeof(WT) + GW_BK - 1) / GW_BK / plan[4];
    switch (nt) {
      case 16:
        return (int)launch_gemm_bf16w<WT, 16>(xbf, tw, scale, qscale, y, turns, M, D, nc, plan,
                                              kts, s);
      case 32:
        return (int)launch_gemm_bf16w<WT, 32>(xbf, tw, scale, qscale, y, turns, M, D, nc, plan,
                                              kts, s);
      case 64:
        return (int)launch_gemm_bf16w<WT, 64>(xbf, tw, scale, qscale, y, turns, M, D, nc, plan,
                                              kts, s);
      default:
        return (int)launch_gemm_bf16w<WT, 128>(xbf, tw, scale, qscale, y, turns, M, D, nc, plan,
                                               kts, s);
    }
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

bool multi_shape_ok(int k, int m, int N, int D, int LE) {
  return k >= 1 && m >= 1 && m < MX_MAX_M && k * m <= MX_MAX_KM && N >= 16 && N % 16 == 0 &&
         D >= 1 && LE >= 1;
}

template <typename WT>
int launch_multi(const float* x, const WT* w, const float* scale, float qscale, const int* idxs,
                 float* y, int k, int m, int shared_x, int N, int D, int LE, cudaStream_t s) {
  if (!multi_shape_ok(k, m, N, D, LE)) return (int)cudaErrorInvalidValue;
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

// The packed-q4 stream (xq_qmatmul_q4, xq_qmatmul_multi_q4; see the note):
// one block an SM, each warp's band of output rows streamed through a ring
// of its own, Q4_SLOTS stages of `slot` bytes: a stage's packed rows (whole
// rows, or a segment of a longer one) and their scale rows, two bulk
// copies. x's codes and row scales are made in the prologue.
constexpr int Q4_MAX_WARPS = 16;  // warps a block: 16, or 8 where 16 rings do not fit
constexpr int Q4_SLOTS = 2;       // a warp's stages in flight
// packed bytes a stage, in whole KB: at most, and at least at 16 and 8 warps
constexpr int Q4_SLOT_MAX = 8192, Q4_SLOT_WIDE = 4096, Q4_SLOT_MIN = 2048;
constexpr int Q4_SMEM = GS_SMEM - GS_RESERVE;  // dynamic shared memory of a block
constexpr int Q4_MAX_M = 8;                    // x's rows a launch
constexpr int Q4_XV = 8;  // float4s of a single row of x a thread holds in the prologue

// A stage's scale copy: `rows` scale rows of ng floats at a 4-byte aligned
// address, widened to 16-byte bounds at both ends (the bulk copy's
// granule; a scale row of N/g floats, 24 bytes at N = 3072 and g = 512, is
// not a multiple of 16): at most 24 bytes more. The widening reads at most
// 12 bytes before the first and after the last scale, within the 16-byte
// granules that hold them: never across a page, and never used.
__host__ __device__ inline int q4_scale_cap(int rows, int ng) {
  return (rows * ng * 4 + 24 + 15) / 16 * 16;
}

struct Q4Plan {
  int mb;     // x's rows a launch (more rows: more launches)
  int warps;  // warps a block
  int bpe;    // blocks an expert (grid.x); grid.y is the k experts
  int slot;   // bytes of a stage: the packed bytes, then the scale copy's room
  int rps;    // whole packed rows a stage (1 for a segmented row)
  int nseg;   // segments a row (1: whole rows a stage)
  int segb;   // packed bytes a segment (a multiple of the group)
  int smem;   // dynamic shared memory of a launch of mb rows
};

// A warp's row of group terms, in floats: npg rounded up to 4 (16-byte
// loads) with its 16-byte count odd (the eight rows' loads of one q fall in
// distinct bank groups)
__host__ __device__ inline int q4_term_stride(int npg) { return (npg + 3) / 8 * 8 + 4; }

// Dynamic shared memory of the stream for M rows of x: the warps' rings, x's
// codes (M, N), and each warp's group terms (2 M rows: the low half's, then
// the high half's)
inline int q4_smem(int warps, int M, int N, int group, int slot) {
  return warps * Q4_SLOTS * slot + M * N + warps * 2 * M * q4_term_stride(N / 2 / group) * 4;
}

// The packed-q4 stream's launch for M rows of x (each expert's; M > 8 runs
// in launches of mb rows) by (D, N/2) packed rows of group g, k experts, on
// a card of `sms` SMs. In order of preference: the most rows of x a launch
// (fewer rows: the weights stream again), 16 warps (8 where 16 rings of 4
// KB stages do not fit), and the most packed bytes a stage, in whole KB
// from 8 KB down (to 4 KB at 16 warps, 2 KB at 8), that fit beside x's
// codes and the terms: whole rows where a row fits (rps of them), else
// equal segments of whole groups. One block an SM: sms / k blocks an expert
// (at least one, and no more than a warp a row). False for a shape the
// stream does not take.
bool q4_plan(int M, int N, int D, int group, int k, int sms, Q4Plan* p) {
  if (M < 1 || D < 1 || k < 1 || group < 128 || group % 128 != 0 || N % (2 * group) != 0)
    return false;
  const int kh = N / 2, ng = N / group;
  for (int mb = M < Q4_MAX_M ? M : Q4_MAX_M; mb >= 1; --mb)
    for (int warps = Q4_MAX_WARPS; warps >= 8; warps /= 2)
      for (int sw = Q4_SLOT_MAX; sw >= (warps > 8 ? Q4_SLOT_WIDE : Q4_SLOT_MIN); sw -= 1024) {
        Q4Plan q{mb, warps, 0, 0, 1, 1, kh, 0};
        if (kh <= sw) {
          q.rps = sw / kh;
        } else {
          q.nseg = (kh + sw - 1) / sw;
          q.segb = ((kh + q.nseg - 1) / q.nseg + group - 1) / group * group;
          if (q.segb > sw) {
            q.segb = sw / group * group;
            if (q.segb == 0) continue;
            q.nseg = (kh + q.segb - 1) / q.segb;
          }
        }
        q.slot = (q.nseg > 1 ? q.segb : q.rps * kh) + q4_scale_cap(q.rps, ng);
        q.smem = q4_smem(warps, mb, N, group, q.slot);
        if (q.smem > Q4_SMEM) continue;
        const int per = sms / k > 1 ? sms / k : 1;
        const int most = (D + warps - 1) / warps;
        q.bpe = per < most ? per : most;
        *p = q;
        return true;
      }
  return false;
}

// x's code for v in a row of scale s (xq_code's rint of the IEEE quotient
// v / s, clipped to +-127) without a division an element: r = 1/s (IEEE,
// once a row), the product v r and one correction put q within an ulp of
// v / s; then Markstein's step: the residual v - q s is exact under an
// FMA, and q + (v - q s) r rounds to the IEEE quotient. That holds without
// under- or overflow: for a row whose absmax lies in [2^-60, 2^100] (every
// quotient that can round away from 0 is then normal, and so is its
// residual); q4_stream divides the other rows' elements.
__device__ __forceinline__ signed char q4_code(float v, float s, float r) {
  const float q0 = __fmul_rn(v, r);
  const float q1 = __fmaf_rn(__fmaf_rn(-q0, s, v), r, q0);
  const float q = __fmaf_rn(__fmaf_rn(-q1, s, v), r, q1);
  return (signed char)fminf(fmaxf(rintf(q), -127.f), 127.f);
}

struct Q4Args {
  int M, N, D, group;  // x's rows this launch (<= MAXM), widths, the group
  int m, m0;           // x's rows an expert (y's rows an expert), this launch's first
  int shared_x, LE;    // x shared by the experts; experts in the stack
  int slot, rps, nseg, segb;
};

// Rows [d0, d1) of expert e = blockIdx.y (of the stack's expert idxs[e];
// for the GEMV, the one matrix) by activation rows m0 .. m0 + M - 1, as
// the note says. y row e * m + m0 + r, x row (shared_x ? 0 : e * m) + m0 + r.
template <int MAXM, bool GATHER>
__device__ __forceinline__ void q4_stream(const float* __restrict__ x,
                                          const int8_t* __restrict__ w,
                                          const float* __restrict__ scale,
                                          const int* __restrict__ idxs, float* __restrict__ y,
                                          const Q4Args& a) {
  // [warps][Q4_SLOTS][slot] rings, then x's codes (M, N), then the terms
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t full[Q4_MAX_WARPS][Q4_SLOTS];
  __shared__ float red[Q4_MAX_WARPS][MAXM];
  __shared__ float sxs[MAXM], rxs[MAXM];  // x's row scales and their reciprocals
  const int tid = threadIdx.x, lane = tid & 31;
  // the warp's index, from lane 0: the compiler then knows it is the same in
  // every lane, so the loops over a warp's stages hold no divergent branch
  // around the shuffles (where it cannot tell, it wraps each shuffle in a
  // loop over the lanes' groups)
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int N = a.N, D = a.D, M = a.M, kh = N / 2, npg = kh / a.group, ng = N / a.group;
  const int hs = q4_term_stride(npg);
  const int e = GATHER ? blockIdx.y : 0;
  const int idx = GATHER ? idxs[e] : 0;  // read on the card, before any copy
  const int d0 = (int)((long long)blockIdx.x * D / gridDim.x);
  const int d1 = (int)((long long)(blockIdx.x + 1) * D / gridDim.x);
  float* ye = y + ((size_t)e * a.m + a.m0) * D;
  if (GATHER && (idx < 0 || idx >= a.LE)) {  // an index outside the stack: NaN rows, no read
    for (int i = tid; i < M * (d1 - d0); i += nthreads)
      ye[(size_t)(i / (d1 - d0)) * D + d0 + i % (d1 - d0)] = NAN;
    return;
  }
  const int8_t* we = w + (size_t)idx * D * kh;  // 64-bit: the stack passes 2^31 bytes
  const float* se = scale + (size_t)idx * D * ng;
  const float* xe = x + ((size_t)(GATHER && !a.shared_x ? e * a.m : 0) + a.m0) * N;
  const int e0 = d0 + (d1 - d0) * warp / nwarps, e1 = d0 + (d1 - d0) * (warp + 1) / nwarps;
  const int nit = a.nseg > 1 ? (e1 - e0) * a.nseg : (e1 - e0 + a.rps - 1) / a.rps;
  const int wcap = a.nseg > 1 ? a.segb : a.rps * kh;  // a stage's packed bytes, at most
  unsigned char* ring = smem + (size_t)warp * Q4_SLOTS * a.slot;
  int8_t* xs = reinterpret_cast<int8_t*>(smem + (size_t)nwarps * Q4_SLOTS * a.slot);
  float* tm = reinterpret_cast<float*>(xs + (size_t)M * N) + (size_t)warp * 2 * M * hs;

  // stage `it` of this warp: its first row, the packed byte of that row it
  // starts at, its rows and its packed bytes (contiguous in memory)
  auto stage = [&](int it, int& r0, int& off, int& nr, int& bytes) {
    if (a.nseg > 1) {
      r0 = e0 + it / a.nseg;
      off = (it % a.nseg) * a.segb;
      nr = 1;
      bytes = min(a.segb, kh - off);
    } else {
      r0 = e0 + it * a.rps;
      off = 0;
      nr = min(a.rps, e1 - r0);
      bytes = nr * kh;
    }
  };
  // the scale rows r0 .. r0 + nr - 1, widened to 16-byte bounds: the
  // copy's source and bytes, and the floats before the first scale
  auto scales = [&](int r0, int nr, const unsigned char*& src, uint32_t& bytes, int& lead) {
    const uintptr_t a0 = reinterpret_cast<uintptr_t>(se + (size_t)r0 * ng);
    const uintptr_t w0 = a0 & ~(uintptr_t)15;
    const uintptr_t w1 = (a0 + (uintptr_t)nr * ng * 4 + 15) & ~(uintptr_t)15;
    src = reinterpret_cast<const unsigned char*>(w0);
    bytes = (uint32_t)(w1 - w0);
    lead = (int)(a0 - w0) / 4;
  };
  auto load = [&](int it) {  // lane 0: the stage's two bulk copies into slot it % Q4_SLOTS
    int r0, off, nr, bytes, lead;
    stage(it, r0, off, nr, bytes);
    const unsigned char* ssrc;
    uint32_t sbytes;
    scales(r0, nr, ssrc, sbytes, lead);
    const int k = it % Q4_SLOTS;
    unsigned char* dst = ring + (size_t)k * a.slot;
    xq_mbar_expect_tx(&full[warp][k], (uint32_t)bytes + sbytes);
    xq_bulk_g2s(dst, we + (size_t)r0 * kh + off, (uint32_t)bytes, &full[warp][k]);
    xq_bulk_g2s(dst + wcap, ssrc, sbytes, &full[warp][k]);
  };
  if (lane == 0) {
    for (int k = 0; k < Q4_SLOTS; ++k) xq_mbar_init(&full[warp][k], 1);
    xq_mbar_fence_init();
  }
  auto issue = [&](int first, int last) {  // lane 0: the ring's stages [first, last)
    if (lane == 0)
      for (int it = first; it < min(last, nit); ++it) load(it);
  };

  // prologue: x's codes and row scales, once a block (quant_x_kernel's
  // arithmetic: absmax, IEEE quotients rounded half to even, clipped to
  // +-127). A load waits behind the bulk copies in flight to its SM (a ring
  // fill is ~200 KB: several us), so x's loads go first: a single row is
  // held in registers, each warp's first stage is issued right after its
  // loads and the second once the codes are written; more rows are read
  // twice and the copies wait for the codes.
  const float4* x4 = reinterpret_cast<const float4*>(xe);
  const bool held = M == 1 && N / 4 <= Q4_XV * nthreads;
  float4 xv[Q4_XV];
  if (held) {
#pragma unroll
    for (int k = 0; k < Q4_XV; ++k) {
      const int i = tid + k * nthreads;
      xv[k] = i < N / 4 ? __ldg(x4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    issue(0, 1);
  }
  auto amax4 = [](float am, const float4& v) {
    return fmaxf(fmaxf(am, fabsf(v.x)), fmaxf(fabsf(v.y), fmaxf(fabsf(v.z), fabsf(v.w))));
  };
#pragma unroll
  for (int m = 0; m < MAXM; ++m) {
    if (m >= M) break;
    float am = 0.f;
    if (held) {
#pragma unroll
      for (int k = 0; k < Q4_XV; ++k) am = amax4(am, xv[k]);
    } else {
      for (int i = tid; i < N / 4; i += nthreads) am = amax4(am, __ldg(x4 + (size_t)m * (N / 4) + i));
    }
    am = xq_warp_max(am);
    if (lane == 0) red[warp][m] = am;
  }
  __syncthreads();
  if (tid < M) {
    float am = 0.f;
    for (int i = 0; i < nwarps; ++i) am = fmaxf(am, red[i][tid]);
    sxs[tid] = xq_row_scale(am);
    // 0 marks a row outside q4_code's range, whose elements divide
    rxs[tid] = am >= 0x1p-60f && am <= 0x1p100f ? __fdiv_rn(1.0f, sxs[tid]) : 0.f;
  }
  __syncthreads();
  auto codes = [](const float4& v, float sc, float rc) {
    return rc != 0.f ? make_char4(q4_code(v.x, sc, rc), q4_code(v.y, sc, rc),
                                  q4_code(v.z, sc, rc), q4_code(v.w, sc, rc))
                     : make_char4(xq_code(v.x, sc), xq_code(v.y, sc), xq_code(v.z, sc),
                                  xq_code(v.w, sc));
  };
  if (held) {
#pragma unroll
    for (int k = 0; k < Q4_XV; ++k) {
      const int i = tid + k * nthreads;
      if (i < N / 4) reinterpret_cast<char4*>(xs)[i] = codes(xv[k], sxs[0], rxs[0]);
    }
    issue(1, Q4_SLOTS);
  } else {
    for (int m = 0; m < M; ++m) {
      char4* xc = reinterpret_cast<char4*>(xs + (size_t)m * N);
      for (int i = tid; i < N / 4; i += nthreads)
        xc[i] = codes(__ldg(x4 + (size_t)m * (N / 4) + i), sxs[m], rxs[m]);
    }
    issue(0, Q4_SLOTS);
  }
  __syncthreads();

  // a piece's groups: 64 L bytes for the powers of two from 128 to 2048,
  // else the 16-byte layout
  auto piece = [&](const unsigned char* p, int rb, int off, const float* sr) {
    switch (a.group) {
      case 128: xq_q4_piece64<MAXM, 2>(p, rb, xs, N, kh, off, sr, npg, M, lane, tm, hs); break;
      case 256: xq_q4_piece64<MAXM, 4>(p, rb, xs, N, kh, off, sr, npg, M, lane, tm, hs); break;
      case 512: xq_q4_piece64<MAXM, 8>(p, rb, xs, N, kh, off, sr, npg, M, lane, tm, hs); break;
      case 1024: xq_q4_piece64<MAXM, 16>(p, rb, xs, N, kh, off, sr, npg, M, lane, tm, hs); break;
      case 2048: xq_q4_piece64<MAXM, 32>(p, rb, xs, N, kh, off, sr, npg, M, lane, tm, hs); break;
      default:
        xq_q4_piece16<MAXM>(p, rb, xs, N, kh, off, sr, npg, a.group / 128, M, lane, tm, hs);
    }
  };
  for (int it = 0; it < nit; ++it) {
    const int k = it % Q4_SLOTS;
    int r0, off, nr, bytes, lead;
    stage(it, r0, off, nr, bytes);
    const unsigned char* ssrc;
    uint32_t sbytes;
    scales(r0, nr, ssrc, sbytes, lead);
    xq_mbar_wait(&full[warp][k], (it / Q4_SLOTS) & 1);
    const unsigned char* st = ring + (size_t)k * a.slot;
    const float* sc = reinterpret_cast<const float*>(st + wcap) + lead;
    const bool ends = a.nseg == 1 || it % a.nseg == a.nseg - 1;  // the rows end here
    for (int r = 0; r < nr; ++r) {
      piece(st + (size_t)r * kh, a.nseg > 1 ? bytes : kh, off, sc + (size_t)r * ng);
      if (ends) {
        __syncwarp();  // every lane's terms are in
        if (lane < M)
          ye[(size_t)lane * D + r0 + r] = __fmul_rn(xq_q4_row_sum(tm, hs, npg, M, lane), sxs[lane]);
        __syncwarp();  // the terms are read before the next row writes them
      }
    }
    __syncwarp();  // every lane has read the slot: refill it
    if (lane == 0 && it + Q4_SLOTS < nit) load(it + Q4_SLOTS);
  }
}

template <int MAXM>
__global__ void __launch_bounds__(Q4_MAX_WARPS * 32, 1)
    gemv_q4_stream_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                          const float* __restrict__ scale, float* __restrict__ y, Q4Args a) {
  q4_stream<MAXM, false>(x, w, scale, nullptr, y, a);
}

template <int MAXM>
__global__ void __launch_bounds__(Q4_MAX_WARPS * 32, 1)
    multi_q4_stream_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                           const float* __restrict__ scale, const int* __restrict__ idxs,
                           float* __restrict__ y, Q4Args a) {
  q4_stream<MAXM, true>(x, w, scale, idxs, y, a);
}

// One launch of the stream for M <= 8 rows of x (a.M), at the plan's
// stages, on the smallest instantiation that holds M rows
template <int MAXM>
cudaError_t launch_q4_rows(const Q4Plan& p, const float* x, const int8_t* w, const float* scale,
                           const int* idxs, float* y, int k, const Q4Args& a, cudaStream_t s) {
  static bool allowed = false;  // opted in to the most dynamic shared memory
  if (!allowed) {
    cudaError_t e = xq_allow_smem(gemv_q4_stream_kernel<MAXM>, Q4_SMEM);
    if (e == cudaSuccess) e = xq_allow_smem(multi_q4_stream_kernel<MAXM>, Q4_SMEM);
    if (e != cudaSuccess) return e;
    allowed = true;
  }
  const int smem = q4_smem(p.warps, a.M, a.N, a.group, p.slot);
  if (idxs == nullptr)
    gemv_q4_stream_kernel<MAXM><<<p.bpe, p.warps * 32, smem, s>>>(x, w, scale, y, a);
  else
    multi_q4_stream_kernel<MAXM><<<dim3(p.bpe, k), p.warps * 32, smem, s>>>(x, w, scale, idxs,
                                                                             y, a);
  return cudaGetLastError();
}

// The stream over m rows of x an expert (k experts; the GEMV: k = 1, no
// idxs), in launches of the plan's mb rows
cudaError_t launch_q4(const float* x, const int8_t* w, const float* scale, const int* idxs,
                      float* y, int k, int m, int shared_x, int N, int D, int LE, int group,
                      cudaStream_t s) {
  Q4Plan p;
  if (!q4_plan(m, N, D, group, k, xq_device_sms(), &p)) return cudaErrorInvalidValue;
  Q4Args a{0, N, D, group, m, 0, shared_x, LE, p.slot, p.rps, p.nseg, p.segb};
  for (a.m0 = 0; a.m0 < m; a.m0 += p.mb) {
    a.M = m - a.m0 < p.mb ? m - a.m0 : p.mb;
    const cudaError_t e =
        a.M == 1   ? launch_q4_rows<1>(p, x, w, scale, idxs, y, k, a, s)
        : a.M <= 4 ? launch_q4_rows<4>(p, x, w, scale, idxs, y, k, a, s)
                   : launch_q4_rows<8>(p, x, w, scale, idxs, y, k, a, s);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// ---- kernel 8's int8 and q8 experts: the per-expert stream (see the
// note). The q4 stream's skeleton and plan: Q4_MAX_WARPS warps (8 where 16
// rings do not fit beside x), MS_SLOTS stages a warp of whole rows or of a
// long row's equal segments (a multiple of 128 bytes), x's m rows staged
// once a block as f32 values of bf16(x) in a layout that keeps each lane's
// reads off shared memory's bank conflicts (ms_x_index), one launch for all
// m <= MS_MAX_M rows.
constexpr int MS_SLOTS = 2;   // a warp's stages in flight (3 ran no faster)
constexpr int MS_MAX_M = 8;   // x's rows an expert
constexpr int MS_XV = 8;      // float4s of x a thread holds in the prologue

struct MsPlan {
  int mb;     // x's rows an expert, all in the one launch
  int warps;  // warps a block
  int bpe;    // blocks an expert (grid.x); grid.y is the k experts
  int slot;   // bytes of a stage
  int rps;    // whole rows a stage (1 for a segmented row)
  int nseg;   // segments a row (1: whole rows a stage)
  int segb;   // bytes a segment (a multiple of 128)
  int smem;   // dynamic shared memory of the launch
};

// The stream's launch for M rows of x an expert by (D, N) int8 weight rows,
// k experts, on a card of `sms` SMs. In order of preference: 16 warps, and
// the most bytes a stage from 8 KB down (to 4 KB at 16 warps, 2 KB at 8) in
// whole KB: whole rows where a row fits (rps of them; the stage holds just
// those bytes), else equal segments in whole 128 bytes; x (M, N) f32 beside
// the rings. One block an SM: sms / k blocks an expert, at least one and no
// more than a warp a row. False for a shape the stream does not take, M >
// MS_MAX_M or x too wide to stand beside the rings among them: those keep
// qmatmul_multi_kernel, which reads the weights once however many rows (a
// stream of launches of fewer rows, each reading them again, lost to it).
bool ms_plan(int M, int N, int D, int k, int sms, MsPlan* p) {
  if (M < 1 || M > MS_MAX_M || D < 1 || k < 1 || N < 16 || N % 16 != 0) return false;
  const int rowb = N;
  for (int warps = Q4_MAX_WARPS; warps >= 8; warps /= 2)
    for (int sw = Q4_SLOT_MAX; sw >= (warps > 8 ? Q4_SLOT_WIDE : Q4_SLOT_MIN); sw -= 1024) {
      MsPlan q{M, warps, 0, 0, 1, 1, rowb, 0};
      if (rowb <= sw) {
        q.rps = sw / rowb;
        q.slot = q.rps * rowb;
      } else {
        q.nseg = (rowb + sw - 1) / sw;
        q.segb = ((rowb + q.nseg - 1) / q.nseg + 127) / 128 * 128;
        q.slot = q.segb;
      }
      q.smem = warps * MS_SLOTS * q.slot + M * N * 4;
      if (q.smem > Q4_SMEM) continue;
      const int per = sms / k > 1 ? sms / k : 1;
      const int most = (D + warps - 1) / warps;
      q.bpe = per < most ? per : most;
      *p = q;
      return true;
    }
  return false;
}

// Where x's element n lies in the stream's shared copy of a row: the 16-byte
// weight word jw = n / 16 takes x's 16 values n .. as four chunks of four
// floats, chunk c at chunk (c + jw / 2) % 4 of the word's slot: the 8 lanes
// of a quarter warp, which read 8 consecutive words' chunk c at once, then
// hit 8 distinct 16-byte bank groups
__host__ __device__ inline int ms_x_index(int n) {
  const int jw = n / 16, c = (n % 16) / 4;
  return jw * 16 + 4 * ((c + (jw >> 1)) & 3) + n % 4;
}

// acc[m] += the products of the 16 codes of the 16-byte word raw (word jw
// of the row) and x's rows m < M (ms_x_index's layout, row m at m * ldx):
// four codes a chunk, each chunk's four products an FMA chain, the chunks
// added in pairs, then to acc
template <int MAXM>
__device__ __forceinline__ void ms_word(const float* xs, int ldx, int jw, const int4& raw, int M,
                                        float (&acc)[MAXM]) {
  float wf[16];
  xq_unpack16<int8_t>(raw, wf);
#pragma unroll
  for (int m = 0; m < MAXM; ++m) {
    if (m >= M) break;
    const float* xw = xs + (size_t)m * ldx + jw * 16;
    float pc[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 xv = *reinterpret_cast<const float4*>(xw + 4 * ((c + (jw >> 1)) & 3));
      float t = xv.x * wf[4 * c];
      t = fmaf(xv.y, wf[4 * c + 1], t);
      t = fmaf(xv.z, wf[4 * c + 2], t);
      pc[c] = fmaf(xv.w, wf[4 * c + 3], t);
    }
    acc[m] += (pc[0] + pc[1]) + (pc[2] + pc[3]);
  }
}

struct MsArgs {
  int M, N, D;       // x's rows an expert (<= MAXM; y's rows an expert), widths
  int shared_x, LE;  // x shared by the experts; experts in the stack
  float qscale;      // the q8 fixed scale (no row scale), 0: none
  int slot, rps, nseg, segb;
};

// Rows [d0, d1) of expert e = blockIdx.y (the stack's expert idxs[e]) by x's
// M rows, as the note says. y row e * M + r, x row (shared_x ? 0 : e * M) + r.
template <int MAXM>
__global__ void __launch_bounds__(Q4_MAX_WARPS * 32, 1)
    multi_stream_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                        const float* __restrict__ scale, const int* __restrict__ idxs,
                        float* __restrict__ y, MsArgs a) {
  // [warps][MS_SLOTS][slot] rings, then x (M, N) f32 (ms_x_index's layout)
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t full[Q4_MAX_WARPS][MS_SLOTS];
  const int tid = threadIdx.x, lane = tid & 31;
  // the warp's index from lane 0, known warp-uniform (see q4_stream)
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int N = a.N, D = a.D, M = a.M, rowb = N;
  const int e = blockIdx.y;
  const int idx = idxs[e];  // read on the card, before any copy
  const int d0 = (int)((long long)blockIdx.x * D / gridDim.x);
  const int d1 = (int)((long long)(blockIdx.x + 1) * D / gridDim.x);
  float* ye = y + (size_t)e * M * D;
  if (idx < 0 || idx >= a.LE) {  // an index outside the stack: NaN rows, no read
    for (int i = tid; i < M * (d1 - d0); i += nthreads)
      ye[(size_t)(i / (d1 - d0)) * D + d0 + i % (d1 - d0)] = NAN;
    return;
  }
  // 64-bit offsets: the flat stack passes 2^31 bytes
  const unsigned char* we = reinterpret_cast<const unsigned char*>(w) + (size_t)idx * D * rowb;
  const float* se = scale != nullptr ? scale + (size_t)idx * D : nullptr;
  const float* xe = x + (size_t)(a.shared_x ? 0 : e * M) * N;
  const int e0 = d0 + (d1 - d0) * warp / nwarps, e1 = d0 + (d1 - d0) * (warp + 1) / nwarps;
  const int nit = a.nseg > 1 ? (e1 - e0) * a.nseg : (e1 - e0 + a.rps - 1) / a.rps;
  unsigned char* ring = smem + (size_t)warp * MS_SLOTS * a.slot;
  float* xs = reinterpret_cast<float*>(smem + (size_t)nwarps * MS_SLOTS * a.slot);

  // stage `it` of this warp: its first row, the byte of that row it starts
  // at, its rows and its bytes (contiguous in memory)
  auto stage = [&](int it, int& r0, int& off, int& nr, int& bytes) {
    if (a.nseg > 1) {
      r0 = e0 + it / a.nseg;
      off = (it % a.nseg) * a.segb;
      nr = 1;
      bytes = min(a.segb, rowb - off);
    } else {
      r0 = e0 + it * a.rps;
      off = 0;
      nr = min(a.rps, e1 - r0);
      bytes = nr * rowb;
    }
  };
  auto load = [&](int it) {  // lane 0: one bulk copy into slot it % MS_SLOTS
    int r0, off, nr, bytes;
    stage(it, r0, off, nr, bytes);
    const int k = it % MS_SLOTS;
    xq_mbar_expect_tx(&full[warp][k], (uint32_t)bytes);
    xq_bulk_g2s(ring + (size_t)k * a.slot, we + (size_t)r0 * rowb + off, (uint32_t)bytes,
                &full[warp][k]);
  };
  if (lane == 0) {
    for (int k = 0; k < MS_SLOTS; ++k) xq_mbar_init(&full[warp][k], 1);
    xq_mbar_fence_init();
  }
  auto issue = [&]() {  // lane 0: the ring's first stages
    if (lane == 0)
      for (int it = 0; it < min(MS_SLOTS, nit); ++it) load(it);
  };

  // prologue: x as f32 values of bf16(x), once a block. A load waits behind
  // the bulk copies in flight to its SM, so x is read first: where x fits in
  // MS_XV float4s a thread it is held in registers while the ring's first
  // stages are issued, else it is stored before they are.
  const float4* x4 = reinterpret_cast<const float4*>(xe);
  const int nx4 = M * N / 4;  // N % 16 == 0: a float4 never crosses a row
  auto put = [&](int i, const float4& v) {
    const int m = i / (N / 4), n = (i % (N / 4)) * 4;
    const auto r = [](float f) { return __bfloat162float(__float2bfloat16_rn(f)); };
    *reinterpret_cast<float4*>(xs + (size_t)m * N + ms_x_index(n)) =
        make_float4(r(v.x), r(v.y), r(v.z), r(v.w));
  };
  if (nx4 <= MS_XV * nthreads) {
    float4 xv[MS_XV];
#pragma unroll
    for (int k = 0; k < MS_XV; ++k) {
      const int i = tid + k * nthreads;
      xv[k] = i < nx4 ? __ldg(x4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    issue();
#pragma unroll
    for (int k = 0; k < MS_XV; ++k)
      if (tid + k * nthreads < nx4) put(tid + k * nthreads, xv[k]);
  } else {
    for (int i = tid; i < nx4; i += nthreads) put(i, __ldg(x4 + i));
    issue();
  }
  __syncthreads();

  float acc[MAXM] = {};
  for (int it = 0; it < nit; ++it) {
    const int k = it % MS_SLOTS;
    int r0, off, nr, bytes;
    stage(it, r0, off, nr, bytes);
    xq_mbar_wait(&full[warp][k], (it / MS_SLOTS) & 1);
    const unsigned char* st = ring + (size_t)k * a.slot;
    const bool ends = a.nseg == 1 || it % a.nseg == a.nseg - 1;  // the rows end here
    const int words = (a.nseg > 1 ? bytes : rowb) / 16, w0 = off / 16;
    for (int r = 0; r < nr; ++r) {
      const unsigned char* row = st + (size_t)r * rowb;
#pragma unroll 4
      for (int j = lane; j < words; j += 32)  // a warp reads 512 contiguous bytes a step
        ms_word<MAXM>(xs, N, w0 + j, *reinterpret_cast<const int4*>(row + j * 16), M, acc);
      if (ends) {
        const int d = r0 + r;
#pragma unroll
        for (int m = 0; m < MAXM; ++m) {
          if (m >= M) break;
          float v = xq_warp_sum(acc[m]);
          if (se != nullptr) v *= se[d];
          else if (a.qscale != 0.f) v *= a.qscale;
          if (lane == 0) ye[(size_t)m * D + d] = v;
          acc[m] = 0.f;
        }
      }
    }
    __syncwarp();  // every lane has read the slot: refill it
    if (lane == 0 && it + MS_SLOTS < nit) load(it + MS_SLOTS);
  }
}

// The stream's launch for a.M <= MAXM rows of x an expert, at the plan's stages
template <int MAXM>
cudaError_t launch_ms_rows(const MsPlan& p, const float* x, const int8_t* w, const float* scale,
                           const int* idxs, float* y, int k, const MsArgs& a, cudaStream_t s) {
  static bool allowed = false;  // opted in to the most dynamic shared memory
  if (!allowed) {
    const cudaError_t e = xq_allow_smem(multi_stream_kernel<MAXM>, Q4_SMEM);
    if (e != cudaSuccess) return e;
    allowed = true;
  }
  multi_stream_kernel<MAXM><<<dim3(p.bpe, k), p.warps * 32, p.smem, s>>>(x, w, scale, idxs, y,
                                                                         a);
  return cudaGetLastError();
}

// The stream over the plan's m rows of x an expert, k experts, in one launch
cudaError_t launch_ms(const MsPlan& p, const float* x, const int8_t* w, const float* scale,
                      float qscale, const int* idxs, float* y, int k, int shared_x, int N, int D,
                      int LE, cudaStream_t s) {
  const MsArgs a{p.mb, N, D, shared_x, LE, qscale, p.slot, p.rps, p.nseg, p.segb};
  return a.M == 1   ? launch_ms_rows<1>(p, x, w, scale, idxs, y, k, a, s)
         : a.M <= 4 ? launch_ms_rows<4>(p, x, w, scale, idxs, y, k, a, s)
                    : launch_ms_rows<8>(p, x, w, scale, idxs, y, k, a, s);
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
// packed rows, scale its (D, N/group) f32 group scales, y (M, D) f32. xq
// (M, N) int8 and sx (M) f32 are scratch the kernel leaves unwritten (x's
// codes are made in shared memory). Launches as xq_qmatmul_q4_plan says.
XQ_EXPORT int xq_qmatmul_q4(const void* x, const void* w, const void* scale, void* xq, void* sx,
                            void* y, int M, int N, int D, int group, void* stream) {
  (void)xq;
  (void)sx;
  if (M < 1 || M >= 256) return (int)cudaErrorInvalidValue;
  return (int)launch_q4((const float*)x, (const int8_t*)w, (const float*)scale, nullptr,
                        (float*)y, 1, M, 1, N, D, 1, group, static_cast<cudaStream_t>(stream));
}

// The packed-q4 stream's launch on the current device for M rows of x an
// expert by (D, N/2) packed rows of group `group`, k experts (1: the
// GEMV): plan (8 ints) = {x's rows a launch, warps a block, blocks an
// expert, bytes a stage, whole rows a stage, segments a row, packed bytes a
// segment, dynamic shared memory of a launch}; cudaErrorInvalidValue for a
// shape it refuses. ops/qmatmul.py's q4_plan is held to it on the card.
XQ_EXPORT int xq_qmatmul_q4_plan(int M, int N, int D, int group, int k, void* plan) {
  Q4Plan p;
  if (!q4_plan(M, N, D, group, k, xq_device_sms(), &p)) return (int)cudaErrorInvalidValue;
  const int v[8] = {p.mb, p.warps, p.bpe, p.slot, p.rps, p.nseg, p.segb, p.smem};
  for (int i = 0; i < 8; ++i) static_cast<int*>(plan)[i] = v[i];
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
// int8, bf16, f32 or fp8 expert stack (w_kind), scale its (LE, D) row
// scales or null, idxs (k,) int32 on the device, y (k*m, D) f32. int8 and
// q8 experts take the per-expert stream (x and w 16-byte aligned) where one
// launch holds x's m rows beside its rings (xq_qmatmul_multi_plan); the
// rest, bf16, f32 and fp8 experts among them, one launch of
// qmatmul_multi_kernel (see the note for the times that chose this).
XQ_EXPORT int xq_qmatmul_multi(const void* x, const void* w, int w_kind, const void* scale,
                               float qscale, const void* idxs, void* y, int k, int m,
                               int shared_x, int N, int D, int LE, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const float* xf = (const float*)x;
  const float* sc = (const float*)scale;
  const int* ix = (const int*)idxs;
  float* yf = (float*)y;
  MsPlan p;
  if (w_kind == W_I8 && multi_shape_ok(k, m, N, D, LE) && ms_plan(m, N, D, k, xq_device_sms(), &p))
    return (int)launch_ms(p, xf, (const int8_t*)w, sc, qscale, ix, yf, k, shared_x, N, D, LE, s);
  if (w_kind == W_I8)
    return launch_multi(xf, (const int8_t*)w, sc, qscale, ix, yf, k, m, shared_x, N, D, LE, s);
  if (w_kind == W_BF16)
    return launch_multi(xf, (const __nv_bfloat16*)w, sc, qscale, ix, yf, k, m, shared_x, N, D, LE, s);
  if (w_kind == W_F32)
    return launch_multi(xf, (const float*)w, sc, qscale, ix, yf, k, m, shared_x, N, D, LE, s);
  if (w_kind == W_E4M3)
    return launch_multi(xf, (const __nv_fp8_e4m3*)w, sc, qscale, ix, yf, k, m, shared_x, N, D, LE, s);
  if (w_kind == W_E5M2)
    return launch_multi(xf, (const __nv_fp8_e5m2*)w, sc, qscale, ix, yf, k, m, shared_x, N, D, LE, s);
  return (int)cudaErrorInvalidValue;
}

// The per-expert stream's launch on the current device for m rows of x an
// expert by (D, N) int8 rows (w_kind 0), k experts: plan (8 ints) = {x's
// rows (m), warps a block, blocks an expert, bytes a stage, whole rows a
// stage, segments a row, bytes a segment, dynamic shared memory};
// cudaErrorInvalidValue for a shape or kind the stream does not take
// (xq_qmatmul_multi then launches qmatmul_multi_kernel). ops/qmatmul.py's
// multi_plan is held to it on the card.
XQ_EXPORT int xq_qmatmul_multi_plan(int m, int N, int D, int w_kind, int k, void* plan) {
  MsPlan p;
  if (w_kind != W_I8 || !ms_plan(m, N, D, k, xq_device_sms(), &p))
    return (int)cudaErrorInvalidValue;
  const int v[8] = {p.mb, p.warps, p.bpe, p.slot, p.rps, p.nseg, p.segb, p.smem};
  for (int i = 0; i < 8; ++i) static_cast<int*>(plan)[i] = v[i];
  return (int)cudaSuccess;
}

// The gathered packed-q4 expert matmul: x (m or k*m, N) f32, w the (LE, D,
// N/2) packed stack, scale its (LE, D, N/group) f32 group scales, idxs (k,)
// int32 on the device, y (k*m, D) f32. xq and sx (m or k*m rows) are
// scratch the kernel leaves unwritten. One launch for m <= 8.
XQ_EXPORT int xq_qmatmul_multi_q4(const void* x, const void* w, const void* scale,
                                  const void* idxs, void* xq, void* sx, void* y, int k, int m,
                                  int shared_x, int N, int D, int LE, int group, void* stream) {
  (void)xq;
  (void)sx;
  if (k < 1 || m < 1 || m >= MX_MAX_M || k * m > MX_MAX_KM || LE < 1)
    return (int)cudaErrorInvalidValue;
  return (int)launch_q4((const float*)x, (const int8_t*)w, (const float*)scale, (const int*)idxs,
                        (float*)y, k, m, shared_x, N, D, LE, group,
                        static_cast<cudaStream_t>(stream));
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

// Bytes of the scratch the tiled route needs for cd(rmsnorm?(x)): bf16 in
// rows of N rounded up to 64 (prep_x_kernel) and the K splits' turn
// counters, or for f32 weights its big and small TF32 parts (f32 each); 0
// where the GEMV route runs (M <= GV_MAX_M and x fits in shared memory)
XQ_EXPORT long long xq_qmatmul_scratch(int M, int N, int w_kind) {
  if (w_kind == W_F32) return use_gemv(M, N, 4) ? 0 : (long long)M * N * 8;
  return use_gemv(M, N, 2) ? 0 : (long long)(gw_x_bytes(M, N) + GW_COUNTERS * 4);
}

// xq_qmatmul's tiled GEMM for x (M, N) by (D, N) weights of w_kind (int8,
// bf16, e4m3 or e5m2) on the current device: plan (7 ints) = {token rows
// a tile, weight rows a tile, tiles along M, tiles along D, K splits,
// stages, blocks}; cudaErrorInvalidValue for a shape it refuses.
// ops/qmatmul.py's gemm_plan is held to it on the card.
XQ_EXPORT int xq_gemm_plan(int M, int N, int D, int w_kind, void* plan) {
  if (w_kind == W_F32 || w_kind < W_I8 || w_kind > W_E5M2) return (int)cudaErrorInvalidValue;
  return gw_plan(M, N, D, w_kind == W_BF16 ? 2 : 1, xq_device_sms(), (int*)plan)
             ? (int)cudaSuccess
             : (int)cudaErrorInvalidValue;
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
