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
// f32 weights (f32 products and sums: FMA on the CUDA cores, never TF32,
// which keeps about three digits).
//
// What bounds it on the H100:
// - Decode (M <= 8): bytes. Each weight byte is used M times, far below the
//   ~295 operations per byte where the tensor cores would become the limit,
//   so the time is the weight stream over 3.35 TB/s. Design (gemv.cuh,
//   shared with the megakernel): one warp per output row pair, 16-byte
//   weight loads (16 int8 or 8 bf16 per lane per step) with both rows'
//   loads in flight, x normalised once per block into shared memory as
//   bf16, warp-shuffle reductions, scale in the epilogue. fp8 rows are 16
//   codes a 16-byte load, the int8 rows' stream; the widening (8 cvt
//   instructions a load) stays under the byte rate.
// - Prefill (M up to 512): operations at M >= ~300, bytes below. Design: a
//   first pass writes bf16(rmsnorm?(x)) once (one block per row); then a
//   64x64-output-tile GEMM on bf16 WMMA (mma.sync) tensor-core fragments,
//   int8 weight tiles widened to bf16 in shared memory. Simple and right
//   first: no TMA, no wgmma, no multi-stage pipeline yet.
// - f32 weights: the GEMV route stages x as f32 (4N bytes a row: 57 KB at
//   N = 14336, past the 48 KB that needs the opt-in) and streams 4 weights
//   per 16-byte load; at M = 1 it is bound by the 4-byte weights. Where x
//   does not fit (or M > 8) a tiled f32 GEMM runs, bound by operations at
//   M = 512 (67 TFLOP/s of f32 FMA): 128x128 outputs a block of 256
//   threads, 8x8 a thread in registers, k-slices of 8 staged in shared
//   memory (transposed, so each thread reads its 8 x and 8 w values as two
//   16-byte words each). Simple first: no double buffering yet.
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
// xq_qmatmul_a8 (W8A8, the 512-row prefill chunks): bound by operations at
// M = 512 (1979 dense s8 TOP/s). Design: a 64x64-output-tile GEMM on s8
// WMMA fragments (16x16x16, int32 accumulators: K * 127^2 = 2.3e8 < 2^31
// at K = 14336, exact), tiles staged in shared memory as 16-column slices
// so each fragment starts 32-byte aligned; the epilogue turns the sum to
// f32, multiplies by the weight's row scale (or the q8 1/100) and then by
// x's row scale, each rounded on its own: bit-equal to the plain version.
// Simple first, like the bf16 GEMM: no TMA, no wgmma, no pipelining.

#include <math.h>
#include <mma.h>

#include "gemv.cuh"

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

constexpr int SBM = 128, SBN = 128, SBK = 8;  // f32 GEMM tile: x rows, outputs, depth

// y[m, d] = sum_n x[m, n] * w[d, n] in f32 (no scale: f32 weights carry none)
__global__ void __launch_bounds__(256) sgemm_kernel(const float* __restrict__ x,
                                                    const float* __restrict__ w,
                                                    float* __restrict__ y, int M, int N, int D) {
  __shared__ __align__(16) float As[SBK][SBM];  // k-slice, x row
  __shared__ __align__(16) float Bs[SBK][SBN];  // k-slice, weight row
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // 16 x 16 threads, 8 x 8 outputs each
  const int m0 = blockIdx.y * SBM, d0 = blockIdx.x * SBN;
  const int lr = tid >> 1, lk = (tid & 1) * 4;  // each thread loads 4 depths of one row a side
  const float* xrow = m0 + lr < M ? x + (size_t)(m0 + lr) * N + lk : nullptr;
  const float* wrow = d0 + lr < D ? w + (size_t)(d0 + lr) * N + lk : nullptr;
  float acc[8][8] = {};
  for (int k0 = 0; k0 < N; k0 += SBK) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (xrow != nullptr) a = *reinterpret_cast<const float4*>(xrow + k0);
    if (wrow != nullptr) b = __ldg(reinterpret_cast<const float4*>(wrow + k0));
    As[lk + 0][lr] = a.x; As[lk + 1][lr] = a.y; As[lk + 2][lr] = a.z; As[lk + 3][lr] = a.w;
    Bs[lk + 0][lr] = b.x; Bs[lk + 1][lr] = b.y; Bs[lk + 2][lr] = b.z; Bs[lk + 3][lr] = b.w;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SBK; ++kk) {
      // rows ty*4.. and 64 + ty*4.., outputs tx*4.. and 64 + tx*4..
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = d0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (d < D) y[(size_t)m * D + d] = acc[i][j];
    }
  }
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

template <typename WT>
int launch_gemm(const float* x, const float* nw, float eps, const WT* w, const float* scale,
                float qscale, float* y, void* xb, int M, int N, int D, cudaStream_t s) {
  if (M < 1 || N % BK != 0) return (int)cudaErrorInvalidValue;
  using XT = xq_act_t<WT>;
  prep_x_kernel<XT><<<M, 256, 0, s>>>(x, nw, eps, (XT*)xb, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if constexpr (sizeof(WT) == 4) {
    dim3 grid((D + SBN - 1) / SBN, (M + SBM - 1) / SBM);
    sgemm_kernel<<<grid, 256, 0, s>>>((const float*)xb, w, y, M, N, D);
  } else {
    dim3 grid((D + BN - 1) / BN, (M + BM - 1) / BM);
    gemm_kernel<WT><<<grid, 128, 0, s>>>((const __nv_bfloat16*)xb, w, scale, qscale, y, M, N, D);
  }
  return (int)cudaGetLastError();
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

constexpr int AM = 64, AN = 64, AK = 64;  // W8A8 tile: x rows, output columns, depth
constexpr int AKS = AK / 16;               // 16-column slices of a tile
constexpr int LDC8 = AN + 4;

__global__ void __launch_bounds__(128) gemm_a8_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ sx, const int8_t* __restrict__ w,
    const float* __restrict__ scale, float qscale, float* __restrict__ y, int M, int N, int D) {
  __shared__ __align__(128) signed char As[AKS][AM][16];  // slice, x row, 16 codes
  __shared__ __align__(128) signed char Bs[AKS][AN][16];  // slice, weight row, 16 codes
  __shared__ __align__(128) int Cs[AM * LDC8];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 2x2 warps, 32x32 outputs each
  const int m0 = blockIdx.y * AM, d0 = blockIdx.x * AN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  for (int k0 = 0; k0 < N; k0 += AK) {
    for (int c = tid; c < AM * AKS; c += 128) {  // 64 rows x 4 slices of 16 bytes, each side
      const int row = c / AKS, ks = c % AKS;
      int4 v = make_int4(0, 0, 0, 0);
      if (m0 + row < M) v = *reinterpret_cast<const int4*>(xq + (size_t)(m0 + row) * N + k0 + ks * 16);
      *reinterpret_cast<int4*>(&As[ks][row][0]) = v;
      int4 u = make_int4(0, 0, 0, 0);
      if (d0 + row < D) u = __ldg(reinterpret_cast<const int4*>(w + (size_t)(d0 + row) * N + k0 + ks * 16));
      *reinterpret_cast<int4*>(&Bs[ks][row][0]) = u;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < AKS; ++ks) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], &As[ks][wm * 32 + i * 16][0], 16);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], &Bs[ks][wn * 32 + j * 16][0], 16);
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
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC8 + wn * 32 + j * 16, acc[i][j], LDC8,
                              wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < AM * AN; idx += 128) {
    const int r = idx / AN, c = idx % AN;
    const int m = m0 + r, d = d0 + c;
    if (m < M && d < D) {
      float v = (float)Cs[r * LDC8 + c];
      if (scale != nullptr) v = __fmul_rn(v, scale[d]);
      else if (qscale != 0.f) v = __fmul_rn(v, qscale);
      y[(size_t)m * D + d] = __fmul_rn(v, sx[m]);
    }
  }
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

// W8A8 matmul: x (M, N) f32, w one layer's (D, N) int8 rows, scale its (D)
// f32 row scales or null (then qscale, or 1 where qscale is 0), xq/sx
// scratch as above, y (M, D) f32.
XQ_EXPORT int xq_qmatmul_a8(const void* x, const void* w, const void* scale, float qscale,
                            void* xq, void* sx, void* y, int M, int N, int D, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (M < 1 || D < 1 || N < AK || N % AK != 0) return (int)cudaErrorInvalidValue;
  auto* codes = (int8_t*)xq;
  auto* rs = (float*)sx;
  quant_x_kernel<<<M, 256, 0, s>>>((const float*)x, codes, rs, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 grid((D + AN - 1) / AN, (M + AM - 1) / AM);
  gemm_a8_kernel<<<grid, 128, 0, s>>>(codes, rs, (const int8_t*)w, (const float*)scale, qscale,
                                      (float*)y, M, N, D);
  return (int)cudaGetLastError();
}

// The weight types of kernels 1 and 8, as the wrappers pass them
enum WKind { W_I8 = 0, W_BF16 = 1, W_F32 = 2, W_E4M3 = 3, W_E5M2 = 4 };

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

// Bytes of the scratch the tiled route needs for cd(rmsnorm?(x)) (bf16, or
// f32 for f32 weights); 0 where the GEMV route runs (M <= GV_MAX_M and x
// fits in shared memory)
XQ_EXPORT long long xq_qmatmul_scratch(int M, int N, int w_kind) {
  const int xbytes = w_kind == W_F32 ? 4 : 2;
  return use_gemv(M, N, xbytes) ? 0 : (long long)M * N * xbytes;
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
    if (w_kind == W_BF16) return launch_gemv(xf, nw, eps, (const __nv_bfloat16*)w, sc, qscale, yf, M, N, D, s);
    if (w_kind == W_F32) return launch_gemv(xf, nw, eps, (const float*)w, sc, qscale, yf, M, N, D, s);
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
