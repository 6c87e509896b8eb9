// Stacked dequant matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel xalm_tpu/ops/pallas_matmul.py::_kernel (through
// pallas_qmatmul_stacked / pallas_qmatmul), i8 and bf16 weights:
//
//     y[m, d] = epi[d] * sum_n bf16(rmsnorm?(x)[m, n]) * W[d, n]
//
// x is f32 (M, N); W is one layer of the stacked (L, D, N) weights, int8 or
// bf16 (the caller offsets the pointer by the layer); epi is the i8 per-row
// f32 scale, the q8 fixed 1/100, or 1. As in the TPU kernel, x is cast to
// bf16 *after* the optional rmsnorm prologue; int8 and bf16 weights are
// exact in bf16, products of two bf16 values are exact in f32, and the sum
// is accumulated in f32; the scale multiplies the f32 result.
//
// What bounds it on the H100:
// - Decode (M <= 8): bytes. Each weight byte is used M times, far below the
//   ~295 operations per byte where the tensor cores would become the limit,
//   so the time is the weight stream over 3.35 TB/s. Design (gemv.cuh,
//   shared with the megakernel): one warp per output row pair, 16-byte
//   weight loads (16 int8 or 8 bf16 per lane per step) with both rows'
//   loads in flight, x normalised once per block into shared memory as
//   bf16, warp-shuffle reductions, scale in the epilogue.
// - Prefill (M up to 512): operations at M >= ~300, bytes below. Design: a
//   first pass writes bf16(rmsnorm?(x)) once (one block per row); then a
//   64x64-output-tile GEMM on bf16 WMMA (mma.sync) tensor-core fragments,
//   int8 weight tiles widened to bf16 in shared memory. Simple and right
//   first: no TMA, no wgmma, no multi-stage pipeline yet.

#include <mma.h>

#include "gemv.cuh"

using namespace nvcuda;

namespace {

constexpr int GV_THREADS = 256;
constexpr int GV_WARPS = GV_THREADS / 32;
constexpr int GV_RPW = 2;  // output rows per warp (xq_gemv2's pair)
constexpr int GV_MAX_M = 8;
constexpr int GV_MAX_SMEM = 160 * 1024;  // the bf16 copy of x held in shared memory

bool use_gemv(int M, int N) { return M <= GV_MAX_M && M * N * 2 <= GV_MAX_SMEM; }

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

template <typename WT>
__global__ void __launch_bounds__(GV_THREADS) gemv_kernel(
    const float* __restrict__ x, const float* __restrict__ norm_w, float eps,
    const WT* __restrict__ w, const float* __restrict__ scale, float qscale,
    float* __restrict__ y, int M, int N, int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // (M, N)
  __shared__ float red[GV_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // prologue: bf16(rmsnorm?(x)) into shared memory, once per block
  for (int m = 0; m < M; ++m) {
    const float* xm = x + (size_t)m * N;
    const float r = norm_w != nullptr ? block_rms(xm, N, eps, red) : 1.f;
    for (int i = tid; i < N; i += GV_THREADS) {
      float v = xm[i];
      if (norm_w != nullptr) v = v * r * norm_w[i];
      xs[(size_t)m * N + i] = __float2bfloat16_rn(v);
    }
  }
  __syncthreads();

  const int row0 = (blockIdx.x * GV_WARPS + warp) * GV_RPW;
  float acc[GV_RPW][GV_MAX_M];
#pragma unroll
  for (int r = 0; r < GV_RPW; ++r)
#pragma unroll
    for (int m = 0; m < GV_MAX_M; ++m) acc[r][m] = 0.f;
  xq_gemv2<WT, GV_MAX_M>(xs, N, row0 < D ? w + (size_t)row0 * N : nullptr,
                         row0 + 1 < D ? w + (size_t)(row0 + 1) * N : nullptr, 0, N, M, lane, acc);

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

// bf16(rmsnorm?(x)) for the tiled path: one block per row
__global__ void __launch_bounds__(256) prep_x_kernel(
    const float* __restrict__ x, const float* __restrict__ norm_w, float eps,
    __nv_bfloat16* __restrict__ xb, int N) {
  __shared__ float red[8];
  const float* xm = x + (size_t)blockIdx.x * N;
  const float r = norm_w != nullptr ? block_rms(xm, N, eps, red) : 1.f;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float v = xm[i];
    if (norm_w != nullptr) v = v * r * norm_w[i];
    xb[(size_t)blockIdx.x * N + i] = __float2bfloat16_rn(v);
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
    // weights: widened to bf16 in shared memory
    if constexpr (sizeof(WT) == 1) {
      const int row = tid >> 1, col = (tid & 1) * 16;  // 64 rows x 2 x 16 bytes
      int4 raw = make_int4(0, 0, 0, 0);
      if (d0 + row < D) raw = __ldg(reinterpret_cast<const int4*>(w + (size_t)(d0 + row) * N + k0 + col));
      const int8_t* p = reinterpret_cast<const int8_t*>(&raw);
      __align__(16) __nv_bfloat16 tmp[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) tmp[e] = __float2bfloat16_rn((float)p[e]);
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

template <typename WT>
int launch_gemv(const float* x, const float* nw, float eps, const WT* w, const float* scale,
                float qscale, float* y, int M, int N, int D, cudaStream_t s) {
  if (M < 1 || M > GV_MAX_M || N % 16 != 0) return (int)cudaErrorInvalidValue;
  const int smem = M * N * (int)sizeof(__nv_bfloat16);
  cudaError_t e = xq_allow_smem(gemv_kernel<WT>, smem);
  if (e != cudaSuccess) return (int)e;
  const int rows_per_block = GV_WARPS * GV_RPW;
  gemv_kernel<WT><<<(D + rows_per_block - 1) / rows_per_block, GV_THREADS, smem, s>>>(
      x, nw, eps, w, scale, qscale, y, M, N, D);
  return (int)cudaGetLastError();
}

template <typename WT>
int launch_gemm(const float* x, const float* nw, float eps, const WT* w, const float* scale,
                float qscale, float* y, __nv_bfloat16* xb, int M, int N, int D, cudaStream_t s) {
  if (M < 1 || N % BK != 0) return (int)cudaErrorInvalidValue;
  prep_x_kernel<<<M, 256, 0, s>>>(x, nw, eps, xb, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 grid((D + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<WT><<<grid, 128, 0, s>>>(xb, w, scale, qscale, y, M, N, D);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 elements of the scratch the tiled route needs for bf16(rmsnorm?(x));
// 0 where the GEMV route runs (M <= GV_MAX_M and x fits in shared memory)
XQ_EXPORT long long xq_qmatmul_scratch(int M, int N) {
  return use_gemv(M, N) ? 0 : (long long)M * N;
}

XQ_EXPORT int xq_qmatmul(const void* x, const void* norm_w, float eps, const void* w,
                         int w_is_bf16, const void* scale, float qscale, void* y, void* xb,
                         int M, int N, int D, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const float* xf = (const float*)x;
  const float* nw = (const float*)norm_w;
  const float* sc = (const float*)scale;
  float* yf = (float*)y;
  if (use_gemv(M, N)) {
    if (w_is_bf16) return launch_gemv(xf, nw, eps, (const __nv_bfloat16*)w, sc, qscale, yf, M, N, D, s);
    return launch_gemv(xf, nw, eps, (const int8_t*)w, sc, qscale, yf, M, N, D, s);
  }
  if (xb == nullptr) return (int)cudaErrorInvalidValue;
  auto* xbb = (__nv_bfloat16*)xb;
  if (w_is_bf16) return launch_gemm(xf, nw, eps, (const __nv_bfloat16*)w, sc, qscale, yf, xbb, M, N, D, s);
  return launch_gemm(xf, nw, eps, (const int8_t*)w, sc, qscale, yf, xbb, M, N, D, s);
}
