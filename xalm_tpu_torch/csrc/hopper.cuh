// Hopper (sm_90a) building blocks of the TMA-fed kernels: the tiled GEMM of
// int8, fp8 and bf16 weights, the W8A8 GEMM, the split-TF32 f32 GEMM and
// the streamed M <= 8 GEMV (qmatmul.cu gemm_bf16w_kernel, gemm_a8_kernel,
// gemm_tf32x3_kernel, gemv_stream_kernel), the causal flash prefill over a
// bf16 and an f32 cache and the cluster flash-decode (attention.cu
// flash_prefill_kernel, flash_prefill_tf32x3_kernel,
// flash_decode_cluster_kernel), and the megakernel's L2 prefetch of its
// weight rows (fused_decode.cu).
//
// - TMA: a tensor map (CUtensorMap, encoded on the host per call by
//   cuTensorMapEncodeTiled, which xq_tensor_map obtains from the driver
//   through cudaGetDriverEntryPoint[ByVersion]: no -lcuda at link time)
//   names a 2-D or 3-D global tensor and a box; one thread asks for a box
//   to be copied into shared memory (cp.async.bulk.tensor), and the copy
//   reports its bytes to an mbarrier. Every map here but the tiled GEMM's
//   one-byte weights uses the 128-byte swizzle: a box row is 128 bytes
//   (128 int8, 64 bf16 or 32 f32) and the 16-byte chunk c of row r lands
//   at chunk c ^ (r % 8) within its 1024-byte group of 8 rows. Elements
//   outside the tensor read as zero.
// - 1-D bulk copy (cp.async.bulk, xq_bulk_g2s): one thread asks for a
//   contiguous run of bytes (a multiple of 16, both ends 16-byte aligned)
//   to be copied from global into shared memory, reported to an mbarrier
//   like a TMA box; no tensor map, no swizzle.
// - mbarrier ring: full[s] completes when stage s's bytes have landed (one
//   arrive.expect_tx by the producer, then the copies' bytes), empty[s]
//   when every consumer warp has released it; a waiter passes once the
//   phase of the given parity has completed (round r waits parity r & 1).
// - wgmma: a warpgroup (4 warps, 128 threads) multiplies a 64-row A tile
//   (shared memory or registers) by a B tile in shared memory into
//   registers, asynchronously (fence, issue, commit, wait). Accumulator
//   element j of thread t (warp w = t / 32 of the warpgroup, lane l) is
//   row 16 w + l / 4 + 8 ((j / 2) % 2), column 8 (j / 4) + 2 (l % 4) + j % 2.
//   A shared-memory operand is described by a 64-bit descriptor: start
//   address, the two byte offsets and the swizzle mode (xq_desc).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t xq_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte aligned address at or after p in shared memory (the
// 128-byte swizzle repeats every 1024 bytes; a tile must start on one)
__device__ __forceinline__ unsigned char* xq_align1024(unsigned char* p) {
  return p + ((1024u - (xq_smem(p) & 1023u)) & 1023u);
}

// ------------------------------------------------------------- mbarrier

__device__ __forceinline__ void xq_mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(xq_smem(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void xq_mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// the producer's arrival, announcing the bytes the stage's copies bring
__device__ __forceinline__ void xq_mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(xq_smem(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void xq_mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(xq_smem(bar)) : "memory");
}

__device__ __forceinline__ bool xq_mbar_try(uint32_t addr, int parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// SM cycles (about 10 s) after which a wait traps: a stage that never
// completes is a fault, reported as a launch error instead of a hung card
constexpr long long XQ_MBAR_TIMEOUT_CYCLES = 1ll << 34;

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void xq_mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = xq_smem(bar);
  if (xq_mbar_try(a, parity)) return;
  const long long t0 = clock64();
  while (!xq_mbar_try(a, parity))
    if (clock64() - t0 > XQ_MBAR_TIMEOUT_CYCLES) __trap();
}

// the thread-block cluster's barrier in two halves: arrive with no
// ordering (only that this thread has started: a block's shared memory may
// be written by its peers once they have all arrived), and wait (acquire)
__device__ __forceinline__ void xq_cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void xq_cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// two floats rounded to bf16 and packed, lo in the low half (the order of
// a wgmma register operand's pair)
__device__ __forceinline__ uint32_t xq_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------------------------------------ TMA

__device__ __forceinline__ void xq_tma_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(xq_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(xq_smem(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void xq_tma_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                          int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(xq_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(xq_smem(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, its bytes reported to bar (expected there by xq_mbar_expect_tx)
__device__ __forceinline__ void xq_bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(xq_smem(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(xq_smem(bar))
      : "memory");
}

// a hint: `bytes` (a multiple of 16) of global memory from src (16-byte
// aligned) brought into L2 by the bulk-copy engine, no shared memory and no
// barrier (the megakernel's weight rows ahead of a grid barrier)
__device__ __forceinline__ void xq_prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(reinterpret_cast<uint64_t>(src)),
               "r"(bytes)
               : "memory");
}

// ---------------------------------------------------------------- wgmma

// Descriptor of a tile laid out by the 128-byte swizzle (a TMA box, or
// written by hand in the same pattern), starting at `addr` (1024-aligned at
// the tile, plus 32-byte steps along a K-major row). K-major: sbo 1024 (the
// next 8 rows), lbo unused. MN-major: lbo is the byte stride between
// 64-element column panels, sbo 1024 (the next 8 rows along K).
__device__ __forceinline__ uint64_t xq_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void xq_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void xq_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void xq_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma region
template <int N>
__device__ __forceinline__ void xq_fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void xq_fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// a barrier of the `count` threads that use barrier `id` (1..15; 0 is
// __syncthreads')
__device__ __forceinline__ void xq_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// orders this thread's generic-proxy writes to shared memory before later
// async-proxy reads of them (wgmma reading a tile the threads wrote)
__device__ __forceinline__ void xq_fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// D (64 x 128, s32) += A (64 x 32, s8, K-major) * B (128 x 32, s8, K-major), both in
// shared memory (descriptors); exact integer sums
__device__ __forceinline__ void xq_wgmma_s8_ss_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "
      "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16, K-major) * B (64 x 16, bf16, K-major), both in
// shared memory (descriptors)
__device__ __forceinline__ void xq_wgmma_bf16_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 96, f32) += A (64 x 16, bf16, in registers: a[4], the layout of an
// m64n16 accumulator) * B (16 x 96, bf16, MN-major in shared memory: trans-b)
__device__ __forceinline__ void xq_wgmma_bf16_rs_n96(float (&d)[48], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16, in registers: a[4], the layout of an
// m64n16 accumulator) * B (16 x 128, bf16, MN-major in shared memory: trans-b)
__device__ __forceinline__ void xq_wgmma_bf16_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "
      "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256, f32) += A (64 x 16, bf16, in registers: a[4], the layout of an
// m64n16 accumulator) * B (16 x 256, bf16, MN-major in shared memory: trans-b)
__device__ __forceinline__ void xq_wgmma_bf16_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "
      "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, "
      "%65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, "
      "%81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, "
      "%97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x N, f32) = A (64 x 16, bf16, in registers: a[4], the layout of an
// m64n16 accumulator) * B (N x 16, bf16, K-major in shared memory: no
// transpose) + D, or without D where acc is 0; N = 16, 32, 64 or 128
template <int N>
__device__ __forceinline__ void xq_wgmma_bf16_rs_kmajor(float (&d)[N / 2], const uint32_t (&a)[4],
                                                       uint64_t db, int acc) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "wgmma widths of the tiled GEMM");
  if constexpr (N == 16) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  } else if constexpr (N == 32) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  } else if constexpr (N == 64) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  } else if constexpr (N == 128) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
}

// ------------------------------------------------------------ split TF32
//
// The tensor cores take f32 operands only as TF32: sign, exponent and the
// top 10 of the 23 mantissa bits. The card reads a raw f32 operand by
// dropping the low 13 bits (truncation toward zero, in wgmma and mma.sync
// alike: test_tensor_cores_read_tf32_by_truncation of
// tests/test_torch_cuda.py, through xq_tf32_probe), so a raw f32 value,
// in registers or in a TMA-landed tile, is its own big part. Split TF32
// (CUTLASS's 3xTF32) writes x = big + small and sums small_a big_b +
// big_a small_b + big_a big_b on the tensor cores in f32, smallest first:
// the dropped small_a small_b and the truncation of small cost at most
// about 2^-18 of |a b| a product, where one TF32 product costs up to 2^-9.
// Measured against f64 on an H100 (chip_smoke.py --kernel-ms, Mistral-7B
// and Gemma-7B shapes): the f32 GEMM's rows within 1.1-1.7e-6 of their max
// (cuBLAS f32: 2.0-4.2e-6), the f32-cache prefill's within 2.5-3.5e-6 (the
// plain f32 version's: 1.7-3.4e-6).
//
// The tensor cores' f32 sums are not IEEE: each wgmma or mma.sync step
// loses about half an ulp of its accumulator, always toward zero, so the
// error of a long chain grows with its length, not its square root (the
// first H100 runs of the f32 GEMM, one chain over K: 1.0e-5 of a row's
// max at K = 1024, 4.5e-5 at 4096, 1.4e-4 at 14336). The kernels therefore
// sum at most 24 steps a chain into a fresh accumulator and add chains
// with IEEE adds.

// x as the tensor core reads a raw f32 operand (the low 13 bits dropped)
__device__ __forceinline__ float xq_tf32_trunc(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// x = big + small: big the raw bits (read as trunc(x)), small = x -
// trunc(x), exact in f32 (its own low bits dropped in turn when read)
__device__ __forceinline__ void xq_tf32_split(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x);
  small = __float_as_uint(x - xq_tf32_trunc(x));
}

// D (64 x 128, f32) = A (64 x 8, tf32, K-major) * B (128 x 8, tf32, K-major) + D, or
// without D where acc is 0; both in shared memory (descriptors). TF32
// wgmma has no transpose: both operands K-major.
__device__ __forceinline__ void xq_wgmma_tf32_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                                      int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "
      "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// D (16 x 8, f32) += A (16 x 8, tf32) * B (8 x 8, tf32), one warp, in registers:
// lane l holds a = A(l/4, l%4), A(l/4 + 8, l%4), A(l/4, l%4 + 4), A(l/4 + 8, l%4 + 4);
// b0 = B(l%4, l/4), b1 = B(l%4 + 4, l/4); d = D(l/4, 2 (l%4)), D(l/4, 2 (l%4) + 1),
// D(l/4 + 8, 2 (l%4)), D(l/4 + 8, 2 (l%4) + 1)
__device__ __forceinline__ void xq_mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The three split-TF32 products of one m16n8k8 step into d, smallest first
__device__ __forceinline__ void xq_mma_tf32x3(float (&d)[4], const uint32_t (&ab)[4],
                                              const uint32_t (&as)[4], uint32_t bb0, uint32_t bb1,
                                              uint32_t bs0, uint32_t bs1) {
  xq_mma_tf32(d, as, bb0, bb1);
  xq_mma_tf32(d, ab, bs0, bs1);
  xq_mma_tf32(d, ab, bb0, bb1);
}

// 16-byte chunk c of row r of a 128-byte-swizzled tile (a TMA box of 32 f32
// a row) lies at chunk c ^ (r % 8): the byte offset of element (r, col),
// col < 32
__device__ __forceinline__ int xq_sw128_f32(int r, int col) {
  return r * 128 + ((((col >> 2) ^ r) & 7) << 4) + (col & 3) * 4;
}


// ----------------------------------------------------------- host side

// cuTensorMapEncodeTiled's signature (cuda.h), reached through the runtime
// so that the libraries need not link the driver library
typedef CUresult (*XqEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static XqEncodeTiled xq_encode_tiled() {
  static XqEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (XqEncodeTiled)p;
  }
  return fn;
}

// A tensor map of a rank-2 or rank-3 row-major tensor: dims innermost first
// (elements), strides[i] the byte stride of dimension i + 1, box the tile
// (elements; box[0] * element bytes = 128, the swizzle span, unless the
// map is unswizzled: then a multiple of 16). Zero fill outside the tensor.
// False if the driver refuses it.
static bool xq_tensor_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* ptr,
                          const uint64_t* dims, const uint64_t* strides, const uint32_t* box,
                          CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  XqEncodeTiled encode = xq_encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t d[3], s[2];
  cuuint32_t b[3], e[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    if (i + 1 < rank) s[i] = strides[i];
  }
  return encode(map, type, (cuuint32_t)rank, const_cast<void*>(ptr), d, s, b, e,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
