// Hopper (sm_90a) building blocks shared by the attention kernels
// (flash_attention_fwd.cu, flash_attention.cu): mbarriers, TMA copies and
// the tensor maps they read, wgmma with its shared-memory descriptors, and
// the bf16 packing and exp2 that the softmax steps use.
//
// Tiles live in shared memory 128-byte swizzled, as [rows][64 bf16] halves
// (a swizzled TMA box is at most 128 bytes wide), each half 1024-byte
// aligned; a D 128 row is two halves, rows * 128 bytes apart.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// Shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// arrive once and expect `bytes` of TMA transactions in this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// until the phase of parity `parity` has completed; a wait of more than
// ~2^34 cycles (seconds) traps, so a lost arrival faults the launch instead
// of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// one box from shared memory into a 4-D tensor map (rows past the map's
// extent are not written), as a bulk async-group of this thread
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit_and_wait_read() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory, before an async-proxy (TMA) read
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a named barrier over the 128 threads of one warpgroup (id 0 is
// __syncthreads)
__device__ __forceinline__ void bar_sync_wg(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(128) : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving register reads or writes across an
// asynchronous wgmma: each register "changes" here.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle. K-major tiles: 8-row
// groups 1024 bytes apart (SBO), the leading offset unused. MN-major tiles
// (a B read through the transpose bit): `lbo` is the distance between
// 64-column halves.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

#define RT_D8(i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64x128] (+)= A[64x16] B[16x128], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : RT_D8(0), RT_D8(8), RT_D8(16), RT_D8(24), RT_D8(32), RT_D8(40), RT_D8(48), RT_D8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64x64] (+)= A[64x16] B[16x64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : RT_D8(0), RT_D8(8), RT_D8(16), RT_D8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64x128] += A[64x16] B[16x128], A in registers, B MN-major in shared
// memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : RT_D8(0), RT_D8(8), RT_D8(16), RT_D8(24), RT_D8(32), RT_D8(40), RT_D8(48), RT_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64x64] += A[64x16] B[16x64], as above
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RT_D8(0), RT_D8(8), RT_D8(16), RT_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef RT_D8

// d[64 x D] += A[64 x 16] B[16 x D] for D 64 or 128, B MN-major
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 128) {
    wgmma_rs_n128(d, a, db);
  } else {
    wgmma_rs_n64(d, a, db);
  }
}

// 2^x on the special-function unit, subnormal results flushed to 0 (a P
// below 2^-126 adds nothing to a bf16 product)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// An m64nN accumulator as the A operand of a product over its N columns,
// packed to bf16 in place: k16 step i is columns 16i..16i+15, the
// accumulator's n8 blocks 2i and 2i + 1 (the accumulator and the A fragment
// share a layout).
template <int N>
__device__ __forceinline__ void pack_a(const float (&s)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int i = 0; i < N / 16; ++i) {
    a[i][0] = pack_bf16(s[8 * i], s[8 * i + 1]);
    a[i][1] = pack_bf16(s[8 * i + 2], s[8 * i + 3]);
    a[i][2] = pack_bf16(s[8 * i + 4], s[8 * i + 5]);
    a[i][3] = pack_bf16(s[8 * i + 6], s[8 * i + 7]);
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps
// ---------------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no
// -lcuda).
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A [B, T, heads, D] bf16 tensor with strides s (elements; [b, t, head])
// as a 4-D map (D, heads, T, B) with boxes of 64 columns x 1 head x `rows`
// x 1 batch, 128-byte swizzled; rows past T read as zeros and are not
// written. A dimension of extent 1 gets its packed stride (its own may be
// anything).
inline CUresult make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, const long long* s,
                         int B, int T, int heads, int D, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)T, (cuuint64_t)B};
  const long long packed[3] = {(long long)D, (long long)D * heads, (long long)D * heads * T};
  const long long elems[3] = {s[2], s[1], s[0]};  // heads, T, B
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = (cuuint64_t)(dims[i + 1] == 1 ? packed[i] : elems[i]) * sizeof(bf16);
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The SMs of the current device, for a persistent grid.
inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

}  // namespace hopper
