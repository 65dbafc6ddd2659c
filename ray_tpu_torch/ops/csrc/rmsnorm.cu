// Fused RMSNorm forward for Hopper (sm_90a).
//
// Replaces ray_tpu/ops/rmsnorm.py:_fwd_kernel (reached through
// _rmsnorm_fwd_2d's pl.pallas_call). Computes, over the last axis of a
// [rows, d] tensor,
//     y = (x * rsqrt(mean(x^2) + eps) * w)   in fp32, cast to y's dtype last,
// with y's dtype = x's dtype (bf16 or fp32) and w of either dtype.
//
// Bound: memory. Each call reads rows*d*bytes(x) + d*bytes(w) and writes
// rows*d*bytes(x); it does ~4 flops per element, far below the card's
// operations-per-byte balance. The design therefore only aims to move
// those bytes once and at full width:
//   - 16-byte vector loads and stores of x and y (8 bf16 or 4 fp32 per
//     thread per access), neighbouring threads on neighbouring addresses;
//   - one block per row for wide rows (the row's sum of squares reduced by
//     warp shuffles, then across warps through shared memory), one warp per
//     row for narrow rows (shuffles only, several rows per block);
//   - the row is read a second time for the scale-and-store pass; that
//     re-read hits L1/L2 (a 3072-wide bf16 row is 6 KB), not device memory;
//   - the ragged end of the row range is masked here (no host-side padding:
//     the TPU's (8, 128) tiling helpers ops/_common.py:pad_rows/pick_block
//     have no counterpart).
// At serving's decode shapes (16 rows of 3072) a call moves ~200 KB and is
// bound by launch latency, not by bytes; see PERF.md.
//
// C interface (loaded with ctypes): rt_rmsnorm_fwd returns cudaGetLastError()
// after the launch, so a refused launch is reported to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerWarpBlock = 4;   // narrow rows: 4 warps, one row each
constexpr int kNarrowVecs = 128;       // <= this many accesses a row: warp/row
constexpr int kMaxThreads = 512;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
// round to nearest even, as torch's .to(torch.bfloat16)
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// VEC: elements per access (16 bytes' worth, or 1 when x/y are not 16-byte
// aligned or d is not a multiple of the vector width).
// WARP_ROW: one warp per row (narrow rows) instead of one block per row.
template <typename XT, typename WT, int VEC, bool WARP_ROW>
__global__ void rmsnorm_fwd_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
                                   XT* __restrict__ y, long long rows, int d, float eps) {
  long long row;
  int tid, nthreads;
  if (WARP_ROW) {
    row = (long long)blockIdx.x * kRowsPerWarpBlock + threadIdx.x / kWarp;
    tid = threadIdx.x % kWarp;
    nthreads = kWarp;
    if (row >= rows) return;  // ragged tail: the whole warp leaves together
  } else {
    row = blockIdx.x;
    tid = threadIdx.x;
    nthreads = blockDim.x;
  }
  const int nvec = d / VEC;
  const Vec<XT, VEC>* xr = reinterpret_cast<const Vec<XT, VEC>*>(x + row * (long long)d);
  Vec<XT, VEC>* yr = reinterpret_cast<Vec<XT, VEC>*>(y + row * (long long)d);

  float ss = 0.f;
  for (int i = tid; i < nvec; i += nthreads) {
    const Vec<XT, VEC> v = xr[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_f(v.v[j]);
      ss += f * f;
    }
  }
  ss = warp_sum(ss);
  if (!WARP_ROW) {
    __shared__ float partial[kMaxThreads / kWarp];
    __shared__ float total;
    const int warp = tid / kWarp;
    if (tid % kWarp == 0) partial[warp] = ss;
    __syncthreads();
    if (warp == 0) {
      const int nwarps = (nthreads + kWarp - 1) / kWarp;
      float t = tid < nwarps ? partial[tid] : 0.f;
      t = warp_sum(t);
      if (tid == 0) total = t;
    }
    __syncthreads();
    ss = total;
  }
  const float scale = rsqrtf(ss / (float)d + eps);

  for (int i = tid; i < nvec; i += nthreads) {
    const Vec<XT, VEC> v = xr[i];
    Vec<XT, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float wf = to_f(w[i * VEC + j]);
      o.v[j] = from_f<XT>(to_f(v.v[j]) * scale * wf);
    }
    yr[i] = o;
  }
}

template <typename XT, typename WT, int VEC>
void launch_vec(const XT* x, const WT* w, XT* y, long long rows, int d, float eps,
                cudaStream_t stream) {
  const int nvec = d / VEC;
  if (nvec <= kNarrowVecs) {
    const long long blocks = (rows + kRowsPerWarpBlock - 1) / kRowsPerWarpBlock;
    rmsnorm_fwd_kernel<XT, WT, VEC, true>
        <<<(unsigned)blocks, kWarp * kRowsPerWarpBlock, 0, stream>>>(x, w, y, rows, d, eps);
  } else {
    int threads = ((nvec + kWarp - 1) / kWarp) * kWarp;
    if (threads > kMaxThreads) threads = kMaxThreads;
    rmsnorm_fwd_kernel<XT, WT, VEC, false>
        <<<(unsigned)rows, threads, 0, stream>>>(x, w, y, rows, d, eps);
  }
}

template <typename XT, typename WT>
cudaError_t launch(const void* x, const void* w, void* y, long long rows, int d, float eps,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(XT);
  const bool aligned = d % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const XT* xp = static_cast<const XT*>(x);
  const WT* wp = static_cast<const WT*>(w);
  XT* yp = static_cast<XT*>(y);
  if (aligned) {
    launch_vec<XT, WT, kVec>(xp, wp, yp, rows, d, eps, stream);
  } else {
    launch_vec<XT, WT, 1>(xp, wp, yp, rows, d, eps, stream);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = ok);
// cudaErrorInvalidValue for a dtype code or size it does not take.
extern "C" int rt_rmsnorm_fwd(const void* x, const void* w, void* y, long long rows, int d,
                              float eps, int x_dtype, int w_dtype, void* stream) {
  if (rows <= 0 || d <= 0 || rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1 && w_dtype == 1) return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, rows, d, eps, s);
  if (x_dtype == 1 && w_dtype == 0) return (int)launch<__nv_bfloat16, float>(x, w, y, rows, d, eps, s);
  if (x_dtype == 0 && w_dtype == 0) return (int)launch<float, float>(x, w, y, rows, d, eps, s);
  if (x_dtype == 0 && w_dtype == 1) return (int)launch<float, __nv_bfloat16>(x, w, y, rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}
