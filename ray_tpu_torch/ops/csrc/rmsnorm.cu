// RMSNorm forward for Hopper (sm_90a), with an optional residual add fused in.
//
// Replaces ray_tpu/ops/rmsnorm.py:_fwd_kernel (reached through
// _rmsnorm_fwd_2d's pl.pallas_call). Computes, over the last axis of a
// [rows, d] tensor,
//     y = (x * rsqrt(mean(x^2) + eps) * w)   in fp32, cast to y's dtype last,
// with y's dtype = x's dtype (bf16 or fp32) and w of either dtype. That is
// the TPU kernel's function when no residual is given.
//
// With a residual delta r (x's shape and dtype) the kernel first forms
//     s = x + r   in fp32, rounded to x's dtype (what the eager `x + r` gives),
// writes s out, and normalises the ROUNDED s. So (s, y) are bit-equal to an
// eager add followed by this kernel without r. In a decoder every norm but
// the first follows a residual add; fusing it removes the add's launch and
// its round trip of s through device memory.
//
// Bound: bytes. A call reads rows*d*bytes(x) (twice that with r) and
// d*bytes(w) and writes rows*d*bytes(x) (twice that with s), at ~4 flops an
// element, far below the card's operations-per-byte balance. At serving's
// decode shape (16 rows of 3072 bf16) that is ~200 KB with no residual,
// ~400 KB with one: 0.06-0.12 us at 3.35 TB/s. That bound is out of reach
// there: 16 blocks on 132 SMs, each a launch plus one load round trip, a
// block reduction and one store, take 1.5-2 us however few bytes they move. A
// decode step runs 2L+1 of them, so the design aims at fewer launches and
// at one trip to memory per launch:
//   - one block per row (row_reduce.cuh, shared with quant.cu); the row's
//     sum of squares reduces by warp shuffles, then across warps through
//     shared memory;
//   - the row in registers: where the block covers the row in one access a
//     thread (up to 512 x 16 bytes: 4096 bf16 or 2048 fp32, the d_model of
//     every bf16 config up to llama3-8b), each thread issues its 16-byte load of
//     x (and r) up front, keeps it for the scale-and-store pass and never
//     reads x again; a wider row takes the general loop, which re-reads the
//     row (from L1/L2) in the second pass;
//   - w as 16-byte vectors, loaded before the reduction, where its dtype
//     and alignment allow; x, r, y, s that are not 16-byte aligned, or a
//     width that is no multiple of the vector, take the scalar path;
//   - no thread-block cluster: a decode row is already one load round trip
//     per thread; splitting it across SMs adds a distributed-shared-memory
//     exchange and removes no round trip;
//   - any row count, with no host-side padding (the TPU's (8, 128) tiling
//     helpers ops/_common.py:pad_rows/pick_block have no counterpart).
// The per-thread sum runs over the same elements in the same order on
// every path that one width and alignment select, with r or without it.
//
// C interface (loaded with ctypes): rt_rmsnorm_fwd returns cudaGetLastError()
// after the launch, so a refused launch is reported to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_reduce.cuh"

namespace {

constexpr int kMaxThreads = 512;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
// round to nearest even, as torch's .to(torch.bfloat16) and its bf16 add
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// s = round(x + r) in place of x, element by element
template <typename XT, int VEC>
__device__ __forceinline__ void add_round(Vec<XT, VEC>& v, const Vec<XT, VEC>& r) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) v.v[j] = from_f<XT>(to_f(v.v[j]) + to_f(r.v[j]));
}

template <typename XT, int VEC>
__device__ __forceinline__ float sum_sq(const Vec<XT, VEC>& v, float ss) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float f = to_f(v.v[j]);
    ss += f * f;
  }
  return ss;
}

template <typename XT, typename WT, int VEC>
__device__ __forceinline__ Vec<XT, VEC> scale_row(const Vec<XT, VEC>& v, const Vec<WT, VEC>& w,
                                                  float scale) {
  Vec<XT, VEC> o;
#pragma unroll
  for (int j = 0; j < VEC; ++j) o.v[j] = from_f<XT>(to_f(v.v[j]) * scale * to_f(w.v[j]));
  return o;
}

// One block per row. VEC: elements per access (16 bytes of x, or 1 on the
// scalar path). HOLD: the block covers the row in one access a thread,
// which stays in registers; else the general loop. RES: r is read and s
// written.
template <typename XT, typename WT, int VEC, bool HOLD, bool RES>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_fwd_kernel(const XT* __restrict__ x, const XT* __restrict__ r, const WT* __restrict__ w,
                   XT* __restrict__ y, XT* __restrict__ s, int d, float eps) {
  using V = Vec<XT, VEC>;
  using W = Vec<WT, VEC>;
  const long long off = (long long)blockIdx.x * d;
  const int nvec = d / VEC;
  const V* xr = reinterpret_cast<const V*>(x + off);
  const V* rr = reinterpret_cast<const V*>(r + off);
  const W* wv = reinterpret_cast<const W*>(w);
  V* yr = reinterpret_cast<V*>(y + off);
  V* sr = reinterpret_cast<V*>(s + off);

  float ss = 0.f;
  if constexpr (HOLD) {
    const int i = threadIdx.x;
    const bool in = i < nvec;
    V v, dv;
    W wk;
    if (in) {
      v = xr[i];
      if constexpr (RES) dv = rr[i];
      wk = wv[i];
      if constexpr (RES) {
        add_round(v, dv);
        sr[i] = v;
      }
      ss = sum_sq(v, ss);
    }
    ss = row_reduce::block_reduce<row_reduce::Sum>(ss);
    const float scale = rsqrtf(ss / (float)d + eps);
    if (in) yr[i] = scale_row(v, wk, scale);
  } else {
    // a row wider than the registers hold: the first pass writes s (each
    // thread rereads only what it wrote), the second rereads the row
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
      V v = xr[i];
      if constexpr (RES) {
        add_round(v, rr[i]);
        sr[i] = v;
      }
      ss = sum_sq(v, ss);
    }
    ss = row_reduce::block_reduce<row_reduce::Sum>(ss);
    const float scale = rsqrtf(ss / (float)d + eps);
    const V* src = RES ? sr : xr;
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) yr[i] = scale_row(src[i], wv[i], scale);
  }
}

template <typename XT, typename WT, int VEC, bool RES>
void launch_vec(const XT* x, const XT* r, const WT* w, XT* y, XT* s, long long rows, int d,
                float eps, cudaStream_t stream) {
  const int nvec = d / VEC;
  const int threads = row_reduce::row_threads(nvec, kMaxThreads);
  const dim3 grid((unsigned)rows);
  if (nvec <= threads) {
    rmsnorm_fwd_kernel<XT, WT, VEC, true, RES><<<grid, threads, 0, stream>>>(x, r, w, y, s, d, eps);
  } else {
    rmsnorm_fwd_kernel<XT, WT, VEC, false, RES><<<grid, threads, 0, stream>>>(x, r, w, y, s, d, eps);
  }
}

inline bool aligned_to(const void* p, size_t n) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % n == 0;
}

template <typename XT, typename WT>
cudaError_t launch(const void* x, const void* r, const void* w, void* y, void* s,
                   long long rows, int d, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(XT);
  const bool vec = d % kVec == 0 && aligned_to(x, 16) && aligned_to(r, 16) &&
                   aligned_to(y, 16) && aligned_to(s, 16) && aligned_to(w, sizeof(WT) * kVec);
  const XT* xp = static_cast<const XT*>(x);
  const XT* rp = static_cast<const XT*>(r);
  const WT* wp = static_cast<const WT*>(w);
  XT* yp = static_cast<XT*>(y);
  XT* sp = static_cast<XT*>(s);
  if (r != nullptr) {
    if (vec) launch_vec<XT, WT, kVec, true>(xp, rp, wp, yp, sp, rows, d, eps, stream);
    else launch_vec<XT, WT, 1, true>(xp, rp, wp, yp, sp, rows, d, eps, stream);
  } else {
    if (vec) launch_vec<XT, WT, kVec, false>(xp, rp, wp, yp, sp, rows, d, eps, stream);
    else launch_vec<XT, WT, 1, false>(xp, rp, wp, yp, sp, rows, d, eps, stream);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. r and s are both null (y = the
// norm of x) or both set (s = x + r, y = the norm of s). Returns a
// cudaError_t (0 = ok); cudaErrorInvalidValue for a dtype code, size or
// residual pairing it does not take.
extern "C" int rt_rmsnorm_fwd(const void* x, const void* r, const void* w, void* y, void* s,
                              long long rows, int d, float eps, int x_dtype, int w_dtype,
                              void* stream) {
  if (rows <= 0 || d <= 0 || rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if ((r == nullptr) != (s == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1 && w_dtype == 1) return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, r, w, y, s, rows, d, eps, st);
  if (x_dtype == 1 && w_dtype == 0) return (int)launch<__nv_bfloat16, float>(x, r, w, y, s, rows, d, eps, st);
  if (x_dtype == 0 && w_dtype == 0) return (int)launch<float, float>(x, r, w, y, s, rows, d, eps, st);
  if (x_dtype == 0 && w_dtype == 1) return (int)launch<float, __nv_bfloat16>(x, r, w, y, s, rows, d, eps, st);
  return (int)cudaErrorInvalidValue;
}
