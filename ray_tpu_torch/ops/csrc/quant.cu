// Per-row absmax int8 quantize and dequantize for Hopper (sm_90a).
//
// Replaces ray_tpu/ops/quant.py:_quant_kernel (reached through
// quantize_int8's pl.pallas_call) and :_dequant_kernel (through
// dequantize_int8's). For a [rows, cols] matrix:
//     scale[r] = max(absmax(x[r, :]), 1e-8) * fp32(1/127)
//     q[r, c]  = clamp(round_half_even(x[r, c] / scale[r]), -127, 127)
//     out[r, c] = fp32(q[r, c]) * scale[r], rounded once to out's dtype.
// The scale multiplies by the constant 1/127, as XLA compiles the
// reference's `/ 127.0`; `x / scale` is a true IEEE division (this file is
// built without --use_fast_math and uses no __fdividef or reciprocal), and
// __float2int_rn rounds half to even as jnp.round does. The absmax carries a
// NaN through, as jnp.max does (a NaN row gets a NaN scale and q 0; an inf
// row an inf scale). So q and scales are bit-equal to the reference's, and
// the output too.
//
// Bound: memory. Quantize reads rows*cols*in_bytes and writes rows*cols +
// 4*rows bytes; dequantize reads rows*cols + 4*rows and writes
// rows*cols*out_bytes. Both do a few operations per element, far below the
// card's operations-per-byte balance. The design only aims to move those
// bytes once and at full width:
//   - quantize: one block per row; the row's absmax is reduced by warp
//     shuffles, then across warps through shared memory (row_reduce.cuh).
//     A second pass over the row divides, rounds, clamps and stores int8;
//     its re-read of the row (6-16 KB at the model's widths) comes from
//     L1/L2, not device memory;
//   - dequantize: one block per row too, so the row's scale is read once
//     and no thread divides to find its row; 16 int8 values per thread
//     from one 16-byte load, 16 outputs stored with 16-byte stores;
//   - a thread handles 16 consecutive elements when the row width is a
//     multiple of 16 and the pointers are 16-byte aligned (16-byte loads of
//     the input and one 16-byte store of int8), else one element at a time;
//   - any row count: the TPU's row padding (ops/_common.py:pad_rows,
//     pick_block) has no counterpart here.
//
// C interface (loaded with ctypes): each entry point returns
// cudaGetLastError() after its launch, so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_reduce.cuh"

namespace {

constexpr int kGroup = 16;  // elements per thread on the 16-byte path
constexpr int kMaxThreads = 256;
constexpr float kScaleFloor = 1e-8f;
constexpr float kInv127 = 1.0f / 127.0f;  // fp32(1/127), folded at compile time

// Element types as raw bits: loads and stores move words, and the
// conversions are the intrinsics (round to nearest even on the way out).
struct F32 {
  using Raw = uint32_t;
  static __device__ __forceinline__ float to_f(Raw r) { return __uint_as_float(r); }
  static __device__ __forceinline__ Raw from_f(float v) { return __float_as_uint(v); }
};
struct BF16 {
  using Raw = uint16_t;
  static __device__ __forceinline__ float to_f(Raw r) { return __uint_as_float((uint32_t)r << 16); }
  static __device__ __forceinline__ Raw from_f(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};
struct F16 {
  using Raw = uint16_t;
  static __device__ __forceinline__ float to_f(Raw r) { return __half2float(__ushort_as_half(r)); }
  static __device__ __forceinline__ Raw from_f(float v) { return __half_as_ushort(__float2half_rn(v)); }
};

// G consecutive elements at p as floats: G = 16 with sizeof(Raw) 16-byte
// loads (p 16-byte aligned), or G = 1.
template <typename D, int G>
__device__ __forceinline__ void load_elems(const typename D::Raw* p, float (&f)[G]) {
  using Raw = typename D::Raw;
  if constexpr (G == 1) {
    f[0] = D::to_f(p[0]);
  } else {
    static_assert(G == kGroup, "vector path moves 16 elements");
    constexpr int kPerWord = 4 / sizeof(Raw);
    const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < (int)sizeof(Raw); ++i) {
      const uint4 u = v[i];
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int k = 0; k < kPerWord; ++k) {
          f[(i * 4 + j) * kPerWord + k] = D::to_f((Raw)(w[j] >> (16 * k)));
        }
      }
    }
  }
}

template <typename D, int G>
__device__ __forceinline__ void store_elems(typename D::Raw* p, const float (&f)[G]) {
  using Raw = typename D::Raw;
  if constexpr (G == 1) {
    p[0] = D::from_f(f[0]);
  } else {
    constexpr int kPerWord = 4 / sizeof(Raw);
    uint4* v = reinterpret_cast<uint4*>(p);
#pragma unroll
    for (int i = 0; i < (int)sizeof(Raw); ++i) {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[j] = 0;
#pragma unroll
        for (int k = 0; k < kPerWord; ++k) {
          w[j] |= (uint32_t)D::from_f(f[(i * 4 + j) * kPerWord + k]) << (16 * k);
        }
      }
      v[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

template <int G>
__device__ __forceinline__ void load_int8(const int8_t* p, float (&f)[G]) {
  if constexpr (G == 1) {
    f[0] = (float)p[0];
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int b = (int)((w[j] >> (8 * k)) & 0xffu);
        f[j * 4 + k] = (float)(b >= 128 ? b - 256 : b);
      }
    }
  }
}

template <int G>
__device__ __forceinline__ void store_int8(int8_t* p, const int (&q)[G]) {
  if constexpr (G == 1) {
    p[0] = (int8_t)q[0];
  } else {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[j] = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) w[j] |= ((uint32_t)q[j * 4 + k] & 0xffu) << (8 * k);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// One block per row. G: elements per access (kGroup or 1).
template <typename D, int G>
__global__ void quantize_kernel(const typename D::Raw* __restrict__ x, int8_t* __restrict__ q,
                                float* __restrict__ scales, int cols) {
  using row_reduce::MaxNaN;
  const long long row = blockIdx.x;
  const int ngroups = cols / G;
  const typename D::Raw* xr = x + row * (long long)cols;
  int8_t* qr = q + row * (long long)cols;

  float m = MaxNaN::identity();
  for (int g = threadIdx.x; g < ngroups; g += blockDim.x) {
    float f[G];
    load_elems<D, G>(xr + g * G, f);
#pragma unroll
    for (int j = 0; j < G; ++j) m = MaxNaN::op(m, fabsf(f[j]));
  }
  m = row_reduce::block_reduce<MaxNaN>(m);
  const float scale = MaxNaN::op(m, kScaleFloor) * kInv127;
  if (threadIdx.x == 0) scales[row] = scale;

  for (int g = threadIdx.x; g < ngroups; g += blockDim.x) {
    float f[G];
    load_elems<D, G>(xr + g * G, f);
    int v[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      // IEEE division, ties to even; a NaN converts to 0
      const int r = __float2int_rn(f[j] / scale);
      v[j] = min(max(r, -127), 127);
    }
    store_int8<G>(qr + g * G, v);
  }
}

// One block per row. G: elements per access (kGroup or 1).
template <typename D, int G>
__global__ void dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
                                  typename D::Raw* __restrict__ out, int cols) {
  const long long row = blockIdx.x;
  const int ngroups = cols / G;
  const int8_t* qr = q + row * (long long)cols;
  typename D::Raw* outr = out + row * (long long)cols;
  const float s = scales[row];
  for (int g = threadIdx.x; g < ngroups; g += blockDim.x) {
    float f[G];
    load_int8<G>(qr + g * G, f);
#pragma unroll
    for (int j = 0; j < G; ++j) f[j] = f[j] * s;
    store_elems<D, G>(outr + g * G, f);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename D>
cudaError_t quantize(const void* x, void* q, float* scales, long long rows, int cols,
                     cudaStream_t stream) {
  const auto* xp = static_cast<const typename D::Raw*>(x);
  auto* qp = static_cast<int8_t*>(q);
  if (cols % kGroup == 0 && aligned16(x) && aligned16(q)) {
    quantize_kernel<D, kGroup><<<(unsigned)rows, row_reduce::row_threads(cols / kGroup, kMaxThreads),
                                 0, stream>>>(xp, qp, scales, cols);
  } else {
    quantize_kernel<D, 1><<<(unsigned)rows, row_reduce::row_threads(cols, kMaxThreads), 0, stream>>>(
        xp, qp, scales, cols);
  }
  return cudaGetLastError();
}

template <typename D>
cudaError_t dequantize(const void* q, const float* scales, void* out, long long rows, int cols,
                       cudaStream_t stream) {
  const auto* qp = static_cast<const int8_t*>(q);
  auto* outp = static_cast<typename D::Raw*>(out);
  if (cols % kGroup == 0 && aligned16(q) && aligned16(out)) {
    dequantize_kernel<D, kGroup><<<(unsigned)rows, row_reduce::row_threads(cols / kGroup, kMaxThreads),
                                   0, stream>>>(qp, scales, outp, cols);
  } else {
    dequantize_kernel<D, 1><<<(unsigned)rows, row_reduce::row_threads(cols, kMaxThreads), 0, stream>>>(
        qp, scales, outp, cols);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16. Each returns a
// cudaError_t (0 = ok); cudaErrorInvalidValue for a dtype code or size it
// does not take.
extern "C" int rt_quantize_int8(const void* x, void* q, void* scales, long long rows, int cols,
                                int x_dtype, void* stream) {
  if (rows <= 0 || cols <= 0 || rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(scales);
  switch (x_dtype) {
    case 0: return (int)quantize<F32>(x, q, sp, rows, cols, s);
    case 1: return (int)quantize<BF16>(x, q, sp, rows, cols, s);
    case 2: return (int)quantize<F16>(x, q, sp, rows, cols, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int rt_dequantize_int8(const void* q, const void* scales, void* out, long long rows,
                                  int cols, int out_dtype, void* stream) {
  if (rows <= 0 || cols <= 0 || rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(scales);
  switch (out_dtype) {
    case 0: return (int)dequantize<F32>(q, sp, out, rows, cols, s);
    case 1: return (int)dequantize<BF16>(q, sp, out, rows, cols, s);
    case 2: return (int)dequantize<F16>(q, sp, out, rows, cols, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
