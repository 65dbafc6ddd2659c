// One-block-per-row reduction, shared by the row kernels (rmsnorm.cu,
// quant.cu).
//
// A kernel launched with one block per row reduces its threads' partial
// values with block_reduce<Op>: warp shuffles, then the warps' results
// through shared memory. row_threads picks the block size: one thread per
// access of the row, rounded up to whole warps, at most max_threads (a
// wider row loops).

#pragma once

#include <cuda_runtime.h>

namespace row_reduce {

constexpr int kWarp = 32;

struct Sum {
  static __device__ __forceinline__ float identity() { return 0.f; }
  static __device__ __forceinline__ float op(float a, float b) { return a + b; }
};

// max that carries a NaN through, as jnp.max and torch.amax do (fmaxf
// drops it)
struct MaxNaN {
  static __device__ __forceinline__ float identity() { return -__int_as_float(0x7f800000); }
  static __device__ __forceinline__ float op(float a, float b) { return (a > b || a != a) ? a : b; }
};

template <typename Op>
__device__ __forceinline__ float warp_reduce(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) v = Op::op(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The block's reduction of v, returned to every thread. blockDim.x is a
// multiple of kWarp, at most kWarp * kWarp. Call it once per block: its
// shared memory is not reusable until the block syncs again.
template <typename Op>
__device__ __forceinline__ float block_reduce(float v) {
  __shared__ float partial[kWarp];
  __shared__ float total;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  v = warp_reduce<Op>(v);
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (int)(blockDim.x / kWarp) ? partial[lane] : Op::identity();
    t = warp_reduce<Op>(t);
    if (lane == 0) total = t;
  }
  __syncthreads();
  return total;
}

// Threads for one block per row of `accesses` accesses.
inline int row_threads(int accesses, int max_threads) {
  const int t = (accesses + kWarp - 1) / kWarp * kWarp;
  return t < max_threads ? t : max_threads;
}

}  // namespace row_reduce
