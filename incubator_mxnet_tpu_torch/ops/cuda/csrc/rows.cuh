// Helpers shared by the row kernels (layer_norm.cu, softmax.cu): loads and
// stores in float32 or bfloat16 through the conversion intrinsics (the
// build defines __CUDA_NO_BFLOAT16_CONVERSIONS__), and warp / block
// reductions of one float.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace rows {

__device__ __forceinline__ float neg_inf() { return -CUDART_INF_F; }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Sum (kMax = false) or max (kMax = true) over the whole block; every
// thread gets the result. `red` is 32 floats of shared memory; the leading
// barrier lets consecutive calls reuse it.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const float ident = kMax ? neg_inf() : 0.f;
  v = lane < n_warps ? red[lane] : ident;
  return kMax ? warp_max(v) : warp_sum(v);
}

// Columns per lane of the warp-per-row kernels: the smallest power of two
// >= ceil(d / 32), for d <= 1024 (a row then sits in 32 registers a lane).
constexpr int kWarpRowMaxD = 1024;

}  // namespace rows
