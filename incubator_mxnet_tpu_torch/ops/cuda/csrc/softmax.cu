// Row softmax over the last axis for Hopper (sm_90a): x (n, d), float32 or
// bfloat16, computed in float32 and written in x's type.
//
// Replaces the Pallas TPU kernel of incubator_mxnet_tpu/ops/pallas/softmax.py:
//   softmax_warp_kernel / softmax_block_kernel  <-  _run / _softmax_kernel
//       m = max(x), e = exp(x - m), y = e / sum(e), per row.
// The backward, p * (dy - sum(dy * p)), is plain PyTorch in the wrapper's
// autograd.Function, as it is plain XLA in the reference.
//
// What bounds it on an H100: device-memory bytes (x read once, y written
// once, about 4 flops and one exp per element). For d <= 1024 one warp owns
// a row held in registers, so x is read once; at the slice's shape
// (attention scores, 196,608 rows of 512) that is 16 values a lane. Wider
// rows (a 32,768-word vocabulary is an ordinary call) take one block per row
// and three passes over the row (max, sum, write), which L1/L2 mostly
// serve. A masked entry (-inf, from the caller's length mask) contributes
// exp(-inf) = 0; a row that is all -inf gives NaN, as the reference does.
#include <stdint.h>

#include "rows.cuh"

namespace {

using rows::from_float;
using rows::to_float;

template <typename T, int kCols>
__global__ void softmax_warp_kernel(const T* __restrict__ x,
                                    T* __restrict__ y, int n, int d) {
  const int lane = threadIdx.x & 31;
  const long row =
      (long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= n) return;                 // the whole warp leaves together
  const T* xr = x + (size_t)row * d;
  float v[kCols];
  float m = rows::neg_inf();
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int c = lane + 32 * j;
    v[j] = c < d ? to_float(xr[c]) : rows::neg_inf();
    m = fmaxf(m, v[j]);
  }
  m = rows::warp_max(m);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int c = lane + 32 * j;
    v[j] = c < d ? expf(v[j] - m) : 0.f;
    s += v[j];
  }
  s = rows::warp_sum(s);
  T* yr = y + (size_t)row * d;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int c = lane + 32 * j;
    if (c < d) yr[c] = from_float<T>(v[j] / s);
  }
}

template <typename T>
__global__ void softmax_block_kernel(const T* __restrict__ x,
                                     T* __restrict__ y, int d) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  float m = rows::neg_inf();
  for (int c = threadIdx.x; c < d; c += blockDim.x)
    m = fmaxf(m, to_float(xr[c]));
  m = rows::block_reduce<true>(m, red);
  float s = 0.f;
  for (int c = threadIdx.x; c < d; c += blockDim.x)
    s += expf(to_float(xr[c]) - m);
  s = rows::block_reduce<false>(s, red);
  T* yr = y + row * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x)
    yr[c] = from_float<T>(expf(to_float(xr[c]) - m) / s);
}

template <typename T, int kCols>
void warp_rows(const void* x, void* y, int n, int d, cudaStream_t st) {
  constexpr int kWarps = 4;
  softmax_warp_kernel<T, kCols><<<(n + kWarps - 1) / kWarps, 32 * kWarps, 0,
                                  st>>>(static_cast<const T*>(x),
                                        static_cast<T*>(y), n, d);
}

template <typename T>
int fwd(const void* x, void* y, int n, int d, cudaStream_t st) {
  if (n == 0 || d == 0) return 0;
  const int cols = (d + 31) / 32;
  if (d > rows::kWarpRowMaxD)
    softmax_block_kernel<T><<<n, 256, 0, st>>>(static_cast<const T*>(x),
                                               static_cast<T*>(y), d);
  else if (cols <= 1) warp_rows<T, 1>(x, y, n, d, st);
  else if (cols <= 2) warp_rows<T, 2>(x, y, n, d, st);
  else if (cols <= 4) warp_rows<T, 4>(x, y, n, d, st);
  else if (cols <= 8) warp_rows<T, 8>(x, y, n, d, st);
  else if (cols <= 16) warp_rows<T, 16>(x, y, n, d, st);
  else warp_rows<T, 32>(x, y, n, d, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t as int.
int softmax_fwd_launch(int dtype, const void* x, void* y, int n, int d,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(x, y, n, d, st);
  if (dtype == 1) return fwd<__nv_bfloat16>(x, y, n, d, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
