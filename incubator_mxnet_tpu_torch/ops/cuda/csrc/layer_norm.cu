// Layer normalisation over the last axis for Hopper (sm_90a): forward and
// backward of rows x (n, d), float32 or bfloat16, with float32 gamma/beta.
//
// Replaces the Pallas TPU kernels of
// incubator_mxnet_tpu/ops/pallas/layer_norm.py:
//   ln_fwd_warp_kernel / ln_fwd_block_kernel  <-  _run_fwd / _fwd_kernel
//       y = (x - mu) * rstd * gamma + beta in x's type, plus mu and rstd
//       (n, 1) float32; var = mean((x - mu)^2), two passes as the reference
//   ln_bwd_kernel  <-  _ln_bwd / _bwd_kernel
//       dx = rstd * (dxn - mean(dxn) - xn * mean(dxn * xn)), dxn = dy * gamma,
//       in x's type; plus per-block float32 partial sums of dy * xn and dy
//       per column, which the wrapper sums (the reference sums its (grid, 8,
//       d) partials outside the kernel the same way).
// All arithmetic is float32.
//
// What bounds it on an H100: device-memory bytes. The forward reads x once
// and writes y (a few flops per element, ~1 flop/byte); the backward reads
// x and dy and writes dx. The design keeps each row on chip between its
// passes: for d <= 1024 one warp owns a row held in registers (32 values a
// lane at most), so x is read from device memory once; wider rows (the
// reference kernelises any d up to 65,536) take one block per row and
// re-read the row, which L1/L2 mostly serve. The backward gives each block
// a run of consecutive rows: one warp per row forms the two row means, then
// the block's threads walk the columns, write dx and keep the column sums
// in registers, so the dgamma/dbeta partials cost one row per block rather
// than an atomic per element. Loads are scalar and coalesced (lane-strided
// columns); vector loads are later speed work.
#include <stdint.h>

#include "rows.cuh"

namespace {

using rows::from_float;
using rows::to_float;

// One warp per row, the row in registers: kCols values per lane, column
// lane + 32 * j. Block: 4 warps.
template <typename T, int kCols>
__global__ void ln_fwd_warp_kernel(const T* __restrict__ x,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ beta,
                                   T* __restrict__ y, float* __restrict__ mu,
                                   float* __restrict__ rstd, int n, int d,
                                   float eps) {
  const int lane = threadIdx.x & 31;
  const long row =
      (long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= n) return;                 // the whole warp leaves together
  const T* xr = x + (size_t)row * d;
  float v[kCols];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int c = lane + 32 * j;
    v[j] = c < d ? to_float(xr[c]) : 0.f;
    s += v[j];
  }
  const float m = rows::warp_sum(s) / (float)d;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int c = lane + 32 * j;
    v[j] = c < d ? v[j] - m : 0.f;
    q += v[j] * v[j];
  }
  const float r = rsqrtf(rows::warp_sum(q) / (float)d + eps);
  T* yr = y + (size_t)row * d;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int c = lane + 32 * j;
    if (c < d) yr[c] = from_float<T>(v[j] * r * gamma[c] + beta[c]);
  }
  if (lane == 0) {
    mu[row] = m;
    rstd[row] = r;
  }
}

// One block per row for rows wider than 1024: three passes over the row in
// device memory (sum, squared deviations, output).
template <typename T>
__global__ void ln_fwd_block_kernel(const T* __restrict__ x,
                                    const float* __restrict__ gamma,
                                    const float* __restrict__ beta,
                                    T* __restrict__ y, float* __restrict__ mu,
                                    float* __restrict__ rstd, int d,
                                    float eps) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  float s = 0.f;
  for (int c = threadIdx.x; c < d; c += blockDim.x) s += to_float(xr[c]);
  const float m = rows::block_reduce<false>(s, red) / (float)d;
  float q = 0.f;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    const float dv = to_float(xr[c]) - m;
    q += dv * dv;
  }
  const float r = rsqrtf(rows::block_reduce<false>(q, red) / (float)d + eps);
  T* yr = y + row * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x)
    yr[c] = from_float<T>((to_float(xr[c]) - m) * r * gamma[c] + beta[c]);
  if (threadIdx.x == 0) {
    mu[row] = m;
    rstd[row] = r;
  }
}

// Block b owns rows [b * rows_per_block, ...). Shared memory: mu, rstd and
// the two row means for each of its rows (4 floats a row).
template <typename T>
__global__ void ln_bwd_kernel(const T* __restrict__ x,
                              const float* __restrict__ gamma,
                              const float* __restrict__ mu,
                              const float* __restrict__ rstd,
                              const T* __restrict__ dy, T* __restrict__ dx,
                              float* __restrict__ dg_part,
                              float* __restrict__ db_part, int n, int d,
                              int rows_per_block) {
  extern __shared__ float st[];
  const int r0 = blockIdx.x * rows_per_block;
  const int nr = min(rows_per_block, n - r0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  // pass 1: per row, mean(dxn) and mean(dxn * xn); one warp per row
  for (int i = warp; i < nr; i += n_warps) {
    const size_t off = (size_t)(r0 + i) * d;
    const float m = mu[r0 + i];
    const float r = rstd[r0 + i];
    float a = 0.f, b = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float xn = (to_float(x[off + c]) - m) * r;
      const float dxn = to_float(dy[off + c]) * gamma[c];
      a += dxn;
      b += dxn * xn;
    }
    a = rows::warp_sum(a);
    b = rows::warp_sum(b);
    if (lane == 0) {
      st[4 * i] = m;
      st[4 * i + 1] = r;
      st[4 * i + 2] = a / (float)d;
      st[4 * i + 3] = b / (float)d;
    }
  }
  __syncthreads();

  // pass 2: threads over columns, rows in order: dx, and the block's
  // column sums of dy * xn and dy
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    const float g = gamma[c];
    float sg = 0.f, sb = 0.f;
#pragma unroll 4
    for (int i = 0; i < nr; ++i) {
      const size_t idx = (size_t)(r0 + i) * d + c;
      const float r = st[4 * i + 1];
      const float xn = (to_float(x[idx]) - st[4 * i]) * r;
      const float dyv = to_float(dy[idx]);
      dx[idx] = from_float<T>(r * (dyv * g - st[4 * i + 2] - xn * st[4 * i + 3]));
      sg += dyv * xn;
      sb += dyv;
    }
    dg_part[(size_t)blockIdx.x * d + c] = sg;
    db_part[(size_t)blockIdx.x * d + c] = sb;
  }
}

template <typename T, int kCols>
void fwd_warp(const void* x, const float* g, const float* b, void* y,
              float* mu, float* rstd, int n, int d, float eps,
              cudaStream_t st) {
  constexpr int kWarps = 4;
  ln_fwd_warp_kernel<T, kCols><<<(n + kWarps - 1) / kWarps, 32 * kWarps, 0,
                                 st>>>(static_cast<const T*>(x), g, b,
                                       static_cast<T*>(y), mu, rstd, n, d,
                                       eps);
}

template <typename T>
int fwd(const void* x, const float* g, const float* b, void* y, float* mu,
        float* rstd, int n, int d, float eps, cudaStream_t st) {
  if (n == 0 || d == 0) return 0;
  const int cols = (d + 31) / 32;
  if (d > rows::kWarpRowMaxD)
    ln_fwd_block_kernel<T><<<n, 256, 0, st>>>(
        static_cast<const T*>(x), g, b, static_cast<T*>(y), mu, rstd, d, eps);
  else if (cols <= 1) fwd_warp<T, 1>(x, g, b, y, mu, rstd, n, d, eps, st);
  else if (cols <= 2) fwd_warp<T, 2>(x, g, b, y, mu, rstd, n, d, eps, st);
  else if (cols <= 4) fwd_warp<T, 4>(x, g, b, y, mu, rstd, n, d, eps, st);
  else if (cols <= 8) fwd_warp<T, 8>(x, g, b, y, mu, rstd, n, d, eps, st);
  else if (cols <= 16) fwd_warp<T, 16>(x, g, b, y, mu, rstd, n, d, eps, st);
  else fwd_warp<T, 32>(x, g, b, y, mu, rstd, n, d, eps, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const void* x, const float* g, const float* mu, const float* rstd,
        const void* dy, void* dx, float* dg, float* db, int n, int d,
        int rows_per_block, cudaStream_t st) {
  if (n == 0 || d == 0) return 0;
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  const size_t smem = (size_t)4 * rows_per_block * sizeof(float);
  ln_bwd_kernel<T><<<blocks, 256, smem, st>>>(
      static_cast<const T*>(x), g, mu, rstd, static_cast<const T*>(dy),
      static_cast<T*>(dx), dg, db, n, d, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t as int.
int layer_norm_fwd_launch(int dtype, const void* x, const float* gamma,
                          const float* beta, void* y, float* mu, float* rstd,
                          int n, int d, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(x, gamma, beta, y, mu, rstd, n, d, eps, st);
  if (dtype == 1)
    return fwd<__nv_bfloat16>(x, gamma, beta, y, mu, rstd, n, d, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dg/db: (ceil(n / rows_per_block), d) float32 partials. rows_per_block * 16
// bytes of shared memory must fit the default 48 KB.
int layer_norm_bwd_launch(int dtype, const void* x, const float* gamma,
                          const float* mu, const float* rstd, const void* dy,
                          void* dx, float* dg, float* db, int n, int d,
                          int rows_per_block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows_per_block < 1 || rows_per_block > 3072)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return bwd<float>(x, gamma, mu, rstd, dy, dx, dg, db, n, d,
                      rows_per_block, st);
  if (dtype == 1)
    return bwd<__nv_bfloat16>(x, gamma, mu, rstd, dy, dx, dg, db, n, d,
                              rows_per_block, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
