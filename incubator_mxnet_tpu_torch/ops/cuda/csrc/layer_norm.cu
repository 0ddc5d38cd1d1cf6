// Layer normalisation over the last axis for Hopper (sm_90a): forward and
// backward of rows x (n, d), float32 or bfloat16, with float32 gamma/beta.
//
// Replaces the Pallas TPU kernels of
// incubator_mxnet_tpu/ops/pallas/layer_norm.py:
//   ln_fwd_vec_kernel (d <= 1024)      \  <-  _run_fwd / _fwd_kernel
//   ln_fwd_block_kernel (d > 1024)     /
//       y = (x - mu) * rstd * gamma + beta in x's type, plus mu and rstd
//       (n, 1) float32; var = mean((x - mu)^2), two passes as the reference
//   ln_bwd_onepass_kernel (d <= 1024)  \  <-  _ln_bwd / _bwd_kernel
//   ln_bwd_kernel (d > 1024)           /
//       dx = rstd * (dxn - mean(dxn) - xn * mean(dxn * xn)), dxn = dy * gamma,
//       in x's type; dgamma = sum of dy * xn and dbeta = sum of dy over the
//       rows, float32 (the reference sums its (grid, 8, d) partials outside
//       the kernel).
// All arithmetic is float32.
//
// What bounds it on an H100: device-memory bytes. The forward reads x once
// and writes y (a few flops per element, ~1 flop/byte); the backward reads
// x and dy and writes dx. For d <= 1024 one warp owns a row held in
// registers (32 values a lane at most), so x is read from device memory
// once; wider rows (the reference kernelises any d up to 65,536) take one
// block per row and re-read the row, which L1/L2 mostly serve.
//
// The forward for d <= 1024 (ln_fwd_vec_kernel) is bound by bytes only if
// it keeps enough loads in flight with few instructions:
//   * one warp a row, the row in registers, brought in by 16-byte loads and
//     written by 16-byte stores (4 float32 or 8 bf16 values a lane) where
//     x, y, gamma and beta start on 16 bytes and a row is a multiple of 16
//     bytes, masked scalar accesses otherwise;
//   * gamma and beta read once a warp into registers, as float32, for all
//     of its rows;
//   * a persistent grid (blocks an SM from the values a lane holds, SM
//     count cached by the caller), each block walking a run of rows with
//     its kFwdWarps warps, each warp issuing its next row's loads before
//     the current row's sums and stores.
// ln_fwd_warp_kernel, the first design (a warp a row, one element a lane a
// load, gamma and beta read from device memory for every element, a warp
// leaving after its row), stays behind the wrapper's private
// _route="warp" as the yardstick.
//
// The backward for d <= 1024 (ln_bwd_onepass_kernel) reads x and dy once:
//   * one warp a row, the row in registers, brought in by 16-byte vector
//     loads (4 float32 or 8 bf16 values a lane) where rows start on 16
//     bytes, scalar loads otherwise, the tail masked; the row means, dx and
//     the lane's share of the column sums all come from the registers;
//   * a grid of one block an SM for float32 rows and two for bf16 rows
//     (SM count cached by the caller), each walking a run of rows with its
//     kBwdWarps warps, each warp loading its next row's x and dy while it
//     finishes the current one; each warp keeps its column partials of
//     dy * xn and dy in its own slice of shared memory across its rows
//     (held in registers they capped a block at 8 warps an SM and read
//     slower on an H100), and the block sums its warps' partials in warp
//     order into one (2, d) row of a workspace;
//   * dgamma and dbeta are finished inside the launch: the last block of
//     each group of kBwdGroup blocks sums the group's rows in block order,
//     and the last group to finish sums the group rows in group order. A
//     block learns that it is last from an atomic ticket that one thread
//     takes after a block barrier and the last one resets to zero (so the
//     next launch, or a CUDA-graph replay, finds it zero). Every sum has a
//     fixed order and no float atomic touches a result: they repeat bit for
//     bit. Two levels keep the serial tail short: a single last block would
//     read every block's row, ~1.6 MB at the nd lane, alone.
// ln_bwd_kernel, for d > 1024 and as the yardstick behind the wrapper's
// private _route="twopass", is the first design: a block owns a run of
// rows, one warp per row forms the two row means (a first read of x and
// dy), then the block's threads walk the columns (a second read), write dx
// and (blocks, d) column partials, which the wrapper sums.
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

// ------------------------------------------------- the one-pass backward
constexpr int kBwdWarps = 8;          // warps of a block, a row each at a time
constexpr int kBwdGroup = 16;         // blocks whose rows one block sums
constexpr int kBwdVecBytes = 16;      // a lane's vector load
constexpr int kBwdTwoBlockValues = 24;  // a lane's values a row, two blocks

// Blocks an SM the grid is sized for (the caller's plan,
// layer_norm_bwd_blocks_per_sm) and the launch bound asks registers for:
// two of bf16 rows, whose half-size rows need twice the rows in flight for
// the same bytes, while a lane holds at most kBwdTwoBlockValues values a
// row (d <= 768); one otherwise.
template <typename T, int kV>
constexpr int bwd_blocks_per_sm() {
  return sizeof(T) == 2 && kV * kBwdVecBytes / sizeof(T) <= kBwdTwoBlockValues
             ? 2 : 1;
}

struct BwdArgs {
  const void* x; const float* gamma; const float* mu; const float* rstd;
  const void* dy; void* dx; float* dgamma; float* dbeta;
  float* ws;          // (blocks + groups, 2, d): block rows, then group rows
  int* tickets;       // (groups + 1,) int32, zero between launches
  int n, d, rows_per_block, blocks, vec;
};

__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// 16 bytes of T as float32: 4 float32 or 8 bf16 values
__device__ __forceinline__ void ld16(const float* p, float* v) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void ld16(const __nv_bfloat16* p, float* v) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void st16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st16(__nv_bfloat16* p, const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = static_cast<uint32_t>(
               __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i]))) |
           (static_cast<uint32_t>(
                __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1])))
            << 16);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// The last block to take one of `count` tickets at `t` resets it and
// returns true in every thread; the block's global writes before the call
// are released to it, and the others' acquired.
__device__ __forceinline__ bool last_to_finish(int* t, int count) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    fence_acq_rel_gpu();
    last = atomicAdd(t, 1) == count - 1;
    if (last) {
      *t = 0;                            // zero again for the next launch
      fence_acq_rel_gpu();
    }
  }
  __syncthreads();
  return last;
}

// out[c] = part[c] + part[2 d + c] + ... over `count` (2, d) rows, in
// order, for each column c; into dgamma / dbeta when `final`. A thread
// takes 4 adjacent columns (16-byte loads when d is even, so that every
// row starts on 16 bytes) and issues the loads of up to kBwdGroup rows
// before it adds them: the sum is a chain of adds, not of L2 round trips.
__device__ __forceinline__ void sum_rows(const BwdArgs& a, const float* part,
                                         int count, float* out, bool final) {
  const int w = 2 * a.d;
  const bool vec = (a.d & 1) == 0;
  for (int c = 4 * threadIdx.x; c < w; c += 4 * blockDim.x) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i0 = 0; i0 < count; i0 += kBwdGroup) {
      float v[kBwdGroup][4];
#pragma unroll
      for (int i = 0; i < kBwdGroup; ++i) {
        const float* src = part + static_cast<size_t>(i0 + i) * w + c;
        if (i0 + i >= count) {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[i][e] = 0.f;
        } else if (vec) {
          const float4 q = __ldcg(reinterpret_cast<const float4*>(src));
          v[i][0] = q.x; v[i][1] = q.y; v[i][2] = q.z; v[i][3] = q.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[i][e] = c + e < w ? __ldcg(src + e) : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < kBwdGroup; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (i0 + i < count)
            s[e] = i0 + i == 0 ? v[i][e] : __fadd_rn(s[e], v[i][e]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = c + e;
      if (col >= w) break;
      if (!final) out[col] = s[e];
      else if (col < a.d) a.dgamma[col] = s[e];
      else a.dbeta[col - a.d] = s[e];
    }
  }
}

// Block b owns rows [b rows_per_block, ...); warp w takes its rows w,
// w + kBwdWarps, ... of them. Lane l holds the columns kE (l + 32 j) ..
// kE (l + 32 j) + kE - 1 of vector j < kV in every row. Dynamic shared
// memory: each warp's column partials of dy * xn and dy, (kBwdWarps, 2, d)
// float32 (up to 64 KB; 48 KB at d 768).
template <typename T, int kV>
__global__ void __launch_bounds__(32 * kBwdWarps, bwd_blocks_per_sm<T, kV>())
ln_bwd_onepass_kernel(BwdArgs a) {
  constexpr int kE = kBwdVecBytes / sizeof(T);
  constexpr int kC = kV * kE;
  extern __shared__ __align__(16) float part[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = a.d;
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  T* dx = static_cast<T*>(a.dx);
  const int r0 = blockIdx.x * a.rows_per_block;
  const int r1 = min(a.n, r0 + a.rows_per_block);
  const float inv_d = 1.f / static_cast<float>(d);
  float* pg = part + static_cast<size_t>(warp) * 2 * d;   // dy * xn
  float* pb = pg + d;                                       // dy
  for (int c = threadIdx.x; c < kBwdWarps * 2 * d; c += blockDim.x)
    part[c] = 0.f;
  __syncthreads();

  // a row's x and dy in this lane's columns (zero past d), mu and rstd
  auto load_row = [&](int r, float (&xr)[kC], float (&dr)[kC], float& m,
                      float& rs) {
    const size_t off = static_cast<size_t>(r) * d;
    m = a.mu[r];
    rs = a.rstd[r];
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int c = kE * (lane + 32 * j);
      if (a.vec) {
        if (c < d) {
          ld16(x + off + c, xr + kE * j);
          ld16(dy + off + c, dr + kE * j);
        } else {
#pragma unroll
          for (int e = 0; e < kE; ++e) xr[kE * j + e] = dr[kE * j + e] = 0.f;
        }
      } else {
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const bool in = c + e < d;
          xr[kE * j + e] = in ? to_float(x[off + c + e]) : 0.f;
          dr[kE * j + e] = in ? to_float(dy[off + c + e]) : 0.f;
        }
      }
    }
  };

  float xr[kC], dr[kC], m = 0.f, rs = 0.f;   // the row's, loaded a row ahead
  if (r0 + warp < r1) load_row(r0 + warp, xr, dr, m, rs);
  for (int r = r0 + warp; r < r1; r += kBwdWarps) {
    const size_t off = static_cast<size_t>(r) * d;
    const float mr = m, rsr = rs;
    float xn[kC], dxn[kC];
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int c = kE * (lane + 32 * j);
      float gv[kE], cg[kE], cb[kE];        // gamma, the column partials
      if (a.vec && c < d) {
#pragma unroll
        for (int e = 0; e < kE; e += 4) {
          ld16(a.gamma + c + e, gv + e);
          const float4 q = *reinterpret_cast<const float4*>(pg + c + e);
          const float4 u = *reinterpret_cast<const float4*>(pb + c + e);
          cg[e] = q.x; cg[e + 1] = q.y; cg[e + 2] = q.z; cg[e + 3] = q.w;
          cb[e] = u.x; cb[e + 1] = u.y; cb[e + 2] = u.z; cb[e + 3] = u.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const bool in = c + e < d;
          gv[e] = in ? a.gamma[c + e] : 0.f;
          cg[e] = in ? pg[c + e] : 0.f;
          cb[e] = in ? pb[c + e] : 0.f;
        }
      }
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int k = kE * j + e;
        const bool in = c + e < d;
        const float xnv = in ? __fmul_rn(__fsub_rn(xr[k], mr), rsr) : 0.f;
        cg[e] = __fadd_rn(cg[e], __fmul_rn(dr[k], xnv));
        cb[e] = __fadd_rn(cb[e], dr[k]);
        xn[k] = xnv;
        dxn[k] = __fmul_rn(dr[k], gv[e]);
      }
      if (a.vec && c < d) {
#pragma unroll
        for (int e = 0; e < kE; e += 4) {
          *reinterpret_cast<float4*>(pg + c + e) =
              make_float4(cg[e], cg[e + 1], cg[e + 2], cg[e + 3]);
          *reinterpret_cast<float4*>(pb + c + e) =
              make_float4(cb[e], cb[e + 1], cb[e + 2], cb[e + 3]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < kE; ++e)
          if (c + e < d) {
            pg[c + e] = cg[e];
            pb[c + e] = cb[e];
          }
      }
    }
    // the next row's loads go out before this row's reductions and stores
    if (r + kBwdWarps < r1) load_row(r + kBwdWarps, xr, dr, m, rs);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < kC; ++k) {
      s1 += dxn[k];
      s2 = fmaf(dxn[k], xn[k], s2);
    }
    const float m1 = rows::warp_sum(s1) * inv_d;
    const float m2 = rows::warp_sum(s2) * inv_d;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int c = kE * (lane + 32 * j);
      float out[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int k = kE * j + e;
        out[e] = __fmul_rn(rsr, __fsub_rn(__fsub_rn(dxn[k], m1),
                                          __fmul_rn(xn[k], m2)));
      }
      if (a.vec) {
        if (c < d) st16(dx + off + c, out);
      } else {
#pragma unroll
        for (int e = 0; e < kE; ++e)
          if (c + e < d) dx[off + c + e] = from_float<T>(out[e]);
      }
    }
  }

  // the block's row of the workspace: its warps' partials in warp order
  __syncthreads();
  float* mine = a.ws + static_cast<size_t>(blockIdx.x) * 2 * d;
  for (int c = threadIdx.x; c < 2 * d; c += blockDim.x) {
    float v = part[c];
#pragma unroll
    for (int w = 1; w < kBwdWarps; ++w)
      v = __fadd_rn(v, part[static_cast<size_t>(w) * 2 * d + c]);
    mine[c] = v;
  }

  // the group's last block sums its rows in block order; the last group's
  // sums its groups' rows in group order into dgamma and dbeta
  const int groups = (a.blocks + kBwdGroup - 1) / kBwdGroup;
  const int group = blockIdx.x / kBwdGroup, g0 = group * kBwdGroup;
  const int in_group = min(kBwdGroup, a.blocks - g0);
  if (!last_to_finish(a.tickets + group, in_group)) return;
  float* gsum = a.ws + (static_cast<size_t>(a.blocks) + group) * 2 * d;
  sum_rows(a, a.ws + static_cast<size_t>(g0) * 2 * d, in_group, gsum,
           groups == 1);
  if (groups == 1 || !last_to_finish(a.tickets + groups, groups)) return;
  sum_rows(a, a.ws + static_cast<size_t>(a.blocks) * 2 * d, groups, nullptr,
           true);
}

template <typename T, int kV>
int bwd_onepass_launch(const BwdArgs& a, cudaStream_t st) {
  // the warps' partials; above 48 KB with the opt-in, set once
  constexpr int kMaxSmem = kBwdWarps * 2 * rows::kWarpRowMaxD * 4;
  static const cudaError_t attr = cudaFuncSetAttribute(
      ln_bwd_onepass_kernel<T, kV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const size_t smem = static_cast<size_t>(kBwdWarps) * 2 * a.d * 4;
  ln_bwd_onepass_kernel<T, kV><<<a.blocks, 32 * kBwdWarps, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_onepass(const BwdArgs& a, cudaStream_t st) {
  // vectors a lane: the smallest instantiated count covering the row (at
  // most 8 float32 or 4 bf16 vectors for d <= 1024)
  constexpr int kE = kBwdVecBytes / sizeof(T);
  const int v = (a.d + 32 * kE - 1) / (32 * kE);
  if (v <= 1) return bwd_onepass_launch<T, 1>(a, st);
  if (v <= 2) return bwd_onepass_launch<T, 2>(a, st);
  if (v <= 3) return bwd_onepass_launch<T, 3>(a, st);
  if (v <= 4) return bwd_onepass_launch<T, 4>(a, st);
  if constexpr (kE == 4) {
    if (v <= 6) return bwd_onepass_launch<T, 6>(a, st);
    return bwd_onepass_launch<T, 8>(a, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------- the vector forward
constexpr int kFwdWarps = 8;          // warps of a block, a row each at a time

// Blocks an SM the grid is sized for (the caller's plan,
// layer_norm_fwd_blocks_per_sm) and the launch bound asks registers for,
// by the values a lane holds of a row: four up to 8, two up to
// kBwdTwoBlockValues (24: bf16 rows up to 768, float32 up to 768), one
// above. A lane keeps the row as float32, the next row's loads as raw
// 16-byte words, and gamma and beta as float32.
template <typename T, int kV>
constexpr int fwd_blocks_per_sm() {
  constexpr int kC = kV * kBwdVecBytes / static_cast<int>(sizeof(T));
  return kC <= 8 ? 4 : kC <= kBwdTwoBlockValues ? 2 : 1;
}

struct FwdArgs {
  const void* x; const float* gamma; const float* beta;
  void* y; float* mu; float* rstd;
  int n, d, rows_per_block, vec;
  float eps;
};

// 16 bytes of a row from column c (kE values, zero past d) as raw words:
// one vector load where rows start on 16 bytes (a chunk is then wholly
// inside the row or wholly past it), else kE masked scalar loads
__device__ __forceinline__ uint4 ld_chunk(const float* p, int c, int d,
                                          bool vec) {
  if (vec)
    return c < d ? __ldg(reinterpret_cast<const uint4*>(p + c))
                 : make_uint4(0u, 0u, 0u, 0u);
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    w[e] = c + e < d ? __float_as_uint(__ldg(p + c + e)) : 0u;
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ uint4 ld_chunk(const __nv_bfloat16* p, int c,
                                          int d, bool vec) {
  if (vec)
    return c < d ? __ldg(reinterpret_cast<const uint4*>(p + c))
                 : make_uint4(0u, 0u, 0u, 0u);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (c + e < d)
      w[e >> 1] |= static_cast<uint32_t>(__bfloat16_as_ushort(p[c + e]))
                   << (16 * (e & 1));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// raw words to float32: 4 float32 or 8 bf16 values
__device__ __forceinline__ void unpack(const uint4& q, float* v, float) {
  v[0] = __uint_as_float(q.x); v[1] = __uint_as_float(q.y);
  v[2] = __uint_as_float(q.z); v[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void unpack(const uint4& q, float* v,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Block b owns rows [b rows_per_block, ...); warp w takes its rows w,
// w + kFwdWarps, ... of them. Lane l holds the columns kE (l + 32 j) ..
// kE (l + 32 j) + kE - 1 of chunk j < kV in every row, and gamma and beta
// at those columns in registers for all of the warp's rows. The next
// row's loads are issued before the current row's sums and stores; the
// arithmetic is the first design's: the sum, the mean, the sum of squared
// deviations from the registers, rstd, then y.
template <typename T, int kV>
__global__ void __launch_bounds__(32 * kFwdWarps, fwd_blocks_per_sm<T, kV>())
ln_fwd_vec_kernel(FwdArgs a) {
  constexpr int kE = kBwdVecBytes / sizeof(T);
  constexpr int kC = kV * kE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = a.d;
  const bool vec = a.vec;
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.y);
  const int r0 = blockIdx.x * a.rows_per_block;
  const int r1 = min(a.n, r0 + a.rows_per_block);
  int r = r0 + warp;
  if (r >= r1) return;                    // the whole warp leaves together

  auto load_row = [&](int row, uint4 (&dst)[kV]) {
    const T* xr = x + static_cast<size_t>(row) * d;
#pragma unroll
    for (int j = 0; j < kV; ++j)
      dst[j] = ld_chunk(xr, kE * (lane + 32 * j), d, vec);
  };
  uint4 raw[kV];                          // a row's loads, a row ahead
  load_row(r, raw);

  float gv[kC], bv[kC];
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const int c = kE * (lane + 32 * j);
    if (vec) {
#pragma unroll
      for (int e = 0; e < kE; e += 4) {
        float4 q = make_float4(0.f, 0.f, 0.f, 0.f), u = q;
        if (c < d) {
          q = __ldg(reinterpret_cast<const float4*>(a.gamma + c + e));
          u = __ldg(reinterpret_cast<const float4*>(a.beta + c + e));
        }
        gv[kE * j + e] = q.x; gv[kE * j + e + 1] = q.y;
        gv[kE * j + e + 2] = q.z; gv[kE * j + e + 3] = q.w;
        bv[kE * j + e] = u.x; bv[kE * j + e + 1] = u.y;
        bv[kE * j + e + 2] = u.z; bv[kE * j + e + 3] = u.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const bool in = c + e < d;
        gv[kE * j + e] = in ? __ldg(a.gamma + c + e) : 0.f;
        bv[kE * j + e] = in ? __ldg(a.beta + c + e) : 0.f;
      }
    }
  }

  for (; r < r1; r += kFwdWarps) {
    float v[kC];
#pragma unroll
    for (int j = 0; j < kV; ++j) unpack(raw[j], v + kE * j, T());
    if (r + kFwdWarps < r1) load_row(r + kFwdWarps, raw);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kC; ++k) s += v[k];
    const float m = rows::warp_sum(s) / static_cast<float>(d);
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < kV; ++j)
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int k = kE * j + e;
        v[k] = kE * (lane + 32 * j) + e < d ? v[k] - m : 0.f;
        q += v[k] * v[k];
      }
    const float rs =
        rsqrtf(rows::warp_sum(q) / static_cast<float>(d) + a.eps);
    T* yr = y + static_cast<size_t>(r) * d;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int c = kE * (lane + 32 * j);
      float out[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int k = kE * j + e;
        out[e] = v[k] * rs * gv[k] + bv[k];
      }
      if (vec) {
        if (c < d) st16(yr + c, out);
      } else {
#pragma unroll
        for (int e = 0; e < kE; ++e)
          if (c + e < d) yr[c + e] = from_float<T>(out[e]);
      }
    }
    if (lane == 0) {
      a.mu[r] = m;
      a.rstd[r] = rs;
    }
  }
}

template <typename T, int kV>
int fwd_vec_launch(const FwdArgs& a, int blocks, cudaStream_t st) {
  ln_fwd_vec_kernel<T, kV><<<blocks, 32 * kFwdWarps, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd_vec(const FwdArgs& a, int blocks, cudaStream_t st) {
  // chunks a lane: the smallest instantiated count covering the row (at
  // most 8 float32 or 4 bf16 chunks for d <= 1024)
  constexpr int kE = kBwdVecBytes / sizeof(T);
  const int v = (a.d + 32 * kE - 1) / (32 * kE);
  if (v <= 1) return fwd_vec_launch<T, 1>(a, blocks, st);
  if (v <= 2) return fwd_vec_launch<T, 2>(a, blocks, st);
  if (v <= 3) return fwd_vec_launch<T, 3>(a, blocks, st);
  if (v <= 4) return fwd_vec_launch<T, 4>(a, blocks, st);
  if constexpr (kE == 4) {
    if (v <= 6) return fwd_vec_launch<T, 6>(a, blocks, st);
    return fwd_vec_launch<T, 8>(a, blocks, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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

// The vector forward, d <= 1024: block b owns rows [b rows_per_block,
// ...), so blocks = ceil(n / rows_per_block). 16-byte loads and stores
// when x, y, gamma and beta start on 16 bytes and a row is a multiple of
// 16 bytes.
int layer_norm_fwd_vec_launch(int dtype, const void* x, const float* gamma,
                              const float* beta, void* y, float* mu,
                              float* rstd, int n, int d, float eps,
                              int rows_per_block, int blocks, void* stream) {
  if (n == 0) return 0;
  if (d < 1 || d > rows::kWarpRowMaxD || rows_per_block < 1 || blocks < 1 ||
      (long long)(blocks - 1) * rows_per_block >= n ||
      (long long)blocks * rows_per_block < n || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int esz = dtype == 0 ? 4 : 2;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % kBwdVecBytes == 0;
  };
  const int vec = aligned(x) && aligned(y) && aligned(gamma) &&
                  aligned(beta) && (d * esz) % kBwdVecBytes == 0;
  const FwdArgs a{x, gamma, beta, y, mu, rstd, n, d, rows_per_block, vec,
                  eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? fwd_vec<float>(a, blocks, st)
                    : fwd_vec<__nv_bfloat16>(a, blocks, st);
}

// The one-pass backward, d <= 1024: dgamma/dbeta (d,) float32 sums; ws
// (blocks + ceil(blocks / kBwdGroup), 2, d) float32 scratch; tickets
// (ceil(blocks / kBwdGroup) + 1,) int32 zeros (each launch leaves them
// zero). Block b owns rows [b rows_per_block, ...), so blocks =
// ceil(n / rows_per_block). Vector loads when x, dy, dx and gamma start
// on 16 bytes and a row is a multiple of 16 bytes.
int layer_norm_bwd_onepass_launch(int dtype, const void* x,
                                  const float* gamma, const float* mu,
                                  const float* rstd, const void* dy, void* dx,
                                  float* dgamma, float* dbeta, float* ws,
                                  int* tickets, int n, int d,
                                  int rows_per_block, int blocks,
                                  void* stream) {
  if (n == 0) return 0;
  if (d < 1 || d > rows::kWarpRowMaxD || rows_per_block < 1 || blocks < 1 ||
      (long long)(blocks - 1) * rows_per_block >= n ||
      (long long)blocks * rows_per_block < n || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int esz = dtype == 0 ? 4 : 2;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % kBwdVecBytes == 0;
  };
  const int vec = aligned(x) && aligned(dy) && aligned(dx) &&
                  aligned(gamma) && (d * esz) % kBwdVecBytes == 0;
  const BwdArgs a{x, gamma, mu, rstd, dy, dx, dgamma, dbeta, ws, tickets,
                  n, d, rows_per_block, blocks, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? bwd_onepass<float>(a, st)
                    : bwd_onepass<__nv_bfloat16>(a, st);
}

// The two-pass backward: dg/db (ceil(n / rows_per_block), d) float32
// partials. rows_per_block * 16 bytes of shared memory must fit the default
// 48 KB.
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
