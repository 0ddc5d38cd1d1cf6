// Flash attention for training on Hopper (sm_90a): the forward with its
// log-sum-exp, and the two-pass backward (dq; dk and dv) from that lse.
//
// Replaces the Pallas TPU kernels of
// incubator_mxnet_tpu/ops/pallas/flash_attention.py:
//   flash_fwd_kernel      <-  _fwd_packed, _fwd_resident, _fwd_streamed
//   flash_bwd_dq_kernel   <-  _dq_pass_packed, _dq_pass_resident,
//                             _dq_pass_streamed, the dq half of
//                             _bwd_fused_packed
//   flash_bwd_dkv_kernel  <-  _dkv_pass_packed, _dkv_pass_resident,
//                             _dkv_pass_streamed, the dk/dv half of
//                             _bwd_fused_packed
// One code serves both layouts of the reference, because every kernel
// addresses rows through (batch, head, row) strides:
//   layout 0, packed:     q/k/v/out (B, T, H*d), lse/delta (B, T, H);
//   layout 1, head-major: q/k/v/out (B, H, T, d), lse/delta (B, H, T).
// The layouts also carry the reference's two roundings. Packed: q is
// scaled once in its own type before Q.K^T, ds has no scale, and dq takes
// the scale once at the end. Head-major: the f32 scores are scaled, and so
// is ds before its cast. Everywhere the softmax weights are cast to v's
// type before P.V, ds is cast to q's type before dS.K and dS^T.Q, masking
// uses -1e30 (NaN-free) with the top-left causal rule row >= col, and
// lse = m + log(max(l, 1e-30)).
//
// The TPU holds whole K/V rows resident in VMEM and carries dq across a
// sequential grid axis. Hopper blocks run in no order and hold at most
// 227 KB of shared memory, so here every block owns one 64-row tile and
// walks the other side in 64-row tiles: forward and dq per (b, h, q-tile)
// over k-tiles, stopping at the diagonal when causal; dk/dv per
// (b, h, k-tile) over q-tiles from the first one at or below the diagonal.
// The backward is two passes (s and p are recomputed once more) so that no
// atomics are needed and results are identical from run to run.
//
// What bounds it on an H100: at the training shape (T 512, d 64) the
// products (2 B H T^2 d flops forward, causal) outweigh the bytes in f32;
// in bf16 the bytes bound it. Tiles sit in shared memory in the input type.
// Each of 256 threads owns a 4x4 block of the 64x64 score tile (rows
// ty + 16 i, columns tx + 16 j), so the softmax state and the output rows
// stay in its registers. The products are float32 FMAs on the CUDA cores
// for f32 inputs (no TF32: the parity is with full-precision f32) and
// tensor-core WMMA 16x16x16 with f32 accumulators for bf16 inputs; a bf16
// product lands in an f32 scratch tile and each thread reads back its own
// elements, so the two types share every line outside the products.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;   // NEG_INF of the reference
constexpr int kTile = 64;           // rows of a q tile and of a k tile
constexpr int kThreads = 256;       // 16 x 16: thread (ty, tx)

// Row pitches, in elements: 16 bytes of padding keep every row 16-byte and
// every 16-row block 32-byte aligned (WMMA's rule) and spread rows over the
// shared-memory banks.
template <typename T> __host__ __device__ constexpr int pad() {
  return 16 / sizeof(T);
}
template <typename T, int D> __host__ __device__ constexpr int ld() {
  return D + pad<T>();
}
template <typename T> __host__ __device__ constexpr int ldp() {
  return kTile + pad<T>();
}
// the f32 scratch tile a bf16 product lands in (none for f32)
template <int D> __host__ __device__ constexpr int lds() {
  return (D > kTile ? D : kTile) + 4;
}
template <typename T, int D>
__host__ __device__ constexpr int scratch_floats() {
  return sizeof(T) == 4 ? 0 : kTile * lds<D>();
}

struct Geometry {
  int B, H, sq, sk;
  long long q_sb, q_sh, q_sr;   // q, out, dout, dq (elements)
  long long k_sb, k_sh, k_sr;   // k, v, dk, dv
  long long l_sb, l_sh, l_sr;   // lse, delta (floats)
  float scale;
  int causal;
  int prescale;                 // 1: packed rounding, 0: head-major
};

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

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// A (kTile, D) tile of rows [0, n_rows) from global to shared memory (pitch
// ld<T, D>), 16 bytes per access; rows past n_rows are zero. With `scale_q`
// each value is multiplied by scale_t in T's rounding (the reference scales
// q in its own type).
template <typename T, int D>
__device__ void load_tile(T* dst, const T* src, long long row_stride,
                          int n_rows, bool scale_q, float scale_t) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int idx = threadIdx.x; idx < kTile * VPR; idx += kThreads) {
    const int r = idx / VPR;
    const int c = (idx - r * VPR) * VEC;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_rows) {
      raw = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
      if (scale_q) {
        T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          e[i] = from_float<T>(to_float(e[i]) * scale_t);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * ld<T, D>() + c) = raw;
  }
}

// The three products. Each adds into the calling thread's own elements;
// all threads of the block call them together.
namespace wmma = nvcuda::wmma;
using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
template <typename Layout>
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             Layout>;
template <typename Layout>
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             Layout>;

// acc[i][j] += sum_k A[ty + 16 i][k] * B[tx + 16 j][k]  (A.B^T over D)
template <typename T, int D>
__device__ __forceinline__ void mm_abT(const T* A, const T* B,
                                       float acc[4][4], int ty, int tx,
                                       float* scr) {
  constexpr int LD = ld<T, D>();
  if constexpr (sizeof(T) == 4) {
#pragma unroll 4
    for (int k = 0; k < D; k += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + k);
        b[i] = *reinterpret_cast<const float4*>(B + (tx + 16 * i) * LD + k);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float s = acc[i][j];
          s = fmaf(a[i].x, b[j].x, s);
          s = fmaf(a[i].y, b[j].y, s);
          s = fmaf(a[i].z, b[j].z, s);
          s = fmaf(a[i].w, b[j].w, s);
          acc[i][j] = s;
        }
      }
    }
  } else {
    // warp w: output rows 16 (w / 2), column tiles 2 (w % 2) and one more
    constexpr int LDS = lds<D>();
    const int warp = threadIdx.x >> 5;
    const int r0 = (warp >> 1) * 16;
    const int c0 = (warp & 1) * 32;
    FragAcc c[2];
    wmma::fill_fragment(c[0], 0.f);
    wmma::fill_fragment(c[1], 0.f);
    __syncthreads();                      // scr is free
#pragma unroll
    for (int k = 0; k < D; k += 16) {
      FragA<wmma::row_major> a;
      wmma::load_matrix_sync(a, A + r0 * LD + k, LD);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        FragB<wmma::col_major> b;
        wmma::load_matrix_sync(b, B + (c0 + 16 * t) * LD + k, LD);
        wmma::mma_sync(c[t], a, b, c[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
      wmma::store_matrix_sync(scr + r0 * LDS + c0 + 16 * t, c[t], LDS,
                              wmma::mem_row_major);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] += scr[(ty + 16 * i) * LDS + tx + 16 * j];
  }
}

// Shared part of the two products with a (64, D) result: C = op(A) . B over
// 64 rows of B, op(A) = A (row-major) or A^T (A read column-major); A has
// pitch ldp<bf16>, B pitch ld<bf16, D>. Lands in scr (pitch lds<D>).
template <int D, typename ALayout>
__device__ __forceinline__ void wmma_64xD(const __nv_bfloat16* A,
                                          const __nv_bfloat16* B,
                                          float* scr) {
  constexpr int LD = ld<__nv_bfloat16, D>();
  constexpr int LDP = ldp<__nv_bfloat16>();
  constexpr int LDS = lds<D>();
  constexpr int PER = D / 32;           // column tiles per warp
  const int warp = threadIdx.x >> 5;
  const int r0 = (warp >> 1) * 16;
  const int c0 = (warp & 1) * PER * 16;
  FragAcc c[PER];
#pragma unroll
  for (int t = 0; t < PER; ++t) wmma::fill_fragment(c[t], 0.f);
  __syncthreads();                        // scr is free
#pragma unroll
  for (int k = 0; k < kTile; k += 16) {
    FragA<ALayout> a;
    if constexpr (std::is_same<ALayout, wmma::row_major>::value)
      wmma::load_matrix_sync(a, A + r0 * LDP + k, LDP);
    else
      wmma::load_matrix_sync(a, A + k * LDP + r0, LDP);
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      FragB<wmma::row_major> b;
      wmma::load_matrix_sync(b, B + k * LD + c0 + 16 * t, LD);
      wmma::mma_sync(c[t], a, b, c[t]);
    }
  }
#pragma unroll
  for (int t = 0; t < PER; ++t)
    wmma::store_matrix_sync(scr + r0 * LDS + c0 + 16 * t, c[t], LDS,
                            wmma::mem_row_major);
  __syncthreads();
}

// acc[i][c] += sum_j P[ty + 16 i][j] * V[j][tx + 16 c]  (P.V over a k-tile)
template <typename T, int D>
__device__ __forceinline__ void mm_ab(const T* P, const T* V,
                                      float acc[4][D / 16], int ty, int tx,
                                      float* scr) {
  constexpr int NC = D / 16;
  if constexpr (sizeof(T) == 4) {
    constexpr int LD = ld<T, D>();
    constexpr int LDP = ldp<T>();
#pragma unroll 2
    for (int j = 0; j < kTile; j += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * LDP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = V + (j + jj) * LD + tx;
        float vv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) vv[c] = vrow[16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pij = jj == 0 ? p[i].x : jj == 1 ? p[i].y
                          : jj == 2 ? p[i].z : p[i].w;
#pragma unroll
          for (int c = 0; c < NC; ++c)
            acc[i][c] = fmaf(pij, vv[c], acc[i][c]);
        }
      }
    }
  } else {
    wmma_64xD<D, wmma::row_major>(P, V, scr);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        acc[i][c] += scr[(ty + 16 * i) * lds<D>() + tx + 16 * c];
  }
}

// acc[r][c] += sum_i A[i][4 ty + r] * B[i][tx + 16 c]  (A^T.B over a
// q-tile)
template <typename T, int D>
__device__ __forceinline__ void mm_aTb(const T* A, const T* B,
                                       float acc[4][D / 16], int ty, int tx,
                                       float* scr) {
  constexpr int NC = D / 16;
  if constexpr (sizeof(T) == 4) {
    constexpr int LD = ld<T, D>();
    constexpr int LDP = ldp<T>();
#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      const float4 a =
          *reinterpret_cast<const float4*>(A + i * LDP + 4 * ty);
      const float* brow = B + i * LD + tx;
      float bb[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) bb[c] = brow[16 * c];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[0][c] = fmaf(a.x, bb[c], acc[0][c]);
        acc[1][c] = fmaf(a.y, bb[c], acc[1][c]);
        acc[2][c] = fmaf(a.z, bb[c], acc[2][c]);
        acc[3][c] = fmaf(a.w, bb[c], acc[3][c]);
      }
    }
  } else {
    wmma_64xD<D, wmma::col_major>(A, B, scr);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        acc[r][c] += scr[(4 * ty + r) * lds<D>() + tx + 16 * c];
  }
}

// k-tiles a q-tile starting at row q0 visits: all of them, or up to the
// one holding the diagonal when causal (nk_eff of the reference)
__device__ __forceinline__ int k_tiles(const Geometry& g, int q0) {
  const int nk = (g.sk + kTile - 1) / kTile;
  return g.causal ? min(nk, (q0 + 2 * kTile - 1) / kTile) : nk;
}

__device__ __forceinline__ bool masked(const Geometry& g, int row, int col) {
  return row >= g.sq || col >= g.sk || (g.causal && col > row);
}

// Grid (q-tiles, H, B). Shared memory: q, k, v tiles, the p tile and the
// scratch tile. Thread (ty, tx) owns score rows ty + 16 i and columns
// tx + 16 j, and output columns tx + 16 c of its rows, so the running max
// m, sum l and the accumulator stay in its registers.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Geometry g) {
  constexpr int LD = ld<T, D>();
  constexpr int LDP = ldp<T>();
  constexpr int NC = D / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + kTile * LD;
  T* v_s = k_s + kTile * LD;
  T* p_s = v_s + kTile * LD;
  float* scr = reinterpret_cast<float*>(p_s + kTile * LDP);

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long qoff = b * g.q_sb + h * g.q_sh;
  const long long koff = b * g.k_sb + h * g.k_sh;

  load_tile<T, D>(q_s, q + qoff + q0 * g.q_sr, g.q_sr, g.sq - q0,
                  g.prescale, round_to<T>(g.scale));
  const float s_mul = g.prescale ? 1.f : g.scale;

  float m[4], l[4], o[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[i][c] = 0.f;
  }

  const int nk = k_tiles(g, q0);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();   // the last tile's readers of k_s, v_s, p_s are done
    load_tile<T, D>(k_s, k + koff + k0 * g.k_sr, g.k_sr, g.sk - k0, false,
                    0.f);
    load_tile<T, D>(v_s, v + koff + k0 * g.k_sr, g.k_sr, g.sk - k0, false,
                    0.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    mm_abT<T, D>(q_s, k_s, s, ty, tx, scr);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = masked(g, row, k0 + tx + 16 * j)
                            ? kNegInf : s[i][j] * s_mul;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps += p;
        p_s[(ty + 16 * i) * LDP + tx + 16 * j] = from_float<T>(p);
      }
      ps = half_warp_sum(ps);
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) o[i][c] *= corr;
    }
    __syncthreads();
    mm_ab<T, D>(p_s, v_s, o, ty, tx, scr);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= g.sq) continue;
    const float ls = fmaxf(l[i], 1e-30f);
    T* orow = out + qoff + row * g.q_sr + tx;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[16 * c] = from_float<T>(o[i][c] / ls);
    if (tx == 0)
      lse[b * g.l_sb + h * g.l_sh + row * g.l_sr] = m[i] + logf(ls);
  }
}

// Grid (q-tiles, H, B). Shared memory: q, dout, k, v tiles, the ds tile and
// the scratch tile. dq for the block's rows accumulates in registers over
// the k-tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Geometry g) {
  constexpr int LD = ld<T, D>();
  constexpr int LDP = ldp<T>();
  constexpr int NC = D / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = q_s + kTile * LD;
  T* k_s = do_s + kTile * LD;
  T* v_s = k_s + kTile * LD;
  T* ds_s = v_s + kTile * LD;
  float* scr = reinterpret_cast<float*>(ds_s + kTile * LDP);

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long qoff = b * g.q_sb + h * g.q_sh;
  const long long koff = b * g.k_sb + h * g.k_sh;
  const long long loff = b * g.l_sb + h * g.l_sh;

  load_tile<T, D>(q_s, q + qoff + q0 * g.q_sr, g.q_sr, g.sq - q0,
                  g.prescale, round_to<T>(g.scale));
  load_tile<T, D>(do_s, dout + qoff + q0 * g.q_sr, g.q_sr, g.sq - q0, false,
                  0.f);
  const float s_mul = g.prescale ? 1.f : g.scale;

  float lse_r[4], delta_r[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < g.sq ? lse[loff + row * g.l_sr] : 0.f;
    delta_r[i] = row < g.sq ? delta[loff + row * g.l_sr] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int nk = k_tiles(g, q0);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, D>(k_s, k + koff + k0 * g.k_sr, g.k_sr, g.sk - k0, false,
                    0.f);
    load_tile<T, D>(v_s, v + koff + k0 * g.k_sr, g.k_sr, g.sk - k0, false,
                    0.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    mm_abT<T, D>(q_s, k_s, s, ty, tx, scr);
    mm_abT<T, D>(do_s, v_s, dp, ty, tx, scr);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const float p = masked(g, row, col)
                            ? 0.f : expf(s[i][j] * s_mul - lse_r[i]);
        float ds = p * (dp[i][j] - delta_r[i]);
        if (!g.prescale) ds *= g.scale;
        ds_s[(ty + 16 * i) * LDP + tx + 16 * j] = from_float<T>(ds);
      }
    }
    __syncthreads();
    mm_ab<T, D>(ds_s, k_s, acc, ty, tx, scr);
  }

  const float out_mul = g.prescale ? g.scale : 1.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= g.sq) continue;
    T* drow = dq + qoff + row * g.q_sr + tx;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      drow[16 * c] = from_float<T>(acc[i][c] * out_mul);
  }
}

// Grid (k-tiles, H, B). Shared memory: k, v, q, dout tiles, the p and ds
// tiles, the scratch tile, and the q-tile's lse and delta. Thread (ty, tx)
// owns dk/dv rows 4 ty + r and columns tx + 16 c.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, Geometry g) {
  constexpr int LD = ld<T, D>();
  constexpr int LDP = ldp<T>();
  constexpr int NC = D / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + kTile * LD;
  T* q_s = v_s + kTile * LD;
  T* do_s = q_s + kTile * LD;
  T* p_s = do_s + kTile * LD;
  T* ds_s = p_s + kTile * LDP;
  float* scr = reinterpret_cast<float*>(ds_s + kTile * LDP);
  float* lse_s = scr + scratch_floats<T, D>();
  float* delta_s = lse_s + kTile;

  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long qoff = b * g.q_sb + h * g.q_sh;
  const long long koff = b * g.k_sb + h * g.k_sh;
  const long long loff = b * g.l_sb + h * g.l_sh;

  load_tile<T, D>(k_s, k + koff + k0 * g.k_sr, g.k_sr, g.sk - k0, false, 0.f);
  load_tile<T, D>(v_s, v + koff + k0 * g.k_sr, g.k_sr, g.sk - k0, false, 0.f);
  const float s_mul = g.prescale ? 1.f : g.scale;
  const float scale_t = round_to<T>(g.scale);

  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  const int nq = (g.sq + kTile - 1) / kTile;
  const int qt0 = g.causal ? k0 / kTile : 0;
  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<T, D>(q_s, q + qoff + q0 * g.q_sr, g.q_sr, g.sq - q0,
                    g.prescale, scale_t);
    load_tile<T, D>(do_s, dout + qoff + q0 * g.q_sr, g.q_sr, g.sq - q0,
                    false, 0.f);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < g.sq ? lse[loff + row * g.l_sr] : 0.f;
      delta_s[threadIdx.x] = row < g.sq ? delta[loff + row * g.l_sr] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    mm_abT<T, D>(q_s, k_s, s, ty, tx, scr);
    mm_abT<T, D>(do_s, v_s, dp, ty, tx, scr);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ri = ty + 16 * i;
      const int row = q0 + ri;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cj = tx + 16 * j;
        const float p = masked(g, row, k0 + cj)
                            ? 0.f : expf(s[i][j] * s_mul - lse_s[ri]);
        float ds = p * (dp[i][j] - delta_s[ri]);
        if (!g.prescale) ds *= g.scale;
        p_s[ri * LDP + cj] = from_float<T>(p);
        ds_s[ri * LDP + cj] = from_float<T>(ds);
      }
    }
    __syncthreads();
    mm_aTb<T, D>(p_s, do_s, dv_acc, ty, tx, scr);
    mm_aTb<T, D>(ds_s, q_s, dk_acc, ty, tx, scr);
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = k0 + 4 * ty + r;
    if (row >= g.sk) continue;
    T* krow = dk + koff + row * g.k_sr + tx;
    T* vrow = dv + koff + row * g.k_sr + tx;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      krow[16 * c] = from_float<T>(dk_acc[r][c]);
      vrow[16 * c] = from_float<T>(dv_acc[r][c]);
    }
  }
}

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int D>
constexpr size_t smem_bytes(int kind) {
  const int tiles = kind == kFwd ? 3 : 4;   // q/k/v-like tiles
  const int p_tiles = kind == kDkv ? 2 : 1;
  return sizeof(T) * (tiles * kTile * ld<T, D>() + p_tiles * kTile * ldp<T>())
         + sizeof(float) * (scratch_floats<T, D>()
                            + (kind == kDkv ? 2 * kTile : 0));
}

template <typename K>
int launch(K kernel, int n_tiles, const Geometry& g, size_t smem,
           cudaStream_t stream, void** args) {
  cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(n_tiles, g.H, g.B);
  e = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), grid,
                       dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int run(int kind, const void* q, const void* k, const void* v,
        const void* dout, const float* lse, const float* delta, void* o0,
        void* o1, float* lse_out, Geometry g, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dp = static_cast<const T*>(dout);
  T* a = static_cast<T*>(o0);
  T* c = static_cast<T*>(o1);
  const int nq = (g.sq + kTile - 1) / kTile;
  const int nk = (g.sk + kTile - 1) / kTile;
  if (kind == kFwd) {
    void* args[] = {&qp, &kp, &vp, &a, &lse_out, &g};
    return launch(flash_fwd_kernel<T, D>, nq, g, smem_bytes<T, D>(kFwd),
                  stream, args);
  }
  if (kind == kDq) {
    void* args[] = {&qp, &kp, &vp, &dp, &lse, &delta, &a, &g};
    return launch(flash_bwd_dq_kernel<T, D>, nq, g, smem_bytes<T, D>(kDq),
                  stream, args);
  }
  void* args[] = {&qp, &kp, &vp, &dp, &lse, &delta, &a, &c, &g};
  return launch(flash_bwd_dkv_kernel<T, D>, nk, g, smem_bytes<T, D>(kDkv),
                stream, args);
}

template <typename T>
int run_d(int kind, int d, const void* q, const void* k, const void* v,
          const void* dout, const float* lse, const float* delta, void* o0,
          void* o1, float* lse_out, const Geometry& g, cudaStream_t st) {
  switch (d) {
    case 32: return run<T, 32>(kind, q, k, v, dout, lse, delta, o0, o1,
                               lse_out, g, st);
    case 64: return run<T, 64>(kind, q, k, v, dout, lse, delta, o0, o1,
                               lse_out, g, st);
    case 128: return run<T, 128>(kind, q, k, v, dout, lse, delta, o0, o1,
                                 lse_out, g, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// kind: 0 forward (o0 = out, lse_out), 1 dq (o0 = dq), 2 dk/dv (o0 = dk,
// o1 = dv). layout: 0 packed, 1 head-major (see the top of the file).
// dtype: 0 float32, 1 bfloat16; d in {32, 64, 128}. Returns a cudaError_t
// as int.
int flash_attention_launch(int kind, int layout, int dtype, const void* q,
                           const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, void* o0,
                           void* o1, float* lse_out, int B, int H, int sq,
                           int sk, int d, int causal, float scale,
                           void* stream) {
  if (B * H == 0 || sq == 0 || sk == 0) return 0;
  Geometry g;
  g.B = B; g.H = H; g.sq = sq; g.sk = sk;
  g.scale = scale;
  g.causal = causal;
  if (layout == 0) {            // (B, T, H*d); lse (B, T, H)
    g.q_sb = (long long)sq * H * d; g.q_sh = d; g.q_sr = (long long)H * d;
    g.k_sb = (long long)sk * H * d; g.k_sh = d; g.k_sr = (long long)H * d;
    g.l_sb = (long long)sq * H; g.l_sh = 1; g.l_sr = H;
    g.prescale = 1;
  } else if (layout == 1) {     // (B, H, T, d); lse (B, H, T)
    g.q_sb = (long long)H * sq * d; g.q_sh = (long long)sq * d; g.q_sr = d;
    g.k_sb = (long long)H * sk * d; g.k_sh = (long long)sk * d; g.k_sr = d;
    g.l_sb = (long long)H * sq; g.l_sh = sq; g.l_sr = 1;
    g.prescale = 0;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_d<float>(kind, d, q, k, v, dout, lse, delta, o0, o1, lse_out,
                        g, st);
  if (dtype == 1)
    return run_d<__nv_bfloat16>(kind, d, q, k, v, dout, lse, delta, o0, o1,
                                lse_out, g, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
