// Flash attention for training on Hopper (sm_90a): the forward with its
// log-sum-exp, and the two-pass backward (dq; dk and dv) from that lse.
//
// Replaces the Pallas TPU kernels of
// incubator_mxnet_tpu/ops/pallas/flash_attention.py:
//   flash_fwd_*           <-  _fwd_packed, _fwd_resident, _fwd_streamed
//   flash_bwd_dq_*        <-  _dq_pass_packed, _dq_pass_resident,
//                             _dq_pass_streamed, the dq half of
//                             _bwd_fused_packed
//   flash_bwd_dkv_*       <-  _dkv_pass_packed, _dkv_pass_resident,
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
// walks the other side in tiles: forward and dq per (b, h, q-tile) over
// k-tiles, stopping at the diagonal when causal; dk/dv per (b, h, k-tile)
// over q-tiles from the first one at or below the diagonal. The backward
// is two passes (s and p are recomputed once more) so that no atomics are
// needed and results are identical from run to run.
//
// What bounds it on an H100: at the training shape (T 512, d 64) the
// products (2 B H T^2 d flops forward, causal) outweigh the bytes in f32;
// in bf16 the bytes bound it. Two families of kernels:
//
// * float32 inputs: the *_mma kernels (the second half of this file). Every
//   float32 operand of a product is split exactly into three bf16 pieces,
//   hi + mid + lo == x, and each 16-deep stage of a product runs the six
//   piece products float32 accuracy needs (hi.hi, hi.mid, mid.hi, hi.lo,
//   lo.hi, mid.mid; the dropped ones are of order 2^-24 relative) as
//   mma.sync m16n8k16 bf16 -> f32 into a fresh float32 partial, smallest
//   first, that is then added to the running float32 result. Four warps,
//   each owning 16 of the block's 64 rows (the FlashAttention-2 layout):
//   the running max, sum and output of a row stay in the accumulator
//   fragments, and a row's state needs only a quad's shuffles. The
//   streamed tile arrives by cp.async (16 bytes a thread) into a float32
//   staging tile while the current tile's products run, and is split into
//   bf16 piece tiles that ldmatrix feeds to the B operands (.trans where
//   the product runs over the tile's rows). The block's own rows are split
//   once into piece tiles where they fit, else kept float32 and split as
//   their A fragments load; the scores become P's (and dS's) A fragments
//   in registers and are split there, so P never goes through shared
//   memory. The exponentials are ex2.approx on scores and lse taken to
//   base 2, and only tiles across the diagonal or an array's edge compute
//   the mask. The causal forward and dq launch their longest q-tiles first
//   (dk/dv's longest k-tiles are already the first). The shared-memory
//   plan is the kMma* constants below: at least two blocks an SM at every
//   head dim.
// * bf16 inputs: each of 256 threads owns a 4x4 block of the 64x64 score
//   tile (rows ty + 16 i, columns tx + 16 j), so the softmax state and the
//   output rows stay in its registers; the products are tensor-core WMMA
//   16x16x16 with f32 accumulators; a product lands in an f32 scratch
//   tile and each thread reads back its own elements. The same kernels,
//   instantiated for float32, run the products as float32 FMAs on the
//   CUDA cores: that is the FMA route, kept as the float32 kernels'
//   yardstick and reached only by asking for it.
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

// ============================================ the float32 route (mma.sync)
// The plan. A block is kMmaThreads threads, four warps, each owning 16 of
// the block's kMmaRows rows (q rows for the forward and dq, k rows for
// dk/dv). The other side streams in tiles of kMma<Kernel>N<d> rows (head
// dim d 32, 64, 128). Every shared row is padded by kMmaPad elements (16
// bytes of bf16, 32 of float32): rows stay 16-byte aligned for cp.async
// and ldmatrix, and eight rows fall on distinct banks. Shared memory, in
// bytes, with R = kMmaRows, N the streamed rows and P = kMmaPad (MmaPlan):
//   the block's own rows             n_own * 3 * R * (d + P) * 2 as bf16
//                                    pieces, split once, where kMmaMinBlocks
//                                    blocks still fit an SM; else
//                                    n_own * R * (d + P) * 4 as float32,
//                                    split as each A fragment loads
//                                    (forward 1: q; dq 2: q, dout;
//                                    dk/dv 2: k, v)
//   the float32 staging tile         N * d * 4
//   bf16 piece tiles (hi, mid, lo)   n_pc * 3 * N * (d + P) * 2
//                                    (forward 1: k, then v; dq 1: v,
//                                    then k; dk/dv 2: q, dout)
//   dk/dv's lse and delta rows       2 * N * 4
// An SM holds 228 KB, 1 KB of it kept a block. The backward kernels are
// built for kMmaMinBlocks blocks an SM (255 registers a thread), the
// forward for kMmaFwdBlocks where its shared memory allows (168).
constexpr int kMmaRows = 64;
constexpr int kMmaThreads = 128;
constexpr int kMmaPad = 8;
constexpr int kMmaMinBlocks = 2;
constexpr int kMmaFwdBlocks = 3;
constexpr int kMmaFwdN32 = 64;
constexpr int kMmaFwdN64 = 64;
constexpr int kMmaFwdN128 = 32;
constexpr int kMmaDqN32 = 64;
constexpr int kMmaDqN64 = 64;
constexpr int kMmaDqN128 = 32;
constexpr int kMmaDkvN32 = 64;
constexpr int kMmaDkvN64 = 32;
constexpr int kMmaDkvN128 = 16;
constexpr int kSmemPerSM = 228 * 1024;

template <int K, int D>
struct MmaPlan {
  static constexpr int N =
      K == kFwd ? (D == 32 ? kMmaFwdN32 : D == 64 ? kMmaFwdN64 : kMmaFwdN128)
    : K == kDq ? (D == 32 ? kMmaDqN32 : D == 64 ? kMmaDqN64 : kMmaDqN128)
    : (D == 32 ? kMmaDkvN32 : D == 64 ? kMmaDkvN64 : kMmaDkvN128);
  static constexpr int kLd = D + kMmaPad;     // row pitch, in elements
  static constexpr int kOwn = K == kFwd ? 1 : 2;
  static constexpr int kPieceTiles = K == kDkv ? 2 : 1;
  static constexpr int kPiece = N * kLd;      // elements of one piece
  // staging tile, piece tiles, dk/dv's lse and delta
  static constexpr size_t kTail = size_t(N) * D * 4 +
                                  size_t(kPieceTiles) * 3 * kPiece * 2 +
                                  (K == kDkv ? 2 * N * 4 : 0);
  // the own rows as bf16 pieces, split once, where two blocks still fit
  // an SM and their float32 copy fits the tail on its way in; else as
  // float32, split as each A fragment loads
  static constexpr size_t kOwnPiecesBytes =
      size_t(kOwn) * 3 * kMmaRows * kLd * 2;
  static constexpr bool kOwnPieces =
      kMmaMinBlocks * (kOwnPiecesBytes + kTail + 1024) <= kSmemPerSM &&
      size_t(kOwn) * kMmaRows * D * 4 <=
          size_t(N) * D * 4 + size_t(kPieceTiles) * 3 * kPiece * 2;
  static constexpr size_t kOwnBytes =
      kOwnPieces ? kOwnPiecesBytes : size_t(kOwn) * kMmaRows * kLd * 4;
  static constexpr size_t kSmem = kOwnBytes + kTail;
  // blocks an SM the kernel is built for (its registers a thread: 255 at
  // two, 168 at three)
  static constexpr int kBlocks =
      K == kFwd && kMmaFwdBlocks * (kSmem + 1024) <= kSmemPerSM
          ? kMmaFwdBlocks : kMmaMinBlocks;
  static_assert(N % 16 == 0 && D % 16 == 0, "16-deep stages");
  static_assert((N * D / 4) % kMmaThreads == 0 &&
                (kMmaRows * D / 4) % kMmaThreads == 0,
                "every thread copies whole 16-byte chunks");
  static_assert(kBlocks * (kSmem + 1024) <= kSmemPerSM,
                "the blocks fit an SM");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; `bytes` 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four 8x8 b16 matrices, lanes 8i..8i+7 addressing matrix i's rows; .trans
// hands each thread a column pair instead of a row pair
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
}

// d (16 x 8, float32) += a (16 x 16, bf16) b (16 x 8, bf16)
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x (ex2.approx: within 2 ulp; a result below 2^-126 flushes to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) as three bf16x2 words, x in the lower halves: hi + mid + lo == x
// exactly (each residual is exact in float32, and lo holds what is left)
// for 0 and every |x| in [2^-110, 2^128 (1 - 2^-9)), where hi does not
// round past float32's top and lo is not below bf16's smallest subnormal
__device__ __forceinline__ void split2(float x, float y, uint32_t (&w)[3]) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
  const float2 h = __bfloat1622float2(hi);
  const float rx = __fsub_rn(x, h.x), ry = __fsub_rn(y, h.y);
  const __nv_bfloat162 mid = __floats2bfloat162_rn(rx, ry);
  const float2 m = __bfloat1622float2(mid);
  const __nv_bfloat162 lo =
      __floats2bfloat162_rn(__fsub_rn(rx, m.x), __fsub_rn(ry, m.y));
  w[0] = bf2_bits(hi);
  w[1] = bf2_bits(mid);
  w[2] = bf2_bits(lo);
}

__device__ __forceinline__ void split_into(uint32_t (&a)[3][4], int i,
                                           float x, float y) {
  uint32_t w[3];
  split2(x, y, w);
  a[0][i] = w[0];
  a[1][i] = w[1];
  a[2][i] = w[2];
}

// d += a b over one 16-deep stage, both in three pieces: the six products
// float32 accuracy needs, smallest first, into a fresh float32 partial
// that is then added to d
__device__ __forceinline__ void mma6(float (&d)[4], const uint32_t (&a)[3][4],
                                     const uint32_t (&b)[3][2]) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(p, a[2], b[0]);   // lo . hi
  mma_bf16(p, a[0], b[2]);   // hi . lo
  mma_bf16(p, a[1], b[1]);   // mid . mid
  mma_bf16(p, a[1], b[0]);   // mid . hi
  mma_bf16(p, a[0], b[1]);   // hi . mid
  mma_bf16(p, a[0], b[0]);   // hi . hi
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += p[i];
}

// The warp's A operand for one 16-deep stage from a float32 row-major tile
// in shared memory (t at the warp's first row and the stage's first
// column; pitch ld), split as it loads.
__device__ __forceinline__ void a_split_smem(uint32_t (&a)[3][4],
                                             const float* t, int ld,
                                             int lane) {
  const int g = lane >> 2, c = 2 * (lane & 3);
  const float2 x0 = *reinterpret_cast<const float2*>(t + g * ld + c);
  const float2 x1 = *reinterpret_cast<const float2*>(t + (g + 8) * ld + c);
  const float2 x2 = *reinterpret_cast<const float2*>(t + g * ld + c + 8);
  const float2 x3 =
      *reinterpret_cast<const float2*>(t + (g + 8) * ld + c + 8);
  split_into(a, 0, x0.x, x0.y);
  split_into(a, 1, x1.x, x1.y);
  split_into(a, 2, x2.x, x2.y);
  split_into(a, 3, x3.x, x3.y);
}

// The same from bf16 piece tiles (t at the warp's first row and the
// stage's first column; pieces `piece` elements apart)
__device__ __forceinline__ void a_pieces_smem(uint32_t (&a)[3][4],
                                              const __nv_bfloat16* t,
                                              int piece, int ld, int lane) {
  const __nv_bfloat16* p = t + (lane & 15) * ld + ((lane >> 4) << 3);
#pragma unroll
  for (int q = 0; q < 3; ++q) ldsm_x4<false>(a[q], p + q * piece);
}

// The A operand for one 16-deep stage from an accumulator in registers:
// its n-tiles c0 (columns 16 j .. 16 j + 7) and c1 (16 j + 8 ..), split in
// place. The accumulator's layout is the A fragment's.
__device__ __forceinline__ void a_split_acc(uint32_t (&a)[3][4],
                                            const float (&c0)[4],
                                            const float (&c1)[4]) {
  split_into(a, 0, c0[0], c0[1]);
  split_into(a, 1, c0[2], c0[3]);
  split_into(a, 2, c1[0], c1[1]);
  split_into(a, 3, c1[2], c1[3]);
}

// B operands of two n-tiles (b[j][piece]) from a bf16 piece tile (pc at the
// first of 16 rows and 16 columns; piece tiles `piece` elements apart).
// ROWS_ARE_N: the tile's rows are the product's columns and its columns
// the stage's depth (K for Q.K^T); else its rows are the depth (V for P.V),
// read with .trans.
template <bool ROWS_ARE_N>
__device__ __forceinline__ void b_pieces(uint32_t (&b)[2][3][2],
                                         const __nv_bfloat16* pc, int piece,
                                         int ld, int lane) {
  const __nv_bfloat16* p =
      ROWS_ARE_N ? pc + ((lane & 7) + ((lane >> 4) << 3)) * ld +
                       ((lane >> 3) & 1) * 8
                 : pc + (lane & 15) * ld + ((lane >> 4) << 3);
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    uint32_t r[4];
    ldsm_x4<!ROWS_ARE_N>(r, p + q * piece);
    b[0][q][0] = r[0];
    b[0][q][1] = r[1];
    b[1][q][0] = r[2];
    b[1][q][1] = r[3];
  }
}

// acc (16 x N) += A . T^T: A the warp's 16 of the block's own rows (a_w;
// bf16 pieces, or float32 split as it loads), T the N rows of a piece
// tile, both D deep
template <int D, int N, bool PIECES>
__device__ __forceinline__ void mm_rows(float (&acc)[N / 8][4],
                                        const void* a_w,
                                        const __nv_bfloat16* pc, int lane) {
  constexpr int LD = D + kMmaPad;
  // one stage at a time: unrolling the stages too runs out of registers
#pragma unroll 1
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[3][4];
    if constexpr (PIECES)
      a_pieces_smem(a, static_cast<const __nv_bfloat16*>(a_w) + 16 * ks,
                    kMmaRows * LD, LD, lane);
    else
      a_split_smem(a, static_cast<const float*>(a_w) + 16 * ks, LD, lane);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t b[2][3][2];
      b_pieces<true>(b, pc + 16 * np * LD + 16 * ks, N * LD, LD, lane);
      mma6(acc[2 * np], a, b[0]);
      mma6(acc[2 * np + 1], a, b[1]);
    }
  }
}

// acc (16 x D) += S . T: S the warp's 16 x N scores in registers, T an
// N x D piece tile
template <int D, int N>
__device__ __forceinline__ void mm_acc(float (&acc)[D / 8][4],
                                       const float (&s)[N / 8][4],
                                       const __nv_bfloat16* pc, int lane) {
  constexpr int LD = D + kMmaPad;
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
    uint32_t a[3][4];
    a_split_acc(a, s[2 * j], s[2 * j + 1]);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[2][3][2];
      b_pieces<false>(b, pc + 16 * j * LD + 16 * np, N * LD, LD, lane);
      mma6(acc[2 * np], a, b[0]);
      mma6(acc[2 * np + 1], a, b[1]);
    }
  }
}

// This thread's 16-byte chunks of rows [r0, r0 + ROWS) of a strided float32
// array into dst (pitch ld), asynchronously; rows at or past `limit` read
// zero. The same thread later reads exactly these chunks, so its own wait
// is enough before it does.
template <int D, int ROWS>
__device__ __forceinline__ void copy_rows(float* dst, int ld,
                                          const float* src, long long stride,
                                          int r0, int limit, int tid) {
  constexpr int CPR = D / 4;
#pragma unroll
  for (int i = 0; i < ROWS * CPR / kMmaThreads; ++i) {
    const int e = tid + i * kMmaThreads, r = e / CPR, c = (e % CPR) * 4;
    const bool ok = r0 + r < limit;
    cp_async16(dst + r * ld + c,
               src + (ok ? static_cast<long long>(r0 + r) * stride + c : 0),
               ok ? 16 : 0);
  }
}

// This thread's chunks of the staging tile (ROWS x D, dense), times `mul`
// (1, or the packed layout's q scale, in float32), into the three piece
// tiles (pitch D + kMmaPad)
template <int D, int ROWS>
__device__ __forceinline__ void split_rows(__nv_bfloat16* pc,
                                           const float* stage, float mul,
                                           int tid) {
  constexpr int CPR = D / 4, LD = D + kMmaPad;
#pragma unroll
  for (int i = 0; i < ROWS * CPR / kMmaThreads; ++i) {
    const int e = tid + i * kMmaThreads, r = e / CPR, c = (e % CPR) * 4;
    const float4 x = *reinterpret_cast<const float4*>(stage + r * D + c);
    uint32_t w0[3], w1[3];
    split2(x.x * mul, x.y * mul, w0);
    split2(x.z * mul, x.w * mul, w1);
#pragma unroll
    for (int q = 0; q < 3; ++q)
      *reinterpret_cast<uint2*>(pc + q * ROWS * LD + r * LD + c) =
          make_uint2(w0[q], w1[q]);
  }
}

// This thread's chunks of a (kMmaRows x D) float32 tile times `mul`, in
// place (the packed layout's q scale)
template <int D>
__device__ __forceinline__ void scale_rows(float* t, float mul, int tid) {
  constexpr int CPR = D / 4, LD = D + kMmaPad;
#pragma unroll
  for (int i = 0; i < kMmaRows * CPR / kMmaThreads; ++i) {
    const int e = tid + i * kMmaThreads, r = e / CPR, c = (e % CPR) * 4;
    float4* p = reinterpret_cast<float4*>(t + r * LD + c);
    float4 x = *p;
    x.x *= mul;
    x.y *= mul;
    x.z *= mul;
    x.w *= mul;
    *p = x;
  }
}

// N-row k-tiles the q-tile at q0 visits: all, or through the one holding
// its last row's diagonal when causal
template <int N>
__device__ __forceinline__ int mma_k_tiles(const Geometry& g, int q0) {
  const int nk = (g.sk + N - 1) / N;
  return g.causal ? min(nk, (min(q0 + kMmaRows, g.sq) - 1) / N + 1) : nk;
}

// The block's own rows: P::kOwn tensors of kMmaRows x D (src[i], rows r0
// .. r0 + kMmaRows of which `limit` exist), the first times mul0 (the
// packed layout's q scale, or 1), into `own`: as bf16 pieces (three tiles
// a tensor) split once by way of the staging region, all of them in place
// after a barrier; or as float32 (pitch D + kMmaPad), each thread's chunks
// in place after its own wait. Then first() issues the first streamed
// tile's copy, which is committed.
template <class P, int D, class First>
__device__ __forceinline__ void load_own(unsigned char* own, float* stage,
                                         const float* src0,
                                         const float* src1,
                                         long long stride, int r0,
                                         int limit, float mul0, int tid,
                                         First first) {
  constexpr int LD = D + kMmaPad;
  const float* src[2] = {src0, src1};
  if constexpr (P::kOwnPieces) {
    __nv_bfloat16* pc = reinterpret_cast<__nv_bfloat16*>(own);
#pragma unroll
    for (int i = 0; i < P::kOwn; ++i)
      copy_rows<D, kMmaRows>(stage + i * kMmaRows * D, D, src[i], stride,
                             r0, limit, tid);
    cp_async_commit();
    cp_async_wait<0>();
#pragma unroll
    for (int i = 0; i < P::kOwn; ++i)
      split_rows<D, kMmaRows>(pc + i * 3 * kMmaRows * LD,
                              stage + i * kMmaRows * D, i ? 1.f : mul0, tid);
    __syncthreads();               // the pieces in; the staging region free
    first();
    cp_async_commit();
  } else {
    float* f = reinterpret_cast<float*>(own);
#pragma unroll
    for (int i = 0; i < P::kOwn; ++i)
      copy_rows<D, kMmaRows>(f + i * kMmaRows * LD, LD, src[i], stride, r0,
                             limit, tid);
    cp_async_commit();
    first();
    cp_async_commit();
    cp_async_wait<1>();
    if (mul0 != 1.f) scale_rows<D>(f, mul0, tid);
  }
}

// The warp's 16 rows of own tensor i
template <class P>
__device__ __forceinline__ const void* own_rows(const unsigned char* own,
                                                int i, int warp) {
  if constexpr (P::kOwnPieces)
    return reinterpret_cast<const __nv_bfloat16*>(own) +
           (i * 3 * kMmaRows + 16 * warp) * P::kLd;
  else
    return reinterpret_cast<const float*>(own) +
           (i * kMmaRows + 16 * warp) * P::kLd;
}

// In every *_mma kernel a thread holds, of each 16 x 8 accumulator tile,
// rows 16 w + lane / 4 and 8 more (r 0, 1) and columns 2 (lane % 4) and
// one more (e 0, 1): elements [2 r + e].

// Grid (B H, q-tiles), the longest q-tiles first. Per k-tile: K's copy
// split into pieces, S = Q.K^T, the online softmax in the score fragments,
// V's copy split into the same piece tiles (K_{t+1} copying meanwhile),
// O += P.V with P split in registers.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, MmaPlan<kFwd, D>::kBlocks)
flash_fwd_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, Geometry g) {
  using Plan = MmaPlan<kFwd, D>;
  constexpr int N = Plan::N, NT = N / 8, ND = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem + Plan::kOwnBytes);
  __nv_bfloat16* pc = reinterpret_cast<__nv_bfloat16*>(stage + N * D);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3;
  const int b = blockIdx.x / g.H, h = blockIdx.x % g.H;
  const int nq = (g.sq + kMmaRows - 1) / kMmaRows;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kMmaRows;
  const int row0 = q0 + 16 * warp + (lane >> 2);
  const float* qb = q + b * g.q_sb + h * g.q_sh;
  const float* kb = k + b * g.k_sb + h * g.k_sh;
  const float* vb = v + b * g.k_sb + h * g.k_sh;
  const void* q_w = own_rows<Plan>(smem, 0, warp);
  const int nk = mma_k_tiles<N>(g, q0);
  const float s_mul = g.prescale ? 1.f : g.scale;

  load_own<Plan, D>(smem, stage, qb, qb, g.q_sr, q0, g.sq,
                    g.prescale ? g.scale : 1.f, tid, [&] {
    copy_rows<D, N>(stage, D, kb, g.k_sr, 0, g.sk, tid);
  });

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[ND][4];
#pragma unroll
  for (int c = 0; c < ND; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * N;
    cp_async_wait<0>();
    __syncthreads();               // K in; the last P.V is done with pc
    split_rows<D, N>(pc, stage, 1.f, tid);
    __syncthreads();
    copy_rows<D, N>(stage, D, vb, g.k_sr, k0, g.sk, tid);
    cp_async_commit();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    mm_rows<D, N, Plan::kOwnPieces>(s, q_w, pc, lane);

    // only a tile across the diagonal or an edge of the arrays masks
    const bool edge = (g.causal && k0 + N - 1 > row0 - (lane >> 2)) ||
                      k0 + N > g.sk || row0 - (lane >> 2) + 16 > g.sq;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[nt][2 * r + e] * s_mul;
          if (edge && masked(g, row0 + 8 * r, k0 + 8 * nt + 2 * t4 + e))
            x = kNegInf;
          s[nt][2 * r + e] = x;
          mx[r] = fmaxf(mx[r], x);
        }
    float corr[2], ps[2] = {0.f, 0.f}, ml[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2_approx((m[r] - m_new) * kLog2e);
      m[r] = m_new;
      ml[r] = m_new * kLog2e;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p =
              exp2_approx(fmaf(s[nt][2 * r + e], kLog2e, -ml[r]));
          s[nt][2 * r + e] = p;
          ps[r] += p;
        }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 1);
      ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 2);
      l[r] = l[r] * corr[r] + ps[r];
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        o[c][2 * r] *= corr[r];
        o[c][2 * r + 1] *= corr[r];
      }
    }

    cp_async_wait<0>();
    __syncthreads();               // V in; Q.K^T is done with pc
    split_rows<D, N>(pc, stage, 1.f, tid);
    __syncthreads();
    if (kt + 1 < nk) copy_rows<D, N>(stage, D, kb, g.k_sr, k0 + N, g.sk, tid);
    cp_async_commit();
    mm_acc<D, N>(o, s, pc, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= g.sq) continue;
    const float ls = fmaxf(l[r], 1e-30f);
    float* orow = out + b * g.q_sb + h * g.q_sh + row * g.q_sr + 2 * t4;
#pragma unroll
    for (int c = 0; c < ND; ++c)
      *reinterpret_cast<float2*>(orow + 8 * c) =
          make_float2(o[c][2 * r] / ls, o[c][2 * r + 1] / ls);
    if (t4 == 0) lse[b * g.l_sb + h * g.l_sh + row * g.l_sr] = m[r] + logf(ls);
  }
}

// Grid (B H, q-tiles), the longest first. Per k-tile: V's copy split, dP =
// dO.V^T; K's copy split into the same piece tiles (V_{t+1} copying
// meanwhile), S = Q.K^T, dS = P (dP - delta) in the score fragments, dQ +=
// dS.K with dS split in registers.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, MmaPlan<kDq, D>::kBlocks)
flash_bwd_dq_mma_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, Geometry g) {
  using Plan = MmaPlan<kDq, D>;
  constexpr int N = Plan::N, NT = N / 8, ND = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem + Plan::kOwnBytes);
  __nv_bfloat16* pc = reinterpret_cast<__nv_bfloat16*>(stage + N * D);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3;
  const int b = blockIdx.x / g.H, h = blockIdx.x % g.H;
  const int nq = (g.sq + kMmaRows - 1) / kMmaRows;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kMmaRows;
  const int row0 = q0 + 16 * warp + (lane >> 2);
  const long long qoff = b * g.q_sb + h * g.q_sh;
  const long long koff = b * g.k_sb + h * g.k_sh;
  const long long loff = b * g.l_sb + h * g.l_sh;
  const void* q_w = own_rows<Plan>(smem, 0, warp);
  const void* do_w = own_rows<Plan>(smem, 1, warp);
  const int nk = mma_k_tiles<N>(g, q0);
  const float s_mul = g.prescale ? 1.f : g.scale;

  // the rows' lse in base 2, and delta
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse_r[r] = row < g.sq ? lse[loff + row * g.l_sr] * kLog2e : 0.f;
    delta_r[r] = row < g.sq ? delta[loff + row * g.l_sr] : 0.f;
  }
  const float s_l2 = s_mul * kLog2e;
  load_own<Plan, D>(smem, stage, q + qoff, dout + qoff, g.q_sr, q0, g.sq,
                    g.prescale ? g.scale : 1.f, tid, [&] {
    copy_rows<D, N>(stage, D, v + koff, g.k_sr, 0, g.sk, tid);
  });

  float acc[ND][4];
#pragma unroll
  for (int c = 0; c < ND; ++c)
    acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * N;
    cp_async_wait<0>();
    __syncthreads();               // V in; the last dS.K is done with pc
    split_rows<D, N>(pc, stage, 1.f, tid);
    __syncthreads();
    copy_rows<D, N>(stage, D, k + koff, g.k_sr, k0, g.sk, tid);
    cp_async_commit();

    float dp[NT][4], s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) dp[nt][i] = s[nt][i] = 0.f;
    mm_rows<D, N, Plan::kOwnPieces>(dp, do_w, pc, lane);

    cp_async_wait<0>();
    __syncthreads();               // K in; dO.V^T is done with pc
    split_rows<D, N>(pc, stage, 1.f, tid);
    __syncthreads();
    if (kt + 1 < nk)
      copy_rows<D, N>(stage, D, v + koff, g.k_sr, k0 + N, g.sk, tid);
    cp_async_commit();
    mm_rows<D, N, Plan::kOwnPieces>(s, q_w, pc, lane);

    const bool edge = (g.causal && k0 + N - 1 > row0 - (lane >> 2)) ||
                      k0 + N > g.sk || row0 - (lane >> 2) + 16 > g.sq;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = exp2_approx(fmaf(s[nt][2 * r + e], s_l2, -lse_r[r]));
          if (edge && masked(g, row0 + 8 * r, k0 + 8 * nt + 2 * t4 + e))
            p = 0.f;
          float ds = p * (dp[nt][2 * r + e] - delta_r[r]);
          if (!g.prescale) ds *= g.scale;
          s[nt][2 * r + e] = ds;
        }
    mm_acc<D, N>(acc, s, pc, lane);
  }

  const float out_mul = g.prescale ? g.scale : 1.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= g.sq) continue;
    float* drow = dq + qoff + row * g.q_sr + 2 * t4;
#pragma unroll
    for (int c = 0; c < ND; ++c)
      *reinterpret_cast<float2*>(drow + 8 * c) =
          make_float2(acc[c][2 * r] * out_mul, acc[c][2 * r + 1] * out_mul);
  }
}

// Grid (B H, k-tiles); under the causal mask k-tile 0 walks the most
// q-tiles, so the longest come first as they are. Per q-tile: Q's copy
// split (scaled first in the packed layout) with its lse and delta rows,
// S^T = K.Q^T, P^T in the score fragments; dout's copy split into its own
// piece tiles (Q_{t+1} copying meanwhile), dP^T = V.dO^T, dV += P^T.dO,
// dS^T = P^T (dP^T - delta), dK += dS^T.Q, P^T and dS^T split in registers.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, MmaPlan<kDkv, D>::kBlocks)
flash_bwd_dkv_mma_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         Geometry g) {
  using Plan = MmaPlan<kDkv, D>;
  constexpr int N = Plan::N, NT = N / 8, ND = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem + Plan::kOwnBytes);
  __nv_bfloat16* pq = reinterpret_cast<__nv_bfloat16*>(stage + N * D);
  __nv_bfloat16* pdo = pq + 3 * Plan::kPiece;
  float* lse_s = reinterpret_cast<float*>(pdo + 3 * Plan::kPiece);
  float* delta_s = lse_s + N;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3;
  const int b = blockIdx.x / g.H, h = blockIdx.x % g.H;
  const int k0 = blockIdx.y * kMmaRows;
  const int krow0 = k0 + 16 * warp + (lane >> 2);
  const long long qoff = b * g.q_sb + h * g.q_sh;
  const long long koff = b * g.k_sb + h * g.k_sh;
  const long long loff = b * g.l_sb + h * g.l_sh;
  const void* k_w = own_rows<Plan>(smem, 0, warp);
  const void* v_w = own_rows<Plan>(smem, 1, warp);
  const int nq = (g.sq + N - 1) / N;
  const int qt0 = g.causal ? k0 / N : 0;
  const float s_mul = g.prescale ? 1.f : g.scale;
  const float q_mul = g.prescale ? g.scale : 1.f;
  const float s_l2 = s_mul * kLog2e;

  load_own<Plan, D>(smem, stage, k + koff, v + koff, g.k_sr, k0, g.sk, 1.f,
                    tid, [&] {
    if (qt0 < nq)
      copy_rows<D, N>(stage, D, q + qoff, g.q_sr, qt0 * N, g.sq, tid);
  });

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int c = 0; c < ND; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[c][i] = dv_acc[c][i] = 0.f;

  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * N;
    cp_async_wait<0>();
    __syncthreads();               // Q in; the last iteration is done
    split_rows<D, N>(pq, stage, q_mul, tid);
    if (tid < N) {
      const int row = q0 + tid;
      lse_s[tid] = row < g.sq ? lse[loff + row * g.l_sr] * kLog2e : 0.f;
      delta_s[tid] = row < g.sq ? delta[loff + row * g.l_sr] : 0.f;
    }
    __syncthreads();
    copy_rows<D, N>(stage, D, dout + qoff, g.q_sr, q0, g.sq, tid);
    cp_async_commit();

    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[nt][i] = dpt[nt][i] = 0.f;
    mm_rows<D, N, Plan::kOwnPieces>(st, k_w, pq, lane);
    const bool edge = (g.causal && krow0 - (lane >> 2) + 15 > q0) ||
                      q0 + N > g.sq || krow0 - (lane >> 2) + 16 > g.sk;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ci = 8 * nt + 2 * t4 + e;    // the q row, in the tile
          float p = exp2_approx(fmaf(st[nt][2 * r + e], s_l2, -lse_s[ci]));
          if (edge && masked(g, q0 + ci, krow0 + 8 * r)) p = 0.f;
          st[nt][2 * r + e] = p;
        }

    cp_async_wait<0>();
    __syncthreads();               // dout in
    split_rows<D, N>(pdo, stage, 1.f, tid);
    __syncthreads();
    if (qt + 1 < nq)
      copy_rows<D, N>(stage, D, q + qoff, g.q_sr, q0 + N, g.sq, tid);
    cp_async_commit();
    mm_rows<D, N, Plan::kOwnPieces>(dpt, v_w, pdo, lane);
    mm_acc<D, N>(dv_acc, st, pdo, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ci = 8 * nt + 2 * t4 + e;
          float ds = st[nt][2 * r + e] * (dpt[nt][2 * r + e] - delta_s[ci]);
          if (!g.prescale) ds *= g.scale;
          dpt[nt][2 * r + e] = ds;
        }
    mm_acc<D, N>(dk_acc, dpt, pq, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = krow0 + 8 * r;
    if (row >= g.sk) continue;
    float* krow = dk + koff + row * g.k_sr + 2 * t4;
    float* vrow = dv + koff + row * g.k_sr + 2 * t4;
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      *reinterpret_cast<float2*>(krow + 8 * c) =
          make_float2(dk_acc[c][2 * r], dk_acc[c][2 * r + 1]);
      *reinterpret_cast<float2*>(vrow + 8 * c) =
          make_float2(dv_acc[c][2 * r], dv_acc[c][2 * r + 1]);
    }
  }
}


template <typename T, int D>
constexpr size_t smem_bytes(int kind) {
  const int tiles = kind == kFwd ? 3 : 4;   // q/k/v-like tiles
  const int p_tiles = kind == kDkv ? 2 : 1;
  return sizeof(T) * (tiles * kTile * ld<T, D>() + p_tiles * kTile * ldp<T>())
         + sizeof(float) * (scratch_floats<T, D>()
                            + (kind == kDkv ? 2 * kTile : 0));
}

template <typename K>
int launch(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
           void** args) {
  cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), grid,
                       dim3(threads), args, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// the bf16 WMMA kernels and the float32 FMA kernels
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
    return launch(flash_fwd_kernel<T, D>, dim3(nq, g.H, g.B), kThreads,
                  smem_bytes<T, D>(kFwd), stream, args);
  }
  if (kind == kDq) {
    void* args[] = {&qp, &kp, &vp, &dp, &lse, &delta, &a, &g};
    return launch(flash_bwd_dq_kernel<T, D>, dim3(nq, g.H, g.B), kThreads,
                  smem_bytes<T, D>(kDq), stream, args);
  }
  void* args[] = {&qp, &kp, &vp, &dp, &lse, &delta, &a, &c, &g};
  return launch(flash_bwd_dkv_kernel<T, D>, dim3(nk, g.H, g.B), kThreads,
                smem_bytes<T, D>(kDkv), stream, args);
}

// the float32 route: grid (B H, tiles)
template <int D>
int run_mma(int kind, const void* q, const void* k, const void* v,
            const void* dout, const float* lse, const float* delta,
            void* o0, void* o1, float* lse_out, Geometry g,
            cudaStream_t stream) {
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dp = static_cast<const float*>(dout);
  float* a = static_cast<float*>(o0);
  float* c = static_cast<float*>(o1);
  const int bh = g.B * g.H;
  const int nq = (g.sq + kMmaRows - 1) / kMmaRows;
  const int nk = (g.sk + kMmaRows - 1) / kMmaRows;
  if (kind == kFwd) {
    void* args[] = {&qp, &kp, &vp, &a, &lse_out, &g};
    return launch(flash_fwd_mma_kernel<D>, dim3(bh, nq), kMmaThreads,
                  MmaPlan<kFwd, D>::kSmem, stream, args);
  }
  if (kind == kDq) {
    void* args[] = {&qp, &kp, &vp, &dp, &lse, &delta, &a, &g};
    return launch(flash_bwd_dq_mma_kernel<D>, dim3(bh, nq), kMmaThreads,
                  MmaPlan<kDq, D>::kSmem, stream, args);
  }
  void* args[] = {&qp, &kp, &vp, &dp, &lse, &delta, &a, &c, &g};
  return launch(flash_bwd_dkv_mma_kernel<D>, dim3(bh, nk), kMmaThreads,
                MmaPlan<kDkv, D>::kSmem, stream, args);
}

template <int D>
int run_route(int kind, int dtype, int fma, const void* q, const void* k,
              const void* v, const void* dout, const float* lse,
              const float* delta, void* o0, void* o1, float* lse_out,
              const Geometry& g, cudaStream_t st) {
  if (dtype == 0 && !fma)
    return run_mma<D>(kind, q, k, v, dout, lse, delta, o0, o1, lse_out, g,
                      st);
  if (dtype == 0)
    return run<float, D>(kind, q, k, v, dout, lse, delta, o0, o1, lse_out,
                         g, st);
  if (dtype == 1 && !fma)
    return run<__nv_bfloat16, D>(kind, q, k, v, dout, lse, delta, o0, o1,
                                 lse_out, g, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// kind: 0 forward (o0 = out, lse_out), 1 dq (o0 = dq), 2 dk/dv (o0 = dk,
// o1 = dv). layout: 0 packed, 1 head-major (see the top of the file).
// dtype: 0 float32, 1 bfloat16; d in {32, 64, 128}. fma: 0 the type's
// kernels (float32: the *_mma kernels; bf16: WMMA), 1 the float32 FMA
// kernels (float32 only). Returns a cudaError_t as int.
int flash_attention_launch(int kind, int layout, int dtype, int fma,
                           const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* o0, void* o1,
                           float* lse_out, int B, int H, int sq, int sk,
                           int d, int causal, float scale, void* stream) {
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
  switch (d) {
    case 32: return run_route<32>(kind, dtype, fma, q, k, v, dout, lse,
                                  delta, o0, o1, lse_out, g, st);
    case 64: return run_route<64>(kind, dtype, fma, q, k, v, dout, lse,
                                  delta, o0, o1, lse_out, g, st);
    case 128: return run_route<128>(kind, dtype, fma, q, k, v, dout, lse,
                                    delta, o0, o1, lse_out, g, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
