// Fused conv + batch-norm + ReLU kernels of the bottleneck ResNet stages on
// Hopper (sm_90a), float32 or bfloat16, NHWC rows.
//
// Replaces the Pallas TPU kernels of
// incubator_mxnet_tpu/ops/pallas/conv_fused.py:
//   cf_fwd_kernel<T, 1>    <-  mm_fused         y = x^ @ W (+ bias), stats
//   cf_fwd_kernel<T, 3>    <-  conv3_fused      y = conv3x3_s1_p1(x^), stats
//   cf_dgrad_kernel<T, 1, false>  \
//   cf_wgrad_kernel<T, 1, false>  /-  mm_fused_bwd     dz, partials; dW
//   cf_dgrad_kernel<T, 3, false>  \
//   cf_wgrad_kernel<T, 3, false>  /-  conv3_fused_bwd  dz, partials; dW9
//   cf_dgrad_kernel<T, 1, true>   \   dgrad_epilogue   dx = G_a W_a^T +
//   cf_wgrad_kernel<T, 1, true>   /                    G_b W_b^T; dW_a, dW_b
// with the reference's rounding points: the load transform (x^ = x,
// relu(a x + b), or the entry form relu(a x + b + asc sc + bsc); the
// backward's G = g or (dzn g0 - g1) - yout g2) is computed in float32 and
// rounded to the input type before the product; products accumulate in
// float32; the outputs are rounded to the input type, and the batch-norm
// sums (sum y, sum y^2; sum dz, sum dz * partner) are taken over the
// ROUNDED stored values.
//
// Every kernel is one implicit GEMM over NHWC rows (B*H*W, C). A 1x1 conv
// is the KS = 1 case with one tap; the 3x3 stride-1 pad-1 conv has nine
// taps, reduction index k = tap * C + c, and reads each tap's input row
// with a bounds check instead of the TPU's padded copy of the whole map.
// The zero padding belongs to x^ (and to G), not to x: an out-of-range tap
// contributes 0 AFTER the transform, since relu(a * 0 + b) need not be 0.
// Weights are read in the gluon layouts through strides (tap, c, n): the
// 1x1 weight (O, 1, 1, I) and the 3x3 weight (O, 3, 3, I) are never copied.
//
// The dual form (DUAL = true) serves block 0 of a stage, whose input feeds
// two 1x1 convs (conv1 and the projection): both G sets are formed on
// load, the reduction runs over the N_a + N_b channels of both, so the two
// dgrads meet in one float32 accumulator and dx is rounded and written
// once; the wgrad launch covers the N_a + N_b output columns of both
// weights off the same x. It is a template flag, so the single form's code
// carries none of the second set's selects.
//
// The TPU walks rows in a sequential grid and accumulates the stats, dW and
// the partials in resident outputs. Hopper blocks run in no order, so:
//   * the forward and the dgrad write one row of column sums per 128-row
//     block, (blocks, rows, cols) float32, which the wrapper sums;
//   * dW has its own launch: a grid over (K tile, N tile, M split), each
//     block walking its split of the rows and writing a float32 partial
//     that the wrapper sums. No atomics: results repeat run to run.
//
// What bounds it on an H100: at the ResNet-50 shapes (M 6272..100352 rows,
// K and N 128..2048, or 9 x 128..512) the products, 2 M K N flops, outweigh
// the bytes in both types, so the kernels are built around the product: a
// 128 x 64 output tile per block of 256 threads, 32-deep reduction steps
// staged through shared memory in the input type, bf16 on the tensor cores
// (WMMA 16x16x16 with float32 accumulators, 2 x 2 fragments a warp) and
// float32 as FMAs on the CUDA cores (each thread an 8 x 4 block; no TF32,
// so float32 matches the plain twin). The next step's global loads are
// issued before the current step's products. In bf16, mm_fused and
// dgrad_epilogue take the wgmma kernels of conv_fused_sm90.cu wherever the
// wrapper's route allows; these kernels serve float32, every other shape,
// and the other three kernels.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

namespace wmma = nvcuda::wmma;

constexpr int kBM = 128;            // output rows of a block tile
constexpr int kBN = 64;             // output columns of a block tile
constexpr int kBK = 32;             // reduction depth of one step
constexpr int kThreads = 256;
constexpr int kLDA = kBK + 8;       // As[kBM][kLDA], input type
constexpr int kLDB = kBN + 8;       // Bs[kBK][kLDB], input type
constexpr int kLDC = kBN + 4;       // Cs[kBM][kLDC], float32

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T cast(float v);
template <> __device__ __forceinline__ float cast<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
cast<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// a * v + b with both roundings of the reference (no fused multiply-add)
__device__ __forceinline__ float affine(float v, float a, float b) {
  return __fadd_rn(__fmul_rn(v, a), b);
}

// G = (dzn * g0 - g1) - yout * g2, the producing batch norm's backward as
// an affine of two raw tensors, in float32 as the reference orders it
__device__ __forceinline__ float bn_g(float dzn, float yout, float g0,
                                      float g1, float g2) {
  return __fsub_rn(__fsub_rn(__fmul_rn(dzn, g0), g1), __fmul_rn(yout, g2));
}

template <typename T>
struct Smem {
  static constexpr int kAB = (kBM * kLDA + kBK * kLDB) * (int)sizeof(T);
  static constexpr int kC = kBM * kLDC * (int)sizeof(float);
  static constexpr int kBytes = kAB > kC ? kAB : kC;
};

// The block's products: acc (kBM x kBN) += As (kBM x kBK) @ Bs (kBK x kBN).
template <typename T> struct Core;

template <> struct Core<__nv_bfloat16> {
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  Acc acc[2][2];                    // warp (w / 2, w % 2): 32 x 32

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }
  __device__ void step(const __nv_bfloat16* As, const __nv_bfloat16* Bs) {
    const int warp = threadIdx.x >> 5;
    const int r0 = (warp >> 1) * 32, c0 = (warp & 1) * 32;
#pragma unroll
    for (int k = 0; k < kBK; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (r0 + 16 * i) * kLDA + k, kLDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + k * kLDB + c0 + 16 * j, kLDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  __device__ void store(float* Cs) {
    const int warp = threadIdx.x >> 5;
    const int r0 = (warp >> 1) * 32, c0 = (warp & 1) * 32;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (r0 + 16 * i) * kLDC + c0 + 16 * j,
                                acc[i][j], kLDC, wmma::mem_row_major);
  }
};

template <> struct Core<float> {
  float acc[8][4];                  // thread (ty, tx): rows ty + 16 i,
                                    // columns tx + 16 j
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  __device__ void step(const float* As, const float* Bs) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[(ty + 16 * i) * kLDA + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k * kLDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  __device__ void store(float* Cs) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Cs[(ty + 16 * i) * kLDC + tx + 16 * j] = acc[i][j];
  }
};

// Reduction index k of a KS x KS conv over C channels -> (tap, c) and the
// tap's (row, column) offset in -KS/2 .. KS/2.
template <int KS>
__device__ __forceinline__ void split_k(int k, int C, int& tap, int& c,
                                        int& dr, int& ds) {
  if (KS == 1) {
    tap = 0; c = k; dr = 0; ds = 0;
  } else {
    tap = k / C;
    c = k - tap * C;
    dr = tap / KS - KS / 2;
    ds = tap % KS - KS / 2;
  }
}

// ---------------------------------------------------------------- forward
struct FwdArgs {
  const void* x; const float* a; const float* b;
  const void* sc; const float* asc; const float* bsc;
  const void* w; long long s_tap, s_c, s_n;
  const float* bias;
  void* y; float* stats; void* xhat;
  int M, C, N, H, W;
};

// Weight tile Bs[kk][nn] = w[tap, c, n] for k = k0 + kk (reduction) and
// n = n0 + nn, loaded along whichever of (c, n) is contiguous.
template <typename T, int KS>
__device__ __forceinline__ void load_w_kn(const T* w, long long s_tap,
                                          long long s_c, long long s_n,
                                          int k0, int n0, int Kp, int C,
                                          int N, float (&reg)[8]) {
  const int tid = threadIdx.x;
  int tap, c, dr, ds;
  if (s_c == 1) {                    // reduction index contiguous
    const int k = k0 + (tid & 31);
    split_k<KS>(k, C, tap, c, dr, ds);
    const long long base = tap * s_tap + c;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (tid >> 5) + 8 * j;
      reg[j] = (k < Kp && n < N) ? f32(w[base + n * s_n]) : 0.f;
    }
  } else {                           // output index contiguous
    const int n = n0 + (tid & 63);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + (tid >> 6) + 4 * j;
      split_k<KS>(k, C, tap, c, dr, ds);
      reg[j] = (k < Kp && n < N)
                   ? f32(w[tap * s_tap + c * s_c + n * s_n]) : 0.f;
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_w_kn(T* Bs, long long s_c,
                                           const float (&reg)[8]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (s_c == 1)
      Bs[(tid & 31) * kLDB + (tid >> 5) + 8 * j] = cast<T>(reg[j]);
    else
      Bs[((tid >> 6) + 4 * j) * kLDB + (tid & 63)] = cast<T>(reg[j]);
  }
}

template <typename T, int KS>
__global__ void __launch_bounds__(kThreads) cf_fwd_kernel(FwdArgs p) {
  __shared__ __align__(128) unsigned char raw[Smem<T>::kBytes];
  __shared__ int ph[kBM], pw[kBM];
  __shared__ float red[4][2][kBN];
  T* As = reinterpret_cast<T*>(raw);
  T* Bs = As + kBM * kLDA;
  float* Cs = reinterpret_cast<float*>(raw);
  const T* x = static_cast<const T*>(p.x);
  const T* sc = static_cast<const T*>(p.sc);
  const T* w = static_cast<const T*>(p.w);
  T* xhat = static_cast<T*>(p.xhat);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int Kp = KS * KS * p.C;
  if (tid < kBM) {
    const int m = m0 + tid;
    ph[tid] = (m / p.W) % p.H;
    pw[tid] = m % p.W;
  }
  __syncthreads();
  const bool emit = xhat != nullptr && blockIdx.y == 0;   // KS == 1 only

  // A: column kk = tid % 32 of the step, rows tid / 32 + 8 j
  const int kk = tid & 31;
  float ra[kBM / 8], rb[8];
  auto fetch = [&](int k0) {
    const int k = k0 + kk;
    const bool kv = k < Kp;
    int tap, c, dr, ds;
    split_k<KS>(kv ? k : 0, p.C, tap, c, dr, ds);
    float ca = 1.f, cb = 0.f, cas = 0.f, cbs = 0.f;
    if (kv && p.a) { ca = p.a[c]; cb = p.b[c]; }
    if (kv && sc) { cas = p.asc[c]; cbs = p.bsc[c]; }
#pragma unroll
    for (int j = 0; j < kBM / 8; ++j) {
      const int r = (tid >> 5) + 8 * j;
      const int m = m0 + r;
      float v = 0.f;
      const int hh = ph[r] + dr, ww = pw[r] + ds;
      if (kv && m < p.M && hh >= 0 && hh < p.H && ww >= 0 && ww < p.W) {
        const size_t src = (size_t)(m + dr * p.W + ds) * p.C + c;
        v = f32(x[src]);
        if (p.a) {
          float z = affine(v, ca, cb);
          if (sc) z = __fadd_rn(__fadd_rn(z, __fmul_rn(f32(sc[src]), cas)),
                                cbs);
          v = f32(cast<T>(fmaxf(z, 0.f)));
        }
        if (emit) xhat[src] = cast<T>(v);
      }
      ra[j] = v;
    }
    load_w_kn<T, KS>(w, p.s_tap, p.s_c, p.s_n, k0, n0, Kp, p.C, p.N, rb);
  };

  Core<T> core;
  core.zero();
  fetch(0);
  for (int k0 = 0; k0 < Kp; k0 += kBK) {
#pragma unroll
    for (int j = 0; j < kBM / 8; ++j)
      As[((tid >> 5) + 8 * j) * kLDA + kk] = cast<T>(ra[j]);
    store_w_kn<T>(Bs, p.s_c, rb);
    __syncthreads();
    if (k0 + kBK < Kp) fetch(k0 + kBK);
    core.step(As, Bs);
    __syncthreads();
  }
  core.store(Cs);
  __syncthreads();

  // epilogue: column cc, rows 32 rg .. 32 rg + 31
  T* y = static_cast<T*>(p.y);
  const int cc = tid & 63, rg = tid >> 6;
  const int n = n0 + cc;
  float s1 = 0.f, s2 = 0.f;
  if (n < p.N) {
    const float bv = p.bias ? p.bias[n] : 0.f;
    for (int i = 0; i < 32; ++i) {
      const int r = rg * 32 + i;
      const int m = m0 + r;
      if (m >= p.M) break;
      float v = Cs[r * kLDC + cc];
      if (p.bias) v = __fadd_rn(v, bv);
      const T yc = cast<T>(v);
      y[(size_t)m * p.N + n] = yc;
      const float yf = f32(yc);
      s1 += yf;
      s2 = fmaf(yf, yf, s2);
    }
  }
  if (p.stats) {
    red[rg][0][cc] = s1;
    red[rg][1][cc] = s2;
    __syncthreads();
    if (tid < kBN && n < p.N) {
      float t1 = 0.f, t2 = 0.f;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        t1 += red[g][0][tid];
        t2 += red[g][1][tid];
      }
      p.stats[((size_t)blockIdx.x * 2) * p.N + n] = t1;
      p.stats[((size_t)blockIdx.x * 2 + 1) * p.N + n] = t2;
    }
  }
}

// ------------------------------------------------------------------ dgrad
struct DgradArgs {
  const void* g; const void* dzn; const void* yout; const float* gc;
  const void* w; long long s_tap, s_c, s_n;
  const void* x; const float* a; const float* b;
  const void* dsc; const void* p0; const void* p1;
  int n_partners, mask;              // mask: 0 none, 1 on x, 2 on a x + b
  void* dz; float* part;             // part null: no partials
  int M, C, N, H, W;
  // the dual form's second G set (1x1 only; Nb = 0 otherwise)
  const void* dzn_b; const void* yout_b; const float* gc_b;
  const void* w_b; long long s_c_b, s_n_b;
  int Nb;
};

// dz (M x C) = mask(sum over taps and n of G[pixel - tap, n] w[tap, c, n]
// (+ dsc)); the reduction index is k = tap * N + n, then, in the dual
// form, Kb0 + n for the second G set's column n.
template <typename T, int KS, bool DUAL>
__global__ void __launch_bounds__(kThreads) cf_dgrad_kernel(DgradArgs p) {
  __shared__ __align__(128) unsigned char raw[Smem<T>::kBytes];
  __shared__ int ph[kBM], pw[kBM];
  __shared__ float red[4][3][kBN];
  T* As = reinterpret_cast<T*>(raw);
  T* Bs = As + kBM * kLDA;
  float* Cs = reinterpret_cast<float*>(raw);
  const T* g = static_cast<const T*>(p.g);
  const T* dzn = static_cast<const T*>(p.dzn);
  const T* yout = static_cast<const T*>(p.yout);
  const T* w = static_cast<const T*>(p.w);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM, c0 = blockIdx.y * kBN;
  const int Ka = KS * KS * p.N;      // the first G set's reduction length
  // the second set's columns start at the next step boundary, so every
  // step reads one set only (set a's tail steps are zero-filled)
  const int Kb0 = DUAL ? (Ka + kBK - 1) / kBK * kBK : Ka;
  const int Kp = DUAL ? Kb0 + p.Nb : Ka;
  if (tid < kBM) {
    const int m = m0 + tid;
    ph[tid] = (m / p.W) % p.H;
    pw[tid] = m % p.W;
  }
  __syncthreads();

  const int kk = tid & 31;
  float ra[kBM / 8], rb[8];
  auto fetch = [&](int k0) {         // a step of the first (or only) set
    const int k = k0 + kk;
    const bool kv = k < Ka;
    int tap, n, dr, ds;
    split_k<KS>(kv ? k : 0, p.N, tap, n, dr, ds);
    float g0 = 0.f, g1 = 0.f, g2 = 0.f;
    if (kv && !g) { g0 = p.gc[n]; g1 = p.gc[p.N + n]; g2 = p.gc[2 * p.N + n]; }
#pragma unroll
    for (int j = 0; j < kBM / 8; ++j) {
      const int r = (tid >> 5) + 8 * j;
      const int m = m0 + r;
      float v = 0.f;
      const int hh = ph[r] - dr, ww = pw[r] - ds;
      if (kv && m < p.M && hh >= 0 && hh < p.H && ww >= 0 && ww < p.W) {
        const size_t src = (size_t)(m - dr * p.W - ds) * p.N + n;
        v = g ? f32(g[src])
              : f32(cast<T>(bn_g(f32(dzn[src]), f32(yout[src]), g0, g1, g2)));
      }
      ra[j] = v;
    }
    // weights: Bs[kk][cc] = w[tap, c0 + cc, n] for k = k0 + kk
    if (p.s_c == 1) {                // output channel contiguous
      const int c = c0 + (tid & 63);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kr = k0 + (tid >> 6) + 4 * j;
        int tp, nn, a1, a2;
        split_k<KS>(kr, p.N, tp, nn, a1, a2);
        rb[j] = (kr < Ka && c < p.C)
                    ? f32(w[tp * p.s_tap + c + nn * p.s_n]) : 0.f;
      }
    } else {
      const long long base = tap * p.s_tap + n * p.s_n;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + (tid >> 5) + 8 * j;
        rb[j] = (kv && c < p.C) ? f32(w[base + c * p.s_c]) : 0.f;
      }
    }
  };
  // a step of the dual form's second set (1x1): column n = k - Kb0 of
  // G_b and w_b, staged in the first set's layout of Bs
  auto fetch_b = [&](int k0) {
    const T* dzn_b = static_cast<const T*>(p.dzn_b);
    const T* yout_b = static_cast<const T*>(p.yout_b);
    const T* w_b = static_cast<const T*>(p.w_b);
    const int n = k0 - Kb0 + kk;
    const bool kv = n < p.Nb;
    float g0 = 0.f, g1 = 0.f, g2 = 0.f;
    if (kv) {
      g0 = p.gc_b[n]; g1 = p.gc_b[p.Nb + n]; g2 = p.gc_b[2 * p.Nb + n];
    }
#pragma unroll
    for (int j = 0; j < kBM / 8; ++j) {
      const int m = m0 + (tid >> 5) + 8 * j;
      float v = 0.f;
      if (kv && m < p.M) {
        const size_t src = (size_t)m * p.Nb + n;
        v = f32(cast<T>(bn_g(f32(dzn_b[src]), f32(yout_b[src]), g0, g1,
                             g2)));
      }
      ra[j] = v;
    }
    if (p.s_c == 1) {
      const int c = c0 + (tid & 63);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int nr = k0 - Kb0 + (tid >> 6) + 4 * j;
        rb[j] = (nr < p.Nb && c < p.C)
                    ? f32(w_b[c * p.s_c_b + nr * p.s_n_b]) : 0.f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + (tid >> 5) + 8 * j;
        rb[j] = (kv && c < p.C) ? f32(w_b[n * p.s_n_b + c * p.s_c_b]) : 0.f;
      }
    }
  };

  Core<T> core;
  core.zero();
  fetch(0);
  for (int k0 = 0; k0 < Kp; k0 += kBK) {
#pragma unroll
    for (int j = 0; j < kBM / 8; ++j)
      As[((tid >> 5) + 8 * j) * kLDA + kk] = cast<T>(ra[j]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (p.s_c == 1)
        Bs[((tid >> 6) + 4 * j) * kLDB + (tid & 63)] = cast<T>(rb[j]);
      else
        Bs[(tid & 31) * kLDB + (tid >> 5) + 8 * j] = cast<T>(rb[j]);
    }
    __syncthreads();
    if (k0 + kBK < Kb0) fetch(k0 + kBK);
    else if (DUAL && k0 + kBK < Kp) fetch_b(k0 + kBK);
    core.step(As, Bs);
    __syncthreads();
  }
  core.store(Cs);
  __syncthreads();

  const T* x = static_cast<const T*>(p.x);
  const T* dsc = static_cast<const T*>(p.dsc);
  const T* q0 = static_cast<const T*>(p.p0);
  const T* q1 = static_cast<const T*>(p.p1);
  T* dz = static_cast<T*>(p.dz);
  const int cc = tid & 63, rg = tid >> 6;
  const int c = c0 + cc;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  if (c < p.C) {
    const float ca = p.mask == 2 ? p.a[c] : 0.f;
    const float cb = p.mask == 2 ? p.b[c] : 0.f;
    for (int i = 0; i < 32; ++i) {
      const int r = rg * 32 + i;
      const int m = m0 + r;
      if (m >= p.M) break;
      const size_t idx = (size_t)m * p.C + c;
      float v = Cs[r * kLDC + cc];
      if (dsc) v = __fadd_rn(v, f32(dsc[idx]));
      if (p.mask == 1 && !(f32(x[idx]) > 0.f)) v = 0.f;
      if (p.mask == 2 && !(affine(f32(x[idx]), ca, cb) > 0.f)) v = 0.f;
      const T dc = cast<T>(v);
      dz[idx] = dc;
      const float df = f32(dc);
      s0 += df;
      if (p.n_partners > 0) s1 = fmaf(df, f32(q0[idx]), s1);
      if (p.n_partners > 1) s2 = fmaf(df, f32(q1[idx]), s2);
    }
  }
  red[rg][0][cc] = s0;
  red[rg][1][cc] = s1;
  red[rg][2][cc] = s2;
  __syncthreads();
  if (p.part && tid < kBN && c < p.C) {
    const int rows = 1 + p.n_partners;
    for (int q = 0; q < rows; ++q) {
      float t = 0.f;
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) t += red[gi][q][tid];
      p.part[((size_t)blockIdx.x * rows + q) * p.C + c] = t;
    }
  }
}

// ------------------------------------------------------------------ wgrad
struct WgradArgs {
  const void* x; const float* a; const float* b;
  const void* g; const void* dzn; const void* yout; const float* gc;
  float* ws; int chunk;
  int M, C, N, H, W;
  // the dual form's second G set (1x1 only; Nb = 0 otherwise)
  const void* dzn_b; const void* yout_b; const float* gc_b;
  int Nb;
};

// dW[n, tap, c] = sum over rows m of this split of x^[m + tap, c] G[m, n],
// written as ws[split, n, tap * C + c] (the gluon weight order); in the
// dual form the columns N .. N + Nb - 1 are the second G set's.
template <typename T, int KS, bool DUAL>
__global__ void __launch_bounds__(kThreads) cf_wgrad_kernel(WgradArgs p) {
  __shared__ __align__(128) unsigned char raw[Smem<T>::kBytes];
  __shared__ int th[kBK], tw[kBK];
  T* As = reinterpret_cast<T*>(raw);
  T* Bs = As + kBM * kLDA;
  float* Cs = reinterpret_cast<float*>(raw);
  const T* x = static_cast<const T*>(p.x);
  const T* g = static_cast<const T*>(p.g);
  const int tid = threadIdx.x;
  const int Kp = KS * KS * p.C;
  const int Nt = DUAL ? p.N + p.Nb : p.N;
  const int kr = tid & 127;                       // this thread's A row
  const int k = blockIdx.x * kBM + kr;
  const int n0 = blockIdx.y * kBN;
  const int mb = blockIdx.z * p.chunk;
  const int me = min(p.M, mb + p.chunk);
  const bool kv = k < Kp;
  int tap, c, dr, ds;
  split_k<KS>(kv ? k : 0, p.C, tap, c, dr, ds);
  const float ca = (kv && p.a) ? p.a[c] : 1.f;
  const float cb = (kv && p.a) ? p.b[c] : 0.f;
  const int nn = tid & 63;
  const int n = n0 + nn;
  const bool nb = DUAL && n >= p.N;  // a column of the second G set
  const int nl = nb ? n - p.N : n;
  const int ldn = nb ? p.Nb : p.N;
  const T* dzn = static_cast<const T*>(nb ? p.dzn_b : p.dzn);
  const T* yout = static_cast<const T*>(nb ? p.yout_b : p.yout);
  const float* gcs = nb ? p.gc_b : p.gc;
  const bool direct = g && !nb;
  float g0 = 0.f, g1 = 0.f, g2 = 0.f;
  if (n < Nt && !direct) {
    g0 = gcs[nl]; g1 = gcs[ldn + nl]; g2 = gcs[2 * ldn + nl];
  }

  Core<T> core;
  core.zero();
  for (int m0 = mb; m0 < me; m0 += kBK) {
    if (tid < kBK) {
      const int m = m0 + tid;
      th[tid] = (m / p.W) % p.H;
      tw[tid] = m % p.W;
    }
    __syncthreads();
    // As[kr][mm] = x^ at row m0 + mm, shifted by this row's tap
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) {
      const int mm = (tid >> 7) + 2 * j;
      const int m = m0 + mm;
      float v = 0.f;
      const int hh = th[mm] + dr, ww = tw[mm] + ds;
      if (kv && m < me && hh >= 0 && hh < p.H && ww >= 0 && ww < p.W) {
        v = f32(x[(size_t)(m + dr * p.W + ds) * p.C + c]);
        if (p.a) v = fmaxf(affine(v, ca, cb), 0.f);
      }
      As[kr * kLDA + mm] = cast<T>(v);
    }
    // Bs[mm][nn] = G[m0 + mm, n]
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int mm = (tid >> 6) + 4 * j;
      const int m = m0 + mm;
      float v = 0.f;
      if (m < me && n < Nt) {
        const size_t idx = (size_t)m * ldn + nl;
        v = direct ? f32(g[idx])
                   : bn_g(f32(dzn[idx]), f32(yout[idx]), g0, g1, g2);
      }
      Bs[mm * kLDB + nn] = cast<T>(v);
    }
    __syncthreads();
    core.step(As, Bs);
    __syncthreads();
  }
  core.store(Cs);
  __syncthreads();
  const int ng = tid >> 7;
  if (kv) {
    for (int i = 0; i < kBN / 2; ++i) {
      const int col = ng * (kBN / 2) + i;
      const int nc = n0 + col;
      if (nc >= Nt) break;
      p.ws[((size_t)blockIdx.z * Nt + nc) * Kp + k] = Cs[kr * kLDC + col];
    }
  }
}

template <typename T>
int fwd(int ks, const FwdArgs& p, cudaStream_t st) {
  const dim3 grid((p.M + kBM - 1) / kBM, (p.N + kBN - 1) / kBN);
  if (ks == 1) cf_fwd_kernel<T, 1><<<grid, kThreads, 0, st>>>(p);
  else cf_fwd_kernel<T, 3><<<grid, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ks 1 with Nb > 0 launches the dual form
template <typename T>
int dgrad(int ks, const DgradArgs& p, cudaStream_t st) {
  const dim3 grid((p.M + kBM - 1) / kBM, (p.C + kBN - 1) / kBN);
  if (ks == 3) cf_dgrad_kernel<T, 3, false><<<grid, kThreads, 0, st>>>(p);
  else if (p.Nb > 0)
    cf_dgrad_kernel<T, 1, true><<<grid, kThreads, 0, st>>>(p);
  else cf_dgrad_kernel<T, 1, false><<<grid, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int wgrad(int ks, int splits, const WgradArgs& p, cudaStream_t st) {
  const dim3 grid((ks * ks * p.C + kBM - 1) / kBM,
                  (p.N + p.Nb + kBN - 1) / kBN, splits);
  if (ks == 3) cf_wgrad_kernel<T, 3, false><<<grid, kThreads, 0, st>>>(p);
  else if (p.Nb > 0)
    cf_wgrad_kernel<T, 1, true><<<grid, kThreads, 0, st>>>(p);
  else cf_wgrad_kernel<T, 1, false><<<grid, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int ks, int M, int C, int N, int H, int W) {
  return (ks != 1 && ks != 3) || M < 0 || C < 1 || N < 1 || H < 1 ||
         W < 1 || (ks == 3 && M % (H * W) != 0);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; ks: 1 or 3. Returns a cudaError_t as
// int. stats: (ceil(M / 128), 2, N) float32 partials or null.
int conv_fused_fwd_launch(int dtype, int ks, const void* x, const float* a,
                          const float* b, const void* sc, const float* asc,
                          const float* bsc, const void* w, long long s_tap,
                          long long s_c, long long s_n, const float* bias,
                          void* y, float* stats, void* xhat, int M, int C,
                          int N, int H, int W, void* stream) {
  if (bad_shape(ks, M, C, N, H, W) || (ks == 3 && (sc || xhat || bias)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const FwdArgs p{x, a, b, sc, asc, bsc, w, s_tap, s_c, s_n, bias,
                  y, stats, xhat, M, C, N, H, W};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(ks, p, st);
  if (dtype == 1) return fwd<__nv_bfloat16>(ks, p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// part: (ceil(M / 128), 1 + n_partners, C) float32 partials.
int conv_fused_dgrad_launch(int dtype, int ks, const void* g,
                            const void* dzn, const void* yout,
                            const float* gc, const void* w, long long s_tap,
                            long long s_c, long long s_n, const void* x,
                            const float* a, const float* b, const void* dsc,
                            const void* p0, const void* p1, int n_partners,
                            int mask, void* dz, float* part, int M, int C,
                            int N, int H, int W, void* stream) {
  if (bad_shape(ks, M, C, N, H, W) || n_partners < 0 || n_partners > 2 ||
      mask < 0 || mask > 2 || (ks == 3 && dsc))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const DgradArgs p{g, dzn, yout, gc, w, s_tap, s_c, s_n, x, a, b, dsc,
                    p0, p1, n_partners, mask, dz, part, M, C, N, H, W,
                    nullptr, nullptr, nullptr, nullptr, 0, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dgrad<float>(ks, p, st);
  if (dtype == 1) return dgrad<__nv_bfloat16>(ks, p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ws: (splits, N, ks * ks * C) float32 partials; split s covers rows
// [s * chunk, (s + 1) * chunk).
int conv_fused_wgrad_launch(int dtype, int ks, const void* x,
                            const float* a, const float* b, const void* g,
                            const void* dzn, const void* yout,
                            const float* gc, float* ws, int splits,
                            int chunk, int M, int C, int N, int H, int W,
                            void* stream) {
  if (bad_shape(ks, M, C, N, H, W) || splits < 1 || splits > 65535 ||
      chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const WgradArgs p{x, a, b, g, dzn, yout, gc, ws, chunk, M, C, N, H, W,
                    nullptr, nullptr, nullptr, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return wgrad<float>(ks, splits, p, st);
  if (dtype == 1) return wgrad<__nv_bfloat16>(ks, splits, p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dual 1x1 dgrad: dx (M, C) = G_a w_a^T + G_b w_b^T, both G from the
// batch-norm form, no mask and no partials. w_a is read at
// w_a[c * s_c_a + n * s_n_a], w_b likewise.
int conv_fused_dual_dgrad_launch(int dtype, const void* dzn_a,
                                 const void* yout_a, const float* gc_a,
                                 const void* w_a, long long s_c_a,
                                 long long s_n_a, const void* dzn_b,
                                 const void* yout_b, const float* gc_b,
                                 const void* w_b, long long s_c_b,
                                 long long s_n_b, void* dx, int M, int C,
                                 int Na, int Nb, void* stream) {
  if (bad_shape(1, M, C, Na, 1, 1) || Nb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const DgradArgs p{nullptr, dzn_a, yout_a, gc_a, w_a, 0, s_c_a, s_n_a,
                    nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0,
                    0, dx, nullptr, M, C, Na, 1, 1,
                    dzn_b, yout_b, gc_b, w_b, s_c_b, s_n_b, Nb};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dgrad<float>(1, p, st);
  if (dtype == 1) return dgrad<__nv_bfloat16>(1, p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dual 1x1 wgrad: ws (splits, Na + Nb, C) float32 partials of
// [dW_a; dW_b] in the gluon order, off one plain x.
int conv_fused_dual_wgrad_launch(int dtype, const void* x,
                                 const void* dzn_a, const void* yout_a,
                                 const float* gc_a, const void* dzn_b,
                                 const void* yout_b, const float* gc_b,
                                 float* ws, int splits, int chunk, int M,
                                 int C, int Na, int Nb, void* stream) {
  if (bad_shape(1, M, C, Na, 1, 1) || Nb < 1 || splits < 1 ||
      splits > 65535 || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const WgradArgs p{x, nullptr, nullptr, nullptr, dzn_a, yout_a, gc_a, ws,
                    chunk, M, C, Na, 1, 1, dzn_b, yout_b, gc_b, Nb};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return wgrad<float>(1, splits, p, st);
  if (dtype == 1) return wgrad<__nv_bfloat16>(1, splits, p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
