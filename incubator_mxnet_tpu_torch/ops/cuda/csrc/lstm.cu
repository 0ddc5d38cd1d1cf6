// Fused LSTM cell kernels on Hopper (sm_90a), float32 or bfloat16.
//
// Replaces the Pallas TPU kernels of incubator_mxnet_tpu/ops/pallas/lstm.py:
//   lstm_fwd_kernel<.., false>  <-  _run_fwd(with_gates=False)  h', c'
//   lstm_fwd_kernel<.., true>   <-  _run_fwd(with_gates=True)   h', c', gates
//   lstm_bwd_kernel<..>         <-  _run_bwd                    dxp, dh, dc
//
// One time step. Two types: the operands' (xp, w, b) and the carries' (h,
// c and their cotangents). Layouts are the packed reference layouts:
// xp (N, 4H) is one step of the input projection x @ W_ih^T + b_ih (gate
// k's column j at k * H + j, gate order i, f, g, o); w (4H, H) is W_hh, so
// z_k[n, j] = xp[n, kH + j] + sum_m h[n, m] w[kH + j, m] + b[kH + j]; the
// gates residual and dxp are (N, 4H) float32 in the same column order.
// The TPU kernel's (4, N, H) and (4, H, H) transposes exist only for its
// lane alignment and have no counterpart here.
//
// Rounding points are the reference's: the gate pre-activations, the
// activations and the cell update in float32; h' and c' rounded to the
// carries' own type (bf16 carries stay bf16); the residual and dxp in
// float32; dh and dc rounded to the cotangents' type. The recurrent product
// multiplies the carry h as it is: on the tensor cores when h and W are
// both bf16 (exact products, float32 sums), else in float32 FMAs with W
// widened exactly (the word LM under bf16 compute carries float32 states,
// so its product is float32 h times bf16 W, as in the reference).
// Elementwise float32 steps use the _rn intrinsics so that no multiply-add
// is contracted and the order matches the plain PyTorch twin.
//
// What bounds it on an H100: at the word LM's shape (N 128, H 650) a step
// moves 4.7-7 MB (W_hh alone is 3.4 MB in bf16) for 0.43 GFLOP of
// products. With bf16 h and W the forward is bound by those bytes
// (~1.4-1.8 us); with a float32 operand (the word LM's float32 carries)
// its products, like the backward's, are float32 FMAs (~6.5 us at
// 67 TFLOP/s). W does not fit an SM's shared memory as the TPU keeps it in
// VMEM, so the output is tiled:
//   * forward: a block owns 32 batch rows x 16 hidden columns and all four
//     gates of them, with four accumulators over the K = H loop; the whole
//     gate epilogue runs on the block's own tile, and only h', c' (and the
//     residual) reach device memory. bf16 x bf16 products run on the
//     tensor cores (WMMA 16x16x16, float32 accumulators, one warp per
//     gate); any float32 operand puts the product on the CUDA cores as FMAs
//     (no TF32). 4 x 41 = 164 blocks at the lane.
//   * backward: dh = dz @ W (K = 4H), a block owning 32 rows x 64 columns
//     of dh. dz is formed ON LOAD: each reduction step takes 8 hidden
//     columns j and all four gates of them, computes the four dz of each
//     (n, j) from (gates, c, c', dh', dc') as it writes the A tile to
//     shared memory, and the blocks of the first column tile also write dxp
//     and dc. dz is float32, and so is the product (FMAs, as the reference
//     computes it with float32 operands). No atomics: results repeat.
// H need not be a multiple of anything: K is zero-filled and the tile
// edges are masked. wgmma, TMA and a persistent whole-sequence kernel that
// keeps W resident across steps are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

namespace {

namespace wmma = nvcuda::wmma;

constexpr int kFM = 32;              // forward: batch rows of a tile
constexpr int kFJ = 16;              // forward: hidden columns (x 4 gates)
constexpr int kFK = 32;              // forward: reduction depth of a step
constexpr int kFThreads = 128;       // one warp per gate on the WMMA path

constexpr int kBM = 32;              // backward: batch rows of a tile
constexpr int kBN = 64;              // backward: dh columns of a tile
constexpr int kBJ = 8;               // backward: hidden columns j per step
constexpr int kBK = 4 * kBJ;         // backward: reduction depth of a step
constexpr int kBThreads = 256;
constexpr int kLDBA = kBK + 1;       // As[kBM][kLDBA] float32

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

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

// leading dimensions of the forward's shared tiles: WMMA wants a multiple
// of 8 bf16 values; the float32 FMA path pads to 33 against bank conflicts
template <typename T> struct FwdLd { static constexpr int v = kFK + 8; };
template <> struct FwdLd<float> { static constexpr int v = kFK + 1; };

// The forward tile's products: Cs[g][r][jj] = sum_k As[r][k] Bs[g][jj][k]
// over one reduction step, accumulated across steps.
template <typename T> struct FwdCore;

template <> struct FwdCore<__nv_bfloat16> {
  static constexpr int kLd = FwdLd<__nv_bfloat16>::v;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  Acc acc[2];                        // warp g: gate g, rows 0-15 and 16-31

  __device__ void zero() {
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
  }
  __device__ void step(const __nv_bfloat16* As, const __nv_bfloat16* Bs) {
    const int g = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < kFK; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> b;
      wmma::load_matrix_sync(b, Bs + g * kFJ * kLd + k, kLd);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, As + 16 * i * kLd + k, kLd);
        wmma::mma_sync(acc[i], a, b, acc[i]);
      }
    }
  }
  __device__ void store(float* Cs) {
    const int g = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::store_matrix_sync(Cs + (g * kFM + 16 * i) * kFJ, acc[i], kFJ,
                              wmma::mem_row_major);
  }
};

template <> struct FwdCore<float> {
  static constexpr int kLd = FwdLd<float>::v;
  float acc[4][4];                   // (row ty + 8 r, gate g), column tx

  __device__ void zero() {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[r][g] = 0.f;
  }
  __device__ void step(const float* As, const float* Bs) {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 8
    for (int k = 0; k < kFK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[(ty + 8 * r) * kLd + k];
#pragma unroll
      for (int g = 0; g < 4; ++g) b[g] = Bs[(g * kFJ + tx) * kLd + k];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = fmaf(a[r], b[g], acc[r][g]);
    }
  }
  __device__ void store(float* Cs) {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        Cs[(g * kFM + ty + 8 * r) * kFJ + tx] = acc[r][g];
  }
};

struct FwdArgs {
  const void* xp; const void* h; const void* c; const void* w;
  const void* b;
  void* h1; void* c1; float* gates;
  int N, H;
};

// the type of the product's shared tiles: bf16 (tensor cores) only when
// both the carry h and W are bf16
template <typename Tin, typename Ts> struct CoreType { using T = float; };
template <> struct CoreType<__nv_bfloat16, __nv_bfloat16> {
  using T = __nv_bfloat16;
};

template <typename Tin, typename Ts, bool kGates>
__global__ void __launch_bounds__(kFThreads) lstm_fwd_kernel(FwdArgs p) {
  using T = typename CoreType<Tin, Ts>::T;
  constexpr int kLd = FwdLd<T>::v;
  __shared__ __align__(128) T As[kFM * kLd];
  __shared__ __align__(128) T Bs[4 * kFJ * kLd];
  __shared__ __align__(128) float Cs[4 * kFM * kFJ];
  const Tin* xp = static_cast<const Tin*>(p.xp);
  const Ts* h = static_cast<const Ts*>(p.h);
  const Ts* c = static_cast<const Ts*>(p.c);
  const Tin* w = static_cast<const Tin*>(p.w);
  const Tin* bias = static_cast<const Tin*>(p.b);
  const int N = p.N, H = p.H;
  const int j0 = blockIdx.x * kFJ, n0 = blockIdx.y * kFM;
  const int tid = threadIdx.x;
  const int kk = tid & 31;

  FwdCore<T> core;
  core.zero();
  for (int m0 = 0; m0 < H; m0 += kFK) {
    const int m = m0 + kk;
    // A: h rows n0.., reduction columns m0.. (zero past N and H)
#pragma unroll
    for (int q = 0; q < kFM / 4; ++q) {
      const int r = (tid >> 5) + 4 * q, n = n0 + r;
      As[r * kLd + kk] = cast<T>((n < N && m < H)
          ? f32(h[(long long)n * H + m]) : 0.f);
    }
    // B: for each gate g, W_hh rows g H + j0.., columns m0.. (read along m)
#pragma unroll
    for (int q = 0; q < 4 * kFJ / 4; ++q) {
      const int idx = (tid >> 5) + 4 * q, g = idx / kFJ, jj = idx % kFJ;
      const int j = j0 + jj;
      Bs[idx * kLd + kk] = cast<T>((j < H && m < H)
          ? f32(w[((long long)g * H + j) * H + m]) : 0.f);
    }
    __syncthreads();
    core.step(As, Bs);
    __syncthreads();
  }
  core.store(Cs);
  __syncthreads();

  // the gate epilogue over the block's (n, j) tile, four gates each
  const long long H4 = 4LL * H;
#pragma unroll
  for (int q = 0; q < kFM * kFJ / kFThreads; ++q) {
    const int e = tid + kFThreads * q, r = e / kFJ, jj = e % kFJ;
    const int n = n0 + r, j = j0 + jj;
    if (n >= N || j >= H) continue;
    float z[4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
      z[g] = __fadd_rn(__fadd_rn(f32(xp[n * H4 + g * H + j]),
                                 Cs[(g * kFM + r) * kFJ + jj]),
                       f32(bias[g * H + j]));
    const float ig = sigmoid(z[0]), fg = sigmoid(z[1]);
    const float gg = tanhf(z[2]), og = sigmoid(z[3]);
    const float cv = f32(c[(long long)n * H + j]);
    const float c1 = __fadd_rn(__fmul_rn(fg, cv), __fmul_rn(ig, gg));
    const float h1 = __fmul_rn(og, tanhf(c1));
    static_cast<Ts*>(p.h1)[(long long)n * H + j] = cast<Ts>(h1);
    static_cast<Ts*>(p.c1)[(long long)n * H + j] = cast<Ts>(c1);
    if (kGates) {
      float* gt = p.gates + n * H4 + j;
      gt[0] = ig;
      gt[H] = fg;
      gt[2LL * H] = gg;
      gt[3LL * H] = og;
    }
  }
}

struct BwdArgs {
  const float* gates; const void* c; const void* c1; const void* w;
  const void* dh1; const void* dc1;
  float* dxp; void* dh; void* dc;
  int N, H;
};

template <typename Tw, typename T>
__global__ void __launch_bounds__(kBThreads) lstm_bwd_kernel(BwdArgs p) {
  __shared__ float As[kBM * kLDBA];
  __shared__ float Bs[kBK * kBN];
  const T* c = static_cast<const T*>(p.c);
  const T* c1 = static_cast<const T*>(p.c1);
  const Tw* w = static_cast<const Tw*>(p.w);
  const T* dh1 = static_cast<const T*>(p.dh1);
  const T* dc1 = static_cast<const T*>(p.dc1);
  const int N = p.N, H = p.H;
  const long long H4 = 4LL * H;
  const int m0 = blockIdx.x * kBN, n0 = blockIdx.y * kBM;
  const bool first = blockIdx.x == 0;     // writes dxp and dc
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  // the (n, j) this thread forms dz for in every step
  const int ra = tid / kBJ, ja = tid % kBJ, na = n0 + ra;

  float acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;

  for (int j0 = 0; j0 < H; j0 += kBJ) {
    // A: dz of rows n0.., columns (gate k, j0 + jj) at k * kBJ + jj
    const int j = j0 + ja;
    float dz[4] = {0.f, 0.f, 0.f, 0.f};
    if (na < N && j < H) {
      const long long o = (long long)na * H + j;
      const float* gt = p.gates + na * H4 + j;
      const float ig = gt[0], fg = gt[H], gg = gt[2LL * H], og = gt[3LL * H];
      const float cv = f32(c[o]), dhv = f32(dh1[o]), dcv = f32(dc1[o]);
      const float tc = tanhf(f32(c1[o]));
      const float dov = __fmul_rn(dhv, tc);
      const float dct = __fadd_rn(
          dcv, __fmul_rn(__fmul_rn(dhv, og),
                         __fsub_rn(1.f, __fmul_rn(tc, tc))));
      dz[0] = __fmul_rn(__fmul_rn(__fmul_rn(dct, gg), ig),
                        __fsub_rn(1.f, ig));
      dz[1] = __fmul_rn(__fmul_rn(__fmul_rn(dct, cv), fg),
                        __fsub_rn(1.f, fg));
      dz[2] = __fmul_rn(__fmul_rn(dct, ig),
                        __fsub_rn(1.f, __fmul_rn(gg, gg)));
      dz[3] = __fmul_rn(__fmul_rn(dov, og), __fsub_rn(1.f, og));
      if (first) {
        float* dx = p.dxp + na * H4 + j;
        dx[0] = dz[0];
        dx[H] = dz[1];
        dx[2LL * H] = dz[2];
        dx[3LL * H] = dz[3];
        static_cast<T*>(p.dc)[o] = cast<T>(__fmul_rn(dct, fg));
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) As[ra * kLDBA + k * kBJ + ja] = dz[k];
    // B: W_hh rows k H + j0 + jj, columns m0.. (read along m)
#pragma unroll
    for (int q = 0; q < kBK * kBN / kBThreads; ++q) {
      const int kk = (tid / kBN) + (kBThreads / kBN) * q, mm = tid % kBN;
      const int k = kk / kBJ, jb = j0 + kk % kBJ, m = m0 + mm;
      Bs[kk * kBN + mm] = (jb < H && m < H)
          ? f32(w[((long long)k * H + jb) * H + m]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float a0 = As[ty * kLDBA + kk], a1 = As[(ty + 16) * kLDBA + kk];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float b = Bs[kk * kBN + tx + 16 * q];
        acc[0][q] = fmaf(a0, b, acc[0][q]);
        acc[1][q] = fmaf(a1, b, acc[1][q]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = n0 + ty + 16 * i;
    if (n >= N) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = m0 + tx + 16 * q;
      if (m < H)
        static_cast<T*>(p.dh)[(long long)n * H + m] = cast<T>(acc[i][q]);
    }
  }
}

template <typename Tin, typename Ts>
int fwd_launch(const FwdArgs& a, bool gates, cudaStream_t st) {
  const dim3 grid((a.H + kFJ - 1) / kFJ, (a.N + kFM - 1) / kFM);
  if (gates)
    lstm_fwd_kernel<Tin, Ts, true><<<grid, kFThreads, 0, st>>>(a);
  else
    lstm_fwd_kernel<Tin, Ts, false><<<grid, kFThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin>
int fwd_dispatch(int state_dtype, const FwdArgs& a, bool gates,
                 cudaStream_t st) {
  return state_dtype == 1 ? fwd_launch<Tin, __nv_bfloat16>(a, gates, st)
                          : fwd_launch<Tin, float>(a, gates, st);
}

template <typename Tw, typename Ts>
int bwd_launch(const BwdArgs& a, cudaStream_t st) {
  const dim3 grid((a.H + kBN - 1) / kBN, (a.N + kBM - 1) / kBM);
  lstm_bwd_kernel<Tw, Ts><<<grid, kBThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tw>
int bwd_dispatch(int state_dtype, const BwdArgs& a, cudaStream_t st) {
  return state_dtype == 1 ? bwd_launch<Tw, __nv_bfloat16>(a, st)
                          : bwd_launch<Tw, float>(a, st);
}

}  // namespace

// Types: 0 float32, 1 bfloat16. in_dtype is xp's, w's and b's; state_dtype
// is h's, c's, h1's and c1's. gates (N, 4H) float32, or null for the
// variant without the residual.
int lstm_fwd_launch(int in_dtype, int state_dtype, const void* xp,
                    const void* h, const void* c, const void* w,
                    const void* b, void* h1, void* c1, float* gates, int N,
                    int H, void* stream) {
  const FwdArgs a{xp, h, c, w, b, h1, c1, gates, N, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool g = gates != nullptr;
  return in_dtype == 1
             ? fwd_dispatch<__nv_bfloat16>(state_dtype, a, g, st)
             : fwd_dispatch<float>(state_dtype, a, g, st);
}

// w_dtype is W's; state_dtype is c's, c1's, dh1's, dc1's, dh's and dc's;
// gates and dxp (N, 4H) float32.
int lstm_bwd_launch(int w_dtype, int state_dtype, const float* gates,
                    const void* c, const void* c1, const void* w,
                    const void* dh1, const void* dc1, float* dxp, void* dh,
                    void* dc, int N, int H, void* stream) {
  const BwdArgs a{gates, c, c1, w, dh1, dc1, dxp, dh, dc, N, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return w_dtype == 1 ? bwd_dispatch<__nv_bfloat16>(state_dtype, a, st)
                      : bwd_dispatch<float>(state_dtype, a, st);
}
