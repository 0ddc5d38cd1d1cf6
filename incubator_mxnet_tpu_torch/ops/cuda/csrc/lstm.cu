// Fused LSTM cell kernels on Hopper (sm_90a), float32 or bfloat16.
//
// Replaces the Pallas TPU kernels of incubator_mxnet_tpu/ops/pallas/lstm.py:
//   lstm_fwd_kernel<.., false>  <-  _run_fwd(with_gates=False)  h', c'
//   lstm_fwd_kernel<.., true>   <-  _run_fwd(with_gates=True)   h', c', gates
//   lstm_bwd_kernel<..>         <-  _run_bwd                    dxp, dh, dc
//   lstm_bwd_dz_kernel<..>   \  <-  _run_bwd, W_hh in bf16      dxp, dc, dz
//   lstm_bwd_tc_kernel<..>   /                                  dh
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
//   * backward with a bf16 W_hh (the word LM's form), two launches: the
//     dz launch forms the four dz of each (n, j) ONCE, writes dxp and dc
//     and splits each float32 dz exactly into three bf16 pieces, hi + mid
//     + lo (three 8-bit significands cover float32's 24, and bf16 has
//     float32's exponent range), into a (3, N, 4, Hk) scratch, zero past
//     H; the product launch runs dh = hi W + mid W + lo W on the tensor
//     cores (mma.sync m16n8k16; W is bf16 and so exact): float32
//     operands' products, as the reference's, at bf16 tensor-core rates.
//     Each 32-deep stage's six products go into a fresh accumulator that
//     one rounded float32 add joins to the block's: the tensor cores' adds
//     lose precision over long chains (at H 650 a single accumulator read
//     as far from the exact product as a split that drops lo). A block owns 32 rows x 64 columns of dh and ONE
//     gate's quarter of K = 4H, so the lane (N 128, H 650) runs 11 x 4 x 4
//     = 176 blocks; the four gates' blocks form a cluster and sum their
//     float32 partials through distributed shared memory in a fixed order
//     (no atomics: results repeat). Operands come in by 16-byte cp.async
//     into a three-stage ring; rows of W (H bf16 values) are 16-byte
//     aligned only in a copy, so W is read as (4, Hk, Hm) padded with
//     zeros (Hk = H rounded up to 32, Hm to 8), which the caller makes
//     once per sequence.
// H need not be a multiple of anything: K is zero-filled and the tile
// edges are masked. wgmma, TMA and a persistent whole-sequence kernel that
// keeps W resident across steps are later work.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;
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

constexpr int kTM = 32;              // tensor-core backward: dh rows (n)
constexpr int kTN = 64;              // ... dh columns (m) of a tile
constexpr int kTK = 32;              // ... reduction depth (j) of a stage
constexpr int kTStages = 3;          // ... stages of the cp.async ring
constexpr int kTThreads = 128;       // ... four warps, 16 x 32 of dh each
constexpr int kTLdA = kTK + 8;       // bf16 a dz piece row: 80 bytes
constexpr int kTLdB = kTN + 8;       // bf16 a W row: 144 bytes (no bank
                                     // conflicts for ldmatrix's 8 rows)
constexpr int kDzThreads = 256;      // the dz launch's block

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
  // the tensor-core route: the (3, N, 4, Hk) dz pieces and the padded
  // (4, Hk, Hm) W
  __nv_bfloat16* dzs; int Hk, Hm;
};

// The four dz of (n, j) from (gates, c, c', dh', dc') in the reference's
// order, and dc = dct f; writes dxp and dc when `write`.
template <typename T>
__device__ __forceinline__ void form_dz(const BwdArgs& p, int n, int j,
                                        bool write, float (&dz)[4]) {
  const int H = p.H;
  const long long H4 = 4LL * H, o = (long long)n * H + j;
  const float* gt = p.gates + n * H4 + j;
  const float ig = gt[0], fg = gt[H], gg = gt[2LL * H], og = gt[3LL * H];
  const float cv = f32(static_cast<const T*>(p.c)[o]);
  const float dhv = f32(static_cast<const T*>(p.dh1)[o]);
  const float dcv = f32(static_cast<const T*>(p.dc1)[o]);
  const float tc = tanhf(f32(static_cast<const T*>(p.c1)[o]));
  const float dov = __fmul_rn(dhv, tc);
  const float dct = __fadd_rn(
      dcv, __fmul_rn(__fmul_rn(dhv, og), __fsub_rn(1.f, __fmul_rn(tc, tc))));
  dz[0] = __fmul_rn(__fmul_rn(__fmul_rn(dct, gg), ig), __fsub_rn(1.f, ig));
  dz[1] = __fmul_rn(__fmul_rn(__fmul_rn(dct, cv), fg), __fsub_rn(1.f, fg));
  dz[2] = __fmul_rn(__fmul_rn(dct, ig), __fsub_rn(1.f, __fmul_rn(gg, gg)));
  dz[3] = __fmul_rn(__fmul_rn(dov, og), __fsub_rn(1.f, og));
  if (write) {
    float* dx = p.dxp + n * H4 + j;
    dx[0] = dz[0];
    dx[H] = dz[1];
    dx[2LL * H] = dz[2];
    dx[3LL * H] = dz[3];
    static_cast<T*>(p.dc)[o] = cast<T>(__fmul_rn(dct, fg));
  }
}

template <typename Tw, typename T>
__global__ void __launch_bounds__(kBThreads) lstm_bwd_kernel(BwdArgs p) {
  __shared__ float As[kBM * kLDBA];
  __shared__ float Bs[kBK * kBN];
  const Tw* w = static_cast<const Tw*>(p.w);
  const int N = p.N, H = p.H;
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
    if (na < N && j < H) form_dz<T>(p, na, j, first, dz);
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

// --------------------------------------------- the tensor-core backward
// dz of every (n, j < Hk) (zero past H): dxp and dc written, each dz split
// into hi + mid + lo, bf16 each, at dzs[((piece N + n) 4 + gate) Hk + j].
// Each residual is exact in float32, and the third piece holds what is
// left exactly, so hi + mid + lo == dz.
template <typename T>
__global__ void __launch_bounds__(kDzThreads) lstm_bwd_dz_kernel(BwdArgs p) {
  const long long e = static_cast<long long>(blockIdx.x) * kDzThreads +
                      threadIdx.x;
  if (e >= static_cast<long long>(p.N) * p.Hk) return;
  const int n = static_cast<int>(e / p.Hk), j = static_cast<int>(e % p.Hk);
  float dz[4] = {0.f, 0.f, 0.f, 0.f};
  if (j < p.H) form_dz<T>(p, n, j, true, dz);
  const size_t piece = static_cast<size_t>(p.N) * 4 * p.Hk;
  __nv_bfloat16* out = p.dzs + (static_cast<size_t>(n) * 4) * p.Hk + j;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat16 hi = __float2bfloat16_rn(dz[k]);
    const float r1 = __fsub_rn(dz[k], __bfloat162float(hi));
    const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
    const float r2 = __fsub_rn(r1, __bfloat162float(mid));
    out[k * p.Hk] = hi;
    out[piece + k * p.Hk] = mid;
    out[2 * piece + k * p.Hk] = __float2bfloat16_rn(r2);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, asynchronously; `bytes` 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
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
                 : "r"(smem_addr(p)) : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)) : "memory");
}

// d (16 x 8, float32) += a (16 x 16, bf16) b (16 x 8, bf16)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// dh[n0 .., m0 ..] (32 x 64) = sum over the gates k and j < Hk of dz_k[n, j]
// W[k H + j, m]. Block z = gate k = its rank in the cluster of four; each
// block's product runs over its gate's Hk, its float32 partial goes to its
// shared memory, and block k sums rows 8 k .. 8 k + 7 of the four partials
// in gate order, rounds them to T and writes them.
template <typename T>
__global__ void __cluster_dims__(1, 1, 4) __launch_bounds__(kTThreads)
lstm_bwd_tc_kernel(BwdArgs p) {
  __shared__ __align__(16) __nv_bfloat16 As[kTStages][3][kTM * kTLdA];
  __shared__ __align__(16) __nv_bfloat16 Bs[kTStages][kTK * kTLdB];
  cg::cluster_group cluster = cg::this_cluster();
  const int gate = blockIdx.z;
  const int m0 = blockIdx.x * kTN, n0 = blockIdx.y * kTM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp >> 1, wc = warp & 1;          // 16 rows x 32 columns
  const int N = p.N, Hk = p.Hk, Hm = p.Hm, nk = Hk / kTK;
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w) +
                           static_cast<size_t>(gate) * Hk * Hm;
  // stage kb: the three pieces' 32 x 32 tiles (rows n >= N read 0) and
  // W's 32 x 64 tile (columns m >= Hm read 0), 16 bytes a copy
  auto load = [&](int kb, int s) {
    const int j0 = kb * kTK;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int i = tid + q * kTThreads;
      const int piece = i >> 7, r = (i >> 2) & (kTM - 1), ch = i & 3;
      const int n = n0 + r;
      cp_async16(&As[s][piece][r * kTLdA + ch * 8],
                 p.dzs + ((static_cast<size_t>(piece) * N + (n < N ? n : 0))
                          * 4 + gate) * Hk + j0 + ch * 8,
                 n < N ? 16 : 0);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = tid + q * kTThreads;
      const int r = i >> 3, m = m0 + (i & 7) * 8;
      cp_async16(&Bs[s][r * kTLdB + (i & 7) * 8],
                 w + static_cast<size_t>(j0 + r) * Hm + (m < Hm ? m : 0),
                 m < Hm ? 16 : 0);
    }
    cp_async_commit();
  };
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
#pragma unroll
  for (int s = 0; s < kTStages - 1; ++s) {
    if (s < nk) load(s, s);
    else cp_async_commit();
  }
  for (int kb = 0; kb < nk; ++kb) {
    cp_async_wait<kTStages - 2>();
    __syncthreads();                         // stage kb in, kb - 1 consumed
    const int nx = kb + kTStages - 1;
    if (nx < nk) load(nx, nx % kTStages);
    else cp_async_commit();
    const int s = kb % kTStages;
    // the stage's six products go into a fresh accumulator, added to acc
    // with one rounded float32 add: the tensor cores' own adds then chain
    // only six deep, and acc sums Hk / kTK stage partials as float32 does
    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[i][q] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kTK / 16; ++ks) {
      uint32_t a[3][4], b[4][2];
#pragma unroll
      for (int q = 0; q < 3; ++q)
        ldsm_x4<false>(a[q], &As[s][q][(16 * wr + (lane & 15)) * kTLdA +
                                       16 * ks + (lane >> 4) * 8]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t r[4];
        ldsm_x4<true>(r, &Bs[s][(16 * ks + (lane & 15)) * kTLdB + 32 * wc +
                                16 * h + (lane >> 4) * 8]);
        b[2 * h][0] = r[0];
        b[2 * h][1] = r[1];
        b[2 * h + 1][0] = r[2];
        b[2 * h + 1][1] = r[3];
      }
#pragma unroll
      for (int q = 2; q >= 0; --q)             // lo, mid, then hi
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(part[nt], a[q], b[nt]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = __fadd_rn(acc[i][q], part[i][q]);
  }
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(&As[0][0][0]);   // 32 x 64 float32
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = 32 * wc + 8 * nt + 2 * t, row = 16 * wr + g;
    red[row * kTN + col] = acc[nt][0];
    red[row * kTN + col + 1] = acc[nt][1];
    red[(row + 8) * kTN + col] = acc[nt][2];
    red[(row + 8) * kTN + col + 1] = acc[nt][3];
  }
  cluster.sync();
  T* dh = static_cast<T*>(p.dh);
  for (int e = tid; e < (kTM / 4) * kTN; e += kTThreads) {
    const int r = (kTM / 4) * gate + e / kTN, col = e % kTN;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) v += cluster.map_shared_rank(red, q)[r * kTN + col];
    const int n = n0 + r, m = m0 + col;
    if (n < N && m < p.H) dh[static_cast<size_t>(n) * p.H + m] = cast<T>(v);
  }
  cluster.sync();                  // no block leaves while read remotely
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

template <typename Ts>
int bwd_tc_launch(const BwdArgs& a, cudaStream_t st) {
  const long long elems = static_cast<long long>(a.N) * a.Hk;
  lstm_bwd_dz_kernel<Ts><<<static_cast<unsigned>(
      (elems + kDzThreads - 1) / kDzThreads), kDzThreads, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.H + kTN - 1) / kTN, (a.N + kTM - 1) / kTM, 4);
  lstm_bwd_tc_kernel<Ts><<<grid, kTThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
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

// The tensor-core backward with a bf16 W: wp the (4, Hk, Hm) bf16 copy of W
// (wp[k, j, m] = W[k H + j, m], zero past H; Hk a multiple of 32 and Hm of
// 8, both at least H); dzs a (3, N, 4, Hk) bf16 scratch; state_dtype is
// c's, c1's, dh1's, dc1's, dh's and dc's; gates and dxp (N, 4H) float32.
int lstm_bwd_sm90_launch(int state_dtype, const float* gates, const void* c,
                         const void* c1, const void* wp, const void* dh1,
                         const void* dc1, float* dxp, void* dh, void* dc,
                         void* dzs, int N, int H, int Hk, int Hm,
                         void* stream) {
  if (N < 1 || H < 1 || Hk < H || Hk % kTK || Hm < H || Hm % 8 ||
      (N + kTM - 1) / kTM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{gates, c, c1, wp, dh1, dc1, dxp, dh, dc, N, H,
                  static_cast<__nv_bfloat16*>(dzs), Hk, Hm};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return state_dtype == 1 ? bwd_tc_launch<__nv_bfloat16>(a, st)
                          : bwd_tc_launch<float>(a, st);
}
