// Fused LSTM cell kernels on Hopper (sm_90a), float32 or bfloat16.
//
// Replaces the Pallas TPU kernels of incubator_mxnet_tpu/ops/pallas/lstm.py:
//   lstm_fwd_tc_kernel<.., false, PW>  <-  _run_fwd(with_gates=False)
//                                           h', c'
//   lstm_fwd_tc_kernel<.., true, PW>   <-  _run_fwd(with_gates=True)
//                                           h', c', gates
//       (PW 1: W_hh bf16; PW 3: W_hh float32 in three bf16 pieces;
//       lstm_fwd_kernel, the FMA forward, is the yardstick behind the
//       wrappers' private _route="simt")
//   lstm_bwd_kernel<..>         <-  _run_bwd, W_hh in float32   dxp, dh, dc
//   lstm_bwd_dz_kernel<..>   \  <-  _run_bwd, W_hh in bf16      dxp, dc, dz
//   lstm_bwd_tc_kernel<..>   /                                  dh
//
// One time step. Three types: the operands' (xp, b), W_hh's, and the
// carries' (h, c and their cotangents). Layouts are the packed reference
// layouts: xp (N, 4H) is one step of the input projection x @ W_ih^T + b_ih
// (gate k's column j at k * H + j, gate order i, f, g, o); w (4H, H) is
// W_hh, so z_k[n, j] = xp[n, kH + j] + sum_m h[n, m] w[kH + j, m] +
// b[kH + j]; the gates residual and dxp are (N, 4H) float32 in the same
// column order. The TPU kernel's (4, N, H) and (4, H, H) transposes exist
// only for its lane alignment and have no counterpart here.
//
// Rounding points are the reference's: the gate pre-activations, the
// activations and the cell update in float32; h' and c' rounded to the
// carries' own type (bf16 carries stay bf16); the residual and dxp in
// float32; dh and dc rounded to the cotangents' type. The recurrent
// products multiply float32 operands as float32 does. They run on the
// tensor cores (mma.sync m16n8k16, float32 accumulators) for a bf16 W_hh
// both ways and for a float32 W_hh forward: a float32 operand (h, dz or a
// float32 W) is split exactly into three bf16 pieces, hi + mid + lo (three
// 8-bit significands cover float32's 24, and bf16 has float32's exponent
// range), and multiplied piece by piece; a bf16 operand is one piece. With
// both operands in three pieces a stage runs the six products whose
// pieces' orders sum to at most two (hi.hi, hi.mid, mid.hi, hi.lo, lo.hi,
// mid.mid); the three dropped ones lie below float32's rounding. Each
// 32-deep stage's products go into a fresh accumulator that one rounded
// float32 add joins to the block's: the tensor cores' adds lose precision
// over long chains (at H 650 a single accumulator read as far from the
// exact product as a split that drops lo). The backward with a float32
// W_hh runs float32 FMAs (no TF32). Elementwise float32 steps use the _rn
// intrinsics so that no multiply-add is contracted and the order matches
// the plain PyTorch twin.
//
// What bounds it on an H100: at the word LM's shape (N 128, H 650; bf16
// xp, W and b, float32 carries) a forward step moves 5.4 MB (6.7 MB with
// the residual; W_hh alone is 3.4 MB) for 0.43 GFLOP of products, 1.3
// GFLOP as three bf16 products: 1.6-2.0 us of bytes against 1.3 us of
// tensor-core operations, so bytes bound it. W and h stay in the 50 MB L2
// from one step to the next; what holds a step back in practice is each
// block's chain of dependent stages and how evenly the blocks fill the 132
// SMs. W does not fit an SM's shared memory as the TPU keeps it in VMEM,
// so the output is tiled:
//   * forward (lstm_fwd_tc_kernel, PW 1 for a bf16 W): a block owns 32 batch
//     rows x 16 hidden columns with all four gates of them (a 32 x 64
//     product tile) and half of the reduction over m. The two halves'
//     blocks form a cluster: each puts its float32 partial in shared
//     memory, and each sums 16 of the 32 rows of the two partials through
//     distributed shared memory in rank order (no atomics: results repeat)
//     and runs the whole gate epilogue on them, so only h', c' (and the
//     residual) reach device memory. The lane runs 41 x 4 x 2 = 328
//     blocks, each a chain of 10-11 stages, in one wave (at most five
//     blocks of 88-90 registers and 37.5 KB to an SM with a bf16 W).
//     The other splits ran slower at the lane on an H100: one block per
//     tile over all of m (164 blocks of 21 stages), and quarters of m in
//     clusters of four (656 blocks of 5-6 stages, of whose 164 clusters
//     only 154 fit at once). A float32 h is split ON LOAD: a thread loads
//     its 8 values of a stage with plain loads a stage ahead, into
//     registers, and stores them to shared memory as bf16 pieces (a
//     float32 h row is only 4-byte aligned, so no 16-byte cp.async).
//     Having each step also write h''s pieces for the next step's
//     16-byte cp.async gave the same bits and about 1% of the scan's
//     forward on an H100, too little for a second path. W comes in
//     by 16-byte cp.async, into a three-stage ring, from its zero-padded
//     (4, Hk, Hm) copy ([k, j, m] = W[k H + j, m], Hk = H rounded up to
//     32, Hm to 8), which the caller makes once per sequence; past Hm it
//     is zero-filled. The kernel runs far from both bounds: its time grows
//     with the work from a floor of a few us, and what limits it within a
//     block is not measured (no hardware-counter profile was taken).
//   * forward with a float32 W (PW 3): the same kernel on W's (3, 4, Hk,
//     Hm) copy of hi, mid and lo pieces, which the caller splits once per
//     sequence; the ring holds the three W pieces' tiles beside h's, 67.5
//     KB a block (dynamic shared memory), so at most three blocks an SM
//     and the lane's 328 still one wave; six products a stage. The FMA
//     forward (lstm_fwd_kernel: 32 rows x 16 columns x 4 gates a block
//     over all of m in float32 FMAs, 164 blocks at the lane) is kept as
//     the yardstick.
//   * backward: dh = dz @ W (K = 4H), a block owning 32 rows x 64 columns
//     of dh. dz is formed ON LOAD: each reduction step takes 8 hidden
//     columns j and all four gates of them, computes the four dz of each
//     (n, j) from (gates, c, c', dh', dc') as it writes the A tile to
//     shared memory, and the blocks of the first column tile also write dxp
//     and dc. dz is float32, and so is the product (FMAs, as the reference
//     computes it with float32 operands). No atomics: results repeat.
//   * backward with a bf16 W_hh (the word LM's form), two launches: the
//     dz launch forms the four dz of each (n, j) ONCE, writes dxp and dc
//     and splits each float32 dz into its three pieces in a (3, N, 4, Hk)
//     scratch, zero past H; the product launch runs dh = hi W + mid W +
//     lo W on the tensor cores. A block owns 32 rows x 64 columns of dh
//     and ONE gate's quarter of K = 4H, so the lane (N 128, H 650) runs
//     11 x 4 x 4 = 176 blocks; the four gates' blocks form a cluster and
//     sum their float32 partials through distributed shared memory in a
//     fixed order (no atomics: results repeat). Operands come in by
//     16-byte cp.async into a three-stage ring from W's padded copy.
// H need not be a multiple of anything: K is zero-filled and the tile
// edges are masked. wgmma, TMA and a persistent whole-sequence kernel that
// keeps W resident across steps are later work.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr int kFM = 32;              // FMA forward: batch rows of a tile
constexpr int kFJ = 16;              // FMA forward: hidden columns (x 4 gates)
constexpr int kFK = 32;              // FMA forward: reduction depth of a step
constexpr int kFThreads = 128;
constexpr int kFLd = kFK + 1;        // its float32 tiles' rows (bank conflicts)

constexpr int kFTM = 32;             // tensor-core forward: batch rows (n)
constexpr int kFTJ = 16;             // ... hidden columns (j) x 4 gates
constexpr int kFTK = 32;             // ... reduction depth (m) of a stage
constexpr int kFTSplit = 2;          // ... blocks of a cluster (m halves)
constexpr int kFTStages = 3;         // ... stages of the ring
constexpr int kFTThreads = 128;      // ... four warps, 16 rows x 2 gates each
constexpr int kFTLd = kFTK + 8;      // bf16 an h piece or W row: 80 bytes

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

static_assert(kFTM % kFTSplit == 0, "the forward's epilogue: whole rows");

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

struct FwdArgs {
  const void* xp; const void* h; const void* c; const void* w;
  const void* b;
  void* h1; void* c1; float* gates;
  int N, H;
  int Hk, Hm;        // the tensor-core route: w is W's (4, Hk, Hm) copy
};

// The gate epilogue of (n, j) from its four products h W_k^T: z_k = (xp +
// product) + b in float32, the activations, c' and h' written in Ts, the
// residual when kGates.
template <typename Tin, typename Ts, bool kGates>
__device__ __forceinline__ void fwd_epilogue(const FwdArgs& p, int n, int j,
                                              const float (&prod)[4]) {
  const int H = p.H;
  const long long H4 = 4LL * H, o = static_cast<long long>(n) * H + j;
  const Tin* xp = static_cast<const Tin*>(p.xp) + n * H4 + j;
  const Tin* bias = static_cast<const Tin*>(p.b) + j;
  float z[4];
#pragma unroll
  for (int g = 0; g < 4; ++g)
    z[g] = __fadd_rn(__fadd_rn(f32(xp[g * H]), prod[g]), f32(bias[g * H]));
  const float ig = sigmoid(z[0]), fg = sigmoid(z[1]);
  const float gg = tanhf(z[2]), og = sigmoid(z[3]);
  const float cv = f32(static_cast<const Ts*>(p.c)[o]);
  const float c1 = __fadd_rn(__fmul_rn(fg, cv), __fmul_rn(ig, gg));
  const float h1 = __fmul_rn(og, tanhf(c1));
  static_cast<Ts*>(p.h1)[o] = cast<Ts>(h1);
  static_cast<Ts*>(p.c1)[o] = cast<Ts>(c1);
  if (kGates) {
    float* gt = p.gates + n * H4 + j;
    gt[0] = ig;
    gt[H] = fg;
    gt[2LL * H] = gg;
    gt[3LL * H] = og;
  }
}

// The FMA forward (any W type; the yardstick behind the wrappers' private
// _route="simt"): the block's 32 x 16 x 4 products in float32 FMAs over
// all of m, then the gate epilogue on its own tile.
template <typename Tin, typename Tw, typename Ts, bool kGates>
__global__ void __launch_bounds__(kFThreads) lstm_fwd_kernel(FwdArgs p) {
  __shared__ float As[kFM * kFLd];
  __shared__ float Bs[4 * kFJ * kFLd];
  __shared__ float Cs[4 * kFM * kFJ];
  const Ts* h = static_cast<const Ts*>(p.h);
  const Tw* w = static_cast<const Tw*>(p.w);
  const int N = p.N, H = p.H;
  const int j0 = blockIdx.x * kFJ, n0 = blockIdx.y * kFM;
  const int tid = threadIdx.x;
  const int kk = tid & 31, tx = tid & 15, ty = tid >> 4;

  float acc[4][4];                   // (row ty + 8 r, gate g), column tx
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[r][g] = 0.f;
  for (int m0 = 0; m0 < H; m0 += kFK) {
    const int m = m0 + kk;
    // A: h rows n0.., reduction columns m0.. (zero past N and H)
#pragma unroll
    for (int q = 0; q < kFM / 4; ++q) {
      const int r = (tid >> 5) + 4 * q, n = n0 + r;
      As[r * kFLd + kk] = (n < N && m < H)
          ? f32(h[static_cast<long long>(n) * H + m]) : 0.f;
    }
    // B: for each gate g, W_hh rows g H + j0.., columns m0.. (read along m)
#pragma unroll
    for (int q = 0; q < 4 * kFJ / 4; ++q) {
      const int idx = (tid >> 5) + 4 * q, g = idx / kFJ, jj = idx % kFJ;
      const int j = j0 + jj;
      Bs[idx * kFLd + kk] = (j < H && m < H)
          ? f32(w[(static_cast<long long>(g) * H + j) * H + m]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kFK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[(ty + 8 * r) * kFLd + k];
#pragma unroll
      for (int g = 0; g < 4; ++g) b[g] = Bs[(g * kFJ + tx) * kFLd + k];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = fmaf(a[r], b[g], acc[r][g]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int g = 0; g < 4; ++g)
      Cs[(g * kFM + ty + 8 * r) * kFJ + tx] = acc[r][g];
  __syncthreads();

  // the gate epilogue over the block's (n, j) tile, four gates each
#pragma unroll
  for (int q = 0; q < kFM * kFJ / kFThreads; ++q) {
    const int e = tid + kFThreads * q, r = e / kFJ, jj = e % kFJ;
    const int n = n0 + r, j = j0 + jj;
    if (n >= N || j >= H) continue;
    float prod[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) prod[g] = Cs[(g * kFM + r) * kFJ + jj];
    fwd_epilogue<Tin, Ts, kGates>(p, n, j, prod);
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

// --------------------------------------------- the tensor-core forward
// x as P bf16 pieces: P 3, hi + mid + lo == x exactly (each residual is
// exact in float32, and lo holds what is left); P 1, x rounded (exact for
// a value read from bf16)
template <int P>
__device__ __forceinline__ void split(float x, __nv_bfloat16 (&piece)[P]) {
  piece[0] = __float2bfloat16_rn(x);
  if constexpr (P == 3) {
    const float r1 = __fsub_rn(x, __bfloat162float(piece[0]));
    piece[1] = __float2bfloat16_rn(r1);
    piece[2] = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(piece[1])));
  }
}

// two bf16 values as one 32-bit word, the first at the lower address
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 a, __nv_bfloat16 b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(a)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(b)) << 16);
}

// The forward's shared memory: a kFTStages ring of h's P pieces' and W's
// PW pieces' stage tiles, bf16 (the block's float32 partial reuses it)
__host__ __device__ constexpr int fwd_tc_smem_bytes(int P, int PW) {
  return kFTStages * (P * kFTM + PW * 4 * kFTJ) * kFTLd * 2;
}

// z[n0 .., the four gates of j0 ..] (32 x 4 x 16) = h W_k^T over this
// block's share of the stages of m; block z = its rank in the cluster of
// kFTSplit. h is P bf16 pieces (three for a float32 h, one for a bf16 h)
// and W is PW (three for a float32 W, one for a bf16 W); each stage's
// products go into a fresh accumulator, the partials meet in shared
// memory, and rank r sums its 32 / kFTSplit rows of them in rank order and
// runs their gate epilogue.
template <typename Tin, typename Ts, bool kGates, int PW>
__global__ void __cluster_dims__(1, 1, kFTSplit) __launch_bounds__(kFTThreads)
lstm_fwd_tc_kernel(FwdArgs p) {
  constexpr int P = std::is_same<Ts, float>::value ? 3 : 1;
  constexpr int kA = kFTM * kFTLd;                  // a piece's stage tile
  constexpr int kB = 4 * kFTJ * kFTLd;              // a W piece's stage tile
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* As = smem;                         // [stage][piece][kA]
  __nv_bfloat16* Bs = smem + kFTStages * P * kA;    // [stage][piece][kB]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.z;
  const int j0 = blockIdx.x * kFTJ, n0 = blockIdx.y * kFTM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp >> 1, wc = warp & 1;          // rows 16 wr, gates 2 wc
  const int N = p.N, H = p.H, Hk = p.Hk, Hm = p.Hm;
  const int nk = (Hm + kFTK - 1) / kFTK;
  const int kb0 = rank * nk / kFTSplit;
  const int nloc = (rank + 1) * nk / kFTSplit - kb0;
  const Ts* h = static_cast<const Ts*>(p.h);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w);
  // this thread's share of a stage's h tile: row ar, columns ac .. ac + 7
  const int ar = tid >> 2, ac = (tid & 3) * 8, an = n0 + ar;

  // split on load: a stage's h values into registers (zero past N and H),
  // then into shared memory as pieces
  float ra[8];
  auto load_a = [&](int kb) {
    const int m = kb * kFTK + ac;
    const Ts* src = h + static_cast<size_t>(an < N ? an : 0) * H;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      ra[e] = (an < N && m + e < H) ? f32(src[m + e]) : 0.f;
  };
  auto store_a = [&](int s) {
    __nv_bfloat16 pc[8][P];
#pragma unroll
    for (int e = 0; e < 8; ++e) split<P>(ra[e], pc[e]);
#pragma unroll
    for (int q = 0; q < P; ++q)
      *reinterpret_cast<uint4*>(As + (s * P + q) * kA + ar * kFTLd + ac) =
          make_uint4(pack2(pc[0][q], pc[1][q]), pack2(pc[2][q], pc[3][q]),
                     pack2(pc[4][q], pc[5][q]), pack2(pc[6][q], pc[7][q]));
  };
  // stage kb's asynchronous copies of W's pieces' 64 x 32 tiles, 16 bytes
  // each (row 16 k + jj is gate k's column j0 + jj; columns m >= Hm read 0)
  auto issue = [&](int kb, int s) {
    const int m0 = kb * kFTK;
#pragma unroll
    for (int r = 0; r < PW; ++r)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int i = tid + q * kFTThreads;
        const int row = i >> 2, ch = (i & 3) * 8, m = m0 + ch;
        cp_async16(Bs + (s * PW + r) * kB + row * kFTLd + ch,
                   w + ((static_cast<size_t>(r) * 4 + row / kFTJ) * Hk + j0 +
                        row % kFTJ) * Hm + (m < Hm ? m : 0),
                   m < Hm ? 16 : 0);
      }
    cp_async_commit();
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
  if (nloc > 0) {
    load_a(kb0);
    store_a(0);
  }
  if (nloc > 1) load_a(kb0 + 1);
#pragma unroll
  for (int s = 0; s < kFTStages - 1; ++s) {
    if (s < nloc) issue(kb0 + s, s);
    else cp_async_commit();
  }
  for (int i = 0; i < nloc; ++i) {
    cp_async_wait<kFTStages - 2>();
    __syncthreads();                         // stage i in, i - 1 consumed
    if (i + 1 < nloc) {                      // h of stage i + 1, then i + 2
      store_a((i + 1) % kFTStages);
      if (i + 2 < nloc) load_a(kb0 + i + 2);
    }
    const int nx = i + kFTStages - 1;
    if (nx < nloc) issue(kb0 + nx, nx % kFTStages);
    else cp_async_commit();
    const int s = i % kFTStages;
    float part[4][4];                        // the stage's own accumulator
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[t][q] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kFTK / 16; ++ks) {
      uint32_t a[P][4], b[PW][4][2];
#pragma unroll
      for (int q = 0; q < P; ++q)
        ldsm_x4<false>(a[q], As + (s * P + q) * kA +
                                 (16 * wr + (lane & 15)) * kFTLd + 16 * ks +
                                 (lane >> 4) * 8);
      // W rows are columns of the product, m along each: no .trans
#pragma unroll
      for (int pr = 0; pr < PW; ++pr)
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          uint32_t r[4];
          ldsm_x4<false>(r, Bs + (s * PW + pr) * kB +
                                ((2 * wc + g) * kFTJ + (lane & 7) +
                                 ((lane >> 4) << 3)) * kFTLd +
                                16 * ks + ((lane >> 3) & 1) * 8);
          b[pr][2 * g][0] = r[0];
          b[pr][2 * g][1] = r[1];
          b[pr][2 * g + 1][0] = r[2];
          b[pr][2 * g + 1][1] = r[3];
        }
      // h piece q times W piece r for q + r <= 2, smallest first: with
      // three pieces each hi.lo, mid.mid, lo.hi, then hi.mid, mid.hi, then
      // hi.hi (mid.lo, lo.mid and lo.lo, below float32's rounding, are
      // dropped); with one W piece lo, mid, then hi
#pragma unroll
      for (int sum = 2; sum >= 0; --sum)
#pragma unroll
        for (int q = 0; q < P; ++q) {
          const int r = sum - q;
          if (r >= 0 && r < PW)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              mma_bf16(part[nt], a[q], b[r][nt]);
        }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[t][q] = __fadd_rn(acc[t][q], part[t][q]);
  }
  cp_async_wait<0>();
  __syncthreads();
  // the block's partial, 32 rows x (4 gates x 16 columns), float32
  float* red = reinterpret_cast<float*>(smem);
  constexpr int kC = 4 * kFTJ;
  const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = 32 * wc + 8 * nt + 2 * t4, row = 16 * wr + g8;
    red[row * kC + col] = acc[nt][0];
    red[row * kC + col + 1] = acc[nt][1];
    red[(row + 8) * kC + col] = acc[nt][2];
    red[(row + 8) * kC + col + 1] = acc[nt][3];
  }
  cluster.sync();
  // this block's rows of the tile, (n, j) pairs dealt to the threads
  constexpr int kRows = kFTM / kFTSplit;
  for (int e = tid; e < kRows * kFTJ; e += kFTThreads) {
    const int r = kRows * rank + e / kFTJ, jj = e % kFTJ;
    float prod[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < kFTSplit; ++q)
        v = __fadd_rn(v, cluster.map_shared_rank(red, q)[r * kC + g * kFTJ +
                                                          jj]);
      prod[g] = v;
    }
    const int n = n0 + r, j = j0 + jj;
    if (n < N && j < H) fwd_epilogue<Tin, Ts, kGates>(p, n, j, prod);
  }
  cluster.sync();                  // no block leaves while read remotely
}

template <typename Tin, typename Tw, typename Ts>
int fwd_launch(const FwdArgs& a, bool gates, cudaStream_t st) {
  const dim3 grid((a.H + kFJ - 1) / kFJ, (a.N + kFM - 1) / kFM);
  if (gates)
    lstm_fwd_kernel<Tin, Tw, Ts, true><<<grid, kFThreads, 0, st>>>(a);
  else
    lstm_fwd_kernel<Tin, Tw, Ts, false><<<grid, kFThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin, typename Tw>
int fwd_dispatch(int state_dtype, const FwdArgs& a, bool gates,
                 cudaStream_t st) {
  return state_dtype == 1 ? fwd_launch<Tin, Tw, __nv_bfloat16>(a, gates, st)
                          : fwd_launch<Tin, Tw, float>(a, gates, st);
}

template <typename Tin>
int fwd_dispatch_w(int w_dtype, int state_dtype, const FwdArgs& a,
                   bool gates, cudaStream_t st) {
  return w_dtype == 1
             ? fwd_dispatch<Tin, __nv_bfloat16>(state_dtype, a, gates, st)
             : fwd_dispatch<Tin, float>(state_dtype, a, gates, st);
}

template <typename Tin, typename Ts, bool kGates, int PW>
int fwd_tc_launch(const FwdArgs& a, cudaStream_t st) {
  constexpr int smem =
      fwd_tc_smem_bytes(std::is_same<Ts, float>::value ? 3 : 1, PW);
  // all of the SM's shared memory for blocks (a hint: five blocks of 37.5
  // KB, or three of 67.5 KB with a float32 W's three pieces), and the
  // opt-in above 48 KB; set once
  static const cudaError_t attrs = [] {
    cudaError_t e = cudaFuncSetAttribute(
        lstm_fwd_tc_kernel<Tin, Ts, kGates, PW>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          lstm_fwd_tc_kernel<Tin, Ts, kGates, PW>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          fwd_tc_smem_bytes(std::is_same<Ts, float>::value ? 3 : 1, PW));
    return e;
  }();
  if (attrs != cudaSuccess) return static_cast<int>(attrs);
  const dim3 grid((a.H + kFTJ - 1) / kFTJ, (a.N + kFTM - 1) / kFTM, kFTSplit);
  lstm_fwd_tc_kernel<Tin, Ts, kGates, PW><<<grid, kFTThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin, typename Ts, int PW>
int fwd_tc_dispatch(const FwdArgs& a, bool gates, cudaStream_t st) {
  return gates ? fwd_tc_launch<Tin, Ts, true, PW>(a, st)
               : fwd_tc_launch<Tin, Ts, false, PW>(a, st);
}

template <typename Tin, int PW>
int fwd_tc_dispatch_s(int state_dtype, const FwdArgs& a, bool gates,
                      cudaStream_t st) {
  return state_dtype == 1
             ? fwd_tc_dispatch<Tin, __nv_bfloat16, PW>(a, gates, st)
             : fwd_tc_dispatch<Tin, float, PW>(a, gates, st);
}

template <typename Tin>
int fwd_tc_dispatch_w(int w_pieces, int state_dtype, const FwdArgs& a,
                      bool gates, cudaStream_t st) {
  return w_pieces == 3 ? fwd_tc_dispatch_s<Tin, 3>(state_dtype, a, gates, st)
                       : fwd_tc_dispatch_s<Tin, 1>(state_dtype, a, gates, st);
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

// Types: 0 float32, 1 bfloat16. in_dtype is xp's and b's, w_dtype W's
// (4H, H); state_dtype is h's, c's, h1's and c1's. gates (N, 4H) float32,
// or null for the variant without the residual. The FMA kernel.
int lstm_fwd_launch(int in_dtype, int w_dtype, int state_dtype,
                    const void* xp, const void* h, const void* c,
                    const void* w, const void* b, void* h1, void* c1,
                    float* gates, int N, int H, void* stream) {
  const FwdArgs a{xp, h, c, w, b, h1, c1, gates, N, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool g = gates != nullptr;
  return in_dtype == 1
             ? fwd_dispatch_w<__nv_bfloat16>(w_dtype, state_dtype, a, g, st)
             : fwd_dispatch_w<float>(w_dtype, state_dtype, a, g, st);
}

// The tensor-core forward: wp W's (w_pieces, 4, Hk, Hm) bf16 copy
// (wp[r, k, j, m] = piece r of W[k H + j, m], zero past H; Hk a multiple
// of 32 and Hm of 8, both at least H): one piece for a bf16 W, hi + mid +
// lo for a float32 W; in_dtype and state_dtype as above.
int lstm_fwd_sm90_launch(int in_dtype, int state_dtype, int w_pieces,
                         const void* xp, const void* h, const void* c,
                         const void* wp, const void* b, void* h1, void* c1,
                         float* gates, int N, int H, int Hk, int Hm,
                         void* stream) {
  if (N < 1 || H < 1 || Hk < H || Hk % kTK || Hm < H || Hm % 8 ||
      (N + kFTM - 1) / kFTM > 65535 || (w_pieces != 1 && w_pieces != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{xp, h, c, wp, b, h1, c1, gates, N, H, Hk, Hm};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool g = gates != nullptr;
  return in_dtype == 1
             ? fwd_tc_dispatch_w<__nv_bfloat16>(w_pieces, state_dtype, a, g,
                                                st)
             : fwd_tc_dispatch_w<float>(w_pieces, state_dtype, a, g, st);
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
