// int8 x int8 -> int32 products on the int8 tensor cores of Hopper
// (sm_90a): the convolution (qconv_s8) and the fully connected product
// (qgemm_s8) of int8 inference, with the quantized layers' two epilogues.
//
// Replaces no Pallas kernel: the reference runs its int8 products through
// lax.dot_general (ops/quantization.py: quantized_fully_connected) and
// lax.conv_general_dilated (quantized_conv) with an int32 result type, the
// MXU's int8 mode, outside any Pallas kernel. PyTorch has no int8
// convolution on CUDA and no int8 matmul but the 2-D, shape-limited
// torch._int_mm, so no library call computes quantized_conv.
//
//   qmma_kernel<kGemm=0>  quantized_conv: x (N, C, H, W) int8 NCHW, w (O,
//       C/groups, kh, kw) int8 OIHW, any stride, padding, dilation and
//       groups (the grid's z axis walks the groups). An implicit GEMM per
//       group: rows m = (n, ho, wo), columns o, depth k = (c, r, t) with
//       K = C/groups * kh * kw; the im2col rows are gathered into shared
//       memory, the halo and the K tail predicated to zero.
//   qmma_kernel<kGemm=1>  quantized_fully_connected: x (N, K) int8 row-major
//       times w (units, K) int8, the same tile and MMA with the A rows read
//       like the B rows.
//
// Epilogues, both in the kernel (kEpi):
//   0: the raw int32 accumulator (the float-boundary layers; dequantize
//      follows in plain PyTorch);
//   1: the requantize-fused chain member (contrib/quantization.py's
//      quantized_forward): int32 bias added, ReLU on the accumulator,
//      then the reference's requantize — float(y) * step, then * (127 /
//      cal), two separate float32 multiplies rounded to nearest, rint
//      (half to even), clamp to +-127, all zeros when the calibrated range
//      is zero. The wrapper computes step and 127 / cal in float32 as the
//      reference's weak-typed scalars are, so the kernel's int8 codes
//      equal the plain twin's bit for bit.
//
// What bounds it on an H100: the int8 tensor cores (1,979 dense TOPS) for
// the wide convs of ResNet-50, device-memory bytes for the stem and the
// batch-1..32 head. This first design is the simple one: a 64 x 64 output
// tile a block of four warps (each 32 x 32, two m16 x four n8
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32 a 32-deep stage), one 32-deep
// stage of A and B in shared memory at a time (rows padded to 48 bytes so
// the fragment loads hit 32 distinct banks), several blocks an SM to hide
// the gathers' latency. Int32 accumulation is exact, so no design choice
// moves a result. Later work: wgmma s8 fed by TMA, an NHWC int8 layout
// inside chains, a pipelined ring, persistence.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;          // output rows (pixels or batch rows) a block
constexpr int kBN = 64;          // output channels a block
constexpr int kBK = 32;          // depth of one MMA stage (32 int8)
constexpr int kLds = 48;         // bytes a shared-memory row: 32 + 16 pad
constexpr int kThreads = 128;    // four warps, 2 x 2 over the tile

struct QArgs {
  const int8_t* x;
  const int8_t* w;
  void* y;
  const int* bias;       // int32 (O,), or null
  int C, H, W;           // input channels (all groups) and spatial size
  int O;                 // output channels (all groups)
  int kh, kw, sh, sw, ph, pw, dh, dw;
  int Ho, Wo;
  int Cg, Og, K;         // a group's input and output channels, depth
  int M;                 // output rows: N * Ho * Wo, or N for the GEMM
  int vec_a, vec_b;      // 16-byte row loads allowed
  int relu, zero;
  float step, s127;
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4],
                                       const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 64 rows x 32 bytes of a row-major (rows, K) int8 matrix, from depth k0,
// into s: 16 bytes a thread, zero past rows_valid and past K.
__device__ __forceinline__ void load_rows(int8_t (*s)[kLds],
                                          const int8_t* __restrict__ base,
                                          int rows_valid, int K, int k0,
                                          int tid, int vec) {
  const int r = tid >> 1, h = (tid & 1) * 16;
  const int k = k0 + h;
  int4 v = make_int4(0, 0, 0, 0);
  if (r < rows_valid && k < K) {
    const int8_t* p = base + (long long)r * K + k;
    if (vec) {
      v = *reinterpret_cast<const int4*>(p);   // K % 16 == 0: k + 16 <= K
    } else {
      unsigned wv[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (k + i < K)
          wv[i >> 2] |= (unsigned)(uint8_t)p[i] << (8 * (i & 3));
      v = make_int4((int)wv[0], (int)wv[1], (int)wv[2], (int)wv[3]);
    }
  }
  *reinterpret_cast<int4*>(&s[r][h]) = v;
}

template <int kGemm, int kEpi>
__global__ void __launch_bounds__(kThreads)
qmma_kernel(const QArgs a) {
  __shared__ __align__(16) int8_t As[kBM][kLds];
  __shared__ __align__(16) int8_t Bs[kBN][kLds];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.x * kBM, o0 = blockIdx.y * kBN, g = blockIdx.z;
  const int K = a.K, P = a.Ho * a.Wo;
  const int rows_m = min(kBM, a.M - m0), rows_o = min(kBN, a.Og - o0);
  const int8_t* wbase = a.w + ((long long)g * a.Og + o0) * K;

  // the im2col rows this thread gathers: m0 + lane and m0 + lane + 32
  const int khw = a.kh * a.kw;
  const long long HW = (long long)a.H * a.W;
  int hi0[2] = {0, 0}, wi0[2] = {0, 0};
  bool mok[2] = {false, false};
  long long xoff[2] = {0, 0};
  if (!kGemm) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + lane + 32 * i;
      mok[i] = m < a.M;
      const int n = mok[i] ? m / P : 0;
      const int p = m - n * P;
      const int ho = p / a.Wo, wo = p - (p / a.Wo) * a.Wo;
      hi0[i] = ho * a.sh - a.ph;
      wi0[i] = wo * a.sw - a.pw;
      xoff[i] = ((long long)n * a.C + (long long)g * a.Cg) * HW;
    }
  }

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();                      // the last stage has been read
    if (kGemm) {
      load_rows(As, a.x + (long long)m0 * K, rows_m, K, k0, tid, a.vec_a);
    } else {
#pragma unroll
      for (int j = 0; j < kBK / 4; ++j) {
        const int kl = warp + 4 * j;
        const int k = k0 + kl;
        int8_t v0 = 0, v1 = 0;
        if (k < K) {
          const int c = k / khw;
          const int rs = k - c * khw;
          const int r = rs / a.kw;
          const int t = rs - r * a.kw;
          const long long coff = (long long)c * HW;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int hi = hi0[i] + r * a.dh, wi = wi0[i] + t * a.dw;
            int8_t v = 0;
            if (mok[i] && hi >= 0 && hi < a.H && wi >= 0 && wi < a.W)
              v = a.x[xoff[i] + coff + (long long)hi * a.W + wi];
            if (i == 0) v0 = v; else v1 = v;
          }
        }
        As[lane][kl] = v0;
        As[lane + 32][kl] = v1;
      }
    }
    load_rows(Bs, wbase, rows_o, K, k0, tid, a.vec_b);
    __syncthreads();

    int af[2][4], bf[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wm + i * 16 + gid;
      af[i][0] = *reinterpret_cast<const int*>(&As[r][tig * 4]);
      af[i][1] = *reinterpret_cast<const int*>(&As[r + 8][tig * 4]);
      af[i][2] = *reinterpret_cast<const int*>(&As[r][16 + tig * 4]);
      af[i][3] = *reinterpret_cast<const int*>(&As[r + 8][16 + tig * 4]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = wn + j * 8 + gid;
      bf[j][0] = *reinterpret_cast<const int*>(&Bs[r][tig * 4]);
      bf[j][1] = *reinterpret_cast<const int*>(&Bs[r][16 + tig * 4]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
  }

  // epilogue: accumulator (row gid or gid + 8, columns tig * 2 + {0, 1})
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + i * 16 + gid + half * 8;
      if (m >= a.M) continue;
      const int n = m / P;
      const long long ybase = (long long)n * a.O * P + (m - n * P);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = o0 + wn + j * 8 + tig * 2 + e;
          if (o >= a.Og) continue;
          const int oc = g * a.Og + o;
          const long long off = ybase + (long long)oc * P;
          int v = acc[i][j][half * 2 + e];
          if (kEpi == 0) {
            static_cast<int*>(a.y)[off] = v;
          } else {
            if (a.bias != nullptr) v += a.bias[oc];
            if (a.relu) v = max(v, 0);
            float f = __fmul_rn(__int2float_rn(v), a.step);
            f = rintf(__fmul_rn(f, a.s127));
            f = fminf(fmaxf(f, -127.f), 127.f);
            static_cast<int8_t*>(a.y)[off] =
                a.zero ? (int8_t)0 : (int8_t)(int)f;
          }
        }
      }
    }
  }
}

template <int kGemm>
void launch(int epi, const QArgs& a, dim3 grid, cudaStream_t st) {
  if (epi == 0)
    qmma_kernel<kGemm, 0><<<grid, kThreads, 0, st>>>(a);
  else
    qmma_kernel<kGemm, 1><<<grid, kThreads, 0, st>>>(a);
}

}  // namespace

// gemm 0: conv (N, C, H, W) x (O, C/groups, kh, kw); gemm 1: (N, C) x
// (O, C) with every spatial argument 1 and no padding. epi 0 writes int32,
// epi 1 int8 (bias may be null). Returns a cudaError_t as int.
int qmma_s8_launch(int gemm, int epi, const void* x, const void* w, void* y,
                   const void* bias, int N, int C, int H, int W, int O,
                   int kh, int kw, int sh, int sw, int ph, int pw, int dh,
                   int dw, int groups, int Ho, int Wo, int relu, float step,
                   float s127, int zero, void* stream) {
  if (groups < 1 || C % groups || O % groups || epi < 0 || epi > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  QArgs a;
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.y = y;
  a.bias = static_cast<const int*>(bias);
  a.C = C; a.H = H; a.W = W; a.O = O;
  a.kh = kh; a.kw = kw; a.sh = sh; a.sw = sw; a.ph = ph; a.pw = pw;
  a.dh = dh; a.dw = dw; a.Ho = Ho; a.Wo = Wo;
  a.Cg = C / groups; a.Og = O / groups; a.K = a.Cg * kh * kw;
  a.M = gemm ? N : N * Ho * Wo;
  const bool k16 = a.K % 16 == 0;
  a.vec_a = gemm && k16 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  a.vec_b = k16 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  a.relu = relu; a.zero = zero; a.step = step; a.s127 = s127;
  if (a.M == 0 || a.Og == 0) return 0;
  dim3 grid((a.M + kBM - 1) / kBM, (a.Og + kBN - 1) / kBN, groups);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gemm) launch<1>(epi, a, grid, st);
  else launch<0>(epi, a, grid, st);
  return static_cast<int>(cudaGetLastError());
}
