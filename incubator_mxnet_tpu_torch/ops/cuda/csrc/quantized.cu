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
// Two routes; the wrapper (ops/cuda/quantized.py: qconv_plan, qgemm_plan)
// picks one by shape before the launch.
//
//   qtma_kernel<BN, kEpi, kT>  the Hopper route: an implicit GEMM on
//       channels-last int8 codes. x is (N, H, W, C) in memory (an (N, C,
//       H, W) tensor in torch.channels_last), w (O, kh, kw, C) (an OIHW
//       tensor in channels_last: K-major, tap by tap). A block tile is 64
//       output rows x BN (32, 64 or 128) columns; its rows are nb images x
//       hb output rows x the whole output width Wo (nb hb Wo <= 64), so
//       the A operand of tap (r, s) and a 128-channel slice is ONE 4-D TMA
//       box {128, Wo, hb, nb} of x at (c0, s dw - pw, ho0 + r dh - ph,
//       n0): coordinates outside the image read 0, which is the halo and
//       the padding; a stride-2 1x1 reads a map whose W and H strides are
//       doubled (no gather). B is one 3-D box {128, 1, BN} of w's (C,
//       taps, O) map. Both land 128B-swizzled in a ring of three to six
//       stages with full and empty mbarriers: one producer thread issues
//       the loads, a consumer warpgroup runs wgmma.m64nBNk32.s32.s8.s8
//       straight from the stage, four k32 steps a stage, one group in
//       flight while the next is issued; setmaxnreg moves the producer's
//       registers to it. Channels past C and output columns past O read
//       0, so no tail needs masking. The grid is persistent, two blocks an
//       SM (so one block's epilogue runs beside the other's products), a
//       block walking its work items; the epilogue's staging tile lies
//       beside the ring, so the producer loads the next item's stages
//       while the consumers store this one's (the shallow convs at batch
//       32 are 900-3,600 one-stage tiles).
//       Where the tiles cannot fill the card (the deep stages at every
//       batch, every shape at batch 1, the head), the items also split K:
//       each split stores its int32 partial tile in its own slice of a
//       workspace and takes a ticket; the tile's last split adds the other
//       slices to its own in split order and runs the epilogue. Int32
//       addition is exact, so the sum is the twin's bit for bit. The
//       tickets lie at the end of the launch's own workspace and a memset
//       on the launch's stream zeroes them first (a memset node in a CUDA
//       graph), so two launches never share a ticket, whatever streams or
//       graph replays overlap; nothing syncs with the host, so the route
//       is capturable.
//       The epilogue requantizes in registers (each thread's bias values
//       read once an item), stages the tile in shared memory (int8 codes,
//       or the raw int32 with rows padded by four words) and writes 16-byte
//       runs, 16 codes or 4 int32 a store, channels-last for the conv (the
//       float boundary's raw int32 too, so no layout pass runs anywhere in
//       the int8 net). kT: the fully connected product with the operands
//       swapped (the units are wgmma's M and the batch its N: w (units, K)
//       is the A operand, x (N, K) the B one, both K-major as they are),
//       its tile staged column-major and written as rows of y (N, units).
//   qmma_kernel<kGemm, kEpi>  the first design, the route of the shapes
//       the TMA plan cannot take (C / groups not a multiple of 16, as the
//       stem's C 3; groups > 1; a stride with a kernel wider than 1 or a
//       pad; Wo > 64) and, behind the wrapper's _route="simple", the
//       yardstick of the other. The same layouts as the Hopper route
//       (channels-last x and y, tap-major w). A 64 x 64 output tile a
//       block of four warps (each 32 x 32, two m16 x four n8
//       mma.sync.m16n8k32.row.col.s32.s8.s8.s32 a 32-deep stage), one
//       32-deep stage in shared memory at a time (rows padded to 48 bytes),
//       the im2col rows gathered byte by byte, K in (r, t, c) order, the
//       halo and the K tail predicated to zero; the grid's z axis walks the
//       groups. kGemm=1: x (N, K) row-major, its rows read like the
//       weight's.
//
// Epilogues, both routes (kEpi):
//   0: the raw int32 accumulator (the float-boundary layers; dequantize
//      follows in plain PyTorch);
//   1: the requantize-fused chain member (contrib/quantization.py's
//      quantized_forward): int32 bias added, ReLU on the accumulator,
//      then the reference's requantize — float(y) * step, then * (127 /
//      cal), two separate float32 multiplies rounded to nearest, rint
//      (half to even), clamp to +-127, all zeros when the calibrated range
//      is zero. The wrapper computes step and 127 / cal in float32 as the
//      reference's weak-typed scalars are, so the kernels' int8 codes
//      equal the plain twin's bit for bit.
//
// What bounds them on an H100: device-memory bytes at ResNet-50's int8
// shapes (262 G int8 operations a batch of 32 take 0.13 ms at 1,979 TOPS,
// its 53 convs' bytes 0.27 ms at 3.35 TB/s) and at the batch-1..32 head.
// The Hopper route's TMA boxes read each operand byte once a tile with no
// per-byte address arithmetic, and split K fills the card where the tiles
// cannot. Later work: a 64-byte-row stage for C 64 (its 128-byte rows are
// half zeros), outputs wider than 64 (two boxes a row), and the stem (C
// 3, a 7x7 at stride 2) on this route.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_gemm.cuh"

namespace {

using namespace sm90;

// ================================================= the first design (simple)
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

// the requantize epilogue of one accumulator, its bias added (kEpi 1)
__device__ __forceinline__ int8_t requant(int v, int relu, int zero,
                                          float step, float s127) {
  if (relu) v = max(v, 0);
  float f = __fmul_rn(__int2float_rn(v), step);
  f = rintf(__fmul_rn(f, s127));
  f = fminf(fmaxf(f, -127.f), 127.f);
  return zero ? (int8_t)0 : (int8_t)(int)f;
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
      xoff[i] = (long long)n * a.H * a.W * a.C + (long long)g * a.Cg;
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
          const int tap = k / a.Cg;
          const int c = k - tap * a.Cg;
          const int r = tap / a.kw;
          const int t = tap - r * a.kw;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int hi = hi0[i] + r * a.dh, wi = wi0[i] + t * a.dw;
            int8_t v = 0;
            if (mok[i] && hi >= 0 && hi < a.H && wi >= 0 && wi < a.W)
              v = a.x[xoff[i] + ((long long)hi * a.W + wi) * a.C + c];
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
      const long long ybase = (long long)m * a.O;   // y (M, O) row-major
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = o0 + wn + j * 8 + tig * 2 + e;
          if (o >= a.Og) continue;
          const int oc = g * a.Og + o;
          const long long off = ybase + oc;
          const int v = acc[i][j][half * 2 + e];
          if (kEpi == 0)
            static_cast<int*>(a.y)[off] = v;
          else
            static_cast<int8_t*>(a.y)[off] = requant(
                a.bias != nullptr ? v + a.bias[oc] : v, a.relu, a.zero,
                a.step, a.s127);
        }
      }
    }
  }
}

template <int kGemm>
void launch_simple(int epi, const QArgs& a, dim3 grid, cudaStream_t st) {
  if (epi == 0)
    qmma_kernel<kGemm, 0><<<grid, kThreads, 0, st>>>(a);
  else
    qmma_kernel<kGemm, 1><<<grid, kThreads, 0, st>>>(a);
}

// ================================================== the Hopper route (TMA)
constexpr int kQBM = 64;                  // output rows of a block tile
constexpr int kQBK = 128;                 // bytes of K a stage: one swizzled row
constexpr int kQThreads = 256;            // a consumer warpgroup + a producer
constexpr int kQConsumers = 128;          // one
constexpr int kQBlocksPerSM = 2;          // so one's epilogue overlaps the
                                          // other's products
constexpr int kQSmemBudget = 108 * 1024;  // the ring and the staging tile
constexpr int kQMaxStages = 6;
constexpr int kQPad = 4;                  // int32 padding of a staging row
constexpr int kQMaxBox = 64;              // rows of a tile (nb hb Wo)

// Shared-memory plan (mirrored by quantized.py:_tma_smem): a stage holds
// the 64-row A box and the BN-row B box, 128 bytes a row; the epilogue's
// int32 staging tile (rows padded by kQPad words, row-major or, under kT,
// column-major) lies beside the ring, so that a tile's epilogue overlaps
// the next tile's loads; up to kQMaxStages stages in what the budget
// leaves. Two blocks fit an SM.
template <int BN>
struct QPlan {
  static constexpr int kA = kQBM * kQBK;
  static constexpr int kB = BN * kQBK;
  static constexpr int kStage = kA + kB;
  static constexpr int kRowMajor = kQBM * (BN + kQPad);
  static constexpr int kColMajor = BN * (kQBM + kQPad);
  static constexpr int kStaging =
      (kRowMajor > kColMajor ? kRowMajor : kColMajor) * 4;
  static constexpr int kStages = (kQSmemBudget - kStaging) / kStage <
                                         kQMaxStages
                                     ? (kQSmemBudget - kStaging) / kStage
                                     : kQMaxStages;
  static constexpr int kSmem = kStages * kStage + kStaging + 1024;
  static_assert(kStages >= 3, "fewer than three stages");
  static_assert(kQBlocksPerSM * (kSmem + 1024) <= 227 * 1024,
                "two blocks do not fit an SM");
};

struct QTArgs {
  void* y;
  const int* bias;        // int32 (O,), or (units,) under kT; or null
  int* ws;                // splits > 1: splits x tiles x kQBM x BN partials
  int* tickets;           // splits > 1: a ticket a tile, zero at the launch
  int R, Wo, hb, nb;      // a tile's rows: nb images x hb rows x Wo
  int Ho, Nimg, ht;       // output height, images, row tiles an image
  int mtiles, ntiles;     // row and column tiles
  int items;              // mtiles x ntiles x splits, the blocks' work
  int splits;             // of K
  int O;                  // output columns (the batch under kT)
  int cs, nk, kw;         // 128-byte slices a tap, stages, kernel width
  int dh, dw, ph, pw;     // tap geometry (0 pads in the strided 1x1)
  long long ys_p, ys_o;   // y's strides of a row (pixel, unit), a column
  int relu, zero;
  float step, s127;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// one 16-byte run of the staging tile at src -> y at dst, n_valid of its
// values inside the output: one 16-byte store where the run is whole and
// aligned
template <typename T>
__device__ __forceinline__ void copy_run(T* dst, const T* src, int n_valid) {
  constexpr int V = 16 / sizeof(T);
  if (n_valid == V && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
    for (int e = 0; e < n_valid; ++e) dst[e] = src[e];
  }
}

// Persistent: block b takes work items b, b + gridDim.x, ... (item =
// (split, row tile, column tile), the column tile fastest, so that the
// blocks of a wave share the A boxes in L2). Per item, y tile (R rows x BN
// columns) = the sum over the split's stages of the A box times the B box;
// then the split reduction and the epilogue (above). The producer runs
// ahead into the next item's stages while the consumers finish one.
template <int BN, int kEpi, bool kT>
__global__ void __launch_bounds__(kQThreads, kQBlocksPerSM)
qtma_kernel(const __grid_constant__ CUtensorMap tx,
            const __grid_constant__ CUtensorMap tw, const QTArgs p) {
  using P = QPlan<BN>;
  constexpr int S = P::kStages;
  extern __shared__ unsigned char dyn[];
  unsigned char* smem = align1024(dyn);
  int* stg = reinterpret_cast<int*>(smem + S * P::kStage);
  __shared__ __align__(8) uint64_t full[S], empty[S];
  __shared__ int last_split;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kQConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
  // item -> (split, mt, nt) and the split's stages [kb0, kb0 + nk)
  auto decode = [&](int item, int& mt, int& nt, int& split, int& kb0,
                    int& nk) {
    nt = item % p.ntiles;
    mt = (item / p.ntiles) % p.mtiles;
    split = item / (p.ntiles * p.mtiles);
    kb0 = static_cast<int>((long long)p.nk * split / p.splits);
    nk = static_cast<int>((long long)p.nk * (split + 1) / p.splits) - kb0;
  };
  if (threadIdx.x >= kQConsumers) {                    // producer
    reg_dealloc<40>();
    if (threadIdx.x == kQConsumers) {
      tma_prefetch(&tx);
      tma_prefetch(&tw);
      const uint32_t bytes = p.R * kQBK + P::kB;
      int i = 0;                                       // stages so far
      for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
        int mt, nt, split, kb0, nk;
        decode(item, mt, nt, split, kb0, nk);
        const int n0 = (mt / p.ht) * p.nb, ho0 = (mt % p.ht) * p.hb;
        for (int j = 0; j < nk; ++j, ++i) {
          const int kb = kb0 + j, tap = kb / p.cs;
          const int c0 = (kb - tap * p.cs) * kQBK;
          const int r = tap / p.kw, s = tap - r * p.kw;
          if (i >= S) mbar_wait(&empty[i % S], ((i / S) - 1) & 1);
          unsigned char* st = smem + (i % S) * P::kStage;
          mbar_expect_tx(&full[i % S], bytes);
          tma_load_4d(st, &tx, &full[i % S], c0, s * p.dw - p.pw,
                      ho0 + r * p.dh - p.ph, n0);
          tma_load_3d(st + P::kA, &tw, &full[i % S], c0, tap, nt * BN);
        }
      }
    }
    return;
  }
  reg_alloc<208>();                                    // consumers
  const int ct = threadIdx.x, w = ct >> 5, lane = ct & 31;
  const int g = lane >> 2, t = lane & 3;
  constexpr int kPitch = (kT ? kQBM : BN) + kQPad;      // int32 staging
  constexpr int kPitch8 = (kT ? kQBM : BN) + 16;        // int8 staging
  constexpr int V = kEpi ? 16 : 4;                 // values a 16-byte store
  const size_t tile_ints = static_cast<size_t>(kQBM) * BN;
  const int tiles = p.mtiles * p.ntiles;
  int i = 0;                                       // stages so far
  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
    int mt, nt, split, kb0, nk;
    decode(item, mt, nt, split, kb0, nk);
    const int n0 = (mt / p.ht) * p.nb, ho0 = (mt % p.ht) * p.hb;
    const int o0 = nt * BN;
    int acc[BN / 2];
#pragma unroll
    for (int q = 0; q < BN / 2; ++q) acc[q] = 0;
    for (int j = 0; j < nk; ++j, ++i) {
      mbar_wait(&full[i % S], (i / S) & 1);
      const unsigned char* st = smem + (i % S) * P::kStage;
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_s8(acc, desc_sw128(st + ks * 32, 16, 1024),
                 desc_sw128(st + P::kA + ks * 32, 16, 1024));
      wgmma_commit();
      fence_regs(acc);
      wgmma_wait<1>();
      fence_regs(acc);
      if (j > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(i - 1) % S]);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[(i - 1) % S]);

    // split K: every split stores its partials in its own slice, takes a
    // ticket; the tile's last split adds the others' to its own, in split
    // order
    if (p.splits > 1) {
      const int tile = mt * p.ntiles + nt;
      int* mine = p.ws + (static_cast<size_t>(split) * tiles + tile) *
                             tile_ints;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * w + g + 8 * h;
          if (r < p.R)
            __stcg(reinterpret_cast<int2*>(mine + r * BN + 8 * j + 2 * t),
                   make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
        }
      __threadfence();
      named_sync(1, kQConsumers);
      if (ct == 0)
        last_split = atomicAdd(&p.tickets[tile], 1) == p.splits - 1;
      named_sync(1, kQConsumers);
      if (!last_split) continue;
      __threadfence();
      for (int sp = 0; sp < p.splits; ++sp) {
        if (sp == split) continue;
        const int* theirs = p.ws + (static_cast<size_t>(sp) * tiles + tile) *
                                       tile_ints;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * w + g + 8 * h;
            if (r < p.R) {
              const int2 v = __ldcg(reinterpret_cast<const int2*>(
                  theirs + r * BN + 8 * j + 2 * t));
              acc[4 * j + 2 * h] += v.x;
              acc[4 * j + 2 * h + 1] += v.y;
            }
          }
      }
    }

    // the tile into the staging tile once the last item's stores have read
    // it: row-major [row][column], or column-major under kT; int32, or
    // under kEpi 1 the codes, requantized here from the registers (the
    // bias of the thread's columns, or under kT of its rows, read once)
    named_sync(1, kQConsumers);
    if constexpr (kEpi == 1) {
      int8_t* s8 = reinterpret_cast<int8_t*>(stg);
      if constexpr (kT) {
        int bias[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int unit = n0 + 16 * w + g + 8 * h;
          bias[h] = p.bias != nullptr && unit < p.Nimg ? p.bias[unit] : 0;
        }
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              s8[(8 * j + 2 * t + e) * kPitch8 + 16 * w + g + 8 * h] =
                  requant(acc[4 * j + 2 * h + e] + bias[h], p.relu, p.zero,
                          p.step, p.s127);
      } else {
        int bias[BN / 8][2];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = o0 + 8 * j + 2 * t + e;
            bias[j][e] = p.bias != nullptr && o < p.O ? p.bias[o] : 0;
          }
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * w + g + 8 * h;
            const uint8_t c0 = requant(acc[4 * j + 2 * h] + bias[j][0],
                                       p.relu, p.zero, p.step, p.s127);
            const uint8_t c1 = requant(acc[4 * j + 2 * h + 1] + bias[j][1],
                                       p.relu, p.zero, p.step, p.s127);
            *reinterpret_cast<uint16_t*>(s8 + r * kPitch8 + 8 * j + 2 * t) =
                static_cast<uint16_t>(c0 | (c1 << 8));
          }
      }
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 16 * w + g + 8 * h, c = 8 * j + 2 * t + e;
            stg[kT ? c * kPitch + r : r * kPitch + c] =
                acc[4 * j + 2 * h + e];
          }
    }
    named_sync(1, kQConsumers);
    using Out = typename std::conditional<kEpi == 1, int8_t, int>::type;
    Out* y = static_cast<Out*>(p.y);
    const Out* src = reinterpret_cast<const Out*>(stg);
    constexpr int kRow = kEpi == 1 ? kPitch8 : kPitch;   // staging pitch
    if constexpr (kT) {
      // runs down a column: units n0 + r .. of batch row o0 + c
      constexpr int kRuns = kQBM / V;
      for (int v = ct; v < BN * kRuns; v += kQConsumers) {
        const int c = v / kRuns, r = (v - c * kRuns) * V;
        const int o = o0 + c, unit = n0 + r;
        if (o >= p.O || r >= p.R || unit >= p.Nimg) continue;
        copy_run(y + unit * p.ys_p + o * p.ys_o, src + c * kRow + r,
                 min(V, min(p.R - r, p.Nimg - unit)));
      }
    } else {
      // runs along a row: channels o0 + c .. of the row's pixel
      constexpr int kRuns = BN / V;
      for (int v = ct; v < p.R * kRuns; v += kQConsumers) {
        const int r = v / kRuns, c = (v - r * kRuns) * V;
        const int wo = r % p.Wo, q = r / p.Wo;
        const int ho = ho0 + q % p.hb, n = n0 + q / p.hb, o = o0 + c;
        if (ho >= p.Ho || n >= p.Nimg || o >= p.O) continue;
        const long long pix = ((long long)n * p.Ho + ho) * p.Wo + wo;
        copy_run(y + pix * p.ys_p + o * p.ys_o, src + r * kRow + c,
                 min(V, p.O - o));
      }
    }
  }
}

// An int8 map of `rank` dims (dims[0] contiguous, strides in bytes for
// dims 1..), read in 128B-swizzled boxes; out-of-range elements read 0.
bool make_map_s8(CUtensorMap* map, const void* ptr, int rank,
                 const cuuint64_t* dims, const cuuint64_t* strides,
                 const cuuint32_t* box) {
  EncodeTiled enc = tensor_map_encoder();
  if (!enc) return false;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Sets the dynamic shared-memory limit of a kernel once, before its first
// launch, then launches it; returns the cudaError_t as int.
template <auto Kernel>
int launch_tma(int smem, dim3 grid, cudaStream_t st, const CUtensorMap& tx,
               const CUtensorMap& tw, const QTArgs& p) {
  static bool ready = false;                 // one flag per kernel
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  Kernel<<<grid, kQThreads, smem, st>>>(tx, tw, p);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, bool kT>
int tma_bn(int epi, dim3 grid, cudaStream_t st, const CUtensorMap& tx,
           const CUtensorMap& tw, const QTArgs& p) {
  constexpr int sm = QPlan<BN>::kSmem;
  return epi == 0 ? launch_tma<qtma_kernel<BN, 0, kT>>(sm, grid, st, tx, tw, p)
                  : launch_tma<qtma_kernel<BN, 1, kT>>(sm, grid, st, tx, tw,
                                                       p);
}

}  // namespace

// The first design. gemm 0: conv of channels-last x (N, H, W, C) by w (O,
// kh, kw, C/groups) into channels-last y (N, Ho, Wo, O); gemm 1: (N, C) x
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
  if (gemm) launch_simple<1>(epi, a, grid, st);
  else launch_simple<0>(epi, a, grid, st);
  return static_cast<int>(cudaGetLastError());
}

// The Hopper route. g = {N, C, H, W, O, kh, kw, sh, sw, ph, pw, dh, dw, Ho,
// Wo, hb, nb, bn, splits, blocks}. swap 0: a conv of channels-last x (N, H, W, C)
// by w (O, kh, kw, C) into channels-last y (N, Ho, Wo, O); stride 1, or a
// 1x1 with no padding at any stride; C a multiple of 16. swap 1: the fully
// connected product y (O, N) row-major = x (O, C)... with the operands
// swapped: x is the weight (units N, K C), w the activations (batch O, K
// C), y (batch, units); H = W = kh = kw = 1. hb and nb as quantized.py's
// plan chooses them (nb hb Wo <= 64); bn 32, 64 or 128; splits at most the
// stages; blocks: the persistent grid (two an SM at most); splits > 1: ws
// splits x tiles x 64 bn int32 partials, then a ticket a tile (zeroed here
// on the stream before the launch). Returns a cudaError_t as int.
int qtma_s8_launch(int swap, int epi, const void* x, const void* w, void* y,
                   const void* bias, void* ws, const int* g, int relu,
                   float step, float s127, int zero, void* stream) {
  const int N = g[0], C = g[1], H = g[2], W = g[3], O = g[4], kh = g[5],
            kw = g[6], sh = g[7], sw = g[8], ph = g[9], pw = g[10],
            dh = g[11], dw = g[12], Ho = g[13], Wo = g[14], hb = g[15],
            nb = g[16], bn = g[17], splits = g[18], blocks = g[19];
  const bool strided = sh != 1 || sw != 1;
  if (epi < 0 || epi > 1 || C % 16 || C < 16 || hb < 1 || nb < 1 ||
      Wo * hb * nb > kQMaxBox || Wo > kQMaxBox || splits < 1 ||
      splits > kh * kw * ((C + kQBK - 1) / kQBK) || blocks < 1 ||
      (bn != 32 && bn != 64 && bn != 128) ||
      (strided && (kh != 1 || kw != 1 || ph != 0 || pw != 0)) ||
      (swap && (H != 1 || W != 1 || kh != 1 || kw != 1)) ||
      (splits > 1 && ws == nullptr) ||
      (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(w) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || O == 0) return 0;
  // x (N, H, W, C): the map runs over (C, W', H', N), W' and H' the input
  // (stride 1) or the strided view the 1x1 reads (W and H strides doubled)
  const cuuint64_t xd[4] = {(cuuint64_t)C, (cuuint64_t)(strided ? Wo : W),
                            (cuuint64_t)(strided ? Ho : H), (cuuint64_t)N};
  const cuuint64_t xs[3] = {(cuuint64_t)sw * C, (cuuint64_t)sh * W * C,
                            (cuuint64_t)H * W * C};
  const cuuint32_t xb[4] = {kQBK, (cuuint32_t)Wo, (cuuint32_t)hb,
                            (cuuint32_t)nb};
  // w (O, taps, C): the map runs over (C, taps, O)
  const int taps = kh * kw;
  const cuuint64_t wd[3] = {(cuuint64_t)C, (cuuint64_t)taps, (cuuint64_t)O};
  const cuuint64_t wsd[2] = {(cuuint64_t)C, (cuuint64_t)taps * C};
  const cuuint32_t wb[3] = {kQBK, 1, (cuuint32_t)bn};
  CUtensorMap tx, tw;
  if (!make_map_s8(&tx, x, 4, xd, xs, xb) ||
      !make_map_s8(&tw, w, 3, wd, wsd, wb))
    return static_cast<int>(cudaErrorInvalidValue);
  QTArgs p;
  p.y = y;
  p.bias = static_cast<const int*>(bias);
  p.ws = static_cast<int*>(ws);
  p.R = Wo * hb * nb; p.Wo = Wo; p.hb = hb; p.nb = nb;
  p.Ho = Ho; p.Nimg = N; p.ht = (Ho + hb - 1) / hb;
  p.mtiles = ((N + nb - 1) / nb) * p.ht;
  p.ntiles = (O + bn - 1) / bn;
  p.splits = splits;
  p.items = p.mtiles * p.ntiles * splits;
  p.O = O;
  p.cs = (C + kQBK - 1) / kQBK; p.nk = taps * p.cs; p.kw = kw;
  p.dh = dh; p.dw = dw; p.ph = ph; p.pw = pw;
  p.ys_p = swap ? 1 : O;
  p.ys_o = swap ? N : 1;
  p.relu = relu; p.zero = zero; p.step = step; p.s127 = s127;
  const dim3 grid(blocks < p.items ? blocks : p.items);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  p.tickets = nullptr;
  if (splits > 1) {
    const size_t tiles = static_cast<size_t>(p.mtiles) * p.ntiles;
    p.tickets = p.ws + static_cast<size_t>(splits) * tiles * kQBM * bn;
    const cudaError_t e =
        cudaMemsetAsync(p.tickets, 0, tiles * sizeof(int), st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (swap) {
    if (bn == 32) return tma_bn<32, true>(epi, grid, st, tx, tw, p);
    if (bn == 64) return tma_bn<64, true>(epi, grid, st, tx, tw, p);
    return tma_bn<128, true>(epi, grid, st, tx, tw, p);
  }
  if (bn == 32) return tma_bn<32, false>(epi, grid, st, tx, tw, p);
  if (bn == 64) return tma_bn<64, false>(epi, grid, st, tx, tw, p);
  return tma_bn<128, false>(epi, grid, st, tx, tw, p);
}
