// The Hopper routes of the fused 1x1 and 3x3 conv kernels (sm_90a):
// TMA-fed wgmma with the load transform applied on chip. All five forms in
// bf16 and in float32, every float32 operand in three bf16 pieces (the
// float32 route, below the bf16 kernels).
//
// Replaces the Pallas TPU kernels of
// incubator_mxnet_tpu/ops/pallas/conv_fused.py:
//   cf90_fwd_kernel          <-  mm_fused (:148)        y = x^ @ W (+ bias),
//                                                       stats, x^
//   cf90_dual_dgrad_kernel \ <-  dgrad_epilogue (:505)  dx = G_a W_a^T +
//   cf90_dual_wgrad_kernel /                            G_b W_b^T; dW_a, dW_b
//   cf90_bwd_dgrad_kernel  \ <-  mm_fused_bwd (:344)    dz = mask(G W^T +
//   cf90_dual_wgrad_kernel /     (single set)           dsc), partials, x^;
//                                                       dW = x^T G
//   cf90_conv3_kernel        <-  conv3_fused (:634)     y = conv3x3(x^),
//                                                       stats
//   cf90_conv3_dgrad_kernel \ <- conv3_fused_bwd (:742) dz = mask(conv3^T
//   cf90_conv3_wgrad_kernel /                           G), partials, x^;
//                                                       dW9 = shift(x^)^T G
//   cf90_fwd_x3_kernel         <- mm_fused (:148), float32
//   cf90_conv3_x3_kernel       <- conv3_fused (:634), float32
//   cf90_dual_dgrad_x3_kernel \ <- dgrad_epilogue (:505), float32
//   cf90_dual_wgrad_x3_kernel /
//   cf90_bwd_dgrad_x3_kernel  \ <- mm_fused_bwd (:344), float32
//   cf90_dual_wgrad_x3_kernel /    (single set)
//   cf90_conv3_dgrad_x3_kernel \ <- conv3_fused_bwd (:742), float32
//   cf90_conv3_wgrad_x3_kernel /
//   (cf90_split3_kernel makes their operands' bf16 pieces)
// with the reference's rounding points, as conv_fused.cu keeps them: the
// load transform (x^ = x, relu(a x + b) or relu(a x + b + asc sc + bsc);
// G = (dzn g0 - g1) - yout g2) in float32 with both roundings of each step,
// rounded to bf16 before the product; float32 accumulation on the tensor
// cores; outputs rounded once; the stats summed over the ROUNDED y.
// In float32 all five take the three-piece kernels (no TF32 here: six bf16
// products hold float32's accuracy). The wrapper (ops/cuda/conv_fused.py)
// chooses the route by type and shape before the launch; conv_fused.cu's
// SIMT kernels take the shapes these cannot.
//
// What bounds them on an H100: at ResNet-50's shapes (M 6272..100352 rows,
// K and N 256..2048) the products, 2 M K N flops, outweigh the bytes, so
// the design feeds the tensor cores:
//   * a block of three warpgroups: two consumers of 64 output rows each
//     (a 128 x BN tile, BN 64, 128 or 256 = the output width rounded up,
//     at most 256, so the entry form's x and sc are read and transformed
//     once per row tile) and one producer whose single thread issues the
//     TMA loads; setmaxnreg moves the registers to the consumers;
//   * a ring of 3-4 shared-memory stages, each 64 deep (128-byte rows,
//     128B swizzle), a "full" mbarrier armed with the stage's bytes and an
//     "empty" one on which the eight consumer warps release it;
//   * raw operands come in by TMA (out-of-range rows and columns read 0),
//     and a consumer that must transform them (x^, G) reads its A fragment
//     out of the swizzled stage with ldmatrix, transforms it in float32
//     with the per-channel coefficients the producer copied into the stage,
//     masks the reduction tail (relu(a 0 + b) and -g1 need not be 0) and
//     hands the bf16 fragment to wgmma from registers, forming the next
//     stage's fragments while the products run; a plain operand (the plain
//     forward's x, the weights, the wgrad's G and x) goes to wgmma straight
//     from the stage through a descriptor;
//   * x^ (forward) and G (dgrad) are written back over their raw slab and
//     stored by TMA, each stage by one column tile, so the dual wgrad is a
//     plain product of G and x that neither reads dzn and yout nor
//     transforms again;
//   * the epilogue stages the rounded tile in shared memory (swizzled, so
//     neither the fragment writes nor the 16-byte row reads conflict),
//     sums the stats per column in a fixed order, and writes y with
//     16-byte stores; dW goes out as float32 partials per row split, which
//     the wrapper sums in order. No atomics: results repeat run to run.
//   * mm_fused_bwd's epilogue (mask on x or on a x + b, dsc, the partials
//     sum dz and sum dz p_j, x^ for the wgrad) takes its operands by TMA
//     through the same ring, 64 columns a stage, the first chunks under the
//     last stages' products, and finishes dz from the accumulators in
//     registers;
//   * conv3_fused runs the nine taps as nine shifted boxes of one (C, M)
//     map and masks the halo after the transform, per row and tap; its
//     backward's dgrad is mm_fused_bwd's dgrad over nine mirrored boxes of
//     G's maps (the halo masked after G's transform), and its wgrad the
//     plain product of G and a shifted x^ box, the halo zeroed in G's
//     stage rows.
// Persistence (one block per SM walking the tiles, so that one tile's
// epilogue overlaps the next one's loads) is later work; a cluster of two
// blocks sharing the B tile by TMA multicast measured slower at these
// shapes.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

#include "sm90_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kBM = 128;                 // output rows of a block tile
constexpr int kBK = 64;                  // reduction depth of a stage
constexpr int kThreads = 384;            // two consumer warpgroups + one
constexpr int kConsumers = 256;          // producer warpgroup
constexpr int kSlab = 64 * 128;          // bytes of a 64-row, 128-byte tile
constexpr int kA = 2 * kSlab;            // one raw A operand of a stage
constexpr int kStageBudget = 200 * 1024;

// Shared-memory plan (mirrored by conv_fused.py:sm90_plan): a stage holds
// NRAW 128 x 64 A operands, the BN x 64 B tile and 1 KB of per-channel
// coefficients (up to four 64-float slices), and at least MIN_STAGE bytes;
// 3-4 stages fit the budget.
template <int BN, int NRAW, int MIN_STAGE = 0>
struct Plan {
  static constexpr int kB = BN * kBK * 2;
  static constexpr int kCoef = NRAW * kA + kB;      // offset in a stage
  static constexpr int kStage = kCoef + 1024 > MIN_STAGE ? kCoef + 1024
                                                         : MIN_STAGE;
  static constexpr int kStages =
      kStageBudget / kStage < 4 ? kStageBudget / kStage : 4;
  static constexpr int kSmem = kStages * kStage + 1024;  // + alignment
  static_assert(kStages >= 3, "fewer than three stages");
  static_assert(kBM * BN * 2 + 2 * 2 * kConsumers * 4 <= kStages * kStage,
                "the epilogue's staging does not fit the ring");
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// a * v + b with both roundings of the reference (no fused multiply-add)
__device__ __forceinline__ float affine(float v, float a, float b) {
  return __fadd_rn(__fmul_rn(v, a), b);
}

// G = (dzn * g0 - g1) - yout * g2, in float32 as the reference orders it
__device__ __forceinline__ float bn_g(float dzn, float yout, float g0,
                                      float g1, float g2) {
  return __fsub_rn(__fsub_rn(__fmul_rn(dzn, g0), g1), __fmul_rn(yout, g2));
}

// The B tile of a stage: BN output columns x 64 reduction rows. K-major
// (BMN false): the map's inner dimension is the reduction, one box
// {64, BN} at (r0, o0). MN-major: the inner dimension is the output, BN / 64
// boxes {64, 64} at (o0 + 64 j, r0), 8 KB apart.
template <int BN, bool BMN>
__device__ __forceinline__ void load_b(unsigned char* dst,
                                       const CUtensorMap* map, uint64_t* bar,
                                       int r0, int o0) {
  if constexpr (BMN) {
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      tma_load_2d(dst + j * kSlab, map, bar, o0 + 64 * j, r0);
  } else {
    tma_load_2d(dst, map, bar, r0, o0);
  }
}

// B's descriptor at k16 step ks of a stage
template <bool BMN>
__device__ __forceinline__ uint64_t desc_b(const unsigned char* b, int ks) {
  return BMN ? desc_sw128(b + ks * 2048, kSlab, 1024)
             : desc_sw128(b + ks * 32, 16, 1024);
}

// D (64 x BN) += A (64 x 64 stage) B with A in registers, four k16 steps
// issued and committed as one group; the caller waits for it
template <int BN, bool BMN>
__device__ __forceinline__ void issue_rs(float (&acc)[BN / 2],
                                         const uint32_t (&a)[4][4],
                                         const unsigned char* b) {
  wgmma_fence();
  fence_regs(acc);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) wgmma_rs<BMN ? 1 : 0>(acc, a[ks],
                                                      desc_b<BMN>(b, ks));
  wgmma_commit();
  fence_regs(acc);
}

// the same with A (64 rows x 64 deep, in shared memory at a): K-major, 64
// rows of 128 bytes, or MN-major (AMN), 64 reduction rows of 128 bytes
template <int BN, bool AMN, bool BMN>
__device__ __forceinline__ void issue_ss(float (&acc)[BN / 2],
                                         const unsigned char* a,
                                         const unsigned char* b) {
  wgmma_fence();
  fence_regs(acc);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_ss<AMN ? 1 : 0, BMN ? 1 : 0>(
        acc, AMN ? desc_sw128(a + ks * 2048, kSlab, 1024)
                 : desc_sw128(a + ks * 32, 16, 1024),
        desc_b<BMN>(b, ks));
  wgmma_commit();
  fence_regs(acc);
}

// The ring of S stages: a "full" mbarrier per stage (the producer's
// arrival with the stage's bytes, then the bytes) and an "empty" one (an
// arrival from each consumer warp).
template <int S>
struct Ring {
  uint64_t* full;
  uint64_t* empty;

  __device__ void init() {
    if (threadIdx.x == 0) {
      for (int s = 0; s < S; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], kConsumers / 32);
      }
      mbar_fence_init();
    }
    __syncthreads();
  }
  // the producer's wait for stage kb's slot (free from the start in round 0)
  __device__ void wait_slot(int kb) {
    if (kb >= S) mbar_wait(&empty[kb % S], ((kb / S) - 1) & 1);
  }
  __device__ void wait_full(int kb) {
    mbar_wait(&full[kb % S], (kb / S) & 1);
  }
  // a consumer warp is done with stage kb (and any bulk store it issued
  // from the stage has read it)
  __device__ void release(int kb, int lane) {
    __syncwarp();
    if (lane == 0) {
      bulk_wait_read();
      mbar_arrive(&empty[kb % S]);
    }
  }
};

// A consumer warpgroup's main loop with A in registers: build(kb, stage,
// frag) waits for stage kb and forms its A fragments (ldmatrix, load
// transform, masks); the products of stage kb run while the fragments of
// stage kb + 1 are formed in the other register set. Unrolled by two so
// that both sets keep compile-time indices.
template <int BN, bool BMN, int STAGE, int S, int BOFS, typename Build>
__device__ __forceinline__ void mainloop_rs(float (&acc)[BN / 2], int nk,
                                            unsigned char* smem,
                                            Ring<S>& ring, int lane,
                                            Build build) {
  uint32_t f0[4][4], f1[4][4];
  if (nk > 0) build(0, smem, f0);
  for (int kb = 0; kb < nk; kb += 2) {
    unsigned char* st = smem + (kb % S) * STAGE;
    issue_rs<BN, BMN>(acc, f0, st + BOFS);
    if (kb + 1 < nk) build(kb + 1, smem + ((kb + 1) % S) * STAGE, f1);
    wgmma_wait<0>();
    fence_regs(acc);
    ring.release(kb, lane);
    if (kb + 1 >= nk) break;
    st = smem + ((kb + 1) % S) * STAGE;
    issue_rs<BN, BMN>(acc, f1, st + BOFS);
    if (kb + 2 < nk) build(kb + 2, smem + ((kb + 2) % S) * STAGE, f0);
    wgmma_wait<0>();
    fence_regs(acc);
    ring.release(kb + 1, lane);
  }
}

// The same with both operands straight from the stages (this warpgroup's
// A at a_ofs): one product group stays in flight while the next stage's is
// issued.
template <int BN, bool AMN, bool BMN, int STAGE, int S, int BOFS>
__device__ __forceinline__ void mainloop_ss(float (&acc)[BN / 2], int nk,
                                            unsigned char* smem,
                                            Ring<S>& ring, int lane,
                                            int a_ofs) {
  for (int kb = 0; kb < nk; ++kb) {
    ring.wait_full(kb);
    const unsigned char* st = smem + (kb % S) * STAGE;
    issue_ss<BN, AMN, BMN>(acc, st + a_ofs, st + BOFS);
    wgmma_wait<1>();
    fence_regs(acc);
    if (kb > 0) ring.release(kb - 1, lane);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  ring.release(nk - 1, lane);
}

// Epilogue shared by the forward and the dgrad: both consumer warpgroups'
// accumulators, rounded to bf16 (after the bias), into a swizzled staging
// tile of BN / 64 blocks of 128 rows x 128 bytes over the ring's memory;
// then 16-byte stores of rows m < M, columns n < N. With stats, one row
// pair of column sums (sum y, sum y^2 over the rounded values of the valid
// rows) per block, in a fixed order.
template <int BN>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2],
                                           unsigned char* smem,
                                           const float* bias, bf16* out,
                                           float* stats, int m0, int n0,
                                           int M, int N) {
  const int ct = threadIdx.x, wg = ct >> 7, w = (ct >> 5) & 3;
  const int lane = ct & 31, g = lane >> 2, t = lane & 3;
  named_sync(1, kConsumers);                // every stage is consumed
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * t;
    float b0 = 0.f, b1 = 0.f;
    if (bias && n0 + c < N) {
      b0 = bias[n0 + c];
      b1 = bias[n0 + c + 1];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * wg + 16 * w + g + 8 * h;
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (bias) {
        v0 = __fadd_rn(v0, b0);
        v1 = __fadd_rn(v1, b1);
      }
      *reinterpret_cast<uint32_t*>(smem + (c >> 6) * (kBM * 128) +
                                   swz(r, (c & 63) >> 3) + (c & 7) * 2) =
          pack_bf16(v0, v1);
    }
  }
  named_sync(1, kConsumers);
  const int rows = min(kBM, M - m0);
  if (stats) {
    // a column pair and a range of rows per thread, then the ranges in
    // order: 2, 4 or 8 ranges of 64, 32 or 16 rows
    constexpr int kParts = 2 * kConsumers / BN;
    constexpr int kRows = kBM / kParts;
    float* red = reinterpret_cast<float*>(smem + kBM * BN * 2);
    const int col = 2 * (ct % (BN / 2)), part = ct / (BN / 2);
    const unsigned char* blk = smem + (col >> 6) * (kBM * 128);
    const int chunk = (col & 63) >> 3, within = (col & 7) * 2;
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
    const int r1 = min(rows, (part + 1) * kRows);
#pragma unroll 4
    for (int r = part * kRows; r < r1; ++r) {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(
          blk + swz(r, chunk) + within);
      const float y0 = lo_f(v), y1 = hi_f(v);
      s1[0] += y0;
      s1[1] += y1;
      s2[0] = fmaf(y0, y0, s2[0]);
      s2[1] = fmaf(y1, y1, s2[1]);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      red[(part * 2) * BN + col + e] = s1[e];
      red[(part * 2 + 1) * BN + col + e] = s2[e];
    }
    named_sync(1, kConsumers);
    if (ct < BN && n0 + ct < N) {
      float t1 = 0.f, t2 = 0.f;
#pragma unroll
      for (int q = 0; q < kParts; ++q) {
        t1 += red[(q * 2) * BN + ct];
        t2 += red[(q * 2 + 1) * BN + ct];
      }
      const size_t row = static_cast<size_t>(m0 / kBM) * 2;
      stats[row * N + n0 + ct] = t1;
      stats[(row + 1) * N + n0 + ct] = t2;
    }
  }
  constexpr int kVecs = BN / 8;               // 16-byte vectors in a row
  for (int v = ct; v < kBM * kVecs; v += kConsumers) {
    const int r = v / kVecs, c8 = v % kVecs;
    const int n = n0 + 8 * c8;
    if (r < rows && n < N) {
      const uint4 val = *reinterpret_cast<const uint4*>(
          smem + (c8 >> 3) * (kBM * 128) + swz(r, c8 & 7));
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(m0 + r) * N + n) =
          val;
    }
  }
}

// ---------------------------------------------------------------- forward
struct FwdArgs {
  const float* a; const float* b;        // null: the plain form
  const float* asc; const float* bsc;    // null: no shortcut (entry form)
  const float* bias;
  bf16* y; float* stats; bf16* xhat;     // stats, xhat: null when not asked
  int M, K, N;
};

// y (M x N) = x^ (M x K) @ W (K x N) (+ bias) over 128 x BN tiles. REGA:
// A goes through registers (the load transform, or x^ to emit); else the
// plain x goes to wgmma from the stage. BMN: the weight's output index is
// its contiguous one.
template <int BN, bool BMN, bool REGA>
__global__ void __launch_bounds__(kThreads, 1)
cf90_fwd_kernel(const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tsc,
                const __grid_constant__ CUtensorMap tw,
                const __grid_constant__ CUtensorMap txh, const FwdArgs p) {
  using P = Plan<BN, REGA ? 2 : 1>;
  constexpr int S = P::kStages;
  extern __shared__ unsigned char dyn[];
  unsigned char* smem = align1024(dyn);
  __shared__ __align__(8) uint64_t full[S], empty[S];
  const int nk = (p.K + kBK - 1) / kBK;
  // column tiles of one row tile are neighbours in the launch order, so
  // the blocks that share x (and sc) run together and read it from L2
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  const bool entry = p.asc != nullptr;
  Ring<S> ring{full, empty};
  ring.init();
  constexpr int kBOfs = (REGA ? 2 : 1) * kA;
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {                                       // producer
    reg_dealloc<40>();
    if (threadIdx.x == kConsumers) {
      tma_prefetch(&tx);
      tma_prefetch(&tw);
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % S, k0 = kb * kBK;
        // the stage's slices of a, b (asc, bsc): 64 floats or the tail
        const uint32_t cb = p.a ? 4 * min(kBK, p.K - k0) : 0;
        ring.wait_slot(kb);
        unsigned char* st = smem + s * P::kStage;
        mbar_expect_tx(&full[s], (entry ? 2 : 1) * kA + P::kB +
                                     (entry ? 4 : 2) * cb);
        tma_load_2d(st, &tx, &full[s], k0, m0);
        if (entry) tma_load_2d(st + kA, &tsc, &full[s], k0, m0);
        load_b<BN, BMN>(st + kBOfs, &tw, &full[s], k0, n0);
        if (cb) {
          bulk_load(st + P::kCoef, p.a + k0, cb, &full[s]);
          bulk_load(st + P::kCoef + 256, p.b + k0, cb, &full[s]);
          if (entry) {
            bulk_load(st + P::kCoef + 512, p.asc + k0, cb, &full[s]);
            bulk_load(st + P::kCoef + 768, p.bsc + k0, cb, &full[s]);
          }
        }
      }
    }
  } else {                                             // consumers
    reg_alloc<232>();
    const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const bool emit = p.xhat != nullptr;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    if constexpr (REGA) {
      // stage kb's A fragments: x (and sc) -> x^ in float32 -> bf16, the
      // columns k >= K zeroed; x^ of stage kb written out by column tile
      // kb mod (column tiles), so the writes spread over the tiles
      auto build = [&](int kb, unsigned char* st, uint32_t (&fa)[4][4]) {
        ring.wait_full(kb);
        const uint32_t xa = smem_u32(st + wg * kSlab);
        const float* cf = reinterpret_cast<const float*>(st + P::kCoef);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          frag_a_kmajor(fa[ks], xa, w, ks, lane);
          if (p.a) {
            uint32_t fs[4];
            if (entry) frag_a_kmajor(fs, xa + kA, w, ks, lane);
#pragma unroll
            for (int q = 0; q < 4; ++q) {             // q >> 1: k + 8
              const int kl = 16 * ks + 2 * t + 8 * (q >> 1);
              const float2 ca = *reinterpret_cast<const float2*>(cf + kl);
              const float2 cb =
                  *reinterpret_cast<const float2*>(cf + 64 + kl);
              float v0 = affine(lo_f(fa[ks][q]), ca.x, cb.x);
              float v1 = affine(hi_f(fa[ks][q]), ca.y, cb.y);
              if (entry) {
                const float2 cs =
                    *reinterpret_cast<const float2*>(cf + 128 + kl);
                const float2 cd =
                    *reinterpret_cast<const float2*>(cf + 192 + kl);
                v0 = __fadd_rn(__fadd_rn(v0, __fmul_rn(lo_f(fs[q]), cs.x)),
                               cd.x);
                v1 = __fadd_rn(__fadd_rn(v1, __fmul_rn(hi_f(fs[q]), cs.y)),
                               cd.y);
              }
              fa[ks][q] = pack_bf16(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
            }
          }
        }
        const int k0 = kb * kBK;
        if (k0 + kBK > p.K) {                          // the tail stage
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (k0 + 16 * ks + 2 * t + 8 * (q >> 1) >= p.K) fa[ks][q] = 0u;
        }
        if (emit && kb % gridDim.x == blockIdx.x) {
          // x^ over the raw x slab it came from (same swizzled layout),
          // then one TMA store of the warpgroup's 64 x 64 box (rows >= M
          // and columns >= K are not written); release() waits for it
          // to have read the slab before the stage is refilled
          unsigned char* slab = st + wg * kSlab;
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              *reinterpret_cast<uint32_t*>(
                  slab + swz(16 * w + g + 8 * (q & 1), 2 * ks + (q >> 1)) +
                  4 * t) = fa[ks][q];
          fence_async_smem();
          named_sync(2 + wg, 128);
          if ((threadIdx.x & 127) == 0)
            tma_store_2d(&txh, slab, k0, m0 + 64 * wg);
        }
      };
      mainloop_rs<BN, BMN, P::kStage, S, kBOfs>(acc, nk, smem, ring, lane,
                                                build);
    } else {                                  // plain x from the stage
      mainloop_ss<BN, false, BMN, P::kStage, S, kBOfs>(acc, nk, smem, ring,
                                                       lane, wg * kSlab);
    }
    store_tile<BN>(acc, smem, p.bias, p.y, p.stats, m0, n0, p.M, p.N);
  }
}

// ------------------------------------------------------------ dual dgrad
struct DgradArgs {
  const float* gc_a; const float* gc_b;  // (3, N) float32 each
  bf16* dx;
  int M, C, Na, Nb;
};

// dx (M x C) = G_a W_a^T + G_b W_b^T over 128 x BN tiles of dx. The
// reduction runs over set a's stages, then set b's; set a's tail is padded
// to the stage (its columns n >= N_a are masked to 0), so every stage
// reads one set. The blocks also write the bf16 G they form (tg_a, tg_b:
// (M, N_a) and (M, N_b)), each stage once, for the wgrad launch that
// follows. BMN: the weights' output index (c) is the contiguous one, as in
// the gluon (O, 1, 1, I) layout.
template <int BN, bool BMN>
__global__ void __launch_bounds__(kThreads, 1)
cf90_dual_dgrad_kernel(const __grid_constant__ CUtensorMap tdzn_a,
                       const __grid_constant__ CUtensorMap tyout_a,
                       const __grid_constant__ CUtensorMap tw_a,
                       const __grid_constant__ CUtensorMap tg_a,
                       const __grid_constant__ CUtensorMap tdzn_b,
                       const __grid_constant__ CUtensorMap tyout_b,
                       const __grid_constant__ CUtensorMap tw_b,
                       const __grid_constant__ CUtensorMap tg_b,
                       const DgradArgs p) {
  using P = Plan<BN, 2>;
  constexpr int S = P::kStages;
  extern __shared__ unsigned char dyn[];
  unsigned char* smem = align1024(dyn);
  __shared__ __align__(8) uint64_t full[S], empty[S];
  const int sa = (p.Na + kBK - 1) / kBK;
  const int nk = sa + (p.Nb + kBK - 1) / kBK;
  const int m0 = blockIdx.y * kBM, c0 = blockIdx.x * BN;  // as the forward
  Ring<S> ring{full, empty};
  ring.init();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    reg_dealloc<40>();
    if (threadIdx.x == kConsumers) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % S;
        const bool set_a = kb < sa;
        const int r0 = (set_a ? kb : kb - sa) * kBK;
        const int nset = set_a ? p.Na : p.Nb;
        const float* gc = set_a ? p.gc_a : p.gc_b;
        // the stage's slices of g0, g1, g2: 64 floats or the set's tail
        const uint32_t cb = 4 * min(kBK, nset - r0);
        ring.wait_slot(kb);
        unsigned char* st = smem + s * P::kStage;
        mbar_expect_tx(&full[s], 2 * kA + P::kB + 3 * cb);
        tma_load_2d(st, set_a ? &tdzn_a : &tdzn_b, &full[s], r0, m0);
        tma_load_2d(st + kA, set_a ? &tyout_a : &tyout_b, &full[s], r0, m0);
        load_b<BN, BMN>(st + 2 * kA, set_a ? &tw_a : &tw_b, &full[s], r0,
                        c0);
#pragma unroll
        for (int i = 0; i < 3; ++i)
          bulk_load(st + P::kCoef + 256 * i, gc + i * nset + r0, cb,
                    &full[s]);
      }
    }
  } else {
    reg_alloc<232>();
    const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    // stage kb's A fragments: G = (dzn g0 - g1) - yout g2 -> bf16, the
    // set's columns n >= N_set zeroed; column tile kb mod (column tiles)
    // writes stage kb's G out over the dzn slab and stores it with TMA
    // (columns >= N_set and rows >= M are not written), as the forward
    // writes x^
    auto build = [&](int kb, unsigned char* st, uint32_t (&fa)[4][4]) {
      ring.wait_full(kb);
      const bool set_a = kb < sa;
      const int r0 = (set_a ? kb : kb - sa) * kBK;
      const int nl = (set_a ? p.Na : p.Nb) - r0;
      unsigned char* slab = st + wg * kSlab;
      const uint32_t da = smem_u32(slab);
      const float* cf = reinterpret_cast<const float*>(st + P::kCoef);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t fy[4];
        frag_a_kmajor(fa[ks], da, w, ks, lane);
        frag_a_kmajor(fy, da + kA, w, ks, lane);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int kl = 16 * ks + 2 * t + 8 * (q >> 1);
          const float2 g0 = *reinterpret_cast<const float2*>(cf + kl);
          const float2 g1 = *reinterpret_cast<const float2*>(cf + 64 + kl);
          const float2 g2 = *reinterpret_cast<const float2*>(cf + 128 + kl);
          fa[ks][q] = kl < nl
              ? pack_bf16(bn_g(lo_f(fa[ks][q]), lo_f(fy[q]), g0.x, g1.x,
                               g2.x),
                          bn_g(hi_f(fa[ks][q]), hi_f(fy[q]), g0.y, g1.y,
                               g2.y))
              : 0u;
        }
      }
      if (kb % gridDim.x == blockIdx.x) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            *reinterpret_cast<uint32_t*>(
                slab + swz(16 * w + g + 8 * (q & 1), 2 * ks + (q >> 1)) +
                4 * t) = fa[ks][q];
        fence_async_smem();
        named_sync(2 + wg, 128);
        if ((threadIdx.x & 127) == 0)
          tma_store_2d(set_a ? &tg_a : &tg_b, slab, r0, m0 + 64 * wg);
      }
    };
    mainloop_rs<BN, BMN, P::kStage, S, 2 * kA>(acc, nk, smem, ring, lane,
                                               build);
    store_tile<BN>(acc, smem, nullptr, p.dx, nullptr, m0, c0, p.M, p.C);
  }
}

// ---------------------------------------------------------- 1x1 backward
struct BwdArgs {
  const float* gc;                       // (3, N) float32; null: G is g
  const float* a; const float* b;        // a null: x^ = x
  int n_partners, mask;                  // mask: 0 none, 1 on x, 2 on z
  bool need_x, p0x, dsc, xhat;           // p0x: x is partner 0
  float* part;
  int M, K, N;
  int H, W;                              // the 3x3's images (TAPS 9)
};

// The epilogue's chunk of 64 columns fills one ring stage: 128-row slabs
// of x (0), dsc (1), partner 0 (2; x^ when x is partner 0) and partner 1
// (3), then a and b. dz is written over slab 1, x^ over slab 0 (or 2).
constexpr int kBwdStage = 4 * kA + 1024;

// The tile of the backward dgrads, cf90_bwd_dgrad_kernel (TAPS 1) and
// cf90_conv3_dgrad_kernel (TAPS 9), with the kernel's plan P.
//
// TAPS 1: dz (M x K) = mask(G W^T (+ dsc)) over 128 x BN tiles of dz, with
// the partials sum dz, sum dz p_j and x^ = relu(a x + b): the single-set
// form of the dual dgrad above, G either formed on load from (dzn, yout,
// gc) and written once as bf16 for the wgrad (tg), or read as it is (g);
// the reduction runs over G's N columns. B is the gluon weight's view
// (K, N) with K contiguous, so MN-major: the one layout built.
//
// TAPS 9: the 3x3 stride-1 pad-1 transpose, dx^ = sum over the taps (r, s)
// of shift(G) W[r, s]^T, the reduction over (tap, 64-column slice of G)
// stages. Tap (r, s) reads G's rows m + (1 - r) W + (1 - s) (the forward's
// shift mirrored): one box of the dzn and yout maps each, transformed on
// load, then every row whose tapped pixel lies outside its own image
// zeroed (the transform of a zero row is -g1, not 0, and a flat shift also
// crosses image rows, so the [0, M) bounds of the box are not enough). B
// is W[r, s]^T from the gluon (O, 3, 3, I) weight, one MN-major (N, 9 C)
// map, at column tap C + c0 (a tile that runs past C reads the next tap's
// columns there, which are never stored). The centre tap reads G unshifted
// and writes it out for the wgrad. The epilogue is the 1x1's with dsc
// none, the mask on z = a x + b, x its own partner and x^ written.
//
// The epilogue's operands (x, dsc, the partners, a, b) come in by TMA in
// 64-column chunks through the same ring, the first ones under the last
// stages' products (the entry form reads four times the bytes of its
// products' operands there); each chunk is finished from the accumulators
// in registers, stored by TMA (dz, x^) and summed down its columns from
// shared memory in a fixed order, one row of partials per 128-row block.
template <int BN, int TAPS, typename P>
__device__ __forceinline__ void
bwd_dgrad_tile(const CUtensorMap& tdzn, const CUtensorMap& tyout,
               const CUtensorMap& tw, const CUtensorMap& tg,
               const CUtensorMap& tx, const CUtensorMap& tdsc,
               const CUtensorMap& tp0, const CUtensorMap& tp1,
               const CUtensorMap& tdz, const CUtensorMap& txh,
               const BwdArgs& p) {
  constexpr int S = P::kStages;
  constexpr int kCf = 4 * kA;                        // a, b of a chunk
  extern __shared__ unsigned char dyn[];
  unsigned char* smem = align1024(dyn);
  __shared__ __align__(8) uint64_t full[S], empty[S];
  __shared__ float red[2][8][3][64];                 // chunk parity
  const int ns = (p.N + kBK - 1) / kBK, nk = TAPS * ns;
  const int m0 = blockIdx.y * kBM, c0 = blockIdx.x * BN;
  const int nch = min(BN, p.K - c0 + 63) / 64;       // chunks inside K
  const bool direct = p.gc == nullptr;
  const int xh_slab = (p.p0x ? 2 : 0) * kA, p0_slab = (p.p0x ? 0 : 2) * kA;
  Ring<S> ring{full, empty};
  ring.init();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    reg_dealloc<40>();
    if (threadIdx.x == kConsumers) {
      tma_prefetch(&tdzn);
      tma_prefetch(&tw);
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % S, tap = kb / ns, r0 = (kb - tap * ns) * kBK;
        const int shift = TAPS == 1 ? 0 : (1 - tap / 3) * p.W + 1 - tap % 3;
        const uint32_t cb = direct ? 0 : 4 * min(kBK, p.N - r0);
        ring.wait_slot(kb);
        unsigned char* st = smem + s * P::kStage;
        mbar_expect_tx(&full[s], (direct ? 1 : 2) * kA + P::kB + 3 * cb);
        tma_load_2d(st, &tdzn, &full[s], r0, m0 + shift);
        if (!direct) tma_load_2d(st + kA, &tyout, &full[s], r0, m0 + shift);
        load_b<BN, true>(st + 2 * kA, &tw, &full[s], r0, tap * p.K + c0);
        if (!direct) {
#pragma unroll
          for (int i = 0; i < 3; ++i)
            bulk_load(st + P::kCoef + 256 * i, p.gc + i * p.N + r0, cb,
                      &full[s]);
        }
      }
      const bool l0 = p.n_partners > 0 && !p.p0x, l1 = p.n_partners > 1;
      const uint32_t slabs = p.need_x + p.dsc + l0 + l1;
      for (int e = 0; e < nch; ++e) {
        const int kb = nk + e, s = kb % S, col = c0 + 64 * e;
        const uint32_t cb = p.a ? 4 * min(64, p.K - col) : 0;
        ring.wait_slot(kb);
        unsigned char* st = smem + s * P::kStage;
        mbar_expect_tx(&full[s], slabs * kA + 2 * cb);
        if (p.need_x) tma_load_2d(st, &tx, &full[s], col, m0);
        if (p.dsc) tma_load_2d(st + kA, &tdsc, &full[s], col, m0);
        if (l0) tma_load_2d(st + 2 * kA, &tp0, &full[s], col, m0);
        if (l1) tma_load_2d(st + 3 * kA, &tp1, &full[s], col, m0);
        if (cb) {
          bulk_load(st + kCf, p.a + col, cb, &full[s]);
          bulk_load(st + kCf + 256, p.b + col, cb, &full[s]);
        }
      }
    }
  } else {
    reg_alloc<232>();
    const int ct = threadIdx.x, w = (ct >> 5) & 3, lane = ct & 31;
    const int g = lane >> 2, t = lane & 3;
    // TAPS 9: bit tap of inside[h] is set when this thread's fragment row
    // h (rows g and g + 8) taps a pixel of its own image there
    uint32_t inside[2] = {1u, 1u};
    if constexpr (TAPS == 9) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 64 * wg + 16 * w + g + 8 * h;
        const int hh = (m / p.W) % p.H, ww = m % p.W;
        inside[h] = 0;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int ih = hh + 1 - tap / 3, iw = ww + 1 - tap % 3;
          if (ih >= 0 && ih < p.H && iw >= 0 && iw < p.W)
            inside[h] |= 1u << tap;
        }
      }
    }
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    // stage kb's A fragments: g as it is, or G = (dzn g0 - g1) - yout g2
    // -> bf16 with the columns n >= N (and, TAPS 9, the rows outside their
    // image) zeroed; the unshifted G written out by column tile (slice mod
    // column tiles), as the dual dgrad does
    auto build = [&](int kb, unsigned char* st, uint32_t (&fa)[4][4]) {
      ring.wait_full(kb);
      const int tap = kb / ns, sl = kb - tap * ns;
      const int r0 = sl * kBK, nl = p.N - r0;
      unsigned char* slab = st + wg * kSlab;
      const uint32_t da = smem_u32(slab);
      if (direct) {                           // TMA read n >= N as 0
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) frag_a_kmajor(fa[ks], da, w, ks, lane);
        return;
      }
      const bool in0 = (inside[0] >> tap) & 1, in1 = (inside[1] >> tap) & 1;
      const float* cf = reinterpret_cast<const float*>(st + P::kCoef);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t fy[4];
        frag_a_kmajor(fa[ks], da, w, ks, lane);
        frag_a_kmajor(fy, da + kA, w, ks, lane);
#pragma unroll
        for (int q = 0; q < 4; ++q) {                 // q & 1: row + 8
          const int kl = 16 * ks + 2 * t + 8 * (q >> 1);
          const float2 g0 = *reinterpret_cast<const float2*>(cf + kl);
          const float2 g1 = *reinterpret_cast<const float2*>(cf + 64 + kl);
          const float2 g2 = *reinterpret_cast<const float2*>(cf + 128 + kl);
          fa[ks][q] = ((q & 1) ? in1 : in0) && kl < nl
              ? pack_bf16(bn_g(lo_f(fa[ks][q]), lo_f(fy[q]), g0.x, g1.x,
                               g2.x),
                          bn_g(hi_f(fa[ks][q]), hi_f(fy[q]), g0.y, g1.y,
                               g2.y))
              : 0u;
        }
      }
      if (tap == TAPS / 2 && sl % gridDim.x == blockIdx.x) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            *reinterpret_cast<uint32_t*>(
                slab + swz(16 * w + g + 8 * (q & 1), 2 * ks + (q >> 1)) +
                4 * t) = fa[ks][q];
        fence_async_smem();
        named_sync(2 + wg, 128);
        if ((threadIdx.x & 127) == 0)
          tma_store_2d(&tg, slab, r0, m0 + 64 * wg);
      }
    };
    mainloop_rs<BN, true, P::kStage, S, 2 * kA>(acc, nk, smem, ring, lane,
                                               build);
    // the epilogue, chunk by chunk: dz (and x^) from the fragments over
    // the chunk's slabs, TMA stores, then the column sums, a column pair
    // and 16 rows a thread, and the 8 row ranges in order. The loop is not
    // unrolled (four unrolled chunks of a 256-wide tile overflow the
    // instruction cache): chunk e's accumulators are moved down to
    // acc[0, 32) for it
    const int rows = min(kBM, p.M - m0);
    const int nq = 1 + p.n_partners;
    const int pc = 2 * (ct & 31), pr = ct >> 5;
#pragma unroll 1
    for (int e = 0; e < nch; ++e) {
      const int kb = nk + e, col = c0 + 64 * e;
      ring.wait_full(kb);
      unsigned char* st = smem + (kb % S) * P::kStage;
      const float* cf = reinterpret_cast<const float*>(st + kCf);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 ca = p.a ? *reinterpret_cast<const float2*>(cf + c)
                              : make_float2(0.f, 0.f);
        const float2 cb = p.a ? *reinterpret_cast<const float2*>(cf + 64 + c)
                              : make_float2(0.f, 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t off = swz(64 * wg + 16 * w + g + 8 * h, j) + 4 * t;
          float v0 = acc[4 * j + 2 * h];
          float v1 = acc[4 * j + 2 * h + 1];
          if (p.dsc) {
            const uint32_t d = *reinterpret_cast<const uint32_t*>(st + kA +
                                                                  off);
            v0 = __fadd_rn(v0, lo_f(d));
            v1 = __fadd_rn(v1, hi_f(d));
          }
          if (p.need_x) {
            const uint32_t xr = *reinterpret_cast<const uint32_t*>(st + off);
            const float x0 = lo_f(xr), x1 = hi_f(xr);
            const float z0 = affine(x0, ca.x, cb.x);
            const float z1 = affine(x1, ca.y, cb.y);
            if ((p.mask == 1 && !(x0 > 0.f)) || (p.mask == 2 && !(z0 > 0.f)))
              v0 = 0.f;
            if ((p.mask == 1 && !(x1 > 0.f)) || (p.mask == 2 && !(z1 > 0.f)))
              v1 = 0.f;
            if (p.xhat)
              *reinterpret_cast<uint32_t*>(st + xh_slab + off) =
                  pack_bf16(fmaxf(z0, 0.f), fmaxf(z1, 0.f));
          }
          *reinterpret_cast<uint32_t*>(st + kA + off) = pack_bf16(v0, v1);
        }
      }
      fence_async_smem();
      named_sync(1, kConsumers);
      if (ct == 0) {
        tma_store_2d(&tdz, st + kA, col, m0);
        if (p.xhat) tma_store_2d(&txh, st + xh_slab, col, m0);
      }
      float s[3][2] = {};
      for (int r = 16 * pr; r < min(rows, 16 * pr + 16); ++r) {
        const uint32_t off = swz(r, pc >> 3) + (pc & 7) * 2;
        const uint32_t dv = *reinterpret_cast<const uint32_t*>(st + kA + off);
        const float d0 = lo_f(dv), d1 = hi_f(dv);
        s[0][0] += d0;
        s[0][1] += d1;
        if (p.n_partners > 0) {
          const uint32_t q0 =
              *reinterpret_cast<const uint32_t*>(st + p0_slab + off);
          s[1][0] = fmaf(d0, lo_f(q0), s[1][0]);
          s[1][1] = fmaf(d1, hi_f(q0), s[1][1]);
        }
        if (p.n_partners > 1) {
          const uint32_t q1 =
              *reinterpret_cast<const uint32_t*>(st + 3 * kA + off);
          s[2][0] = fmaf(d0, lo_f(q1), s[2][0]);
          s[2][1] = fmaf(d1, hi_f(q1), s[2][1]);
        }
      }
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        red[e & 1][pr][q][pc] = s[q][0];
        red[e & 1][pr][q][pc + 1] = s[q][1];
      }
      named_sync(1, kConsumers);
      if (ct < 64 && col + ct < p.K) {
        for (int q = 0; q < nq; ++q) {
          float v = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) v += red[e & 1][i][q][ct];
          p.part[(static_cast<size_t>(blockIdx.y) * nq + q) * p.K + col +
                 ct] = v;
        }
      }
      ring.release(kb, lane);
#pragma unroll
      for (int i = 0; i < BN / 2 - 32; ++i) acc[i] = acc[i + 32];
    }
  }
}

// mm_fused_bwd's dgrad: bwd_dgrad_tile's TAPS 1 form over the 1x1's maps
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
cf90_bwd_dgrad_kernel(const __grid_constant__ CUtensorMap tdzn,
                      const __grid_constant__ CUtensorMap tyout,
                      const __grid_constant__ CUtensorMap tw,
                      const __grid_constant__ CUtensorMap tg,
                      const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tdsc,
                      const __grid_constant__ CUtensorMap tp0,
                      const __grid_constant__ CUtensorMap tp1,
                      const __grid_constant__ CUtensorMap tdz,
                      const __grid_constant__ CUtensorMap txh,
                      const BwdArgs p) {
  using P = Plan<BN, 2, kBwdStage>;
  bwd_dgrad_tile<BN, 1, P>(tdzn, tyout, tw, tg, tx, tdsc, tp0, tp1, tdz, txh,
                           p);
}

// conv3_fused_bwd's dgrad: the TAPS 9 form. dz (M x C) = mask_z(sum over
// the taps of shift(G) W[tap]^T), the partials sum dz and sum dz x, x^ and
// the unshifted G for cf90_conv3_wgrad_kernel. x is the epilogue's only
// operand (its own partner), so the dsc and partner maps are never read.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
cf90_conv3_dgrad_kernel(const __grid_constant__ CUtensorMap tdzn,
                        const __grid_constant__ CUtensorMap tyout,
                        const __grid_constant__ CUtensorMap tw,
                        const __grid_constant__ CUtensorMap tg,
                        const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tdz,
                        const __grid_constant__ CUtensorMap txh,
                        const BwdArgs p) {
  using P = Plan<BN, 2, kBwdStage>;
  bwd_dgrad_tile<BN, 9, P>(tdzn, tyout, tw, tg, tx, tx, tx, tx, tdz, txh, p);
}

// ------------------------------------------------------------ dual wgrad
struct WgradArgs {
  float* ws;                             // (splits, Na + Nb, C) float32
  int chunk, M, C, Na, Nb;
};

// ws[split, n, c] = sum over this split's rows m of G[m, n] x[m, c], a
// plain product of the dgrad's G and x: the output rows are the G columns
// (set a's row tiles, then set b's, so no tile straddles the two), the
// columns are x's, the reduction runs over the split's rows (whole stages;
// rows >= M and columns >= N_set read 0). A = G^T and B = x, both
// MN-major, straight from the stage. With N_b = 0 it is the single-set
// wgrad of mm_fused_bwd, dW = x^T G, x being x^ there.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
cf90_dual_wgrad_kernel(const __grid_constant__ CUtensorMap tx,
                       const __grid_constant__ CUtensorMap tg_a,
                       const __grid_constant__ CUtensorMap tg_b,
                       const WgradArgs p) {
  using P = Plan<BN, 1>;
  constexpr int S = P::kStages;
  extern __shared__ unsigned char dyn[];
  unsigned char* smem = align1024(dyn);
  __shared__ __align__(8) uint64_t full[S], empty[S];
  const int ta = (p.Na + kBM - 1) / kBM;
  const bool set_a = static_cast<int>(blockIdx.x) < ta;
  const int nset = set_a ? p.Na : p.Nb;
  const int n0 = (set_a ? blockIdx.x : blockIdx.x - ta) * kBM;
  const int c0 = blockIdx.y * BN;
  const int mb = blockIdx.z * p.chunk;
  const int nk = (min(p.M, mb + p.chunk) - mb + kBK - 1) / kBK;
  Ring<S> ring{full, empty};
  ring.init();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    reg_dealloc<40>();
    if (threadIdx.x == kConsumers) {
      const CUtensorMap* tg = set_a ? &tg_a : &tg_b;
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % S;
        const int r0 = mb + kb * kBK;
        ring.wait_slot(kb);
        unsigned char* st = smem + s * P::kStage;
        mbar_expect_tx(&full[s], kA + P::kB);
        tma_load_2d(st, tg, &full[s], n0, r0);
        tma_load_2d(st + kSlab, tg, &full[s], n0 + 64, r0);
        load_b<BN, true>(st + kA, &tx, &full[s], r0, c0);
      }
    }
  } else {
    reg_alloc<232>();
    const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    mainloop_ss<BN, true, true, P::kStage, S, kA>(acc, nk, smem, ring, lane,
                                                  wg * kSlab);
    // float32 partials straight from the fragments: rows n < N_set of the
    // set's block of ws, columns c < C
    float* ws = p.ws + static_cast<size_t>(blockIdx.z) * (p.Na + p.Nb) * p.C;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 64 * wg + 16 * w + g + 8 * h;
      if (n >= nset) continue;
      float* row = ws + static_cast<size_t>((set_a ? 0 : p.Na) + n) * p.C;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = c0 + 8 * j + 2 * t;
        if (c < p.C)
          *reinterpret_cast<float2*>(row + c) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// ------------------------------------------------------------ 3x3 wgrad
struct Conv3WgradArgs {
  float* ws;                             // (splits, N, 9 C) float32
  int chunk, M, C, N, H, W;
};

// ws[split, n, tap C + c] = sum over this split's rows m of G[m, n]
// x^[m + (r - 1) W + (s - 1), c], over the rows m whose tapped pixel (the
// forward's tap (r, s)) lies in m's own image: the dual wgrad's plain
// product of the dgrad's G and x^, one tap per output column tile (tile
// (n0, tap, c0); columns c >= C are not stored). x^'s box is shifted by
// the tap (rows outside [0, M) read 0); the halo mask falls on A = G^T
// along the reduction: each consumer warpgroup zeroes, in its own slab of
// the stage, the 128-byte rows m whose tapped pixel leaves the image,
// while the previous stage's products run, then hands the slab to wgmma.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
cf90_conv3_wgrad_kernel(const __grid_constant__ CUtensorMap txh,
                        const __grid_constant__ CUtensorMap tg,
                        const Conv3WgradArgs p) {
  using P = Plan<BN, 1>;
  constexpr int S = P::kStages;
  extern __shared__ unsigned char dyn[];
  unsigned char* smem = align1024(dyn);
  __shared__ __align__(8) uint64_t full[S], empty[S];
  const int ctiles = (p.C + BN - 1) / BN;
  const int tap = blockIdx.y / ctiles;
  const int n0 = blockIdx.x * kBM, c0 = (blockIdx.y - tap * ctiles) * BN;
  const int dr = tap / 3 - 1, ds = tap % 3 - 1;
  const int mb = blockIdx.z * p.chunk;
  const int nk = (min(p.M, mb + p.chunk) - mb + kBK - 1) / kBK;
  Ring<S> ring{full, empty};
  ring.init();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    reg_dealloc<40>();
    if (threadIdx.x == kConsumers) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % S, r0 = mb + kb * kBK;
        ring.wait_slot(kb);
        unsigned char* st = smem + s * P::kStage;
        mbar_expect_tx(&full[s], kA + P::kB);
        tma_load_2d(st, &tg, &full[s], n0, r0);
        tma_load_2d(st + kSlab, &tg, &full[s], n0 + 64, r0);
        load_b<BN, true>(st + kA, &txh, &full[s], r0 + dr * p.W + ds, c0);
      }
    }
  } else {
    reg_alloc<232>();
    const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int half = threadIdx.x & 1, row = (threadIdx.x & 127) >> 1;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kb = 0; kb < nk; ++kb) {
      ring.wait_full(kb);
      unsigned char* slab = smem + (kb % S) * P::kStage + wg * kSlab;
      // two threads a row: zero this warpgroup's half-row if the row's
      // tapped pixel is outside its image (rows >= M read 0 already)
      const int m = mb + kb * kBK + row;
      const int ih = (m / p.W) % p.H + dr, iw = m % p.W + ds;
      if (m < p.M && (ih < 0 || ih >= p.H || iw < 0 || iw >= p.W)) {
        uint4* z = reinterpret_cast<uint4*>(slab + row * 128 + half * 64);
#pragma unroll
        for (int i = 0; i < 4; ++i) z[i] = make_uint4(0u, 0u, 0u, 0u);
      }
      fence_async_smem();
      named_sync(2 + wg, 128);
      issue_ss<BN, true, true>(acc, slab, smem + (kb % S) * P::kStage + kA);
      wgmma_wait<1>();
      fence_regs(acc);
      if (kb > 0) ring.release(kb - 1, lane);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (nk > 0) ring.release(nk - 1, lane);
    // float32 partials straight from the fragments: rows n < N of the
    // split's block of ws, this tap's columns c < C
    float* ws = p.ws + static_cast<size_t>(blockIdx.z) * p.N * 9 * p.C;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 64 * wg + 16 * w + g + 8 * h;
      if (n >= p.N) continue;
      float* out = ws + static_cast<size_t>(n) * 9 * p.C + tap * p.C;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = c0 + 8 * j + 2 * t;
        if (c < p.C)
          *reinterpret_cast<float2*>(out + c) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// ------------------------------------------------------------ 3x3 forward
struct Conv3Args {
  const float* a; const float* b;
  bf16* y; float* stats;
  int M, C, N, H, W;
};

// y (M x N) = conv3x3_s1_p1(relu(a x + b)) over flat NHWC rows, 128 x BN
// tiles of y, the reduction over (tap, 64-channel slice) stages: index
// tap C + c, as the gluon weight (O, 3, 3, I) lays it out. Tap (r, s)'s A
// box is the tile's 128 rows shifted by (r - 1) W + (s - 1) flat rows, a
// plain box of the (C, M) map (rows outside [0, M) read 0); the consumer
// transforms it, then zeroes each row whose tapped pixel lies outside its
// own image (the padding belongs to x^: relu(a 0 + b) need not be 0) and
// the channels c >= C. B is one 2-D K-major map over the (9 C, N) weight
// (the gluon view: the reduction index contiguous, the one layout built);
// a slice that runs past C reads the next tap's rows there, against A's
// zeroed columns. The epilogue is the forward's: rounded y and its stats.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
cf90_conv3_kernel(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tw,
                  const Conv3Args p) {
  using P = Plan<BN, 1>;
  constexpr int S = P::kStages;
  extern __shared__ unsigned char dyn[];
  unsigned char* smem = align1024(dyn);
  __shared__ __align__(8) uint64_t full[S], empty[S];
  const int nc = (p.C + kBK - 1) / kBK, nk = 9 * nc;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  Ring<S> ring{full, empty};
  ring.init();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    reg_dealloc<40>();
    if (threadIdx.x == kConsumers) {
      tma_prefetch(&tx);
      tma_prefetch(&tw);
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % S, tap = kb / nc, c0 = (kb - tap * nc) * kBK;
        const uint32_t cb = 4 * min(kBK, p.C - c0);
        ring.wait_slot(kb);
        unsigned char* st = smem + s * P::kStage;
        mbar_expect_tx(&full[s], kA + P::kB + 2 * cb);
        tma_load_2d(st, &tx, &full[s], c0,
                    m0 + (tap / 3 - 1) * p.W + (tap % 3 - 1));
        load_b<BN, false>(st + kA, &tw, &full[s], tap * p.C + c0, n0);
        bulk_load(st + P::kCoef, p.a + c0, cb, &full[s]);
        bulk_load(st + P::kCoef + 256, p.b + c0, cb, &full[s]);
      }
    }
  } else {
    reg_alloc<232>();
    const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int t = lane & 3;
    // bit tap of inside[h]: this thread's row h (fragment rows g and
    // g + 8) taps a pixel of its own image there
    uint32_t inside[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 64 * wg + 16 * w + (lane >> 2) + 8 * h;
      const int hh = (m / p.W) % p.H, ww = m % p.W;
      inside[h] = 0;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ih = hh + tap / 3 - 1, iw = ww + tap % 3 - 1;
        if (ih >= 0 && ih < p.H && iw >= 0 && iw < p.W)
          inside[h] |= 1u << tap;
      }
    }
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    auto build = [&](int kb, unsigned char* st, uint32_t (&fa)[4][4]) {
      ring.wait_full(kb);
      const int tap = kb / nc;
      const int cl = p.C - (kb - tap * nc) * kBK;   // channels left
      const bool in0 = (inside[0] >> tap) & 1, in1 = (inside[1] >> tap) & 1;
      const uint32_t xa = smem_u32(st + wg * kSlab);
      const float* cf = reinterpret_cast<const float*>(st + P::kCoef);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        frag_a_kmajor(fa[ks], xa, w, ks, lane);
#pragma unroll
        for (int q = 0; q < 4; ++q) {                 // q & 1: row + 8
          const int kl = 16 * ks + 2 * t + 8 * (q >> 1);
          const float2 ca = *reinterpret_cast<const float2*>(cf + kl);
          const float2 cb = *reinterpret_cast<const float2*>(cf + 64 + kl);
          const float v0 = fmaxf(affine(lo_f(fa[ks][q]), ca.x, cb.x), 0.f);
          const float v1 = fmaxf(affine(hi_f(fa[ks][q]), ca.y, cb.y), 0.f);
          fa[ks][q] = ((q & 1) ? in1 : in0) && kl < cl ? pack_bf16(v0, v1)
                                                      : 0u;
        }
      }
    };
    mainloop_rs<BN, false, P::kStage, S, kA>(acc, nk, smem, ring, lane, build);
    store_tile<BN>(acc, smem, nullptr, p.y, p.stats, m0, n0, p.M, p.N);
  }
}

// ------------------------------------------ the float32 route (three pieces)
// The five forms in float32 on the same machinery: every float32 operand
// of a product is split exactly into three bf16 pieces,
// hi + mid + lo == v (each residual exact in float32, lo holding what is
// left), and each 32-deep stage runs the six piece products float32 needs
// on wgmma, smallest first (lo.hi, hi.lo, mid.mid, mid.hi, hi.mid, hi.hi;
// the three dropped ones are of order 2^-24 relative), into a fresh
// float32 partial that is then added to the running float32 accumulator
// (the tensor cores' own sums then only span one stage). The stage is 32
// deep because a 128-byte swizzled row holds 32 floats: the raw float32 A
// operand (x and sc for the forwards, dzn and yout (or g) for the dgrads)
// comes in as one TMA box {32, 128} a map, the consumers transform it in
// float32 with
// the reference's roundings (affine, bn_g), mask the halo and the
// reduction tail after the transform, split it in registers and hand the
// three fragments to wgmma; B is three bf16 piece planes that
// cf90_split3_kernel makes once a call, stored MN-major (the output index
// contiguous), 64-wide boxes of 32 reduction rows, 4 KB apart. A block
// tile is 128 x 128 (the running accumulator and the partial take 128
// registers a thread). The 1x1 forward writes x^ back by TMA where it is
// asked for; the dgrads write G's pieces back (the backwards' also x^'s),
// and the wgrads, the dual one with one set or two and the 3x3's, are then
// six plain piece products from shared memory against x's (or x^'s)
// pieces, the 3x3's with x^'s box shifted by the tap and the halo rows
// zeroed in G's pieces.
constexpr int kBK3 = 32;                  // reduction depth of a stage
constexpr int kBN3 = 128;                 // output columns of a block tile
constexpr int kBlk3 = kBK3 * 128;         // 64 MN values x 32 rows, bf16
constexpr int kWgRaw3 = 64 * 128;         // a warpgroup's rows of a raw box
constexpr int kRaw3 = kBM * 128;          // one raw float32 A operand
constexpr int kPieceA3 = kBM * kBK3 * 2;  // one A piece (the wgrad's G^T)
constexpr int kPieceB3 = kBN3 * kBK3 * 2; // one B piece of a stage
constexpr int kB3 = 3 * kPieceB3;         // B's three pieces
constexpr int kMaxStages3 = 4;

// Shared-memory plan of a float32-route block (mirrored by
// conv_fused.py:sm90_x3_plan): a stage holds A_BYTES of A (raw float32
// boxes, or the wgrad's A pieces), B's three pieces and COEF bytes of
// per-channel coefficients; up to kMaxStages3 stages in the budget; the
// epilogue's float32 staging tile and its column sums reuse the ring.
template <int A_BYTES, int COEF, int MIN_STAGE = 0>
struct Plan3 {
  static constexpr int kCoef = A_BYTES + kB3;        // offset in a stage
  static constexpr int kStage = kCoef + COEF > MIN_STAGE ? kCoef + COEF
                                                         : MIN_STAGE;
  static constexpr int kStages = kStageBudget / kStage < kMaxStages3
                                     ? kStageBudget / kStage
                                     : kMaxStages3;
  static constexpr int kSmem = kStages * kStage + 1024;  // + alignment
  static_assert(kStages >= 3, "fewer than three stages");
  static_assert(kBM * kBN3 * 4 + 2 * 2 * kConsumers * 4 <= kStages * kStage,
                "the epilogue's staging does not fit the ring");
};
using PlanConv3X3 = Plan3<kRaw3, 1024>;       // x; a, b
// mm_fused: x (and sc in the entry form); a, b (asc, bsc)
template <bool ENTRY>
using PlanFwdX3 = Plan3<(ENTRY ? 2 : 1) * kRaw3, 1024>;
using PlanDgradX3 = Plan3<2 * kRaw3, 1024>;   // dzn, yout; g0, g1, g2
using PlanWgradX3 = Plan3<3 * kPieceA3, 0>;   // G^T's three pieces
// mm_fused_bwd's dgrad: dzn and yout (or g); g0, g1, g2; an epilogue chunk
// of four 128 x 32 float32 boxes and 1 KB of a and b
using PlanBwdX3 = Plan3<2 * kRaw3, 1024, 4 * kRaw3 + 1024>;
// conv3_fused_bwd's dgrad: the same stage over nine taps (dzn's and yout's
// shifted boxes, W9^T's pieces, g0, g1, g2) and the same epilogue chunk
// (x, dz, x^'s pieces over the partner boxes; a and b)
using PlanConv3DgradX3 = Plan3<2 * kRaw3, 1024, 4 * kRaw3 + 1024>;
// its wgrad: G^T's three pieces (the halo rows zeroed in place) beside
// x^'s shifted pieces
using PlanConv3WgradX3 = Plan3<3 * kPieceA3, 0>;

// the six piece products of a stage, smallest first: product pr is A's
// piece prod_a(pr) times B's piece prod_b(pr) (0 hi, 1 mid, 2 lo)
__device__ constexpr int prod_a(int pr) {
  return pr == 0 ? 2 : pr < 2 ? 0 : pr < 4 ? 1 : 0;
}
__device__ constexpr int prod_b(int pr) {
  return pr == 1 ? 2 : pr == 2 || pr == 4 ? 1 : 0;
}

// v0, v1 -> three bf16x2 words hi, mid, lo with hi + mid + lo == v exactly
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  hi = pack_bf16(v0, v1);
  const float r0 = __fsub_rn(v0, lo_f(hi)), r1 = __fsub_rn(v1, hi_f(hi));
  mid = pack_bf16(r0, r1);
  lo = pack_bf16(__fsub_rn(r0, lo_f(mid)), __fsub_rn(r1, hi_f(mid)));
}

// a descriptor of an MN-major piece at k16 step ks (64-wide blocks of the
// MN index 4 KB apart: 32 rows of 128 bytes)
__device__ __forceinline__ uint64_t desc_mn3(const unsigned char* p, int ks) {
  return desc_sw128(p + ks * 2048, kBlk3, 1024);
}

// p = the stage's six piece products, A's pieces in registers (a[ks][piece])
// and B's three MN-major pieces from the stage at b, kPieceB3 apart; the
// first product overwrites p. Issued and committed as one group.
__device__ __forceinline__ void issue6_rs(float (&p)[kBN3 / 2],
                                          const uint32_t (&a)[2][3][4],
                                          const unsigned char* b) {
  wgmma_fence();
  fence_regs(p);
#pragma unroll
  for (int pr = 0; pr < 6; ++pr)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      wgmma_rs<1>(p, a[ks][prod_a(pr)],
                  desc_mn3(b + prod_b(pr) * kPieceB3, ks), (pr | ks) != 0);
  wgmma_commit();
  fence_regs(p);
}

// the same with A's three MN-major pieces from the stage at a (this
// warpgroup's 64-row box of each piece; pieces kPieceA3 apart)
__device__ __forceinline__ void issue6_ss(float (&p)[kBN3 / 2],
                                          const unsigned char* a,
                                          const unsigned char* b) {
  wgmma_fence();
  fence_regs(p);
#pragma unroll
  for (int pr = 0; pr < 6; ++pr)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      wgmma_ss<1, 1>(p, desc_mn3(a + prod_a(pr) * kPieceA3, ks),
                     desc_mn3(b + prod_b(pr) * kPieceB3, ks), (pr | ks) != 0);
  wgmma_commit();
  fence_regs(p);
}

// A dgrad's stage of G, this thread's fragments fa (fa[ks][piece][q]), as
// three plain 64 x 32 bf16 tiles over its warpgroup's raw rows of the
// stage at st (the first box's rows hold pieces 0 and 1, the second box's
// piece 2, loaded or not), once every thread of the warpgroup has read
// them; then stored by TMA into tg (3, M, N) at (r0, m0 + 64 wg). The
// ring's release() waits for the stores to have read them before the
// stage is refilled.
__device__ __forceinline__ void store_g_pieces(unsigned char* st,
                                               const uint32_t (&fa)[2][3][4],
                                               const CUtensorMap* tg, int r0,
                                               int m0) {
  const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  unsigned char* pb[3] = {st + wg * kWgRaw3, st + wg * kWgRaw3 + kWgRaw3 / 2,
                          st + kRaw3 + wg * kWgRaw3};
  named_sync(2 + wg, 128);
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<uint32_t*>(
            pb[j] + (16 * w + g + 8 * (q & 1)) * 64 +
            (16 * ks + 2 * t + 8 * (q >> 1)) * 2) = fa[ks][j][q];
  fence_async_smem();
  named_sync(2 + wg, 128);
  if ((threadIdx.x & 127) == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) tma_store_3d(tg, pb[j], r0, m0 + 64 * wg, j);
  }
}

template <int R>
__device__ __forceinline__ void add_partial(float (&acc)[R],
                                            const float (&p)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = __fadd_rn(acc[i], p[i]);
}

// A consumer warpgroup's main loop with A's pieces in registers: build(kb,
// stage, frag) waits for stage kb and forms its fragments; stage kb's six
// products run into the partial while stage kb + 1's fragments are formed,
// then the partial is added to acc in stage order.
template <int STAGE, int S, int BOFS, typename Build>
__device__ __forceinline__ void mainloop3_rs(float (&acc)[kBN3 / 2], int nk,
                                             unsigned char* smem,
                                             Ring<S>& ring, int lane,
                                             Build build) {
  float part[kBN3 / 2];
  uint32_t f0[2][3][4], f1[2][3][4];
  if (nk > 0) build(0, smem, f0);
  for (int kb = 0; kb < nk; kb += 2) {
    issue6_rs(part, f0, smem + (kb % S) * STAGE + BOFS);
    if (kb + 1 < nk) build(kb + 1, smem + ((kb + 1) % S) * STAGE, f1);
    wgmma_wait<0>();
    fence_regs(part);
    add_partial(acc, part);
    ring.release(kb, lane);
    if (kb + 1 >= nk) break;
    issue6_rs(part, f1, smem + ((kb + 1) % S) * STAGE + BOFS);
    if (kb + 2 < nk) build(kb + 2, smem + ((kb + 2) % S) * STAGE, f0);
    wgmma_wait<0>();
    fence_regs(part);
    add_partial(acc, part);
    ring.release(kb + 1, lane);
  }
}

// The same with A's and B's pieces straight from the stage (this
// warpgroup's A at a_ofs, B at b_ofs): stage(kb) waits for stage kb, makes
// it ready for the products and returns it; its six products run into one
// of two alternating partials while the other stage's partial is added to
// acc, so the adds stay in stage order.
template <int S, typename Stage>
__device__ __forceinline__ void mainloop3_ss(float (&acc)[kBN3 / 2], int nk,
                                             int a_ofs, int b_ofs,
                                             Ring<S>& ring, int lane,
                                             Stage stage) {
  float p0[kBN3 / 2], p1[kBN3 / 2];
  for (int kb = 0; kb < nk; kb += 2) {
    const unsigned char* st = stage(kb);
    issue6_ss(p0, st + a_ofs, st + b_ofs);
    if (kb > 0) {                               // stage kb - 1's partial
      wgmma_wait<1>();
      fence_regs(p1);
      add_partial(acc, p1);
      ring.release(kb - 1, lane);
    }
    if (kb + 1 >= nk) {
      wgmma_wait<0>();
      fence_regs(p0);
      add_partial(acc, p0);
      ring.release(kb, lane);
      break;
    }
    st = stage(kb + 1);
    issue6_ss(p1, st + a_ofs, st + b_ofs);
    wgmma_wait<1>();
    fence_regs(p0);
    add_partial(acc, p0);
    ring.release(kb, lane);
  }
  if (nk > 0 && nk % 2 == 0) {
    wgmma_wait<0>();
    fence_regs(p1);
    add_partial(acc, p1);
    ring.release(nk - 1, lane);
  }
}

// The epilogue of the float32 route: both consumer warpgroups'
// accumulators, plus the bias in float32 where one is passed, into a
// swizzled float32 staging tile of four blocks of 128 rows x 128 bytes
// over the ring's memory; then 16-byte stores of rows m < M, columns
// n < N. With stats, one row pair of column sums (sum y, sum y^2 over the
// stored values of the valid rows) per block, in a fixed order.
__device__ __forceinline__ void store_tile_f32(const float (&acc)[kBN3 / 2],
                                               unsigned char* smem,
                                               const float* bias,
                                               float* out, float* stats,
                                               int m0, int n0, int M,
                                               int N) {
  constexpr int BN = kBN3;
  const int ct = threadIdx.x, wg = ct >> 7, w = (ct >> 5) & 3;
  const int lane = ct & 31, g = lane >> 2, t = lane & 3;
  named_sync(1, kConsumers);                // every stage is consumed
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * t;
    float b0 = 0.f, b1 = 0.f;
    if (bias && n0 + c < N) {
      b0 = bias[n0 + c];
      b1 = bias[n0 + c + 1];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * wg + 16 * w + g + 8 * h;
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (bias) {
        v0 = __fadd_rn(v0, b0);
        v1 = __fadd_rn(v1, b1);
      }
      *reinterpret_cast<float2*>(smem + (c >> 5) * (kBM * 128) +
                                 swz(r, (c & 31) >> 2) + (c & 3) * 4) =
          make_float2(v0, v1);
    }
  }
  named_sync(1, kConsumers);
  const int rows = min(kBM, M - m0);
  if (stats) {
    // a column pair and 32 rows per thread, then the four ranges in order
    constexpr int kParts = 2 * kConsumers / BN;
    constexpr int kRows = kBM / kParts;
    float* red = reinterpret_cast<float*>(smem + kBM * BN * 4);
    const int col = 2 * (ct % (BN / 2)), part = ct / (BN / 2);
    const unsigned char* blk = smem + (col >> 5) * (kBM * 128);
    const int chunk = (col & 31) >> 2, within = (col & 3) * 4;
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
    const int r1 = min(rows, (part + 1) * kRows);
#pragma unroll 4
    for (int r = part * kRows; r < r1; ++r) {
      const float2 v = *reinterpret_cast<const float2*>(blk + swz(r, chunk) +
                                                        within);
      s1[0] += v.x;
      s1[1] += v.y;
      s2[0] = fmaf(v.x, v.x, s2[0]);
      s2[1] = fmaf(v.y, v.y, s2[1]);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      red[(part * 2) * BN + col + e] = s1[e];
      red[(part * 2 + 1) * BN + col + e] = s2[e];
    }
    named_sync(1, kConsumers);
    if (ct < BN && n0 + ct < N) {
      float t1 = 0.f, t2 = 0.f;
#pragma unroll
      for (int q = 0; q < kParts; ++q) {
        t1 += red[(q * 2) * BN + ct];
        t2 += red[(q * 2 + 1) * BN + ct];
      }
      const size_t row = static_cast<size_t>(m0 / kBM) * 2;
      stats[row * N + n0 + ct] = t1;
      stats[(row + 1) * N + n0 + ct] = t2;
    }
  }
  constexpr int kVecs = BN / 4;               // 16-byte vectors in a row
  for (int v = ct; v < kBM * kVecs; v += kConsumers) {
    const int r = v / kVecs, c4 = v % kVecs;
    const int n = n0 + 4 * c4;
    if (r < rows && n < N) {
      const uint4 val = *reinterpret_cast<const uint4*>(
          smem + (c4 >> 3) * (kBM * 128) + swz(r, c4 & 7));
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(m0 + r) * N + n) =
          val;
    }
  }
}

// One operand of cf90_split3_kernel: dst (3, R, O) bf16, the pieces of
// src[i s_i + j s_j]; its 32 x 32 tiles are the blocks [tile0, tile0 +
// ceil(R / 32) ceil(O / 32)) of the launch.
struct Split3Op {
  const float* src;
  long long s_i, s_j;
  bf16* dst;
  int R, O;
  long long tile0;
};
constexpr int kSplitOps = 3;
struct Split3Args {
  Split3Op op[kSplitOps];
  int n;
};

// dst[p][i][j] = piece p of src[i s_i + j s_j] for i < R, j < O, of each
// operand, through a 32 x 32 tile in shared memory so that both the reads
// (along the unit stride, j's when s_j is 1, else i's) and the writes
// (along j) are coalesced. One launch makes every plane a call needs (B's,
// and x's for the dual wgrad); the tiles lie on a 1-D grid, so R is not
// bound by gridDim.y.
__global__ void __launch_bounds__(256)
cf90_split3_kernel(const __grid_constant__ Split3Args p) {
  __shared__ float tile[32][33];
  Split3Op q = p.op[0];
#pragma unroll
  for (int o = 1; o < kSplitOps; ++o)   // static indices: no local copy
    if (o < p.n && blockIdx.x >= p.op[o].tile0) q = p.op[o];
  const long long t = blockIdx.x - q.tile0;
  const int tj = (q.O + 31) / 32;
  const int i0 = static_cast<int>(t / tj) * 32;
  const int j0 = static_cast<int>(t % tj) * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  if (q.s_j == 1) {
    for (int k = ty; k < 32; k += 8) {
      const int i = i0 + k, j = j0 + tx;
      tile[k][tx] = i < q.R && j < q.O
                        ? q.src[static_cast<long long>(i) * q.s_i + j]
                        : 0.f;
    }
  } else {
    for (int k = ty; k < 32; k += 8) {
      const int i = i0 + tx, j = j0 + k;
      tile[tx][k] = i < q.R && j < q.O
                        ? q.src[i * q.s_i + static_cast<long long>(j) * q.s_j]
                        : 0.f;
    }
  }
  __syncthreads();
  const size_t plane = static_cast<size_t>(q.R) * q.O;
  for (int k = ty; k < 32; k += 8) {
    const int i = i0 + k, j = j0 + tx;
    if (i < q.R && j < q.O) {
      const float v = tile[k][tx];
      const bf16 hi = __float2bfloat16_rn(v);
      const float r1 = __fsub_rn(v, __bfloat162float(hi));
      const bf16 mid = __float2bfloat16_rn(r1);
      const size_t at = static_cast<size_t>(i) * q.O + j;
      q.dst[at] = hi;
      q.dst[plane + at] = mid;
      q.dst[2 * plane + at] =
          __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(mid)));
    }
  }
}

struct Conv3X3Args {
  const float* a; const float* b;
  float* y; float* stats;
  int M, C, N, H, W;
};

// conv3_fused in float32: y (M x N) = conv3x3_s1_p1(relu(a x + b)) over
// 128 x 128 tiles of y, the reduction over (tap, 32-channel slice) stages,
// index tap C + c. Tap (r, s)'s A box is the tile's 128 rows of x shifted by
// (r - 1) W + (s - 1) flat rows (rows outside [0, M) read 0), transformed in
// float32, then each row whose tapped pixel lies outside its own image and
// the channels c >= C zeroed, then split. B is W9's pieces (3, 9 C, N),
// which cf90_split3_kernel makes once a call. The epilogue stores y in
// float32 and sums the stats over it.
__global__ void __launch_bounds__(kThreads, 1)
cf90_conv3_x3_kernel(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tw,
                     const Conv3X3Args p) {
  using P = PlanConv3X3;
  constexpr int S = P::kStages;
  extern __shared__ unsigned char dyn[];
  unsigned char* smem = align1024(dyn);
  __shared__ __align__(8) uint64_t full[S], empty[S];
  const int nc = (p.C + kBK3 - 1) / kBK3, nk = 9 * nc;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN3;
  Ring<S> ring{full, empty};
  ring.init();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    reg_dealloc<40>();
    if (threadIdx.x == kConsumers) {
      tma_prefetch(&tx);
      tma_prefetch(&tw);
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % S, tap = kb / nc, c0 = (kb - tap * nc) * kBK3;
        const uint32_t cb = 4 * min(kBK3, p.C - c0);
        ring.wait_slot(kb);
        unsigned char* st = smem + s * P::kStage;
        mbar_expect_tx(&full[s], kRaw3 + kB3 + 2 * cb);
        tma_load_2d(st, &tx, &full[s], c0,
                    m0 + (tap / 3 - 1) * p.W + (tap % 3 - 1));
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int e = 0; e < kBN3 / 64; ++e)
            tma_load_3d(st + kRaw3 + j * kPieceB3 + e * kBlk3, &tw,
                        &full[s], n0 + 64 * e, tap * p.C + c0, j);
        bulk_load(st + P::kCoef, p.a + c0, cb, &full[s]);
        bulk_load(st + P::kCoef + 128, p.b + c0, cb, &full[s]);
      }
    }
  } else {
    reg_alloc<232>();
    const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    // bit tap of inside[h]: this thread's row h (fragment rows g and
    // g + 8) taps a pixel of its own image there
    uint32_t inside[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 64 * wg + 16 * w + g + 8 * h;
      const int hh = (m / p.W) % p.H, ww = m % p.W;
      inside[h] = 0;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ih = hh + tap / 3 - 1, iw = ww + tap % 3 - 1;
        if (ih >= 0 && ih < p.H && iw >= 0 && iw < p.W)
          inside[h] |= 1u << tap;
      }
    }
    float acc[kBN3 / 2];
#pragma unroll
    for (int i = 0; i < kBN3 / 2; ++i) acc[i] = 0.f;
    // stage kb's fragments: x -> relu(a x + b) in float32, the halo rows and
    // the channels c >= C zeroed, then three pieces
    auto build = [&](int kb, unsigned char* st, uint32_t (&fa)[2][3][4]) {
      ring.wait_full(kb);
      const int tap = kb / nc;
      const int cl = p.C - (kb - tap * nc) * kBK3;  // channels left
      const bool in0 = (inside[0] >> tap) & 1, in1 = (inside[1] >> tap) & 1;
      const float* cf = reinterpret_cast<const float*>(st + P::kCoef);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int q = 0; q < 4; ++q) {             // q & 1: row + 8
          const int r = 64 * wg + 16 * w + g + 8 * (q & 1);
          const int kl = 16 * ks + 2 * t + 8 * (q >> 1);
          const float2 v = *reinterpret_cast<const float2*>(
              st + swz(r, kl >> 2) + (kl & 3) * 4);
          const float2 ca = *reinterpret_cast<const float2*>(cf + kl);
          const float2 cb = *reinterpret_cast<const float2*>(cf + 32 + kl);
          float v0 = fmaxf(affine(v.x, ca.x, cb.x), 0.f);
          float v1 = fmaxf(affine(v.y, ca.y, cb.y), 0.f);
          if (!((q & 1) ? in1 : in0) || kl >= cl) v0 = v1 = 0.f;
          split3(v0, v1, fa[ks][0][q], fa[ks][1][q], fa[ks][2][q]);
        }
    };
    mainloop3_rs<P::kStage, S, kRaw3>(acc, nk, smem, ring, lane, build);
    store_tile_f32(acc, smem, nullptr, p.y, p.stats, m0, n0, p.M, p.N);
  }
}

struct FwdX3Args {
  const float* a; const float* b;        // null: the plain form
  const float* asc; const float* bsc;    // the entry form's shortcut
  const float* bias;                     // null: none
  float* y; float* stats;                // stats: null when not asked
  int emit;                              // 1: write x^ through txh
  int M, K, N;
};

// mm_fused in float32: y (M x N) = x^ (M x K) @ W (K x N) (+ bias) over
// 128 x 128 tiles of y, 32-deep stages. x's raw box (and sc's in the entry
// form, ENTRY) comes in by TMA; the consumers form x^ = x, relu(a x + b) or
// relu(a x + b + asc sc + bsc) in float32 with cf90_fwd_kernel's
// operations, zero the columns k >= K after the transform (relu(b) need
// not be 0), and split it in registers; B is W's pieces (3, K, N), which
// cf90_split3_kernel makes once a call. With emit, column tile kb mod
// (column tiles) writes stage kb's x^ over the warpgroup's rows of the raw
// x box (the same swizzled layout) and stores it by TMA (rows >= M and
// columns >= K are not written); the ring's release() waits for the store
// to have read it. The epilogue adds the bias in float32, stores y and
// sums the stats over the stored values of the rows < M.
template <bool ENTRY>
__global__ void __launch_bounds__(kThreads, 1)
cf90_fwd_x3_kernel(const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap tsc,
                   const __grid_constant__ CUtensorMap tw,
                   const __grid_constant__ CUtensorMap txh,
                   const FwdX3Args p) {
  using P = PlanFwdX3<ENTRY>;
  constexpr int S = P::kStages;
  constexpr int kBOfs = (ENTRY ? 2 : 1) * kRaw3;
  extern __shared__ unsigned char dyn[];
  unsigned char* smem = align1024(dyn);
  __shared__ __align__(8) uint64_t full[S], empty[S];
  const int nk = (p.K + kBK3 - 1) / kBK3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN3;
  Ring<S> ring{full, empty};
  ring.init();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    reg_dealloc<40>();
    if (threadIdx.x == kConsumers) {
      tma_prefetch(&tx);
      tma_prefetch(&tw);
      // the stage's slices of a, b (asc, bsc): 32 floats or the tail
      const int nvec = p.a ? (ENTRY ? 4 : 2) : 0;
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % S, k0 = kb * kBK3;
        const uint32_t cb = 4 * min(kBK3, p.K - k0);
        ring.wait_slot(kb);
        unsigned char* st = smem + s * P::kStage;
        mbar_expect_tx(&full[s], kBOfs + kB3 + nvec * cb);
        tma_load_2d(st, &tx, &full[s], k0, m0);
        if (ENTRY) tma_load_2d(st + kRaw3, &tsc, &full[s], k0, m0);
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int e = 0; e < kBN3 / 64; ++e)
            tma_load_3d(st + kBOfs + j * kPieceB3 + e * kBlk3, &tw,
                        &full[s], n0 + 64 * e, k0, j);
        if (nvec) {
          bulk_load(st + P::kCoef, p.a + k0, cb, &full[s]);
          bulk_load(st + P::kCoef + 128, p.b + k0, cb, &full[s]);
          if (ENTRY) {
            bulk_load(st + P::kCoef + 256, p.asc + k0, cb, &full[s]);
            bulk_load(st + P::kCoef + 384, p.bsc + k0, cb, &full[s]);
          }
        }
      }
    }
  } else {
    reg_alloc<232>();
    const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    float acc[kBN3 / 2];
#pragma unroll
    for (int i = 0; i < kBN3 / 2; ++i) acc[i] = 0.f;
    // stage kb's fragments: x (and sc) -> x^ in float32, the columns
    // k >= K zeroed, x^ written back where emitted, then three pieces
    auto build = [&](int kb, unsigned char* st, uint32_t (&fa)[2][3][4]) {
      ring.wait_full(kb);
      const int k0 = kb * kBK3, kleft = p.K - k0;
      const bool out = p.emit && kb % gridDim.x == blockIdx.x;
      const float* cf = reinterpret_cast<const float*>(st + P::kCoef);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int q = 0; q < 4; ++q) {             // q & 1: row + 8
          const int r = 64 * wg + 16 * w + g + 8 * (q & 1);
          const int kl = 16 * ks + 2 * t + 8 * (q >> 1);
          const uint32_t off = swz(r, kl >> 2) + (kl & 3) * 4;
          const float2 v = *reinterpret_cast<const float2*>(st + off);
          float v0 = v.x, v1 = v.y;
          if (p.a) {
            const float2 ca = *reinterpret_cast<const float2*>(cf + kl);
            const float2 cb = *reinterpret_cast<const float2*>(cf + 32 + kl);
            v0 = affine(v0, ca.x, cb.x);
            v1 = affine(v1, ca.y, cb.y);
            if (ENTRY) {
              const float2 s2 = *reinterpret_cast<const float2*>(
                  st + kRaw3 + off);
              const float2 cs = *reinterpret_cast<const float2*>(cf + 64 +
                                                                 kl);
              const float2 cd = *reinterpret_cast<const float2*>(cf + 96 +
                                                                 kl);
              v0 = __fadd_rn(__fadd_rn(v0, __fmul_rn(s2.x, cs.x)), cd.x);
              v1 = __fadd_rn(__fadd_rn(v1, __fmul_rn(s2.y, cs.y)), cd.y);
            }
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          if (kl >= kleft) v0 = v1 = 0.f;
          if (out)
            *reinterpret_cast<float2*>(st + off) = make_float2(v0, v1);
          split3(v0, v1, fa[ks][0][q], fa[ks][1][q], fa[ks][2][q]);
        }
      if (out) {
        // every thread wrote back exactly the elements it read
        fence_async_smem();
        named_sync(2 + wg, 128);
        if ((threadIdx.x & 127) == 0)
          tma_store_2d(&txh, st + wg * kWgRaw3, k0, m0 + 64 * wg);
      }
    };
    mainloop3_rs<P::kStage, S, kBOfs>(acc, nk, smem, ring, lane, build);
    store_tile_f32(acc, smem, p.bias, p.y, p.stats, m0, n0, p.M, p.N);
  }
}

struct DgradX3Args {
  const float* gc_a; const float* gc_b;  // (3, N) float32 each
  float* dx;
  int M, C, Na, Nb;
};

// dgrad_epilogue's dgrad in float32: dx (M x C) = G_a W_a^T + G_b W_b^T over
// 128 x 128 tiles of dx, both sets meeting in the one float32 accumulator:
// set a's 32-deep stages, then set b's (a set's tail columns n >= N_set
// masked to 0 after the transform). G = (dzn g0 - g1) - yout g2 in float32,
// then three pieces; B is W_set^T's pieces (3, N_set, C). Column tile kb mod
// (column tiles) writes stage kb's G pieces over the warpgroup's raw rows
// and stores them by TMA into tg_set (3, M, N_set) (rows >= M and columns
// >= N_set are not written) for the wgrad launch that follows.
__global__ void __launch_bounds__(kThreads, 1)
cf90_dual_dgrad_x3_kernel(const __grid_constant__ CUtensorMap tdzn_a,
                          const __grid_constant__ CUtensorMap tyout_a,
                          const __grid_constant__ CUtensorMap tw_a,
                          const __grid_constant__ CUtensorMap tg_a,
                          const __grid_constant__ CUtensorMap tdzn_b,
                          const __grid_constant__ CUtensorMap tyout_b,
                          const __grid_constant__ CUtensorMap tw_b,
                          const __grid_constant__ CUtensorMap tg_b,
                          const DgradX3Args p) {
  using P = PlanDgradX3;
  constexpr int S = P::kStages;
  extern __shared__ unsigned char dyn[];
  unsigned char* smem = align1024(dyn);
  __shared__ __align__(8) uint64_t full[S], empty[S];
  const int sa = (p.Na + kBK3 - 1) / kBK3;
  const int nk = sa + (p.Nb + kBK3 - 1) / kBK3;
  const int m0 = blockIdx.y * kBM, c0 = blockIdx.x * kBN3;
  Ring<S> ring{full, empty};
  ring.init();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    reg_dealloc<40>();
    if (threadIdx.x == kConsumers) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % S;
        const bool set_a = kb < sa;
        const int r0 = (set_a ? kb : kb - sa) * kBK3;
        const int nset = set_a ? p.Na : p.Nb;
        const float* gc = set_a ? p.gc_a : p.gc_b;
        const uint32_t cb = 4 * min(kBK3, nset - r0);
        ring.wait_slot(kb);
        unsigned char* st = smem + s * P::kStage;
        mbar_expect_tx(&full[s], 2 * kRaw3 + kB3 + 3 * cb);
        tma_load_2d(st, set_a ? &tdzn_a : &tdzn_b, &full[s], r0, m0);
        tma_load_2d(st + kRaw3, set_a ? &tyout_a : &tyout_b, &full[s], r0,
                    m0);
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int e = 0; e < kBN3 / 64; ++e)
            tma_load_3d(st + 2 * kRaw3 + j * kPieceB3 + e * kBlk3,
                        set_a ? &tw_a : &tw_b, &full[s], c0 + 64 * e, r0, j);
#pragma unroll
        for (int i = 0; i < 3; ++i)
          bulk_load(st + P::kCoef + 128 * i, gc + i * nset + r0, cb,
                    &full[s]);
      }
    }
  } else {
    reg_alloc<232>();
    const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    float acc[kBN3 / 2];
#pragma unroll
    for (int i = 0; i < kBN3 / 2; ++i) acc[i] = 0.f;
    auto build = [&](int kb, unsigned char* st, uint32_t (&fa)[2][3][4]) {
      ring.wait_full(kb);
      const bool set_a = kb < sa;
      const int r0 = (set_a ? kb : kb - sa) * kBK3;
      const int nl = (set_a ? p.Na : p.Nb) - r0;
      const float* cf = reinterpret_cast<const float*>(st + P::kCoef);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int q = 0; q < 4; ++q) {             // q & 1: row + 8
          const int r = 64 * wg + 16 * w + g + 8 * (q & 1);
          const int kl = 16 * ks + 2 * t + 8 * (q >> 1);
          const uint32_t off = swz(r, kl >> 2) + (kl & 3) * 4;
          const float2 dz = *reinterpret_cast<const float2*>(st + off);
          const float2 yo = *reinterpret_cast<const float2*>(st + kRaw3 +
                                                             off);
          const float2 g0 = *reinterpret_cast<const float2*>(cf + kl);
          const float2 g1 = *reinterpret_cast<const float2*>(cf + 32 + kl);
          const float2 g2 = *reinterpret_cast<const float2*>(cf + 64 + kl);
          float v0 = bn_g(dz.x, yo.x, g0.x, g1.x, g2.x);
          float v1 = bn_g(dz.y, yo.y, g0.y, g1.y, g2.y);
          if (kl >= nl) v0 = v1 = 0.f;
          split3(v0, v1, fa[ks][0][q], fa[ks][1][q], fa[ks][2][q]);
        }
      if (kb % gridDim.x == blockIdx.x)
        store_g_pieces(st, fa, set_a ? &tg_a : &tg_b, r0, m0);
    };
    mainloop3_rs<P::kStage, S, 2 * kRaw3>(acc, nk, smem, ring, lane, build);
    store_tile_f32(acc, smem, nullptr, p.dx, nullptr, m0, c0, p.M, p.C);
  }
}

// ws[split, n, c] = sum over this split's rows m of G[m, n] x[m, c] in
// float32 from the pieces of both: the six piece products a 32-row stage,
// A = G^T's pieces and B = x's (3, M, C) pieces, both MN-major straight
// from the stage (rows >= M read 0), into a fresh partial added to the
// running sum in stage order; two partials alternate so that one stage's
// products run while the previous one's partial is added. Output row tiles
// as the bf16 dual wgrad's (set a's, then set b's).
__global__ void __launch_bounds__(kThreads, 1)
cf90_dual_wgrad_x3_kernel(const __grid_constant__ CUtensorMap tx,
                          const __grid_constant__ CUtensorMap tg_a,
                          const __grid_constant__ CUtensorMap tg_b,
                          const WgradArgs p) {
  using P = PlanWgradX3;
  constexpr int S = P::kStages;
  extern __shared__ unsigned char dyn[];
  unsigned char* smem = align1024(dyn);
  __shared__ __align__(8) uint64_t full[S], empty[S];
  const int ta = (p.Na + kBM - 1) / kBM;
  const bool set_a = static_cast<int>(blockIdx.x) < ta;
  const int nset = set_a ? p.Na : p.Nb;
  const int n0 = (set_a ? blockIdx.x : blockIdx.x - ta) * kBM;
  const int c0 = blockIdx.y * kBN3;
  const int mb = blockIdx.z * p.chunk;
  const int nk = (min(p.M, mb + p.chunk) - mb + kBK3 - 1) / kBK3;
  Ring<S> ring{full, empty};
  ring.init();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    reg_dealloc<40>();
    if (threadIdx.x == kConsumers) {
      const CUtensorMap* tg = set_a ? &tg_a : &tg_b;
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % S, r0 = mb + kb * kBK3;
        ring.wait_slot(kb);
        unsigned char* st = smem + s * P::kStage;
        mbar_expect_tx(&full[s], 3 * kPieceA3 + kB3);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          tma_load_3d(st + j * kPieceA3, tg, &full[s], n0, r0, j);
          tma_load_3d(st + j * kPieceA3 + kBlk3, tg, &full[s], n0 + 64, r0,
                      j);
#pragma unroll
          for (int e = 0; e < kBN3 / 64; ++e)
            tma_load_3d(st + 3 * kPieceA3 + j * kPieceB3 + e * kBlk3,
                        &tx, &full[s], c0 + 64 * e, r0, j);
        }
      }
    }
  } else {
    reg_alloc<232>();
    const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    float acc[kBN3 / 2];
#pragma unroll
    for (int i = 0; i < kBN3 / 2; ++i) acc[i] = 0.f;
    mainloop3_ss(acc, nk, wg * kBlk3, 3 * kPieceA3, ring, lane,
                 [&](int kb) {
                   ring.wait_full(kb);
                   return smem + (kb % S) * P::kStage;
                 });
    // float32 partials straight from the fragments: rows n < N_set of the
    // set's block of ws, columns c < C
    float* ws = p.ws + static_cast<size_t>(blockIdx.z) * (p.Na + p.Nb) * p.C;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 64 * wg + 16 * w + g + 8 * h;
      if (n >= nset) continue;
      float* row = ws + static_cast<size_t>((set_a ? 0 : p.Na) + n) * p.C;
#pragma unroll
      for (int j = 0; j < kBN3 / 8; ++j) {
        const int c = c0 + 8 * j + 2 * t;
        if (c < p.C)
          *reinterpret_cast<float2*>(row + c) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

struct BwdX3Args {
  const float* gc;                       // (3, N) float32; null: G is g
  const float* a; const float* b;        // a null: x^ = x
  int n_partners, mask;                  // mask: 0 none, 1 on x, 2 on z
  bool need_x, p0x, dsc, xhat;           // p0x: x is partner 0
  float* part;
  int M, K, N;
  int H, W;                              // the 3x3's images (TAPS 9)
};

// The float32 dgrad tile of the backward's two forms, with the kernel's
// plan P: cf90_bwd_dgrad_x3_kernel (TAPS 1) and cf90_conv3_dgrad_x3_kernel
// (TAPS 9), as bwd_dgrad_tile is the bf16 kernels'.
//
// TAPS 1, mm_fused_bwd's dgrad in float32: dz (M x K) = mask(G W^T (+ dsc))
// over 128 x 128 tiles of dz, the single-set form of
// cf90_dual_dgrad_x3_kernel. G is g as it is (a TMA box, columns n >= N
// read 0) or (dzn g0 - g1) - yout g2 in float32 (the tail columns masked
// after the transform), split in registers; B is W^T's pieces (3, N, K).
// Column tile kb mod (column tiles) stores stage kb's G pieces into tgp
// (3, M, N) for the wgrad.
//
// TAPS 9, conv3_fused_bwd's dgrad in float32: the 3x3 stride-1 pad-1
// transpose over (tap, 32-column slice of G) stages. Tap (r, s) reads rows
// m + (1 - r) W + (1 - s) of dzn and yout (the forward's shift mirrored),
// forms G on them and then zeroes every row whose tapped pixel lies
// outside its own image (the transform of a zero row is -g1, and a flat
// shift also crosses image rows, so the [0, M) bounds of the box are not
// enough); B is W9^T's pieces (3, N, 9 C) at column tap C + c0 (a tile
// that runs past C reads the next tap's columns there, which are never
// stored). The centre tap reads G unshifted and stores its pieces.
//
// The epilogue is cf90_bwd_dgrad_kernel's in float32, chunk by 32-column
// chunk through the ring (x, dsc, the partners: one 128 x 32 box each, a
// and b): dsc added, the mask applied, dz stored by TMA, then the sums of
// dz and dz p_j down the columns (a column pair and 8 rows a thread, the
// 16 row ranges in order: one row of partials per 128-row block); then,
// when a is passed, x^ = relu(a x + b) from the same x box, split into its
// three pieces over the partners' boxes (which the sums have read) and
// stored by TMA into txh (3, M, K) for the wgrad, so x^ is never stored in
// float32 and split again. The 3x3's epilogue has dsc none, the mask on
// z = a x + b, x its own partner and x^ written.
template <int TAPS, typename P>
__device__ __forceinline__ void
bwd_dgrad_x3_tile(const CUtensorMap& tdzn, const CUtensorMap& tyout,
                  const CUtensorMap& tw, const CUtensorMap& tgp,
                  const CUtensorMap& tx, const CUtensorMap& tdsc,
                  const CUtensorMap& tp0, const CUtensorMap& tp1,
                  const CUtensorMap& tdz, const CUtensorMap& txh,
                  const BwdX3Args& p) {
  constexpr int S = P::kStages;
  constexpr int kCf = 4 * kRaw3;                     // a, b of a chunk
  constexpr int kXhPiece = kBM * kBK3 * 2;           // one x^ piece, plain
  extern __shared__ unsigned char dyn[];
  unsigned char* smem = align1024(dyn);
  __shared__ __align__(8) uint64_t full[S], empty[S];
  __shared__ float red[2][16][3][32];                // chunk parity
  const int ns = (p.N + kBK3 - 1) / kBK3, nk = TAPS * ns;
  const int m0 = blockIdx.y * kBM, c0 = blockIdx.x * kBN3;
  const int nch = min(kBN3, p.K - c0 + kBK3 - 1) / kBK3;  // chunks in K
  const bool direct = p.gc == nullptr;
  const int p0_slab = (p.p0x ? 0 : 2) * kRaw3;
  Ring<S> ring{full, empty};
  ring.init();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    reg_dealloc<40>();
    if (threadIdx.x == kConsumers) {
      tma_prefetch(&tdzn);
      tma_prefetch(&tw);
      for (int kb = 0; kb < nk; ++kb) {
        const int tap = TAPS == 1 ? 0 : kb / ns;
        const int s = kb % S, r0 = (kb - tap * ns) * kBK3;
        const int shift = TAPS == 1 ? 0 : (1 - tap / 3) * p.W + 1 - tap % 3;
        const uint32_t cb = direct ? 0 : 4 * min(kBK3, p.N - r0);
        ring.wait_slot(kb);
        unsigned char* st = smem + s * P::kStage;
        mbar_expect_tx(&full[s], (direct ? 1 : 2) * kRaw3 + kB3 + 3 * cb);
        tma_load_2d(st, &tdzn, &full[s], r0, m0 + shift);
        if (!direct)
          tma_load_2d(st + kRaw3, &tyout, &full[s], r0, m0 + shift);
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int e = 0; e < kBN3 / 64; ++e)
            tma_load_3d(st + 2 * kRaw3 + j * kPieceB3 + e * kBlk3, &tw,
                        &full[s], tap * p.K + c0 + 64 * e, r0, j);
        if (!direct) {
#pragma unroll
          for (int i = 0; i < 3; ++i)
            bulk_load(st + P::kCoef + 128 * i, p.gc + i * p.N + r0, cb,
                      &full[s]);
        }
      }
      const bool l0 = p.n_partners > 0 && !p.p0x, l1 = p.n_partners > 1;
      const uint32_t slabs = p.need_x + p.dsc + l0 + l1;
      for (int e = 0; e < nch; ++e) {
        const int kb = nk + e, s = kb % S, col = c0 + kBK3 * e;
        const uint32_t cb = p.a ? 4 * min(kBK3, p.K - col) : 0;
        ring.wait_slot(kb);
        unsigned char* st = smem + s * P::kStage;
        mbar_expect_tx(&full[s], slabs * kRaw3 + 2 * cb);
        if (p.need_x) tma_load_2d(st, &tx, &full[s], col, m0);
        if (p.dsc) tma_load_2d(st + kRaw3, &tdsc, &full[s], col, m0);
        if (l0) tma_load_2d(st + 2 * kRaw3, &tp0, &full[s], col, m0);
        if (l1) tma_load_2d(st + 3 * kRaw3, &tp1, &full[s], col, m0);
        if (cb) {
          bulk_load(st + kCf, p.a + col, cb, &full[s]);
          bulk_load(st + kCf + 128, p.b + col, cb, &full[s]);
        }
      }
    }
  } else {
    reg_alloc<232>();
    const int ct = threadIdx.x, w = (ct >> 5) & 3, lane = ct & 31;
    const int g = lane >> 2, t = lane & 3;
    // TAPS 9: bit tap of inside[h] is set when this thread's fragment row
    // h (rows g and g + 8) taps a pixel of its own image there
    uint32_t inside[2] = {1u, 1u};
    if constexpr (TAPS == 9) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 64 * wg + 16 * w + g + 8 * h;
        const int hh = (m / p.W) % p.H, ww = m % p.W;
        inside[h] = 0;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int ih = hh + 1 - tap / 3, iw = ww + 1 - tap % 3;
          if (ih >= 0 && ih < p.H && iw >= 0 && iw < p.W)
            inside[h] |= 1u << tap;
        }
      }
    }
    float acc[kBN3 / 2];
#pragma unroll
    for (int i = 0; i < kBN3 / 2; ++i) acc[i] = 0.f;
    // stage kb's fragments: g as it is, or G = (dzn g0 - g1) - yout g2 in
    // float32 with the columns n >= N (and, TAPS 9, the rows outside their
    // image) zeroed after the transform, then three pieces; the centre
    // tap's G pieces stored by column tile (slice mod column tiles)
    auto build = [&](int kb, unsigned char* st, uint32_t (&fa)[2][3][4]) {
      ring.wait_full(kb);
      const int tap = TAPS == 1 ? 0 : kb / ns, sl = kb - tap * ns;
      const int r0 = sl * kBK3, nl = p.N - r0;
      const bool in0 = (inside[0] >> tap) & 1, in1 = (inside[1] >> tap) & 1;
      const float* cf = reinterpret_cast<const float*>(st + P::kCoef);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int q = 0; q < 4; ++q) {             // q & 1: row + 8
          const int r = 64 * wg + 16 * w + g + 8 * (q & 1);
          const int kl = 16 * ks + 2 * t + 8 * (q >> 1);
          const uint32_t off = swz(r, kl >> 2) + (kl & 3) * 4;
          const float2 v = *reinterpret_cast<const float2*>(st + off);
          float v0 = v.x, v1 = v.y;
          if (!direct) {
            const float2 yo = *reinterpret_cast<const float2*>(st + kRaw3 +
                                                               off);
            const float2 g0 = *reinterpret_cast<const float2*>(cf + kl);
            const float2 g1 = *reinterpret_cast<const float2*>(cf + 32 + kl);
            const float2 g2 = *reinterpret_cast<const float2*>(cf + 64 + kl);
            v0 = bn_g(v.x, yo.x, g0.x, g1.x, g2.x);
            v1 = bn_g(v.y, yo.y, g0.y, g1.y, g2.y);
            if (kl >= nl || !((q & 1) ? in1 : in0)) v0 = v1 = 0.f;
          }
          split3(v0, v1, fa[ks][0][q], fa[ks][1][q], fa[ks][2][q]);
        }
      if (tap == TAPS / 2 && sl % gridDim.x == blockIdx.x)
        store_g_pieces(st, fa, &tgp, r0, m0);
    };
    mainloop3_rs<P::kStage, S, 2 * kRaw3>(acc, nk, smem, ring, lane, build);
    // the epilogue, chunk by chunk, not unrolled: chunk e's accumulators
    // are moved down to acc[0, 16) for it
    const int rows = min(kBM, p.M - m0);
    const int nq = 1 + p.n_partners;
    const int pc = 2 * (ct & 15), pr = ct >> 4;
#pragma unroll 1
    for (int e = 0; e < nch; ++e) {
      const int kb = nk + e, col = c0 + kBK3 * e;
      ring.wait_full(kb);
      unsigned char* st = smem + (kb % S) * P::kStage;
      const float* cf = reinterpret_cast<const float*>(st + kCf);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 ca = p.a ? *reinterpret_cast<const float2*>(cf + c)
                              : make_float2(0.f, 0.f);
        const float2 cb = p.a ? *reinterpret_cast<const float2*>(cf + 32 + c)
                              : make_float2(0.f, 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t off = swz(64 * wg + 16 * w + g + 8 * h, c >> 2) +
                               (c & 3) * 4;
          float v0 = acc[4 * j + 2 * h];
          float v1 = acc[4 * j + 2 * h + 1];
          if (p.dsc) {
            const float2 d = *reinterpret_cast<const float2*>(st + kRaw3 +
                                                              off);
            v0 = __fadd_rn(v0, d.x);
            v1 = __fadd_rn(v1, d.y);
          }
          if (p.need_x) {
            const float2 xr = *reinterpret_cast<const float2*>(st + off);
            const float z0 = affine(xr.x, ca.x, cb.x);
            const float z1 = affine(xr.y, ca.y, cb.y);
            if ((p.mask == 1 && !(xr.x > 0.f)) || (p.mask == 2 && !(z0 > 0.f)))
              v0 = 0.f;
            if ((p.mask == 1 && !(xr.y > 0.f)) || (p.mask == 2 && !(z1 > 0.f)))
              v1 = 0.f;
          }
          *reinterpret_cast<float2*>(st + kRaw3 + off) = make_float2(v0, v1);
        }
      }
      fence_async_smem();
      named_sync(1, kConsumers);
      if (ct == 0) tma_store_2d(&tdz, st + kRaw3, col, m0);
      float sum[3][2] = {};
      for (int r = 8 * pr; r < min(rows, 8 * pr + 8); ++r) {
        const uint32_t off = swz(r, pc >> 2) + (pc & 3) * 4;
        const float2 d = *reinterpret_cast<const float2*>(st + kRaw3 + off);
        sum[0][0] += d.x;
        sum[0][1] += d.y;
        if (p.n_partners > 0) {
          const float2 q0 =
              *reinterpret_cast<const float2*>(st + p0_slab + off);
          sum[1][0] = fmaf(d.x, q0.x, sum[1][0]);
          sum[1][1] = fmaf(d.y, q0.y, sum[1][1]);
        }
        if (p.n_partners > 1) {
          const float2 q1 =
              *reinterpret_cast<const float2*>(st + 3 * kRaw3 + off);
          sum[2][0] = fmaf(d.x, q1.x, sum[2][0]);
          sum[2][1] = fmaf(d.y, q1.y, sum[2][1]);
        }
      }
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        red[e & 1][pr][q][pc] = sum[q][0];
        red[e & 1][pr][q][pc + 1] = sum[q][1];
      }
      named_sync(1, kConsumers);
      if (ct < kBK3 && col + ct < p.K) {
        for (int q = 0; q < nq; ++q) {
          float v = 0.f;
#pragma unroll
          for (int i = 0; i < 16; ++i) v += red[e & 1][i][q][ct];
          p.part[(static_cast<size_t>(blockIdx.y) * nq + q) * p.K + col +
                 ct] = v;
        }
      }
      if (p.xhat) {
        unsigned char* xp = st + 2 * kRaw3;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 8 * j + 2 * t;
          const float2 ca = *reinterpret_cast<const float2*>(cf + c);
          const float2 cb = *reinterpret_cast<const float2*>(cf + 32 + c);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 64 * wg + 16 * w + g + 8 * h;
            const float2 xr = *reinterpret_cast<const float2*>(
                st + swz(r, c >> 2) + (c & 3) * 4);
            uint32_t pw[3];
            split3(fmaxf(affine(xr.x, ca.x, cb.x), 0.f),
                   fmaxf(affine(xr.y, ca.y, cb.y), 0.f), pw[0], pw[1], pw[2]);
#pragma unroll
            for (int q = 0; q < 3; ++q)
              *reinterpret_cast<uint32_t*>(xp + q * kXhPiece + r * 64 +
                                           c * 2) = pw[q];
          }
        }
        fence_async_smem();
        named_sync(1, kConsumers);
        if (ct == 0) {
#pragma unroll
          for (int q = 0; q < 3; ++q)
            tma_store_3d(&txh, xp + q * kXhPiece, col, m0, q);
        }
      }
      ring.release(kb, lane);
#pragma unroll
      for (int i = 0; i < kBN3 / 2 - 16; ++i) acc[i] = acc[i + 16];
    }
  }
}

// mm_fused_bwd's dgrad in float32: bwd_dgrad_x3_tile's TAPS 1 form
__global__ void __launch_bounds__(kThreads, 1)
cf90_bwd_dgrad_x3_kernel(const __grid_constant__ CUtensorMap tdzn,
                         const __grid_constant__ CUtensorMap tyout,
                         const __grid_constant__ CUtensorMap tw,
                         const __grid_constant__ CUtensorMap tgp,
                         const __grid_constant__ CUtensorMap tx,
                         const __grid_constant__ CUtensorMap tdsc,
                         const __grid_constant__ CUtensorMap tp0,
                         const __grid_constant__ CUtensorMap tp1,
                         const __grid_constant__ CUtensorMap tdz,
                         const __grid_constant__ CUtensorMap txh,
                         const BwdX3Args p) {
  bwd_dgrad_x3_tile<1, PlanBwdX3>(tdzn, tyout, tw, tgp, tx, tdsc, tp0, tp1,
                                  tdz, txh, p);
}

// conv3_fused_bwd's dgrad in float32: the TAPS 9 form. dz (M x C) =
// mask_z(sum over the taps of shift(G) W[tap]^T), the partials sum dz and
// sum dz x, x^'s pieces and the unshifted G's for
// cf90_conv3_wgrad_x3_kernel. x is the epilogue's only operand (its own
// partner), so the dsc and partner maps are never read.
__global__ void __launch_bounds__(kThreads, 1)
cf90_conv3_dgrad_x3_kernel(const __grid_constant__ CUtensorMap tdzn,
                           const __grid_constant__ CUtensorMap tyout,
                           const __grid_constant__ CUtensorMap tw,
                           const __grid_constant__ CUtensorMap tgp,
                           const __grid_constant__ CUtensorMap tx,
                           const __grid_constant__ CUtensorMap tdz,
                           const __grid_constant__ CUtensorMap txh,
                           const BwdX3Args p) {
  bwd_dgrad_x3_tile<9, PlanConv3DgradX3>(tdzn, tyout, tw, tgp, tx, tx, tx,
                                         tx, tdz, txh, p);
}

// ws[split, n, tap C + c] = sum over this split's rows m of G[m, n]
// x^[m + (r - 1) W + (s - 1), c] in float32, over the rows m whose tapped
// pixel (the forward's tap (r, s)) lies in m's own image: the product of
// cf90_conv3_wgrad_kernel done as cf90_dual_wgrad_x3_kernel does it. One
// tap per output column tile (tile (n0, tap, c0); columns c >= C are not
// stored). A is G^T's three pieces, B x^'s three pieces in a box shifted
// by the tap (rows outside [0, M) read 0), both MN-major from the stage;
// each consumer warpgroup zeroes, in all three of its own A pieces, the
// 128-byte rows m whose tapped pixel leaves the image (a flat shift also
// crosses image rows) while the previous stage's products run, then
// issues the six piece products into a fresh partial; two partials
// alternate, each added to the running sum in stage order.
__global__ void __launch_bounds__(kThreads, 1)
cf90_conv3_wgrad_x3_kernel(const __grid_constant__ CUtensorMap txh,
                           const __grid_constant__ CUtensorMap tg,
                           const Conv3WgradArgs p) {
  using P = PlanConv3WgradX3;
  constexpr int S = P::kStages;
  extern __shared__ unsigned char dyn[];
  unsigned char* smem = align1024(dyn);
  __shared__ __align__(8) uint64_t full[S], empty[S];
  const int ctiles = (p.C + kBN3 - 1) / kBN3;
  const int tap = blockIdx.y / ctiles;
  const int n0 = blockIdx.x * kBM, c0 = (blockIdx.y - tap * ctiles) * kBN3;
  const int dr = tap / 3 - 1, ds = tap % 3 - 1;
  const int mb = blockIdx.z * p.chunk;
  const int nk = (min(p.M, mb + p.chunk) - mb + kBK3 - 1) / kBK3;
  Ring<S> ring{full, empty};
  ring.init();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    reg_dealloc<40>();
    if (threadIdx.x == kConsumers) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % S, r0 = mb + kb * kBK3;
        ring.wait_slot(kb);
        unsigned char* st = smem + s * P::kStage;
        mbar_expect_tx(&full[s], 3 * kPieceA3 + kB3);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          tma_load_3d(st + j * kPieceA3, &tg, &full[s], n0, r0, j);
          tma_load_3d(st + j * kPieceA3 + kBlk3, &tg, &full[s], n0 + 64, r0,
                      j);
#pragma unroll
          for (int e = 0; e < kBN3 / 64; ++e)
            tma_load_3d(st + 3 * kPieceA3 + j * kPieceB3 + e * kBlk3,
                        &txh, &full[s], c0 + 64 * e, r0 + dr * p.W + ds, j);
        }
      }
    }
  } else {
    reg_alloc<232>();
    const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    // the halo: thread (row, quarter) of the warpgroup zeroes 32 bytes of
    // reduction row `row` in each of its three A pieces
    const int row = threadIdx.x & 31, quarter = (threadIdx.x & 127) >> 5;
    float acc[kBN3 / 2];
#pragma unroll
    for (int i = 0; i < kBN3 / 2; ++i) acc[i] = 0.f;
    const int a_ofs = wg * kBlk3;
    // stage kb, in, with this warpgroup's halo rows zeroed
    mainloop3_ss(acc, nk, a_ofs, 3 * kPieceA3, ring, lane, [&](int kb) {
      ring.wait_full(kb);
      unsigned char* st = smem + (kb % S) * P::kStage;
      const int m = mb + kb * kBK3 + row;
      const int ih = (m / p.W) % p.H + dr, iw = m % p.W + ds;
      if (m < p.M && (ih < 0 || ih >= p.H || iw < 0 || iw >= p.W)) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          uint4* z = reinterpret_cast<uint4*>(st + j * kPieceA3 + a_ofs +
                                              row * 128 + quarter * 32);
          z[0] = make_uint4(0u, 0u, 0u, 0u);
          z[1] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      fence_async_smem();
      named_sync(2 + wg, 128);
      return st;
    });
    // float32 partials straight from the fragments: rows n < N of the
    // split's block of ws, this tap's columns c < C
    float* ws = p.ws + static_cast<size_t>(blockIdx.z) * p.N * 9 * p.C;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 64 * wg + 16 * w + g + 8 * h;
      if (n >= p.N) continue;
      float* out = ws + static_cast<size_t>(n) * 9 * p.C + tap * p.C;
#pragma unroll
      for (int j = 0; j < kBN3 / 8; ++j) {
        const int c = c0 + 8 * j + 2 * t;
        if (c < p.C)
          *reinterpret_cast<float2*>(out + c) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// --------------------------------------------------------------- host side
// A bf16 2-D map over `outer` rows of `inner` contiguous values, `stride`
// values apart, read in 128B-swizzled boxes of {64, box_outer}; out-of-range
// elements read as 0. Returns false if the encoder refuses it.
bool make_map(CUtensorMap* map, const void* ptr, long long inner,
              long long outer, long long stride, int box_outer) {
  EncodeTiled enc = tensor_map_encoder();
  if (!enc) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A float32 2-D map over `outer` rows of `inner` contiguous values, `stride`
// values apart, read in 128B-swizzled boxes of {32, box_outer} (one 128-byte
// row of 32 floats); out-of-range elements read as 0.
bool make_map_f32(CUtensorMap* map, const void* ptr, long long inner,
                  long long outer, long long stride, int box_outer) {
  EncodeTiled enc = tensor_map_encoder();
  if (!enc) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride) * 4};
  const cuuint32_t box[2] = {32, static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 3-D map over three contiguous bf16 piece planes (3, rows, inner): boxes
// of {64, box_rows, 1}, 128B-swizzled (swizzle), or plain {32, box_rows, 1}
// (the dual dgrad's stores of G's pieces). Elements outside a plane's rows
// and columns read as 0 and are not written.
bool make_map_pieces(CUtensorMap* map, const void* ptr, long long inner,
                     long long rows, int box_rows, bool swizzle) {
  EncodeTiled enc = tensor_map_encoder();
  if (!enc) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(rows), 3};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(inner) * 2,
                                 static_cast<cuuint64_t>(inner * rows) * 2};
  const cuuint32_t box[3] = {swizzle ? 64u : 32u,
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the weight's map: reduction length r, output length o, strides (s_r,
// s_o), one of them 1. BMN when the output index is the contiguous one.
bool weight_map(CUtensorMap* map, const void* w, long long r, long long o,
                long long s_r, long long s_o, int bn, bool& bmn) {
  if (s_r != 1 && s_o != 1) return false;
  bmn = s_o == 1 && s_r != 1;
  return bmn ? make_map(map, w, o, r, s_r, 64)
             : make_map(map, w, r, o, s_o, bn);
}

// Sets the dynamic shared-memory limit of a kernel once, before its first
// launch, then launches it; returns the cudaError_t as int.
template <auto Kernel, typename... Args>
int launch(int smem, dim3 grid, cudaStream_t st, const Args&... args) {
  static bool ready = false;                 // one flag per kernel
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  Kernel<<<grid, kThreads, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int fwd_bn(bool bmn, bool rega, const CUtensorMap& tx, const CUtensorMap& ts,
           const CUtensorMap& tw, const CUtensorMap& txh, const FwdArgs& p,
           cudaStream_t st) {
  const dim3 grid((p.N + BN - 1) / BN, (p.M + kBM - 1) / kBM);
  if (rega) {
    constexpr int sm = Plan<BN, 2>::kSmem;
    return bmn ? launch<cf90_fwd_kernel<BN, true, true>>(sm, grid, st, tx,
                                                         ts, tw, txh, p)
               : launch<cf90_fwd_kernel<BN, false, true>>(sm, grid, st, tx,
                                                          ts, tw, txh, p);
  }
  constexpr int sm = Plan<BN, 1>::kSmem;
  return bmn ? launch<cf90_fwd_kernel<BN, true, false>>(sm, grid, st, tx, ts,
                                                        tw, txh, p)
             : launch<cf90_fwd_kernel<BN, false, false>>(sm, grid, st, tx,
                                                         ts, tw, txh, p);
}

template <int BN>
int dgrad_bn(bool bmn, const CUtensorMap (&m)[8], const DgradArgs& p,
             cudaStream_t st) {
  const dim3 grid((p.C + BN - 1) / BN, (p.M + kBM - 1) / kBM);
  constexpr int sm = Plan<BN, 2>::kSmem;
  return bmn ? launch<cf90_dual_dgrad_kernel<BN, true>>(
                   sm, grid, st, m[0], m[1], m[2], m[3], m[4], m[5], m[6],
                   m[7], p)
             : launch<cf90_dual_dgrad_kernel<BN, false>>(
                   sm, grid, st, m[0], m[1], m[2], m[3], m[4], m[5], m[6],
                   m[7], p);
}

template <int BN>
int wgrad_bn(int splits, const CUtensorMap (&m)[3], const WgradArgs& p,
             cudaStream_t st) {
  const dim3 grid((p.Na + kBM - 1) / kBM + (p.Nb + kBM - 1) / kBM,
                  (p.C + BN - 1) / BN, splits);
  return launch<cf90_dual_wgrad_kernel<BN>>(Plan<BN, 1>::kSmem, grid, st,
                                            m[0], m[1], m[2], p);
}

template <int BN>
int bwd_bn(const CUtensorMap (&m)[10], const BwdArgs& p, cudaStream_t st) {
  const dim3 grid((p.K + BN - 1) / BN, (p.M + kBM - 1) / kBM);
  return launch<cf90_bwd_dgrad_kernel<BN>>(
      Plan<BN, 2, kBwdStage>::kSmem, grid, st, m[0], m[1], m[2], m[3], m[4],
      m[5], m[6], m[7], m[8], m[9], p);
}

template <int BN>
int conv3_bn(const CUtensorMap& tx, const CUtensorMap& tw,
             const Conv3Args& p, cudaStream_t st) {
  const dim3 grid((p.N + BN - 1) / BN, (p.M + kBM - 1) / kBM);
  return launch<cf90_conv3_kernel<BN>>(Plan<BN, 1>::kSmem, grid, st, tx, tw,
                                       p);
}

template <int BN>
int conv3_bwd_bn(const CUtensorMap (&m)[8], const BwdArgs& p,
                 const Conv3WgradArgs& q, int splits, cudaStream_t st) {
  const dim3 grid((p.K + BN - 1) / BN, (p.M + kBM - 1) / kBM);
  const int e = launch<cf90_conv3_dgrad_kernel<BN>>(
      Plan<BN, 2, kBwdStage>::kSmem, grid, st, m[0], m[1], m[2], m[3], m[4],
      m[5], m[6], p);
  if (e != 0) return e;
  const dim3 wgrid((q.N + kBM - 1) / kBM, 9 * ((q.C + BN - 1) / BN), splits);
  return launch<cf90_conv3_wgrad_kernel<BN>>(Plan<BN, 1>::kSmem, wgrid, st,
                                             m[7], m[3], q);
}

bool bad_bn(int bn) { return bn != 64 && bn != 128 && bn != 256; }

}  // namespace

// The bf16 forward: x (M, K) rows, w read at w[k * s_k + n * s_n] with one
// stride 1 and the other a multiple of 8; K and N multiples of 8; every
// pointer 16-byte aligned; bn 64, 128 or 256. stats: (ceil(M / 128), 2, N)
// float32 partials or null. Returns a cudaError_t as int.
int conv_fused_sm90_fwd_launch(const void* x, const float* a, const float* b,
                               const void* sc, const float* asc,
                               const float* bsc, const void* w,
                               long long s_k, long long s_n,
                               const float* bias, void* y, float* stats,
                               void* xhat, int M, int K, int N, int bn,
                               void* stream) {
  if (M < 0 || K < 8 || N < 8 || K % 8 || N % 8 || bad_bn(bn) ||
      (s_k != 1 && s_n != 1) || (sc && !a))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  CUtensorMap tx, ts = {}, tw, txh = {};       // ts, txh: read if passed
  bool bmn = false;
  if (!make_map(&tx, x, K, M, K, kBM) ||
      (sc && !make_map(&ts, sc, K, M, K, kBM)) ||
      (xhat && !make_map(&txh, xhat, K, M, K, 64)) ||
      !weight_map(&tw, w, K, N, s_k, s_n, bn, bmn))
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs p{a, b, sc ? asc : nullptr, sc ? bsc : nullptr, bias,
                  static_cast<bf16*>(y), stats, static_cast<bf16*>(xhat), M,
                  K, N};
  const bool rega = a != nullptr || xhat != nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == 64) return fwd_bn<64>(bmn, rega, tx, ts, tw, txh, p, st);
  if (bn == 128) return fwd_bn<128>(bmn, rega, tx, ts, tw, txh, p, st);
  return fwd_bn<256>(bmn, rega, tx, ts, tw, txh, p, st);
}

// The bf16 dual dgrad: dx (M, C) = G_a w_a^T + G_b w_b^T, w_a read at
// w_a[c * s_c_a + n * s_n_a] (both weights with the same stride-1 index);
// g_a (M, Na) and g_b (M, Nb) receive the bf16 G for the wgrad.
int conv_fused_sm90_dual_dgrad_launch(
    const void* dzn_a, const void* yout_a, const float* gc_a,
    const void* w_a, long long s_c_a, long long s_n_a, void* g_a,
    const void* dzn_b, const void* yout_b, const float* gc_b,
    const void* w_b, long long s_c_b, long long s_n_b, void* g_b, void* dx,
    int M, int C, int Na, int Nb, int bn, void* stream) {
  if (M < 0 || C < 8 || Na < 8 || Nb < 8 || C % 8 || Na % 8 || Nb % 8 ||
      bad_bn(bn))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  CUtensorMap m[8];
  bool bmn_a = false, bmn_b = false;
  if (!make_map(&m[0], dzn_a, Na, M, Na, kBM) ||
      !make_map(&m[1], yout_a, Na, M, Na, kBM) ||
      !weight_map(&m[2], w_a, Na, C, s_n_a, s_c_a, bn, bmn_a) ||
      !make_map(&m[3], g_a, Na, M, Na, 64) ||
      !make_map(&m[4], dzn_b, Nb, M, Nb, kBM) ||
      !make_map(&m[5], yout_b, Nb, M, Nb, kBM) ||
      !weight_map(&m[6], w_b, Nb, C, s_n_b, s_c_b, bn, bmn_b) ||
      !make_map(&m[7], g_b, Nb, M, Nb, 64) || bmn_a != bmn_b)
    return static_cast<int>(cudaErrorInvalidValue);
  const DgradArgs p{gc_a, gc_b, static_cast<bf16*>(dx), M, C, Na, Nb};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == 64) return dgrad_bn<64>(bmn_a, m, p, st);
  if (bn == 128) return dgrad_bn<128>(bmn_a, m, p, st);
  return dgrad_bn<256>(bmn_a, m, p, st);
}

// The bf16 dual wgrad: ws (splits, Na + Nb, C) float32 partials of [dW_a;
// dW_b] in the gluon order from the dgrad's g_a, g_b and x; split s covers
// rows [s * chunk, (s + 1) * chunk), chunk a multiple of 64. Nb = 0 with
// g_b null: the single-set wgrad, ws (splits, Na, C).
int conv_fused_sm90_dual_wgrad_launch(const void* x, const void* g_a,
                                      const void* g_b, float* ws, int splits,
                                      int chunk, int M, int C, int Na,
                                      int Nb, int bn, void* stream) {
  if (M < 1 || C < 8 || Na < 8 || (Nb != 0 && Nb < 8) || C % 8 || Na % 8 ||
      Nb % 8 || (Nb == 0) != (g_b == nullptr) || bad_bn(bn) || splits < 1 ||
      splits > 65535 || chunk < kBK || chunk % kBK ||
      static_cast<long long>(splits - 1) * chunk >= M ||
      static_cast<long long>(splits) * chunk < M)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[3] = {};                       // m[2]: read if Nb > 0
  if (!make_map(&m[0], x, C, M, C, 64) ||
      !make_map(&m[1], g_a, Na, M, Na, 64) ||
      (Nb > 0 && !make_map(&m[2], g_b, Nb, M, Nb, 64)))
    return static_cast<int>(cudaErrorInvalidValue);
  const WgradArgs p{ws, chunk, M, C, Na, Nb};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == 64) return wgrad_bn<64>(splits, m, p, st);
  if (bn == 128) return wgrad_bn<128>(splits, m, p, st);
  return wgrad_bn<256>(splits, m, p, st);
}

// The bf16 1x1 backward's dgrad: dz (M, K) = mask(G w^T (+ dsc)) with w
// read at w[k * s_k + n * s_n], G = g (M, N) when g is passed, else formed
// from dzn, yout and gc (3, N) and written to gout (M, N) for the wgrad;
// mask 0 none, 1 on x > 0, 2 on a x + b > 0; part (ceil(M / 128), 1 +
// n_partners, K) float32 partials of sum dz and sum dz p_j; xhat (M, K)
// receives relu(a x + b) when a is passed (null otherwise). Every pointer
// 16-byte aligned, K and N multiples of 8, s_k 1 and s_n a multiple of 8,
// bn 64, 128 or 256.
int conv_fused_sm90_bwd_dgrad_launch(
    const void* g, const void* dzn, const void* yout, const float* gc,
    const void* w, long long s_k, long long s_n, void* gout, const void* x,
    const float* a, const float* b, const void* dsc, const void* p0,
    const void* p1, int n_partners, int mask, void* dz, float* part,
    void* xhat, int M, int K, int N, int bn, void* stream) {
  const bool direct = g != nullptr;
  if (M < 0 || K < 8 || N < 8 || K % 8 || N % 8 || s_k != 1 || bad_bn(bn) ||
      n_partners < 0 || n_partners > 2 || mask < 0 || mask > 2 ||
      (mask == 2 && !a) || (a && !b) || (xhat != nullptr) != (a != nullptr) ||
      (!direct && (!dzn || !yout || !gc || !gout)) ||
      (n_partners > 0 && !p0) || (n_partners > 1 && !p1) || !x || !part)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const bool p0x = n_partners > 0 && p0 == x;
  const bool need_x = mask != 0 || a != nullptr || p0x;
  // G's maps (m[1], m[3]: G on load), the weight, then the epilogue's
  // 128-row boxes: x, dsc, the partners, dz and x^ (each made if used)
  CUtensorMap m[10] = {};
  if (!make_map(&m[0], direct ? g : dzn, N, M, N, kBM) ||
      (!direct && (!make_map(&m[1], yout, N, M, N, kBM) ||
                   !make_map(&m[3], gout, N, M, N, 64))) ||
      !make_map(&m[2], w, K, N, s_n, 64) ||           // MN-major B
      (need_x && !make_map(&m[4], x, K, M, K, kBM)) ||
      (dsc && !make_map(&m[5], dsc, K, M, K, kBM)) ||
      (n_partners > 0 && !p0x && !make_map(&m[6], p0, K, M, K, kBM)) ||
      (n_partners > 1 && !make_map(&m[7], p1, K, M, K, kBM)) ||
      !make_map(&m[8], dz, K, M, K, kBM) ||
      (xhat && !make_map(&m[9], xhat, K, M, K, kBM)))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs p{direct ? nullptr : gc, a, b, n_partners, mask, need_x,
                  p0x, dsc != nullptr, xhat != nullptr, part, M, K, N};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == 64) return bwd_bn<64>(m, p, st);
  if (bn == 128) return bwd_bn<128>(m, p, st);
  return bwd_bn<256>(m, p, st);
}

// The bf16 3x3 forward: x (M, C) NHWC rows of B = M / (H W) images, w read
// at w[tap * s_tap + c * s_c + n * s_n] with s_c 1 and s_tap C (one K-major
// (9 C, N) matrix, the gluon view) and s_n a multiple of 8; C and N
// multiples of 8; stats (ceil(M / 128), 2, N) float32 partials or null.
int conv_fused_sm90_conv3_launch(const void* x, const float* a,
                                 const float* b, const void* w,
                                 long long s_tap, long long s_c,
                                 long long s_n, void* y, float* stats, int M,
                                 int C, int N, int H, int W, int bn,
                                 void* stream) {
  if (M < 0 || C < 8 || N < 8 || C % 8 || N % 8 || H < 1 || W < 1 ||
      M % (H * W) || bad_bn(bn) || s_c != 1 || s_tap != C || !a || !b)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  CUtensorMap tx, tw;
  if (!make_map(&tx, x, C, M, C, kBM) ||
      !make_map(&tw, w, 9LL * C, N, s_n, bn))          // K-major B
    return static_cast<int>(cudaErrorInvalidValue);
  const Conv3Args p{a, b, static_cast<bf16*>(y), stats, M, C, N, H, W};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == 64) return conv3_bn<64>(tx, tw, p, st);
  if (bn == 128) return conv3_bn<128>(tx, tw, p, st);
  return conv3_bn<256>(tx, tw, p, st);
}

// The bf16 3x3 backward, two launches: the dgrad, dz (M, C) = the 3x3
// transpose of G masked on a x + b > 0, part (ceil(M / 128), 2, C) float32
// partials of sum dz and sum dz x, with G = (dzn g0 - g1) - yout g2 from
// dzn, yout (M, N) and gc (3, N) written to gout (M, N) and x^ =
// relu(a x + b) to xhat (M, C); then the wgrad from gout and xhat, ws
// (splits, N, 9 C) float32 dW partials in the gluon order, split s
// covering rows [s chunk, (s + 1) chunk), chunk a multiple of 64. x (M, C)
// NHWC rows of M / (H W) images; w read at w[tap * s_tap + c * s_c + n *
// s_n] with s_c 1 and s_tap C (the gluon view) and s_n a multiple of 8; C
// and N multiples of 8; every pointer 16-byte aligned.
int conv_fused_sm90_conv3_bwd_launch(
    const void* dzn, const void* yout, const float* gc, const void* w,
    long long s_tap, long long s_c, long long s_n, void* gout, const void* x,
    const float* a, const float* b, void* dz, float* part, void* xhat,
    float* ws, int splits, int chunk, int M, int C, int N, int H, int W,
    int bn, void* stream) {
  if (M < 1 || C < 8 || N < 8 || C % 8 || N % 8 || H < 1 || W < 1 ||
      M % (H * W) || bad_bn(bn) || s_c != 1 || s_tap != C || !dzn ||
      !yout || !gc || !gout || !x || !a || !b || !dz || !part || !xhat ||
      !ws || splits < 1 || splits > 65535 || chunk < kBK || chunk % kBK ||
      static_cast<long long>(splits - 1) * chunk >= M ||
      static_cast<long long>(splits) * chunk < M)
    return static_cast<int>(cudaErrorInvalidValue);
  // the dgrad's G operands, weight, G out, x, dz and x^ (128-row boxes for
  // the epilogue's chunks); the wgrad's x^ in 64-row boxes
  CUtensorMap m[8];
  if (!make_map(&m[0], dzn, N, M, N, kBM) ||
      !make_map(&m[1], yout, N, M, N, kBM) ||
      !make_map(&m[2], w, 9LL * C, N, s_n, 64) ||       // MN-major B
      !make_map(&m[3], gout, N, M, N, 64) ||
      !make_map(&m[4], x, C, M, C, kBM) ||
      !make_map(&m[5], dz, C, M, C, kBM) ||
      !make_map(&m[6], xhat, C, M, C, kBM) ||
      !make_map(&m[7], xhat, C, M, C, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs p{gc, a, b, 1, 2, true, true, false, true, part, M, C, N};
  p.H = H;
  p.W = W;
  const Conv3WgradArgs q{ws, chunk, M, C, N, H, W};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == 64) return conv3_bwd_bn<64>(m, p, q, splits, st);
  if (bn == 128) return conv3_bwd_bn<128>(m, p, q, splits, st);
  return conv3_bwd_bn<256>(m, p, q, splits, st);
}

// The float32 route's piece planes, n (1-3) operands in one launch: desc
// holds n records {src, s_i, s_j, R, O, dst}, and operand k's dst (3, R, O)
// bf16 receives dst[p][i][j] = piece p (hi, mid, lo) of src[i * s_i + j *
// s_j], hi + mid + lo exact. Returns a cudaError_t as int.
int conv_fused_sm90_split3_launch(int n, const long long* desc,
                                  void* stream) {
  if (n < 1 || n > kSplitOps || !desc)
    return static_cast<int>(cudaErrorInvalidValue);
  Split3Args p{};
  p.n = n;
  long long tiles = 0;
  for (int k = 0; k < n; ++k) {
    const long long* d = desc + 6 * k;
    Split3Op& q = p.op[k];
    q.src = reinterpret_cast<const float*>(d[0]);
    q.s_i = d[1];
    q.s_j = d[2];
    q.dst = reinterpret_cast<bf16*>(d[5]);
    if (!q.src || !q.dst || d[3] < 1 || d[4] < 1 || d[3] > INT_MAX ||
        d[4] > INT_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
    q.R = static_cast<int>(d[3]);
    q.O = static_cast<int>(d[4]);
    q.tile0 = tiles;
    tiles += ((d[3] + 31) / 32) * ((d[4] + 31) / 32);
  }
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cf90_split3_kernel<<<static_cast<unsigned>(tiles), dim3(32, 8), 0,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The float32 3x3 forward: x (M, C) float32 NHWC rows of M / (H W) images,
// wp (3, 9 C, N) bf16 the pieces of W9 with the reduction index tap C + c;
// y (M, N) float32, stats (ceil(M / 128), 2, N) float32 partials or null;
// C and N multiples of 8, every pointer 16-byte aligned.
int conv_fused_sm90_conv3_x3_launch(const float* x, const float* a,
                                    const float* b, const void* wp, float* y,
                                    float* stats, int M, int C, int N, int H,
                                    int W, void* stream) {
  if (M < 0 || C < 8 || N < 8 || C % 8 || N % 8 || H < 1 || W < 1 ||
      M % (H * W) || (M + kBM - 1) / kBM > 65535 || !x || !a || !b || !wp ||
      !y)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  CUtensorMap tx, tw;
  if (!make_map_f32(&tx, x, C, M, C, kBM) ||
      !make_map_pieces(&tw, wp, N, 9LL * C, kBK3, true))
    return static_cast<int>(cudaErrorInvalidValue);
  const Conv3X3Args p{a, b, y, stats, M, C, N, H, W};
  const dim3 grid((N + kBN3 - 1) / kBN3, (M + kBM - 1) / kBM);
  return launch<cf90_conv3_x3_kernel>(PlanConv3X3::kSmem, grid,
                                      static_cast<cudaStream_t>(stream), tx,
                                      tw, p);
}

// The float32 1x1 forward: y (M, N) float32 = x^ W (+ bias) with x^ = x,
// relu(a x + b) (a, b passed) or relu(a x + b + asc sc + bsc) (sc, asc and
// bsc passed too) from x (M, K) float32; wp (3, K, N) bf16 the pieces of
// W; stats (ceil(M / 128), 2, N) float32 partials or null; xhat (M, K)
// float32 receives x^ when passed. K and N multiples of 8, every pointer
// 16-byte aligned.
int conv_fused_sm90_fwd_x3_launch(const float* x, const float* a,
                                  const float* b, const float* sc,
                                  const float* asc, const float* bsc,
                                  const void* wp, const float* bias,
                                  float* y, float* stats, float* xhat,
                                  int M, int K, int N, void* stream) {
  if (M < 0 || K < 8 || N < 8 || K % 8 || N % 8 ||
      (M + kBM - 1) / kBM > 65535 || (a != nullptr) != (b != nullptr) ||
      (sc && (!a || !asc || !bsc)) || !x || !wp || !y)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  CUtensorMap tx, ts = {}, tw, txh = {};       // ts, txh: read if passed
  if (!make_map_f32(&tx, x, K, M, K, kBM) ||
      (sc && !make_map_f32(&ts, sc, K, M, K, kBM)) ||
      !make_map_pieces(&tw, wp, N, K, kBK3, true) ||
      (xhat && !make_map_f32(&txh, xhat, K, M, K, 64)))
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdX3Args p{a, b, sc ? asc : nullptr, sc ? bsc : nullptr, bias, y,
                    stats, xhat != nullptr, M, K, N};
  const dim3 grid((N + kBN3 - 1) / kBN3, (M + kBM - 1) / kBM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return sc ? launch<cf90_fwd_x3_kernel<true>>(PlanFwdX3<true>::kSmem, grid,
                                               st, tx, ts, tw, txh, p)
            : launch<cf90_fwd_x3_kernel<false>>(PlanFwdX3<false>::kSmem,
                                                grid, st, tx, ts, tw, txh,
                                                p);
}

// The float32 dual dgrad: dx (M, C) float32 = G_a W_a^T + G_b W_b^T with
// G_set = (dzn g0 - g1) - yout g2 from dzn, yout (M, N_set) float32 and gc
// (3, N_set); wp_set (3, N_set, C) bf16 the pieces of W_set^T; gp_set
// (3, M, N_set) bf16 receives G_set's pieces for the wgrad. C, Na and Nb
// multiples of 8, every pointer 16-byte aligned.
int conv_fused_sm90_dual_dgrad_x3_launch(
    const float* dzn_a, const float* yout_a, const float* gc_a,
    const void* wp_a, void* gp_a, const float* dzn_b, const float* yout_b,
    const float* gc_b, const void* wp_b, void* gp_b, float* dx, int M, int C,
    int Na, int Nb, void* stream) {
  if (M < 0 || C < 8 || Na < 8 || Nb < 8 || C % 8 || Na % 8 || Nb % 8 ||
      (M + kBM - 1) / kBM > 65535 || !dzn_a || !yout_a || !gc_a || !wp_a || !gp_a || !dzn_b || !yout_b ||
      !gc_b || !wp_b || !gp_b || !dx)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  CUtensorMap m[8];
  if (!make_map_f32(&m[0], dzn_a, Na, M, Na, kBM) ||
      !make_map_f32(&m[1], yout_a, Na, M, Na, kBM) ||
      !make_map_pieces(&m[2], wp_a, C, Na, kBK3, true) ||
      !make_map_pieces(&m[3], gp_a, Na, M, 64, false) ||
      !make_map_f32(&m[4], dzn_b, Nb, M, Nb, kBM) ||
      !make_map_f32(&m[5], yout_b, Nb, M, Nb, kBM) ||
      !make_map_pieces(&m[6], wp_b, C, Nb, kBK3, true) ||
      !make_map_pieces(&m[7], gp_b, Nb, M, 64, false))
    return static_cast<int>(cudaErrorInvalidValue);
  const DgradX3Args p{gc_a, gc_b, dx, M, C, Na, Nb};
  const dim3 grid((C + kBN3 - 1) / kBN3, (M + kBM - 1) / kBM);
  return launch<cf90_dual_dgrad_x3_kernel>(
      PlanDgradX3::kSmem, grid, static_cast<cudaStream_t>(stream), m[0], m[1],
      m[2], m[3], m[4], m[5], m[6], m[7], p);
}

// The float32 1x1 backward's dgrad: dz (M, K) float32 = mask(G W^T
// (+ dsc)) with G = g (M, N) float32 when g is passed, else (dzn g0 - g1)
// - yout g2 from dzn, yout (M, N) and gc (3, N); wp (3, N, K) bf16 the
// pieces of W^T; gp (3, M, N) bf16 receives G's pieces for the wgrad;
// mask 0 none, 1 on x > 0, 2 on a x + b > 0; part (ceil(M / 128),
// 1 + n_partners, K) float32 partials of sum dz and sum dz p_j; xhp
// (3, M, K) bf16 receives the pieces of relu(a x + b) when a is passed
// (null otherwise). K and N multiples of 8, every pointer 16-byte aligned.
int conv_fused_sm90_bwd_dgrad_x3_launch(
    const float* g, const float* dzn, const float* yout, const float* gc,
    const void* wp, void* gp, const float* x, const float* a,
    const float* b, const float* dsc, const float* p0, const float* p1,
    int n_partners, int mask, float* dz, float* part, void* xhp, int M,
    int K, int N, void* stream) {
  const bool direct = g != nullptr;
  if (M < 0 || K < 8 || N < 8 || K % 8 || N % 8 ||
      (M + kBM - 1) / kBM > 65535 || n_partners < 0 || n_partners > 2 ||
      mask < 0 || mask > 2 || (mask == 2 && !a) || (a && !b) ||
      (xhp != nullptr) != (a != nullptr) ||
      (!direct && (!dzn || !yout || !gc)) || (n_partners > 0 && !p0) ||
      (n_partners > 1 && !p1) || !wp || !gp || !x || !dz || !part)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const bool p0x = n_partners > 0 && p0 == x;
  const bool need_x = mask != 0 || a != nullptr || p0x;
  // G's boxes, W^T's pieces, G's pieces out, then the epilogue's 128-row
  // boxes: x, dsc, the partners, dz, and x^'s pieces out (each made if used)
  CUtensorMap m[10] = {};
  if (!make_map_f32(&m[0], direct ? g : dzn, N, M, N, kBM) ||
      (!direct && !make_map_f32(&m[1], yout, N, M, N, kBM)) ||
      !make_map_pieces(&m[2], wp, K, N, kBK3, true) ||
      !make_map_pieces(&m[3], gp, N, M, 64, false) ||
      (need_x && !make_map_f32(&m[4], x, K, M, K, kBM)) ||
      (dsc && !make_map_f32(&m[5], dsc, K, M, K, kBM)) ||
      (n_partners > 0 && !p0x && !make_map_f32(&m[6], p0, K, M, K, kBM)) ||
      (n_partners > 1 && !make_map_f32(&m[7], p1, K, M, K, kBM)) ||
      !make_map_f32(&m[8], dz, K, M, K, kBM) ||
      (xhp && !make_map_pieces(&m[9], xhp, K, M, kBM, false)))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdX3Args p{direct ? nullptr : gc, a, b, n_partners, mask, need_x,
                    p0x, dsc != nullptr, xhp != nullptr, part, M, K, N};
  const dim3 grid((K + kBN3 - 1) / kBN3, (M + kBM - 1) / kBM);
  return launch<cf90_bwd_dgrad_x3_kernel>(
      PlanBwdX3::kSmem, grid, static_cast<cudaStream_t>(stream), m[0], m[1],
      m[2], m[3], m[4], m[5], m[6], m[7], m[8], m[9], p);
}

// The float32 3x3 backward, two launches: the dgrad, dz (M, C) float32 =
// the 3x3 transpose of G masked on a x + b > 0, part (ceil(M / 128), 2, C)
// float32 partials of sum dz and sum dz x, with G = (dzn g0 - g1) - yout g2
// from dzn, yout (M, N) float32 and gc (3, N); wp (3, N, 9 C) bf16 the
// pieces of W9^T ([n, tap C + c] = w9[tap, c, n]); G's pieces written to
// gp (3, M, N) and x^'s to xhp (3, M, C); then the wgrad from gp and xhp,
// ws (splits, N, 9 C) float32 dW partials in the gluon order, split s
// covering rows [s chunk, (s + 1) chunk), chunk a multiple of 64. x (M, C)
// NHWC rows of M / (H W) images; C and N multiples of 8; every pointer
// 16-byte aligned.
int conv_fused_sm90_conv3_bwd_x3_launch(
    const float* dzn, const float* yout, const float* gc, const void* wp,
    void* gp, const float* x, const float* a, const float* b, float* dz,
    float* part, void* xhp, float* ws, int splits, int chunk, int M, int C,
    int N, int H, int W, void* stream) {
  if (M < 1 || C < 8 || N < 8 || C % 8 || N % 8 || H < 1 || W < 1 ||
      M % (H * W) || (M + kBM - 1) / kBM > 65535 || !dzn || !yout || !gc ||
      !wp || !gp || !x || !a || !b || !dz || !part || !xhp || !ws ||
      splits < 1 || splits > 65535 || chunk < kBK || chunk % kBK ||
      static_cast<long long>(splits - 1) * chunk >= M ||
      static_cast<long long>(splits) * chunk < M)
    return static_cast<int>(cudaErrorInvalidValue);
  // the dgrad's G boxes, W9^T's pieces, G's pieces out, x, dz and x^'s
  // pieces out (128-row boxes for the epilogue's chunks); the wgrad's x^
  // and G pieces in 32-row boxes
  CUtensorMap m[9];
  if (!make_map_f32(&m[0], dzn, N, M, N, kBM) ||
      !make_map_f32(&m[1], yout, N, M, N, kBM) ||
      !make_map_pieces(&m[2], wp, 9LL * C, N, kBK3, true) ||
      !make_map_pieces(&m[3], gp, N, M, 64, false) ||
      !make_map_f32(&m[4], x, C, M, C, kBM) ||
      !make_map_f32(&m[5], dz, C, M, C, kBM) ||
      !make_map_pieces(&m[6], xhp, C, M, kBM, false) ||
      !make_map_pieces(&m[7], xhp, C, M, kBK3, true) ||
      !make_map_pieces(&m[8], gp, N, M, kBK3, true))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdX3Args p{gc, a, b, 1, 2, true, true, false, true, part, M, C, N};
  p.H = H;
  p.W = W;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((C + kBN3 - 1) / kBN3, (M + kBM - 1) / kBM);
  const int e = launch<cf90_conv3_dgrad_x3_kernel>(
      PlanConv3DgradX3::kSmem, grid, st, m[0], m[1], m[2], m[3], m[4], m[5],
      m[6], p);
  if (e != 0) return e;
  const Conv3WgradArgs q{ws, chunk, M, C, N, H, W};
  const dim3 wgrid((N + kBM - 1) / kBM, 9 * ((C + kBN3 - 1) / kBN3), splits);
  return launch<cf90_conv3_wgrad_x3_kernel>(PlanConv3WgradX3::kSmem, wgrid,
                                            st, m[7], m[8], q);
}

// The float32 dual wgrad: ws (splits, Na + Nb, C) float32 partials of
// [dW_a; dW_b] in the gluon order from xp (3, M, C), the pieces of x (or
// x^), and the dgrad's gp_a (3, M, Na) and gp_b (3, M, Nb); split s covers
// rows [s * chunk, (s + 1) * chunk), chunk a multiple of 64. Nb = 0 with
// gp_b null: the single-set wgrad of mm_fused_bwd, ws (splits, Na, C).
int conv_fused_sm90_dual_wgrad_x3_launch(const void* xp, const void* gp_a,
                                         const void* gp_b, float* ws,
                                         int splits, int chunk, int M, int C,
                                         int Na, int Nb, void* stream) {
  if (M < 1 || C < 8 || Na < 8 || (Nb != 0 && Nb < 8) || C % 8 || Na % 8 ||
      Nb % 8 || (Nb == 0) != (gp_b == nullptr) || !xp || !gp_a || !ws ||
      splits < 1 || splits > 65535 || chunk < kBK || chunk % kBK ||
      static_cast<long long>(splits - 1) * chunk >= M ||
      static_cast<long long>(splits) * chunk < M)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[3] = {};                       // m[2]: read if Nb > 0
  if (!make_map_pieces(&m[0], xp, C, M, kBK3, true) ||
      !make_map_pieces(&m[1], gp_a, Na, M, kBK3, true) ||
      (Nb > 0 && !make_map_pieces(&m[2], gp_b, Nb, M, kBK3, true)))
    return static_cast<int>(cudaErrorInvalidValue);
  const WgradArgs p{ws, chunk, M, C, Na, Nb};
  const dim3 grid((Na + kBM - 1) / kBM + (Nb + kBM - 1) / kBM,
                  (C + kBN3 - 1) / kBN3, splits);
  return launch<cf90_dual_wgrad_x3_kernel>(
      PlanWgradX3::kSmem, grid, static_cast<cudaStream_t>(stream), m[0], m[1],
      m[2], p);
}
