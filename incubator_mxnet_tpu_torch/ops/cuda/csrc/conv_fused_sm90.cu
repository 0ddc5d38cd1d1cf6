// The bf16 route of two fused 1x1 conv kernels on Hopper (sm_90a):
// TMA-fed wgmma with the load transform applied on chip.
//
// Replaces the Pallas TPU kernels of
// incubator_mxnet_tpu/ops/pallas/conv_fused.py:
//   cf90_fwd_kernel          <-  mm_fused (:148)        y = x^ @ W (+ bias),
//                                                       stats, x^
//   cf90_dual_dgrad_kernel \ <-  dgrad_epilogue (:505)  dx = G_a W_a^T +
//   cf90_dual_wgrad_kernel /                            G_b W_b^T; dW_a, dW_b
// with the reference's rounding points, as conv_fused.cu keeps them: the
// load transform (x^ = x, relu(a x + b) or relu(a x + b + asc sc + bsc);
// G = (dzn g0 - g1) - yout g2) in float32 with both roundings of each step,
// rounded to bf16 before the product; float32 accumulation on the tensor
// cores; outputs rounded once; the stats summed over the ROUNDED y.
// float32 stays on conv_fused.cu's SIMT kernels (no TF32 here); the
// wrapper (ops/cuda/conv_fused.py) chooses the route by type and shape
// before the launch.
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
// Persistence (one block per SM walking the tiles, so that one tile's
// epilogue overlaps the next one's loads) is later work; a cluster of two
// blocks sharing the B tile by TMA multicast measured slower at these
// shapes.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
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
// coefficients (up to four 64-float slices); 3-4 stages fit the budget.
template <int BN, int NRAW>
struct Plan {
  static constexpr int kB = BN * kBK * 2;
  static constexpr int kCoef = NRAW * kA + kB;      // offset in a stage
  static constexpr int kStage = kCoef + 1024;
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
// MN-major, straight from the stage.
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

// --------------------------------------------------------------- host side
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found once through the runtime's entry
// point query (this library is not linked against libcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// A bf16 2-D map over `outer` rows of `inner` contiguous values, `stride`
// values apart, read in 128B-swizzled boxes of {64, box_outer}; out-of-range
// elements read as 0. Returns false if the encoder refuses it.
bool make_map(CUtensorMap* map, const void* ptr, long long inner,
              long long outer, long long stride, int box_outer) {
  EncodeTiled enc = encoder();
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
// rows [s * chunk, (s + 1) * chunk), chunk a multiple of 64.
int conv_fused_sm90_dual_wgrad_launch(const void* x, const void* g_a,
                                      const void* g_b, float* ws, int splits,
                                      int chunk, int M, int C, int Na,
                                      int Nb, int bn, void* stream) {
  if (M < 1 || C < 8 || Na < 8 || Nb < 8 || C % 8 || Na % 8 || Nb % 8 ||
      bad_bn(bn) || splits < 1 || splits > 65535 || chunk < kBK ||
      chunk % kBK || static_cast<long long>(splits - 1) * chunk >= M ||
      static_cast<long long>(splits) * chunk < M)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[3];
  if (!make_map(&m[0], x, C, M, C, 64) ||
      !make_map(&m[1], g_a, Na, M, Na, 64) ||
      !make_map(&m[2], g_b, Nb, M, Nb, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const WgradArgs p{ws, chunk, M, C, Na, Nb};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == 64) return wgrad_bn<64>(splits, m, p, st);
  if (bn == 128) return wgrad_bn<128>(splits, m, p, st);
  return wgrad_bn<256>(splits, m, p, st);
}
