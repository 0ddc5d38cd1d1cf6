// The bf16 flash-attention forward and backward on Hopper (sm_90a):
// TMA-fed wgmma, the online softmax in registers; the backward's two passes
// (dq; dk and dv) below the forward.
//
// Replaces, for bf16 inputs, the Pallas TPU kernels of
// incubator_mxnet_tpu/ops/pallas/flash_attention.py:
//   flash_fwd_wgmma_kernel      <-  _fwd_packed (:699), _fwd_resident
//                                   (:418), _fwd_streamed (:112)
//   flash_bwd_dq_wgmma_kernel   <-  _dq_pass_packed (:940), the dq half of
//                                   _bwd_fused_packed (:911),
//                                   _dq_pass_resident (:556),
//                                   _dq_pass_streamed (:279)
//   flash_bwd_dkv_wgmma_kernel  <-  _dkv_pass_packed (:965), the dk/dv half
//                                   of _bwd_fused_packed (:911),
//                                   _dkv_pass_resident (:593),
//                                   _dkv_pass_streamed (:318)
// The forward, in both of the reference's layouts (packed (B, T, H*d) with lse (B, T,
// H); head-major (B, H, T, d) with lse (B, H, T)) and with the rounding
// points flash_attention.cu keeps: packed scales q once in bf16 (by the
// scale rounded to bf16) before Q.K^T, head-major scales the float32
// scores; P is rounded to bf16 before P.V; masked entries are -1e30 with
// the top-left causal rule row >= col; lse = m + log(max(l, 1e-30)).
//
// What bounds it on an H100: at the training shape (B 32, H 12, T 512,
// d 64, causal) the bytes, q, k, v read and out and lse written once
// (0.03 ms at 3.35 TB/s), against 0.013 ms of products at the bf16 peak.
// So the design keeps copies in flight under the products and takes
// nothing through shared memory but Q, K and V:
//   * a block is two warpgroups of 64 query rows each (a 128-row q-tile
//     that shares each K/V tile); one thread of the first issues the TMA
//     loads: the block's Q tile once, then K and V tiles of 64 keys into a
//     ring of kFStages stages, K and V each on its own "full" mbarrier (so
//     S = Q.K^T starts before V lands), one "empty" mbarrier a stage on
//     which the eight warps release it; the tile for a stage freed one
//     tile ago is issued behind each P.V product, kFStages - 1 tiles ahead
//     (a separate producer warp cost the consumers the registers that keep
//     the wgmma chain asynchronous: ptxas serialised it at 96 a thread);
//   * the tensor maps are 3-D, (H d, T, B) at column h d packed and (d, T,
//     B H) head-major, so rows past T read zero and never the next batch's
//     rows; 128B-swizzled 64-column boxes (64B-swizzled 32-column ones at
//     d 32), one box a 64-column block of the head;
//   * S = Q.K^T is wgmma m64n64k16 with both operands K-major in shared
//     memory; in the packed layout each warpgroup first scales its Q rows
//     in place, in bf16, and fences them to the async proxy;
//   * the online softmax runs on S's accumulator fragments: a thread holds
//     two rows, a row's max reduced over its quad by shuffles, the
//     exponentials ex2.approx with scale log2(e) folded in (as the float32
//     route of flash_attention.cu does), the row max and sum each over
//     four partial accumulators (short dependency chains), the row sums
//     kept per thread and reduced over the quad once at the end; only
//     tiles across the diagonal or the keys' end compute the mask, as a
//     compare with the row's last key;
//   * O += P.V is wgmma with P converted to bf16 in registers as the A
//     operand (the accumulator's layout is the A fragment's) and V an
//     MN-major B operand from shared memory; P never touches shared
//     memory; S of the next tile is issued right behind it;
//   * a warpgroup whose rows stop short of the block's last key tile (the
//     upper one under the causal mask) releases that tile unread;
//   * the causal grid launches its longest q-tiles first;
//   * the output, times the row sums' reciprocals and rounded, is written
//     over the warpgroup's own Q rows and stored by TMA; lse from the
//     registers.
// Registers bound the occupancy: at d 32 and 64 two blocks an SM (128
// registers a thread), at d 128 one (the 64 x 128 accumulator).
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

#include "sm90_gemm.cuh"

namespace {

using namespace sm90;

constexpr int kFRows = 128;                 // query rows of a block
constexpr int kFKeys = 64;                  // keys of a K or V tile
constexpr int kFStages = 3;                 // K/V ring stages
constexpr int kFThreads = 256;              // two warpgroups
constexpr float kNegInf = -1e30f;           // NEG_INF of the reference
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory plan at head dim D (mirrored by flash_attention.py:
// flash_wgmma_plan): the Q tile, 128 rows, and kFStages stages of a K and
// a V tile of 64 rows, each as D / kBoxCols column blocks of swizzled rows
// of kRowBytes (128, or 64 at d 32); 1 KB for the 1024-byte alignment.
template <int D>
struct FlashPlan {
  static constexpr int kRowBytes = D >= 64 ? 128 : 64;
  static constexpr int kBoxCols = kRowBytes / 2;
  static constexpr int kColBlocks = D / kBoxCols;
  static constexpr uint32_t kMode = D >= 64 ? 1 : 2;   // 128B or 64B
  static constexpr int kQ = kFRows * D * 2;
  static constexpr int kKV = kFKeys * D * 2;
  static constexpr int kSmem = kQ + kFStages * 2 * kKV + 1024;
  static constexpr int kBlocks = D <= 64 ? 2 : 1;      // blocks an SM
  static_assert(D == 32 || D == 64 || D == 128, "head dims 32, 64, 128");
  static_assert(kBlocks * (kSmem + 1024) <= 228 * 1024, "the blocks fit");
};

struct FlashArgs {
  float* lse;                               // the forward writes it
  const float* delta;                       // the backward's
  long long l_sb, l_sh, l_sr;               // lse / delta strides (floats)
  int H, sq, sk, causal, packed;
  float scale;                              // the backward's: dS's
                                            // (head-major), dq's (packed)
  float s_mul;                              // the scores' factor
  float s_l2;                               // s_mul * log2(e)
  float q_mul;                              // packed: the scale in bf16
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// byte offset of 16-byte chunk c of row r in a tile of RB-byte swizzled rows
template <int RB>
__device__ __forceinline__ uint32_t swz_rows(int r, int c) {
  return RB == 128 ? swz(r, c)
                   : static_cast<uint32_t>(r * 64 + ((c ^ ((r >> 1) & 3))
                                                     << 4));
}

// 2^x (ex2.approx: within 2 ulp; a result below 2^-126 flushes to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a bf16 pair times m, rounded to bf16 (the product of two bf16 values is
// exact in float32, so this is the reference's one rounding)
__device__ __forceinline__ uint32_t scale_pair(uint32_t v, float m) {
  return pack_bf16(lo_f(v) * m, hi_f(v) * m);
}

// ROWS rows x D columns at t, in a tile of column blocks of N swizzled
// rows of RB bytes, times m in bf16, by `threads` threads from index i0
template <int D, int N, int ROWS = N>
__device__ __forceinline__ void scale_tile(unsigned char* t, float m, int i0,
                                           int threads) {
  constexpr int RB = FlashPlan<D>::kRowBytes;
#pragma unroll
  for (int cb = 0; cb < FlashPlan<D>::kColBlocks; ++cb) {
    uint4* v = reinterpret_cast<uint4*>(t + cb * N * RB);
    for (int i = i0; i < ROWS * RB / 16; i += threads) {
      uint4 x = v[i];
      x.x = scale_pair(x.x, m);
      x.y = scale_pair(x.y, m);
      x.z = scale_pair(x.z, m);
      x.w = scale_pair(x.w, m);
      v[i] = x;
    }
  }
}

// Grid (B H, q-tiles of 128 rows), the longest q-tiles first; block
// kFThreads, two warpgroups; thread 0 also issues the loads. A thread
// holds, of each 8-column block j of an m64nN accumulator, rows 16 w + g
// and + 8 (r 0, 1) of its warpgroup's 64 and columns 8 j + 2 t and + 1
// (e 0, 1): element [4 j + 2 r + e].
template <int D>
__global__ void __launch_bounds__(kFThreads, FlashPlan<D>::kBlocks)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to,
                       const FlashArgs p) {
  using P = FlashPlan<D>;
  constexpr int RB = P::kRowBytes, CB = P::kColBlocks, S = kFStages;
  constexpr int SBO = 8 * RB;                  // between 8-row groups
  constexpr int KSTEPS = RB / 32;              // k16 steps a column block
  extern __shared__ unsigned char dyn[];
  unsigned char* smem = align1024(dyn);
  unsigned char* qs = smem;                    // [CB][kFRows][RB]
  unsigned char* kv = smem + P::kQ;            // stage s: K, then V
  __shared__ __align__(8) uint64_t qbar, fullk[S], fullv[S], empty[S];

  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int nq = (p.sq + kFRows - 1) / kFRows;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kFRows;
  const int col0 = p.packed ? h * D : 0, z = p.packed ? b : bh;
  const int nk = (p.sk + kFKeys - 1) / kFKeys;
  // key tiles the 64 rows from r0 visit: all, or through the one holding
  // their last row's diagonal when causal; none past the array
  auto tiles = [&](int r0) {
    if (r0 >= p.sq) return 0;
    return p.causal ? min(nk, (min(r0 + 63, p.sq - 1)) / kFKeys + 1) : nk;
  };
  const int n_blk = max(tiles(q0), tiles(q0 + 64));

  if (threadIdx.x == 0) {
    mbar_init(&qbar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&fullk[s], 1);
      mbar_init(&fullv[s], 1);
      mbar_init(&empty[s], kFThreads / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // K and V of tile kt into stage kt mod S (thread 0)
  auto load_kv = [&](int kt) {
    const int s = kt % S;
    unsigned char* st = kv + s * 2 * P::kKV;
    mbar_expect_tx(&fullk[s], P::kKV);
#pragma unroll
    for (int cb = 0; cb < CB; ++cb)
      tma_load_3d(st + cb * kFKeys * RB, &tk, &fullk[s],
                  col0 + cb * P::kBoxCols, kt * kFKeys, z);
    mbar_expect_tx(&fullv[s], P::kKV);
#pragma unroll
    for (int cb = 0; cb < CB; ++cb)
      tma_load_3d(st + P::kKV + cb * kFKeys * RB, &tv, &fullv[s],
                  col0 + cb * P::kBoxCols, kt * kFKeys, z);
  };
  // at tile kt (kt >= 1): tile kt - 1 + S into the stage tile kt - 1 held,
  // once all eight warps have released it
  auto produce = [&](int kt) {
    if (threadIdx.x == 0 && kt >= 1 && kt - 1 + S < n_blk) {
      mbar_wait(&empty[(kt - 1) % S], ((kt - 1) / S) & 1);
      load_kv(kt - 1 + S);
    }
  };
  if (threadIdx.x == 0) {
    tma_prefetch(&tq);
    tma_prefetch(&tk);
    tma_prefetch(&tv);
    mbar_expect_tx(&qbar, P::kQ);
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int cb = 0; cb < CB; ++cb)
        tma_load_3d(qs + cb * kFRows * RB + half * 64 * RB, &tq, &qbar,
                    col0 + cb * P::kBoxCols, q0 + 64 * half, z);
    for (int kt = 0; kt < min(S, n_blk); ++kt) load_kv(kt);
  }

  const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 64 * wg;                 // the warpgroup's first row
  const int row = r0 + 16 * w + g;             // this thread's rows: + 8 r
  const int n_own = tiles(r0);
  unsigned char* qw = qs + wg * 64 * RB;       // its Q rows, column block 0

  mbar_wait(&qbar, 0);
  if (p.packed) {                              // q * bf16(scale) in bf16
    scale_tile<D, kFRows, 64>(qw, p.q_mul, threadIdx.x & 127, 128);
    fence_async_smem();
    named_sync(2 + wg, 128);
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float s[32];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // the operands' descriptors: this warpgroup's Q rows, stage 0's K and
  // V; a k16 step, a column block or a stage adds its byte offset / 16 to
  // the address field (every address stays below 256 KB)
  const uint64_t dq = desc_swz(qw, 16, SBO, P::kMode);
  const uint64_t dk = desc_swz(kv, 16, SBO, P::kMode);
  const uint64_t dv = desc_swz(kv + P::kKV, kFKeys * RB, SBO, P::kMode);
  // S = Q.K^T of tile kt into s, issued and committed as one group
  auto issue_s = [&](int kt) {
    const uint32_t st_off = (kt % S) * (2 * P::kKV / 16);
    wgmma_fence();
    fence_regs(s);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int cb = ks / KSTEPS, off = (ks % KSTEPS) * 32;
      wgmma_ss<0, 0>(s, dq + (cb * kFRows * RB + off) / 16,
                     dk + st_off + (cb * kFKeys * RB + off) / 16, ks > 0);
    }
    wgmma_commit();
    fence_regs(s);
  };
  // this warp is done with stage st
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  };

  if (n_own > 0) {
    mbar_wait(&fullk[0], 0);
    issue_s(0);
    wgmma_wait<0>();
    fence_regs(s);
  }
  for (int kt = 0; kt < n_blk; ++kt) {
    const int st = kt % S;
    const uint32_t par = (kt / S) & 1;
    if (kt >= n_own) {                         // past this warpgroup's rows
      mbar_wait(&fullk[st], par);
      release(st);
      produce(kt);
      continue;
    }
    const int k0 = kt * kFKeys;
    // only a tile across the diagonal or the keys' end masks: a column
    // past last[r], this thread's row's last key (causal) or the keys' end
    if ((p.causal && k0 + kFKeys - 1 > r0 + 16 * w) || k0 + kFKeys > p.sk) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int last = p.causal ? min(row + 8 * r, p.sk - 1) : p.sk - 1;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (k0 + 8 * j + 2 * t + e > last) s[4 * j + 2 * r + e] = kNegInf;
      }
    }
    // the row max and sum, each over four partial accumulators a row
    // (short dependency chains; max is exact in any order)
    float mx[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mx[r][i] = fmaxf(fmaxf(s[8 * i + 2 * r], s[8 * i + 2 * r + 1]),
                         fmaxf(s[8 * i + 4 + 2 * r], s[8 * i + 5 + 2 * r]));
    float corr[2], ml[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float m_new = fmaxf(m[r], x);
      corr[r] = exp2_approx((m[r] - m_new) * p.s_l2);
      m[r] = m_new;
      ml[r] = m_new * p.s_l2;
    }
    float ps[2][4] = {};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pv = exp2_approx(fmaf(s[4 * j + 2 * r + e], p.s_l2,
                                            -ml[r]));
          s[4 * j + 2 * r + e] = pv;
          ps[r][j & 3] += pv;
        }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l[r] = l[r] * corr[r] + ((ps[r][0] + ps[r][1]) + (ps[r][2] + ps[r][3]));
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }
    // P in bf16 as wgmma's A fragments, one a 16-key step
    uint32_t pf[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        pf[ks][q] = pack_bf16(s[8 * ks + 2 * q], s[8 * ks + 2 * q + 1]);

    mbar_wait(&fullv[st], par);
    const uint64_t dvs = dv + st * (2 * P::kKV / 16);
    wgmma_fence();
    fence_regs(o);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_rs<1>(o, pf[ks], dvs + ks * 16 * RB / 16);
    wgmma_commit();
    produce(kt);
    if (kt + 1 < n_own) {
      mbar_wait(&fullk[(kt + 1) % S], ((kt + 1) / S) & 1);
      issue_s(kt + 1);
    }
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(s);
    release(st);
  }

  // the row sums over the quad; out = O / l (times the reciprocal),
  // rounded to bf16 over the warpgroup's own Q rows (its last S is done
  // with them), then stored by TMA one column block at a time (rows past
  // sq are not written)
  float ls[2], inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    ls[r] = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f / ls[r];
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    const int cb = c / P::kBoxCols, ch = (c % P::kBoxCols) >> 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = 64 * wg + 16 * w + g + 8 * r;
      *reinterpret_cast<uint32_t*>(qs + cb * kFRows * RB +
                                   swz_rows<RB>(rr, ch) + 4 * t) =
          pack_bf16(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
    }
  }
  fence_async_smem();
  named_sync(2 + wg, 128);
  if ((threadIdx.x & 127) == 0 && r0 < p.sq) {
#pragma unroll
    for (int cb = 0; cb < CB; ++cb)
      tma_store_3d(&to, qw + cb * kFRows * RB, col0 + cb * P::kBoxCols, r0,
                   z);
    bulk_wait_read();
  }
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = row + 8 * r;
      if (rr < p.sq)
        p.lse[b * p.l_sb + h * p.l_sh + rr * p.l_sr] =
            m[r] * p.s_mul + logf(ls[r]);
    }
  }
}

// ============================================================== backward
// The two passes of the reference's backward from the forward's lse and
// delta = sum(dout * out) per row, in the rounding points of
// flash_attention.cu's bf16 kernels: the packed query scaled once in bf16,
// P = exp(S s_mul - lse) (masked entries 0), dS = P (dP - delta) (times
// the scale head-major) rounded to bf16, P rounded to bf16 before dV, every
// product accumulated in float32, dq times the scale at the end (packed).
// No atomics: every output element is written by one block, its sums in a
// fixed order, so two calls give the same bits.
//
// What bounds the pair on an H100: at the training shape the bytes (q, k,
// v, dout, lse and delta read once, dq, dk and dv written once: 0.053 ms at
// 3.35 TB/s) against 0.033 ms of products (10 d flops a causal pair) at
// the bf16 peak; the two passes each compute S and dP, so that neither
// needs atomics. The kernels:
//   flash_bwd_dq_wgmma_kernel   a block is 128 query rows in two
//     warpgroups of 64; Q and dO loaded once, K/V tiles of 64 keys through
//     a ring of kBStages stages (thread 0 issues the loads, as in the
//     forward); per tile S = Q.K^T and dP = dO.V^T on wgmma from shared
//     memory (K-major), then dS in registers, rounded, as wgmma's register
//     A operand against K read MN-major: dQ += dS.K. The rows' lse and
//     delta stay in registers. Causal: through the block's last row's
//     diagonal.
//   flash_bwd_dkv_wgmma_kernel  a block is 128 keys in two warpgroups of
//     64; K and V loaded once, tiles of 64 queries of Q and dO through the
//     ring, their lse and delta copied beside them by warp 0 (cp.async of
//     4 bytes, the packed layout's rows being H floats apart) onto the Q
//     tile's mbarrier; per tile S^T = K.Q^T and dP^T = V.dO^T, then P^T and
//     dS^T with lse and delta per column, and dV += P^T.dO, dK += dS^T.Q
//     with dO and Q read MN-major (Q the scaled one, packed: dK = dS^T
//     (q scale)). Causal: from the tile holding the block's first key's
//     diagonal.
// Both warpgroups walk the same tiles and a tile's masked entries are
// zeroed (a warpgroup whose rows a tile does not reach adds zeros), so
// every part of a tile is one product group a warpgroup, with the next
// part's S and dP issued behind it. Rows past T read zero and their P is
// masked (dk/dv) or never stored (dq). Registers set the blocks an SM: up
// to d 64 two (128 registers a thread) hold the accumulators (dQ, or dK
// and dV) with S and dP of a part of the tile only, 32 keys (dq, d 64), 32
// or 16 queries (dk/dv, d 32 or 64), where the whole 64-wide tile spills
// (and dk/dv's 32-query parts at d 64); at d 128 one block (the tile
// whole: dk/dv 250 registers).
constexpr int kBStages = 3;

template <int D>
struct FlashBwdPlan {
  static constexpr int kRowBytes = FlashPlan<D>::kRowBytes;
  static constexpr int kBoxCols = FlashPlan<D>::kBoxCols;
  static constexpr int kColBlocks = FlashPlan<D>::kColBlocks;
  static constexpr uint32_t kMode = FlashPlan<D>::kMode;
  static constexpr int kOwn = kFRows * D * 2;      // 128 rows of Q, dO, K, V
  static constexpr int kTile = kFKeys * D * 2;     // 64 rows streamed
  static constexpr int kSmem = 2 * kOwn + kBStages * 2 * kTile + 1024;
  // blocks an SM, and the columns of one S (dP) product: keys (dq) or
  // queries (dk/dv) of the streamed tile, all 64 of them or a part, so
  // that two blocks an SM fit 128 registers a thread up to d 64
  static constexpr int kDqBlocks = D <= 64 ? 2 : 1;
  static constexpr int kDqCols = D == 64 ? 32 : 64;
  static constexpr int kDkvBlocks = D <= 64 ? 2 : 1;
  static constexpr int kDkvCols = D == 32 ? 32 : D == 64 ? 16 : 64;
  static_assert(kDqBlocks * (kSmem + 2048) <= 228 * 1024 &&
                kDkvBlocks * (kSmem + 2048) <= 228 * 1024, "the blocks fit");
};

// added to a K-major descriptor (LBO 16) of a tile of 64-row column blocks
// of RB-byte rows: the same tile read MN-major (LBO, bits 16-29, the
// blocks' distance)
template <int RB>
constexpr uint64_t kMnLbo = static_cast<uint64_t>(kFKeys * RB / 16 - 1)
                            << 16;

// 4 bytes global -> shared, asynchronously; `bytes` 0 writes a zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

// an arrival on bar once this thread's cp.async copies have landed (the
// barrier's count includes it)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Grid (B H, q-tiles of 128 rows), the longest q-tiles first; block
// kFThreads. Fragment layout as in the forward.
template <int D>
__global__ void __launch_bounds__(kFThreads, FlashBwdPlan<D>::kDqBlocks)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tdq,
                          const FlashArgs p) {
  using P = FlashBwdPlan<D>;
  constexpr int RB = P::kRowBytes, CB = P::kColBlocks, S = kBStages;
  constexpr int SBO = 8 * RB;                  // between 8-row groups
  constexpr int KSTEPS = RB / 32;              // k16 steps a column block
  extern __shared__ unsigned char dyn[];
  unsigned char* smem = align1024(dyn);
  unsigned char* qs = smem;                    // [CB][kFRows][RB]
  unsigned char* dos = smem + P::kOwn;         // dO, the same
  unsigned char* kv = smem + 2 * P::kOwn;      // stage s: K, then V
  __shared__ __align__(8) uint64_t qbar, fullk[S], fullv[S], empty[S];

  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int nq = (p.sq + kFRows - 1) / kFRows;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kFRows;
  const int col0 = p.packed ? h * D : 0, z = p.packed ? b : bh;
  const int nk = (p.sk + kFKeys - 1) / kFKeys;
  // key tiles: all, or through the block's last row's diagonal
  const int n_blk =
      p.causal ? min(nk, (min(q0 + kFRows, p.sq) - 1) / kFKeys + 1) : nk;

  if (threadIdx.x == 0) {
    mbar_init(&qbar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&fullk[s], 1);
      mbar_init(&fullv[s], 1);
      mbar_init(&empty[s], kFThreads / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // K and V of tile kt into stage kt mod S (thread 0)
  auto load_kv = [&](int kt) {
    const int s = kt % S;
    unsigned char* st = kv + s * 2 * P::kTile;
    mbar_expect_tx(&fullk[s], P::kTile);
#pragma unroll
    for (int cb = 0; cb < CB; ++cb)
      tma_load_3d(st + cb * kFKeys * RB, &tk, &fullk[s],
                  col0 + cb * P::kBoxCols, kt * kFKeys, z);
    mbar_expect_tx(&fullv[s], P::kTile);
#pragma unroll
    for (int cb = 0; cb < CB; ++cb)
      tma_load_3d(st + P::kTile + cb * kFKeys * RB, &tv, &fullv[s],
                  col0 + cb * P::kBoxCols, kt * kFKeys, z);
  };
  // at tile kt (kt >= 1): tile kt - 1 + S into the stage tile kt - 1 held
  auto produce = [&](int kt) {
    if (threadIdx.x == 0 && kt >= 1 && kt - 1 + S < n_blk) {
      mbar_wait(&empty[(kt - 1) % S], ((kt - 1) / S) & 1);
      load_kv(kt - 1 + S);
    }
  };
  if (threadIdx.x == 0) {
    tma_prefetch(&tq);
    tma_prefetch(&tk);
    tma_prefetch(&tv);
    tma_prefetch(&tdo);
    mbar_expect_tx(&qbar, 2 * P::kOwn);
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) {
        const int at = cb * kFRows * RB + half * 64 * RB;
        tma_load_3d(qs + at, &tq, &qbar, col0 + cb * P::kBoxCols,
                    q0 + 64 * half, z);
        tma_load_3d(dos + at, &tdo, &qbar, col0 + cb * P::kBoxCols,
                    q0 + 64 * half, z);
      }
    for (int kt = 0; kt < min(S, n_blk); ++kt) load_kv(kt);
  }

  const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 64 * wg;                 // the warpgroup's first row
  const int row = r0 + 16 * w + g;             // this thread's rows: + 8 r
  unsigned char* qw = qs + wg * 64 * RB;       // its Q rows, column block 0
  // the rows' lse in base 2 and delta (rows past sq: 0, never stored)
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
    const long long at = b * p.l_sb + h * p.l_sh + rr * p.l_sr;
    l2[r] = rr < p.sq ? p.lse[at] * kLog2e : 0.f;
    dl[r] = rr < p.sq ? p.delta[at] : 0.f;
  }

  mbar_wait(&qbar, 0);
  if (p.packed) {                              // q * bf16(scale) in bf16
    scale_tile<D, kFRows, 64>(qw, p.q_mul, threadIdx.x & 127, 128);
    fence_async_smem();
    named_sync(2 + wg, 128);
  }

  constexpr int NH = P::kDqCols, PARTS = kFKeys / NH;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[NH / 2], dp[NH / 2];

  // descriptors: this warpgroup's Q rows (A, K-major; its dO rows kOwn
  // further), stage 0's K (B, K-major; V kTile further); dQ's B is K read
  // MN-major
  const uint64_t da = desc_swz(qw, 16, SBO, P::kMode);
  const uint64_t db = desc_swz(kv, 16, SBO, P::kMode);
  // S = Q.K^T and dP = dO.V^T of keys [NH part, NH part + NH) of tile kt,
  // issued and committed as one group
  auto issue_sdp = [&](int kt, int part) {
    const int st = kt % S;
    const uint32_t par = (kt / S) & 1;
    const uint32_t st_off = (st * 2 * P::kTile + part * NH * RB) / 16;
    if (part == 0) mbar_wait(&fullk[st], par);
    wgmma_fence();
    fence_regs(s);
    fence_regs(dp);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int cb = ks / KSTEPS, off = (ks % KSTEPS) * 32;
      wgmma_ss<0, 0>(s, da + (cb * kFRows * RB + off) / 16,
                     db + st_off + (cb * kFKeys * RB + off) / 16, ks > 0);
    }
    if (part == 0) mbar_wait(&fullv[st], par);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int cb = ks / KSTEPS, off = (ks % KSTEPS) * 32;
      wgmma_ss<0, 0>(dp, da + (P::kOwn + cb * kFRows * RB + off) / 16,
                     db + st_off + (P::kTile + cb * kFKeys * RB + off) / 16,
                     ks > 0);
    }
    wgmma_commit();
    fence_regs(s);
    fence_regs(dp);
  };

  issue_sdp(0, 0);                             // n_blk >= 1
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  for (int kt = 0; kt < n_blk; ++kt) {
    const int st = kt % S;
#pragma unroll
    for (int part = 0; part < PARTS; ++part) {
      const int k0 = kt * kFKeys + part * NH;
      // P, then dS = P (dP - delta) (times the scale head-major); only
      // keys across the diagonal or the keys' end mask
      const bool edge =
          (p.causal && k0 + NH - 1 > r0 + 16 * w) || k0 + NH > p.sk;
#pragma unroll
      for (int j = 0; j < NH / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * r + e;
            float pv = exp2_approx(fmaf(s[i], p.s_l2, -l2[r]));
            if (edge) {
              const int last = p.causal ? min(row + 8 * r, p.sk - 1)
                                        : p.sk - 1;
              if (k0 + 8 * j + 2 * t + e > last) pv = 0.f;
            }
            const float ds = pv * (dp[i] - dl[r]);
            s[i] = p.packed ? ds : ds * p.scale;
          }
      uint32_t dsf[NH / 16][4];
#pragma unroll
      for (int ks = 0; ks < NH / 16; ++ks)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          dsf[ks][q] = pack_bf16(s[8 * ks + 2 * q], s[8 * ks + 2 * q + 1]);
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int ks = 0; ks < NH / 16; ++ks)
        wgmma_rs<1>(acc, dsf[ks],
                    db + kMnLbo<RB> +
                        (st * 2 * P::kTile + (part * NH + 16 * ks) * RB) /
                            16);
      wgmma_commit();
      if (part == 0) produce(kt);
      if (part + 1 < PARTS)
        issue_sdp(kt, part + 1);
      else if (kt + 1 < n_blk)
        issue_sdp(kt + 1, 0);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(s);
      fence_regs(dp);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // dq (times the scale, packed), rounded to bf16 over the warpgroup's own
  // Q rows (its last S is done with them), stored by TMA (rows past sq
  // are not written)
  const float mul = p.packed ? p.scale : 1.f;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    const int cb = c / P::kBoxCols, ch = (c % P::kBoxCols) >> 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = 64 * wg + 16 * w + g + 8 * r;
      *reinterpret_cast<uint32_t*>(qs + cb * kFRows * RB +
                                   swz_rows<RB>(rr, ch) + 4 * t) =
          pack_bf16(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
    }
  }
  fence_async_smem();
  named_sync(2 + wg, 128);
  if ((threadIdx.x & 127) == 0 && r0 < p.sq) {
#pragma unroll
    for (int cb = 0; cb < CB; ++cb)
      tma_store_3d(&tdq, qw + cb * kFRows * RB, col0 + cb * P::kBoxCols, r0,
                   z);
    bulk_wait_read();
  }
}

// Grid (B H, k-tiles of 128 keys), the longest (first) k-tiles first;
// block kFThreads. A thread holds, of S^T's m64nQN accumulator, key rows
// 16 w + g and + 8 (r) of its warpgroup's 64 and query columns 8 j + 2 t
// and + 1 (e) of the tile: element [4 j + 2 r + e].
template <int D>
__global__ void __launch_bounds__(kFThreads, FlashBwdPlan<D>::kDkvBlocks)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tdk,
                           const __grid_constant__ CUtensorMap tdv,
                           const FlashArgs p) {
  using P = FlashBwdPlan<D>;
  constexpr int RB = P::kRowBytes, CB = P::kColBlocks, S = kBStages;
  constexpr int QN = kFKeys, T2 = P::kTile;
  constexpr int SBO = 8 * RB;
  constexpr int KSTEPS = RB / 32;
  extern __shared__ unsigned char dyn[];
  unsigned char* smem = align1024(dyn);
  unsigned char* ks = smem;                    // [CB][kFRows][RB] K
  unsigned char* vs = smem + P::kOwn;          // V, the same
  unsigned char* ring = smem + 2 * P::kOwn;    // stage s: Q, then dO
  __shared__ __align__(8) uint64_t kvbar, fullq[S], fulldo[S], empty[S];
  __shared__ __align__(16) float lse_s[S][QN], dl_s[S][QN];

  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int k0 = blockIdx.y * kFRows;
  const int col0 = p.packed ? h * D : 0, z = p.packed ? b : bh;
  // query tiles: all, or from the one holding the block's first key's
  // diagonal when causal (none when every query lies before it)
  const int qt0 = p.causal ? k0 / QN : 0;
  const int n_blk = max(0, (p.sq + QN - 1) / QN - qt0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(&kvbar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&fullq[s], 1 + 32);           // the TMA's and warp 0's
      mbar_init(&fulldo[s], 1);
      mbar_init(&empty[s], kFThreads / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // query tile i's Q, lse and delta, and dO into stage i mod S (warp 0:
  // lane 0 the TMA loads, every lane its rows' lse and delta)
  auto load_q = [&](int i) {
    const int s = i % S, q0 = (qt0 + i) * QN;
    unsigned char* st = ring + s * 2 * T2;
    if (lane == 0) {
      mbar_expect_tx(&fullq[s], T2);
#pragma unroll
      for (int cb = 0; cb < CB; ++cb)
        tma_load_3d(st + cb * QN * RB, &tq, &fullq[s],
                    col0 + cb * P::kBoxCols, q0, z);
      mbar_expect_tx(&fulldo[s], T2);
#pragma unroll
      for (int cb = 0; cb < CB; ++cb)
        tma_load_3d(st + T2 + cb * QN * RB, &tdo, &fulldo[s],
                    col0 + cb * P::kBoxCols, q0, z);
    }
    for (int r = lane; r < QN; r += 32) {
      const int rr = q0 + r;
      const long long at =
          rr < p.sq ? b * p.l_sb + h * p.l_sh + rr * p.l_sr : 0;
      cp_async4(&lse_s[s][r], p.lse + at, rr < p.sq ? 4 : 0);
      cp_async4(&dl_s[s][r], p.delta + at, rr < p.sq ? 4 : 0);
    }
    cp_async_arrive(&fullq[s]);
  };
  // at tile i (i >= 1): tile i - 1 + S into the stage tile i - 1 held,
  // once all eight warps have released it (warp 0)
  auto produce = [&](int i) {
    if (warp == 0 && i >= 1 && i - 1 + S < n_blk) {
      mbar_wait(&empty[(i - 1) % S], ((i - 1) / S) & 1);
      load_q(i - 1 + S);
    }
  };
  if (threadIdx.x == 0) {
    tma_prefetch(&tq);
    tma_prefetch(&tk);
    tma_prefetch(&tv);
    tma_prefetch(&tdo);
    mbar_expect_tx(&kvbar, 2 * P::kOwn);
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) {
        const int at = cb * kFRows * RB + half * 64 * RB;
        tma_load_3d(ks + at, &tk, &kvbar, col0 + cb * P::kBoxCols,
                    k0 + 64 * half, z);
        tma_load_3d(vs + at, &tv, &kvbar, col0 + cb * P::kBoxCols,
                    k0 + 64 * half, z);
      }
  }
  if (warp == 0)
    for (int i = 0; i < min(S, n_blk); ++i) load_q(i);

  const int wg = threadIdx.x >> 7, w = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int kw0 = k0 + 64 * wg;                // the warpgroup's first key
  const int key = kw0 + 16 * w + g;            // this thread's keys: + 8 r
  unsigned char* kw = ks + wg * 64 * RB;       // its K rows, column block 0
  unsigned char* vw = vs + wg * 64 * RB;

  constexpr int NH = P::kDkvCols, PARTS = QN / NH;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  float s[NH / 2], dp[NH / 2];

  // descriptors: this warpgroup's K rows (A, K-major; its V rows kOwn
  // further), stage 0's Q (B, K-major; dO T2 further); dK's and dV's B are
  // Q and dO read MN-major
  const uint64_t da = desc_swz(kw, 16, SBO, P::kMode);
  const uint64_t db = desc_swz(ring, 16, SBO, P::kMode);
  // S^T = K.Q^T and dP^T = V.dO^T of queries [NH part, NH part + NH) of
  // tile i, one group; packed, the block first scales the tile's Q in
  // place, in bf16
  auto issue_sdp = [&](int i, int part) {
    const int st = i % S;
    const uint32_t par = (i / S) & 1;
    const uint32_t st_off = (st * 2 * T2 + part * NH * RB) / 16;
    if (part == 0) {
      mbar_wait(&fullq[st], par);
      if (p.packed) {
        scale_tile<D, QN>(ring + st * 2 * T2, p.q_mul, threadIdx.x,
                          kFThreads);
        fence_async_smem();
        named_sync(1, kFThreads);
      }
    }
    wgmma_fence();
    fence_regs(s);
    fence_regs(dp);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int cb = kk / KSTEPS, off = (kk % KSTEPS) * 32;
      wgmma_ss<0, 0>(s, da + (cb * kFRows * RB + off) / 16,
                     db + st_off + (cb * QN * RB + off) / 16, kk > 0);
    }
    if (part == 0) mbar_wait(&fulldo[st], par);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int cb = kk / KSTEPS, off = (kk % KSTEPS) * 32;
      wgmma_ss<0, 0>(dp, da + (P::kOwn + cb * kFRows * RB + off) / 16,
                     db + st_off + (T2 + cb * QN * RB + off) / 16, kk > 0);
    }
    wgmma_commit();
    fence_regs(s);
    fence_regs(dp);
  };

  mbar_wait(&kvbar, 0);
  if (n_blk > 0) {
    issue_sdp(0, 0);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
  }
  for (int i = 0; i < n_blk; ++i) {
    const int st = i % S;
    const uint32_t st_off = st * (2 * T2 / 16);
#pragma unroll
    for (int part = 0; part < PARTS; ++part) {
      const int c0 = part * NH, q0 = (qt0 + i) * QN + c0;
      // P^T and dS^T; only queries past sq or across the diagonal mask (a
      // query past sq, or a key after its query)
      const bool edge = q0 + NH > p.sq || (p.causal && q0 < kw0 + 64);
#pragma unroll
      for (int j = 0; j < NH / 8; ++j) {
        const float2 lv = *reinterpret_cast<const float2*>(
            &lse_s[st][c0 + 8 * j + 2 * t]);
        const float2 dv2 = *reinterpret_cast<const float2*>(
            &dl_s[st][c0 + 8 * j + 2 * t]);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ix = 4 * j + 2 * r + e;
            float pv = exp2_approx(fmaf(s[ix], p.s_l2,
                                        -(e ? lv.y : lv.x) * kLog2e));
            if (edge) {
              const int qc = q0 + 8 * j + 2 * t + e;
              if (qc >= p.sq || (p.causal && key + 8 * r > qc)) pv = 0.f;
            }
            const float ds = pv * (dp[ix] - (e ? dv2.y : dv2.x));
            s[ix] = pv;
            dp[ix] = p.packed ? ds : ds * p.scale;
          }
      }
      uint32_t pf[NH / 16][4], dsf[NH / 16][4];
#pragma unroll
      for (int kk = 0; kk < NH / 16; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          pf[kk][q] = pack_bf16(s[8 * kk + 2 * q], s[8 * kk + 2 * q + 1]);
          dsf[kk][q] = pack_bf16(dp[8 * kk + 2 * q],
                                 dp[8 * kk + 2 * q + 1]);
        }
      wgmma_fence();
      fence_regs(dv);
      fence_regs(dk);
#pragma unroll
      for (int kk = 0; kk < NH / 16; ++kk)
        wgmma_rs<1>(dv, pf[kk], db + kMnLbo<RB> + st_off +
                                    (T2 + (c0 + 16 * kk) * RB) / 16);
#pragma unroll
      for (int kk = 0; kk < NH / 16; ++kk)
        wgmma_rs<1>(dk, dsf[kk], db + kMnLbo<RB> + st_off +
                                     (c0 + 16 * kk) * RB / 16);
      wgmma_commit();
      if (part == 0) produce(i);
      if (part + 1 < PARTS)
        issue_sdp(i, part + 1);
      else if (i + 1 < n_blk)
        issue_sdp(i + 1, 0);
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(s);
      fence_regs(dp);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // dK and dV rounded to bf16 over the warpgroup's own K and V rows (its
  // last products are done with them), stored by TMA (keys past sk are
  // not written)
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    const int cb = c / P::kBoxCols, ch = (c % P::kBoxCols) >> 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = 64 * wg + 16 * w + g + 8 * r;
      const uint32_t at = cb * kFRows * RB + swz_rows<RB>(rr, ch) + 4 * t;
      *reinterpret_cast<uint32_t*>(ks + at) =
          pack_bf16(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(vs + at) =
          pack_bf16(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
  fence_async_smem();
  named_sync(2 + wg, 128);
  if ((threadIdx.x & 127) == 0 && kw0 < p.sk) {
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) {
      tma_store_3d(&tdk, kw + cb * kFRows * RB, col0 + cb * P::kBoxCols,
                   kw0, z);
      tma_store_3d(&tdv, vw + cb * kFRows * RB, col0 + cb * P::kBoxCols,
                   kw0, z);
    }
    bulk_wait_read();
  }
}

// A 3-D bf16 map over (W, T, Z), W contiguous, T rows of W, Z planes of T
// rows; boxes of {D or 64 (128B swizzle), 64 rows, 1}, {32, 64, 1} with the
// 64B swizzle at d 32. Elements outside read 0 and are not written.
bool flash_map(CUtensorMap* map, const void* ptr, int D, long long W,
               long long T, long long Z) {
  EncodeTiled enc = tensor_map_encoder();
  if (!enc) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(Z)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(W) * 2,
                                 static_cast<cuuint64_t>(W * T) * 2};
  const cuuint32_t box[3] = {D >= 64 ? 64u : 32u,
                             static_cast<cuuint32_t>(kFKeys), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             D >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The arguments every launch takes, and the tensor maps' row width W and
// planes Zq, in layout 0 (packed (B, T, H*d), lse and delta (B, T, H)) or
// 1 (head-major (B, H, T, d), lse and delta (B, H, T))
FlashArgs flash_args(int layout, float* lse, const float* delta, int B,
                     int H, int sq, int sk, int d, int causal, float scale,
                     long long& W, long long& Zq) {
  FlashArgs p;
  p.lse = lse;
  p.delta = delta;
  p.H = H;
  p.sq = sq;
  p.sk = sk;
  p.causal = causal;
  p.packed = layout == 0;
  p.scale = scale;
  p.s_mul = p.packed ? 1.f : scale;
  p.s_l2 = p.s_mul * kLog2e;
  p.q_mul = __bfloat162float(__float2bfloat16_rn(scale));
  if (p.packed) {
    p.l_sb = static_cast<long long>(sq) * H; p.l_sh = 1; p.l_sr = H;
    W = static_cast<long long>(H) * d;
    Zq = B;
  } else {
    p.l_sb = static_cast<long long>(H) * sq; p.l_sh = sq; p.l_sr = 1;
    W = d;
    Zq = static_cast<long long>(B) * H;
  }
  return p;
}

// Sets the dynamic shared-memory limit of a kernel once, then launches it;
// returns the cudaError_t as int.
template <auto Kernel, typename... Maps>
int launch(int smem, dim3 grid, cudaStream_t st, const FlashArgs& p,
           const Maps&... maps) {
  static bool ready = false;                   // one flag per kernel
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  Kernel<<<grid, kFThreads, smem, st>>>(maps..., p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int run_wgmma(const void* q, const void* k, const void* v, void* out,
              long long W, long long Zq, const FlashArgs& p, int B,
              cudaStream_t st) {
  CUtensorMap tq, tk, tv, to;
  if (!flash_map(&tq, q, D, W, p.sq, Zq) ||
      !flash_map(&tk, k, D, W, p.sk, Zq) ||
      !flash_map(&tv, v, D, W, p.sk, Zq) ||
      !flash_map(&to, out, D, W, p.sq, Zq))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B * p.H, (p.sq + kFRows - 1) / kFRows);
  return launch<flash_fwd_wgmma_kernel<D>>(FlashPlan<D>::kSmem, grid, st, p,
                                           tq, tk, tv, to);
}

// dq (dkv 0) or dk and dv (dkv 1) of layout-mapped q, k, v, dout
template <int D>
int run_bwd(bool dkv, const void* q, const void* k, const void* v,
            const void* dout, void* o0, void* o1, long long W, long long Zq,
            const FlashArgs& p, int B, cudaStream_t st) {
  using P = FlashBwdPlan<D>;
  CUtensorMap tq, tk, tv, tdo, t0, t1;
  if (!flash_map(&tq, q, D, W, p.sq, Zq) ||
      !flash_map(&tk, k, D, W, p.sk, Zq) ||
      !flash_map(&tv, v, D, W, p.sk, Zq) ||
      !flash_map(&tdo, dout, D, W, p.sq, Zq) ||
      !flash_map(&t0, o0, D, W, dkv ? p.sk : p.sq, Zq) ||
      (dkv && !flash_map(&t1, o1, D, W, p.sk, Zq)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!dkv)
    return launch<flash_bwd_dq_wgmma_kernel<D>>(
        P::kSmem, dim3(B * p.H, (p.sq + kFRows - 1) / kFRows), st, p, tq,
        tk, tv, tdo, t0);
  return launch<flash_bwd_dkv_wgmma_kernel<D>>(
      P::kSmem, dim3(B * p.H, (p.sk + kFRows - 1) / kFRows), st, p, tq,
      tk, tv, tdo, t0, t1);
}

}  // namespace

// The bf16 backward's two passes: dq (dkv 0, o0 = dq) or dk and dv (dkv 1,
// o0 = dk, o1 = dv) of q, k, v, dout in layout 0 (packed (B, T, H*d), lse
// and delta (B, T, H) float32) or 1 (head-major (B, H, T, d), lse and delta
// (B, H, T)), from the forward's lse and delta = sum(dout * out) per row;
// d 32, 64 or 128; every pointer 16-byte aligned. Returns a cudaError_t as
// int.
int flash_bwd_sm90_launch(int dkv, int layout, const void* q, const void* k,
                          const void* v, const void* dout, const float* lse,
                          const float* delta, void* o0, void* o1, int B,
                          int H, int sq, int sk, int d, int causal,
                          float scale, void* stream) {
  if (B < 0 || H < 1 || sq < 0 || sk < 0 || (layout != 0 && layout != 1) ||
      (dkv != 0 && dkv != 1) || static_cast<long long>(B) * H > INT_MAX ||
      (sq + kFRows - 1) / kFRows > 65535 ||
      (sk + kFRows - 1) / kFRows > 65535 || !q || !k || !v || !dout ||
      !lse || !delta || !o0 || (dkv && !o1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || sq == 0 || sk == 0) return 0;
  long long W, Zq;
  // lse is only read here; the forward's writes it
  const FlashArgs p = flash_args(layout, const_cast<float*>(lse), delta, B,
                                 H, sq, sk, d, causal, scale, W, Zq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return run_bwd<32>(dkv, q, k, v, dout, o0, o1, W, Zq, p, B, st);
    case 64: return run_bwd<64>(dkv, q, k, v, dout, o0, o1, W, Zq, p, B, st);
    case 128:
      return run_bwd<128>(dkv, q, k, v, dout, o0, o1, W, Zq, p, B, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 forward: out and lse of q, k, v in layout 0 (packed (B, T, H*d),
// lse (B, T, H)) or 1 (head-major (B, H, T, d), lse (B, H, T)); d 32, 64 or
// 128; every pointer 16-byte aligned. Returns a cudaError_t as int.
int flash_fwd_sm90_launch(int layout, const void* q, const void* k,
                          const void* v, void* out, float* lse, int B, int H,
                          int sq, int sk, int d, int causal, float scale,
                          void* stream) {
  if (B < 0 || H < 1 || sq < 0 || sk < 0 || (layout != 0 && layout != 1) ||
      static_cast<long long>(B) * H > INT_MAX ||
      (sq + kFRows - 1) / kFRows > 65535 || !q || !k || !v || !out || !lse)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || sq == 0 || sk == 0) return 0;
  long long W, Zq;
  const FlashArgs p = flash_args(layout, lse, nullptr, B, H, sq, sk, d,
                                 causal, scale, W, Zq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return run_wgmma<32>(q, k, v, out, W, Zq, p, B, st);
    case 64: return run_wgmma<64>(q, k, v, out, W, Zq, p, B, st);
    case 128: return run_wgmma<128>(q, k, v, out, W, Zq, p, B, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
