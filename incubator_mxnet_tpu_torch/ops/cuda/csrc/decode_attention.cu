// Decode-step attention for Hopper (sm_90a): one query row per (slot, head)
// against that slot's cached K/V, with the slot's valid length as the mask.
//
// Replaces the two Pallas TPU kernels of
// incubator_mxnet_tpu/ops/pallas/flash_attention.py:
//   decode_split_kernel<T, false>  <-  flash_decode_step / _decode_kernel
//       (contiguous cache, k/v (S, H, C, d))
//   decode_split_kernel<T, true>   <-  flash_decode_step_paged /
//       _paged_decode_kernel (page pool (n_pool, H, page_len, d) addressed
//       through the slot's block-table row)
// What they compute is the TPU kernels' _decode_attn_page walk: scores in
// f32 against the query pre-scaled in the input type, running max m,
// running sum l and accumulator acc in f32, softmax weights rounded to the
// input type before the P.V product, and the result acc / max(l, 1e-30).
//
// What bounds it on an H100: device-memory bytes. Each (slot, head) reads
// K and V for its `length` positions once (2 * sum(lengths) * H * d values)
// and does 4 flops per value, far below the ~295 flops/byte at which the
// tensor cores would become the limit. So the design is about parallelism
// and bytes in flight:
// * Split over the cache length (flash-decoding). A cell's span is cut
//   into tiles of whole rows, each inside one page (a tile of one head's
//   page, or of a slot-head's contiguous span, is one contiguous run of
//   memory), and a block takes a run of up to kSplitChunkTiles tiles. The
//   plan (tile rows, tiles a split, splits a cell) comes from static
//   shapes in the wrapper; lengths stay on the device, and a block whose
//   run starts at or past its slot's length exits at once. At the serving
//   lane (8 slots x 12 heads, cache 512, page 64, bf16, d 64) that is one
//   64-row tile a block, 768 blocks.
// * Every copy up front. The block reads its block-table entries, then one
//   thread issues every K and V tile of its run as 1-D bulk copies
//   (cp.async.bulk, no tensor map) that complete on one mbarrier each, so
//   V is in flight while the scores and the softmax of K run. Only the
//   valid rows of a tile are copied: a dead tail or a trash page costs no
//   bytes and contributes exactly zero weight.
// * One block barrier a tile. Scores go to shared memory; every warp then
//   reduces the tile's max itself (the same values in the same order, so m
//   agrees across the block); the row sum l, like acc, stays a per-thread
//   partial until one reduction at the end of the run.
// * A deterministic combine. A cell with one live split writes its output
//   directly. Otherwise each split writes (acc[d], m, l) in f32 to a
//   workspace, and the last live split of the cell to finish (counted
//   with an atomic ticket that it resets to zero, so a replayed CUDA graph
//   finds it zero) takes the partials in index order 0..n-1: rescaled by
//   exp(m_i - max m), summed in f32, rounded once. The result does not
//   depend on the order in which blocks finish, and no float atomic
//   touches the output. (A second launch for the combine measured slower
//   in a stream: it adds a kernel boundary.)
//
// decode_attn_kernel<T, kPaged> is the first design, kept as the yardstick
// behind the wrappers' private _route="simple": one block per (slot, head)
// walking the pages one after another, K loads then the softmax then V
// loads in each page.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90_gemm.cuh"

namespace {

constexpr float kNegInf = -1e30f;   // NEG_INF of the reference: NaN-free mask

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

// rounds through T: the reference scales q and casts the softmax weights in
// the input type, so the kernel does too
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// Grid: one block per (slot, head) cell, blockIdx.x = s * H + h.
// Block: 256 threads (8 warps). d is a power of two in [8, 256].
// Shared memory: q (d floats), one page of scores (block_k), a reduction
// buffer (one row of d per warp).
template <typename T, bool kPaged>
__global__ void decode_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out,
    const int* __restrict__ lengths, const int* __restrict__ block_tables,
    int H, int d, int block_k, int n_blocks, int n_pool, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* s_buf = q_s + d;
  float* red = s_buf + block_k;

  const int cell = blockIdx.x;
  const int s = cell / H;
  const int h = cell - s * H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  const int length = lengths[s];
  int nb = length > 0 ? (length + block_k - 1) / block_k : 0;
  nb = min(nb, n_blocks);

  const float scale_t = round_to<T>(scale);
  for (int i = tid; i < d; i += blockDim.x)
    q_s[i] = round_to<T>(to_float(q[(size_t)cell * d + i]) * scale_t);
  __syncthreads();

  // score layout: d/8 lanes per key row, 8 values each
  const int lpk = d >> 3;
  const int keys_per_warp = 32 / lpk;
  const int sub = lane / lpk;
  const int part = lane - sub * lpk;
  const int keys_per_pass = keys_per_warp * n_warps;
  float qreg[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) qreg[e] = q_s[part * 8 + e];

  // V rows are read in the same layout; acc[e] is this thread's partial
  // sum for output columns part * 8 + e over the keys its slot visits
  float m = kNegInf, l = 0.f;
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  for (int p = 0; p < nb; ++p) {
    const int n_valid = min(block_k, length - p * block_k);   // >= 1
    size_t base;
    if (kPaged) {
      int pid = block_tables[(size_t)s * n_blocks + p];
      pid = min(max(pid, 0), n_pool - 1);   // clamps like the reference
      base = ((size_t)pid * H + h) * (size_t)block_k * d;
    } else {
      base = ((size_t)cell * n_blocks + p) * (size_t)block_k * d;
    }
    const T* kp = k + base;
    const T* vp = v + base;

    // s_j = q_scaled . k_j for the page's valid rows
#pragma unroll 4
    for (int j0 = warp * keys_per_warp; j0 < n_valid; j0 += keys_per_pass) {
      const int j = j0 + sub;
      float dot = 0.f;
      if (j < n_valid) {
        float kr[8];
        load8(kp + (size_t)j * d + part * 8, kr);
#pragma unroll
        for (int e = 0; e < 8; ++e) dot += qreg[e] * kr[e];
      }
      for (int off = lpk >> 1; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (part == 0 && j < n_valid) s_buf[j] = dot;
    }
    __syncthreads();

    // online-softmax update; every warp reduces the same values in the
    // same order, so m and l agree across the block
    float mx = kNegInf;
    for (int j = lane; j < n_valid; j += 32) mx = fmaxf(mx, s_buf[j]);
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    __syncthreads();
    for (int j = tid; j < n_valid; j += blockDim.x)
      s_buf[j] = expf(s_buf[j] - m_new);
    __syncthreads();
    float ps = 0.f;
    for (int j = lane; j < n_valid; j += 32) ps += s_buf[j];
    for (int off = 16; off > 0; off >>= 1)
      ps += __shfl_xor_sync(0xffffffffu, ps, off);
    l = l * corr + ps;

#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] *= corr;
#pragma unroll 4
    for (int j0 = warp * keys_per_warp; j0 < n_valid; j0 += keys_per_pass) {
      const int j = j0 + sub;
      if (j < n_valid) {
        float vr[8];
        load8(vp + (size_t)j * d + part * 8, vr);
        const float pj = round_to<T>(s_buf[j]);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] += pj * vr[e];
      }
    }
    m = m_new;
    __syncthreads();   // s_buf is rewritten by the next page
  }

  // sum the key slots: lanes of a warp with the same `part`, then warps
  for (int off = lpk; off < 32; off <<= 1) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  }
  if (sub == 0) {
#pragma unroll
    for (int e = 0; e < 8; ++e) red[warp * d + part * 8 + e] = acc[e];
  }
  __syncthreads();
  for (int i = tid; i < d; i += blockDim.x) {
    float tot = 0.f;
    for (int w = 0; w < n_warps; ++w) tot += red[w * d + i];
    out[(size_t)cell * d + i] = from_float<T>(tot / fmaxf(l, 1e-30f));
  }
}

template <typename T, bool kPaged>
int launch(const void* q, const void* k, const void* v, void* out,
           const int* lengths, const int* block_tables, int S, int H, int d,
           int block_k, int n_blocks, int n_pool, float scale,
           cudaStream_t stream) {
  if (S * H == 0) return 0;
  constexpr int threads = 256;
  const size_t smem =
      (size_t)(d + block_k + (threads / 32) * d) * sizeof(float);
  decode_attn_kernel<T, kPaged><<<S * H, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lengths, block_tables,
      H, d, block_k, n_blocks, n_pool, scale);
  return static_cast<int>(cudaGetLastError());
}


// ------------------------------------------------------------ split route
// The plan's constants; the wrapper (flash_attention.py, _SPLIT_*) holds the
// same values and computes the plan from them.
constexpr int kSplitThreads = 128;       // 4 warps a block
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kSplitTileBytes = 8192;    // most bytes of one K (or V) tile
constexpr int kSplitChunkTiles = 4;      // most tiles a split
constexpr int kSplitTargetBlocks = 1056; // 132 SMs x 8 blocks
constexpr int kSplitBarBytes = 128;      // 2 * kSplitChunkTiles mbarriers
constexpr int kSmemLimit = 232448;       // 227 KB a block
static_assert(2 * kSplitChunkTiles * 8 <= kSplitBarBytes, "mbarriers");

struct SplitArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const int* lengths;
  const int* block_tables;   // (S, n_pages) for the paged pool
  float* ws;                 // (cells, n_split, d + 2): acc[d], m, l
  int* tickets;              // (cells,) zeros between launches
  int H, d, page_len, n_pages, n_pool;
  int tile_rows, tiles_per_page, tiles_per_split, n_split;
  float scale;
};

__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// a load issued where it stands (inline asm is not moved past the branch
// that follows it), so its latency overlaps the loads beside it
__device__ __forceinline__ int ld_early(const int* p) {
  int x;
  asm volatile("ld.global.nc.s32 %0, [%1];\n" : "=r"(x) : "l"(p));
  return x;
}

// splits of a cell whose first row lies below its length (0 for length 0)
__device__ __forceinline__ int live_splits(const SplitArgs& a, int length) {
  if (length <= 0) return 0;
  const int r = length - 1;
  const int t_last = (r / a.page_len) * a.tiles_per_page +
                     (r % a.page_len) / a.tile_rows;
  return t_last / a.tiles_per_split + 1;
}

// the combine of a cell's n_live >= 2 partials, in split order. Up to
// kCombineBatch partials are loaded at once (one round trip to L2); longer
// runs take two passes with the same arithmetic.
constexpr int kCombineBatch = 8;

template <typename T>
__device__ void combine_cell(const SplitArgs& a, int cell, int n_live) {
  const int d = a.d;
  const float* part = a.ws + (size_t)cell * a.n_split * (d + 2);
  T* out = static_cast<T*>(a.out) + (size_t)cell * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    float mx = kNegInf, l = 0.f, acc = 0.f;
    if (n_live <= kCombineBatch) {
      float mc[kCombineBatch], lc[kCombineBatch], ac[kCombineBatch];
#pragma unroll
      for (int c = 0; c < kCombineBatch; ++c) {
        if (c < n_live) {
          const float* pc = part + (size_t)c * (d + 2);
          mc[c] = __ldcg(pc + d);
          lc[c] = __ldcg(pc + d + 1);
          ac[c] = __ldcg(pc + i);
        }
      }
#pragma unroll
      for (int c = 0; c < kCombineBatch; ++c)
        if (c < n_live) mx = fmaxf(mx, mc[c]);
#pragma unroll
      for (int c = 0; c < kCombineBatch; ++c) {
        if (c < n_live) {
          const float w = expf(mc[c] - mx);
          l += w * lc[c];
          acc += w * ac[c];
        }
      }
    } else {
      for (int c = 0; c < n_live; ++c)
        mx = fmaxf(mx, __ldcg(part + (size_t)c * (d + 2) + d));
      for (int c = 0; c < n_live; ++c) {
        const float* pc = part + (size_t)c * (d + 2);
        const float w = expf(__ldcg(pc + d) - mx);
        l += w * __ldcg(pc + d + 1);
        acc += w * __ldcg(pc + i);
      }
    }
    out[i] = from_float<T>(acc / fmaxf(l, 1e-30f));
  }
}

// Grid: cells * n_split blocks, blockIdx.x = cell * n_split + split, where
// cell = s * H + h. Block: kSplitThreads. Dynamic shared memory:
// kSplitBarBytes of mbarriers, then tiles_per_split K tiles and as many V
// tiles (tile_rows * d values each), their scores (tile_rows floats each)
// and the end's reduction buffer (kSplitWarps rows of d + 1 floats).
template <typename T, bool kPaged>
__global__ void __launch_bounds__(kSplitThreads)
decode_split_kernel(const SplitArgs a) {
  extern __shared__ __align__(128) unsigned char split_smem[];
  const int d = a.d, R = a.tile_rows;
  const int cell = blockIdx.x / a.n_split;
  const int split = blockIdx.x - cell * a.n_split;
  const int s = cell / a.H;
  const int h = cell - s * a.H;
  const int tid = threadIdx.x;
  const int t0 = split * a.tiles_per_split;
  // the slot's length and this run's block-table entries are loaded
  // together, before anything waits on either
  const int len_raw = a.lengths[s];
  int pid[kSplitChunkTiles];
  if (kPaged && tid == 0) {
    const int n_tiles = a.n_pages * a.tiles_per_page;
#pragma unroll
    for (int i = 0; i < kSplitChunkTiles; ++i)
      pid[i] = ld_early(a.block_tables + (size_t)s * a.n_pages +
                        min(t0 + i, n_tiles - 1) / a.tiles_per_page);
  }
  const int length = min(max(len_raw, 0), a.n_pages * a.page_len);
  const int n_live = live_splits(a, length);
  T* out = static_cast<T*>(a.out) + (size_t)cell * d;
  if (split >= n_live) {
    if (split == 0)            // length 0 attends to nothing: zeros
      for (int i = tid; i < d; i += kSplitThreads) out[i] = from_float<T>(0.f);
    return;
  }

  // this split's tiles that hold valid rows: [t0, t0 + n_t)
  const int r_last = length - 1;
  const int t_last = (r_last / a.page_len) * a.tiles_per_page +
                     (r_last % a.page_len) / R;
  const int n_t = min(a.tiles_per_split, t_last + 1 - t0);
  const size_t tile_elems = (size_t)R * d;
  // mbarriers: K tile i at [i], V tile i at [kSplitChunkTiles + i]
  uint64_t* bars = reinterpret_cast<uint64_t*>(split_smem);
  T* k_s = reinterpret_cast<T*>(split_smem + kSplitBarBytes);
  T* v_s = k_s + (size_t)a.tiles_per_split * tile_elems;
  float* s_buf = reinterpret_cast<float*>(v_s + (size_t)a.tiles_per_split *
                                          tile_elems);
  float* red = s_buf + (size_t)a.tiles_per_split * R;

  if (tid == 0) {
    // every copy of the run, issued before any arithmetic
    if (kPaged) {
#pragma unroll
      for (int i = 0; i < kSplitChunkTiles; ++i)
        pid[i] = min(max(pid[i], 0), a.n_pool - 1);   // as the reference
    }
    for (int i = 0; i < n_t; ++i) {
      sm90::mbar_init(&bars[i], 1);
      sm90::mbar_init(&bars[kSplitChunkTiles + i], 1);
    }
    sm90::mbar_fence_init();
#pragma unroll
    for (int i = 0; i < kSplitChunkTiles; ++i) {
      if (i < n_t) {
        const int t = t0 + i;
        const int p = t / a.tiles_per_page;
        const int row0 = (t - p * a.tiles_per_page) * R;     // in the page
        const int n_valid = min(min(R, a.page_len - row0),
                                length - (p * a.page_len + row0));
        const size_t base =
            kPaged ? (((size_t)pid[i] * a.H + h) * a.page_len + row0) * d
                   : ((size_t)cell * a.page_len + row0) * d;
        const uint32_t bytes = (uint32_t)(n_valid * d * sizeof(T));
        sm90::mbar_expect_tx(&bars[i], bytes);
        sm90::bulk_load(k_s + i * tile_elems,
                        static_cast<const T*>(a.k) + base, bytes, &bars[i]);
        sm90::mbar_expect_tx(&bars[kSplitChunkTiles + i], bytes);
        sm90::bulk_load(v_s + i * tile_elems,
                        static_cast<const T*>(a.v) + base, bytes,
                        &bars[kSplitChunkTiles + i]);
      }
    }
  }

  // d/8 lanes per row, 8 values each; rows spread over the warps
  const int lane = tid & 31, warp = tid >> 5;
  const int lpk = d >> 3;
  const int keys_per_warp = 32 / lpk;
  const int sub = lane / lpk;
  const int part = lane - sub * lpk;
  const int keys_per_pass = keys_per_warp * kSplitWarps;
  const float scale_t = round_to<T>(a.scale);
  float qreg[8];
  load8(static_cast<const T*>(a.q) + (size_t)cell * d + part * 8, qreg);
#pragma unroll
  for (int e = 0; e < 8; ++e) qreg[e] = round_to<T>(qreg[e] * scale_t);
  __syncthreads();   // the mbarriers are initialised

  float m = kNegInf, l = 0.f;   // l: this thread's rows' share
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  for (int i = 0; i < n_t; ++i) {
    const int t = t0 + i;
    const int p = t / a.tiles_per_page;
    const int row0 = (t - p * a.tiles_per_page) * R;
    const int n_valid = min(min(R, a.page_len - row0),
                            length - (p * a.page_len + row0));
    const T* kt = k_s + i * tile_elems;
    const T* vt = v_s + i * tile_elems;
    float* sb = s_buf + i * R;

    sm90::mbar_wait(&bars[i], 0);
    for (int j0 = warp * keys_per_warp; j0 < n_valid; j0 += keys_per_pass) {
      const int j = j0 + sub;
      float dot = 0.f;
      if (j < n_valid) {
        float kr[8];
        load8(kt + (size_t)j * d + part * 8, kr);
#pragma unroll
        for (int e = 0; e < 8; ++e) dot += qreg[e] * kr[e];
      }
      for (int off = lpk >> 1; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (part == 0 && j < n_valid) sb[j] = dot;
    }
    __syncthreads();

    float mx = kNegInf;
    for (int j = lane; j < n_valid; j += 32) mx = fmaxf(mx, sb[j]);
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] *= corr;

    sm90::mbar_wait(&bars[kSplitChunkTiles + i], 0);
    for (int j0 = warp * keys_per_warp; j0 < n_valid; j0 += keys_per_pass) {
      const int j = j0 + sub;
      if (j < n_valid) {
        const float pj = expf(sb[j] - m_new);
        const float pr = round_to<T>(pj);
        float vr[8];
        load8(vt + (size_t)j * d + part * 8, vr);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] += pr * vr[e];
        if (part == 0) l += pj;
      }
    }
    m = m_new;
  }

  // sum the row slots: lanes with the same `part`, then warps
  for (int off = lpk; off < 32; off <<= 1) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  }
  for (int off = 16; off > 0; off >>= 1)
    l += __shfl_xor_sync(0xffffffffu, l, off);
  if (sub == 0) {
#pragma unroll
    for (int e = 0; e < 8; ++e) red[warp * d + part * 8 + e] = acc[e];
  }
  if (lane == 0) red[kSplitWarps * d + warp] = l;
  __syncthreads();
  float l_tot = 0.f;
  for (int w = 0; w < kSplitWarps; ++w) l_tot += red[kSplitWarps * d + w];
  if (n_live == 1) {
    for (int i = tid; i < d; i += kSplitThreads) {
      float tot = 0.f;
      for (int w = 0; w < kSplitWarps; ++w) tot += red[w * d + i];
      out[i] = from_float<T>(tot / fmaxf(l_tot, 1e-30f));
    }
    return;
  }
  float* mine = a.ws + ((size_t)cell * a.n_split + split) * (d + 2);
  for (int i = tid; i < d; i += kSplitThreads) {
    float tot = 0.f;
    for (int w = 0; w < kSplitWarps; ++w) tot += red[w * d + i];
    mine[i] = tot;
  }
  if (tid == 0) {
    mine[d] = m;
    mine[d + 1] = l_tot;
  }

  // the last live split of the cell to finish combines: thread 0
  // releases the block's partial (ordered after the other threads' writes
  // by the barrier) and takes a ticket; the last one acquires the others'
  __shared__ int last;
  __syncthreads();
  if (tid == 0) {
    fence_acq_rel_gpu();
    const int ticket = atomicAdd(&a.tickets[cell], 1);
    last = ticket == n_live - 1;
    if (last) {
      a.tickets[cell] = 0;     // zero again for the next launch
      fence_acq_rel_gpu();
    }
  }
  __syncthreads();
  if (!last) return;
  combine_cell<T>(a, cell, n_live);
}

size_t split_smem_bytes(int d, int tile_rows, int tiles_per_split,
                        int itemsize) {
  const size_t tile_bytes = (size_t)tile_rows * d * itemsize;
  return kSplitBarBytes +
         (size_t)tiles_per_split * (2 * tile_bytes + (size_t)tile_rows * 4) +
         (size_t)kSplitWarps * (d + 1) * 4;
}

template <typename T, bool kPaged>
int launch_split(SplitArgs a, int cells, cudaStream_t stream) {
  if (cells == 0) return 0;
  const size_t smem =
      split_smem_bytes(a.d, a.tile_rows, a.tiles_per_split, sizeof(T));
  if (a.tile_rows < 1 || a.tiles_per_split < 1 ||
      a.tiles_per_split > kSplitChunkTiles ||
      (size_t)a.tile_rows * a.d * sizeof(T) > kSplitTileBytes ||
      smem > kSmemLimit ||
      (a.n_split > 1 && (a.ws == nullptr || a.tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_split_kernel<T, kPaged>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_split_kernel<T, kPaged>
      <<<cells * a.n_split, kSplitThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t as int.
int decode_attention_launch(int paged, int dtype, const void* q,
                            const void* k, const void* v, void* out,
                            const int* lengths, const int* block_tables,
                            int S, int H, int d, int block_k, int n_blocks,
                            int n_pool, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return paged ? launch<float, true>(q, k, v, out, lengths, block_tables,
                                       S, H, d, block_k, n_blocks, n_pool,
                                       scale, st)
                 : launch<float, false>(q, k, v, out, lengths, block_tables,
                                        S, H, d, block_k, n_blocks, n_pool,
                                        scale, st);
  }
  if (dtype == 1) {
    return paged ? launch<__nv_bfloat16, true>(
                       q, k, v, out, lengths, block_tables, S, H, d,
                       block_k, n_blocks, n_pool, scale, st)
                 : launch<__nv_bfloat16, false>(
                       q, k, v, out, lengths, block_tables, S, H, d,
                       block_k, n_blocks, n_pool, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The split route. tickets: (S * H,) int32 zeros (each launch leaves them
// zero). ws: (S * H,
// n_split, d + 2) float32, or null when n_split is 1. Returns a
// cudaError_t as int.
int decode_split_launch(int paged, int dtype, const void* q, const void* k,
                        const void* v, void* out, const int* lengths,
                        const int* block_tables, float* ws, int* tickets,
                        int S, int H, int d, int page_len, int n_pages,
                        int n_pool, int tile_rows, int tiles_per_split,
                        int n_split, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  SplitArgs a{q, k, v, out, lengths, block_tables, ws, tickets, H, d,
              page_len, n_pages, n_pool, tile_rows,
              tile_rows > 0 ? (page_len + tile_rows - 1) / tile_rows : 0,
              tiles_per_split, n_split, scale};
  const int cells = S * H;
  if (dtype == 0)
    return paged ? launch_split<float, true>(a, cells, st)
                 : launch_split<float, false>(a, cells, st);
  if (dtype == 1)
    return paged ? launch_split<__nv_bfloat16, true>(a, cells, st)
                 : launch_split<__nv_bfloat16, false>(a, cells, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
