// Decode-step attention for Hopper (sm_90a): one query row per (slot, head)
// against that slot's cached K/V, with the slot's valid length as the mask.
//
// Replaces the two Pallas TPU kernels of
// incubator_mxnet_tpu/ops/pallas/flash_attention.py:
//   decode_attn_kernel<T, false>  <-  flash_decode_step / _decode_kernel
//       (contiguous cache, k/v (S, H, C, d), block_k-sized pages of the span)
//   decode_attn_kernel<T, true>   <-  flash_decode_step_paged /
//       _paged_decode_kernel (page pool (n_pool, H, page_len, d) addressed
//       through the slot's block-table row)
// Both walk the pages with the same online-softmax update as the TPU
// kernels' _decode_attn_page: scores in f32 against the query pre-scaled in
// the input type, running max m, running sum l and accumulator acc in f32,
// softmax weights rounded to the input type before the P.V product, and the
// result acc / max(l, 1e-30).
//
// What bounds it on an H100: device-memory bytes. Each (slot, head) reads
// K and V for its `length` positions once (2 * sum(lengths) * H * d values)
// and does 4 flops per value, far below the ~295 flops/byte at which the
// tensor cores would become the limit. The design therefore reads only what
// the mask keeps: the page loop stops at ceil(length / page), and inside the
// last partial page no row at or past `length` is loaded, so a trash page or
// a dead tail costs no bytes and contributes exactly zero weight. K and V
// rows are both read 16 bytes per lane (d/8 lanes per row, several rows per
// warp, a few rows in flight per thread), and the P.V partial sums stay in
// registers until one reduction at the end. The block table row is read by
// the block itself (Hopper has no scalar prefetch).
// One block per (slot, head) is the simple first design: at the serving
// shape (8 slots x 12 heads) that is 96 blocks on 132 SMs, so a split over
// the cache length is the next step for speed.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
