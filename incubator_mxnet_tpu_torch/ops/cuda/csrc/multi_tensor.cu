// The fused trainer step for Hopper (sm_90a): one launch updates every
// tensor of a table, one launch takes the all-finite census of their
// gradients, and one launch updates the active rows of a row-sparse
// gradient in place.
//
// Replaces no Pallas kernel. The reference's fused step
// (incubator_mxnet_tpu/optimizer/fused.py) is one XLA program over the
// whole parameter/grad/state tree:
//   multi_tensor_update_kernel  <-  FusedStepExecutor._tree_step (:149)
//       for each tensor: rescale, clip, the optimizer's update rule, and
//       the census select where(ok, new, old);
//   multi_tensor_all_finite_kernel  <-  _census (:184)
//       all(isfinite(g)) over every gradient of the step;
//   row_sparse_update_kernel  <-  row_slice_step (:54) / _row_sparse_step
//       the lazy update of the rows a row-sparse gradient names.
// Without it the port's step is one chain of elementwise ATen launches
// per tensor (161 tensors for ResNet-50): host time, not bytes.
//
// What bounds it on an H100: device-memory bytes. SGD with momentum in
// float32 reads w, g and mom and writes w and mom, 20 bytes a parameter
// for about 6 operations, far below the 295 operations a byte the card
// needs before arithmetic counts. The design: the host packs one 104-byte
// entry a tensor (its pointers, element count, first block and hypers,
// the hypers computed on the host exactly as Optimizer.fused_hypers and
// tensor_step take them) into a table that is copied to the device on the
// stream; a block owns kChunk elements of one tensor, found by a binary
// search over the entries' first blocks, and each thread keeps kIlp
// independent elements in flight. The hypers are launch data, never code:
// a new learning rate changes a table entry and builds nothing.
//
// Every operation is the one the per-parameter path (tensor_step) runs, in
// its order, rounded as PyTorch rounds it (each op computed in float32 and
// stored in the tensor's type), with no contraction to FMA (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), so a step equals the
// per-parameter step bit for bit. A Python scalar enters an op rounded to
// float32, as PyTorch rounds it.
//
// The census flag (one byte, 1 = every gradient finite) gates the updates:
// a block that reads 0 writes nothing, the where(ok, new, old) of the
// reference. The flag stays on the device; nothing here syncs the host.
#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIlp = 4;
constexpr long long kChunk = 16384;   // elements a block (multiple of kThreads * kIlp)

// One tensor of the step (the Python side packs the same layout:
// ops/cuda/multi_tensor.py ENTRY_DTYPE).
struct MTEntry {
  unsigned long long w, g, s0, s1, master;
  long long n;
  int first_block;
  int code;
  float lr, wd, rescale, clip;
  float c[8];
};
static_assert(sizeof(MTEntry) == 104, "MTEntry is 104 bytes");

// the update rules (Python: multi_tensor.KINDS)
enum Kind { kSgd = 0, kSgdMom = 1, kNag = 2, kAdam = 3, kAdamW = 4 };
// storage: every tensor float32, float16 or bfloat16; or float16 weights
// and gradients with float32 master weights and states (multi_precision)
enum Code { kF32 = 0, kF16 = 1, kBF16 = 2, kF16Master = 3 };

template <typename T>
__device__ __forceinline__ float load(unsigned long long p, long long i);
template <>
__device__ __forceinline__ float load<float>(unsigned long long p,
                                             long long i) {
  return reinterpret_cast<const float*>(p)[i];
}
template <>
__device__ __forceinline__ float load<__half>(unsigned long long p,
                                              long long i) {
  return __half2float(reinterpret_cast<const __half*>(p)[i]);
}
template <>
__device__ __forceinline__ float load<__nv_bfloat16>(unsigned long long p,
                                                     long long i) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
}

template <typename T>
__device__ __forceinline__ void store(unsigned long long p, long long i,
                                      float v);
template <>
__device__ __forceinline__ void store<float>(unsigned long long p,
                                             long long i, float v) {
  reinterpret_cast<float*>(p)[i] = v;
}
template <>
__device__ __forceinline__ void store<__half>(unsigned long long p,
                                              long long i, float v) {
  reinterpret_cast<__half*>(p)[i] = __float2half_rn(v);
}
template <>
__device__ __forceinline__ void store<__nv_bfloat16>(unsigned long long p,
                                                     long long i, float v) {
  reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
}

// A float32 result as PyTorch leaves it in a tensor of type T.
template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__half>(float x) {
  return __half2float(__float2half_rn(x));
}
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// PyTorch's elementwise ops, each rounded to the arithmetic type S.
template <typename S>
struct Op {
  static __device__ __forceinline__ float mul(float a, float b) {
    return rnd<S>(__fmul_rn(a, b));
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return rnd<S>(__fadd_rn(a, b));
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return rnd<S>(__fsub_rn(a, b));
  }
  static __device__ __forceinline__ float div(float a, float b) {
    return rnd<S>(__fdiv_rn(a, b));
  }
  static __device__ __forceinline__ float sqrt(float a) {
    return rnd<S>(__fsqrt_rn(a));
  }
  // torch.clamp(g, -c, c) for c >= 0 (a NaN passes through); off below 0
  static __device__ __forceinline__ float clip(float g, float c) {
    if (!(c >= 0.f) || isnan(g)) return g;
    return rnd<S>(fminf(fmaxf(g, -c), c));
  }
};

// One element: w, g and the states as float32 values of their storage;
// the new weight and states replace w, s0 and s1. The hypers: lr, wd,
// rescale and clip (negative: off), and in c
//   SGD with momentum, NAG: c[0] momentum;
//   Adam: lr is the bias-corrected lr_t; c[0..4] beta1, 1 - beta1, beta2,
//     1 - beta2, epsilon;
//   AdamW: c[0..4] as Adam's, c[5] 1 / (1 - beta1^t), c[6]
//     1 / (1 - beta2^t).
template <int K, typename S>
__device__ __forceinline__ void update_one(const MTEntry& e, float& w,
                                           float g, float& s0, float& s1) {
  using O = Op<S>;
  const float gr = O::clip(O::mul(g, e.rescale), e.clip);
  if (K == kAdamW) {
    const float m = O::add(O::mul(e.c[0], s0), O::mul(e.c[1], gr));
    const float v = O::add(O::mul(e.c[2], s1), O::mul(e.c[3], O::mul(gr, gr)));
    const float mhat = O::mul(m, e.c[5]);
    const float vhat = O::mul(v, e.c[6]);
    const float upd = O::add(O::div(mhat, O::add(O::sqrt(vhat), e.c[4])),
                             O::mul(e.wd, w));
    w = O::sub(w, O::mul(e.lr, upd));
    s0 = m;
    s1 = v;
    return;
  }
  const float gw = O::add(gr, O::mul(e.wd, w));
  if (K == kSgd) {
    w = O::sub(w, O::mul(e.lr, gw));
  } else if (K == kSgdMom) {
    const float m = O::sub(O::mul(e.c[0], s0), O::mul(e.lr, gw));
    w = O::add(w, m);
    s0 = m;
  } else if (K == kNag) {
    const float m = O::add(O::mul(e.c[0], s0), gw);
    w = O::sub(w, O::mul(e.lr, O::add(gw, O::mul(e.c[0], m))));
    s0 = m;
  } else {  // kAdam
    const float m = O::add(O::mul(e.c[0], s0), O::mul(e.c[1], gw));
    const float v =
        O::add(O::mul(e.c[2], s1), O::mul(O::mul(e.c[3], gw), gw));
    w = O::sub(w, O::div(O::mul(e.lr, m), O::add(O::sqrt(v), e.c[4])));
    s0 = m;
    s1 = v;
  }
}

constexpr bool has_s0(int K) { return K != kSgd; }
constexpr bool has_s1(int K) { return K == kAdam || K == kAdamW; }

// Elements [lo, hi) of one entry. W is the weight's type, G the
// gradient's, S the arithmetic type (the states are S; with a master
// weight, S is float and the weight is written rounded to W).
template <int K, typename W, typename G, typename S, bool kMaster>
__device__ __forceinline__ void update_range(const MTEntry& e, long long lo,
                                             long long hi) {
  const unsigned long long wp = kMaster ? e.master : e.w;
  for (long long base = lo + threadIdx.x; base < hi;
       base += (long long)kThreads * kIlp) {
    float w[kIlp], g[kIlp], s0[kIlp], s1[kIlp];
#pragma unroll
    for (int j = 0; j < kIlp; ++j) {
      const long long i = base + (long long)j * kThreads;
      if (i < hi) {
        w[j] = load<S>(wp, i);
        g[j] = load<G>(e.g, i);
        s0[j] = has_s0(K) ? load<S>(e.s0, i) : 0.f;
        s1[j] = has_s1(K) ? load<S>(e.s1, i) : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < kIlp; ++j) {
      const long long i = base + (long long)j * kThreads;
      if (i < hi) {
        update_one<K, S>(e, w[j], g[j], s0[j], s1[j]);
        store<S>(wp, i, w[j]);
        if (kMaster) store<W>(e.w, i, w[j]);
        if (has_s0(K)) store<S>(e.s0, i, s0[j]);
        if (has_s1(K)) store<S>(e.s1, i, s1[j]);
      }
    }
  }
}

// The entry that owns block b: the last one whose first block is <= b.
__device__ __forceinline__ int entry_of(const MTEntry* t, int n, int b) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t[mid].first_block <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
multi_tensor_update_kernel(const MTEntry* __restrict__ table, int n_entries,
                           const unsigned char* __restrict__ flag) {
  if (flag != nullptr && *flag == 0) return;   // the census failed: skip
  const int k = entry_of(table, n_entries, blockIdx.x);
  const MTEntry e = table[k];
  const long long lo = (long long)(blockIdx.x - e.first_block) * kChunk;
  const long long hi = lo + kChunk < e.n ? lo + kChunk : e.n;
  switch (e.code) {
    case kF32:
      update_range<K, float, float, float, false>(e, lo, hi);
      break;
    case kF16:
      update_range<K, __half, __half, __half, false>(e, lo, hi);
      break;
    case kBF16:
      update_range<K, __nv_bfloat16, __nv_bfloat16, __nv_bfloat16, false>(
          e, lo, hi);
      break;
    default:   // kF16Master
      update_range<K, __half, __half, float, true>(e, lo, hi);
      break;
  }
}

template <typename G>
__device__ __forceinline__ int any_bad(unsigned long long g, long long lo,
                                       long long hi) {
  int bad = 0;
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads)
    bad |= !isfinite(load<G>(g, i));
  return bad;
}

// Each block checks its chunk and leaves its verdict in partial[block];
// the last block to finish (a ticket) folds the verdicts into the flag
// and leaves the ticket at 0 for the next launch.
__global__ void __launch_bounds__(kThreads)
multi_tensor_all_finite_kernel(const MTEntry* __restrict__ table,
                               int n_entries, int* partial,
                               unsigned int* ticket, unsigned char* flag) {
  const int k = entry_of(table, n_entries, blockIdx.x);
  const MTEntry e = table[k];
  const long long lo = (long long)(blockIdx.x - e.first_block) * kChunk;
  const long long hi = lo + kChunk < e.n ? lo + kChunk : e.n;
  int bad;
  switch (e.code) {
    case kF32: bad = any_bad<float>(e.g, lo, hi); break;
    case kBF16: bad = any_bad<__nv_bfloat16>(e.g, lo, hi); break;
    default: bad = any_bad<__half>(e.g, lo, hi); break;   // kF16, kF16Master
  }
  bad = __syncthreads_or(bad);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = bad;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  int any = 0;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads)
    any |= reinterpret_cast<volatile int*>(partial)[i];
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) {
    *flag = any ? 0 : 1;
    *ticket = 0;
  }
}

// One block a row id: the row's weight and states from the gradient row
// g[b] (w and the states (rows, width), g (n_ids, width)). An id >= rows
// is padding and updates nothing. Ids are unique (a row-sparse array's).
template <int K, typename S>
__global__ void __launch_bounds__(kThreads)
row_sparse_update_kernel(MTEntry e, const long long* __restrict__ ids,
                         long long rows, int width,
                         const unsigned char* __restrict__ flag) {
  if (flag != nullptr && *flag == 0) return;
  const long long row = ids[blockIdx.x];
  if (row < 0 || row >= rows) return;
  const long long wb = row * width, gb = (long long)blockIdx.x * width;
  for (int c = threadIdx.x; c < width; c += kThreads) {
    float w = load<S>(e.w, wb + c);
    float s0 = has_s0(K) ? load<S>(e.s0, wb + c) : 0.f;
    float s1 = has_s1(K) ? load<S>(e.s1, wb + c) : 0.f;
    update_one<K, S>(e, w, load<S>(e.g, gb + c), s0, s1);
    store<S>(e.w, wb + c, w);
    if (has_s0(K)) store<S>(e.s0, wb + c, s0);
    if (has_s1(K)) store<S>(e.s1, wb + c, s1);
  }
}

template <int K>
cudaError_t launch_update(const MTEntry* table, int n_entries, int n_blocks,
                          const unsigned char* flag, cudaStream_t s) {
  multi_tensor_update_kernel<K><<<n_blocks, kThreads, 0, s>>>(
      table, n_entries, flag);
  return cudaGetLastError();
}

template <int K, typename S>
cudaError_t launch_rows(const MTEntry& e, const long long* ids, int n_ids,
                        long long rows, int width,
                        const unsigned char* flag, cudaStream_t s) {
  row_sparse_update_kernel<K, S><<<n_ids, kThreads, 0, s>>>(
      e, ids, rows, width, flag);
  return cudaGetLastError();
}

template <typename S>
cudaError_t rows_by_kind(int kind, const MTEntry& e, const long long* ids,
                         int n_ids, long long rows, int width,
                         const unsigned char* flag, cudaStream_t s) {
  switch (kind) {
    case kSgd: return launch_rows<kSgd, S>(e, ids, n_ids, rows, width, flag, s);
    case kAdam: return launch_rows<kAdam, S>(e, ids, n_ids, rows, width, flag, s);
    case kAdamW: return launch_rows<kAdamW, S>(e, ids, n_ids, rows, width, flag, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

int multi_tensor_update_launch(int kind, const void* table, int n_entries,
                               int n_blocks, const void* flag, void* stream) {
  if (n_entries < 1 || n_blocks < 1) return cudaErrorInvalidValue;
  const MTEntry* t = static_cast<const MTEntry*>(table);
  const unsigned char* f = static_cast<const unsigned char*>(flag);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kSgd: return launch_update<kSgd>(t, n_entries, n_blocks, f, s);
    case kSgdMom: return launch_update<kSgdMom>(t, n_entries, n_blocks, f, s);
    case kNag: return launch_update<kNag>(t, n_entries, n_blocks, f, s);
    case kAdam: return launch_update<kAdam>(t, n_entries, n_blocks, f, s);
    case kAdamW: return launch_update<kAdamW>(t, n_entries, n_blocks, f, s);
    default: return cudaErrorInvalidValue;
  }
}

int multi_tensor_all_finite_launch(const void* table, int n_entries,
                                   int n_blocks, void* partial, void* ticket,
                                   void* flag, void* stream) {
  if (n_entries < 1 || n_blocks < 1) return cudaErrorInvalidValue;
  multi_tensor_all_finite_kernel<<<n_blocks, kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const MTEntry*>(table), n_entries,
      static_cast<int*>(partial), static_cast<unsigned int*>(ticket),
      static_cast<unsigned char*>(flag));
  return cudaGetLastError();
}

int row_sparse_update_launch(int kind, const void* entry, const void* ids,
                             int n_ids, long long rows, int width,
                             const void* flag, void* stream) {
  if (n_ids < 1 || width < 1) return cudaErrorInvalidValue;
  const MTEntry e = *static_cast<const MTEntry*>(entry);   // a host copy
  const long long* r = static_cast<const long long*>(ids);
  const unsigned char* f = static_cast<const unsigned char*>(flag);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (e.code) {
    case kF32: return rows_by_kind<float>(kind, e, r, n_ids, rows, width, f, s);
    case kF16: return rows_by_kind<__half>(kind, e, r, n_ids, rows, width, f, s);
    case kBF16:
      return rows_by_kind<__nv_bfloat16>(kind, e, r, n_ids, rows, width, f, s);
    default: return cudaErrorInvalidValue;
  }
}
