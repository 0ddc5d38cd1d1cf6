// The SSD detection-head kernels for Hopper (sm_90a): the training-target
// matcher and greedy non-maximum suppression. Both are selection ops: no
// gradient flows through them, and they define no backward.
//
// Replaces the Pallas TPU kernels of incubator_mxnet_tpu/ops/pallas/detection.py:
//   multibox_match_kernel  <-  multibox_match / _match_kernel
//       anchors (N, 4) and labels (B, M, 5) -> anchor_gt (B, N) int32,
//       anchor_iou (B, N) and loc_t (B, N, 4): the (M, N) IoU, M greedy
//       bipartite rounds, threshold matching, the loc encoding.
//   nms_mask_kernel, nms_sweep_kernel  <-  nms_keep / _nms_kernel
//       boxes (B, k, 4), ids (B, k), valid (B, k), rows score-descending
//       -> keep (B, k), ANDed with valid.
//
// Exactness. Both must give the plain PyTorch twins' answers bit for bit
// (ops/cuda/detection.py), ties included, so the IoU is computed in the
// reference's order with each step rounded on its own (__fadd_rn and
// kin): nvcc would otherwise contract a*b + c into an FMA, change the
// rounding, and with it the `> thr` and tie decisions. Only logf in the
// loc encoding is not correctly rounded.
//
// What bounds them on an H100: neither bytes nor flops. At the SSD-512
// lane the matcher moves ~4.4 MB (about 1.3 us at 3.35 TB/s) and the NMS
// ~0.4 MB; both are chains of dependent rounds (M greedy picks; k ordered
// suppressions), so they are latency-bound. The TPU kernel keeps the whole
// (M, N) IoU matrix in VMEM across the M rounds; at N 5630 one label row is
// 22.5 KB, so it does not fit shared memory for useful M. The designs:
//
// * multibox_match: one block per batch row. The anchors (90 KB at N 5630)
//   sit in shared memory when they fit, else they are read from global
//   memory. No IoU matrix is stored: each label keeps its best remaining
//   anchor (value, index), computed by one warp per label. A round takes
//   the best (value, flat index g * N + a) over the labels, the smallest
//   flat index winning a tie as jnp.argmax does, commits it if it is above
//   1e-12, and recomputes only the labels whose best anchor it just took.
//   A round that commits nothing ends the loop: later rounds would see the
//   same state. Stage 2 and the encoding run one thread per anchor, over
//   all M labels, the smallest label winning a tie.
// * nms_keep: two launches. The first builds the (k, k) suppression
//   bitmask, 64 columns j > i to a word, in global memory, 64 rows a block
//   over (ceil(k / 64), B) blocks, so the k^2 / 2 IoUs spread over the
//   card. The second sweeps the rows in order, one block per batch row: it
//   copies the row's mask into shared memory when it fits (k up to ~1280;
//   20 KB at k 400), then one warp ORs the row of every kept, valid box
//   into the removed set (each lane owns every 32nd word). The suppression
//   order is the reference's: a box suppresses only while itself kept and
//   valid. The sweep is the serial part: k dependent steps.
//
// The matcher launches 32 blocks at the lane (batch 32) on 132 SMs: a
// simple first design; splitting a row's IoU work across blocks is later
// work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Box {
  float x1, y1, x2, y2;
};

__device__ __forceinline__ Box load_box(const float* p) {
  return Box{p[0], p[1], p[2], p[3]};
}

__device__ __forceinline__ Box load_box(const float4* p) {
  const float4 v = *p;
  return Box{v.x, v.y, v.z, v.w};
}

__device__ __forceinline__ float box_area(const Box& b) {
  return __fmul_rn(__fsub_rn(b.x2, b.x1), __fsub_rn(b.y2, b.y1));
}

// The reference's corner IoU (ops/detection.py box_iou), op for op:
//   iw = max(min(lx2, rx2) - max(lx1, rx1), 0), ih alike, inter = iw * ih,
//   union = (area_l + area_r) - inter, iou = union > 0 ? inter / union : 0
__device__ __forceinline__ float pair_iou(const Box& l, const Box& r) {
  const float iw =
      fmaxf(__fsub_rn(fminf(l.x2, r.x2), fmaxf(l.x1, r.x1)), 0.f);
  const float ih =
      fmaxf(__fsub_rn(fminf(l.y2, r.y2), fmaxf(l.y1, r.y1)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(box_area(l), box_area(r)), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

// (value, index) order of an argmax that takes the first index of a tie
__device__ __forceinline__ bool better(float v, long long i, float bv,
                                       long long bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_best(float& v, long long& i) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const long long oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

constexpr long long kNone = 0x7fffffffffffffffLL;

// ------------------------------------------------------------ the matcher
struct MatchArgs {
  const float* anchors;   // (N, 4)
  const float* labels;    // (B, M, 5)
  int* scratch;           // (B, 3M) label state, when not in shared memory
  int* agt;               // (B, N)
  float* aiou;            // (B, N)
  float* loc;             // (B, N, 4)
  int N, M, anchors_in_smem;
  float thr, v0, v1, v2, v3;
};

// One warp: the best remaining anchor of label g (anchors taken by an
// earlier round are masked as -1, as in the reference), written by lane 0.
template <typename A>
__device__ void row_best(const A* anc, const float* lab, const int* agt,
                         int N, int g, float* best_v, int* best_i,
                         int lane) {
  const Box l = load_box(lab + (size_t)g * 5 + 1);
  float bv = -1.f;
  long long bi = kNone;
  for (int a = lane; a < N; a += 32) {
    if (agt[a] >= 0) continue;
    const float v = pair_iou(l, load_box(anc + a));
    if (better(v, a, bv, bi)) {
      bv = v;
      bi = a;
    }
  }
  warp_best(bv, bi);
  if (lane == 0) {
    best_v[g] = bv;
    best_i[g] = bi == kNone ? -1 : static_cast<int>(bi);
  }
}

template <typename A>
__device__ void match_body(const MatchArgs& p, const A* anc,
                           unsigned char* state) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, N = p.N, M = p.M;
  const float* lab = p.labels + (size_t)b * M * 5;
  int* agt = p.agt + (size_t)b * N;
  float* best_v = reinterpret_cast<float*>(state);
  int* best_i = reinterpret_cast<int*>(state) + M;
  int* done = reinterpret_cast<int*>(state) + 2 * M;
  __shared__ float s_v;
  __shared__ long long s_f;

  // invalid label rows (cls < 0) start done and never match in stage 1
  for (int g = tid; g < M; g += kThreads)
    done[g] = !(lab[(size_t)g * 5] >= 0.f);
  __syncthreads();
  for (int g = warp; g < M; g += kWarps)
    if (!done[g]) row_best(anc, lab, agt, N, g, best_v, best_i, lane);
  __syncthreads();

  // stage 1: greedy bipartite rounds
  for (int round = 0; round < M; ++round) {
    if (warp == 0) {
      float v = -1.f;
      long long f = kNone;
      for (int g = lane; g < M; g += 32) {
        if (done[g] || best_i[g] < 0) continue;
        const long long fg = (long long)g * N + best_i[g];
        if (better(best_v[g], fg, v, f)) {
          v = best_v[g];
          f = fg;
        }
      }
      warp_best(v, f);
      if (lane == 0) {
        s_v = v;
        s_f = f;
      }
    }
    __syncthreads();
    // a round that commits nothing changes nothing: neither will the rest
    if (!(s_v > 1e-12f)) break;
    const int g = static_cast<int>(s_f / N), a = static_cast<int>(s_f % N);
    if (tid == 0) {
      agt[a] = g;
      done[g] = 1;
    }
    __syncthreads();
    for (int r = warp; r < M; r += kWarps)
      if (!done[r] && best_i[r] == a)
        row_best(anc, lab, agt, N, r, best_v, best_i, lane);
    __syncthreads();
  }

  // stage 2 (threshold matching over each anchor's best label, invalid
  // rows counting as IoU 0) and the loc encoding
  float* aiou = p.aiou + (size_t)b * N;
  float* loc = p.loc + (size_t)b * N * 4;
  const float eps = 1e-12f;
  for (int a = tid; a < N; a += kThreads) {
    const Box ab = load_box(anc + a);
    float bv = 0.f;
    int bg = 0;
    for (int g = 0; g < M; ++g) {
      const float* lg = lab + (size_t)g * 5;
      const float v = lg[0] >= 0.f ? pair_iou(load_box(lg + 1), ab) : 0.f;
      if (g == 0 || v > bv) {
        bv = v;
        bg = g;
      }
    }
    const int m1 = agt[a];
    const int m = (m1 < 0 && bv > p.thr) ? bg : m1;
    agt[a] = m;
    aiou[a] = m1 >= 0 ? 1.f : bv;
    float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m >= 0) {
      const Box gb = load_box(lab + (size_t)m * 5 + 1);
      const float aw = __fsub_rn(ab.x2, ab.x1), ah = __fsub_rn(ab.y2, ab.y1);
      const float ax = __fmul_rn(__fadd_rn(ab.x1, ab.x2), 0.5f);
      const float ay = __fmul_rn(__fadd_rn(ab.y1, ab.y2), 0.5f);
      const float gw = __fsub_rn(gb.x2, gb.x1), gh = __fsub_rn(gb.y2, gb.y1);
      const float gx = __fmul_rn(__fadd_rn(gb.x1, gb.x2), 0.5f);
      const float gy = __fmul_rn(__fadd_rn(gb.y1, gb.y2), 0.5f);
      const float awe = __fadd_rn(aw, eps), ahe = __fadd_rn(ah, eps);
      out.x = __fdiv_rn(__fdiv_rn(__fsub_rn(gx, ax), awe), p.v0);
      out.y = __fdiv_rn(__fdiv_rn(__fsub_rn(gy, ay), ahe), p.v1);
      out.z = __fdiv_rn(logf(fmaxf(__fdiv_rn(gw, awe), eps)), p.v2);
      out.w = __fdiv_rn(logf(fmaxf(__fdiv_rn(gh, ahe), eps)), p.v3);
    }
    loc[(size_t)a * 4 + 0] = out.x;
    loc[(size_t)a * 4 + 1] = out.y;
    loc[(size_t)a * 4 + 2] = out.z;
    loc[(size_t)a * 4 + 3] = out.w;
  }
}

__global__ void __launch_bounds__(kThreads)
    multibox_match_kernel(MatchArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  int* agt = p.agt + (size_t)b * p.N;
  float4* anc_s = reinterpret_cast<float4*>(smem);
  for (int a = threadIdx.x; a < p.N; a += kThreads) {
    agt[a] = -1;
    if (p.anchors_in_smem) {
      const float* q = p.anchors + (size_t)a * 4;
      anc_s[a] = make_float4(q[0], q[1], q[2], q[3]);
    }
  }
  unsigned char* state =
      p.scratch
          ? reinterpret_cast<unsigned char*>(p.scratch + (size_t)b * 3 * p.M)
          : smem + (p.anchors_in_smem ? (size_t)p.N * 16 : 0);
  __syncthreads();
  if (p.anchors_in_smem)
    match_body(p, static_cast<const float4*>(anc_s), state);
  else
    match_body(p, reinterpret_cast<const float4*>(p.anchors), state);
}

// ---------------------------------------------------------------- the NMS
constexpr int kMaskRows = 64;          // rows of the mask one block builds
constexpr int kWordGroups = kThreads / kMaskRows;

// The (k, k) suppression bitmask of one batch row, kMaskRows rows a block:
// word (i, w) has bit t set when i suppresses j = 64 w + t, j > i. The
// threads of a warp share w and take consecutive i, so the boxes j they
// read are the same for the whole warp.
__global__ void __launch_bounds__(kThreads)
    nms_mask_kernel(const float* __restrict__ boxes,
                    const float* __restrict__ ids, int k, int W, float thr,
                    int force, unsigned long long* __restrict__ mask) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * kMaskRows + (threadIdx.x % kMaskRows);
  if (i >= k) return;
  const float* bx = boxes + (size_t)b * k * 4;
  const float* id = ids + (size_t)b * k;
  const Box bi = load_box(bx + (size_t)i * 4);
  const float idi = id[i];
  unsigned long long* row = mask + ((size_t)b * k + i) * W;
  for (int w = threadIdx.x / kMaskRows; w < W; w += kWordGroups) {
    const int j0 = w * 64;
    const int j_lo = j0 > i + 1 ? j0 : i + 1;
    const int j_hi = j0 + 64 < k ? j0 + 64 : k;
    unsigned long long bits = 0ull;
    for (int j = j_lo; j < j_hi; ++j) {
      bool sup = pair_iou(bi, load_box(bx + (size_t)j * 4)) >= thr;
      if (!force) sup = sup && id[j] == idi;
      if (sup) bits |= 1ull << (j - j0);
    }
    row[w] = bits;
  }
}

// The ordered sweep of one batch row: a kept, valid box removes the later
// boxes it covers. The block copies the row's mask into shared memory when
// it fits (mask_in_smem); then one warp sweeps, each lane owning every 32nd
// word of the removed set.
__global__ void __launch_bounds__(kThreads)
    nms_sweep_kernel(const unsigned char* __restrict__ valid, int k, int W,
                     int mask_in_smem,
                     const unsigned long long* __restrict__ g_mask,
                     unsigned char* __restrict__ keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, b = blockIdx.x;
  unsigned long long* removed = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* s_mask = removed + W;
  const unsigned long long* src = g_mask + (size_t)b * k * W;
  const unsigned long long* mask = mask_in_smem ? s_mask : src;
  unsigned char* val_s = reinterpret_cast<unsigned char*>(
      s_mask + (mask_in_smem ? (size_t)k * W : 0));
  for (int w = tid; w < W; w += kThreads) removed[w] = 0ull;
  for (int i = tid; i < k; i += kThreads)
    val_s[i] = valid[(size_t)b * k + i] != 0;
  if (mask_in_smem)
    for (long long e = tid; e < (long long)k * W; e += kThreads)
      s_mask[e] = src[e];
  __syncthreads();
  if (tid < 32) {
    for (int i = 0; i < k; ++i) {
      const int wi = i >> 6;
      if (!((removed[wi] >> (i & 63)) & 1ull) && val_s[i]) {
        const unsigned long long* row = mask + (size_t)i * W;
        for (int w = wi + lane; w < W; w += 32) removed[w] |= row[w];
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int i = tid; i < k; i += kThreads)
    keep[(size_t)b * k + i] =
        val_s[i] && !((removed[i >> 6] >> (i & 63)) & 1ull);
}

int launch(const void* kernel, int blocks, size_t smem, cudaStream_t stream,
           void** args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaLaunchKernel(kernel, dim3(blocks), dim3(kThreads), args, smem,
                       stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory: the anchors when anchors_in_smem, the label state
// (3 M ints) unless scratch is given.
int multibox_match_launch(const float* anchors, const float* labels, int B,
                          int N, int M, float thr, float v0, float v1,
                          float v2, float v3, int anchors_in_smem,
                          int* scratch, int* agt, float* aiou, float* loc,
                          void* stream) {
  MatchArgs p{anchors, labels, scratch, agt, aiou, loc, N, M,
              anchors_in_smem, thr, v0, v1, v2, v3};
  const size_t smem = (anchors_in_smem ? (size_t)N * 16 : 0) +
                      (scratch ? 0 : (size_t)M * 12);
  void* args[] = {&p};
  return launch(reinterpret_cast<const void*>(multibox_match_kernel), B,
                smem, static_cast<cudaStream_t>(stream), args);
}

// Two launches: the mask build over (ceil(k / 64), B) blocks into mask
// (B, k, W) in global memory, then the sweep, one block per batch row,
// whose shared memory holds the removed set (W words), the mask when
// mask_in_smem, and the valid flags (k bytes).
int nms_keep_launch(const float* boxes, const float* ids,
                    const unsigned char* valid, int B, int k, float thr,
                    int force, int mask_in_smem, unsigned long long* mask,
                    unsigned char* keep, void* stream) {
  int W = (k + 63) / 64;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3((k + kMaskRows - 1) / kMaskRows, B), kThreads, 0,
                    s>>>(boxes, ids, k, W, thr, force, mask);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = (size_t)W * 8 +
                      (mask_in_smem ? (size_t)k * W * 8 : 0) + (size_t)k;
  void* args[] = {&valid, &k, &W, &mask_in_smem, &mask, &keep};
  return launch(reinterpret_cast<const void*>(nms_sweep_kernel), B, smem, s,
                args);
}
