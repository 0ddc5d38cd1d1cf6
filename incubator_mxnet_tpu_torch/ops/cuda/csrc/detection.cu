// The SSD detection-head kernels for Hopper (sm_90a): the training-target
// matcher and greedy non-maximum suppression. Both are selection ops: no
// gradient flows through them, and they define no backward.
//
// Replaces the Pallas TPU kernels of incubator_mxnet_tpu/ops/pallas/detection.py:
//   match_cluster_kernel  <-  multibox_match / _match_kernel
//       anchors (N, 4) and labels (B, M, 5) -> anchor_gt (B, N) int32,
//       anchor_iou (B, N) and loc_t (B, N, 4): the (M, N) IoU, M greedy
//       bipartite rounds, threshold matching, the loc encoding.
//   nms_cluster_kernel  <-  nms_keep / _nms_kernel
//       boxes (B, k, 4), ids (B, k), valid (B, k), rows score-descending
//       -> keep (B, k), ANDed with valid.
// The first design of each (multibox_match_kernel; nms_mask_kernel +
// nms_sweep_kernel) stays below as the yardstick behind the wrappers'
// private _route="simple".
//
// Exactness. Both must give the plain PyTorch twins' answers bit for bit
// (ops/cuda/detection.py), ties included, so the IoU is computed in the
// reference's order with each step rounded on its own (__fadd_rn and
// kin): nvcc would otherwise contract a*b + c into an FMA, change the
// rounding, and with it the `> thr` and tie decisions. A box's area is the
// same product wherever it is computed, so it may be computed once. Only
// logf in the loc encoding is not correctly rounded.
//
// What bounds them on an H100: neither bytes nor flops (the matcher moves
// ~4.4 MB at the SSD-512 lane, ~1.3 us at 3.35 TB/s) but chains of
// dependent steps, and NMS's (k, k) IoUs where k is large.
// * The matcher's chain is its greedy rounds: each takes the best
//   remaining (label, anchor) pair of the image, so round r + 1 waits for
//   round r's pick, up to M + 1 rounds. The first design gave each image
//   one block (32 of 132 SMs at batch 32), found each label's best anchor
//   with one warp over all N anchors, and recomputed every IoU it read
//   again (0.78 ms at 32 labels an image).
// * NMS's chain is the ordered sweep: row i is kept only if no kept row
//   before it covers it, k dependent steps (400 at the eval point). The
//   first design swept one row a step with one warp, the mask built by a
//   second launch in device memory (0.09 ms at the eval point, 3.1 ms at
//   k 5630, where the mask's 507M IoUs a batch of 32 take over half).
//
// The designs:
// * match_cluster_kernel: one launch, each image a thread-block cluster of
//   S blocks (S from the batch, so that B S fills the SMs: 4 at batch 32,
//   8 at 16 or fewer), each block owning ceil(N / S) anchors in shared
//   memory, loaded by 16-byte loads. Each block computes its (M, N / S)
//   IoU slice once (180 KB at M 32, S 4: mode 2) and keeps it, as the TPU
//   kernel keeps its (M, N) IoU in VMEM; then every warp finds the local
//   best (IoU, anchor) of a label. A round: every block publishes each
//   label's local best in its shared memory (double-buffered by round
//   parity, so one cluster barrier a round suffices), reads the S blocks'
//   through distributed shared memory, and takes each label's best over
//   the cluster (the largest IoU, then the smallest anchor). Then warp 0
//   of every block walks the same commits in the greedy order (the
//   largest IoU, then the smallest flat index g N + a, as jnp.argmax): a
//   commit makes stale the labels whose best was the anchor just taken,
//   and the walk goes on while its next candidate beats every stale
//   label's old best (its new one is no better), so one barrier buys as
//   many rounds of the reference as can be proven; only the block owning
//   a taken anchor rescans, and only the labels whose local best it was,
//   from its slice. A walk with no candidate above 1e-12 and no stale
//   label ends the matching, as the reference's first round that commits
//   nothing does. Stage 2 takes each anchor's best label (the first on a
//   tie) from the same slice and writes loc_t as float4. Where the slice
//   does not fit, the IoU is recomputed where it is read (mode 1); where
//   the labels and their state do not fit either, they and the anchors
//   are read in device memory and the state lives in scratch (mode 0).
// * nms_cluster_kernel: one launch, each image a cluster of S blocks that
//   build its (k, k) suppression bitmask (64 columns j > i to a word),
//   four rows a warp sharing each column's loads and two ballots a row's
//   word, into the shared memory of the cluster's first block through
//   distributed shared memory (22.4 KB at k 400: mode 2), or into device
//   memory where it does not fit; rows that are not valid never suppress
//   and are not built. The first block then sweeps by 64-row words: one
//   thread resolves a word's 64 rows against that word's diagonal bits in
//   a register (64 dependent shift/AND/OR steps on 32-bit halves, no
//   memory round trip; invalid and padding rows enter as already
//   removed), then the warps OR the kept rows of that word into every
//   later word, one warp a word, in parallel. The order is the
//   reference's: a box suppresses only while it is itself kept and valid.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;         // the first design's blocks
constexpr int kWarps = kThreads / 32;
constexpr int kMatchThreads = 1024;   // the cluster matcher's blocks
constexpr int kMatchWarps = kMatchThreads / 32;
constexpr int kMaxSplit = 8;          // blocks a cluster, portable
constexpr int kTileRows = 4;          // NMS mask rows a warp builds at once
// dynamic shared memory a block may take: the H100's 227 KB less room for
// the kernels' static shared memory (ops/cuda/detection.py _SMEM_BUDGET)
constexpr size_t kSmemBudget = 226 * 1024;

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

// The same IoU for the cluster kernels, both areas given (each box_area),
// with no division where the boxes do not overlap (most pairs: skipping it
// took the NMS kernel at (32, 5630) from 3.71 to 2.64 ms on an H100).
// There inter / union is inter itself (a zero of inter's sign), so the
// result is unchanged.
__device__ __forceinline__ float pair_iou(const Box& l, float al,
                                          const Box& r, float ar) {
  const float iw =
      fmaxf(__fsub_rn(fminf(l.x2, r.x2), fmaxf(l.x1, r.x1)), 0.f);
  const float ih =
      fmaxf(__fsub_rn(fminf(l.y2, r.y2), fmaxf(l.y1, r.y1)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(al, ar), inter);
  if (!(uni > 0.f)) return 0.f;
  return inter == 0.f ? inter : __fdiv_rn(inter, uni);
}

// The reference's loc encoding (ops/detection.py _encode_loc) of ground
// truth g against anchor a, the eps guards included
__device__ __forceinline__ float4 encode_loc(const Box& ab, const Box& gb,
                                             float v0, float v1, float v2,
                                             float v3) {
  const float eps = 1e-12f;
  const float aw = __fsub_rn(ab.x2, ab.x1), ah = __fsub_rn(ab.y2, ab.y1);
  const float ax = __fmul_rn(__fadd_rn(ab.x1, ab.x2), 0.5f);
  const float ay = __fmul_rn(__fadd_rn(ab.y1, ab.y2), 0.5f);
  const float gw = __fsub_rn(gb.x2, gb.x1), gh = __fsub_rn(gb.y2, gb.y1);
  const float gx = __fmul_rn(__fadd_rn(gb.x1, gb.x2), 0.5f);
  const float gy = __fmul_rn(__fadd_rn(gb.y1, gb.y2), 0.5f);
  const float awe = __fadd_rn(aw, eps), ahe = __fadd_rn(ah, eps);
  return make_float4(__fdiv_rn(__fdiv_rn(__fsub_rn(gx, ax), awe), v0),
                     __fdiv_rn(__fdiv_rn(__fsub_rn(gy, ay), ahe), v1),
                     __fdiv_rn(logf(fmaxf(__fdiv_rn(gw, awe), eps)), v2),
                     __fdiv_rn(logf(fmaxf(__fdiv_rn(gh, ahe), eps)), v3));
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
constexpr int kNoneI = 0x7fffffff;

// An IoU as an unsigned key in the same order, for the warp's integer
// reductions: 0 for a missing candidate (IoU -1), 1 for a zero of either
// sign, the bits plus one above zero. iou_of is its inverse, bar the sign
// of a zero.
__device__ __forceinline__ unsigned iou_key(float v) {
  return v > 0.f ? __float_as_uint(v) + 1u : (v == 0.f ? 1u : 0u);
}

__device__ __forceinline__ float iou_of(unsigned key) {
  return key > 1u ? __uint_as_float(key - 1u) : (key == 1u ? 0.f : -1.f);
}

// The warp's best (key, g, a): the largest key, then the smallest g, then
// the smallest a (the argmax of g N + a, the first index of a tie), left
// in every lane; three integer reductions.
__device__ __forceinline__ void warp_pick(unsigned& key, int& g, int& a) {
  const unsigned km = __reduce_max_sync(0xffffffffu, key);
  const int gm = __reduce_min_sync(0xffffffffu, key == km ? g : kNoneI);
  a = __reduce_min_sync(0xffffffffu, key == km && g == gm ? a : kNoneI);
  key = km;
  g = gm;
}

// ================================================== the cluster matcher
struct ClusterMatchArgs {
  const float* anchors;   // (N, 4), 16-byte aligned
  const float* labels;    // (B, M, 5)
  int* scratch;           // (B S, 10 M): each block's label state in mode 0
  int* agt;               // (B, N)
  float* aiou;            // (B, N)
  float* loc;             // (B, N, 4)
  int N, M, chunk, mode;  // chunk: anchors a block owns (the last, fewer)
  float thr, v0, v1, v2, v3;
};

// The label state a block keeps: 10 ints a label (the published
// candidates, (key, anchor) by round parity; best IoU, best anchor, done,
// stale, the cluster's best key and anchor). In mode 0 it lives in
// scratch, in that order.
constexpr int kLabelInts = 10;

// A block's shared memory: mode 2 everything, the (M, chunk) IoU slice
// included; mode 1 everything but the slice; mode 0 nothing. Layout: the
// anchors (chunk float4), the published candidates (2 M int2), the
// anchors' stage-1 labels (chunk int), the label rows (M x 5 float), the
// rest of the label state (6 M), the slice.
size_t match_cluster_smem(int chunk, int M, int mode) {
  if (mode == 0) return 0;
  const size_t s = (size_t)chunk * 20 + (size_t)M * (20 + 4 * kLabelInts);
  return mode == 2 ? s + (size_t)chunk * M * 4 : s;
}

// One block's view of its image: where each piece lives.
struct MatchView {
  const float4* anc;  // the block's anchors
  const float* lab;   // the image's label rows (M, 5)
  int* agt;           // the block's anchors' stage-1 label, -1 while free
  int2* pub;          // (2, M): each label's local best as (key, anchor)
  float* best_v;      // each label's best free anchor of the block: IoU,
  int* best_x;        //   and index in the block (-1: none)
  int* done;          // the label is matched, or not valid
  int* stale;         // its best anchor was taken earlier in this round
  int* gkey;          // the cluster's best for the label this round: key
  int* ga;            //   and anchor
  float* slice;       // (M, chunk) IoU, label-major (mode 2)
  int n, chunk;
};

template <bool kSlice>
__device__ __forceinline__ float match_iou(const MatchView& v, int g,
                                           int x) {
  if (kSlice) return v.slice[(size_t)g * v.chunk + x];
  const float* l = v.lab + (size_t)g * 5;
  if (!(l[0] >= 0.f)) return 0.f;
  const Box lb = load_box(l + 1), ab = load_box(v.anc + x);
  return pair_iou(lb, box_area(lb), ab, box_area(ab));
}

// One warp: label g's best free anchor among the block's (the first on a
// tie); lane 0 writes it. Both loads of an anchor are issued whether or
// not it is free, so the unrolled iterations' loads overlap.
template <bool kSlice>
__device__ void local_best(const MatchView& v, int g, int lane) {
  float bv = -1.f;
  int bx = kNoneI;
#pragma unroll 4
  for (int x = lane; x < v.n; x += 32) {
    const int taken = v.agt[x];
    const float val = match_iou<kSlice>(v, g, x);
    if (taken < 0 && val > bv) {
      bv = val;
      bx = x;
    }
  }
  unsigned key = iou_key(bv);
  int none = 0;
  warp_pick(key, none, bx);
  if (lane == 0) {
    v.best_v[g] = iou_of(key);
    v.best_x[g] = key ? bx : -1;
  }
}

// Warp 0 of every block: the round's commits, in the greedy order, from
// each label's best over the cluster (gkey, ga). A commit takes the best
// label (key, then the smallest g: the smallest flat index g N + a) and
// makes stale every label whose best was the same anchor; such a label's
// new best is unknown but no better than its old one, so the walk goes on
// only while its candidate beats every stale label's old best in the same
// order, and stops for the rescans otherwise. Every block walks the same
// inputs to the same commits. Returns whether the matching is over: no
// candidate above 1e-12 and no stale label.
__device__ bool walk(const MatchView& v, int M, int a0, int lane) {
  unsigned sk = 0u;     // the best stale label's old key
  int sg = kNoneI;      //   and index
  for (;;) {
    unsigned key = 0u;
    int g = kNoneI, a = kNoneI;
    for (int h = lane; h < M; h += 32) {   // each lane's labels ascend
      if (v.done[h] || v.stale[h]) continue;
      const unsigned kh = static_cast<unsigned>(v.gkey[h]);
      if (kh > key) {
        key = kh;
        g = h;
        a = v.ga[h];
      }
    }
    warp_pick(key, g, a);
    // a commit needs an IoU above 1e-12, as in the reference
    if (!(iou_of(key) > 1e-12f)) return sg == kNoneI;
    if (sk > key || (sk == key && sg < g)) return false;
    if (lane == 0) {
      v.done[g] = 1;
      const int x = a - a0;
      if (x >= 0 && x < v.n) v.agt[x] = g;
    }
    unsigned bk = 0u;
    int bg = kNoneI, none = 0;
    for (int h = lane; h < M; h += 32) {
      if (h == g || v.done[h] || v.stale[h] || v.ga[h] != a) continue;
      v.stale[h] = 1;
      const unsigned kh = static_cast<unsigned>(v.gkey[h]);
      if (kh > bk) {
        bk = kh;
        bg = h;
      }
    }
    warp_pick(bk, none, bg);
    if (bk > sk || (bk == sk && bg < sg)) {
      sk = bk;
      sg = bg;
    }
    __syncwarp();
  }
}

template <bool kSlice>
__global__ void __launch_bounds__(kMatchThreads)
    match_cluster_kernel(ClusterMatchArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_over;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = p.N, M = p.M, chunk = p.chunk;
  const int a0 = min(N, rank * chunk);
  const int n = min(N, a0 + chunk) - a0;
  const float4* anc_g = reinterpret_cast<const float4*>(p.anchors) + a0;
  const float* lab_g = p.labels + (size_t)b * M * 5;
  MatchView v;
  v.n = n;
  v.chunk = chunk;
  v.slice = nullptr;
  int* state;           // best_v, best_x, done, stale, gkey, ga: M each
  if (kSlice || p.mode == 1) {
    float4* anc_s = reinterpret_cast<float4*>(smem);
    v.pub = reinterpret_cast<int2*>(anc_s + chunk);
    int* agt_s = reinterpret_cast<int*>(v.pub + 2 * M);
    float* lab_s = reinterpret_cast<float*>(agt_s + chunk);
    state = reinterpret_cast<int*>(lab_s + (size_t)M * 5);
    if (kSlice) v.slice = reinterpret_cast<float*>(state + 6 * M);
    for (int x = tid; x < n; x += kMatchThreads) {
      anc_s[x] = anc_g[x];
      agt_s[x] = -1;
    }
    for (int e = tid; e < M * 5; e += kMatchThreads) lab_s[e] = lab_g[e];
    v.anc = anc_s;
    v.lab = lab_s;
    v.agt = agt_s;
  } else {
    int* st = p.scratch + (size_t)blockIdx.x * kLabelInts * M;
    v.pub = reinterpret_cast<int2*>(st);
    state = st + 4 * M;
    v.anc = anc_g;
    v.lab = lab_g;
    v.agt = p.agt + (size_t)b * N + a0;
    for (int x = tid; x < n; x += kMatchThreads) v.agt[x] = -1;
  }
  v.best_v = reinterpret_cast<float*>(state);
  v.best_x = state + M;
  v.done = state + 2 * M;
  v.stale = state + 3 * M;
  v.gkey = state + 4 * M;
  v.ga = state + 5 * M;
  // labels that are not valid (cls < 0) start done and never match in
  // stage 1
  for (int g = tid; g < M; g += kMatchThreads)
    v.done[g] = !(lab_g[(size_t)g * 5] >= 0.f);
  __syncthreads();
  if (kSlice) {
    for (int x = tid; x < n; x += kMatchThreads) {
      const Box ab = load_box(v.anc + x);
      const float aa = box_area(ab);
#pragma unroll 4
      for (int g = 0; g < M; ++g) {
        const float* l = v.lab + (size_t)g * 5;
        const Box lb = load_box(l + 1);
        v.slice[(size_t)g * chunk + x] =
            l[0] >= 0.f ? pair_iou(lb, box_area(lb), ab, aa) : 0.f;
      }
    }
    __syncthreads();
  }
  for (int g = warp; g < M; g += kMatchWarps)
    if (!v.done[g]) local_best<kSlice>(v, g, lane);
  __syncthreads();

  // stage 1: greedy bipartite rounds, each as many commits as the walk
  // can prove
  for (int round = 0; round <= M; ++round) {
    int2* pub = v.pub + (round & 1) * M;
    for (int g = tid; g < M; g += kMatchThreads)
      pub[g] = v.done[g] || v.best_x[g] < 0
                   ? make_int2(0, kNoneI)
                   : make_int2(static_cast<int>(iou_key(v.best_v[g])),
                               a0 + v.best_x[g]);
    // every block's candidates of this round are published; the other
    // parity's were last read before this barrier, so the next round may
    // write them
    if (!kSlice && p.mode == 0) __threadfence();
    cluster.sync();
    for (int g = tid; g < M; g += kMatchThreads) {
      unsigned key = 0u;
      int a = kNoneI;
      for (int r = 0; r < S; ++r) {
        // block r's candidates: its shared memory, or its scratch region
        const int2 c =
            kSlice || p.mode == 1
                ? cluster.map_shared_rank(pub, r)[g]
                : reinterpret_cast<const int2*>(
                      reinterpret_cast<const int*>(pub) +
                      (long long)(r - rank) * kLabelInts * M)[g];
        const unsigned ck = static_cast<unsigned>(c.x);
        if (ck > key || (ck == key && c.y < a)) {
          key = ck;
          a = c.y;
        }
      }
      v.gkey[g] = static_cast<int>(key);
      v.ga[g] = a;
      v.stale[g] = 0;
    }
    __syncthreads();
    if (warp == 0) {
      const bool over = walk(v, M, a0, lane);
      if (lane == 0) s_over = over;
    }
    __syncthreads();
    if (s_over) break;
    // a label whose best anchor in this block was taken rescans it
    for (int g = warp; g < M; g += kMatchWarps) {
      if (v.done[g]) continue;
      const int x = v.best_x[g];
      if (x >= 0 && v.agt[x] >= 0) local_best<kSlice>(v, g, lane);
    }
    __syncthreads();
  }

  // stage 2 (threshold matching over each anchor's best label, labels that
  // are not valid counting as IoU 0) and the loc encoding
  int* agt = p.agt + (size_t)b * N + a0;
  float* aiou = p.aiou + (size_t)b * N + a0;
  float4* loc = reinterpret_cast<float4*>(p.loc) + (size_t)b * N + a0;
  for (int x = tid; x < n; x += kMatchThreads) {
    float bv = 0.f;
    int bg = 0;
#pragma unroll 4
    for (int g = 0; g < M; ++g) {
      const float val = match_iou<kSlice>(v, g, x);
      if (g == 0 || val > bv) {
        bv = val;
        bg = g;
      }
    }
    const int m1 = v.agt[x];
    const int m = (m1 < 0 && bv > p.thr) ? bg : m1;
    agt[x] = m;
    aiou[x] = m1 >= 0 ? 1.f : bv;
    loc[x] = m >= 0 ? encode_loc(load_box(v.anc + x),
                                 load_box(v.lab + (size_t)m * 5 + 1), p.v0,
                                 p.v1, p.v2, p.v3)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cluster.sync();  // no block leaves while another may read its candidates
}

// ================================================== the cluster NMS
struct ClusterNmsArgs {
  const float* boxes;           // image b's (k, 4) rows at boxes + b sb
  const float* ids;             // its (k,) ids at ids + b si
  const unsigned char* valid;   // its (k,) flags at valid + b sv
  unsigned long long* gmask;    // (B, k, W) words in modes 0 and 1
  unsigned char* keep;          // (B, k)
  long long sb, si, sv;
  int k, W;
  float thr;
  int force;
};

// A block's shared memory: the removed set (W words); in modes 1 and 2
// also the boxes, areas and ids (24 bytes a row); in mode 2 the (k, W)
// mask (used in the cluster's first block). Layout: boxes, mask, removed
// set, areas, ids.
size_t nms_cluster_smem(int k, int W, int mode) {
  size_t s = (size_t)W * 8;
  if (mode >= 1) s += (size_t)k * 24;
  if (mode == 2) s += (size_t)k * W * 8;
  return s;
}

// The cluster NMS's block size by mode, as measured on an H100 80GB HBM3
// at 700 W: with the mask in shared memory (k up to 1256) 512 threads
// (0.0228 ms at the eval point's (32, 400), 1024 threads 0.0277); with
// the mask in device memory 1024 (1.717 ms at (32, 5630), 512: 2.233).
__host__ __device__ constexpr int nms_threads(int mode) {
  return mode == 2 ? 512 : 1024;
}

template <int kMode>
__global__ void __launch_bounds__(nms_threads(kMode))
    nms_cluster_kernel(ClusterNmsArgs p) {
  constexpr int kNmsThreads = nms_threads(kMode);
  constexpr int kNmsWarps = kNmsThreads / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long diag[64];   // a word's diagonal words
  __shared__ unsigned long long kept_bits;  // its kept rows
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k = p.k, W = p.W;
  const float4* box_g = reinterpret_cast<const float4*>(p.boxes + b * p.sb);
  const float* ids_g = p.ids + b * p.si;
  const unsigned char* val_g = p.valid + b * p.sv;

  unsigned char* q = smem;
  float4* box_s = reinterpret_cast<float4*>(q);
  if (kMode >= 1) q += (size_t)k * 16;
  unsigned long long* mask_s = reinterpret_cast<unsigned long long*>(q);
  if (kMode == 2) q += (size_t)k * W * 8;
  unsigned long long* removed = reinterpret_cast<unsigned long long*>(q);
  q += (size_t)W * 8;
  float* area_s = reinterpret_cast<float*>(q);
  float* ids_s = area_s + k;

  const float4* box = box_g;
  const float* ids = ids_g;
  if (kMode >= 1) {
    for (int i = tid; i < k; i += kNmsThreads) {
      const float4 bx = box_g[i];
      box_s[i] = bx;
      area_s[i] = box_area(Box{bx.x, bx.y, bx.z, bx.w});
      ids_s[i] = ids_g[i];
    }
    box = box_s;
    ids = ids_s;
  }
  // rows that are not valid, and the padding of the last word, enter the
  // sweep as removed: they never suppress and are never kept
  if (rank == 0)
    for (int i = tid; i < W * 64; i += kNmsThreads) {
      const unsigned m = __ballot_sync(0xffffffffu, i >= k || !val_g[i]);
      if (lane == 0) reinterpret_cast<unsigned*>(removed)[i >> 5] = m;
    }
  unsigned long long* mask;
  if (kMode == 2) {
    // the first block's mask is written by every block of the cluster: all
    // must have started before the first remote store
    cluster.sync();
    mask = rank == 0 ? mask_s : cluster.map_shared_rank(mask_s, 0);
  } else {
    __syncthreads();
    mask = p.gmask + (size_t)b * k * W;
  }

  // the mask: block `rank` builds rows i = rank + S r, kTileRows rows a
  // warp (the tiles dealt round, so that each warp's words add up alike),
  // their words w (columns 64 w .. 64 w + 63) in turn: lane t loads
  // columns 64 w + t and 64 w + 32 + t once for the tile's rows, and two
  // ballots a row make the word; a row's words start at w = i / 64
  const int R = (k - rank + S - 1) / S;
  for (int r0 = warp * kTileRows; r0 < R; r0 += kNmsWarps * kTileRows) {
    Box bi[kTileRows];
    float ai[kTileRows], idi[kTileRows];
    int ii[kTileRows];
#pragma unroll
    for (int q = 0; q < kTileRows; ++q) {
      const int i = rank + S * (r0 + q);
      // a row past the last, or not valid, takes part as i = k: it
      // suppresses nothing and writes no word
      ii[q] = r0 + q < R && val_g[i] ? i : k;
      const int ic = ii[q] < k ? ii[q] : 0;
      bi[q] = load_box(box + ic);
      ai[q] = kMode >= 1 ? area_s[ic] : box_area(bi[q]);
      idi[q] = ids[ic];
    }
    for (int w = (rank + S * r0) >> 6; w < W; ++w) {
      unsigned half[kTileRows][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 64 * w + 32 * h + lane;
        const int jc = j < k ? j : k - 1;
        const Box bj = load_box(box + jc);
        const float aj = kMode >= 1 ? area_s[jc] : box_area(bj);
        const float idj = ids[jc];
#pragma unroll
        for (int q = 0; q < kTileRows; ++q) {
          const bool sup = pair_iou(bi[q], ai[q], bj, aj) >= p.thr &&
                           (p.force || idj == idi[q]);
          half[q][h] = __ballot_sync(0xffffffffu, sup && j > ii[q] && j < k);
        }
      }
      // lane q writes row q's word
      unsigned long long word = 0ull;
      int row = k;
#pragma unroll
      for (int q = 0; q < kTileRows; ++q)
        if (lane == q) {
          word = (static_cast<unsigned long long>(half[q][1]) << 32) |
                 half[q][0];
          row = ii[q];
        }
      if (row < k && w >= (row >> 6)) mask[(size_t)row * W + w] = word;
    }
  }
  if (kMode != 2) __threadfence();
  cluster.sync();  // the mask and the removed set are complete
  if (rank != 0) return;

  // the sweep, by 64-row words: removed[w] is final once every word before
  // w has been swept
  unsigned char* keep = p.keep + (size_t)b * k;
  if (tid < 64) diag[tid] = tid < k ? mask[(size_t)tid * W] : 0ull;
  __syncthreads();
  for (int w = 0; w < W; ++w) {
    if (tid == 0) {
      // row t is kept when no kept row before it removed it; a row's
      // diagonal word has bits only above t, so bit t is final at step t
      const unsigned long long cur = removed[w];
      unsigned lo = static_cast<unsigned>(cur);
      unsigned hi = static_cast<unsigned>(cur >> 32);
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const unsigned long long d = diag[t];
        if (!((lo >> t) & 1u)) {
          lo |= static_cast<unsigned>(d);
          hi |= static_cast<unsigned>(d >> 32);
        }
      }
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const unsigned d = static_cast<unsigned>(diag[32 + t] >> 32);
        if (!((hi >> t) & 1u)) hi |= d;
      }
      kept_bits = ~((static_cast<unsigned long long>(hi) << 32) | lo);
    }
    __syncthreads();
    const unsigned long long K = kept_bits;
    const int i0 = w * 64;
    if (tid < 64) {
      if (i0 + tid < k)
        keep[i0 + tid] = static_cast<unsigned char>((K >> tid) & 1ull);
      const int i1 = i0 + 64 + tid;  // the next word's diagonal
      if (w + 1 < W) diag[tid] = i1 < k ? mask[(size_t)i1 * W + w + 1] : 0ull;
    }
    for (int w2 = w + 1 + warp; w2 < W; w2 += kNmsWarps) {
      unsigned long long bits = 0ull;
      if ((K >> lane) & 1ull) bits = mask[(size_t)(i0 + lane) * W + w2];
      if ((K >> (lane + 32)) & 1ull)
        bits |= mask[(size_t)(i0 + 32 + lane) * W + w2];
      const unsigned lo =
          __reduce_or_sync(0xffffffffu, static_cast<unsigned>(bits));
      const unsigned hi =
          __reduce_or_sync(0xffffffffu, static_cast<unsigned>(bits >> 32));
      if (lane == 0)
        removed[w2] |= (static_cast<unsigned long long>(hi) << 32) | lo;
    }
    __syncthreads();
  }
}

// ===================================== the first design (_route="simple")
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
    const float4 out =
        m >= 0 ? encode_loc(ab, load_box(lab + (size_t)m * 5 + 1), p.v0,
                            p.v1, p.v2, p.v3)
               : make_float4(0.f, 0.f, 0.f, 0.f);
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

// Sets a kernel's dynamic shared-memory limit when a launch needs more than
// the default 48 KB and more than any launch of it before: once per kernel
// and size, not per call.
template <auto Kernel>
cudaError_t reserve_smem(size_t smem) {
  static size_t reserved = 48 * 1024;        // one per kernel
  if (smem <= reserved) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess) reserved = smem;
  return e;
}

template <auto Kernel>
int launch(int blocks, size_t smem, cudaStream_t stream, void** args) {
  cudaError_t e = reserve_smem<Kernel>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaLaunchKernel(reinterpret_cast<const void*>(Kernel), dim3(blocks),
                       dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// `images` clusters of `split` blocks each, one image a cluster
template <auto Kernel, typename Args>
int launch_clusters(int images, int split, int threads, size_t smem,
                    cudaStream_t stream, const Args& args) {
  cudaError_t e = reserve_smem<Kernel>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(images * split);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, Kernel, args);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The cluster matcher: B clusters of `split` blocks (1..8), each block
// ceil(N / split) anchors; mode as match_cluster_smem says (0 needs
// scratch (B split, 10 M) int32).
int multibox_match_cluster_launch(const float* anchors, const float* labels,
                                  int B, int N, int M, int split, int mode,
                                  float thr, float v0, float v1, float v2,
                                  float v3, int* scratch, int* agt,
                                  float* aiou, float* loc, void* stream) {
  if (split < 1 || split > kMaxSplit || mode < 0 || mode > 2 || N < 1 ||
      M < 1 || (mode == 0 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = (N + split - 1) / split;
  const size_t smem = match_cluster_smem(chunk, M, mode);
  if (smem > kSmemBudget) return static_cast<int>(cudaErrorInvalidValue);
  const ClusterMatchArgs p{anchors, labels, scratch, agt, aiou, loc, N, M,
                           chunk, mode, thr, v0, v1, v2, v3};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mode == 2 ? launch_clusters<match_cluster_kernel<true>>(
                         B, split, kMatchThreads, smem, s, p)
                   : launch_clusters<match_cluster_kernel<false>>(
                         B, split, kMatchThreads, smem, s, p);
}

// The cluster NMS: B clusters of `split` blocks (1..8); the boxes, ids and
// valid flags of image b at b times their batch strides (rows contiguous,
// boxes 16-byte aligned); mode as nms_cluster_smem says (0 and 1 need
// gmask (B, k, ceil(k / 64)) words).
int nms_keep_cluster_launch(const float* boxes, const float* ids,
                            const unsigned char* valid, long long sb,
                            long long si, long long sv, int B, int k,
                            int split, int mode, float thr, int force,
                            unsigned long long* gmask, unsigned char* keep,
                            void* stream) {
  const int W = (k + 63) / 64;
  if (split < 1 || split > kMaxSplit || mode < 0 || mode > 2 || k < 1 ||
      (mode < 2 && gmask == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = nms_cluster_smem(k, W, mode);
  if (smem > kSmemBudget) return static_cast<int>(cudaErrorInvalidValue);
  const ClusterNmsArgs p{boxes, ids, valid, gmask, keep, sb, si, sv,
                         k, W, thr, force};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 2:
      return launch_clusters<nms_cluster_kernel<2>>(B, split, nms_threads(2),
                                                    smem, s, p);
    case 1:
      return launch_clusters<nms_cluster_kernel<1>>(B, split, nms_threads(1),
                                                    smem, s, p);
    default:
      return launch_clusters<nms_cluster_kernel<0>>(B, split, nms_threads(0),
                                                    smem, s, p);
  }
}

// The first design. Shared memory: the anchors when anchors_in_smem, the
// label state (3 M ints) unless scratch is given.
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
  return launch<multibox_match_kernel>(B, smem,
                                       static_cast<cudaStream_t>(stream),
                                       args);
}

// The first design's two launches: the mask build over (ceil(k / 64), B)
// blocks into mask (B, k, W) in global memory, then the sweep, one block
// per batch row, whose shared memory holds the removed set (W words), the
// mask when mask_in_smem, and the valid flags (k bytes).
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
  return launch<nms_sweep_kernel>(B, smem, s, args);
}
