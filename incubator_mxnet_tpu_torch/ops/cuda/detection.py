"""The SSD detection-head kernels: the training-target matcher and greedy
NMS, in CUDA, beside their plain PyTorch twins.

Counterpart of ``incubator_mxnet_tpu/ops/pallas/detection.py``:

* ``multibox_match`` / ``multibox_match_reference`` — anchors (N, 4) and
  labels (B, M, 5) rows [cls, x1, y1, x2, y2] (cls < 0 pads) give
  ``anchor_gt`` (B, N) int32 (the matched label or -1), ``anchor_iou``
  (B, N) (1 for a stage-1 match, else the best IoU) and ``loc_t``
  (B, N, 4) (the encoded offsets, 0 where unmatched): the IoU, M greedy
  bipartite rounds (the globally best remaining (label, anchor) pair, the
  smallest flat index winning a tie, committed while above 1e-12), then
  threshold matching over each anchor's best label, then the encoding;
* ``nms_keep`` / ``nms_keep_reference`` — boxes (B, k, 4), ids (B, k),
  valid (B, k) with rows score-descending give keep (B, k): box i removes
  every later box whose IoU with it is at least the threshold (and, unless
  ``force_suppress``, that shares its id), while i is itself kept and
  valid; the result is ANDed with valid.

The kernels take every shape: their working sets move from shared to
global memory when they outgrow it, so no shape goes to the twin. The
kernels equal the twins bit for bit, ties included, except ``loc_t``,
whose ``log`` is not correctly rounded on the card (a few ulp). The IoU is
computed in the reference's order and rounding (:func:`pair_iou`); the
twins divide by the variances as tensors, since PyTorch's CUDA division by
a Python number multiplies by its reciprocal. Both ops are selection ops:
they take no gradient. CUDA tensors go through the kernels (the callers in
``ops/detection.py`` choose by device), CPU tensors through the twins; a
kernel wrapper given anything else raises.

Each kernel runs one image as a thread-block cluster (:func:`match_plan`,
:func:`nms_plan`); the first design of each stays behind the wrappers'
private ``_route="simple"`` as the yardstick. :func:`multibox_match_split`
and :func:`nms_keep_blocked` are plain models of the cluster kernels'
algorithms (the S-way split matcher, the word-blocked sweep), which the
CPU tests hold against the twins and the Pallas kernels.
"""
from __future__ import annotations

import torch

from .. import device_vector
from .common import (check_launch, counted_kernel, current_stream_handle,
                     kernel_library, sm_count)

__all__ = ["pair_iou", "encode_loc", "match_anchors", "cluster_split",
           "match_plan", "nms_plan", "multibox_match",
           "multibox_match_reference", "multibox_match_split", "nms_keep",
           "nms_keep_reference", "nms_keep_blocked"]

# dynamic shared memory a block may take: the H100's 227 KB less room for
# the kernels' static shared memory (detection.cu kSmemBudget)
_SMEM_BUDGET = 226 * 1024
_MAX_SPLIT = 8              # blocks a cluster (detection.cu kMaxSplit)
# the first design's own budget, kept with it (``_route="simple"``)
_SIMPLE_SMEM_BUDGET = 200 * 1024


# ----------------------------------------------------------- plain math
def pair_iou(l, r):
    """Corner IoU of broadcast boxes l (..., 4) and r (..., 4), op for op as
    the reference's ``box_iou``: union = (area_l + area_r) - inter, and 0
    where the union is not positive."""
    iw = torch.clamp_min(torch.minimum(l[..., 2], r[..., 2])
                         - torch.maximum(l[..., 0], r[..., 0]), 0.0)
    ih = torch.clamp_min(torch.minimum(l[..., 3], r[..., 3])
                         - torch.maximum(l[..., 1], r[..., 1]), 0.0)
    inter = iw * ih
    area_l = (l[..., 2] - l[..., 0]) * (l[..., 3] - l[..., 1])
    area_r = (r[..., 2] - r[..., 0]) * (r[..., 3] - r[..., 1])
    union = area_l + area_r - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def encode_loc(anchor, gt, variances):
    """(gcx - acx) / aw / v0, (gcy - acy) / ah / v1, log(gw / aw) / v2,
    log(gh / ah) / v3, with the reference's eps guards (ref:
    multibox_target.cc AssignLocTargets)."""
    var = device_vector([float(v) for v in variances], gt.dtype, gt.device)
    aw = anchor[..., 2] - anchor[..., 0]
    ah = anchor[..., 3] - anchor[..., 1]
    ax = (anchor[..., 0] + anchor[..., 2]) / 2
    ay = (anchor[..., 1] + anchor[..., 3]) / 2
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    gx = (gt[..., 0] + gt[..., 2]) / 2
    gy = (gt[..., 1] + gt[..., 3]) / 2
    eps = 1e-12
    return torch.stack([
        (gx - ax) / (aw + eps) / var[0],
        (gy - ay) / (ah + eps) / var[1],
        torch.log(torch.clamp_min(gw / (aw + eps), eps)) / var[2],
        torch.log(torch.clamp_min(gh / (ah + eps), eps)) / var[3]], -1)


def match_anchors(iou_t, valid_gt, overlap_threshold):
    """Greedy bipartite then threshold matching over leading batch dims:
    iou_t (..., M, N) label x anchor IoU with invalid rows zeroed, valid_gt
    (..., M). Returns (anchor_gt (..., N) int32, anchor_iou (..., N)).
    Each round takes the first flat index of the masked matrix's maximum,
    as ``jnp.argmax`` does; a round that commits nothing in any row ends
    the loop, since the rest would commit nothing either."""
    *lead, M, N = iou_t.shape
    iou = iou_t.reshape(-1, M, N)
    B = iou.shape[0]
    rows = torch.arange(B, device=iou.device)
    anchor_gt = torch.full((B, N), -1, dtype=torch.int32, device=iou.device)
    gt_done = ~valid_gt.reshape(B, M)
    anchor_done = torch.zeros((B, N), dtype=torch.bool, device=iou.device)
    neg = torch.full((), -1.0, dtype=iou.dtype, device=iou.device)
    for _ in range(M):
        masked = torch.where(gt_done[:, :, None] | anchor_done[:, None, :],
                             neg, iou).reshape(B, M * N)
        flat = torch.argmax(masked, dim=1)
        good = masked[rows, flat] > 1e-12
        if not bool(good.any()):
            break
        r, f = rows[good], flat[good]
        g, a = f // N, f % N
        anchor_gt[r, a] = g.to(torch.int32)
        gt_done[r, g] = True
        anchor_done[r, a] = True
    best_gt = torch.argmax(iou, dim=1).to(torch.int32)
    best_iou = torch.amax(iou, dim=1)
    stage2 = ~anchor_done & (best_iou > overlap_threshold)
    anchor_gt = torch.where(stage2, best_gt, anchor_gt)
    anchor_iou = torch.where(anchor_done, torch.ones_like(best_iou),
                             best_iou)
    return (anchor_gt.reshape(*lead, N), anchor_iou.reshape(*lead, N))


# ------------------------------------------------------ the kernels' plans
def cluster_split(batch: int, sms: int) -> int:
    """Blocks in an image's cluster on a card of ``sms`` SMs: the largest
    power of two at most ``sms // batch``, 1..8 (8 is the portable cluster
    size), so that the batch's clusters fill the SMs: 4 at batch 32 on an
    H100's 132, 8 at 16 or fewer."""
    s = 1
    while s * 2 <= min(_MAX_SPLIT, sms // max(batch, 1)):
        s *= 2
    return s


def match_plan(B: int, N: int, M: int, sms: int):
    """(split, chunk, mode, smem) of the cluster matcher: ``split`` blocks
    an image (:func:`cluster_split`), ``chunk`` anchors a block, and where
    its working set lives (``match_cluster_smem`` in ``detection.cu``):
    mode 2 all of it in shared memory with the (M, chunk) IoU slice, 1 all
    but the slice (the IoU recomputed where read), 0 none (the label state
    in scratch); ``smem`` the dynamic bytes a block."""
    split = cluster_split(B, sms)
    chunk = -(-N // split)
    base = chunk * 20 + M * 60
    if base + chunk * M * 4 <= _SMEM_BUDGET:
        return split, chunk, 2, base + chunk * M * 4
    if base <= _SMEM_BUDGET:
        return split, chunk, 1, base
    return split, chunk, 0, 0


def nms_plan(B: int, k: int, sms: int):
    """(split, W, mode, smem) of the cluster NMS: ``split`` blocks an image,
    W = ceil(k / 64) mask words a row, and where the working set lives
    (``nms_cluster_smem`` in ``detection.cu``): mode 2 the boxes, areas,
    ids (24 bytes a row) and the (k, W) mask in shared memory, 1 the mask
    in device memory, 0 the boxes too; the removed set (W words) always in
    shared memory. Raises where even that does not fit."""
    W = -(-k // 64)
    split = cluster_split(B, sms)
    for mode, smem in ((2, 8 * W + 24 * k + 8 * k * W), (1, 8 * W + 24 * k),
                       (0, 8 * W)):
        if smem <= _SMEM_BUDGET:
            return split, W, mode, smem
    raise ValueError(f"nms_keep: {k} candidates exceed the kernel's "
                     "shared-memory removed set")


def _check_route(name: str, route) -> None:
    if route not in (None, "simple"):
        raise ValueError(f"{name}: _route {route!r} (only \"simple\", for "
                         "comparisons)")


# ------------------------------------------------------------ the matcher
def _match_inputs(anchor, label):
    if anchor.dim() != 2 or anchor.shape[1] != 4 or label.dim() != 3 \
            or label.shape[2] != 5:
        raise ValueError(f"multibox_match: anchor (N, 4) and label (B, M, 5)"
                         f", got {tuple(anchor.shape)} and "
                         f"{tuple(label.shape)}")
    if anchor.shape[0] < 1 or label.shape[1] < 1:
        raise ValueError("multibox_match: needs at least one anchor and one "
                         "label row")
    return anchor.detach().float(), label.detach().float()


def _encoded(anchor, label, agt, variances):
    """loc_t of the matches ``agt`` (B, N): the encoding, 0 where
    unmatched."""
    gt = torch.gather(label[..., 1:5], 1,
                      agt.clamp_min(0).long()[..., None].expand(-1, -1, 4))
    loc = encode_loc(anchor, gt, variances)
    return torch.where((agt >= 0)[..., None], loc, torch.zeros_like(loc))


def multibox_match_reference(anchor, label, overlap_threshold: float,
                             variances):
    """Plain twin of :func:`multibox_match` (the reference's
    ``_match_anchors`` and loc encoding, batched)."""
    anchor, label = _match_inputs(anchor, label)
    valid = label[..., 0] >= 0                                  # (B, M)
    iou = pair_iou(label[:, :, None, 1:5], anchor[None, None])   # (B, M, N)
    iou = iou * valid[..., None]
    agt, aiou = match_anchors(iou, valid, overlap_threshold)
    return agt, aiou, _encoded(anchor, label, agt, variances)


def multibox_match_split(anchor, label, overlap_threshold: float, variances,
                         split: int):
    """Plain model of the cluster matcher's algorithm
    (``match_cluster_kernel``), for the CPU tests. Each image's anchors are
    cut into ``split`` slices of ceil(N / split) (the last ones shorter or
    empty); each slice keeps every label's local best free anchor (IoU,
    the first index on a tie). A round: each label's best over the slices
    (the largest IoU, then the smallest anchor); then the walk commits in
    the greedy order (the largest IoU, then the smallest flat index
    g N + a), above 1e-12; a commit makes stale every label whose best was
    the same anchor, and the walk goes on only while its candidate beats
    every stale label's old best (a stale label's new best is no better),
    else the slices owning a taken anchor rescan the labels whose local
    best it was, and the next round begins. No candidate above 1e-12 and
    no stale label ends the matching. Stage 2 and the encoding as the
    reference. Returns what :func:`multibox_match` does."""
    anchor, label = _match_inputs(anchor, label)
    B, M, _ = label.shape
    N = anchor.shape[0]
    chunk = -(-N // split)
    valid = label[..., 0] >= 0
    iou = pair_iou(label[:, :, None, 1:5], anchor[None, None])
    iou = iou * valid[..., None]                                  # (B, M, N)
    agt = torch.full((B, N), -1, dtype=torch.int32)
    bounds = [(min(N, r * chunk), min(N, (r + 1) * chunk))
              for r in range(split)]

    def order(t):                 # (IoU, index, ...): the greedy order
        return -t[0], t[1]

    for b in range(B):
        taken = torch.zeros(N, dtype=torch.bool)
        done = [not bool(v) for v in valid[b]]

        def local(r, g):          # (IoU, anchor) or None: no free anchor
            a0, a1 = bounds[r]
            if a0 == a1 or bool(taken[a0:a1].all()):
                return None
            row = torch.where(taken[a0:a1], torch.full((), -1.0),
                              iou[b, g, a0:a1])
            x = int(torch.argmax(row))                 # the first maximum
            return float(row[x]), a0 + x

        best = [[None if done[g] else local(r, g) for g in range(M)]
                for r in range(split)]
        for _ in range(M + 1):
            top = [None if done[g] else min(
                (c[g] for c in best if c[g] is not None), key=order,
                default=None) for g in range(M)]
            stale = {}            # label: its old best IoU
            while True:
                cands = [(top[g][0], g, top[g][1]) for g in range(M)
                         if top[g] is not None and not done[g]
                         and g not in stale]
                v, g, a = min(cands, key=order, default=(-1.0, M, N))
                if not v > 1e-12:
                    over = not stale
                    break
                if stale and order(min(((sv, h) for h, sv in stale.items()),
                                       key=order)) < order((v, g)):
                    over = False
                    break
                done[g] = True
                taken[a] = True
                agt[b, a] = g
                stale.update({h: top[h][0] for h in range(M)
                              if h != g and not done[h] and h not in stale
                              and top[h] is not None and top[h][1] == a})
            if over:
                break
            for r in range(split):
                for h in range(M):
                    if not done[h] and best[r][h] is not None \
                            and bool(taken[best[r][h][1]]):
                        best[r][h] = local(r, h)
    taken = agt >= 0
    best_gt = torch.argmax(iou, dim=1).to(torch.int32)
    best_iou = torch.amax(iou, dim=1)
    agt = torch.where(~taken & (best_iou > overlap_threshold), best_gt, agt)
    aiou = torch.where(taken, torch.ones_like(best_iou), best_iou)
    return agt, aiou, _encoded(anchor, label, agt, variances)


@counted_kernel
def multibox_match(anchor, label, overlap_threshold: float, variances,
                   _route=None):
    """CUDA matcher (replaces the Pallas ``multibox_match``): anchor (N, 4)
    and label (B, M, 5) on one card, any N and M >= 1, taken as float32.
    Returns (anchor_gt (B, N) int32, anchor_iou (B, N), loc_t (B, N, 4)).

    One launch of the cluster kernel (:func:`match_plan`), counted in
    ``launches`` and ``sm90_launches``; the private ``_route="simple"``
    (the first design, one block an image, kept as the yardstick) counts
    in ``launches`` only."""
    _check_route("multibox_match", _route)
    anchor, label = _match_inputs(anchor, label)
    if not (anchor.is_cuda and label.device == anchor.device):
        raise ValueError(f"multibox_match: the kernel takes CUDA tensors on "
                         f"one device, got {anchor.device} and "
                         f"{label.device}")
    anchor, label = anchor.contiguous(), label.contiguous()
    if anchor.data_ptr() % 16:          # read as float4
        anchor = anchor.clone()
    B, M, _ = label.shape
    N = anchor.shape[0]
    dev = anchor.device
    agt = torch.empty((B, N), dtype=torch.int32, device=dev)
    aiou = torch.empty((B, N), dtype=torch.float32, device=dev)
    loc = torch.empty((B, N, 4), dtype=torch.float32, device=dev)
    if B == 0:
        return agt, aiou, loc
    v = [float(x) for x in variances]
    lib = kernel_library()
    if _route == "simple":
        anchors_in_smem = 16 * N <= _SIMPLE_SMEM_BUDGET
        state_in_smem = (16 * N if anchors_in_smem else 0) + 12 * M \
            <= _SIMPLE_SMEM_BUDGET
        scratch = None if state_in_smem else torch.empty(
            (B, 3 * M), dtype=torch.int32, device=dev)
        code = lib.mxt_multibox_match(
            anchor.data_ptr(), label.data_ptr(), B, N, M,
            float(overlap_threshold), *v, int(anchors_in_smem),
            None if scratch is None else scratch.data_ptr(),
            agt.data_ptr(), aiou.data_ptr(), loc.data_ptr(),
            current_stream_handle(anchor))
        check_launch(code, "multibox_match")
        multibox_match.launches += 1
        return agt, aiou, loc
    split, _, mode, _ = match_plan(B, N, M, sm_count(dev))
    scratch = None if mode else torch.empty(
        (B * split, 10 * M), dtype=torch.int32, device=dev)
    code = lib.mxt_multibox_match_cluster(
        anchor.data_ptr(), label.data_ptr(), B, N, M, split, mode,
        float(overlap_threshold), *v,
        None if scratch is None else scratch.data_ptr(), agt.data_ptr(),
        aiou.data_ptr(), loc.data_ptr(), current_stream_handle(anchor))
    check_launch(code, "multibox_match")
    multibox_match.launches += 1
    multibox_match.sm90_launches += 1
    return agt, aiou, loc


# ---------------------------------------------------------------- the NMS
def _nms_inputs(boxes, ids, valid):
    if boxes.dim() != 3 or boxes.shape[2] != 4 \
            or tuple(ids.shape) != tuple(boxes.shape[:2]) \
            or tuple(valid.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"nms_keep: boxes (B, k, 4), ids and valid (B, k), "
                         f"got {tuple(boxes.shape)}, {tuple(ids.shape)}, "
                         f"{tuple(valid.shape)}")
    return (boxes.detach().float(), ids.detach().float(),
            valid.detach().to(torch.bool))


def _suppression(boxes, ids, overlap_thresh, force_suppress):
    """(k, k) bool: row i suppresses every later j whose IoU with it is at
    least the threshold (and, unless ``force_suppress``, shares its id)."""
    k = ids.shape[0]
    s = pair_iou(boxes[:, None], boxes[None]) >= overlap_thresh
    if not force_suppress:
        s = s & (ids[:, None] == ids[None, :])
    return s & torch.ones((k, k), dtype=torch.bool,
                          device=boxes.device).triu(1)


def nms_keep_reference(boxes, ids, valid, overlap_thresh: float,
                       force_suppress: bool):
    """Plain twin of :func:`nms_keep` (the reference's ``_nms_loop``
    recurrence, batched): the suppression matrix one batch row at a time,
    then the ordered sweep over k."""
    boxes, ids, valid = _nms_inputs(boxes, ids, valid)
    B, k = ids.shape
    sup = torch.empty((B, k, k), dtype=torch.bool, device=boxes.device)
    for b in range(B):
        sup[b] = _suppression(boxes[b], ids[b], overlap_thresh,
                              force_suppress)
    keep = torch.ones((B, k), dtype=torch.bool, device=boxes.device)
    for i in range(k):
        live = keep[:, i] & valid[:, i]
        keep = keep & ~(sup[:, i] & live[:, None])
    return keep & valid


def nms_keep_blocked(boxes, ids, valid, overlap_thresh: float,
                     force_suppress: bool):
    """Plain model of the cluster NMS's sweep (``nms_cluster_kernel``), for
    the CPU tests: the suppression bitmask in 64-bit words (row i, word w:
    bit t for column 64 w + t), rows that are not valid left unbuilt (0);
    the removed set starts with the invalid and padding rows; then word by
    word, the word's 64 rows are resolved against its diagonal words in
    32-bit halves, as the kernel's one thread does (rows 0-31 update both
    halves, rows 32-63 only the high one), and the kept rows' words are
    ORed into every later word."""
    boxes, ids, valid = _nms_inputs(boxes, ids, valid)
    B, k = ids.shape
    W = -(-k // 64)
    weights = [1 << t for t in range(64)]
    keep = torch.zeros((B, k), dtype=torch.bool)
    for b in range(B):
        sup = _suppression(boxes[b], ids[b], overlap_thresh,
                           force_suppress).tolist()
        ok = valid[b].tolist()
        mask = [[sum(wt for wt, s in zip(weights, row[64 * w:64 * w + 64])
                     if s) if ok[i] else 0 for w in range(W)]
                for i, row in enumerate(sup)]
        removed = [sum(weights[t] for t in range(64)
                       if 64 * w + t >= k or not ok[64 * w + t])
                   for w in range(W)]
        for w in range(W):
            diag = [mask[64 * w + t][w] if 64 * w + t < k else 0
                    for t in range(64)]
            lo, hi = removed[w] & 0xFFFFFFFF, removed[w] >> 32
            for t in range(32):
                if not (lo >> t) & 1:
                    lo |= diag[t] & 0xFFFFFFFF
                    hi |= diag[t] >> 32
            for t in range(32):
                if not (hi >> t) & 1:
                    hi |= diag[32 + t] >> 32
            kept = ~((hi << 32) | lo) & (2 ** 64 - 1)
            rows = [t for t in range(64) if (kept >> t) & 1]
            for t in rows:
                keep[b, 64 * w + t] = True
                for w2 in range(w + 1, W):
                    removed[w2] |= mask[64 * w + t][w2]
    return keep


def _rows_contiguous(t, width: int):
    """``t`` itself when each batch row is contiguous (a batch stride is
    allowed, as in a (B, N) tensor's [:, :k] slice), else a contiguous
    copy."""
    if t.stride(-1) == 1 and (width == 1 or t.stride(1) == width):
        return t
    return t.contiguous()


@counted_kernel
def nms_keep(boxes, ids, valid, overlap_thresh: float, force_suppress: bool,
             _route=None):
    """CUDA greedy NMS (replaces the Pallas ``nms_keep``): boxes (B, k, 4),
    ids (B, k) (taken as float32) and valid (B, k) (taken as bool) on one
    card, any k. Returns keep (B, k) bool.

    One launch of the cluster kernel (:func:`nms_plan`), counted in
    ``launches`` and ``sm90_launches``; rows contiguous within a batch row
    (the leading k of wider rows included) are read in place. The private
    ``_route="simple"`` (the first design: a mask launch, then the sweep)
    counts in ``launches`` only."""
    _check_route("nms_keep", _route)
    boxes, ids, valid = _nms_inputs(boxes, ids, valid)
    if not (boxes.is_cuda and ids.device == boxes.device
            and valid.device == boxes.device):
        raise ValueError(f"nms_keep: the kernel takes CUDA tensors on one "
                         f"device, got {boxes.device}, {ids.device}, "
                         f"{valid.device}")
    B, k = ids.shape
    keep = torch.empty((B, k), dtype=torch.bool, device=boxes.device)
    if B == 0 or k == 0:
        return keep
    lib = kernel_library()
    if _route == "simple":
        boxes, ids, valid = (boxes.contiguous(), ids.contiguous(),
                             valid.contiguous())
        words = -(-k // 64)
        if 8 * words + k > _SIMPLE_SMEM_BUDGET:
            raise ValueError(f"nms_keep: {k} candidates exceed the kernel's "
                             "shared-memory removed set")
        mask = torch.empty((B, k, words), dtype=torch.int64,
                           device=boxes.device)
        in_smem = 8 * words + 8 * k * words + k <= _SIMPLE_SMEM_BUDGET
        code = lib.mxt_nms_keep(
            boxes.data_ptr(), ids.data_ptr(), valid.data_ptr(), B, k,
            float(overlap_thresh), int(bool(force_suppress)), int(in_smem),
            mask.data_ptr(), keep.data_ptr(), current_stream_handle(boxes))
        check_launch(code, "nms_keep")
        nms_keep.launches += 1
        return keep
    split, W, mode, _ = nms_plan(B, k, sm_count(boxes.device))
    boxes = _rows_contiguous(boxes, 4)
    if boxes.data_ptr() % 16 or boxes.stride(0) % 4:     # read as float4
        boxes = boxes.clone()
    ids, valid = _rows_contiguous(ids, 1), _rows_contiguous(valid, 1)
    gmask = None if mode == 2 else torch.empty(
        (B, k, W), dtype=torch.int64, device=boxes.device)
    code = lib.mxt_nms_keep_cluster(
        boxes.data_ptr(), ids.data_ptr(), valid.data_ptr(), boxes.stride(0),
        ids.stride(0), valid.stride(0), B, k, split, mode,
        float(overlap_thresh), int(bool(force_suppress)),
        None if gmask is None else gmask.data_ptr(), keep.data_ptr(),
        current_stream_handle(boxes))
    check_launch(code, "nms_keep")
    nms_keep.launches += 1
    nms_keep.sm90_launches += 1
    return keep
