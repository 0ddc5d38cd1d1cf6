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
"""
from __future__ import annotations

import torch

from .common import (check_launch, counted_kernel, current_stream_handle,
                     kernel_library)

__all__ = ["pair_iou", "encode_loc", "match_anchors", "multibox_match",
           "multibox_match_reference", "nms_keep", "nms_keep_reference"]

# dynamic shared memory a block may take (of the H100's 227 KB)
_SMEM_BUDGET = 200 * 1024


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
    var = torch.tensor([float(v) for v in variances], dtype=gt.dtype,
                       device=gt.device)
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


def multibox_match_reference(anchor, label, overlap_threshold: float,
                             variances):
    """Plain twin of :func:`multibox_match` (the reference's
    ``_match_anchors`` and loc encoding, batched)."""
    anchor, label = _match_inputs(anchor, label)
    valid = label[..., 0] >= 0                                  # (B, M)
    iou = pair_iou(label[:, :, None, 1:5], anchor[None, None])   # (B, M, N)
    iou = iou * valid[..., None]
    agt, aiou = match_anchors(iou, valid, overlap_threshold)
    gt = torch.gather(label[..., 1:5], 1,
                      agt.clamp_min(0).long()[..., None].expand(-1, -1, 4))
    loc = encode_loc(anchor, gt, variances)
    loc = torch.where((agt >= 0)[..., None], loc, torch.zeros_like(loc))
    return agt, aiou, loc


@counted_kernel
def multibox_match(anchor, label, overlap_threshold: float, variances):
    """CUDA matcher (replaces the Pallas ``multibox_match``): anchor (N, 4)
    and label (B, M, 5) on one card, any N and M >= 1, taken as float32.
    Returns (anchor_gt (B, N) int32, anchor_iou (B, N), loc_t (B, N, 4))."""
    anchor, label = _match_inputs(anchor, label)
    if not (anchor.is_cuda and label.device == anchor.device):
        raise ValueError(f"multibox_match: the kernel takes CUDA tensors on "
                         f"one device, got {anchor.device} and "
                         f"{label.device}")
    anchor, label = anchor.contiguous(), label.contiguous()
    if anchor.data_ptr() % 16:          # read as float4 outside shared memory
        anchor = anchor.clone()
    B, M, _ = label.shape
    N = anchor.shape[0]
    dev = anchor.device
    agt = torch.empty((B, N), dtype=torch.int32, device=dev)
    aiou = torch.empty((B, N), dtype=torch.float32, device=dev)
    loc = torch.empty((B, N, 4), dtype=torch.float32, device=dev)
    if B == 0:
        return agt, aiou, loc
    anchors_in_smem = 16 * N <= _SMEM_BUDGET
    state_in_smem = (16 * N if anchors_in_smem else 0) + 12 * M \
        <= _SMEM_BUDGET
    scratch = None if state_in_smem else torch.empty(
        (B, 3 * M), dtype=torch.int32, device=dev)
    v = [float(x) for x in variances]
    code = kernel_library().mxt_multibox_match(
        anchor.data_ptr(), label.data_ptr(), B, N, M,
        float(overlap_threshold), v[0], v[1], v[2], v[3],
        int(anchors_in_smem), None if scratch is None else scratch.data_ptr(),
        agt.data_ptr(), aiou.data_ptr(), loc.data_ptr(),
        current_stream_handle(anchor))
    check_launch(code, "multibox_match")
    multibox_match.launches += 1
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


def nms_keep_reference(boxes, ids, valid, overlap_thresh: float,
                       force_suppress: bool):
    """Plain twin of :func:`nms_keep` (the reference's ``_nms_loop``
    recurrence, batched): the suppression matrix one batch row at a time,
    then the ordered sweep over k."""
    boxes, ids, valid = _nms_inputs(boxes, ids, valid)
    B, k = ids.shape
    later = torch.ones((k, k), dtype=torch.bool,
                       device=boxes.device).triu(1)
    sup = torch.empty((B, k, k), dtype=torch.bool, device=boxes.device)
    for b in range(B):
        s = pair_iou(boxes[b, :, None], boxes[b, None]) >= overlap_thresh
        if not force_suppress:
            s = s & (ids[b, :, None] == ids[b, None, :])
        sup[b] = s & later
    keep = torch.ones((B, k), dtype=torch.bool, device=boxes.device)
    for i in range(k):
        live = keep[:, i] & valid[:, i]
        keep = keep & ~(sup[:, i] & live[:, None])
    return keep & valid


@counted_kernel
def nms_keep(boxes, ids, valid, overlap_thresh: float, force_suppress: bool):
    """CUDA greedy NMS (replaces the Pallas ``nms_keep``): boxes (B, k, 4),
    ids (B, k) (taken as float32) and valid (B, k) (taken as bool) on one
    card, any k. Returns keep (B, k) bool."""
    boxes, ids, valid = _nms_inputs(boxes, ids, valid)
    if not (boxes.is_cuda and ids.device == boxes.device
            and valid.device == boxes.device):
        raise ValueError(f"nms_keep: the kernel takes CUDA tensors on one "
                         f"device, got {boxes.device}, {ids.device}, "
                         f"{valid.device}")
    boxes, ids, valid = (boxes.contiguous(), ids.contiguous(),
                         valid.contiguous())
    B, k = ids.shape
    keep = torch.empty((B, k), dtype=torch.bool, device=boxes.device)
    if B == 0 or k == 0:
        return keep
    words = -(-k // 64)
    if 8 * words + k > _SMEM_BUDGET:
        raise ValueError(f"nms_keep: {k} candidates exceed the kernel's "
                         "shared-memory removed set")
    mask = torch.empty((B, k, words), dtype=torch.int64, device=boxes.device)
    in_smem = 8 * words + 8 * k * words + k <= _SMEM_BUDGET
    code = kernel_library().mxt_nms_keep(
        boxes.data_ptr(), ids.data_ptr(), valid.data_ptr(), B, k,
        float(overlap_thresh), int(bool(force_suppress)), int(in_smem),
        mask.data_ptr(), keep.data_ptr(), current_stream_handle(boxes))
    check_launch(code, "nms_keep")
    nms_keep.launches += 1
    return keep
