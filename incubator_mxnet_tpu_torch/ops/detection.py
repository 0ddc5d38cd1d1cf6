"""Object-detection ops: anchors, target assignment, decoding, NMS, ROI ops.

Counterpart of ``incubator_mxnet_tpu/ops/detection.py`` (ref:
src/operator/contrib/multibox_prior.cc, multibox_target.cc,
multibox_detection.cc, bounding_box.cc, roi_align.cc,
bilinear_resize.cc, adaptive_avg_pooling.cc). The reference's ``vmap``s
are batch dimensions written out. Its two ``fori_loop``s are the B9
kernels (``ops/cuda/detection.py``): the target matcher in
:func:`multibox_target` and the greedy NMS behind
:func:`multibox_detection` and :func:`box_nms`. A CUDA tensor always takes
the kernel and a CPU tensor always takes its plain twin; the reference's
VMEM viability gates describe the TPU and have no counterpart here. Both
are selection ops, computed without a gradient.

All boxes are corner format (xmin, ymin, xmax, ymax) unless stated.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .cuda import detection as _k
from .cuda.detection import encode_loc as _encode_loc  # noqa: F401
from .cuda.detection import match_anchors as _match_anchors  # noqa: F401

__all__ = ["multibox_prior", "multibox_target", "multibox_detection",
           "box_iou", "box_nms", "roi_align", "bilinear_resize2d",
           "adaptive_avg_pool2d"]


def multibox_prior(feat_h: int, feat_w: int, sizes=(1.0,), ratios=(1.0,),
                   clip: bool = False, steps=(-1.0, -1.0),
                   offsets=(0.5, 0.5), device=None) -> torch.Tensor:
    """Anchor boxes for one feature map; (1, H*W*(ns+nr-1), 4), float32
    whatever the network's type (ref: multibox_prior.cc:30): per pixel,
    every size with the first ratio, then every other ratio with the first
    size; widths carry the h/w aspect correction."""
    f32 = dict(dtype=torch.float32, device=device)
    sizes = torch.tensor([float(s) for s in sizes], **f32)
    ratios = torch.tensor([float(r) for r in ratios], **f32)
    step_y = steps[0] if steps[0] > 0 else 1.0 / feat_h
    step_x = steps[1] if steps[1] > 0 else 1.0 / feat_w
    cy = (torch.arange(feat_h, **f32) + offsets[0]) * step_y
    cx = (torch.arange(feat_w, **f32) + offsets[1]) * step_x

    aspect = feat_h / feat_w
    w_sizes = sizes * aspect / 2.0
    h_sizes = sizes / 2.0
    sr = torch.sqrt(ratios[1:])
    w_ratios = sizes[0] * aspect * sr / 2.0
    h_ratios = sizes[0] / sr / 2.0
    half_w = torch.cat([w_sizes, w_ratios])
    half_h = torch.cat([h_sizes, h_ratios])

    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")        # (H, W)
    cxg = cxg[:, :, None]
    cyg = cyg[:, :, None]
    boxes = torch.stack([cxg - half_w, cyg - half_h,
                         cxg + half_w, cyg + half_h], dim=-1)  # (H, W, A, 4)
    boxes = boxes.reshape(1, -1, 4)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    return boxes


def box_iou(lhs: torch.Tensor, rhs: torch.Tensor,
            fmt: str = "corner") -> torch.Tensor:
    """Pairwise IoU: (..., N, 4) x (..., M, 4) -> (..., N, M)
    (ref: bounding_box.cc box_iou)."""
    if fmt == "center":
        lhs = _center_to_corner(lhs)
        rhs = _center_to_corner(rhs)
    return _k.pair_iou(lhs[..., :, None, :], rhs[..., None, :, :])


def _center_to_corner(b):
    cx, cy, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def multibox_target(anchor: torch.Tensor, label: torch.Tensor,
                    cls_pred: torch.Tensor, overlap_threshold: float = 0.5,
                    ignore_label: float = -1.0,
                    negative_mining_ratio: float = -1.0,
                    negative_mining_thresh: float = 0.5,
                    minimum_negative_samples: int = 0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD training target assignment (ref: multibox_target.cc).

    anchor (1, N, 4); label (B, M, 5) rows [cls, xmin, ymin, xmax, ymax]
    with cls = -1 padding; cls_pred (B, C+1, N) raw logits.
    Returns (box_target (B, N*4), box_mask (B, N*4), cls_target (B, N)),
    none of them carrying a gradient. The IoU, matching and encoding run in
    the ``multibox_match`` kernel on the card (its twin on the CPU);
    hard-negative mining is the double stable argsort, outside it.
    """
    anchor = anchor.detach().reshape(-1, 4).float()
    label = label.detach().float()
    cls_pred = cls_pred.detach()
    N = anchor.shape[0]
    match = _k.multibox_match if anchor.is_cuda else \
        _k.multibox_match_reference
    anchor_gt, anchor_iou, loc_t = match(anchor, label, overlap_threshold,
                                        variances)

    pos = anchor_gt >= 0                                        # (B, N)
    gt_idx = anchor_gt.clamp_min(0).long()
    gt_cls = torch.gather(label[..., 0], 1, gt_idx)
    cls_target = torch.where(pos, gt_cls + 1.0, torch.zeros_like(gt_cls))
    box_mask = pos[..., None].expand(loc_t.shape).to(torch.float32)
    if negative_mining_ratio > 0:
        # rank non-positive anchors by background confidence ascending
        # (low background prob = hardest negative), keep ratio * num_pos
        # as explicit negatives, ignore the rest (ref:
        # multibox_target.cc:181-240)
        bg_prob = torch.softmax(cls_pred, dim=1)[:, 0]           # (B, N)
        num_pos = pos.sum(dim=1, keepdim=True).to(torch.int32)
        num_neg = torch.minimum(
            torch.clamp_min((num_pos * negative_mining_ratio)
                            .to(torch.int32), minimum_negative_samples),
            N - num_pos)
        candidate = ~pos & (anchor_iou < negative_mining_thresh)
        order_key = torch.where(candidate, bg_prob,
                                torch.full_like(bg_prob, float("inf")))
        rank = torch.argsort(torch.argsort(order_key, dim=1, stable=True),
                             dim=1, stable=True)
        negative = candidate & (rank < num_neg)
        cls_target = torch.where(
            pos, cls_target,
            torch.where(negative, torch.zeros_like(cls_target),
                        torch.full_like(cls_target, ignore_label)))
    B = label.shape[0]
    return (loc_t.reshape(B, -1), box_mask.reshape(B, -1), cls_target)


def _decode_loc(anchor, loc, variances, clip):
    """ref: multibox_detection.cc:46 TransformLocations."""
    aw = anchor[..., 2] - anchor[..., 0]
    ah = anchor[..., 3] - anchor[..., 1]
    ax = (anchor[..., 0] + anchor[..., 2]) / 2
    ay = (anchor[..., 1] + anchor[..., 3]) / 2
    ox = loc[..., 0] * variances[0] * aw + ax
    oy = loc[..., 1] * variances[1] * ah + ay
    ow = torch.exp(loc[..., 2] * variances[2]) * aw / 2
    oh = torch.exp(loc[..., 3] * variances[3]) * ah / 2
    out = torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], -1)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out


def _nms_loop(boxes, ids, scores, valid, nms_threshold, force_suppress,
              nms_topk):
    """Greedy NMS of one row (N, 4) / (N,), entries sorted by score
    descending; suppressed entries get id -1 (ref:
    multibox_detection.cc:148-190). Only the leading ``nms_topk`` rows take
    part; the rest come back -1."""
    return _nms_ids(boxes[None], ids[None], scores[None], valid[None],
                    nms_threshold, force_suppress, nms_topk)[0]


def _nms_ids(boxes, ids, scores, valid, nms_threshold, force_suppress,
             nms_topk):
    """Batched NMS: boxes (B, N, 4), ids/scores/valid (B, N), rows sorted
    score-descending. Returns the surviving ids (B, N), suppressed entries
    -1. The leading k = min(nms_topk, N) rows (all N when nms_topk <= 0) go
    through ``nms_keep``: the kernel on the card, its twin on the CPU."""
    B, N = ids.shape
    k = min(nms_topk, N) if nms_topk > 0 else N
    nms = _k.nms_keep if boxes.is_cuda else _k.nms_keep_reference
    keep = nms(boxes[:, :k], ids[:, :k], valid[:, :k], nms_threshold,
               force_suppress)
    head = torch.where(keep, ids[:, :k], torch.full_like(ids[:, :k], -1.0))
    if k == N:
        return head
    return torch.cat([head, torch.full((B, N - k), -1.0, dtype=head.dtype,
                                       device=head.device)], dim=1)


def multibox_detection(cls_prob: torch.Tensor, loc_pred: torch.Tensor,
                       anchor: torch.Tensor, clip: bool = True,
                       threshold: float = 0.01, background_id: int = 0,
                       nms_threshold: float = 0.5,
                       force_suppress: bool = False,
                       variances=(0.1, 0.1, 0.2, 0.2),
                       nms_topk: int = -1) -> torch.Tensor:
    """Decode + NMS; output (B, N, 6) rows [cls_id, score, x1, y1, x2, y2],
    cls_id -1 for suppressed/background, rows sorted by validity then
    score (ref: multibox_detection.cc MultiBoxDetectionForward)."""
    assert background_id == 0, "reference semantics: class 0 is background"
    cls_prob, loc_pred = cls_prob.detach(), loc_pred.detach()
    anchor = anchor.detach().reshape(-1, 4)
    B = cls_prob.shape[0]
    loc = loc_pred.reshape(B, -1, 4)
    fg = cls_prob[:, 1:]                                  # (B, C, N)
    score = torch.amax(fg, dim=1)
    cls_id = torch.argmax(fg, dim=1).to(torch.float32)    # 0-based fg id
    ids = torch.where(score >= threshold, cls_id,
                      torch.full_like(cls_id, -1.0))
    boxes = _decode_loc(anchor, loc, variances, clip)
    # sort: valid first, then score descending (stable, fixed shape)
    key = torch.where(ids >= 0, -score, torch.full_like(score,
                                                         float("inf")))
    order = torch.argsort(key, dim=1, stable=True)
    boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    ids = torch.gather(ids, 1, order)
    score = torch.gather(score, 1, order)
    if 0 < nms_threshold <= 1:
        ids = _nms_ids(boxes, ids, score, ids >= 0, nms_threshold,
                       force_suppress, nms_topk)
    # suppressed/background rows keep score+box but id = -1 (ref parity)
    dt = torch.promote_types(torch.promote_types(ids.dtype, score.dtype),
                             boxes.dtype)
    return torch.cat([ids[..., None].to(dt), score[..., None].to(dt),
                      boxes.to(dt)], dim=2)


def box_nms(data: torch.Tensor, overlap_thresh: float = 0.5,
            valid_thresh: float = 0.0, topk: int = -1, coord_start: int = 2,
            score_index: int = 1, id_index: int = -1,
            force_suppress: bool = False) -> torch.Tensor:
    """Generic NMS over (..., N, K) records; suppressed records become -1,
    survivors sorted by score descending (ref: bounding_box.cc box_nms)."""
    data = data.detach()
    shape = data.shape
    d = data.reshape((-1,) + tuple(shape[-2:]))
    score = d[..., score_index]
    boxes = d[..., coord_start:coord_start + 4]
    ids = (d[..., id_index] if id_index >= 0
           else torch.zeros_like(score))
    valid = score > valid_thresh
    key = torch.where(valid, -score, torch.full_like(score, float("inf")))
    order = torch.argsort(key, dim=1, stable=True)
    d_s = torch.gather(d, 1, order[..., None].expand(-1, -1, d.shape[-1]))
    kept_ids = _nms_ids(torch.gather(boxes, 1, order[..., None].expand(
        -1, -1, 4)), torch.gather(ids, 1, order),
        torch.gather(score, 1, order), torch.gather(valid, 1, order),
        overlap_thresh, force_suppress, topk)
    out = torch.where(kept_ids[..., None] >= 0, d_s, -torch.ones_like(d_s))
    return out.reshape(shape)


def roi_align(data: torch.Tensor, rois: torch.Tensor,
              pooled_size: Tuple[int, int], spatial_scale: float,
              sample_ratio: int = -1) -> torch.Tensor:
    """ROIAlign (B, C, H, W) x (R, 5 [batch, x1, y1, x2, y2]) ->
    (R, C, ph, pw); average of bilinear samples per bin
    (ref: roi_align.cc ROIAlignForward)."""
    ph, pw = pooled_size
    B, C, H, W = data.shape
    sr = sample_ratio if sample_ratio > 0 else 2
    outs = []
    for roi in rois:
        bidx = int(roi[0].item())
        x1, y1, x2, y2 = roi[1:] * spatial_scale
        rw = torch.clamp_min(x2 - x1, 1.0)
        rh = torch.clamp_min(y2 - y1, 1.0)
        bin_w = rw / pw
        bin_h = rh / ph
        ar_y = torch.arange(ph * sr, dtype=data.dtype, device=data.device)
        ar_x = torch.arange(pw * sr, dtype=data.dtype, device=data.device)
        gy = y1 + (ar_y + 0.5) * bin_h / sr
        gx = x1 + (ar_x + 0.5) * bin_w / sr
        yy, xx = torch.meshgrid(gy, gx, indexing="ij")
        sampled = _bilinear_sample(data[bidx], yy, xx)   # (C, ph*sr, pw*sr)
        outs.append(sampled.reshape(C, ph, sr, pw, sr).mean(dim=(2, 4)))
    if not outs:
        return data.new_zeros((0, C, ph, pw))
    return torch.stack(outs)


def _bilinear_sample(img, yy, xx):
    """img (C, H, W); sample at float coords (out-of-range -> 0)."""
    C, H, W = img.shape
    y0 = torch.floor(yy)
    x0 = torch.floor(xx)
    wy = yy - y0
    wx = xx - x0
    out = 0.0
    for dy, wyy in ((0, 1 - wy), (1, wy)):
        for dx, wxx in ((0, 1 - wx), (1, wx)):
            yi = (y0 + dy).to(torch.int32)
            xi = (x0 + dx).to(torch.int32)
            inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            yc = torch.clamp(yi, 0, H - 1).long()
            xc = torch.clamp(xi, 0, W - 1).long()
            val = img[:, yc, xc]                       # (C, gh, gw)
            out = out + val * (wyy * wxx * inb)[None]
    return out


def bilinear_resize2d(data: torch.Tensor, height: int,
                      width: int) -> torch.Tensor:
    """NCHW bilinear resize with align_corners=True (the caffe convention
    of the reference kernel; ref: bilinear_resize.cc)."""
    B, C, H, W = data.shape
    sy = (H - 1) / (height - 1) if height > 1 else 0.0
    sx = (W - 1) / (width - 1) if width > 1 else 0.0
    yy = torch.arange(height, dtype=torch.float32, device=data.device) * sy
    xx = torch.arange(width, dtype=torch.float32, device=data.device) * sx
    yg, xg = torch.meshgrid(yy, xx, indexing="ij")
    flat = data.reshape(B * C, H, W)
    return _bilinear_sample(flat, yg, xg).reshape(B, C, height, width)


def adaptive_avg_pool2d(data: torch.Tensor,
                        output_size: Tuple[int, int]) -> torch.Tensor:
    """NCHW adaptive average pooling through a 2-D integral image: every
    output cell is a box sum (ref: adaptive_avg_pooling.cc)."""
    oh, ow = output_size
    B, C, H, W = data.shape
    integral = torch.cumsum(torch.cumsum(data, dim=2), dim=3)
    integral = torch.nn.functional.pad(integral, (1, 0, 1, 0))
    dev = data.device
    ys = (torch.arange(oh, device=dev) * H) // oh
    ye = -(-(torch.arange(1, oh + 1, device=dev) * H) // oh)     # ceil
    xs = (torch.arange(ow, device=dev) * W) // ow
    xe = -(-(torch.arange(1, ow + 1, device=dev) * W) // ow)
    s_ee = integral[:, :, ye][:, :, :, xe]
    s_se = integral[:, :, ys][:, :, :, xe]
    s_es = integral[:, :, ye][:, :, :, xs]
    s_ss = integral[:, :, ys][:, :, :, xs]
    area = ((ye - ys)[:, None] * (xe - xs)[None, :]).to(data.dtype)
    return (s_ee - s_se - s_es + s_ss) / area
