"""``nd.contrib``: control flow, the detection and vision ops, and the
reference's small contrib helpers.

Counterpart of ``incubator_mxnet_tpu/ndarray/contrib.py`` (ref:
src/operator/control_flow.cc ``_foreach``, ``_while_loop``, ``_cond``;
src/operator/contrib/; python/mxnet/ndarray/contrib.py). The port runs
eagerly, so ``foreach``, ``while_loop`` and ``cond`` are Python loops and
branches on the tape: the reference's own imperative path. The detection
ops go through ``ops/detection.py``, whose target matcher and NMS are the
B9 kernels on the card. Every op runs through :func:`invoke`, so it is
differentiable under ``autograd.record()`` where the reference's is, and
the target and detection ops, which take no gradient, return detached
results. The quantization ops are ``ops/quantization.py``'s (the int8
products on the ``qconv_s8`` / ``qgemm_s8`` kernels on the card), taking
NDArrays and returning them; ``edge_id`` and ``getnnz`` take CSR arrays
(``ndarray/sparse.py``).
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from ..ops import detection as _det
from ..ops import device_vector
from ..ops import quantization as _quant
from .ndarray import NDArray, _as_nd, _wrap, invoke, stack
from .ops import Embedding
from .optimizer_ops import group_adagrad_update  # noqa: F401

__all__ = ["foreach", "while_loop", "cond", "isinf", "isnan", "isfinite",
           "MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection", "box_iou",
           "box_nms", "ROIAlign", "BilinearResize2D", "AdaptiveAvgPooling2D",
           "boolean_mask", "index_copy", "quadratic", "div_sqrt_dim", "fft",
           "ifft", "count_sketch", "arange_like", "DeformableConvolution",
           "PSROIPooling", "Proposal", "krprod", "getnnz", "edge_id",
           "bipartite_matching", "SparseEmbedding", "group_adagrad_update",
           "quantize", "quantize_v2", "dequantize", "requantize",
           "quantized_concat", "quantized_conv", "quantized_flatten",
           "quantized_fully_connected", "quantized_pooling"]


def _as_list(x):
    if isinstance(x, (list, tuple)):
        return list(x), True
    return [x], False


def _truth(c) -> bool:
    return bool(c.asnumpy().item()) if isinstance(c, NDArray) else bool(c)


def foreach(body: Callable, data, init_states):
    """Scan ``body`` over axis 0 of ``data`` (ref: contrib.foreach).

    body(data_slice, states) -> (outs, new_states). Returns (outs stacked
    on a new axis 0, final states), keeping the structure of both."""
    data_list, data_was_list = _as_list(data)
    states, states_was_list = _as_list(init_states)
    n = data_list[0].shape[0]
    if n == 0:
        # no iterations: the outputs are unknowable without the body
        return [], (states if states_was_list else states[0])
    outs_acc, o_was_list = None, False
    for i in range(n):
        slices = [d[i] for d in data_list]
        o, states = body(slices if data_was_list else slices[0],
                         states if states_was_list else states[0])
        states, _ = _as_list(states)
        o_list, o_was_list = _as_list(o)
        if outs_acc is None:
            outs_acc = [[] for _ in o_list]
        for acc, oo in zip(outs_acc, o_list):
            acc.append(oo)
    outs = [stack(*acc, axis=0) for acc in outs_acc]
    return (outs if o_was_list else outs[0],
            states if states_was_list else states[0])


def while_loop(cond_fn: Callable, func: Callable, loop_vars,
               max_iterations: int = None):
    """Bounded while loop (ref: contrib.while_loop): cond_fn(*loop_vars)
    -> boolean scalar; func(*loop_vars) -> (step_output, new_loop_vars).
    Returns (the steps' outputs stacked, the final loop_vars); no step
    taken gives an empty output list."""
    cur, was_list = _as_list(loop_vars)
    steps, outs_acc, o_was_list = 0, None, False
    while max_iterations is None or steps < max_iterations:
        if not _truth(cond_fn(*cur)):
            break
        o, cur = func(*cur)
        cur, _ = _as_list(cur)
        o_list, o_was_list = _as_list(o)
        if outs_acc is None:
            outs_acc = [[] for _ in o_list]
        for acc, oo in zip(outs_acc, o_list):
            acc.append(oo)
        steps += 1
    if outs_acc is None:
        outs = []
    else:
        outs = [stack(*acc, axis=0) for acc in outs_acc]
        outs = outs if o_was_list else outs[0]
    return outs, (cur if was_list else cur[0])


def cond(pred, then_func: Callable, else_func: Callable):
    """Conditional execution (ref: contrib.cond): pred a boolean scalar,
    the branches no-argument closures."""
    return then_func() if _truth(pred) else else_func()


def isinf(data):
    return invoke(torch.isinf, [data], "isinf")


def isnan(data):
    return invoke(torch.isnan, [data], "isnan")


def isfinite(data):
    return invoke(torch.isfinite, [data], "isfinite")


# ------------------------------------------ detection / vision contrib ops
def MultiBoxPrior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                  steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchors for an NCHW feature map, float32 whatever its type
    (ref: src/operator/contrib/multibox_prior.cc)."""
    h, w = data.shape[2], data.shape[3]
    return invoke(lambda x: _det.multibox_prior(h, w, sizes, ratios, clip,
                                                steps, offsets, x.device),
                  [data], "MultiBoxPrior")


def MultiBoxTarget(anchor, label, cls_pred, overlap_threshold=0.5,
                   ignore_label=-1.0, negative_mining_ratio=-1.0,
                   negative_mining_thresh=0.5, minimum_negative_samples=0,
                   variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD target assignment -> [box_target, box_mask, cls_target], none
    carrying a gradient (ref: src/operator/contrib/multibox_target.cc)."""
    return list(invoke(
        lambda a, l, c: _det.multibox_target(
            a, l, c, overlap_threshold, ignore_label, negative_mining_ratio,
            negative_mining_thresh, minimum_negative_samples, variances),
        [anchor, label, cls_pred], "MultiBoxTarget", n_out=3))


def MultiBoxDetection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                      background_id=0, nms_threshold=0.5,
                      force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                      nms_topk=-1):
    """Decode SSD predictions + NMS -> (B, N, 6)
    (ref: src/operator/contrib/multibox_detection.cc)."""
    return invoke(
        lambda c, l, a: _det.multibox_detection(
            c, l, a, clip, threshold, background_id, nms_threshold,
            force_suppress, variances, nms_topk),
        [cls_prob, loc_pred, anchor], "MultiBoxDetection")


def box_iou(lhs, rhs, format="corner"):  # noqa: A002 - reference name
    """Pairwise IoU (ref: src/operator/contrib/bounding_box.cc)."""
    return invoke(lambda a, b: _det.box_iou(a, b, fmt=format), [lhs, rhs],
                  "box_iou")


def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, force_suppress=False,
            in_format="corner", out_format="corner"):
    """NMS over records; suppressed records become -1
    (ref: src/operator/contrib/bounding_box.cc _contrib_box_nms)."""
    assert in_format == "corner" and out_format == "corner", \
        "only corner format currently supported"
    return invoke(
        lambda d: _det.box_nms(d, overlap_thresh, valid_thresh, topk,
                               coord_start, score_index, id_index,
                               force_suppress),
        [data], "box_nms")


def ROIAlign(data, rois, pooled_size, spatial_scale, sample_ratio=-1):
    """(ref: src/operator/contrib/roi_align.cc _contrib_ROIAlign)."""
    return invoke(
        lambda d, r: _det.roi_align(d, r, tuple(pooled_size), spatial_scale,
                                    sample_ratio),
        [data, rois], "ROIAlign")


def BilinearResize2D(data, height, width):
    """(ref: src/operator/contrib/bilinear_resize.cc)."""
    return invoke(lambda d: _det.bilinear_resize2d(d, height, width), [data],
                  "BilinearResize2D")


def AdaptiveAvgPooling2D(data, output_size):
    """(ref: src/operator/contrib/adaptive_avg_pooling.cc)."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    return invoke(lambda d: _det.adaptive_avg_pool2d(d, tuple(output_size)),
                  [data], "AdaptiveAvgPooling2D")


def boolean_mask(data, index, axis=0):
    """The slices along ``axis`` where index != 0 (ref:
    src/operator/contrib/boolean_mask.cc); the output's shape depends on
    the data."""
    def f(x, m):
        keep = torch.nonzero(m.reshape(-1) != 0).reshape(-1)
        return torch.index_select(x, axis, keep)
    return invoke(f, [data, _as_nd(index, data)], "boolean_mask")


def index_copy(old_tensor, index_vector, new_tensor):
    """Copy rows of new_tensor into old_tensor at index_vector
    (ref: src/operator/contrib/index_copy.cc)."""
    return invoke(lambda o, i, n: o.index_copy(0, i.long(), n.to(o.dtype)),
                  [old_tensor, index_vector, new_tensor], "index_copy")


def quadratic(data, a=0.0, b=0.0, c=0.0):
    """a*x^2 + b*x + c, the reference's tutorial op
    (ref: src/operator/contrib/quadratic_op.cc)."""
    return invoke(lambda x: a * x * x + b * x + c, [data], "quadratic")


def div_sqrt_dim(data):
    """x / sqrt(last dim) in float32 or wider, as the reference divides by a
    float32 (ref: src/operator/contrib/transformer.cc:34)."""
    def f(x):
        dt = torch.promote_types(x.dtype, torch.float32)
        root = torch.sqrt(torch.full((), float(x.shape[-1]), dtype=dt,
                                     device=x.device))
        return x.to(dt) / root
    return invoke(f, [data], "div_sqrt_dim")


def _dft_mats(d, device):
    """The real and imaginary DFT matrices, as the reference builds them
    (angles in float32)."""
    j = torch.arange(d, dtype=torch.float32, device=device)
    ang = 2.0 * math.pi * j[:, None] * j[None, :] / d
    return torch.cos(ang), torch.sin(ang)


def fft(data, compute_size=128):
    """Real -> interleaved-complex DFT over the last axis: (..., d) ->
    (..., 2d), [re, im, re, im, ...] (ref: src/operator/contrib/fft-inl.h;
    the reference's dense DFT, two products)."""
    def f(x):
        x = x.to(torch.float32)
        cos, sin = _dft_mats(x.shape[-1], x.device)
        out = torch.stack([x @ cos, -(x @ sin)], dim=-1)
        return out.reshape(x.shape[:-1] + (2 * x.shape[-1],))
    return invoke(f, [data], "fft")


def ifft(data, compute_size=128):
    """Interleaved-complex -> real inverse DFT: (..., 2d) -> (..., d),
    unnormalised: ifft(fft(x)) == d * x (ref: fft-inl.h IFFT)."""
    def f(x):
        d = x.shape[-1] // 2
        pairs = x.reshape(x.shape[:-1] + (d, 2))
        cos, sin = _dft_mats(d, x.device)
        return pairs[..., 0] @ cos - pairs[..., 1] @ sin
    return invoke(f, [data], "ifft")


def count_sketch(data, h, s, out_dim):
    """Count-sketch projection: out[..., h[j]] += s[j] * data[..., j]
    (ref: src/operator/contrib/count_sketch-inl.h); h (1, in_dim) bucket
    ids, s (1, in_dim) signs."""
    def f(x, hh, ss):
        signed = x * ss.reshape(-1).to(x.dtype)
        zeros = x.new_zeros(x.shape[:-1] + (out_dim,))
        return zeros.index_add(x.dim() - 1, hh.reshape(-1).long(), signed)
    return invoke(f, [data, _as_nd(h, data), _as_nd(s, data)],
                  "count_sketch")


def arange_like(data, start=0.0, step=1.0, repeat=1, axis=None):
    """arange shaped like data, or like its ``axis`` (ref:
    src/operator/tensor/init_op.cc _contrib_arange_like)."""
    def f(x):
        n = x.numel() if axis is None else x.shape[axis]
        shape = x.shape if axis is None else (n,)
        vals = start + step * (torch.arange(n, device=x.device) // repeat)
        return vals.reshape(shape).to(x.dtype)
    return invoke(f, [data], "arange_like")


def DeformableConvolution(data, offset, weight, bias=None, kernel=(3, 3),
                          stride=(1, 1), pad=(0, 0), dilate=(1, 1),
                          num_filter=0, num_deformable_group=1,
                          no_bias=False, num_group=1, **kw):
    """Deformable convolution v1 (ref: src/operator/contrib/
    deformable_convolution.cc): offset (B, 2*G*kh*kw, H', W') gives each
    kernel tap's (dy, dx) per output position, sampled bilinearly; the
    deformed im2col columns then meet the weights in one product."""
    if num_group != 1:
        raise NotImplementedError(
            "DeformableConvolution num_group>1 is not supported")
    if kw:
        raise TypeError(f"unsupported DeformableConvolution kwargs "
                        f"{sorted(kw)}")
    kh, kw_ = kernel
    sh, sw = stride
    ph, pw = pad
    dh, dw = dilate
    G = num_deformable_group

    def f(x, off, w, *maybe_b):
        B, C, H, W = x.shape
        OH = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
        OW = (W + 2 * pw - (dw * (kw_ - 1) + 1)) // sw + 1
        xp = torch.nn.functional.pad(x, (pw, pw, ph, ph))
        off = off.reshape(B, G, kh * kw_, 2, OH, OW)
        dev = x.device
        tap_y = torch.repeat_interleave(torch.arange(kh, device=dev) * dh,
                                        kw_)
        tap_x = torch.tile(torch.arange(kw_, device=dev) * dw, (kh,))
        oy = torch.arange(OH, device=dev) * sh
        ox = torch.arange(OW, device=dev) * sw
        cg = C // G
        cols = []
        for img, o in zip(xp, off):
            per_group = []
            for g in range(G):
                yy = oy[None, :, None] + tap_y[:, None, None] + o[g, :, 0]
                xx = ox[None, None, :] + tap_x[:, None, None] + o[g, :, 1]
                samp = _det._bilinear_sample(img[g * cg:(g + 1) * cg],
                                             yy.reshape(-1), xx.reshape(-1))
                per_group.append(samp.reshape(cg, kh * kw_, OH, OW))
            cols.append(torch.cat(per_group, dim=0))
        cols = torch.stack(cols).reshape(B, C * kh * kw_, OH * OW)
        out = torch.einsum("fk,bkn->bfn", w.reshape(num_filter, -1), cols)
        out = out.reshape(B, num_filter, OH, OW)
        if maybe_b:
            out = out + maybe_b[0].reshape(1, -1, 1, 1)
        return out

    ins = [data, offset, weight] + ([] if (bias is None or no_bias)
                                    else [bias])
    return invoke(f, ins, "DeformableConvolution")


def PSROIPooling(data, rois, output_dim, pooled_size, spatial_scale,
                 group_size=None, **kw):
    """Position-sensitive ROI pooling (ref: src/operator/contrib/
    psroi_pooling.cc, the R-FCN head): channels are (output_dim,
    group_size, group_size); bin (i, j) of the pooled grid averages channel
    group (i*gs//k, j*gs//k) over the bin's pixels, with the reference's
    ROI rounding: start = round(x1)*scale, end = (round(x2)+1)*scale."""
    if kw:
        raise TypeError(f"unsupported PSROIPooling kwargs {sorted(kw)}")
    k = pooled_size
    gs = pooled_size if group_size is None else group_size

    def f(x, r):
        B, C, H, W = x.shape
        assert C == output_dim * gs * gs, (C, output_dim, gs)
        xg = x.reshape(B, output_dim, gs, gs, H, W)
        ygrid = torch.arange(H, device=x.device)
        xgrid = torch.arange(W, device=x.device)
        outs = []
        for roi in r:
            bidx = int(roi[0].item())
            x1 = torch.round(roi[1]) * spatial_scale
            y1 = torch.round(roi[2]) * spatial_scale
            x2 = (torch.round(roi[3]) + 1.0) * spatial_scale
            y2 = (torch.round(roi[4]) + 1.0) * spatial_scale
            rw = torch.clamp_min(x2 - x1, 0.1)
            rh = torch.clamp_min(y2 - y1, 0.1)
            rows = []
            for i in range(k):
                ys = torch.floor(y1 + i * rh / k)
                ye = torch.maximum(torch.ceil(y1 + (i + 1) * rh / k), ys + 1)
                my = (ygrid >= ys) & (ygrid < ye)
                cols = []
                for j in range(k):
                    xs = torch.floor(x1 + j * rw / k)
                    xe = torch.maximum(torch.ceil(x1 + (j + 1) * rw / k),
                                       xs + 1)
                    mask = my[:, None] & ((xgrid >= xs) & (xgrid < xe))
                    plane = xg[bidx, :, (i * gs) // k, (j * gs) // k]
                    s = torch.where(mask, plane, torch.zeros_like(plane)) \
                        .sum(dim=(1, 2))
                    cols.append(s / torch.clamp_min(mask.sum(), 1))
                rows.append(torch.stack(cols, dim=-1))
            outs.append(torch.stack(rows, dim=-2))           # (dim, k, k)
        if not outs:
            return x.new_zeros((0, output_dim, k, k))
        return torch.stack(outs)

    return invoke(f, [data, rois], "PSROIPooling")


def Proposal(cls_prob, bbox_pred, im_info, feature_stride=16,
             scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
             rpn_pre_nms_top_n=6000, rpn_post_nms_top_n=300,
             threshold=0.7, rpn_min_size=16, output_score=False, **kw):
    """RPN proposal generation (ref: src/operator/contrib/proposal.cc):
    decode anchor deltas, clip to the image, drop boxes under the minimum
    size (scaled by im_info[2]), greedy NMS with the reference's end+1
    pixel areas, survivors in rank order. rois are (B * post_n, 5), the
    batch index in column 0; slots past the survivors repeat the
    top-scoring box. output_score=True also returns the (B * post_n, 1)
    scores."""
    if kw:
        raise TypeError(f"unsupported Proposal kwargs {sorted(kw)}")
    A = len(scales) * len(ratios)
    post_n = rpn_post_nms_top_n

    def f(scores, deltas, info):
        B, _, H, W = scores.shape
        dev = scores.device
        fg = scores[:, A:]                                  # (B, A, H, W)
        anchors = []
        for r in ratios:
            for s in scales:
                size = s * feature_stride
                w_a = size * (1.0 / r) ** 0.5
                h_a = size * r ** 0.5
                anchors.append([-w_a / 2, -h_a / 2, w_a / 2, h_a / 2])
        base = device_vector([v for a in anchors for v in a], torch.float32,
                             dev).reshape(-1, 4)
        shift_x = (torch.arange(W, device=dev) + 0.5) * feature_stride
        shift_y = (torch.arange(H, device=dev) + 0.5) * feature_stride
        sx, sy = torch.meshgrid(shift_x, shift_y, indexing="xy")
        shifts = torch.stack([sx, sy, sx, sy], -1).reshape(-1, 1, 4)
        all_anchors = (shifts + base[None]).reshape(-1, 4)  # (H*W*A, 4)
        aw = all_anchors[:, 2] - all_anchors[:, 0]
        ah = all_anchors[:, 3] - all_anchors[:, 1]
        ax = (all_anchors[:, 0] + all_anchors[:, 2]) / 2
        ay = (all_anchors[:, 1] + all_anchors[:, 3]) / 2
        rois, scs_out = [], []
        for sc, dl, im in zip(fg, deltas, info):
            scs = sc.permute(1, 2, 0).reshape(-1)
            dls = dl.reshape(A, 4, H, W).permute(2, 3, 0, 1).reshape(-1, 4)
            cx = dls[:, 0] * aw + ax
            cy = dls[:, 1] * ah + ay
            nw = torch.exp(torch.clamp(dls[:, 2], -10, 10)) * aw
            nh = torch.exp(torch.clamp(dls[:, 3], -10, 10)) * ah
            boxes = torch.stack([cx - nw / 2, cy - nh / 2,
                                 cx + nw / 2, cy + nh / 2], -1)
            boxes = torch.clamp(boxes, torch.zeros_like(boxes),
                                torch.stack([im[1], im[0], im[1], im[0]])
                                - 1.0)
            min_sz = rpn_min_size * im[2]
            keep = ((boxes[:, 2] - boxes[:, 0] + 1 >= min_sz)
                    & (boxes[:, 3] - boxes[:, 1] + 1 >= min_sz))
            scs = torch.where(keep, scs, torch.full_like(scs, -1.0))
            n_pre = min(rpn_pre_nms_top_n, scs.shape[0])
            # lax.top_k: descending, the lower index first in a tie
            order = torch.sort(scs, descending=True, stable=True).indices
            top_i = order[:n_pre]
            top_sc, top_boxes = scs[top_i], boxes[top_i]
            plus1 = top_boxes + device_vector([0.0, 0.0, 1.0, 1.0],
                                              top_boxes.dtype, dev)
            ids = _det._nms_loop(plus1, torch.zeros_like(top_sc), top_sc,
                                 top_sc > 0, threshold, True, -1)
            survive = ids >= 0
            rank = torch.cumsum(survive.to(torch.int64), 0) - 1
            sel = torch.clamp(torch.where(survive, rank,
                                          torch.full_like(rank, post_n)),
                              max=post_n)
            padded = top_boxes.new_zeros((post_n + 1, 4))
            padded[sel] = top_boxes
            sc_padded = top_sc.new_zeros((post_n + 1,))
            sc_padded[sel] = top_sc
            n_surv = torch.clamp(survive.sum(), max=post_n)
            in_rank = torch.arange(post_n, device=dev) < n_surv
            rois.append(torch.where(in_rank[:, None], padded[:post_n],
                                    top_boxes[0]))
            scs_out.append(torch.where(in_rank, sc_padded[:post_n],
                                       top_sc[0]))
        bcol = torch.repeat_interleave(
            torch.arange(B, dtype=torch.float32, device=dev), post_n)[:, None]
        rois5 = torch.cat([bcol, torch.stack(rois).reshape(-1, 4)
                           .to(torch.float32)], dim=1)
        if output_score:
            return rois5, torch.stack(scs_out).reshape(-1, 1)
        return rois5

    return invoke(f, [cls_prob, bbox_pred, im_info], "Proposal",
                  n_out=2 if output_score else 1)


def krprod(*matrices):
    """Khatri-Rao (column-wise Kronecker) product
    (ref: src/operator/contrib/krprod.cc)."""
    def f(*ms):
        out = ms[0]
        for m in ms[1:]:
            out = torch.einsum("ir,jr->ijr", out, m).reshape(-1, out.shape[1])
        return out
    return invoke(f, list(matrices), "krprod")


def _on_nd(fn):
    """``ops.quantization``'s ``fn`` over NDArrays: its tensor results
    (codes, and ranges computed from the data) come back as NDArrays."""
    def op(*args, **kwargs):
        out = fn(*args, **kwargs)
        if isinstance(out, torch.Tensor):
            return _wrap(out)
        return tuple(_wrap(o) if isinstance(o, torch.Tensor) else o
                     for o in out)
    op.__name__ = fn.__name__
    op.__doc__ = fn.__doc__
    return op


# the reference exposes its quantization surface here (ref:
# src/operator/quantization/*.cc as mx.nd.contrib.quantize etc.)
quantize = _on_nd(_quant.quantize)
quantize_v2 = _on_nd(_quant.quantize_v2)
dequantize = _on_nd(_quant.dequantize)
requantize = _on_nd(_quant.requantize)
quantized_concat = _on_nd(_quant.quantized_concat)
quantized_conv = _on_nd(_quant.quantized_conv)
quantized_flatten = _on_nd(_quant.quantized_flatten)
quantized_fully_connected = _on_nd(_quant.quantized_fully_connected)
quantized_pooling = _on_nd(_quant.quantized_pooling)


def getnnz(data, axis=None):
    """Number of stored values (ref: src/operator/contrib/nnz.cc), of a CSR
    array or a dense one's non-zeros: all of them (axis None), per column
    (0) or per row (1)."""
    from .sparse import CSRNDArray
    if isinstance(data, CSRNDArray):
        data = data.todense()

    def f(x):
        nz = (x != 0).to(torch.int32)
        return (nz.sum() if axis is None else nz.sum(dim=axis)).to(
            torch.int32)
    return invoke(f, [_as_nd(data)], "getnnz")


def edge_id(data, u, v):
    """Edge-id lookup in a CSR adjacency (ref: src/operator/contrib/
    dgl_graph.cc _contrib_edge_id): for each (u_i, v_i) the stored value
    at (u_i, v_i), or -1 where there is none."""
    from .sparse import CSRNDArray
    if not isinstance(data, CSRNDArray):
        raise TypeError("edge_id expects a CSR adjacency")

    def f(dense, uu, vv):
        vals = dense[uu.long(), vv.long()]
        return torch.where(vals != 0, vals, -torch.ones_like(vals))
    return invoke(f, [data.todense(), _as_nd(u), _as_nd(v)], "edge_id")


def bipartite_matching(data, threshold, is_ascend=False, topk=-1):
    """Greedy bipartite matching (ref: src/operator/contrib/bounding_box.cc
    _contrib_bipartite_matching): data (B, N, M) pair scores; rows pair
    with columns in score order until ``threshold``. Returns (row_match,
    col_match), each the partner index or -1."""
    def f(x):
        B, N, M = x.shape
        rounds = min(N, M) if topk < 0 else min(topk, min(N, M))
        big = torch.full((), 1e30, dtype=x.dtype, device=x.device)
        sgn = 1.0 if not is_ascend else -1.0
        scores = x * sgn
        rmatch = -torch.ones((B, N), dtype=x.dtype, device=x.device)
        cmatch = -torch.ones((B, M), dtype=x.dtype, device=x.device)
        rows = torch.arange(N, device=x.device)[None]
        cols = torch.arange(M, device=x.device)[None]
        for _ in range(rounds):
            flat = scores.reshape(B, N * M)
            best = torch.argmax(flat, dim=1)
            bi, bj = best // M, best % M
            bval = torch.gather(flat, 1, best[:, None])[:, 0]
            ok = (bval * sgn >= threshold) if not is_ascend else \
                (bval * sgn <= threshold)
            ok = ok & (bval > -big / 2)
            rm = ok[:, None] & (rows == bi[:, None])
            cm = ok[:, None] & (cols == bj[:, None])
            rmatch = torch.where(rm, bj[:, None].to(x.dtype), rmatch)
            cmatch = torch.where(cm, bi[:, None].to(x.dtype), cmatch)
            scores = torch.where(rm[:, :, None] | cm[:, None, :], -big,
                                 scores)
        return rmatch, cmatch
    return invoke(f, [_as_nd(data)], "bipartite_matching", n_out=2)


def SparseEmbedding(data, weight, input_dim=None, output_dim=None,
                    dtype="float32", **kw):
    """Embedding lookup whose gradient the reference keeps row-sparse (ref:
    src/operator/tensor/indexing_op.cc _contrib_SparseEmbedding). The
    lookup is the dense ``Embedding``'s and so is the gradient buffer;
    ``sparse.cast_storage(grad, "row_sparse")`` (what
    ``Parameter.row_sparse_grad`` does) recovers its active rows."""
    return Embedding(data, weight, input_dim=input_dim,
                     output_dim=output_dim, dtype=dtype, sparse_grad=True,
                     **kw)
