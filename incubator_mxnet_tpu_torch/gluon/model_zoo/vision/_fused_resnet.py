"""Fused-kernel execution of BottleneckV1 stages (NHWC, training mode).

Counterpart of ``incubator_mxnet_tpu/gluon/model_zoo/vision/
_fused_resnet.py``. Each residual stage runs as ONE
``torch.autograd.Function`` chaining the fused conv kernels of
``ops/cuda/conv_fused.py`` (their plain twins on the CPU). Between two
convolutions only each conv's RAW output is materialised: the batch-norm
normalise + ReLU rides the next kernel's load, the batch-norm statistics
ride the producing kernel's store, and each block's tail (bn3 + shortcut add
+ ReLU) is fused into the NEXT block's conv1 kernel (the "entry" form, which
also writes the block input that is the next shortcut). The backward chains
one dz + dW kernel pair per conv, applying each BN backward as a
per-channel affine of two raw tensors on the load.

The math equals the per-block path (training BN with batch statistics,
ReLU, shortcut add, biases on the 1x1 convs). Block 0's conv1 and
projection dgrads run as one ``dgrad_epilogue`` call, which sums both in
float32 and writes dx once (the reference's path with its ``conv_dgrad``
gate on, as on the TPU). Layout: all tensors NHWC; 1x1 convs are GEMMs over
(B*H*W, C) rows; BottleneckV1 carries its stride on conv1, so the 3x3
kernel is stride 1 and a strided stage slices its input once up front.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List

import torch

from ....ops.cuda import conv_fused as cf

__all__ = ["fused_stage", "stage_params_from_blocks", "write_moving_stats",
           "fused_path_enabled", "stage_bns_use_default_hparams"]

_EPS = 1e-5
_MOMENTUM = 0.9


def stage_bns_use_default_hparams(blocks) -> bool:
    """The fused stage bakes eps=1e-5 / momentum=0.9 (the nn.BatchNorm
    defaults every model-zoo BottleneckV1 uses); other hyperparameters take
    the per-block path."""
    for blk in blocks:
        bns = [blk.body[1], blk.body[4], blk.body[7]]
        if blk.downsample is not None:
            bns.append(blk.downsample[1])
        for bn in bns:
            if (getattr(bn, "_epsilon", _EPS) != _EPS
                    or getattr(bn, "_momentum", _MOMENTUM) != _MOMENTUM):
                return False
    return True


def fused_path_enabled(layout: str, training: bool) -> bool:
    """The fused path serves NHWC training; ``MXTPU_FUSED_RESNET=1`` opts
    in (off by default, as in the reference)."""
    if layout != "NHWC" or not training:
        return False
    return os.environ.get("MXTPU_FUSED_RESNET", "0") == "1"


# ---------------------------------------------------------------------------
# parameter plumbing
# ---------------------------------------------------------------------------

def stage_params_from_blocks(blocks) -> List[Dict[str, Any]]:
    """Per-block parameters (gluon layouts) of BottleneckV1 blocks."""
    out = []
    for blk in blocks:
        body = blk.body
        p = {
            "w1": body[0].weight.data()._data,
            "g1": body[1].gamma.data()._data,
            "be1": body[1].beta.data()._data,
            "w2": body[3].weight.data()._data,
            "g2": body[4].gamma.data()._data,
            "be2": body[4].beta.data()._data,
            "w3": body[6].weight.data()._data,
            "g3": body[7].gamma.data()._data,
            "be3": body[7].beta.data()._data,
        }
        # the model-zoo BottleneckV1 1x1 convs carry biases; the 3x3 and
        # the projection are bias-free
        if body[0].bias is not None:
            p["bias1"] = body[0].bias.data()._data
        if body[6].bias is not None:
            p["bias3"] = body[6].bias.data()._data
        if blk.downsample is not None:
            p["wd"] = blk.downsample[0].weight.data()._data
            p["gd"] = blk.downsample[1].gamma.data()._data
            p["bed"] = blk.downsample[1].beta.data()._data
        out.append(p)
    return out


def write_moving_stats(blocks, stats, momentum: float = 0.9):
    """Update running mean/var on the BatchNorm children from the batch
    stats the fused stage returned (the rule of ``nn.BatchNorm``)."""
    from .... import autograd as _ag
    i = 0
    with _ag.pause():
        for blk in blocks:
            bns = [blk.body[1], blk.body[4], blk.body[7]]
            if blk.downsample is not None:
                bns.append(blk.downsample[1])
            for bn in bns:
                mean, var = stats[i]
                i += 1
                rm = bn.running_mean.data()._data
                rv = bn.running_var.data()._data
                bn.running_mean.data()._set_data(
                    rm * momentum + mean.to(rm.dtype) * (1 - momentum))
                bn.running_var.data()._set_data(
                    rv * momentum + var.to(rv.dtype) * (1 - momentum))


# ---------------------------------------------------------------------------
# per-BN constant math (small per-channel ops between kernels)
# ---------------------------------------------------------------------------

def _bn_consts(s, n, gamma, beta, eps):
    """Epilogue sums (2, N) -> (a, b, mean, var, inv): x^ = a y + b with
    the batch statistics (biased variance)."""
    mean = s[0] / n
    var = torch.clamp(s[1] / n - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    a = gamma.float() * inv
    b = beta.float() - mean * a
    return a, b, mean, var, inv


def _bn_bwd_consts(p0, p1, mean, inv, a, n):
    """Backward partials (sum dz, sum dz y) -> (gcoef = [a, k0, k1],
    dgamma, dbeta): dy = a dz - k0 - k1 y."""
    dbeta = p0
    dgamma = inv * (p1 - mean * p0)
    k0 = (a / n) * (p0 - dgamma * inv * mean)
    k1 = a * dgamma * inv / n
    return torch.stack([a, k0, k1]), dgamma, dbeta


def _w1x1(w):
    """gluon (O, 1, 1, I) -> kernel (I, O), a view."""
    return w.reshape(w.shape[0], w.shape[3]).t()


def _w3x3(w):
    """gluon (O, 3, 3, I) -> kernel (9, I, O), a view."""
    return w.permute(1, 2, 3, 0).reshape(9, w.shape[3], w.shape[0])


def _w1x1_back(dw, like):
    """(I, O) float32 -> gluon (O, 1, 1, I)."""
    return dw.t().reshape(like.shape).to(like.dtype)


def _w3x3_back(dw9, like):
    """(9, I, O) float32 -> gluon (O, 3, 3, I)."""
    o, _, _, i = like.shape
    return dw9.reshape(3, 3, i, o).permute(3, 0, 1, 2).contiguous().to(
        like.dtype)


def _ops(x):
    """The kernels for a CUDA tensor, their plain twins for a CPU one."""
    if x.is_cuda:
        return (cf.mm_fused, cf.mm_fused_bwd, cf.conv3_fused,
                cf.conv3_fused_bwd, cf.dgrad_epilogue)
    return (cf.mm_fused_reference, cf.mm_fused_bwd_reference,
            cf.conv3_fused_reference, cf.conv3_fused_bwd_reference,
            cf.dgrad_epilogue_reference)


# ---------------------------------------------------------------------------
# the fused stage
# ---------------------------------------------------------------------------

def _stage_fwd_impl(stride: int, x, params):
    mm, _, c3, _, _ = _ops(x)
    B, H, W, Cin = x.shape
    Ho, Wo = H // stride, W // stride
    M = B * Ho * Wo
    L = len(params)
    eps = _EPS
    res: Dict[str, Any] = {"x_shape": tuple(x.shape)}
    stats_out = []

    # ---- block 0 (has the projection shortcut) ----
    p = params[0]
    xs = x[:, ::stride, ::stride, :] if stride > 1 else x
    xs2 = xs.reshape(M, Cin).contiguous()
    C4 = p["w3"].shape[0]

    y1, s1 = mm(xs2, _w1x1(p["w1"]), bias=p.get("bias1"))
    a1, b1, m1, v1, inv1 = _bn_consts(s1, M, p["g1"], p["be1"], eps)
    y2, s2 = c3(y1, _w3x3(p["w2"]), a1, b1, (B, Ho, Wo))
    a2, b2, m2, v2, inv2 = _bn_consts(s2, M, p["g2"], p["be2"], eps)
    y3, s3 = mm(y2, _w1x1(p["w3"]), a=a2, b=b2, bias=p.get("bias3"))
    a3, b3, m3, v3, inv3 = _bn_consts(s3, M, p["g3"], p["be3"], eps)
    yd, sd = mm(xs2, _w1x1(p["wd"]))
    ad, bd, md, vd, invd = _bn_consts(sd, M, p["gd"], p["bed"], eps)
    stats_out += [(m1, v1), (m2, v2), (m3, v3), (md, vd)]
    res["b0"] = dict(xs2=xs2, y1=y1, y2=y2, y3=y3, yd=yd,
                     sy1=s1[0], sy3=s3[0],
                     bn1=(a1, b1, m1, inv1), bn2=(a2, b2, m2, inv2),
                     bn3=(a3, b3, m3, inv3), bnd=(ad, bd, md, invd))
    prev = (y3, yd, a3, b3, ad, bd)       # the unmaterialised block-0 tail

    # ---- middle blocks: the entry kernel fuses the previous tail ----
    ones = torch.ones((C4,), dtype=torch.float32, device=x.device)
    zeros = torch.zeros((C4,), dtype=torch.float32, device=x.device)
    for i in range(1, L):
        p = params[i]
        y3p, scp, a3p, b3p, ascp, bscp = prev
        y1, s1, x_in = mm(y3p, _w1x1(p["w1"]), a=a3p, b=b3p, sc=scp,
                          asc=ascp, bsc=bscp, bias=p.get("bias1"),
                          emit_xhat=True)
        a1, b1, m1, v1, inv1 = _bn_consts(s1, M, p["g1"], p["be1"], eps)
        y2, s2 = c3(y1, _w3x3(p["w2"]), a1, b1, (B, Ho, Wo))
        a2, b2, m2, v2, inv2 = _bn_consts(s2, M, p["g2"], p["be2"], eps)
        y3, s3 = mm(y2, _w1x1(p["w3"]), a=a2, b=b2, bias=p.get("bias3"))
        a3, b3, m3, v3, inv3 = _bn_consts(s3, M, p["g3"], p["be3"], eps)
        stats_out += [(m1, v1), (m2, v2), (m3, v3)]
        res[f"b{i}"] = dict(x_in=x_in, y1=y1, y2=y2, y3=y3,
                            sy1=s1[0], sy3=s3[0],
                            bn1=(a1, b1, m1, inv1), bn2=(a2, b2, m2, inv2),
                            bn3=(a3, b3, m3, inv3))
        prev = (y3, x_in, a3, b3, ones, zeros)

    # ---- stage tail (one elementwise pass) ----
    y3L, scL, a3L, b3L, ascL, bscL = prev
    zL = y3L.float() * a3L + b3L + scL.float() * ascL + bscL
    x_out = torch.clamp(zL, min=0.0).to(x.dtype).reshape(B, Ho, Wo, C4)
    res["tail"] = dict(y3L=y3L, scL=scL)
    return x_out, tuple(stats_out), res


def _dbias(gc, p0_src, sy, n, like):
    """sum G for G = gc0 dz - gc1 - gc2 y, from reductions already known."""
    return (gc[0] * p0_src - n * gc[1] - gc[2] * sy).to(like.dtype)


def _stage_bwd(stride, params, res, dxout):
    _, mmb, _, c3b, dual = _ops(dxout)
    L = len(params)
    B, H, W, Cin = res["x_shape"]
    Ho, Wo = H // stride, W // stride
    M = B * Ho * Wo
    C4 = params[0]["w3"].shape[0]
    grads: List[Dict[str, Any]] = [dict() for _ in range(L)]
    if L < 2:
        raise ValueError("fused stages have >= 2 blocks")

    # ---- stage tail backward: dz_tail of block L-1 ----
    last = res[f"b{L - 1}"]
    last_p = params[L - 1]
    y3L = res["tail"]["y3L"]
    scL = res["tail"]["scL"]
    a3L, b3L, m3L, inv3L = last["bn3"]
    dxf = dxout.reshape(M, C4).float()
    zL = y3L.float() * a3L + b3L + scL.float()
    dztail = torch.where(zL > 0, dxf, torch.zeros((), device=dxf.device))
    p0 = dztail.sum(0)
    p1 = (dztail * y3L.float()).sum(0)
    dztail = dztail.to(y3L.dtype)
    bn3_coefs, dg3, db3 = _bn_bwd_consts(p0, p1, m3L, inv3L, a3L, M)
    grads[L - 1]["g3"] = dg3.to(last_p["g3"].dtype)
    grads[L - 1]["be3"] = db3.to(last_p["be3"].dtype)
    dztail_p0 = p0          # sum dz_tail: with sy3 it gives dbias3 = sum G3
    bnd_coefs = None

    # ---- middle blocks in reverse ----
    for i in range(L - 1, 0, -1):
        p = params[i]
        r = res[f"b{i}"]
        a1, b1, m1, inv1 = r["bn1"]
        a2, b2, m2, inv2 = r["bn2"]
        # conv3 backward: G formed on load from (dz_tail, y3, bn3 coefs)
        dz2, dw3, pp = mmb(_w1x1(p["w3"]), r["y2"], dzn=dztail,
                           yout=r["y3"], gcoef=bn3_coefs, a=a2, b=b2,
                           out_mask="z", partners=(r["y2"],))
        grads[i]["w3"] = _w1x1_back(dw3, p["w3"])
        if "bias3" in p:
            grads[i]["bias3"] = _dbias(bn3_coefs, dztail_p0, r["sy3"], M,
                                       p["bias3"])
        gc2, dg2, db2 = _bn_bwd_consts(pp[0], pp[1], m2, inv2, a2, M)
        grads[i]["g2"] = dg2.to(p["g2"].dtype)
        grads[i]["be2"] = db2.to(p["be2"].dtype)
        # conv2 (3x3) backward
        dz1, dw2, pp = c3b(_w3x3(p["w2"]), r["y1"], a1, b1, dz2, r["y2"],
                           gc2, (B, Ho, Wo))
        grads[i]["w2"] = _w3x3_back(dw2, p["w2"])
        gc1, dg1, db1 = _bn_bwd_consts(pp[0], pp[1], m1, inv1, a1, M)
        grads[i]["g1"] = dg1.to(p["g1"].dtype)
        grads[i]["be1"] = db1.to(p["be1"].dtype)
        if "bias1" in p:
            grads[i]["bias1"] = _dbias(gc1, pp[0], r["sy1"], M, p["bias1"])
        # entry backward: emits the PREVIOUS block's tail gradient
        prev_r = res[f"b{i - 1}"]
        partners = [prev_r["y3"]]
        if i == 1:
            partners.append(res["b0"]["yd"])
        dztail_prev, dw1, pp = mmb(_w1x1(p["w1"]), r["x_in"], dzn=dz1,
                                   yout=r["y1"], gcoef=gc1, dsc=dztail,
                                   out_mask="x", partners=tuple(partners))
        grads[i]["w1"] = _w1x1_back(dw1, p["w1"])
        pa3, pb3, pm3, pinv3 = prev_r["bn3"]
        bn3_coefs, dg3p, db3p = _bn_bwd_consts(pp[0], pp[1], pm3, pinv3,
                                               pa3, M)
        grads[i - 1]["g3"] = dg3p.to(params[i - 1]["g3"].dtype)
        grads[i - 1]["be3"] = db3p.to(params[i - 1]["be3"].dtype)
        if i == 1:
            pad, pbd, pmd, pinvd = res["b0"]["bnd"]
            bnd_coefs, dgd, dbd = _bn_bwd_consts(pp[0], pp[2], pmd, pinvd,
                                                 pad, M)
            grads[0]["gd"] = dgd.to(params[0]["gd"].dtype)
            grads[0]["bed"] = dbd.to(params[0]["bed"].dtype)
        dztail = dztail_prev
        dztail_p0 = pp[0]

    # ---- block 0 ----
    p = params[0]
    r = res["b0"]
    a1, b1, m1, inv1 = r["bn1"]
    a2, b2, m2, inv2 = r["bn2"]
    dz2, dw3, pp = mmb(_w1x1(p["w3"]), r["y2"], dzn=dztail, yout=r["y3"],
                       gcoef=bn3_coefs, a=a2, b=b2, out_mask="z",
                       partners=(r["y2"],))
    grads[0]["w3"] = _w1x1_back(dw3, p["w3"])
    if "bias3" in p:
        grads[0]["bias3"] = _dbias(bn3_coefs, dztail_p0, r["sy3"], M,
                                   p["bias3"])
    gc2, dg2, db2 = _bn_bwd_consts(pp[0], pp[1], m2, inv2, a2, M)
    grads[0]["g2"] = dg2.to(p["g2"].dtype)
    grads[0]["be2"] = db2.to(p["be2"].dtype)
    dz1, dw2, pp = c3b(_w3x3(p["w2"]), r["y1"], a1, b1, dz2, r["y2"], gc2,
                       (B, Ho, Wo))
    grads[0]["w2"] = _w3x3_back(dw2, p["w2"])
    gc1, dg1, db1 = _bn_bwd_consts(pp[0], pp[1], m1, inv1, a1, M)
    grads[0]["g1"] = dg1.to(p["g1"].dtype)
    grads[0]["be1"] = db1.to(p["be1"].dtype)
    if "bias1" in p:
        grads[0]["bias1"] = _dbias(gc1, pp[0], r["sy1"], M, p["bias1"])
    # the conv1 and projection dgrads meet in one accumulator: the
    # junction cotangent is written once, and both wgrads read xs2 once
    dxs, dw1, dwd = dual(_w1x1(p["w1"]), _w1x1(p["wd"]), r["xs2"], dz1,
                         r["y1"], gc1, dztail, r["yd"], bnd_coefs)
    grads[0]["w1"] = _w1x1_back(dw1, p["w1"])
    grads[0]["wd"] = _w1x1_back(dwd, p["wd"])
    dxs4 = dxs.reshape(B, Ho, Wo, Cin)
    if stride > 1:
        # the gradient of x[:, ::s, ::s, :]: zero-interleave
        dx = torch.zeros((B, H, W, Cin), dtype=dxs4.dtype,
                         device=dxs4.device)
        dx[:, ::stride, ::stride, :] = dxs4
    else:
        dx = dxs4
    return dx, grads


class _FusedStage(torch.autograd.Function):
    """One stage as one autograd node: the forward is
    :func:`_stage_fwd_impl`, the backward :func:`_stage_bwd` (the
    reference's custom VJP). The stats outputs carry no gradient."""

    @staticmethod
    def forward(ctx, stride, keys, x, *flat):
        params = _unflatten(keys, flat)
        x_out, stats, res = _stage_fwd_impl(stride, x, params)
        ctx.stride, ctx.keys = stride, keys
        ctx.params, ctx.res = params, res
        flat_stats = [t for pair in stats for t in pair]
        ctx.mark_non_differentiable(*flat_stats)
        return (x_out, *flat_stats)

    @staticmethod
    def backward(ctx, dxout, *_dstats):
        dx, grads = _stage_bwd(ctx.stride, ctx.params, ctx.res,
                               dxout.contiguous())
        ctx.res = ctx.params = None
        flat = [grads[i].get(k) for i, names in enumerate(ctx.keys)
                for k in names]
        return (None, None, dx, *flat)


def _unflatten(keys, flat):
    out, it = [], iter(flat)
    for names in keys:
        out.append({k: next(it) for k in names})
    return out


def fused_stage(stride: int, x, params: List[Dict[str, Any]]):
    """Run one BottleneckV1 stage (block 0 downsamples) on NHWC ``x``.

    Returns (x_out, stats): stats is a tuple of (mean, var) pairs in block
    order [bn1, bn2, bn3, (bn_d)], the batch statistics for the
    moving-average update; they carry no gradient."""
    keys = tuple(tuple(p.keys()) for p in params)
    flat = [p[k] for p in params for k in p]
    out = _FusedStage.apply(stride, keys, x.contiguous(), *flat)
    x_out, rest = out[0], out[1:]
    stats = tuple((rest[2 * i], rest[2 * i + 1])
                  for i in range(len(rest) // 2))
    return x_out, stats
