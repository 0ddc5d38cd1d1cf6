"""Neural-network primitive ops as plain PyTorch functions over tensors.

Counterpart of ``incubator_mxnet_tpu/ops/nn.py``, function for function.
Layouts are the reference's (NCHW at the API, OIHW weights; NHWC with
(O, kH, kW, I) weights). Convolution, pooling and batch norm call
PyTorch's library ops, as the reference leaves them to XLA outside any
Pallas kernel. The reference's custom VJPs that change results are kept as
``torch.autograd.Function``s: the fused batch-norm backward, ``residual_relu``,
the sorted-gradient embedding (``MXTPU_EMB_SORTED_GRAD=1``), and the loss
heads whose backward ignores the head gradient (``softmax_output``,
``regression_output``). The two Pallas dispatch sites route to the port's
CUDA kernels: ``layer_norm`` over the last axis to ``ops/cuda/layer_norm``
(B5) and ``softmax`` over the last axis to ``ops/cuda/softmax`` (B6); on
the CPU those take their plain twins.

Random ops take an explicit ``torch.Generator`` where the reference takes a
JAX key.
"""
from __future__ import annotations

import contextlib
import math
import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import matmul_promoted
from .cuda import layer_norm as _ln
from .cuda import softmax as _sm

__all__ = [
    "fully_connected", "convolution", "deconvolution", "pooling",
    "global_pooling", "batch_norm", "layer_norm", "instance_norm",
    "activation", "leaky_relu", "softmax", "log_softmax", "softmax_output",
    "softmax_cross_entropy", "dropout", "embedding", "lrn", "sequence_mask",
    "one_hot", "smooth_l1",
]


def _pair(x, n=2):
    if isinstance(x, (tuple, list)):
        return tuple(x)
    return (x,) * n


# ---------------------------------------------------------------------------

def fully_connected(x, weight, bias=None, num_hidden: Optional[int] = None,
                    flatten: bool = True):
    """y = x @ W^T + b; ``weight`` is (num_hidden, in_units). Mixed types
    multiply in their promotion, as ``jnp`` does (the word LM under bf16
    compute feeds its float32 LSTM output to a bf16 decoder)."""
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    y = matmul_promoted(x, weight.T)
    if bias is not None:
        y = y + bias
    return y


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def convolution(x, weight, bias=None, kernel=None, stride=(1, 1),
                dilate=(1, 1), pad=(0, 0), num_filter=None,
                num_group: int = 1, layout="NCHW"):
    """N-d convolution; ``layout="NHWC"`` takes NHWC input and (O, kH, kW,
    I) weights and returns NHWC."""
    if layout == "NHWC":
        y = convolution(x.permute(0, 3, 1, 2), weight.permute(0, 3, 1, 2),
                        None, kernel, stride, dilate, pad, num_filter,
                        num_group, "NCHW").permute(0, 2, 3, 1)
        return y + bias if bias is not None else y
    if not layout.startswith("NC"):
        raise ValueError(f"unsupported layout {layout}")
    nd = x.dim() - 2
    stride, dilate, pad = _pair(stride, nd), _pair(dilate, nd), _pair(pad, nd)
    y = _CONV[nd](x, weight, None, stride, pad, dilate, num_group)
    if bias is not None:
        y = y + bias.reshape((1, -1) + (1,) * nd)
    return y


def deconvolution(x, weight, bias=None, kernel=None, stride=(1, 1),
                  dilate=(1, 1), pad=(0, 0), adj=(0, 0), num_filter=None,
                  num_group: int = 1, target_shape=None):
    """Transposed convolution; weight (in, out / group, k...)."""
    nd = x.dim() - 2
    stride, dilate, pad = _pair(stride, nd), _pair(dilate, nd), _pair(pad, nd)
    if num_group != 1:
        xs = torch.chunk(x, num_group, dim=1)
        ws = torch.chunk(weight, num_group, dim=0)
        y = torch.cat([deconvolution(xi, wi, None, kernel, stride, dilate,
                                     pad, (0,) * nd, num_filter, 1,
                                     target_shape)
                       for xi, wi in zip(xs, ws)], dim=1)
    else:
        y = _CONV_T[nd](x, weight, None, stride, pad, 0, 1, dilate)
    if bias is not None:
        y = y + bias.reshape((1, -1) + (1,) * nd)
    return y


def pooling(x, kernel=(2, 2), pool_type: str = "max", stride=None,
            pad=(0, 0), global_pool: bool = False,
            count_include_pad: bool = True,
            pooling_convention: str = "valid", layout: str = "NCHW"):
    """Max/avg/sum/lp pooling over the spatial axes (channels-second "NC*"
    or channels-last layouts)."""
    nd = x.dim() - 2
    cl = layout.endswith("C") and not layout.startswith("NC")
    if cl:
        x = torch.movedim(x, -1, 1)
    spatial = tuple(x.shape[2:2 + nd])
    if global_pool:
        kernel = spatial
        stride, pad = (1,) * nd, (0,) * nd
    kernel = _pair(kernel, nd)
    stride = _pair(stride if stride is not None else kernel, nd)
    pad = _pair(pad, nd)
    sp_pads = []
    for i in range(nd):
        if pooling_convention == "full":        # ceil-mode output size
            out = -(-max(spatial[i] + 2 * pad[i] - kernel[i], 0)
                    // stride[i]) + 1
            need = max((out - 1) * stride[i] + kernel[i] - spatial[i], 0)
            sp_pads.append((pad[i], need - pad[i]))
        else:
            sp_pads.append((pad[i], pad[i]))
    flat = []
    for before, after in reversed(sp_pads):
        flat += [before, after]
    pool = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}[nd]
    area = float(math.prod(int(k) for k in kernel))
    if pool_type == "max":
        xp = F.pad(x, flat, value=-math.inf)
        y = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[nd](
            xp, kernel, stride)
    elif pool_type == "sum":
        y = pool(F.pad(x, flat, value=0.0), kernel, stride) * area
    elif pool_type == "avg":
        # avg_pool over the explicitly padded input divides by the window
        # area: the count that includes padding
        y = pool(F.pad(x, flat, value=0.0), kernel, stride)
        if not count_include_pad:
            ones = F.pad(torch.ones_like(x), flat, value=0.0)
            y = y / pool(ones, kernel, stride)
    elif pool_type == "lp":
        y = (pool(F.pad(x.abs() ** 2, flat, value=0.0), kernel, stride)
             * area) ** 0.5
    else:
        raise ValueError(f"unknown pool_type {pool_type}")
    return torch.movedim(y, 1, -1) if cl else y


def global_pooling(x, pool_type: str = "avg", layout: str = "NCHW"):
    return pooling(x, global_pool=True, pool_type=pool_type, layout=layout)


def _bn_train_fused_make(axis: int, eps: float):
    """Training-mode BN with the reference's single-pass statistics (sum
    and sum of squares) and its closed-form two-reduction backward, as a
    ``torch.autograd.Function``. Returns (the Function's apply, the plain
    forward)."""

    def _fwd_impl(x, gamma, beta):
        ax = axis % x.dim()
        red = tuple(i for i in range(x.dim()) if i != ax)
        n = math.prod(x.shape[i] for i in red)
        shape = [1] * x.dim()
        shape[ax] = x.shape[ax]
        xf = x.float()
        mean = xf.sum(dim=red) / n
        var = torch.clamp(torch.square(xf).sum(dim=red) / n
                          - torch.square(mean), min=0.0)
        inv = torch.rsqrt(var + eps)
        g32 = gamma.float()
        a = (g32 * inv).reshape(shape)
        b = (beta.float() - mean * g32 * inv).reshape(shape)
        y = (x * a.to(x.dtype) + b.to(x.dtype)).to(x.dtype)
        return y, mean, var, inv

    class _BN(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, gamma, beta):
            y, mean, var, inv = _fwd_impl(x, gamma, beta)
            ctx.save_for_backward(x, mean, inv, gamma)
            ctx.mark_non_differentiable(mean, var)
            return y, mean, var

        @staticmethod
        def backward(ctx, dy, _dmean, _dvar):
            # the mean/var outputs feed the moving averages only; their
            # cotangents are dropped, as the reference drops them
            x, mean, inv, gamma = ctx.saved_tensors
            ax = axis % x.dim()
            red = tuple(i for i in range(x.dim()) if i != ax)
            n = math.prod(x.shape[i] for i in red)
            shape = [1] * x.dim()
            shape[ax] = x.shape[ax]
            dbeta = dy.float().sum(dim=red)
            dxy = (dy * x).float().sum(dim=red)
            dgamma = inv * (dxy - mean * dbeta)
            g32 = gamma.float()
            c1 = (g32 * inv).reshape(shape)
            cb = (g32 * inv * dbeta / n).reshape(shape)
            cg = (g32 * inv * inv * dgamma / n).reshape(shape)
            cm = mean.reshape(shape)
            dx = (c1.to(x.dtype) * dy - cb.to(x.dtype)
                  - cg.to(x.dtype) * (x - cm.to(x.dtype)))
            return (dx.to(x.dtype), dgamma.to(gamma.dtype),
                    dbeta.to(gamma.dtype))

    return _BN.apply, _fwd_impl


_BN_FUSED_CACHE = {}

# override of the training-BN implementation ("plain"/"fused", as the
# reference's remat train step sets it, or a function of (x, reduced dims)
# returning the batch's (mean, mean square), as a mesh step sets it)
_BN_IMPL_OVERRIDE = None


@contextlib.contextmanager
def bn_impl_override(impl):
    global _BN_IMPL_OVERRIDE
    prev = _BN_IMPL_OVERRIDE
    _BN_IMPL_OVERRIDE = impl
    try:
        yield
    finally:
        _BN_IMPL_OVERRIDE = prev


def _bn_train_moments(x, gamma, beta, axis, eps, moments):
    """The fused forward's formula (E[x^2] - E[x]^2, clamped) on the
    statistics ``moments(x float32, reduced dims)`` returns (mean, mean
    square), as a differentiable composition. Returns (y, mean, var)."""
    ax = axis % x.dim()
    red = tuple(i for i in range(x.dim()) if i != ax)
    shape = [1] * x.dim()
    shape[ax] = x.shape[ax]
    mean, meansq = moments(x.float(), red)
    var = torch.clamp(meansq - torch.square(mean), min=0.0)
    inv = torch.rsqrt(var + eps)
    g32 = gamma.float()
    a = (g32 * inv).reshape(shape)
    b = (beta.float() - mean * g32 * inv).reshape(shape)
    y = (x * a.to(x.dtype) + b.to(x.dtype)).to(x.dtype)
    return y, mean.detach(), var.detach()


def _bn_train_fused(x, gamma, beta, axis, eps):
    """Training BN: the fused Function by default; under
    ``bn_impl_override("plain")`` or ``MXTPU_BN_IMPL=plain`` the same
    forward as a plain differentiable composition; under
    ``bn_impl_override(moments)`` a plain composition on the statistics
    that ``moments`` returns (a mesh step's synchronised BatchNorm)."""
    if callable(_BN_IMPL_OVERRIDE):
        return _bn_train_moments(x, gamma, beta, axis, eps,
                                 _BN_IMPL_OVERRIDE)
    key = (axis, float(eps))
    if key not in _BN_FUSED_CACHE:
        _BN_FUSED_CACHE[key] = _bn_train_fused_make(axis, eps)
    bn, fwd_impl = _BN_FUSED_CACHE[key]
    impl = _BN_IMPL_OVERRIDE or os.environ.get("MXTPU_BN_IMPL", "fused")
    if impl == "plain":
        y, mean, var, _ = fwd_impl(x, gamma, beta)
        return y, mean, var
    return bn(x, gamma, beta)


def batch_norm(x, gamma, beta, moving_mean, moving_var, eps: float = 1e-5,
               momentum: float = 0.9, fix_gamma: bool = False,
               use_global_stats: bool = False, training: bool = True,
               axis: int = 1):
    """Batch normalization. Returns (y, new_mean, new_var); the caller
    owns the moving statistics."""
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    if training and not use_global_stats:
        y, mean, var = _bn_train_fused(x, gamma.to(x.dtype),
                                       beta.to(x.dtype), axis, eps)
        new_mean = moving_mean * momentum + mean.to(moving_mean.dtype) \
            * (1 - momentum)
        new_var = moving_var * momentum + var.to(moving_var.dtype) \
            * (1 - momentum)
        return y, new_mean, new_var
    inv = torch.rsqrt(moving_var + eps) * gamma
    y = (x - moving_mean.reshape(shape)) * inv.reshape(shape) \
        + beta.reshape(shape)
    return y, moving_mean, moving_var


class _ResidualRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, res):
        y = torch.clamp(x + res, min=0)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        gb = torch.where(y > 0, g, torch.zeros((), dtype=g.dtype,
                                               device=g.device))
        return gb, gb


def residual_relu(x, res):
    """relu(x + res) whose backward hands the same masked gradient to both
    inputs (the reference materialises it once for every consumer)."""
    return _ResidualRelu.apply(x, res)


def layer_norm(x, gamma, beta, axis: int = -1, eps: float = 1e-5):
    """Layer normalization. The last axis goes to the B5 kernels
    (``ops/cuda/layer_norm.py``; its plain twin on the CPU), as the
    reference sends it to its Pallas kernel; any other axis uses the plain
    formula."""
    if axis == -1 or axis == x.dim() - 1:
        return _ln.layer_norm(x, gamma.reshape(-1), beta.reshape(-1),
                              eps=eps)
    mean = torch.mean(x, dim=axis, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=axis, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    return y * gamma.reshape(shape) + beta.reshape(shape)


def instance_norm(x, gamma, beta, eps: float = 1e-5):
    """Instance norm over the spatial dims, NC... layout."""
    red = tuple(range(2, x.dim()))
    mean = torch.mean(x, dim=red, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=red, keepdim=True)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return (x - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape) \
        + beta.reshape(shape)


def lrn(x, nsize: int = 5, alpha: float = 1e-4, beta: float = 0.75,
        knorm: float = 2.0):
    """Local response norm across channels."""
    half = nsize // 2
    sq = torch.square(x)
    pads = [0, 0] * (x.dim() - 2) + [half, half]
    s = F.pad(sq, pads).unfold(1, nsize, 1).sum(dim=-1)
    return x / (knorm + alpha / nsize * s) ** beta


def activation(x, act_type: str = "relu"):
    if act_type == "relu":
        return torch.relu(x)
    if act_type == "sigmoid":
        return torch.sigmoid(x)
    if act_type == "tanh":
        return torch.tanh(x)
    if act_type == "softrelu":
        return F.softplus(x)
    if act_type == "softsign":
        return F.softsign(x)
    if act_type in ("gelu", "erf_gelu"):
        return F.gelu(x, approximate="none")
    if act_type in ("silu", "swish"):
        return F.silu(x)
    raise ValueError(f"unknown act_type {act_type}")


def leaky_relu(x, act_type: str = "leaky", slope: float = 0.25,
               lower_bound: float = 0.125, upper_bound: float = 0.334,
               gamma=None, generator: Optional[torch.Generator] = None,
               training: bool = True):
    """LeakyReLU family: leaky/prelu/elu/selu/rrelu/gelu."""
    if act_type == "leaky":
        return torch.where(x > 0, x, slope * x)
    if act_type == "prelu":
        g = (gamma.reshape((1, -1) + (1,) * (x.dim() - 2))
             if gamma.dim() == 1 and x.dim() > 2 else gamma)
        return torch.where(x > 0, x, g * x)
    if act_type == "elu":
        return torch.where(x > 0, x, slope * (torch.exp(x) - 1))
    if act_type == "selu":
        return F.selu(x)
    if act_type == "gelu":
        return F.gelu(x, approximate="none")
    if act_type == "rrelu":
        if training and generator is not None:
            s = torch.rand(x.shape, generator=generator, device=x.device,
                           dtype=x.dtype) * (upper_bound - lower_bound) \
                + lower_bound
        else:
            s = (lower_bound + upper_bound) / 2.0
        return torch.where(x > 0, x, s * x)
    raise ValueError(f"unknown act_type {act_type}")


def softmax(x, axis: int = -1, temperature: Optional[float] = None,
            length=None):
    """Softmax: the temperature first, then the ``length`` mask with
    -inf, then the B6 kernel over the last axis (``ops/cuda/softmax.py``;
    its plain twin on the CPU); any other axis takes ``torch.softmax``."""
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    if length is not None:
        ax = axis % x.dim()
        pos = torch.arange(x.shape[ax], device=x.device)
        mask = pos < length.unsqueeze(-1)
        x = torch.where(mask, x, torch.full((), -math.inf, dtype=x.dtype,
                                            device=x.device))
    return _sm.softmax(x, axis=axis)


def log_softmax(x, axis: int = -1, temperature: Optional[float] = None):
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    return torch.log_softmax(x, dim=axis)


def _softmax_output_make(axis, ignore_label, use_ignore, grad_scale,
                         normalization):
    class _SoftmaxOutput(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, label):
            p = torch.softmax(x, dim=axis)
            ctx.save_for_backward(p, label)
            return p

        @staticmethod
        def backward(ctx, g):
            # the head gradient g is ignored, as in the reference
            p, label = ctx.saved_tensors
            n_class = p.shape[axis]
            onehot = torch.movedim(
                _one_hot_idx(label, n_class, p.dtype), -1, axis)
            gx = (p - onehot) * grad_scale
            if use_ignore and ignore_label is not None:
                keep = (label != ignore_label).to(p.dtype)
                gx = gx * keep.unsqueeze(axis)
                if normalization == "valid":
                    gx = gx / torch.clamp(keep.sum(), min=1.0)
            if normalization == "batch":
                gx = gx / p.shape[0]
            return gx, None

    return _SoftmaxOutput.apply


def softmax_output(x, label, ignore_label: Optional[float] = None,
                   multi_output: bool = False, use_ignore: bool = False,
                   grad_scale: float = 1.0, normalization: str = "null"):
    """Fused SoftmaxOutput: the forward is the softmax; the backward
    ignores the incoming head gradient and emits (p - onehot(label)) *
    grad_scale, the reference's loss-head semantics."""
    axis = 1 if multi_output else -1
    if label is None:
        return torch.softmax(x, dim=axis)
    return _softmax_output_make(axis, ignore_label, use_ignore, grad_scale,
                                normalization)(x, label)


def softmax_cross_entropy(logits, labels, axis: int = -1,
                          sparse_label: bool = True,
                          ignore_label: Optional[int] = None):
    """Cross-entropy with logits per example."""
    logp = torch.log_softmax(logits, dim=axis)
    if sparse_label:
        lab = labels.to(torch.int64)
        nll = -torch.gather(logp, axis, lab.unsqueeze(axis)).squeeze(axis)
        if ignore_label is not None:
            nll = torch.where(lab == ignore_label, torch.zeros_like(nll), nll)
    else:
        nll = -torch.sum(labels * logp, dim=axis)
    return nll


def dropout(x, generator: Optional[torch.Generator], p: float = 0.5,
            mode: str = "training", axes: Tuple[int, ...] = (),
            training: bool = True):
    """Inverted dropout; the mask is drawn from ``generator`` (on x's
    device), the port's stand-in for the reference's explicit key."""
    if not training or p <= 0 or mode == "always_off":
        return x
    shape = list(x.shape)
    for ax in axes:
        shape[ax] = 1
    keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class _EmbeddingSortedGrad(torch.autograd.Function):
    """Lookup whose backward sums the rows' gradients in sorted index
    order (argsort + segment sum), the reference's
    ``_embedding_sorted_grad``."""

    @staticmethod
    def forward(ctx, weight, idx):
        ctx.save_for_backward(idx)
        ctx.wshape, ctx.wdtype = weight.shape, weight.dtype
        return weight[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        flat = idx.reshape(-1)
        gf = g.reshape(flat.shape[0], -1).float()
        order = torch.argsort(flat, stable=True)
        dw = torch.zeros((ctx.wshape[0], gf.shape[1]), dtype=torch.float32,
                         device=g.device)
        dw.index_add_(0, flat[order], gf[order])
        return dw.reshape(ctx.wshape).to(ctx.wdtype), None


def embedding(indices, weight, dtype=None):
    """Lookup table. The backward is autograd's scatter-add, or with
    ``MXTPU_EMB_SORTED_GRAD=1`` the sorted segment sum of the reference's
    measured alternative."""
    idx = indices.to(torch.int64)
    if os.environ.get("MXTPU_EMB_SORTED_GRAD") == "1":
        return _EmbeddingSortedGrad.apply(weight, idx)
    return weight[idx]


def sequence_mask(x, length=None, use_sequence_length: bool = False,
                  value: float = 0.0, axis: int = 0):
    """x is (seq, batch, ...) when axis=0, (batch, seq, ...) when 1."""
    if not use_sequence_length or length is None:
        return x
    pos = torch.arange(x.shape[axis], device=x.device)
    lens = length.to(torch.int64)
    if axis == 0:
        mask = pos[:, None] < lens[None, :]
    else:
        mask = pos[None, :] < lens[:, None]
    mask = mask.reshape(mask.shape + (1,) * (x.dim() - 2))
    return torch.where(mask, x, torch.full((), value, dtype=x.dtype,
                                           device=x.device))


def _one_hot_idx(indices, depth: int, dtype):
    classes = torch.arange(depth, device=indices.device)
    return (indices.to(torch.int64)[..., None] == classes).to(dtype)


def one_hot(indices, depth: int, on_value: float = 1.0,
            off_value: float = 0.0, dtype=torch.float32):
    """An index outside [0, depth) gives a row of ``off_value``."""
    return _one_hot_idx(indices, depth, dtype) * (on_value - off_value) \
        + off_value


def smooth_l1(x, scalar: float = 1.0):
    s2 = scalar * scalar
    return torch.where(torch.abs(x) < 1.0 / s2, 0.5 * s2 * torch.square(x),
                       torch.abs(x) - 0.5 / s2)


def regression_output(x, label, grad_scale: float = 1.0,
                      kind: str = "linear"):
    """Fused regression heads: the forward is the prediction (identity, or
    sigmoid for logistic); the backward ignores the head gradient and emits
    (pred - label), or its sign for MAE, times grad_scale / outputs per
    sample."""
    def predict(v):
        return torch.sigmoid(v) if kind == "logistic" else v

    if label is None:
        return predict(x)

    class _Regression(torch.autograd.Function):
        @staticmethod
        def forward(ctx, xv, lv):
            p = predict(xv)
            ctx.save_for_backward(p, lv)
            return p

        @staticmethod
        def backward(ctx, g):
            p, lv = ctx.saved_tensors
            lv = lv.reshape(p.shape)
            num_output = max(int(p.numel() // p.shape[0]), 1)
            diff = p - lv
            gx = (torch.sign(diff) if kind == "mae" else diff) \
                * (grad_scale / num_output)
            return gx.to(p.dtype), None

    return _Regression.apply(x, label)


def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             blank_label: str = "first"):
    """Connectionist temporal classification loss: data (T, B, C)
    activations, label (B, L); returns (B,) negative log-likelihoods. The
    alpha recursion runs over time in the log semiring; steps at or past a
    sample's length leave its alpha unchanged. The gradient is autograd's
    through the recursion, as in the reference."""
    logits = data
    T, B, C = logits.shape
    lab = label.to(torch.int64)
    L = lab.shape[1]
    neg_inf = -1e30
    dev = logits.device
    if blank_label == "first":
        blank = 0
        pad_mask = lab > 0
    else:
        blank = C - 1
        pad_mask = (lab >= 0) & (lab < C - 1)
    lab_len = (pad_mask.to(torch.int64).sum(dim=1) if label_lengths is None
               else label_lengths.to(torch.int64))
    in_len = (torch.full((B,), T, dtype=torch.int64, device=dev)
              if data_lengths is None else data_lengths.to(torch.int64))
    logp = torch.log_softmax(logits.float(), dim=-1)

    S = 2 * L + 1
    ext = torch.full((B, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = torch.where(pad_mask, lab, torch.full_like(lab, blank))
    ext_prev2 = F.pad(ext, (2, 0), value=-1)[:, :S]
    pos = torch.arange(S, device=dev)[None, :]
    valid = pos < (2 * lab_len + 1)[:, None]
    can_skip = (ext != blank) & (ext != ext_prev2) & valid

    first_lab = torch.gather(logp[0], 1, ext[:, 1:2])[:, 0]
    alpha = torch.full((B, S), neg_inf, device=dev)
    col0 = (pos == 0).expand(B, S)
    col1 = (pos == 1).expand(B, S)
    alpha = torch.where(col0, logp[0, :, blank][:, None], alpha)
    alpha = torch.where(col1, torch.where(lab_len > 0, first_lab,
                                          torch.full_like(first_lab,
                                                          neg_inf))[:, None],
                        alpha)
    for t in range(1, T):
        a1 = F.pad(alpha, (1, 0), value=neg_inf)[:, :S]
        a2 = F.pad(alpha, (2, 0), value=neg_inf)[:, :S]
        merged = torch.logaddexp(alpha, a1)
        merged = torch.where(can_skip, torch.logaddexp(merged, a2), merged)
        emit = torch.gather(logp[t], 1, ext)
        live = (t < in_len)[:, None]
        alpha = torch.where(live, merged + emit, alpha)

    endpos = 2 * lab_len - 1
    final_blank = torch.gather(alpha, 1, (endpos + 1)[:, None])[:, 0]
    final_label = torch.gather(alpha, 1, torch.clamp(endpos, min=0)[:, None])[:, 0]
    ll = torch.where(lab_len > 0, torch.logaddexp(final_blank, final_label),
                     final_blank)
    return -ll
