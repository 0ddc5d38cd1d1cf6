"""The ``mx.nd.*`` operator namespace.

Counterpart of ``incubator_mxnet_tpu/ndarray/ops.py``, op for op and alias
for alias: each op is a thin eager wrapper (``invoke``) over a plain torch
function, differentiable under ``autograd.record()``. Both snake_case and
the reference's CamelCase names are exposed, and unknown keyword arguments
raise (``_strictify_module``). Binary ops take both operands in the
promotion of their types, as ``jnp`` does. ``LayerNorm`` and ``softmax``
reach the B5 and B6 CUDA kernels through ``ops/nn.py``, ``RNN`` the B8
LSTM kernels through ``ops/rnn.py``. ``Custom`` runs a registered custom
operator through ``operator.py``.
"""
from __future__ import annotations

import builtins as _builtins
import math
import sys

import torch
import torch.nn.functional as F

from ..ops import device_vector
from ..ops import nn as _nn
from .ndarray import (NDArray, invoke, _as_nd, _cmp, _pad, _promote,
                      array, zeros, ones, full, empty, arange, eye, linspace,
                      concat, concatenate, stack, split, dot, batch_dot,
                      moveaxis, reduce_op, to_torch_dtype)

_mod = sys.modules[__name__]


def _first_nd(*xs):
    for x in xs:
        if isinstance(x, NDArray):
            return x
    return None


def _unary(name, fn):
    def op(data, *, out=None, **kw):
        res = invoke(fn, [_as_nd(data)], name)
        if out is not None:
            out._set_data(res._data)
            return out
        return res
    op.__name__ = name
    op.__doc__ = f"Elementwise {name}."
    return op


def _float(x):
    """Integer input promoted to float32, as jnp's transcendental ops do."""
    return x if x.is_floating_point() or x.is_complex() else x.float()


def _cbrt(x):
    x = _float(x)
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


_UNARY = {
    "abs": torch.abs, "sign": torch.sign, "round": torch.round,
    "rint": torch.round, "ceil": torch.ceil, "floor": torch.floor,
    "trunc": torch.trunc, "fix": torch.trunc, "square": torch.square,
    "sqrt": torch.sqrt, "rsqrt": lambda x: torch.rsqrt(_float(x)),
    "cbrt": _cbrt, "rcbrt": lambda x: 1.0 / _cbrt(x),
    "exp": torch.exp, "log": torch.log, "log10": torch.log10,
    "log2": torch.log2, "log1p": torch.log1p, "expm1": torch.expm1,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh, "arctanh": torch.atanh,
    "degrees": lambda x: torch.rad2deg(_float(x)),
    "radians": lambda x: torch.deg2rad(_float(x)),
    "sigmoid": lambda x: torch.sigmoid(_float(x)), "relu": torch.relu,
    "softsign": lambda x: F.softsign(_float(x)),
    "reciprocal": lambda x: torch.reciprocal(_float(x)),
    "negative": torch.neg, "erf": lambda x: torch.special.erf(_float(x)),
    "erfinv": lambda x: torch.special.erfinv(_float(x)),
    "gamma": lambda x: torch.exp(torch.lgamma(_float(x))),
    "gammaln": lambda x: torch.lgamma(_float(x)),
    "logical_not": lambda x: (x == 0).to(x.dtype),
    "zeros_like": torch.zeros_like, "ones_like": torch.ones_like,
    "identity": lambda x: x,
}
for _name, _fn in _UNARY.items():
    setattr(_mod, _name, _unary(_name, _fn))


def _binary(name, fn):
    def op(lhs, rhs, *, out=None, **kw):
        like = _first_nd(lhs, rhs)
        res = invoke(lambda a, b: fn(*_promote(a, b)),
                     [_as_nd(lhs, like), _as_nd(rhs, like)], name)
        if out is not None:
            out._set_data(res._data)
            return out
        return res
    op.__name__ = name
    op.__doc__ = f"Broadcasting binary {name}."
    return op


_BINARY = {
    "add": torch.add, "subtract": torch.sub, "multiply": torch.mul,
    "divide": torch.true_divide, "modulo": torch.remainder, "power": torch.pow,
    "maximum": torch.maximum, "minimum": torch.minimum,
    "hypot": lambda x, y: torch.hypot(_float(x), _float(y)),
    "arctan2": lambda x, y: torch.atan2(_float(x), _float(y)),
    "equal": _cmp(torch.eq), "not_equal": _cmp(torch.ne),
    "greater": _cmp(torch.gt), "greater_equal": _cmp(torch.ge),
    "lesser": _cmp(torch.lt), "lesser_equal": _cmp(torch.le),
    "logical_and": _cmp(lambda x, y: (x != 0) & (y != 0)),
    "logical_or": _cmp(lambda x, y: (x != 0) | (y != 0)),
    "logical_xor": _cmp(lambda x, y: (x != 0) ^ (y != 0)),
}
for _name, _fn in _BINARY.items():
    setattr(_mod, _name, _binary(_name, _fn))
    setattr(_mod, "broadcast_" + _name, _binary("broadcast_" + _name, _fn))
# the reference spells some differently
broadcast_sub = getattr(_mod, "broadcast_subtract")
broadcast_mul = getattr(_mod, "broadcast_multiply")
broadcast_div = getattr(_mod, "broadcast_divide")
broadcast_mod = getattr(_mod, "broadcast_modulo")
elemwise_add = getattr(_mod, "add")
elemwise_sub = getattr(_mod, "subtract")
elemwise_mul = getattr(_mod, "multiply")
elemwise_div = getattr(_mod, "divide")
mod = getattr(_mod, "modulo")


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def _reduce(name):
    def op(data, axis=None, keepdims=False, exclude=False, **kw):
        data = _as_nd(data)
        ax = axis
        if isinstance(ax, list):
            ax = tuple(ax)
        if exclude and ax is not None:
            if isinstance(ax, int):
                ax = (ax,)
            ax = tuple(i for i in range(data.ndim) if i not in
                       tuple(a % data.ndim for a in ax))
        return invoke(lambda x: reduce_op(name, x, ax, keepdims), [data],
                      name)
    op.__name__ = name
    return op


for _name in ("sum", "mean", "prod", "nansum", "nanprod", "max", "min"):
    setattr(_mod, _name, _reduce(_name))
sum_axis = getattr(_mod, "sum")


def norm(data, ord=2, axis=None, keepdims=False, **kw):
    data = _as_nd(data)
    dims = tuple(axis) if isinstance(axis, list) else axis

    def f(x):
        if ord == 2:
            return torch.sqrt(reduce_op("sum", torch.square(x), dims,
                                        keepdims))
        return reduce_op("sum", torch.abs(x), dims, keepdims)
    return invoke(f, [data], "norm")


def argmax(data, axis=None, keepdims=False):
    return _as_nd(data).argmax(axis, keepdims)


def argmin(data, axis=None, keepdims=False):
    return _as_nd(data).argmin(axis, keepdims)


def topk(data, axis: int = -1, k: int = 1, ret_typ: str = "indices",
         is_ascend: bool = False, dtype="float32"):
    data = _as_nd(data)
    odt = to_torch_dtype(dtype)

    def f(x):
        vals, idx = torch.topk(x, k, dim=axis, largest=not is_ascend,
                               sorted=True)
        if ret_typ == "value":
            return vals
        if ret_typ == "both":
            return vals, idx.to(odt)
        if ret_typ == "mask":
            mask = torch.zeros_like(x)
            return mask.scatter(axis, idx, torch.ones_like(vals))
        return idx.to(odt)
    if ret_typ == "both":
        return invoke(f, [data], "topk", n_out=2)
    return invoke(f, [data], "topk")


def sort(data, axis: int = -1, is_ascend: bool = True):
    """``axis=None`` sorts the flattened array."""
    return invoke(lambda x: torch.sort(
        x.reshape(-1) if axis is None else x, dim=0 if axis is None
        else axis, stable=True, descending=not is_ascend).values,
        [_as_nd(data)], "sort")


def argsort(data, axis: int = -1, is_ascend: bool = True, dtype="float32"):
    return _as_nd(data).argsort(axis, is_ascend)


def pick(data, index, axis: int = -1, keepdims: bool = False, mode="clip"):
    """Along ``axis``, the entry ``index`` names (clipped into range)."""
    def f(x, i):
        i = torch.clamp(i.to(torch.int64), 0, x.shape[axis] - 1)
        r = torch.gather(x, axis, torch.unsqueeze(i, axis))
        return r if keepdims else torch.squeeze(r, axis)
    data = _as_nd(data)
    return invoke(f, [data, _as_nd(index, data)], "pick")


# ---------------------------------------------------------------------------
# shape / indexing ops
# ---------------------------------------------------------------------------

def reshape(data, shape, reverse=False, **kw):
    return _as_nd(data).reshape(shape)


def reshape_like(lhs, rhs):
    return _as_nd(lhs).reshape(_as_nd(rhs).shape)


def flatten(data):
    return _as_nd(data).flatten()


def transpose(data, axes=None):
    return _as_nd(data).transpose(axes)


def expand_dims(data, axis):
    return _as_nd(data).expand_dims(axis)


def squeeze(data, axis=None):
    return _as_nd(data).squeeze(axis)


def broadcast_to(data, shape):
    return _as_nd(data).broadcast_to(shape)


def broadcast_like(lhs, rhs):
    return _as_nd(lhs).broadcast_to(_as_nd(rhs).shape)


def broadcast_axis(data, axis, size):
    data = _as_nd(data)
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    tgt = list(data.shape)
    for a, s in zip(axes, sizes):
        tgt[a] = s
    return data.broadcast_to(tgt)


def tile(data, reps):
    return _as_nd(data).tile(reps)


def repeat(data, repeats, axis=None):
    return _as_nd(data).repeat(repeats, axis)


def pad(data, mode="constant", pad_width=None, constant_value=0):
    """``pad_width`` is the reference's flat 2 * ndim tuple."""
    data = _as_nd(data)
    pw = [(pad_width[2 * i], pad_width[2 * i + 1]) for i in range(data.ndim)]
    if mode not in ("constant", "edge", "reflect"):
        raise KeyError(mode)
    return invoke(lambda x: _pad(x, pw, mode, constant_value), [data], "pad")


def flip(data, axis):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return invoke(lambda x: torch.flip(x, axes), [_as_nd(data)], "flip")


reverse = flip


def clip(data, a_min, a_max):
    return _as_nd(data).clip(a_min, a_max)


def where(condition, x, y):
    like = _first_nd(condition, x, y)
    return invoke(lambda c, a, b: torch.where(c != 0, *_promote(a, b)),
                  [_as_nd(condition, like), _as_nd(x, like),
                   _as_nd(y, like)], "where")


def take(a, indices, axis=0, mode="clip"):
    a = _as_nd(a)
    return a.take(_as_nd(indices, a), axis, mode)


def batch_take(a, indices):
    return pick(a, indices, axis=-1)


def gather_nd(data, indices):
    """indices (M, ...) index the first M dims of data."""
    def f(x, idx):
        idx = idx.to(torch.int64)
        return x[tuple(idx[i] for i in range(idx.shape[0]))]
    data = _as_nd(data)
    return invoke(f, [data, _as_nd(indices, data)], "gather_nd")


def scatter_nd(data, indices, shape):
    def f(d, idx):
        idx = idx.to(torch.int64)
        out = torch.zeros(tuple(shape), dtype=d.dtype, device=d.device)
        return out.index_put(tuple(idx[i] for i in range(idx.shape[0])), d)
    data = _as_nd(data)
    return invoke(f, [data, _as_nd(indices, data)], "scatter_nd")


def slice(data, begin, end, step=None):  # noqa: A001 - reference name
    return _as_nd(data).slice(begin, end, step)


def slice_axis(data, axis, begin, end):
    return _as_nd(data).slice_axis(axis, begin, end)


def slice_like(data, shape_like, axes=()):
    data, ref = _as_nd(data), _as_nd(shape_like)
    axes = axes or range(data.ndim)
    idx = [_builtins.slice(None)] * data.ndim
    for a in axes:
        idx[a] = _builtins.slice(0, ref.shape[a])
    return data[tuple(idx)]


def diag(data, k=0, **kw):
    return invoke(lambda x: torch.diag(x, k) if x.dim() <= 2
                  else torch.diagonal(x, k, -2, -1), [_as_nd(data)], "diag")


def shape_array(data):
    data = _as_nd(data)
    return array(list(data.shape), ctx=data.context, dtype="int64")


def size_array(data):
    data = _as_nd(data)
    return array([data.size], ctx=data.context, dtype="int64")


def cast(data, dtype):
    return _as_nd(data).astype(dtype)


Cast = cast


def one_hot(indices, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    dt = to_torch_dtype(dtype)
    return invoke(lambda i: _nn.one_hot(i, depth, on_value, off_value, dt),
                  [_as_nd(indices)], "one_hot")


def swapaxes(data, dim1, dim2):
    return _as_nd(data).swapaxes(dim1, dim2)


SwapAxis = swapaxes


def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    data = _as_nd(data)
    if sequence_length is not None:
        return invoke(lambda x, l: _nn.sequence_mask(
            x, l, use_sequence_length, value, axis),
            [data, _as_nd(sequence_length, data)], "sequence_mask")
    return data


SequenceMask = sequence_mask


def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0):
    d = _as_nd(data)
    if not use_sequence_length or sequence_length is None:
        return (d[d.shape[axis] - 1] if axis == 0
                else d.slice_axis(axis, -1, None).squeeze(axis))

    def f(x, l):
        idx = l.to(torch.int64) - 1
        xm = torch.movedim(x, axis, 0)
        return torch.gather(xm, 0, idx.reshape(
            (1, -1) + (1,) * (xm.dim() - 2)).expand(
                (1,) + tuple(xm.shape[1:])))[0]
    return invoke(f, [d, _as_nd(sequence_length, d)], "sequence_last")


def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    d = _as_nd(data)
    if not use_sequence_length or sequence_length is None:
        return flip(d, axis)

    def f(x, l):
        seq = x.shape[0]
        pos = torch.arange(seq, device=x.device)[:, None]
        li = l.to(torch.int64)[None, :]
        rev = torch.where(pos < li, li - 1 - pos, pos)
        rev = rev.reshape(rev.shape + (1,) * (x.dim() - 2)).expand(x.shape)
        return torch.gather(x, 0, rev)
    return invoke(f, [d, _as_nd(sequence_length, d)], "sequence_reverse")


# ---------------------------------------------------------------------------
# NN ops (CamelCase reference names)
# ---------------------------------------------------------------------------

def FullyConnected(data, weight, bias=None, num_hidden=None, no_bias=False,
                   flatten=True, **kw):
    ins = [_as_nd(data), _as_nd(weight)]
    if not no_bias and bias is not None:
        ins.append(_as_nd(bias))
        return invoke(lambda x, w, b: _nn.fully_connected(
            x, w, b, num_hidden, flatten), ins, "FullyConnected")
    return invoke(lambda x, w: _nn.fully_connected(
        x, w, None, num_hidden, flatten), ins, "FullyConnected")


def Convolution(data, weight, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=None, num_group=1,
                no_bias=False, layout="NCHW", **kw):
    nd = _as_nd(data).ndim - 2
    stride = stride or (1,) * nd
    dilate = dilate or (1,) * nd
    pad = pad or (0,) * nd
    ins = [_as_nd(data), _as_nd(weight)]
    if not no_bias and bias is not None:
        ins.append(_as_nd(bias))
        return invoke(lambda x, w, b: _nn.convolution(
            x, w, b, kernel, stride, dilate, pad, num_filter, num_group,
            layout), ins, "Convolution")
    return invoke(lambda x, w: _nn.convolution(
        x, w, None, kernel, stride, dilate, pad, num_filter, num_group,
        layout), ins, "Convolution")


def Deconvolution(data, weight, bias=None, kernel=None, stride=None,
                  dilate=None, pad=None, adj=None, num_filter=None,
                  num_group=1, no_bias=True, target_shape=None,
                  layout=None, **kw):
    if layout is not None and not layout.startswith("NC"):
        raise ValueError(f"Deconvolution supports NC* layouts only, got "
                         f"{layout}")
    nd = _as_nd(data).ndim - 2
    stride = stride or (1,) * nd
    dilate = dilate or (1,) * nd
    pad = pad or (0,) * nd
    adj = adj or (0,) * nd
    ins = [_as_nd(data), _as_nd(weight)]
    if not no_bias and bias is not None:
        ins.append(_as_nd(bias))
        return invoke(lambda x, w, b: _nn.deconvolution(
            x, w, b, kernel, stride, dilate, pad, adj, num_filter, num_group,
            target_shape), ins, "Deconvolution")
    return invoke(lambda x, w: _nn.deconvolution(
        x, w, None, kernel, stride, dilate, pad, adj, num_filter, num_group,
        target_shape), ins, "Deconvolution")


def Pooling(data, kernel=(2, 2), pool_type="max", stride=None, pad=None,
            global_pool=False, pooling_convention="valid",
            count_include_pad=True, layout="NCHW", **kw):
    d = _as_nd(data)
    pad = pad or (0,) * (d.ndim - 2)
    return invoke(lambda x: _nn.pooling(x, kernel, pool_type, stride, pad,
                                        global_pool, count_include_pad,
                                        pooling_convention, layout),
                  [d], "Pooling")


def Activation(data, act_type="relu", **kw):
    return invoke(lambda x: _nn.activation(x, act_type), [_as_nd(data)],
                  "Activation")


def LeakyReLU(data, gamma=None, act_type="leaky", slope=0.25,
              lower_bound=0.125, upper_bound=0.334, **kw):
    ins = [_as_nd(data)]
    if act_type == "prelu" and gamma is not None:
        ins.append(_as_nd(gamma))
        return invoke(lambda x, g: _nn.leaky_relu(
            x, act_type, slope, lower_bound, upper_bound, g), ins,
            "LeakyReLU")
    return invoke(lambda x: _nn.leaky_relu(x, act_type, slope, lower_bound,
                                           upper_bound, training=False),
                  ins, "LeakyReLU")


def BatchNorm(data, gamma, beta, moving_mean, moving_var, eps=1e-5,
              momentum=0.9, fix_gamma=True, use_global_stats=False,
              output_mean_var=False, axis=1, **kw):
    from .. import autograd as _ag
    training = _ag.is_training()
    mm_nd, mv_nd = _as_nd(moving_mean), _as_nd(moving_var)

    def f(x, g, b, mm, mv):
        y, nm, nv = _nn.batch_norm(x, g, b, mm, mv, eps, momentum,
                                   fix_gamma, use_global_stats, training,
                                   axis)
        # the extra outputs are the batch statistics the normalization
        # used (not the blended moving averages)
        if training and not use_global_stats:
            red = tuple(i for i in range(x.dim()) if i != axis)
            n = math.prod(x.shape[i] for i in red)
            xf = x.float()
            bmean = xf.sum(dim=red) / n
            bvar = torch.clamp(torch.square(xf).sum(dim=red) / n
                               - torch.square(bmean), min=0.0)
        else:
            bmean, bvar = mm, mv
        return y, nm, nv, bmean, bvar

    y, new_mean, new_var, batch_mean, batch_var = invoke(
        f, [_as_nd(data), _as_nd(gamma), _as_nd(beta), mm_nd, mv_nd],
        "BatchNorm", n_out=5)
    if training and not use_global_stats:
        # the moving statistics are aux states the forward updates
        mm_nd._set_data(new_mean._data)
        mv_nd._set_data(new_var._data)
    if output_mean_var:
        return y, batch_mean, batch_var
    return y


def LayerNorm(data, gamma, beta, axis=-1, eps=1e-5, **kw):
    """Layer norm; the last axis runs the B5 kernels on the card."""
    return invoke(lambda x, g, b: _nn.layer_norm(x, g, b, axis, eps),
                  [_as_nd(data), _as_nd(gamma), _as_nd(beta)], "LayerNorm")


def InstanceNorm(data, gamma, beta, eps=1e-5, **kw):
    return invoke(lambda x, g, b: _nn.instance_norm(x, g, b, eps),
                  [_as_nd(data), _as_nd(gamma), _as_nd(beta)],
                  "InstanceNorm")


def L2Normalization(data, eps=1e-10, mode="instance"):
    def f(x):
        if mode == "instance":
            red = tuple(range(1, x.dim()))
        elif mode == "channel":
            red = (1,)
        else:  # spatial
            red = tuple(range(2, x.dim()))
        return x / torch.sqrt(torch.sum(torch.square(x), dim=red,
                                        keepdim=True) + eps)
    return invoke(f, [_as_nd(data)], "L2Normalization")


def LRN(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5, **kw):
    return invoke(lambda x: _nn.lrn(x, nsize, alpha, beta, knorm),
                  [_as_nd(data)], "LRN")


def Dropout(data, p=0.5, mode="training", axes=(), **kw):
    from .. import autograd as _ag
    from .. import random as _rnd
    data = _as_nd(data)
    if not _ag.is_training() or p <= 0:
        return data
    g = _rnd.generator(data._data.device)
    return invoke(lambda x: _nn.dropout(x, g, p, mode, tuple(axes), True),
                  [data], "Dropout")


def Embedding(data, weight, input_dim=None, output_dim=None,
              dtype="float32", sparse_grad=False, **kw):
    return invoke(lambda i, w: _nn.embedding(i, w),
                  [_as_nd(data), _as_nd(weight)], "Embedding")


def softmax(data, axis=-1, temperature=None, length=None, **kw):
    """Softmax; the last axis runs the B6 kernel on the card."""
    data = _as_nd(data)
    if length is not None:
        return invoke(lambda x, l: _nn.softmax(x, axis, temperature, l),
                      [data, _as_nd(length, data)], "softmax")
    return invoke(lambda x: _nn.softmax(x, axis, temperature), [data],
                  "softmax")


def log_softmax(data, axis=-1, temperature=None, **kw):
    return invoke(lambda x: _nn.log_softmax(x, axis, temperature),
                  [_as_nd(data)], "log_softmax")


def softmax_cross_entropy(data, label, **kw):
    """Summed cross-entropy over the batch."""
    data = _as_nd(data)
    return invoke(lambda x, l: torch.sum(_nn.softmax_cross_entropy(x, l)),
                  [data, _as_nd(label, data)], "softmax_cross_entropy")


def SoftmaxOutput(data, label=None, grad_scale=1.0, ignore_label=-1,
                  multi_output=False, use_ignore=False, normalization="null",
                  **kw):
    data = _as_nd(data)
    if label is None:
        return invoke(lambda x: _nn.softmax_output(
            x, None, multi_output=multi_output), [data], "SoftmaxOutput")
    return invoke(lambda x, l: _nn.softmax_output(
        x, l, ignore_label=ignore_label, multi_output=multi_output,
        use_ignore=use_ignore, grad_scale=grad_scale,
        normalization=normalization),
        [data, _as_nd(label, data)], "SoftmaxOutput")


def SoftmaxActivation(data, mode="instance"):
    return softmax(data, axis=1 if mode == "channel" else -1)


def smooth_l1(data, scalar=1.0, **kw):
    return invoke(lambda x: _nn.smooth_l1(x, scalar), [_as_nd(data)],
                  "smooth_l1")


def MakeLoss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    return invoke(lambda x: x * grad_scale if grad_scale != 1.0 else x,
                  [_as_nd(data)], "MakeLoss")


def BlockGrad(data):
    return invoke(lambda x: x.detach(), [_as_nd(data)], "BlockGrad")


stop_gradient = BlockGrad


def RNN(data, parameters, state, state_cell=None, mode="lstm",
        state_size=None, num_layers=1, bidirectional=False, p=0.0,
        state_outputs=False, **kw):
    """Fused multi-layer RNN over a packed parameter vector (ref:
    src/operator/rnn-inl.h:158 RNNParam; packing rnn_packed_param_size);
    LSTM runs the fused LSTM kernels where the reference's rule takes the
    shape (``ops/rnn.py``)."""
    if kw:
        raise TypeError(f"RNN got unsupported keyword arguments {sorted(kw)}; "
                        "supported: mode, state_size, num_layers, "
                        "bidirectional, p, state_outputs")
    if state_size is None:
        raise ValueError("RNN requires state_size (the hidden size H used "
                         "to unpack the flat parameter vector)")
    from ..ops import rnn as _rnn
    from .. import autograd as _ag
    from .. import random as _random
    training = _ag.is_training()
    data = _as_nd(data)
    gen = (_random.generator(data._data.device) if (p > 0.0 and training)
           else None)
    ins = [data, _as_nd(parameters), _as_nd(state)]
    if mode == "lstm" and state_cell is not None:
        ins.append(_as_nd(state_cell))

    def fn(d, pr, st, sc=None):
        return _rnn.rnn(d, pr, st, sc, mode=mode, state_size=state_size,
                        num_layers=num_layers, bidirectional=bidirectional,
                        p=p, state_outputs=state_outputs, training=training,
                        generator=gen)
    n_out = 1 if not state_outputs else (3 if mode == "lstm" else 2)
    return invoke(fn, ins, "RNN", n_out=n_out)


def UpSampling(*data, scale=2, sample_type="nearest", num_args=1, **kw):
    """Nearest upsampling, NCHW."""
    def f(v):
        return torch.repeat_interleave(
            torch.repeat_interleave(v, scale, dim=2), scale, dim=3)
    return invoke(f, [_as_nd(data[0])], "UpSampling")


def Concat(*data, dim=1, num_args=None, **kw):
    return concat(*data, dim=dim)


def add_n(*args, **kw):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    like = _first_nd(*args)
    return invoke(lambda *xs: _builtins.sum(xs[1:], xs[0]),
                  [_as_nd(a, like) for a in args], "add_n")


ElementWiseSum = add_n


def dot_op(lhs, rhs, transpose_a=False, transpose_b=False):
    return dot(lhs, rhs, transpose_a, transpose_b)


linalg_gemm2 = batch_dot

# snake_case aliases of the reference's generated names
fully_connected = FullyConnected
convolution = Convolution
pooling = Pooling
activation = Activation
batch_norm = BatchNorm
layer_norm = LayerNorm
dropout = Dropout
embedding = Embedding


def _flash_attention(q, k, v, scale=1.0, causal=False):
    """Fused attention over (B, T, D) or (B, H, T, D), through the port's
    flash-attention op (``ops/cuda/flash_attention.py``)."""
    from ..ops.cuda.flash_attention import flash_attention as _fa

    def fn(qv, kv, vv):
        squeeze = qv.dim() == 3
        if squeeze:
            qv, kv, vv = (x[:, None] for x in (qv, kv, vv))
        out = _fa(qv, kv, vv, causal=causal, scale=scale)
        return out[:, 0] if squeeze else out

    return invoke(fn, [_as_nd(q), _as_nd(k), _as_nd(v)], "_flash_attention")


def _regression_head(op_name, kind):
    def head(data, label=None, grad_scale=1.0, **kw):
        data = _as_nd(data)
        if label is None:
            return invoke(lambda x: _nn.regression_output(
                x, None, grad_scale, kind), [data], op_name)
        return invoke(lambda x, l: _nn.regression_output(
            x, l, grad_scale, kind), [data, _as_nd(label, data)], op_name)

    head.__name__ = op_name
    head.__doc__ = f"Fused regression head ({kind})."
    return head


LinearRegressionOutput = _regression_head("LinearRegressionOutput", "linear")
MAERegressionOutput = _regression_head("MAERegressionOutput", "mae")
LogisticRegressionOutput = _regression_head("LogisticRegressionOutput",
                                            "logistic")


def histogram(a, bins=10, range=None, **kw):
    """(counts, edges) in float32."""
    rng_pair = range

    def f(x):
        xf = x.float()
        lo, hi = ((xf.min().item(), xf.max().item()) if rng_pair is None
                  else rng_pair)
        cnt = torch.histc(xf, bins=bins, min=float(lo), max=float(hi))
        edges = torch.linspace(float(lo), float(hi), bins + 1,
                               device=x.device)
        return cnt, edges

    return invoke(f, [_as_nd(a)], "histogram", n_out=2)


def ravel_multi_index(data, shape=None, **kw):
    """(ndim, N) indices -> flat indices under ``shape``."""
    if shape is None:
        raise ValueError("ravel_multi_index needs shape")

    def f(x):
        strides = [1]
        for s in reversed(shape[1:]):
            strides.insert(0, strides[0] * s)
        st = device_vector(strides, x.dtype, x.device)
        return torch.sum(x * st[:, None], dim=0)

    return invoke(f, [_as_nd(data)], "ravel_multi_index")


def unravel_index(data, shape=None, **kw):
    """Flat (N,) -> (ndim, N)."""
    if shape is None:
        raise ValueError("unravel_index needs shape")

    def f(x):
        return torch.stack(torch.unravel_index(x.to(torch.int64), shape),
                           dim=0).to(torch.int32)

    return invoke(f, [_as_nd(data)], "unravel_index")


def depth_to_space(data, block_size, **kw):
    b = block_size

    def f(x):
        n, c, h, w = x.shape
        y = x.reshape(n, b, b, c // (b * b), h, w)
        y = y.permute(0, 3, 4, 1, 5, 2)
        return y.reshape(n, c // (b * b), h * b, w * b)

    return invoke(f, [_as_nd(data)], "depth_to_space")


def space_to_depth(data, block_size, **kw):
    b = block_size

    def f(x):
        n, c, h, w = x.shape
        y = x.reshape(n, c, h // b, b, w // b, b)
        y = y.permute(0, 3, 5, 1, 2, 4)   # the exact inverse of the above
        return y.reshape(n, c * b * b, h // b, w // b)

    return invoke(f, [_as_nd(data)], "space_to_depth")


def GridGenerator(data, transform_type="affine", target_shape=None, **kw):
    """Affine sampling grid: data (B, 6); output (B, 2, H, W) of x, y in
    [-1, 1]."""
    if transform_type != "affine":
        raise ValueError("GridGenerator: warp grids arrive as data directly")
    h, w = target_shape

    def f(theta):
        ys = torch.linspace(-1, 1, h, device=theta.device)
        xs = torch.linspace(-1, 1, w, device=theta.device)
        yg, xg = torch.meshgrid(ys, xs, indexing="ij")
        base = torch.stack([xg, yg, torch.ones_like(xg)], 0).reshape(3, -1)
        t = theta.reshape(-1, 2, 3)
        return torch.einsum("bij,jn->bin", t, base.to(t.dtype)).reshape(
            -1, 2, h, w)

    return invoke(f, [_as_nd(data)], "GridGenerator")


def _bilinear_sample(img, yy, xx):
    """img (C, H, W) sampled at float coordinates; out of range reads 0."""
    C, H, W = img.shape
    y0 = torch.floor(yy)
    x0 = torch.floor(xx)
    wy = yy - y0
    wx = xx - x0
    out = 0.0
    for dy, wyy in ((0, 1 - wy), (1, wy)):
        for dx, wxx in ((0, 1 - wx), (1, wx)):
            yi = (y0 + dy).to(torch.int64)
            xi = (x0 + dx).to(torch.int64)
            inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            val = img[:, yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
            out = out + val * (wyy * wxx * inb)[None]
    return out


def BilinearSampler(data, grid, **kw):
    """Sample NCHW ``data`` at ``grid`` (B, 2, H', W') in [-1, 1]; out of
    range reads 0."""
    def f(x, g):
        n, c, h, w = x.shape
        gx = (g[:, 0] + 1.0) * (w - 1) / 2.0
        gy = (g[:, 1] + 1.0) * (h - 1) / 2.0
        return torch.stack([_bilinear_sample(x[i], gy[i], gx[i])
                            for i in range(n)])

    data = _as_nd(data)
    return invoke(f, [data, _as_nd(grid, data)], "BilinearSampler")


def SpatialTransformer(data, loc, target_shape=None,
                       transform_type="affine", sampler_type="bilinear",
                       **kw):
    """GridGenerator + BilinearSampler."""
    grid = GridGenerator(loc, transform_type, target_shape=target_shape)
    return BilinearSampler(data, grid)


def ROIPooling(data, rois, pooled_size, spatial_scale, **kw):
    """Max-pool ROI extraction; rois (R, 5) = [batch, x1, y1, x2, y2]."""
    ph, pw = pooled_size

    def one(x, roi):
        bidx = int(roi[0].item())
        x1, y1, x2, y2 = torch.round(roi[1:] * spatial_scale)
        img = x[bidx]
        h, w = img.shape[1], img.shape[2]
        rh = torch.clamp(y2 - y1 + 1, min=1.0)
        rw = torch.clamp(x2 - x1 + 1, min=1.0)
        ygrid = torch.arange(h, device=x.device)
        xgrid = torch.arange(w, device=x.device)
        rows = []
        for i in range(ph):
            ys = torch.floor(y1 + i * rh / ph)
            ye = torch.maximum(torch.ceil(y1 + (i + 1) * rh / ph), ys + 1)
            my = (ygrid >= ys) & (ygrid < ye)
            cols = []
            for j in range(pw):
                xs = torch.floor(x1 + j * rw / pw)
                xe = torch.maximum(torch.ceil(x1 + (j + 1) * rw / pw),
                                   xs + 1)
                mask = my[:, None] & ((xgrid >= xs) & (xgrid < xe))
                v = torch.where(mask, img, torch.full((), -math.inf,
                                                      dtype=img.dtype,
                                                      device=x.device))
                v = v.amax(dim=(1, 2))
                cols.append(torch.where(torch.isfinite(v), v,
                                        torch.zeros_like(v)))
            rows.append(torch.stack(cols, dim=-1))
        return torch.stack(rows, dim=-2)

    def f(x, r):
        return torch.stack([one(x, r[i]) for i in range(r.shape[0])])

    data = _as_nd(data)
    return invoke(f, [data, _as_nd(rois, data)], "ROIPooling")


class _MakeLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return torch.ones_like(g)


def make_loss(data, **kw):
    """Forward identity; the backward seeds ones whatever the head
    gradient."""
    return invoke(_MakeLoss.apply, [_as_nd(data)], "make_loss")


def Custom(*inputs, op_type=None, **kwargs):
    """Run the custom operator registered as ``op_type`` (``operator.py``;
    ref: src/operator/custom/custom.cc); ``kwargs`` go to its prop."""
    if op_type is None:
        raise ValueError("nd.Custom needs op_type, the registered name")
    from .. import operator as _op_mod
    return _op_mod.invoke_custom(op_type, *inputs, **kwargs)


SequenceLast = sequence_last
SequenceReverse = sequence_reverse
SequenceMask = sequence_mask
Pad = pad


def Correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                stride2=1, pad_size=0, is_multiply=True, **kw):
    """FlowNet's correlation layer: for every displacement in the stride2
    grid within max_displacement, the patch-wise product (or absolute
    difference) of data1 and the displaced data2, normalized by the patch
    element count; output (B, D*D, H', W')."""
    if kw:
        raise TypeError(f"unsupported Correlation kwargs {sorted(kw)}")
    if kernel_size % 2 != 1:
        raise ValueError("Correlation kernel_size must be odd")
    md = max_displacement
    kr = (kernel_size - 1) // 2
    border = md + kr

    def f(a, b):
        B, C, H, W = a.shape
        ps = [pad_size] * 4
        ap = F.pad(a, ps)
        bp = F.pad(b, ps)
        Hp, Wp = ap.shape[2], ap.shape[3]
        if Hp <= 2 * border or Wp <= 2 * border:
            raise ValueError(
                f"Correlation: padded input {Hp}x{Wp} smaller than twice "
                f"the border (max_displacement + kernel_radius = {border}); "
                "increase pad_size (FlowNet uses pad_size=max_displacement)")
        bwide = F.pad(bp, [md] * 4)
        sumelems = kernel_size * kernel_size * C
        maps = []
        for iy in range(-(md // stride2), md // stride2 + 1):
            for ix in range(-(md // stride2), md // stride2 + 1):
                dy, dx = iy * stride2, ix * stride2
                shifted = bwide[:, :, md + dy:md + dy + Hp,
                                md + dx:md + dx + Wp]
                prod = (ap * shifted if is_multiply
                        else torch.abs(ap - shifted))
                maps.append(prod.sum(dim=1))
        m = torch.stack(maps, dim=1)
        if kernel_size > 1:
            # "SAME" window sum over the whole displacement stack
            m = F.avg_pool2d(F.pad(m, [kr] * 4), kernel_size, 1) \
                * (kernel_size * kernel_size)
        return m[:, :, border:Hp - border:stride1,
                 border:Wp - border:stride1] / sumelems

    d1 = _as_nd(data1)
    return invoke(f, [d1, _as_nd(data2, d1)], "Correlation")


def Crop(data, *like, offset=(0, 0), h_w=(0, 0), num_args=None,
         center_crop=False, **kw):
    """Spatial crop of NCHW ``data`` to ``h_w`` at ``offset``, to a second
    input's spatial size, or centered."""
    if kw:
        raise TypeError(f"unsupported Crop kwargs {sorted(kw)}")
    if like:
        ref_shape = like[0].shape[2:]
    elif h_w != (0, 0):
        ref_shape = h_w
    else:
        raise ValueError("Crop needs h_w or a reference input")
    th, tw = int(ref_shape[0]), int(ref_shape[1])

    def f(x, *unused):
        H, W = x.shape[2], x.shape[3]
        if center_crop:
            y0, x0 = (H - th) // 2, (W - tw) // 2
        else:
            y0, x0 = offset
        if y0 < 0 or x0 < 0 or y0 + th > H or x0 + tw > W:
            raise ValueError(
                f"Crop window ({th}x{tw} at offset ({y0}, {x0})) exceeds "
                f"input spatial dims ({H}x{W})")
        return x[:, :, y0:y0 + th, x0:x0 + tw]

    ins = [_as_nd(data)] + [_as_nd(l) for l in like]
    return invoke(f, ins, "Crop")


# ---------------------------------------------------------------------------
# misc activation / loss / legacy-surface ops
# ---------------------------------------------------------------------------

def hard_sigmoid(data, alpha: float = 0.2, beta: float = 0.5, **kw):
    """clip(alpha * x + beta, 0, 1)."""
    return invoke(lambda x: torch.clamp(alpha * x + beta, 0.0, 1.0),
                  [_as_nd(data)], "hard_sigmoid")


def softmin(data, axis: int = -1, temperature=None, dtype=None, **kw):
    """Softmax of the negated input."""
    odt = to_torch_dtype(dtype)

    def f(x):
        xs = -x if temperature is None else -x / temperature
        r = torch.softmax(xs, dim=axis)
        return r.to(odt) if odt is not None else r
    return invoke(f, [_as_nd(data)], "softmin")


def argmax_channel(data, **kw):
    """argmax along axis 1, in the input's type."""
    return invoke(lambda x: torch.argmax(x, dim=1).to(x.dtype),
                  [_as_nd(data)], "argmax_channel")


def khatri_rao(*args, **kw):
    """Column-wise Khatri-Rao product: for A_i (M_i, N), the (prod M_i, N)
    matrix whose k-th column is the outer product of the k-th columns."""
    def f(*ms):
        out = ms[0]
        for m in ms[1:]:
            out = torch.einsum("ir,jr->ijr", out, m).reshape(
                -1, out.shape[1])
        return out
    like = _first_nd(*args)
    return invoke(f, [_as_nd(a, like) for a in args], "khatri_rao")


def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             use_data_lengths: bool = False, use_label_lengths: bool = False,
             blank_label: str = "first", **kw):
    """CTC alignment loss: data (T, B, C), label (B, L); (B,) losses. The
    given lengths count only with their use_*_lengths flag."""
    data = _as_nd(data)
    ins = [data, _as_nd(label, data)]
    dl = (_as_nd(data_lengths, data) if use_data_lengths
          and data_lengths is not None else None)
    ll = (_as_nd(label_lengths, data) if use_label_lengths
          and label_lengths is not None else None)

    def f(x, lab, *rest):
        rest = list(rest)
        dlv = rest.pop(0) if dl is not None else None
        llv = rest.pop(0) if ll is not None else None
        return _nn.ctc_loss(x, lab, dlv, llv, blank_label=blank_label)

    extra = [a for a in (dl, ll) if a is not None]
    return invoke(f, ins + extra, "CTCLoss")


CTCLoss = ctc_loss


def IdentityAttachKLSparseReg(data, sparseness_target: float = 0.1,
                              penalty: float = 0.001, momentum: float = 0.9,
                              **kw):
    """Identity whose backward adds the KL sparseness penalty's gradient,
    penalty * (-target / rho + (1 - target) / (1 - rho)), rho being the
    batch's per-unit mean activation (the reference's momentum = 0
    form)."""
    class _KL(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(torch.clamp(x.mean(dim=0, keepdim=True),
                                              1e-6, 1.0 - 1e-6))
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            (rho,) = ctx.saved_tensors
            return g + penalty * (-sparseness_target / rho
                                  + (1.0 - sparseness_target) / (1.0 - rho))

    return invoke(_KL.apply, [_as_nd(data)], "IdentityAttachKLSparseReg")


# legacy-name aliases of the v1 surface
SliceChannel = split
slice_channel = split
Flatten = flatten
stop_gradient = BlockGrad


def Reshape(data, shape=None, reverse=False, **kw):
    """CamelCase legacy name of reshape."""
    return reshape(_as_nd(data), shape=shape, reverse=reverse, **kw)


def BatchNorm_v1(data, gamma, beta, moving_mean=None, moving_var=None,
                 eps=1e-5, momentum=0.9, fix_gamma=True,
                 use_global_stats=False, output_mean_var=False, **kw):
    """Legacy v1 batch norm: the same math as BatchNorm."""
    return BatchNorm(data, gamma, beta, moving_mean, moving_var, eps=eps,
                     momentum=momentum, fix_gamma=fix_gamma,
                     use_global_stats=use_global_stats,
                     output_mean_var=output_mean_var)


# ---------------------------------------------------------------------------
# strict keyword validation: an unknown keyword raises MXTPUError instead of
# being swallowed; legacy CUDA/MKLDNN-only knobs and the naming attributes
# the reference's frontends attach are allowlisted and ignored
# ---------------------------------------------------------------------------

_IGNORED_LEGACY = frozenset({
    "cudnn_off", "cudnn_tune", "workspace", "mkldnn_off",
    "cudnn_algo_verbose", "cudnn_algo_fwd", "cudnn_algo_bwd_data",
    "cudnn_algo_bwd_filter",
    "name", "attr", "__layout__", "__profiler_scope__",
    "priority",
})


def _strictify_module():
    """Wrap every op of this module that declares ``**kw`` so unknown
    keyword arguments raise."""
    import functools as _functools
    import inspect as _inspect

    from ..base import MXTPUError as _Err

    for _n in list(vars(_mod)):
        _f = getattr(_mod, _n)
        if (not callable(_f) or _inspect.isclass(_f)
                or getattr(_f, "__module__", None) != __name__):
            continue
        try:
            _sig = _inspect.signature(_f)
        except (TypeError, ValueError):
            continue
        _vks = [p for p in _sig.parameters.values()
                if p.kind is _inspect.Parameter.VAR_KEYWORD]
        if not _vks or _vks[0].name != "kw":  # 'kwargs' = deliberately open
            continue
        _named = frozenset(
            p.name for p in _sig.parameters.values()
            if p.kind in (_inspect.Parameter.POSITIONAL_OR_KEYWORD,
                          _inspect.Parameter.KEYWORD_ONLY))

        def _wrap(f, named, opname):
            @_functools.wraps(f)
            def g(*a, **k):
                if k:
                    bad = [x for x in k
                           if x not in named and x not in _IGNORED_LEGACY]
                    if bad:
                        raise _Err(
                            f"operator '{opname}' got unknown argument(s) "
                            f"{bad}; valid arguments: {sorted(named)} "
                            "(legacy CUDA/MKLDNN knobs are ignored: "
                            f"{sorted(_IGNORED_LEGACY)})")
                    k = {x: v for x, v in k.items() if x in named}
                return f(*a, **k)
            return g

        setattr(_mod, _n, _wrap(_f, _named, _n))


_strictify_module()

# the namespace ``nd`` re-exports: every op and alias above
__all__ = [_n for _n, _v in vars(_mod).items()
           if not _n.startswith("_") and callable(_v)
           and _n not in ("reduce_op", "to_torch_dtype")]
