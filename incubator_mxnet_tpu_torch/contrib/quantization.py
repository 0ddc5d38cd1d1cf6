"""INT8 model quantization: calibration and network conversion.

Counterpart of the reference's ``contrib/quantization.py`` (ref:
python/mxnet/contrib/quantization.py: quantize_model with calib_mode
none/naive/entropy, ``_get_optimal_threshold`` KL calibration,
``_LayerOutputMinMaxCollector``; graph rewrite
src/operator/quantization/quantize_graph_pass.cc), with the same
behaviour: ``quantize_net`` walks a Gluon block tree and substitutes
Dense/Conv2D leaves with quantized wrappers whose forward runs the int8
products of ``ops/quantization.py`` (on the card, the ``qconv_s8`` and
``qgemm_s8`` tensor-core kernels).

Requantize fusion (ref: quantize_graph_pass.cc inserting ``requantize``
between adjacent quantized nodes): inside every ``HybridSequential``,
maximal runs of quantized layers and int8-safe pass-throughs (ReLU,
max/avg pooling, flatten, folded-BN identities) collapse into ONE
``QuantizedChain``, which quantizes its input once, keeps activations in
int8 — each conv/matmul accumulates in int32, adds its bias in int32
steps, applies ReLU on the accumulator and requantizes to the layer's
calibrated output range, all in the kernel's epilogue — and dequantizes
once at exit. A Conv->Pool->Conv->Dense chain crosses the float boundary
exactly twice (the ``mxtpu_quant_*_ops_total`` build-time counters).
Without fusion (``MXTPU_QUANT_FUSE=0`` or ``calib_mode='none'``) every
layer keeps its dequantize->float->quantize boundary.

Calibrated thresholds are observable and portable:
``mxtpu_quant_threshold{layer=...,kind=in|out}`` gauges,
``get_thresholds(net)``, and ``quantize_net(..., thresholds=saved)``
rebuilds the same quantized net with no calibration data.

Differences from the reference: the naive collector takes a layer's
min and max on the tensor's own device (exact, as numpy's); the int8
weights and float32 biases are registered on the device of the weights
they replace.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..gluon.block import Block, HybridBlock
from ..gluon import nn as _nn
from ..gluon.nn.conv_layers import _Pooling as _PoolingBase
from ..ndarray.ndarray import (NDArray, array as _nd_array, from_torch,
                                invoke)
from ..ops import quantization as qop

__all__ = ["quantize_net", "QuantizedDense", "QuantizedConv2D",
           "QuantizedChain", "QuantizedPooling", "QuantizedActivation",
           "QuantizedFlatten", "CalibrationCollector", "fold_batchnorm",
           "get_thresholds"]


def _fuse_default() -> bool:
    return os.environ.get("MXTPU_QUANT_FUSE", "1") != "0"


# ---------------------------------------------------------------------------
# KL (entropy) calibration (ref: python/mxnet/contrib/quantization.py:245-383)
# ---------------------------------------------------------------------------

def _smooth_distribution(p, eps: float = 1e-4):
    """Move a little mass from non-zero bins onto zero bins so KL is finite
    (ref: quantization.py:_smooth_distribution)."""
    is_zeros = (p == 0).astype(np.float64)
    is_nonzeros = (p != 0).astype(np.float64)
    n_zeros = int(is_zeros.sum())
    n_nonzeros = p.size - n_zeros
    if n_nonzeros == 0:
        return None
    eps1 = eps * n_zeros / n_nonzeros
    hist = p.astype(np.float64)
    hist += eps * is_zeros - eps1 * is_nonzeros
    if (hist < 0).any():
        return None
    return hist


def _kl_divergence(p, q):
    p = p / max(p.sum(), 1e-12)
    q = q / max(q.sum(), 1e-12)
    mask = p > 0
    return float(np.sum(p[mask] * np.log(p[mask] / np.maximum(q[mask], 1e-12))))


def _get_optimal_threshold(arr: np.ndarray, num_bins: Optional[int] = None,
                           num_quantized_bins: int = 255) -> float:
    """The |threshold| minimising KL(reference || quantized) (ref:
    quantization.py:_get_optimal_threshold): the input flattened to float64
    before binning, a fixed sweep of candidates that always includes the
    full range, ties kept at the smallest threshold. ``MXTPU_QUANT_BINS``
    (default 2001) and ``MXTPU_QUANT_SWEEP`` (candidates, default 64)."""
    if num_bins is None:
        num_bins = int(os.environ.get("MXTPU_QUANT_BINS", "2001"))
    sweep = max(1, int(os.environ.get("MXTPU_QUANT_SWEEP", "64")))
    arr = np.abs(np.asarray(arr, dtype=np.float64).ravel())
    max_val = float(arr.max()) if arr.size else 0.0
    if max_val <= 0:
        return 1e-8
    hist, edges = np.histogram(arr, bins=num_bins, range=(0.0, max_val))
    hist = hist.astype(np.float64)
    stride = max(1, (num_bins - num_quantized_bins) // sweep)
    candidates = list(range(num_quantized_bins, num_bins + 1, stride))
    if candidates[-1] != num_bins:
        candidates.append(num_bins)
    best_div, best_th = float("inf"), max_val
    for i in candidates:
        th = edges[i]
        sliced = hist[:i].copy()
        # p keeps the clipped outlier mass in its edge bin; q is built from
        # the unclipped slice: the mismatch is what penalises clipping
        p = sliced.copy()
        p[-1] += hist[i:].sum()
        sm_p = _smooth_distribution(p)
        if sm_p is None:
            continue
        idx = np.minimum((np.arange(i) * num_quantized_bins) // i,
                         num_quantized_bins - 1)
        q_bins = np.zeros(num_quantized_bins)
        np.add.at(q_bins, idx, sliced)
        counts = np.zeros(num_quantized_bins)
        np.add.at(counts, idx, (sliced > 0).astype(np.float64))
        expand = np.zeros(i)
        mask = sliced > 0
        expand[mask] = q_bins[idx[mask]] / counts[idx[mask]]
        sm_q = _smooth_distribution(expand)
        if sm_q is None:
            continue
        div = _kl_divergence(sm_p, sm_q)
        if div < best_div:            # strict <: ties keep the smaller th
            best_div, best_th = div, float(th)
    return best_th


# ---------------------------------------------------------------------------
# Calibration collector (ref: _LayerOutputMinMaxCollector)
# ---------------------------------------------------------------------------

def _values(v) -> torch.Tensor:
    return v._data if isinstance(v, NDArray) else torch.as_tensor(v)


class CalibrationCollector(HybridBlock):
    """Transparent wrapper recording the input and output distribution of
    a layer: the input range picks the entry quantization scale, the
    output range the one ``requantize`` maps the int32 accumulator to."""

    def __init__(self, inner: Block, mode: str = "naive",
                 max_samples: Optional[int] = None):
        super().__init__()
        self._inner_block = inner
        self._mode = mode
        self.min_val = float("inf")
        self.max_val = float("-inf")
        self.out_min = float("inf")
        self.out_max = float("-inf")
        self._samples: List[np.ndarray] = []
        self._out_samples: List[np.ndarray] = []
        if max_samples is None:
            max_samples = int(os.environ.get("MXTPU_QUANT_CALIB_SAMPLES",
                                             "8"))
        self._max_samples = max_samples

    def _observe(self, v, samples):
        t = _values(v)
        lo, hi = (float(m) for m in torch.aminmax(t.detach()))
        if self._mode == "entropy" and len(samples) < self._max_samples:
            samples.append(t.detach().cpu().numpy())
        return lo, hi

    def forward(self, x, *args):
        lo, hi = self._observe(x, self._samples)
        self.min_val = min(self.min_val, lo)
        self.max_val = max(self.max_val, hi)
        out = self._inner_block(x, *args)
        lo, hi = self._observe(out, self._out_samples)
        self.out_min = min(self.out_min, lo)
        self.out_max = max(self.out_max, hi)
        return out

    def hybrid_forward(self, F, x, *args):
        return self.forward(x, *args)

    def threshold(self) -> float:
        if self._mode == "entropy" and self._samples:
            return _get_optimal_threshold(np.concatenate(
                [s.ravel() for s in self._samples]))
        return max(abs(self.min_val), abs(self.max_val))

    def out_threshold(self) -> float:
        if self._mode == "entropy" and self._out_samples:
            return _get_optimal_threshold(np.concatenate(
                [s.ravel() for s in self._out_samples]))
        return max(abs(self.out_min), abs(self.out_max))


# ---------------------------------------------------------------------------
# Quantized layer wrappers
# ---------------------------------------------------------------------------

def _apply_act(y, act_type: Optional[str]):
    if act_type is None:
        return y
    from ..ops.nn import activation
    return activation(y, act_type)


def _quantize_weight(w: np.ndarray):
    r = float(np.max(np.abs(w))) or 1e-8
    q = np.clip(np.round(w * (127.0 / r)), -127, 127).astype(np.int8)
    return q, r


def _int32_bias(bias: torch.Tensor, in_th: float, w_range: float):
    """fp32 bias -> int32 accumulator steps for the fused path: one int32
    unit is worth (in_range/127)*(w_range/127) real units (a float64 step,
    divided into the bias in float32 as the reference does). Clipped
    before the cast, which saturates, so a degenerate (epsilon-floored)
    step never pushes inf into int32."""
    step_o = (max(in_th, 1e-20) / qop.INT8_RANGE) * \
             (max(w_range, 1e-20) / qop.INT8_RANGE)
    q = torch.round(bias / torch.full((), np.float32(step_o),
                                      dtype=torch.float32,
                                      device=bias.device))
    q = torch.clamp(q, -2.0 ** 31, 2.0 ** 31)
    return torch.clamp(q.to(torch.float64), -2.0 ** 31,
                       2.0 ** 31 - 1).to(torch.int32)


def _register_quantized(block, source, wq):
    """``block``'s int8 ``qweight`` and float32 ``qbias`` parameters
    (``grad_req='null'``) on the device of ``source``'s weight. A conv's
    (O, C, kh, kw) weight is laid out channels-last, (O, kh, kw, C) in
    memory: the K-major, tap-by-tap operand of the conv kernel's Hopper
    route, made once here (same shape and bytes)."""
    ctx = source.weight.data().context
    with block.name_scope():
        block.qweight = block.params.get(
            "qweight", shape=wq.shape, dtype="int8", differentiable=False)
    w = _nd_array(wq, ctx=ctx)
    if wq.ndim == 4:
        w = from_torch(w._data.contiguous(memory_format=torch.channels_last))
    block.qweight._load_init(w)
    if getattr(source, "bias", None) is not None:
        b = source.bias.data().asnumpy()
        with block.name_scope():
            block.qbias = block.params.get(
                "qbias", shape=b.shape, dtype="float32",
                differentiable=False)
        block.qbias._load_init(_nd_array(b, ctx=ctx))
    else:
        block.qbias = None


def _boundary_input(x, th):
    """Quantize a float input at a stand-alone layer's boundary: with the
    calibrated threshold, or from the data (``th`` None)."""
    if th is None:
        return qop.quantize_v2(x)
    return qop.quantize(x, -th, th)


class QuantizedDense(HybridBlock):
    """int8 replacement for nn.Dense (ref: quantized_fully_connected.cc).

    The int8 weight and fp32 bias are registered parameters
    (``grad_req='null'``), so a captured serving forward reads them as
    static buffers, 4x smaller than the float32 weights, and
    ``collect_params`` sizes them (the ``mxtpu_serve_model_bytes``
    gauge)."""

    def __init__(self, dense: "_nn.Dense", input_threshold: Optional[float],
                 out_threshold: Optional[float] = None):
        super().__init__()
        self._units = dense._units
        self._flatten = dense._flatten
        self._act_type = dense._act_type
        wq, self._w_range = _quantize_weight(dense.weight.data().asnumpy())
        _register_quantized(self, dense, wq)
        self._input_th = input_threshold  # None -> dynamic quantization
        self._out_th = out_threshold

    def _inputs(self, x):
        inputs = [x, self.qweight.data()]
        if self.qbias is not None:
            inputs.append(self.qbias.data())
        return inputs

    # ---- float-boundary mode (stand-alone substitution) ----
    def forward(self, x):
        w_r, th, flatten = self._w_range, self._input_th, self._flatten
        act = self._act_type

        def fn(xv, wv, bv=None):
            if flatten and xv.dim() > 2:
                xv = xv.reshape(xv.shape[0], -1)
            xq, mn, mx = _boundary_input(xv, th)
            y32, mo, Mo = qop.quantized_fully_connected(
                xq, wv, mn, mx, -w_r, w_r)
            y = qop.dequantize_int32(y32, mo, Mo)
            if bv is not None:
                y = y + bv
            return _apply_act(y, act)
        return invoke(fn, self._inputs(x), "QuantizedDense")

    # ---- int8-domain mode (requantize-fused chain member) ----
    def quantized_forward(self, q, mn: float, mx: float):
        w_r, out_th, act, flatten = (self._w_range, self._out_th,
                                     self._act_type, self._flatten)
        in_th = max(abs(mn), abs(mx))

        def fn(qv, wv, bv=None):
            if flatten and qv.dim() > 2:
                qv = qv.reshape(qv.shape[0], -1)
            b32 = None if bv is None else _int32_bias(bv, in_th, w_r)
            return qop.quantized_fully_connected_requantize(
                qv, wv, mn, mx, -w_r, w_r, -out_th, out_th, b32,
                relu=act == "relu")[0]
        return (invoke(fn, self._inputs(q), "QuantizedDense.int8"),
                -out_th, out_th)

    def hybrid_forward(self, F, x, *args, **kwargs):
        return self.forward(x)


class QuantizedConv2D(HybridBlock):
    """int8 replacement for nn.Conv2D, NCHW (ref: quantized_conv.cc)."""

    def __init__(self, conv, input_threshold: Optional[float],
                 out_threshold: Optional[float] = None):
        super().__init__()
        kw = conv._kwargs
        self._stride = tuple(kw["stride"])
        self._pad = tuple(kw["pad"])
        self._dilate = tuple(kw["dilate"])
        self._groups = kw["num_group"]
        self._act_type = conv._act_type
        wq, self._w_range = _quantize_weight(conv.weight.data().asnumpy())
        _register_quantized(self, conv, wq)
        self._input_th = input_threshold
        self._out_th = out_threshold

    _inputs = QuantizedDense._inputs

    def _geometry(self):
        return dict(stride=self._stride, pad=self._pad, dilate=self._dilate,
                    groups=self._groups)

    def forward(self, x):
        w_r, th, act = self._w_range, self._input_th, self._act_type

        def fn(xv, wv, bv=None):
            xq, mn, mx = _boundary_input(xv, th)
            y32, mo, Mo = qop.quantized_conv(xq, wv, mn, mx, -w_r, w_r,
                                             **self._geometry())
            y = qop.dequantize_int32(y32, mo, Mo)
            if bv is not None:
                y = y + bv.reshape(1, -1, 1, 1)
            return _apply_act(y, act)
        return invoke(fn, self._inputs(x), "QuantizedConv2D")

    def quantized_forward(self, q, mn: float, mx: float):
        w_r, out_th, act = self._w_range, self._out_th, self._act_type
        in_th = max(abs(mn), abs(mx))

        def fn(qv, wv, bv=None):
            b32 = None if bv is None else _int32_bias(bv, in_th, w_r)
            return qop.quantized_conv_requantize(
                qv, wv, mn, mx, -w_r, w_r, -out_th, out_th, b32,
                relu=act == "relu", **self._geometry())[0]
        return (invoke(fn, self._inputs(q), "QuantizedConv2D.int8"),
                -out_th, out_th)

    def hybrid_forward(self, F, x, *args, **kwargs):
        return self.forward(x)


class QuantizedPooling(HybridBlock):
    """int8-domain pooling chain stage (ref: quantized_pooling.cc): max
    pooling is exact on int8 codes; avg divides the int32 window sum by
    the window area (floor). Ranges pass through unchanged."""

    def __init__(self, pool: "_PoolingBase"):
        super().__init__()
        kw = pool._kwargs
        self._pool_kwargs = dict(kw)        # float-fallback F.Pooling args
        self._kernel = tuple(kw["kernel"])
        self._stride = tuple(kw["stride"])
        self._pad = tuple(kw["pad"])
        self._pool_type = kw["pool_type"]
        self._global_pool = bool(kw.get("global_pool", False))

    def quantized_forward(self, q, mn: float, mx: float):
        def fn(qv):
            return qop.quantized_pooling(
                qv, mn, mx, kernel=self._kernel, pool_type=self._pool_type,
                stride=self._stride, pad=self._pad,
                global_pool=self._global_pool)[0]
        return invoke(fn, [q], "QuantizedPooling.int8"), mn, mx

    def hybrid_forward(self, F, x, *args, **kwargs):  # float fallback
        return F.Pooling(x, **self._pool_kwargs)


class QuantizedActivation(HybridBlock):
    """int8-domain ReLU chain stage: with a symmetric (positive) scale,
    ``max(q, 0)`` is exactly relu of the real values."""

    def quantized_forward(self, q, mn: float, mx: float):
        return (invoke(lambda qv: torch.clamp_min(qv, 0), [q],
                       "QuantizedActivation.int8"), mn, mx)

    def hybrid_forward(self, F, x, *args, **kwargs):
        return F.Activation(x, act_type="relu")


class QuantizedFlatten(HybridBlock):
    """int8-domain flatten chain stage (ref: quantized_flatten.cc)."""

    def quantized_forward(self, q, mn: float, mx: float):
        return (invoke(lambda qv: qv.reshape(qv.shape[0], -1), [q],
                       "QuantizedFlatten.int8"), mn, mx)

    def hybrid_forward(self, F, x, *args, **kwargs):
        return F.flatten(x)


class QuantizedChain(HybridBlock):
    """A maximal run of int8-domain stages under requantize fusion.

    ``forward`` quantizes the float input once (the first layer's
    calibrated input range), threads the (int8 codes, range) pair through
    every stage — conv/matmul stages requantize their int32 accumulator to
    their calibrated output range, pass-through stages keep the range —
    and dequantizes once at exit. The stages are the chain's children, so
    ``collect_params`` (and the serving capture) sees their int8 weights
    as ordinary parameters."""

    def __init__(self, stages, entry_threshold: float):
        super().__init__()
        self._entry_th = float(entry_threshold)
        self._stages = list(stages)
        for i, s in enumerate(self._stages):
            self.register_child(s, str(i))

    def forward(self, x):
        th = self._entry_th
        q = invoke(lambda xv: qop.quantize(xv, -th, th)[0], [x],
                   "QuantizedChain.entry")
        mn, mx = -th, th
        for s in self._stages:
            q, mn, mx = s.quantized_forward(q, mn, mx)
        return invoke(lambda qv: qop.dequantize(qv, mn, mx), [q],
                      "QuantizedChain.exit")

    def hybrid_forward(self, F, x, *args, **kwargs):
        return self.forward(x)

    def __repr__(self):
        inner = ", ".join(type(s).__name__ for s in self._stages)
        return f"QuantizedChain({len(self._stages)} stages: {inner})"


# ---------------------------------------------------------------------------
# BatchNorm folding (the standard inference-graph fold)
# ---------------------------------------------------------------------------

class _FoldedIdentity(HybridBlock):
    """Pass-through left in place of a folded BatchNorm, so sibling
    indices (and therefore calibration/threshold paths) stay stable."""

    def forward(self, x, *args):
        return x

    def hybrid_forward(self, F, x, *args, **kwargs):
        return x

    def __repr__(self):
        return "FoldedBatchNorm(identity)"


def fold_batchnorm(net: Block) -> Block:
    """Fold inference-mode BatchNorm into the preceding Conv2D, in place
    (ref: quantize_graph_pass.cc's conv+BN fusion). Only adjacent (Conv2D,
    BatchNorm) children of a ``HybridSequential`` are folded:

    w'[o,...] = w[o,...] * gamma[o]/sqrt(var[o]+eps)
    b'[o]     = beta[o] + (b[o] - mean[o]) * gamma[o]/sqrt(var[o]+eps)

    The per-channel BN scale lands in the conv weight ahead of weight
    quantization; the folded BN slot becomes a pass-through marker
    (chain-eligible, index-stable)."""
    if isinstance(net, HybridBlock):
        net.hybridize(active=False)   # drop graphs that read old weights
    folded = [0]

    def _walk(block):
        for child in block._children.values():
            _walk(child)
        if not isinstance(block, _nn.HybridSequential):
            return
        items = list(block._children.items())
        for (n1, c1), (n2, c2) in zip(items, items[1:]):
            if not (isinstance(c1, _nn.Conv2D)
                    and isinstance(c2, _nn.BatchNorm)):
                continue
            if c1._act_type is not None:   # act between conv and BN
                continue
            gamma = c2.gamma.data().asnumpy().astype(np.float64)
            beta = c2.beta.data().asnumpy().astype(np.float64)
            mean = c2.running_mean.data().asnumpy().astype(np.float64)
            var = c2.running_var.data().asnumpy().astype(np.float64)
            w = c1.weight.data().asnumpy()
            if w.shape[0] != gamma.shape[0]:   # BN not on the out-channel
                continue
            ctx = c1.weight.data().context
            scale = gamma / np.sqrt(var + c2._epsilon)
            w2 = (w.astype(np.float64)
                  * scale.reshape((-1,) + (1,) * (w.ndim - 1)))
            b0 = (c1.bias.data().asnumpy().astype(np.float64)
                  if c1.bias is not None else 0.0)
            b2 = beta + (b0 - mean) * scale
            c1.weight.set_data(_nd_array(w2.astype(np.float32), ctx=ctx))
            if c1.bias is None:
                with c1.name_scope():
                    c1.bias = c1.params.get(
                        "bias", shape=(w.shape[0],), dtype="float32",
                        init="zeros")
                c1.bias._load_init(_nd_array(b2.astype(np.float32),
                                             ctx=ctx))
                c1._kwargs["no_bias"] = False
            else:
                c1.bias.set_data(_nd_array(b2.astype(np.float32), ctx=ctx))
            block._children[n2] = _FoldedIdentity()
            folded[0] += 1

    _walk(net)
    logging.getLogger(__name__).debug("fold_batchnorm: folded %d BN layers",
                                      folded[0])
    return net


# ---------------------------------------------------------------------------
# Network conversion (ref: quantize_model / quantize_graph_pass.cc)
# ---------------------------------------------------------------------------

def _targets():
    return (_nn.Dense, _nn.Conv2D)


def _eligible_leaf(child) -> bool:
    if isinstance(child, _nn.Dense):
        return True
    if isinstance(child, _nn.Conv2D):
        # quantized_conv is NCHW; NHWC convs stay fp32
        return child._kwargs.get("layout", "NCHW") == "NCHW"
    return False


def _walk_substitute(block: Block, fn, exclude, prefix=""):
    for name, child in list(block._children.items()):
        path = f"{prefix}{name}"
        if isinstance(child, _targets()) and _eligible_leaf(child) \
                and path not in (exclude or ()):
            repl = fn(path, child)
            if repl is not None:
                block._children[name] = repl
                if block.__dict__.get(name) is child:
                    block.__dict__[name] = repl
        else:
            _walk_substitute(child, fn, exclude, prefix=path + ".")


def _pool_chainable(p) -> bool:
    kw = p._kwargs
    if kw.get("layout", "NCHW") != "NCHW":
        return False
    if kw.get("global_pool", False):
        return True
    if kw.get("pooling_convention") != "valid":
        return False
    if kw["pool_type"] == "avg" and tuple(kw["pad"]) != (0, 0):
        return False
    return kw["pool_type"] in ("max", "avg")


def _chain_stage(child):
    """The int8-domain stage for a chain member, or None if the member
    cannot live inside a fused run."""
    if isinstance(child, (QuantizedDense, QuantizedConv2D)):
        if child._out_th is None or child._act_type not in (None, "relu"):
            return None
        return child
    if isinstance(child, _nn.Activation) and child._act_type == "relu":
        return QuantizedActivation()
    if isinstance(child, _PoolingBase) and _pool_chainable(child):
        return QuantizedPooling(child)
    if isinstance(child, _nn.Flatten):
        return QuantizedFlatten()
    if isinstance(child, _FoldedIdentity):
        return child          # pass-through, re-used as-is
    return None


def _fuse_sequentials(block: Block):
    """Collapse maximal runs of chain-eligible children of every
    HybridSequential (bottom-up) into QuantizedChain blocks. A run must
    start with a quantized matmul/conv (its calibrated input range is the
    chain's entry scale) and hold at least two quantized layers: a lone
    one plus pass-throughs keeps its (equal-boundary-count) wrapper."""
    for child in block._children.values():
        _fuse_sequentials(child)
    if not isinstance(block, _nn.HybridSequential):
        return
    items = list(block._children.items())
    out: List[Block] = []
    i = 0
    while i < len(items):
        child = items[i][1]
        if (isinstance(child, (QuantizedDense, QuantizedConv2D))
                and child._input_th is not None
                and _chain_stage(child) is not None):
            stages = [child]
            j = i + 1
            while j < len(items):
                st = _chain_stage(items[j][1])
                if st is None:
                    break
                stages.append(st)
                j += 1
            n_mm = sum(isinstance(s, (QuantizedDense, QuantizedConv2D))
                       for s in stages)
            if n_mm >= 2:
                out.append(QuantizedChain(
                    [s for s in stages
                     if not isinstance(s, _FoldedIdentity)],
                    entry_threshold=child._input_th))
                i = j
                continue
        out.append(child)
        i += 1
    if len(out) != len(items):
        block._children.clear()
        for k, c in enumerate(out):
            block._children[str(k)] = c


def get_thresholds(net: Block) -> Dict[str, Dict[str, float]]:
    """The calibrated thresholds captured by the last ``quantize_net`` on
    this net: ``{layer_path: {"in": th, "out": th}}`` — plain floats,
    JSON-serializable, accepted back by ``quantize_net(...,
    thresholds=...)``."""
    th = getattr(net, "_quant_thresholds", None)
    if th is None:
        raise ValueError("net has no calibrated thresholds — run "
                         "quantize_net(net, calib_data=...) first")
    return {k: dict(v) for k, v in th.items()}


def _publish_thresholds(thresholds) -> None:
    from .. import telemetry as _telemetry
    g = _telemetry.gauge("mxtpu_quant_threshold",
                         "Calibrated |threshold| per quantized layer.")
    for path, th in thresholds.items():
        if th.get("in") is not None:
            g.set(float(th["in"]), layer=path, kind="in")
        if th.get("out") is not None:
            g.set(float(th["out"]), layer=path, kind="out")


def quantize_net(net: Block, calib_data=None, calib_mode: str = "naive",
                 quantized_dtype: str = "int8", exclude=None,
                 num_calib_batches: int = 4, logger=None,
                 fuse: Optional[bool] = None,
                 thresholds: Optional[Dict[str, Dict[str, float]]] = None):
    """Convert a trained Gluon net to int8 inference, in place (ref:
    python/mxnet/contrib/quantization.py:quantize_model).

    calib_mode: 'none' -> dynamic per-batch input ranges (no fusion: the
    requantize scale needs a calibrated output range, and dynamic ranges
    see the padding rows of a serving bucket); 'naive' -> min/max over the
    calibration batches; 'entropy' -> KL-optimal thresholds. calib_data:
    an iterable of input NDArrays (or batches whose first element is the
    input). fuse (default env MXTPU_QUANT_FUSE, on): collapse eligible runs
    into requantize-fused ``QuantizedChain``s. thresholds: a previous
    ``get_thresholds`` dict; skips calibration."""
    assert quantized_dtype == "int8", "only int8 is supported"
    assert calib_mode in ("none", "naive", "entropy")
    log = logger or logging.getLogger(__name__)
    if fuse is None:
        fuse = _fuse_default()
    # drop captured forwards: the collectors must see eager values, and a
    # stale graph would keep replaying the float32 forward
    net.hybridize(active=False)

    if thresholds is not None:
        thresholds = {k: dict(v) for k, v in thresholds.items()}
    elif calib_mode != "none":
        if calib_data is None:
            raise ValueError(f"calib_mode={calib_mode} requires calib_data")
        collectors: Dict[str, CalibrationCollector] = {}

        def _wrap_collector(path, child):
            c = CalibrationCollector(child, mode=calib_mode)
            collectors[path] = c
            return c

        _walk_substitute(net, _wrap_collector, exclude)
        for i, batch in enumerate(calib_data):
            if i >= num_calib_batches:
                break
            x = batch[0] if isinstance(batch, (tuple, list)) else batch
            net(x)
        thresholds = {}
        for path, c in collectors.items():
            thresholds[path] = {"in": c.threshold(),
                                "out": c.out_threshold()}
            log.debug("calibrated %s: in=%.6f out=%.6f", path,
                      thresholds[path]["in"], thresholds[path]["out"])

        def _restore(block):
            for name, child in list(block._children.items()):
                if isinstance(child, CalibrationCollector):
                    block._children[name] = child._inner_block
                    if block.__dict__.get(name) is child:
                        block.__dict__[name] = child._inner_block
                else:
                    _restore(child)
        _restore(net)
    else:
        thresholds = {}

    _publish_thresholds(thresholds)

    def _to_quantized(path, child):
        th = thresholds.get(path)  # None under calib_mode='none'
        in_th = th["in"] if th else None
        out_th = th.get("out") if th else None
        if isinstance(child, _nn.Conv2D):
            return QuantizedConv2D(child, in_th, out_th)
        return QuantizedDense(child, in_th, out_th)

    _walk_substitute(net, _to_quantized, exclude)
    if fuse:
        _fuse_sequentials(net)
    net._quant_thresholds = thresholds
    return net
