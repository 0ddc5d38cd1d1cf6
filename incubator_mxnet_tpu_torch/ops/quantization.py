"""INT8 quantization ops in PyTorch.

Counterpart of the reference's ``ops/quantization.py`` (ref:
src/operator/quantization/: quantize-inl.h, dequantize-inl.h,
requantize-inl.h, quantized_fully_connected.cc, quantized_conv.cc,
quantized_pooling.cc, quantized_flatten.cc, quantized_concat.cc; range
math quantization_utils.h:80-114), with the same convention: symmetric
int8, ``real_range = max(|min|, |max|)``, ``scale = 127 / real_range``,
``q = round(clip(x * scale, -127, 127))``; a quantized tensor travels as
``(q, min_range, max_range)``, and an int32 accumulator carries the
product range ``real_a / 127 * real_b / 127`` a unit.

The int8 products run on the hand-written tensor-core kernels of
``ops/cuda/quantized.py`` (``qconv_s8``, ``qgemm_s8``) for CUDA tensors
and on their plain twins for CPU tensors; every other op is plain
PyTorch. ``quantized_conv_requantize`` and
``quantized_fully_connected_requantize`` are the port's fused forms of
the reference's chain member (product, int32 bias, ReLU, requantize to a
calibrated range): the kernels' epilogue (b).

4-D codes are carried in ``torch.channels_last`` memory: ``quantize``
makes them so, the conv kernel reads and writes them so, and every op
after it is elementwise or pooling, which keep the layout. Shapes stay
the reference's (N, C, H, W).

Ranges are Python (or numpy) floats — calibrated thresholds — or 0-d
tensors (``quantize_v2`` and ``requantize`` without a range compute them
from the data). Range arithmetic is float32 throughout, as the
reference's weak-typed scalars are: host numbers on the host with numpy
float32 (and results returned as Python floats), tensors with tensor ops.
No op reads a tensor range back to the host, so a forward over dynamic
ranges can be captured in a CUDA graph. Constants that meet a tensor are
made by fills, and every division is tensor by tensor (PyTorch's CUDA
division by a Python scalar multiplies by its reciprocal, which rounds
otherwise).

``op_counts`` reads the build-time counters
``mxtpu_quant_{quantize,dequantize,requantize}_ops_total``: one count a
Python-level call (under a CUDA graph, the capture's call; replays move
nothing).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .cuda import quantized as _qk

__all__ = [
    "quantize", "quantize_v2", "dequantize", "requantize",
    "quantized_fully_connected", "quantized_conv", "quantized_pooling",
    "quantized_flatten", "quantized_concat", "op_counts",
    "dequantize_int32", "quantized_conv_requantize",
    "quantized_fully_connected_requantize", "requant_epilogue",
]

INT8_RANGE = 127.0
INT32_RANGE = float(2 ** 31 - 1)
_EPS = 1e-20


def _count(kind: str) -> None:
    """Count a float<->int8 edge op at build time (each Python-level
    call): the requantize-fusion gates read these to show that a fused
    chain crosses the float boundary exactly twice."""
    from .. import telemetry as _telemetry
    _telemetry.counter(
        "mxtpu_quant_%s_ops_total" % kind,
        "float<->int8 edge ops recorded at graph-build time.").inc(1)


def op_counts():
    """Snapshot of the (quantize, dequantize, requantize) build-time op
    counters."""
    from .. import telemetry as _telemetry
    return tuple(int(_telemetry.counter(
        "mxtpu_quant_%s_ops_total" % k).value())
        for k in ("quantize", "dequantize", "requantize"))


# ----------------------------------------------------------- range scalars
def _tensor(v):
    """The tensor of an NDArray, or ``v`` itself."""
    return getattr(v, "_data", v) if not isinstance(v, torch.Tensor) else v


def _scalars(values, like: torch.Tensor):
    """``values`` as float32 range scalars of one kind: numpy float32 when
    every one is a host number, else 0-d float32 tensors on ``like``'s
    device (host numbers made by fills)."""
    vals = [_tensor(v) for v in values]
    if not any(isinstance(v, torch.Tensor) for v in vals):
        return [np.float32(v) for v in vals]
    return [v.to(torch.float32).reshape(()) if isinstance(v, torch.Tensor)
            else torch.full((), np.float32(v), dtype=torch.float32,
                            device=like.device) for v in vals]


def _const(v, kind):
    """The float32 constant ``v`` of ``kind``'s sort (numpy or tensor)."""
    if isinstance(kind, torch.Tensor):
        return torch.full((), np.float32(v), dtype=torch.float32,
                          device=kind.device)
    return np.float32(v)


def _maximum(a, b):
    if isinstance(a, torch.Tensor):
        return torch.maximum(a, b)
    return np.maximum(a, b)


def _floor(r):
    if isinstance(r, torch.Tensor):
        return torch.clamp_min(r, _EPS)
    return np.maximum(r, np.float32(_EPS))


def _out(v):
    """A range as it is returned: a Python float, or the 0-d tensor."""
    return v if isinstance(v, torch.Tensor) else float(v)


def _rr(mn, mx):
    """``max(|min|, |max|)`` floored at 1e-20 (the reference's
    ``_real_range``): an all-zero tensor must quantize to zeros, not NaN."""
    return _floor(_maximum(abs(mn), abs(mx)))


def _mul(x: torch.Tensor, s):
    """x (float32) times the float32 scalar ``s``."""
    return x * (s if isinstance(s, torch.Tensor) else float(s))


def _where_pos(raw, q: torch.Tensor) -> torch.Tensor:
    """``q`` where the raw range is positive, zeros where it is 0."""
    if isinstance(raw, torch.Tensor):
        return torch.where(raw > 0, q, torch.zeros_like(q))
    return q if raw > 0 else torch.zeros_like(q)


# --------------------------------------------------------------------- ops
def quantize(data, min_range, max_range, out_type: str = "int8"):
    """fp32 -> int8 with a given calibration range (ref: quantize-inl.h).

    Returns (q, out_min, out_max), the symmetric real range actually
    representable. A degenerate range (threshold 0: the layer only ever
    saw zeros) quantizes everything to zero."""
    assert out_type == "int8", "only int8 is supported"
    _count("quantize")
    x = _tensor(data)
    mn, mx = _scalars((min_range, max_range), x)
    raw = _maximum(abs(mn), abs(mx))
    r = _floor(raw)
    scale = _const(INT8_RANGE, r) / r
    q = torch.clamp(torch.round(_mul(x, scale)), -INT8_RANGE, INT8_RANGE)
    q = _where_pos(raw, q).to(torch.int8)
    if q.dim() == 4:         # the layout the conv kernels read and write
        q = q.contiguous(memory_format=torch.channels_last)
    return q, _out(-r), _out(r)


def quantize_v2(data, min_calib_range: Optional[float] = None,
                max_calib_range: Optional[float] = None,
                out_type: str = "int8"):
    """Quantize with the range taken from the data when not calibrated
    (ref: quantize_v2-inl.h): 0-d tensors, never read on the host."""
    if min_calib_range is None or max_calib_range is None:
        x = _tensor(data)
        min_calib_range, max_calib_range = x.min(), x.max()
    return quantize(data, min_calib_range, max_calib_range, out_type)


def dequantize(qdata, min_range, max_range, out_type: str = "float32"):
    """int8 -> fp32 (ref: dequantize-inl.h)."""
    _count("dequantize")
    q = _tensor(qdata)
    mn, mx = _scalars((min_range, max_range), q)
    r = _rr(mn, mx)
    return _mul(q.to(torch.float32), r / _const(INT8_RANGE, r))


def dequantize_int32(qdata32, min_range, max_range):
    """int32 accumulator -> fp32 directly (the float-boundary epilogue of a
    stand-alone quantized layer); min/max_range is the carried product
    range."""
    _count("dequantize")
    q = _tensor(qdata32)
    mn, mx = _scalars((min_range, max_range), q)
    r = _rr(mn, mx)
    return _mul(q.to(torch.float32), r / _const(INT32_RANGE, r))


def _requant_step(mn, mx):
    """The real value of one int32 unit of the carried product range."""
    return _rr(mn, mx) / _const(INT32_RANGE, mn)


def requantize(qdata32, min_range, max_range,
               min_calib_range: Optional[float] = None,
               max_calib_range: Optional[float] = None):
    """int32 accumulator -> int8 (ref: requantize-inl.h): real values
    ``float(q) * step``, then ``* (127 / cal)`` with the calibrated range
    (or the largest magnitude when there is none); a zero calibrated range
    maps everything to 0."""
    _count("requantize")
    q32 = _tensor(qdata32)
    mn, mx = _scalars((min_range, max_range), q32)
    real = _mul(q32.to(torch.float32), _requant_step(mn, mx))
    if min_calib_range is None or max_calib_range is None:
        cal_raw = real.abs().amax()
    else:
        cmn, cmx = _scalars((min_calib_range, max_calib_range), q32)
        cal_raw = _maximum(abs(cmn), abs(cmx))
    cal = _floor(cal_raw)
    q = torch.clamp(torch.round(_mul(real, _const(INT8_RANGE, cal) / cal)),
                    -INT8_RANGE, INT8_RANGE)
    q = _where_pos(cal_raw, q)
    return q.to(torch.int8), _out(-cal), _out(cal)


def _mul_range(min_a, max_a, min_b, max_b, like=None):
    """Real range carried by an int32 product of two int8 tensors (ref:
    quantization_utils.h QuantizationRangeForMultiplication)."""
    a0, a1, b0, b1 = _scalars((min_a, max_a, min_b, max_b), like)
    c127 = _const(INT8_RANGE, a0)
    step = (_rr(a0, a1) / c127) * (_rr(b0, b1) / c127)
    r = step * _const(INT32_RANGE, a0)
    return _out(-r), _out(r)


def requant_epilogue(min_o, max_o, min_calib, max_calib,
                     bias32: Optional[torch.Tensor] = None,
                     relu: bool = False) -> _qk.Requant:
    """The kernels' epilogue (b) for an accumulator of carried range
    (min_o, max_o) requantized to the calibrated (min_calib, max_calib):
    ``step`` and ``127 / cal`` in float32, as :func:`requantize` computes
    them. Every range must be a host number (a calibrated chain's)."""
    vals = (min_o, max_o, min_calib, max_calib)
    if any(isinstance(_tensor(v), torch.Tensor) for v in vals):
        raise TypeError("requant_epilogue: the fused epilogue takes "
                        "calibrated (host) ranges only")
    mn, mx, cmn, cmx = (np.float32(v) for v in vals)
    step = _requant_step(mn, mx)
    cal_raw = np.maximum(abs(cmn), abs(cmx))
    cal = _floor(cal_raw)
    return _qk.Requant(bias32, bool(relu), float(step),
                       float(np.float32(INT8_RANGE) / cal),
                       not cal_raw > 0)


def _gemm(xq: torch.Tensor, wq: torch.Tensor, epi=None) -> torch.Tensor:
    """xq (..., K) by wq (units, K): the kernel or, on the CPU, its twin."""
    lead = xq.shape[:-1]
    x2 = xq.reshape(-1, xq.shape[-1]).contiguous()
    if xq.is_cuda:
        y = _qk.qgemm_s8(x2, wq.contiguous(), epi)
    else:
        y = _qk.qgemm_s8_reference(x2, wq, epi)
    return y.reshape(*lead, y.shape[-1])


def _conv(xq, wq, stride, pad, dilate, groups, epi=None):
    """xq by wq as they are laid out: the kernel (which reads
    channels-last codes on its Hopper route) or, on the CPU, its twin."""
    args = (tuple(stride), tuple(pad), tuple(dilate), int(groups), epi)
    if xq.is_cuda:
        return _qk.qconv_s8(xq, wq, *args)
    return _qk.qconv_s8_reference(xq, wq, *args)


def quantized_fully_connected(xq, wq, min_x, max_x, min_w, max_w,
                              bias_q=None, min_b=None, max_b=None):
    """int8 x int8 -> int32 dense (ref: quantized_fully_connected.cc).

    xq: (N, K) int8; wq: (units, K) int8 (the reference's weight layout).
    Returns (y_int32, min_out, max_out)."""
    xq, wq = _tensor(xq), _tensor(wq)
    y = _gemm(xq, wq)
    min_o, max_o = _mul_range(min_x, max_x, min_w, max_w, xq)
    if bias_q is not None:
        bq = _tensor(bias_q)
        o0, o1, b0, b1 = _scalars((min_o, max_o, min_b, max_b), xq)
        step_o = _rr(o0, o1) / _const(INT32_RANGE, o0)
        step_b = _rr(b0, b1) / _const(INT8_RANGE, o0)
        y = y + torch.round(_mul(bq.to(torch.float32),
                                 step_b / step_o)).to(torch.int32)
    return y, min_o, max_o


def quantized_conv(xq, wq, min_x, max_x, min_w, max_w,
                   stride=(1, 1), pad=(0, 0), dilate=(1, 1),
                   groups: int = 1):
    """int8 NCHW conv -> int32 (ref: quantized_conv.cc)."""
    xq, wq = _tensor(xq), _tensor(wq)
    y = _conv(xq, wq, stride, pad, dilate, groups)
    min_o, max_o = _mul_range(min_x, max_x, min_w, max_w, xq)
    return y, min_o, max_o


def _fused_epilogue(min_x, max_x, min_w, max_w, min_calib, max_calib,
                    bias32, relu):
    """The fused step's epilogue and returned range (counted as one
    requantize)."""
    _count("requantize")
    min_o, max_o = _mul_range(min_x, max_x, min_w, max_w)
    epi = requant_epilogue(min_o, max_o, min_calib, max_calib, bias32, relu)
    cal = float(_floor(np.maximum(abs(np.float32(min_calib)),
                                  abs(np.float32(max_calib)))))
    return epi, -cal, cal


def quantized_fully_connected_requantize(xq, wq, min_x, max_x, min_w, max_w,
                                         min_calib, max_calib, bias32=None,
                                         relu: bool = False):
    """The chain member's dense step in one kernel: the int8 product, the
    int32 bias, ReLU on the accumulator and ``requantize`` to the
    calibrated range. Returns the int8 codes and the calibrated range."""
    epi, lo, hi = _fused_epilogue(min_x, max_x, min_w, max_w, min_calib,
                                  max_calib, bias32, relu)
    return _gemm(_tensor(xq), _tensor(wq), epi), lo, hi


def quantized_conv_requantize(xq, wq, min_x, max_x, min_w, max_w,
                              min_calib, max_calib, bias32=None,
                              relu: bool = False, stride=(1, 1),
                              pad=(0, 0), dilate=(1, 1), groups: int = 1):
    """The chain member's conv step in one kernel (see
    :func:`quantized_fully_connected_requantize`)."""
    epi, lo, hi = _fused_epilogue(min_x, max_x, min_w, max_w, min_calib,
                                  max_calib, bias32, relu)
    return (_conv(_tensor(xq), _tensor(wq), stride, pad, dilate, groups,
                  epi), lo, hi)


def quantized_pooling(qdata, min_range, max_range, kernel=(2, 2),
                      pool_type: str = "max", stride=None, pad=(0, 0),
                      global_pool: bool = False):
    """Pooling directly on int8 (ref: quantized_pooling.cc); ranges pass
    through unchanged. Max pooling runs on the codes as float32 (exact;
    a padded position never wins over a code >= -127); average pooling is
    the int32 window sum with zero padding, floor-divided by the window
    area as the reference does (not a rounded mean)."""
    q = _tensor(qdata)
    if stride is None:
        stride = kernel
    n, c, h, w = q.shape
    if global_pool:
        kernel, stride, pad = (h, w), (1, 1), (0, 0)
    kernel, stride, pad = tuple(kernel), tuple(stride), tuple(pad)
    if pool_type == "max":
        out = F.max_pool2d(q.to(torch.float32), kernel, stride, pad)
    elif pool_type == "avg":
        s = F.avg_pool2d(q.to(torch.float64), kernel, stride, pad,
                         count_include_pad=True, divisor_override=1)
        out = torch.div(torch.round(s).to(torch.int32),
                        kernel[0] * kernel[1], rounding_mode="floor")
    else:
        raise ValueError(f"unsupported quantized pool_type {pool_type}")
    return out.to(torch.int8), min_range, max_range


def quantized_flatten(qdata, min_range, max_range):
    """(ref: quantized_flatten.cc)."""
    q = _tensor(qdata)
    return q.reshape(q.shape[0], -1), min_range, max_range


def quantized_concat(qdatas, mins, maxs, dim: int = 1):
    """Concat int8 tensors after rescaling to a common range
    (ref: quantized_concat.cc)."""
    qs = [_tensor(q) for q in qdatas]
    sc = _scalars(list(mins) + list(maxs), qs[0])
    k = len(qs)
    rs = [_rr(mn, mx) for mn, mx in zip(sc[:k], sc[k:])]
    out_r = torch.stack(rs).amax() if isinstance(rs[0], torch.Tensor) \
        else np.max(np.stack(rs))
    parts = [torch.clamp(torch.round(_mul(q.to(torch.float32), ri / out_r)),
                         -INT8_RANGE, INT8_RANGE).to(torch.int8)
             for q, ri in zip(qs, rs)]
    return torch.cat(parts, dim=dim), _out(-out_r), _out(out_r)
