"""int8 x int8 -> int32 products on the int8 tensor cores: the CUDA kernels
``qconv_s8`` and ``qgemm_s8`` (``csrc/quantized.cu``), their plain PyTorch
twins, and the requantize epilogue they share.

They replace no Pallas kernel: the reference computes
``ops/quantization.py``'s ``quantized_conv`` and
``quantized_fully_connected`` with ``lax.conv_general_dilated`` and
``lax.dot_general`` at an int32 result type, the MXU's int8 mode. PyTorch
has no int8 convolution on CUDA, so both are hand-written here.

* ``qconv_s8_reference`` / ``qgemm_s8_reference`` — plain twins: the
  product in float64 of the int8 values (exact while every sum stays under
  2^53 in magnitude), rounded to int32, then the same epilogue;
* ``Requant`` — epilogue (b) of a requantize-fused chain member: an int32
  bias, ReLU on the accumulator, then ``float(y) * step`` and ``* s127``
  as two float32 multiplies, half-to-even rounding, a clamp to +-127, and
  zeros for a zero calibrated range (``zero``). Without one the kernels
  write the raw int32 accumulator (epilogue (a)).

CUDA tensors go through the kernels, CPU tensors through the twins (the
callers in ``ops/quantization.py`` choose by device); a kernel wrapper
given anything it cannot take raises.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from .common import (check_launch, counted_kernel, current_stream_handle,
                     kernel_library)

__all__ = ["Requant", "qconv_s8", "qgemm_s8", "qconv_s8_reference",
           "qgemm_s8_reference", "requantize_reference", "conv_out_hw"]


class Requant(NamedTuple):
    """Epilogue (b): ``bias`` an int32 (O,) tensor or None; ``step`` and
    ``s127`` float32 values (as Python floats); ``zero`` True when the
    calibrated range is 0 (every code 0)."""

    bias: Optional[torch.Tensor]
    relu: bool
    step: float
    s127: float
    zero: bool


def conv_out_hw(h, w, kernel, stride, pad, dilate):
    """Output height and width of a convolution (floor mode)."""
    ho = (h + 2 * pad[0] - dilate[0] * (kernel[0] - 1) - 1) // stride[0] + 1
    wo = (w + 2 * pad[1] - dilate[1] * (kernel[1] - 1) - 1) // stride[1] + 1
    return ho, wo


def requantize_reference(acc, epi: Optional[Requant], channel_dim: int = 1):
    """Plain twin of the kernels' epilogues: ``acc`` (int32) as it is
    without ``epi``, else its int8 codes."""
    if epi is None:
        return acc
    if epi.bias is not None:
        shape = [1] * acc.dim()
        shape[channel_dim] = -1
        acc = acc + epi.bias.to(torch.int32).reshape(shape)
    if epi.relu:
        acc = torch.clamp_min(acc, 0)
    if epi.zero:
        return torch.zeros(acc.shape, dtype=torch.int8, device=acc.device)
    f = torch.round((acc.to(torch.float32) * epi.step) * epi.s127)
    return torch.clamp(f, -127.0, 127.0).to(torch.int8)


def _to_int32(acc64):
    return torch.round(acc64).to(torch.int32)


def qconv_s8_reference(x, w, stride=(1, 1), pad=(0, 0), dilate=(1, 1),
                       groups: int = 1, epi: Optional[Requant] = None):
    """Plain twin of :func:`qconv_s8`: x (N, C, H, W) int8 by w (O, C /
    groups, kh, kw) int8, in float64, rounded to int32, then ``epi``."""
    acc = F.conv2d(x.to(torch.float64), w.to(torch.float64), None,
                   tuple(stride), tuple(pad), tuple(dilate), groups)
    return requantize_reference(_to_int32(acc), epi, 1)


def qgemm_s8_reference(x, w, epi: Optional[Requant] = None):
    """Plain twin of :func:`qgemm_s8`: x (N, K) int8 times w (units, K)
    int8 transposed, in float64, rounded to int32, then ``epi``."""
    acc = x.to(torch.float64) @ w.to(torch.float64).T
    return requantize_reference(_to_int32(acc), epi, 1)


def _check(name, x, w, epi, o):
    for t, what in ((x, "x"), (w, "w")):
        if not t.is_cuda:
            raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                             f"{what} on {t.device}")
        if t.dtype != torch.int8:
            raise TypeError(f"{name}: {what} must be int8, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if x.device != w.device:
        raise ValueError(f"{name}: x on {x.device}, w on {w.device}")
    if epi is not None and epi.bias is not None:
        b = epi.bias
        if b.dtype != torch.int32 or b.device != x.device \
                or tuple(b.shape) != (o,) or not b.is_contiguous():
            raise ValueError(f"{name}: the bias must be a contiguous int32 "
                             f"({o},) tensor on {x.device}, got {b.dtype} "
                             f"{tuple(b.shape)} on {b.device}")
    if x.numel() >= 2 ** 31 or w.numel() >= 2 ** 31:
        raise ValueError(f"{name}: operands of 2^31 elements or more")


def _launch(name, gemm, x, w, y, epi, dims):
    e = epi or Requant(None, False, 0.0, 0.0, False)
    bias = e.bias.data_ptr() if e.bias is not None else None
    code = kernel_library().mxt_qmma_s8(
        gemm, 0 if epi is None else 1, x.data_ptr(), w.data_ptr(),
        y.data_ptr(), bias, *dims, int(e.relu), float(e.step),
        float(e.s127), int(e.zero), current_stream_handle(x))
    check_launch(code, name)


@counted_kernel
def qconv_s8(x, w, stride: Sequence[int] = (1, 1),
             pad: Sequence[int] = (0, 0), dilate: Sequence[int] = (1, 1),
             groups: int = 1, epi: Optional[Requant] = None):
    """CUDA int8 convolution (the reference's ``quantized_conv`` product):
    x (N, C, H, W) int8 NCHW by w (O, C / groups, kh, kw) int8 OIHW.
    Returns (N, O, Ho, Wo) int32, or int8 codes under ``epi``."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"qconv_s8: x and w must be 4-D, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    n, c, h, wd = x.shape
    o, cg, kh, kw = w.shape
    groups = int(groups)
    if groups < 1 or c % groups or o % groups or cg != c // groups:
        raise ValueError(f"qconv_s8: {c} input and {o} output channels, "
                         f"weight {tuple(w.shape)}, do not make {groups} "
                         "groups")
    _check("qconv_s8", x, w, epi, o)
    sh, sw = (int(v) for v in stride)
    ph, pw = (int(v) for v in pad)
    dh, dw = (int(v) for v in dilate)
    if min(sh, sw, dh, dw) < 1 or min(ph, pw) < 0:
        raise ValueError(f"qconv_s8: stride {stride}, pad {pad}, dilation "
                         f"{dilate}")
    ho, wo = conv_out_hw(h, wd, (kh, kw), (sh, sw), (ph, pw), (dh, dw))
    if ho < 1 or wo < 1:
        raise ValueError(f"qconv_s8: no output for input {tuple(x.shape)} "
                         f"and kernel {(kh, kw)}")
    if n * ho * wo >= 2 ** 31 or n * o * ho * wo >= 2 ** 31:
        raise ValueError("qconv_s8: outputs of 2^31 elements or more")
    y = torch.empty((n, o, ho, wo), device=x.device,
                    dtype=torch.int32 if epi is None else torch.int8)
    _launch("qconv_s8", 0, x, w, y, epi,
            (n, c, h, wd, o, kh, kw, sh, sw, ph, pw, dh, dw, groups, ho, wo))
    qconv_s8.launches += 1
    return y


@counted_kernel
def qgemm_s8(x, w, epi: Optional[Requant] = None):
    """CUDA int8 fully connected product (the reference's
    ``quantized_fully_connected``): x (N, K) int8 times w (units, K) int8
    transposed. Returns (N, units) int32, or int8 codes under ``epi``."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"qgemm_s8: x (N, K) and w (units, K), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    n, k = x.shape
    o = w.shape[0]
    _check("qgemm_s8", x, w, epi, o)
    if n * o >= 2 ** 31:
        raise ValueError("qgemm_s8: outputs of 2^31 elements or more")
    y = torch.empty((n, o), device=x.device,
                    dtype=torch.int32 if epi is None else torch.int8)
    _launch("qgemm_s8", 1, x, w, y, epi,
            (n, k, 1, 1, o, 1, 1, 1, 1, 0, 0, 1, 1, 1, 1, 1))
    qgemm_s8.launches += 1
    return y
