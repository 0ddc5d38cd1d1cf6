"""Row softmax over the last axis: the CUDA kernel, its plain PyTorch twin,
and the differentiable op.

Counterpart of ``incubator_mxnet_tpu/ops/pallas/softmax.py``:

* ``softmax_reference`` — plain twin of the kernel ``softmax_fwd``: max,
  exp, sum and divide per row in float32, written in the input type;
* ``softmax`` — the op along any axis. The last axis goes through a
  ``torch.autograd.Function`` whose backward is the reference's closed
  form p * (dy - sum(dy * p)) in float32, plain PyTorch as in the
  reference; other axes, and shapes the reference computes inline
  (:func:`softmax_viable` false), take ``torch.softmax``.

CUDA tensors go through the kernel, CPU tensors through the twin; the
kernel wrapper given anything else raises.
"""
from __future__ import annotations

import torch

from .common import (check_launch, counted_kernel, current_stream_handle,
                     kernel_library, pick_row_block)

__all__ = ["softmax_reference", "softmax_fwd", "softmax", "softmax_viable"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def softmax_reference(x2):
    """Plain twin of :func:`softmax_fwd`: softmax of each row of x2 (n, d)
    in float32, returned in x2's type."""
    xf = x2.float()
    e = torch.exp(xf - xf.amax(dim=1, keepdim=True))
    return (e / e.sum(dim=1, keepdim=True)).to(x2.dtype)


@counted_kernel
def softmax_fwd(x2):
    """CUDA row softmax (replaces the Pallas ``_run``): x2 (n, d) float32 or
    bfloat16, contiguous. Returns y like x2."""
    if x2.dtype not in _DTYPE_CODE:
        raise TypeError(f"softmax_fwd: dtype {x2.dtype} not supported "
                        "(float32 or bfloat16)")
    if not x2.is_cuda:
        raise ValueError(f"softmax_fwd: the kernel takes CUDA tensors, got "
                         f"{x2.device}")
    if x2.dim() != 2 or not x2.is_contiguous():
        raise ValueError("softmax_fwd: x must be a contiguous (n, d) tensor, "
                         f"got {tuple(x2.shape)}")
    n, d = x2.shape
    y = torch.empty_like(x2)
    code = kernel_library().mxt_softmax_fwd(
        x2.data_ptr(), y.data_ptr(), n, d, _DTYPE_CODE[x2.dtype],
        current_stream_handle(x2))
    check_launch(code, "softmax_fwd")
    softmax_fwd.launches += 1
    return y


class _Softmax(torch.autograd.Function):
    """The reference's ``_softmax2`` custom VJP: saves p; the backward is
    p * (dy - sum(dy * p)) in float32, cast to p's type."""

    @staticmethod
    def forward(ctx, x2):
        p = softmax_fwd(x2) if x2.is_cuda else softmax_reference(x2)
        ctx.save_for_backward(p)
        return p

    @staticmethod
    def backward(ctx, dy):
        (p,) = ctx.saved_tensors
        dyf, pf = dy.float(), p.float()
        dx = pf * (dyf - (dyf * pf).sum(dim=1, keepdim=True))
        return dx.to(p.dtype)


def softmax_viable(n_rows: int, d: int) -> bool:
    """Does the reference run its kernel on this shape? Its ``softmax``
    (``ops/pallas/softmax.py:62-67``) falls back to ``jax.nn.softmax`` when
    the row count is not a multiple of 8 or ``pick_row_block(n, d)`` is 0
    (rows wider than 65,536)."""
    return n_rows % 8 == 0 and pick_row_block(n_rows, d) != 0


def softmax(x, axis: int = -1):
    """Softmax along ``axis``: the kernel (or, on the CPU, its twin) over
    the last axis where :func:`softmax_viable` holds, ``torch.softmax``
    otherwise."""
    if axis not in (-1, x.dim() - 1):
        return torch.softmax(x, dim=axis)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if not softmax_viable(x2.shape[0], x2.shape[1]):
        return torch.softmax(x, dim=-1)
    return _Softmax.apply(x2.contiguous()).reshape(shape)
