"""Layer normalisation over the last axis: the CUDA kernels, their plain
PyTorch twins, and the differentiable op.

Counterpart of ``incubator_mxnet_tpu/ops/pallas/layer_norm.py``:

* ``layer_norm_reference`` / ``layer_norm_backward_reference`` — plain
  twins of the kernels ``layer_norm_fwd`` (y, mu, rstd) and
  ``layer_norm_bwd`` (dx and float32 column partials of dy * xn and dy);
* ``layer_norm`` — the op over any leading shape, differentiable through a
  ``torch.autograd.Function`` that saves (x, gamma, mu, rstd), as the
  reference's custom VJP does; shapes the reference computes inline
  (:func:`layer_norm_viable` false) take the same inline formula here, in
  the input type.

All kernel arithmetic is float32: var = mean((x - mu)^2), rstd =
rsqrt(var + eps), y = (x - mu) * rstd * gamma + beta in x's type;
dx = rstd * (dxn - mean(dxn) - xn * mean(dxn * xn)) with dxn = dy * gamma.
CUDA tensors go through the kernels, CPU tensors through the twins; a
kernel wrapper given anything else raises.
"""
from __future__ import annotations

import torch

from .common import (check_launch, counted_kernel, current_stream_handle,
                     kernel_library, pick_row_block)

__all__ = ["layer_norm_reference", "layer_norm_backward_reference",
           "layer_norm_fwd", "layer_norm_bwd", "layer_norm",
           "layer_norm_viable"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BWD_MAX_ROWS = 3072        # rows a backward block stats in shared memory


def layer_norm_reference(x2, gamma, beta, eps: float = 1e-5):
    """Plain twin of :func:`layer_norm_fwd`: x2 (n, d), gamma/beta (d,).
    Returns (y in x2's type, mu (n, 1) float32, rstd (n, 1) float32)."""
    xf = x2.float()
    mu = xf.mean(dim=1, keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt((xc * xc).mean(dim=1, keepdim=True) + eps)
    y = xc * rstd * gamma.float() + beta.float()
    return y.to(x2.dtype), mu, rstd


def layer_norm_backward_reference(x2, gamma, mu, rstd, dy):
    """Plain twin of :func:`layer_norm_bwd`. Returns (dx in x2's type,
    column sums of dy * xn and of dy as (1, d) float32 partials)."""
    xf, dyf = x2.float(), dy.float()
    xn = (xf - mu) * rstd
    dxn = dyf * gamma.float()
    m1 = dxn.mean(dim=1, keepdim=True)
    m2 = (dxn * xn).mean(dim=1, keepdim=True)
    dx = (rstd * (dxn - m1 - xn * m2)).to(x2.dtype)
    return dx, (dyf * xn).sum(dim=0, keepdim=True), \
        dyf.sum(dim=0, keepdim=True)


def _check_rows(name: str, x2, *others):
    if x2.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x2.dtype} not supported "
                        "(float32 or bfloat16)")
    if not x2.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                         f"{x2.device}")
    if x2.dim() != 2 or not x2.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous (n, d) tensor, got "
                         f"{tuple(x2.shape)}")
    for t in others:
        if t.device != x2.device:
            raise ValueError(f"{name}: operands on {t.device} and "
                             f"{x2.device}")


def _vec_f32(name: str, v, d: int):
    if v.numel() != d:
        raise ValueError(f"{name}: a ({d},) vector expected, got "
                         f"{tuple(v.shape)}")
    return v.reshape(d).to(torch.float32).contiguous()


def _stats_f32(name: str, t, n: int):
    if t.numel() != n or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: mu/rstd must be contiguous float32 with "
                         f"{n} entries, got {tuple(t.shape)} {t.dtype}")
    return t


@counted_kernel
def layer_norm_fwd(x2, gamma, beta, eps: float = 1e-5):
    """CUDA layer-norm forward (replaces the Pallas ``_run_fwd``): x2 (n, d)
    float32 or bfloat16, gamma/beta (d,) of any float type. Returns (y like
    x2, mu (n, 1) float32, rstd (n, 1) float32)."""
    _check_rows("layer_norm_fwd", x2, gamma, beta)
    n, d = x2.shape
    g = _vec_f32("layer_norm_fwd", gamma, d)
    b = _vec_f32("layer_norm_fwd", beta, d)
    y = torch.empty_like(x2)
    mu = torch.empty((n, 1), dtype=torch.float32, device=x2.device)
    rstd = torch.empty_like(mu)
    code = kernel_library().mxt_layer_norm_fwd(
        x2.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
        mu.data_ptr(), rstd.data_ptr(), n, d, _DTYPE_CODE[x2.dtype],
        float(eps), current_stream_handle(x2))
    check_launch(code, "layer_norm_fwd")
    layer_norm_fwd.launches += 1
    return y, mu, rstd


def _bwd_rows_per_block(n: int, device) -> int:
    """Rows a backward block owns: about four blocks per SM, so the
    (blocks, d) partials stay a small fraction of x."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(_BWD_MAX_ROWS, max(8, -(-n // (4 * sms))))


@counted_kernel
def layer_norm_bwd(x2, gamma, mu, rstd, dy):
    """CUDA layer-norm backward (replaces the Pallas ``_ln_bwd``). Returns
    (dx like x2, dgamma and dbeta partials, each (blocks, d) float32; their
    column sums are dgamma and dbeta)."""
    _check_rows("layer_norm_bwd", x2, gamma, mu, rstd, dy)
    n, d = x2.shape
    if dy.shape != x2.shape or dy.dtype != x2.dtype \
            or not dy.is_contiguous():
        raise ValueError(f"layer_norm_bwd: dy {tuple(dy.shape)} {dy.dtype} "
                         "does not match x")
    g = _vec_f32("layer_norm_bwd", gamma, d)
    mu = _stats_f32("layer_norm_bwd", mu, n)
    rstd = _stats_f32("layer_norm_bwd", rstd, n)
    rows = _bwd_rows_per_block(n, x2.device)
    blocks = -(-n // rows)
    dx = torch.empty_like(x2)
    dg = torch.empty((blocks, d), dtype=torch.float32, device=x2.device)
    db = torch.empty_like(dg)
    code = kernel_library().mxt_layer_norm_bwd(
        x2.data_ptr(), g.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
        dy.data_ptr(), dx.data_ptr(), dg.data_ptr(), db.data_ptr(), n, d,
        rows, _DTYPE_CODE[x2.dtype], current_stream_handle(x2))
    check_launch(code, "layer_norm_bwd")
    layer_norm_bwd.launches += 1
    return dx, dg, db


class _LayerNorm(torch.autograd.Function):
    """The reference's ``_layer_norm`` custom VJP: the forward saves (x,
    gamma, mu, rstd); the backward sums the column partials and casts them
    to gamma's type (``_ln_bwd`` :114-115; autograd then casts dbeta to
    beta's type)."""

    @staticmethod
    def forward(ctx, x2, gamma, beta, eps):
        fwd = layer_norm_fwd if x2.is_cuda else layer_norm_reference
        y, mu, rstd = fwd(x2, gamma, beta, eps)
        ctx.save_for_backward(x2, gamma, mu, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, gamma, mu, rstd = ctx.saved_tensors
        bwd = layer_norm_bwd if x2.is_cuda else layer_norm_backward_reference
        dx, dg, db = bwd(x2, gamma, mu, rstd, dy.contiguous())
        return (dx, dg.sum(dim=0).to(gamma.dtype),
                db.sum(dim=0).to(gamma.dtype), None)


def layer_norm_viable(n_rows: int, d: int) -> bool:
    """Does the reference run its kernel on this shape? Its ``layer_norm``
    (``ops/pallas/layer_norm.py:127-131``) computes inline when the row
    count is not a multiple of 8 or ``pick_row_block(n, d, 256)`` is 0
    (rows wider than 65,536)."""
    return n_rows % 8 == 0 and pick_row_block(n_rows, d, 256) != 0


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    """Layer norm over the last axis of ``x`` (any leading shape); gamma
    and beta hold d values. The kernels (or, on the CPU, their twins) where
    :func:`layer_norm_viable` holds; otherwise the reference's inline
    formula in the input type."""
    shape = x.shape
    d = shape[-1]
    x2 = x.reshape(-1, d)
    g, b = gamma.reshape(-1), beta.reshape(-1)
    if not layer_norm_viable(x2.shape[0], d):
        mu = x2.mean(dim=1, keepdim=True)
        xc = x2 - mu
        rstd = torch.rsqrt((xc * xc).mean(dim=1, keepdim=True) + eps)
        return ((xc * rstd) * g + b).reshape(shape)
    return _LayerNorm.apply(x2.contiguous(), g, b, eps).reshape(shape)
