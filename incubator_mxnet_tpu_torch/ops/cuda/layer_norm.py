"""Layer normalisation over the last axis: the CUDA kernels, their plain
PyTorch twins, and the differentiable op.

Counterpart of ``incubator_mxnet_tpu/ops/pallas/layer_norm.py``:

* ``layer_norm_reference`` / ``layer_norm_backward_reference`` — plain
  twins of the kernels ``layer_norm_fwd`` (y, mu, rstd) and
  ``layer_norm_bwd`` (dx, dgamma, dbeta);
* ``layer_norm_fwd_route`` — the forward's route by row width: rows of at
  most 1024 take the vector kernel (16-byte loads and stores, gamma and
  beta in registers, a persistent grid, counted in ``sm90_launches``
  beside ``launches``); wider rows the block kernel;
* ``layer_norm_bwd_route`` — the backward's route by row width: rows of
  at most 1024 take the one-pass kernel (x and dy read once, dgamma and
  dbeta finished inside the launch, counted in ``sm90_launches`` beside
  ``launches``); wider rows the two-pass kernel, whose column partials the
  wrapper sums;
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
                     kernel_library, pick_row_block, sm_count, ticket_buffer)

__all__ = ["layer_norm_reference", "layer_norm_backward_reference",
           "layer_norm_fwd", "layer_norm_bwd", "layer_norm",
           "layer_norm_viable", "layer_norm_fwd_route",
           "layer_norm_fwd_plan", "layer_norm_fwd_blocks_per_sm",
           "layer_norm_bwd_route", "layer_norm_bwd_plan",
           "layer_norm_bwd_blocks_per_sm"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BWD_MAX_ROWS = 3072        # rows a two-pass block stats in shared memory
# the one-pass backward (layer_norm.cu kBwd*, rows.cuh kWarpRowMaxD)
ONEPASS_MAX_D = 1024        # a row in one warp's registers
BWD_WARPS = 8               # warps of a block
BWD_GROUP = 16              # blocks whose partials one block sums
BWD_VEC_BYTES = 16          # a lane's vector load
# a row's values a lane holds, at most, for two bf16 blocks an SM
BWD_TWO_BLOCK_VALUES = 24
H100_SMS = 132              # the twin's SM count on the CPU
# the vector forward (layer_norm.cu kFwdWarps, fwd_blocks_per_sm)
FWD_WARPS = 8               # warps of a block


def layer_norm_fwd_route(d: int) -> str:
    """"vec" for rows of at most 1024 (a warp a row in registers, 16-byte
    loads and stores, a persistent grid), "block" for wider rows (a block
    a row)."""
    return "vec" if d <= ONEPASS_MAX_D else "block"


def layer_norm_fwd_blocks_per_sm(d: int, itemsize: int) -> int:
    """Blocks an SM the vector forward's grid is sized for, the minimum
    that its launch bound asks registers for (layer_norm.cu
    fwd_blocks_per_sm), by the values a lane holds of a row (whole 16-byte
    chunks): four up to 8, two up to ``BWD_TWO_BLOCK_VALUES``, else one."""
    per_vec = BWD_VEC_BYTES // itemsize
    values = -(-d // (32 * per_vec)) * per_vec
    return 4 if values <= 8 else 2 if values <= BWD_TWO_BLOCK_VALUES else 1


def layer_norm_fwd_plan(n: int, d: int, itemsize: int,
                        sms: int = H100_SMS) -> tuple[int, int]:
    """The vector forward's grid over n rows of d ``itemsize``-byte values
    on a card of ``sms`` SMs: (rows a block, blocks). Block b walks rows
    [b R, b R + R) with ``FWD_WARPS`` warps, warp w taking rows w,
    w + FWD_WARPS, ...."""
    blocks = min(-(-n // FWD_WARPS),
                 layer_norm_fwd_blocks_per_sm(d, itemsize) * sms)
    rows = -(-n // blocks)
    return rows, -(-n // rows)


def layer_norm_bwd_route(d: int) -> str:
    """"onepass" for rows of at most 1024 (one warp a row, x and dy read
    once, dgamma and dbeta summed inside the launch), "twopass" for wider
    rows (a block's rows read twice, column partials summed after)."""
    return "onepass" if d <= ONEPASS_MAX_D else "twopass"


def layer_norm_bwd_blocks_per_sm(d: int, itemsize: int) -> int:
    """Blocks an SM the one-pass grid is sized for, the minimum that the
    kernel's launch bound asks registers for (layer_norm.cu
    bwd_blocks_per_sm): two for bf16 rows (half the bytes a row, so twice
    the rows in flight) while a lane holds at most
    ``BWD_TWO_BLOCK_VALUES`` values of a row (d <= 768), else one."""
    per_vec = BWD_VEC_BYTES // itemsize
    values = -(-d // (32 * per_vec)) * per_vec
    return 2 if itemsize == 2 and values <= BWD_TWO_BLOCK_VALUES else 1


def layer_norm_bwd_plan(n: int, d: int, itemsize: int,
                        sms: int = H100_SMS) -> tuple[int, int, int]:
    """The one-pass kernel's grid over n rows of d ``itemsize``-byte values
    on a card of ``sms`` SMs: (rows a block, blocks, groups). Blocks walk
    runs of consecutive rows; a group of ``BWD_GROUP`` blocks has its
    partials summed by its last block, the groups' sums by the last
    group's."""
    blocks = min(-(-n // BWD_WARPS),
                 layer_norm_bwd_blocks_per_sm(d, itemsize) * sms)
    rows = -(-n // blocks)
    blocks = -(-n // rows)
    return rows, blocks, -(-blocks // BWD_GROUP)


def layer_norm_reference(x2, gamma, beta, eps: float = 1e-5):
    """Plain twin of :func:`layer_norm_fwd`: x2 (n, d), gamma/beta (d,).
    Returns (y in x2's type, mu (n, 1) float32, rstd (n, 1) float32)."""
    xf = x2.float()
    mu = xf.mean(dim=1, keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt((xc * xc).mean(dim=1, keepdim=True) + eps)
    y = xc * rstd * gamma.float() + beta.float()
    return y.to(x2.dtype), mu, rstd


def _sum_in_order(t):
    """t[0] + t[1] + ... along the first axis, one rounded add at a time."""
    total = t[0]
    for i in range(1, t.shape[0]):
        total = total + t[i]
    return total


def _onepass_column_sums(v, plan):
    """The one-pass kernel's column sums of v (n, d) float32: each warp's
    rows in order (block b's rows b R .. b R + R - 1, warp w taking rows
    w, w + BWD_WARPS, ...), its warps in order, the blocks of each group in
    order, then the groups in order. Zero rows pad the ragged runs (adding
    0 changes no sum)."""
    rows, blocks, groups = plan
    n, d = v.shape
    per_warp = -(-rows // BWD_WARPS)
    flat = v.new_zeros((blocks * rows, d))
    flat[:n] = v
    t = v.new_zeros((blocks, per_warp * BWD_WARPS, d))
    t[:, :rows] = flat.view(blocks, rows, d)
    warps = _sum_in_order(t.view(blocks, per_warp, BWD_WARPS, d)
                          .transpose(0, 1))           # (blocks, warps, d)
    block_rows = _sum_in_order(warps.transpose(0, 1))  # (blocks, d)
    padded = v.new_zeros((groups * BWD_GROUP, d))
    padded[:blocks] = block_rows
    group_rows = _sum_in_order(padded.view(groups, BWD_GROUP, d)
                               .transpose(0, 1))       # (groups, d)
    return _sum_in_order(group_rows)


def layer_norm_backward_reference(x2, gamma, mu, rstd, dy):
    """Plain twin of :func:`layer_norm_bwd`. Returns (dx in x2's type,
    dgamma, dbeta (d,) float32). On the one-pass route the column sums
    are taken in the kernel's order for x2's card (an H100's 132 SMs on
    the CPU)."""
    xf, dyf = x2.float(), dy.float()
    xn = (xf - mu) * rstd
    dxn = dyf * gamma.float()
    m1 = dxn.mean(dim=1, keepdim=True)
    m2 = (dxn * xn).mean(dim=1, keepdim=True)
    dx = (rstd * (dxn - m1 - xn * m2)).to(x2.dtype)
    n, d = x2.shape
    if layer_norm_bwd_route(d) == "twopass" or n == 0:
        return dx, (dyf * xn).sum(dim=0), dyf.sum(dim=0)
    sms = sm_count(x2.device) if x2.is_cuda else H100_SMS
    plan = layer_norm_bwd_plan(n, d, x2.element_size(), sms)
    return (dx, _onepass_column_sums(dyf * xn, plan),
            _onepass_column_sums(dyf, plan))


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
def layer_norm_fwd(x2, gamma, beta, eps: float = 1e-5, _route=None):
    """CUDA layer-norm forward (replaces the Pallas ``_run_fwd``): x2 (n, d)
    float32 or bfloat16, gamma/beta (d,) of any float type. Returns (y like
    x2, mu (n, 1) float32, rstd (n, 1) float32). The route is
    :func:`layer_norm_fwd_route`'s; ``_route="warp"`` forces the first
    design (a warp a row, scalar accesses; the block kernel above 1024
    columns)."""
    if _route not in (None, "warp"):
        raise ValueError(f"layer_norm_fwd: _route {_route!r}")
    _check_rows("layer_norm_fwd", x2, gamma, beta)
    n, d = x2.shape
    g = _vec_f32("layer_norm_fwd", gamma, d)
    b = _vec_f32("layer_norm_fwd", beta, d)
    y = torch.empty_like(x2)
    mu = torch.empty((n, 1), dtype=torch.float32, device=x2.device)
    rstd = torch.empty_like(mu)
    vec = _route is None and d > 0 and layer_norm_fwd_route(d) == "vec"
    if vec:
        rows, blocks = layer_norm_fwd_plan(max(n, 1), d, x2.element_size(),
                                           sm_count(x2.device))
        code = kernel_library().mxt_layer_norm_fwd_vec(
            x2.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
            mu.data_ptr(), rstd.data_ptr(), n, d, rows, blocks,
            _DTYPE_CODE[x2.dtype], float(eps), current_stream_handle(x2))
    else:
        code = kernel_library().mxt_layer_norm_fwd(
            x2.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
            mu.data_ptr(), rstd.data_ptr(), n, d, _DTYPE_CODE[x2.dtype],
            float(eps), current_stream_handle(x2))
    check_launch(code, "layer_norm_fwd")
    layer_norm_fwd.launches += 1
    layer_norm_fwd.sm90_launches += vec
    return y, mu, rstd


def _bwd_rows_per_block(n: int, device) -> int:
    """Rows a two-pass block owns: about four blocks per SM, so the
    (blocks, d) partials stay a small fraction of x."""
    return min(_BWD_MAX_ROWS, max(8, -(-n // (4 * sm_count(device)))))


def _bwd_twopass(x2, g, mu, rstd, dy, dx):
    """The two-pass kernel, then the sums of its column partials."""
    n, d = x2.shape
    rows = _bwd_rows_per_block(n, x2.device)
    dg = torch.empty((-(-n // rows), d), dtype=torch.float32,
                     device=x2.device)
    db = torch.empty_like(dg)
    code = kernel_library().mxt_layer_norm_bwd(
        x2.data_ptr(), g.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
        dy.data_ptr(), dx.data_ptr(), dg.data_ptr(), db.data_ptr(), n, d,
        rows, _DTYPE_CODE[x2.dtype], current_stream_handle(x2))
    check_launch(code, "layer_norm_bwd")
    layer_norm_bwd.launches += 1
    return dx, dg.sum(dim=0), db.sum(dim=0)


def _bwd_onepass(x2, g, mu, rstd, dy, dx):
    """The one-pass kernel: dx, dgamma and dbeta in one launch."""
    n, d = x2.shape
    rows, blocks, groups = layer_norm_bwd_plan(n, d, x2.element_size(),
                                               sm_count(x2.device))
    dg = torch.empty((2, d), dtype=torch.float32, device=x2.device)
    ws = torch.empty(((blocks + groups) * 2 * d,), dtype=torch.float32,
                     device=x2.device)
    stream = current_stream_handle(x2)
    tickets = ticket_buffer("layer_norm_bwd", x2, stream, groups + 1)
    code = kernel_library().mxt_layer_norm_bwd_onepass(
        x2.data_ptr(), g.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
        dy.data_ptr(), dx.data_ptr(), dg[0].data_ptr(), dg[1].data_ptr(),
        ws.data_ptr(), tickets.data_ptr(), n, d, rows, blocks,
        _DTYPE_CODE[x2.dtype], stream)
    check_launch(code, "layer_norm_bwd")
    layer_norm_bwd.launches += 1
    layer_norm_bwd.sm90_launches += 1
    return dx, dg[0], dg[1]


@counted_kernel
def layer_norm_bwd(x2, gamma, mu, rstd, dy, _route=None):
    """CUDA layer-norm backward (replaces the Pallas ``_ln_bwd``). Returns
    (dx like x2, dgamma, dbeta (d,) float32). The route is
    :func:`layer_norm_bwd_route`'s; ``_route="twopass"`` forces the
    two-pass kernel at any width."""
    _check_rows("layer_norm_bwd", x2, gamma, mu, rstd, dy)
    n, d = x2.shape
    if dy.shape != x2.shape or dy.dtype != x2.dtype \
            or not dy.is_contiguous():
        raise ValueError(f"layer_norm_bwd: dy {tuple(dy.shape)} {dy.dtype} "
                         "does not match x")
    if _route not in (None, "twopass"):
        raise ValueError(f"layer_norm_bwd: _route {_route!r}")
    g = _vec_f32("layer_norm_bwd", gamma, d)
    mu = _stats_f32("layer_norm_bwd", mu, n)
    rstd = _stats_f32("layer_norm_bwd", rstd, n)
    dx = torch.empty_like(x2)
    if n == 0 or d == 0:
        zeros = torch.zeros(d, dtype=torch.float32, device=x2.device)
        return dx, zeros, zeros.clone()
    route = _route or layer_norm_bwd_route(d)
    run = _bwd_onepass if route == "onepass" else _bwd_twopass
    return run(x2, g, mu, rstd, dy, dx)


class _LayerNorm(torch.autograd.Function):
    """The reference's ``_layer_norm`` custom VJP: the forward saves (x,
    gamma, mu, rstd); the backward casts dgamma and dbeta to gamma's type
    (``_ln_bwd`` :114-115; autograd then casts dbeta to beta's type)."""

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
        return dx, dg.to(gamma.dtype), db.to(gamma.dtype), None


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
