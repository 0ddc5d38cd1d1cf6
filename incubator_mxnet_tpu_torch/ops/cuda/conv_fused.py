"""Fused conv + batch-norm + ReLU for NHWC bottleneck ResNets: the CUDA
kernels, their plain PyTorch twins, and their launch counts.

Counterpart of ``incubator_mxnet_tpu/ops/pallas/conv_fused.py``, with the
reference's signatures (activations are flat NHWC rows (B*H*W, C); 1x1
weights are (K, N) and 3x3 weights (9, C, N), usually views of the gluon
weights (O, 1, 1, I) and (O, 3, 3, I) that the kernels read by strides):

* ``mm_fused`` / ``mm_fused_reference`` — y = x^ @ w (+ bias) with the load
  transform x^ = x, relu(a x + b) or relu(a x + b + asc sc + bsc), the
  optional x^ output, and (2, N) float32 sums of y and y^2;
* ``mm_fused_bwd`` / ``mm_fused_bwd_reference`` — G = g or (dzn g0 - g1 -
  yout g2); dz = mask(G @ w^T (+ dsc)) masked on x or on z = a x + b;
  dW = x^^T @ G in float32; partials sum dz and sum dz * partner_j;
* ``conv3_fused`` / ``conv3_fused_reference`` — the 3x3 stride-1 pad-1
  conv of relu(a x + b), plus the stats;
* ``conv3_fused_bwd`` / ``conv3_fused_bwd_reference`` — dz = (conv3^T G) *
  [z > 0], dW9 (9, C, N) float32, partials sum dz and sum dz * x;
* ``dgrad_epilogue`` / ``dgrad_epilogue_reference`` — the dual dgrad of a
  junction feeding two 1x1 convs: dx = G_a w_a^T + G_b w_b^T summed in
  float32 and rounded once, and both dW off the one x.

The rounding points are the reference's: the transform in float32 rounded
to the input type, float32 accumulation, outputs rounded to the input type,
sums over the rounded values.

Two routes, chosen by type and shape before the launch (never on failure):
all five in bf16, with channel counts that are multiples of 8,
16-byte-aligned operands and a weight with a stride 1 (for
``mm_fused_bwd``, ``conv3_fused`` and ``conv3_fused_bwd``, the one of the
gluon weight's view), take the Hopper kernels of
``csrc/conv_fused_sm90.cu`` (TMA-fed ``wgmma``; counted in
``sm90_launches`` beside ``launches``); everything else, float32 always,
takes the SIMT kernels of ``csrc/conv_fused.cu`` (no TF32, so float32
matches the plain twin). :func:`mm_fused_route`,
:func:`mm_fused_bwd_route`, :func:`conv3_fused_route`,
:func:`conv3_fused_bwd_route`, :func:`dgrad_epilogue_route`,
:func:`sm90_bn`, :func:`sm90_plan` and :func:`sm90_wgrad_split` hold the
choice and the tile plan in Python. The kernel wrappers take CUDA tensors only
and raise on anything else; the ``*_reference`` twins are plain PyTorch,
for the CPU and for holding the kernels to on the card. The reference's
dispatch between its Pallas kernels and its XLA twins (the 128-lane rule,
``MXTPU_FUSED_IMPL``, ``MXTPU_FUSED_CONV3``, the row-block pickers) is TPU
scheduling over identical values and has no counterpart here.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .common import (check_launch, counted_kernel, current_stream_handle,
                     kernel_library, sm_count)

__all__ = ["mm_fused", "mm_fused_bwd", "conv3_fused", "conv3_fused_bwd",
           "dgrad_epilogue", "mm_fused_reference", "mm_fused_bwd_reference",
           "conv3_fused_reference", "conv3_fused_bwd_reference",
           "dgrad_epilogue_reference", "mm_fused_route",
           "mm_fused_bwd_route", "conv3_fused_route",
           "conv3_fused_bwd_route", "dgrad_epilogue_route",
           "sm90_bn", "sm90_plan", "sm90_wgrad_split"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MASK_CODE = {"none": 0, "x": 1, "z": 2}
_BM, _BN, _BK = 128, 64, 32          # the kernels' tile (conv_fused.cu)
# the Hopper route's tile (conv_fused_sm90.cu): 128 rows, a 64-deep ring of
# stages in a 200 KB budget, at most 227 KB of shared memory a block
SM90_BM, SM90_BK = 128, 64
SM90_SMEM_LIMIT = 232448
# mm_fused_bwd's dgrad stage (kBwdStage): four 128 x 64 tiles and 1 KB
SM90_BWD_STAGE = 4 * SM90_BM * SM90_BK * 2 + 1024
_SM90_STAGE_BUDGET = 200 * 1024
# the dW split's cost model: a 128-row block's time per reduction row at a
# tile width of 256 (2 * 128 * 256 flops at one SM's share of 989 TFLOP/s)
# and the float32 partials' bytes, written and summed, at 3.35 TB/s
_SM90_ROW_S = 2 * 128 * 256 / (989e12 / 132)
_HBM_BYTES_S = 3.35e12


def _f32(t):
    return t.float()


# ---------------------------------------------------------------- twins
def mm_fused_reference(x, w, a=None, b=None, sc=None, asc=None, bsc=None,
                       bias=None, stats: bool = True,
                       emit_xhat: bool = False):
    """Plain twin of :func:`mm_fused` (the reference's ``_mm_fused_xla``).
    Returns (y[, stats (2, N)][, xhat])."""
    if a is None:
        xh = x
    else:
        z = _f32(x) * _f32(a) + _f32(b)
        if sc is not None:
            z = z + _f32(sc) * _f32(asc) + _f32(bsc)
        xh = torch.clamp(z, min=0.0).to(x.dtype)
    y = torch.matmul(_f32(xh), _f32(w))
    if bias is not None:
        y = y + _f32(bias)
    yc = y.to(x.dtype)
    out = [yc]
    if stats:
        yf = _f32(yc)
        out.append(torch.stack([yf.sum(0), (yf * yf).sum(0)]))
    if emit_xhat:
        out.append(xh)
    return tuple(out)


def _g_on_load(g, dzn, yout, gcoef):
    if g is not None:
        return g
    gc = _f32(gcoef)
    return (_f32(dzn) * gc[0] - gc[1] - _f32(yout) * gc[2]).to(dzn.dtype)


def mm_fused_bwd_reference(w, x, g=None, dzn=None, yout=None, gcoef=None,
                           a=None, b=None, dsc=None, partners=(),
                           out_mask: str = "none", out_dtype=None):
    """Plain twin of :func:`mm_fused_bwd` (the reference's
    ``_mm_fused_bwd_xla``). Returns (dz (M, K), dW (K, N) float32,
    partials (1 + len(partners), K) float32)."""
    if out_mask == "z" and a is None:
        raise ValueError("out_mask='z' masks on the load transform "
                         "z = a*x + b; pass a and b")
    out_dtype = out_dtype or x.dtype
    g = _g_on_load(g, dzn, yout, gcoef)
    if a is not None:
        z = _f32(x) * _f32(a) + _f32(b)
        xh = torch.clamp(z, min=0.0).to(x.dtype)
    else:
        xh = x
    dxh = torch.matmul(_f32(g), _f32(w).t())
    if dsc is not None:
        dxh = dxh + _f32(dsc)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if out_mask == "x":
        dz = torch.where(_f32(x) > 0.0, dxh, zero)
    elif out_mask == "z":
        dz = torch.where(z > 0.0, dxh, zero)
    else:
        dz = dxh
    dzc = dz.to(out_dtype)
    dw = torch.matmul(_f32(xh).t(), _f32(g))
    dzf = _f32(dzc)
    rows = [dzf.sum(0)] + [(dzf * _f32(p)).sum(0) for p in partners]
    return dzc, dw, torch.stack(rows)


def dgrad_epilogue_reference(w_a, w_b, x, dzn_a, yout_a, gcoef_a, dzn_b,
                             yout_b, gcoef_b, out_dtype=None):
    """Plain twin of :func:`dgrad_epilogue` (the reference's
    ``_dgrad_epilogue_xla``). Returns (dx (M, K), dW_a (K, N_a) float32,
    dW_b (K, N_b) float32)."""
    out_dtype = out_dtype or x.dtype
    ga = _f32(_g_on_load(None, dzn_a, yout_a, gcoef_a))
    gb = _f32(_g_on_load(None, dzn_b, yout_b, gcoef_b))
    dx = torch.matmul(ga, _f32(w_a).t()) + torch.matmul(gb, _f32(w_b).t())
    xf = _f32(x).t()
    return dx.to(out_dtype), torch.matmul(xf, ga), torch.matmul(xf, gb)


def _nchw(rows, bhw):
    B, H, W = bhw
    return rows.reshape(B, H, W, -1).permute(0, 3, 1, 2)


def _rows(t):
    return t.permute(0, 2, 3, 1).reshape(-1, t.shape[1])


def _w_oihw(w9):
    """(9, C, N) taps -> (N, C, 3, 3) float32 for ``F.conv2d``."""
    C, N = w9.shape[1], w9.shape[2]
    return _f32(w9).reshape(3, 3, C, N).permute(3, 2, 0, 1)


def conv3_fused_reference(x2, w9, a, b, bhw, stats: bool = True):
    """Plain twin of :func:`conv3_fused` (the reference's
    ``_conv3_fused_xla``). Returns (y (B*H*W, N)[, stats (2, N)])."""
    xh = torch.clamp(_f32(x2) * _f32(a) + _f32(b), min=0.0).to(x2.dtype)
    y = _rows(F.conv2d(_f32(_nchw(xh, bhw)), _w_oihw(w9),
                       padding=1)).to(x2.dtype)
    out = [y]
    if stats:
        yf = _f32(y)
        out.append(torch.stack([yf.sum(0), (yf * yf).sum(0)]))
    return tuple(out)


def conv3_fused_bwd_reference(w9, x2, a, b, dzn, yout, gcoef, bhw):
    """Plain twin of :func:`conv3_fused_bwd` (the reference's
    ``_conv3_fused_bwd_xla``, with dW9 kept in float32 as its Pallas kernel
    keeps it). Returns (dz (B*H*W, C), dW9 (9, C, N) float32, partials
    (2, C) float32)."""
    C, N = w9.shape[1], w9.shape[2]
    g = _g_on_load(None, dzn, yout, gcoef)
    z = _f32(x2) * _f32(a) + _f32(b)
    xh = torch.clamp(z, min=0.0).to(x2.dtype)
    xh4 = _f32(_nchw(xh, bhw))
    g4 = _f32(_nchw(g, bhw))
    w4 = _w_oihw(w9)
    dxh = _rows(torch.nn.grad.conv2d_input(xh4.shape, w4, g4, padding=1))
    dw4 = torch.nn.grad.conv2d_weight(xh4, w4.shape, g4, padding=1)
    dz = torch.where(z > 0.0, dxh, torch.zeros((), device=x2.device)
                     ).to(x2.dtype)
    dzf = _f32(dz)
    p = torch.stack([dzf.sum(0), (dzf * _f32(x2)).sum(0)])
    return dz, dw4.permute(2, 3, 1, 0).reshape(9, C, N), p


# ------------------------------------------------------------- wrappers
def _check(name, x, w, *others):
    if not x.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (float32 or "
                        "bfloat16)")
    if w.dtype != x.dtype:
        raise TypeError(f"{name}: weight {w.dtype} and input {x.dtype}")
    for t in (x, w) + others:
        if t is not None and t.device != x.device:
            raise ValueError(f"{name}: operands on {t.device} and "
                             f"{x.device}")


def _rows_of(name, t, shape, dtype):
    """An activation operand: a contiguous ``shape`` tensor of ``dtype``."""
    if t is None:
        return None
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {tuple(shape)} "
                         f"{dtype} tensor, got {tuple(t.shape)} {t.dtype}")
    return t


def _vec(name, v, n):
    """A per-channel vector as contiguous float32 (None stays None)."""
    if v is None:
        return None
    if v.numel() != n:
        raise ValueError(f"{name}: a ({n},) vector expected, got "
                         f"{tuple(v.shape)}")
    if v.dim() == 1 and v.dtype == torch.float32 and v.is_contiguous():
        return v
    return v.reshape(n).to(torch.float32).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _blocks(m: int) -> int:
    return -(-m // _BM)


def _wgrad_split(m: int, rows: int, n: int, device):
    """(splits, chunk) of the dW launch's row range: about four blocks per
    SM over the (rows / 128) x (n / 64) output tiles, each split a multiple
    of the 32-row step."""
    tiles = -(-rows // _BM) * -(-n // _BN)
    splits = max(1, min(-(-m // _BK), -(-4 * sm_count(device) // tiles)))
    chunk = max(_BK, -(-(-(-m // splits)) // _BK) * _BK)
    return max(1, -(-m // chunk)), chunk


def sm90_bn(width: int) -> int:
    """The Hopper route's tile width for ``width`` output columns: the
    width rounded up to 64, 128 or 256 (at most 256: wider outputs take
    several column tiles)."""
    return 64 if width <= 64 else 128 if width <= 128 else 256


def sm90_plan(bn: int, n_raw: int, min_stage: int = 0) -> dict:
    """The shared-memory plan of a Hopper-route block (``Plan`` in
    conv_fused_sm90.cu): a stage holds ``n_raw`` 128 x 64 A tiles (1 for
    the plain forward, the wgrad's G and the 3x3 forward's tap box, 2 raw
    ones for the transformed forward and the dgrads), the bn x 64 B tile
    and 1 KB of per-channel coefficients, and at least ``min_stage`` bytes
    (:data:`SM90_BWD_STAGE` for ``mm_fused_bwd``'s dgrad, whose epilogue
    takes four 128 x 64 operand tiles a stage); 3-4 stages; the epilogue
    reuses them."""
    stage = max(min_stage,
                n_raw * SM90_BM * SM90_BK * 2 + bn * SM90_BK * 2 + 1024)
    stages = min(4, _SM90_STAGE_BUDGET // stage)
    return {"bn": bn, "stages": stages, "stage_bytes": stage,
            "smem_bytes": stages * stage + 1024}


def _tma_ok(t) -> bool:
    """A bf16 operand the TMA can read: 2-D, one stride 1 and the other a
    multiple of 8 elements (16 bytes), its base 16-byte aligned."""
    if t is None:
        return True
    if t.dim() != 2 or t.data_ptr() % 16:
        return False
    s0, s1 = t.stride()
    return (s1 == 1 and s0 % 8 == 0) or (s0 == 1 and s1 % 8 == 0)


def _bulk_ok(v) -> bool:
    """A float32 coefficient vector the kernel copies in 16-byte runs."""
    return v is None or (v.data_ptr() % 16 == 0 and v.is_contiguous())


def mm_fused_route(x, w, sc=None, vecs=()) -> str:
    """"sm90" when :func:`mm_fused` takes the Hopper kernel (bf16, K and N
    multiples of 8, operands the TMA can read, the float32 vectors ``vecs``
    (a, b, asc, bsc) 16-byte aligned), else "simt"."""
    k, n = w.shape
    ok = (x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16
          and k % 8 == 0 and n % 8 == 0 and k >= 8 and n >= 8
          and all(_tma_ok(t) for t in (x, w, sc))
          and all(_bulk_ok(v) for v in vecs))
    return "sm90" if ok else "simt"


def mm_fused_bwd_route(x, w, acts=(), vecs=()) -> str:
    """"sm90" when :func:`mm_fused_bwd` takes the Hopper kernels (bf16, K
    and N multiples of 8, at least one row, w (K, N) with K contiguous as
    the gluon weight's view gives it, x, w and the activations ``acts`` (g
    or dzn and yout, dsc, the partners) readable by the TMA and by 16-byte
    row loads, the float32 vectors ``vecs`` (a, b, gcoef) 16-byte aligned),
    else "simt". Every form takes it: G direct or formed on load, each
    mask, 0-2 partners, dsc."""
    k, n = w.shape
    ok = (x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16
          and x.shape[0] >= 1 and all(d % 8 == 0 and d >= 8 for d in (k, n))
          and w.stride(0) == 1
          and all(_tma_ok(t) for t in (x, w) + tuple(acts))
          and all(_bulk_ok(v) for v in vecs))
    return "sm90" if ok else "simt"


def conv3_fused_route(x2, w9, vecs=()) -> str:
    """"sm90" when :func:`conv3_fused` takes the Hopper kernel (bf16, C and
    N multiples of 8, at least one row, x2 readable by the TMA, w9 one
    (9 C, N) matrix with the reduction index tap C + c contiguous, as the
    gluon weight's view gives it (strides (C, 1, a multiple of 8)), a
    16-byte aligned base, the float32 vectors ``vecs`` (a, b) 16-byte
    aligned), else "simt"."""
    c, n = w9.shape[1], w9.shape[2]
    s_tap, s_c, s_n = w9.stride()
    ok = (x2.dtype == torch.bfloat16 and w9.dtype == torch.bfloat16
          and x2.shape[0] >= 1 and all(d % 8 == 0 and d >= 8 for d in (c, n))
          and s_c == 1 and s_tap == c and s_n % 8 == 0
          and w9.data_ptr() % 16 == 0
          and _tma_ok(x2) and all(_bulk_ok(v) for v in vecs))
    return "sm90" if ok else "simt"


def conv3_fused_bwd_route(x2, w9, acts=(), vecs=()) -> str:
    """"sm90" when :func:`conv3_fused_bwd` takes the Hopper kernels (bf16,
    C and N multiples of 8, at least one row, x2 and the activations
    ``acts`` (dzn, yout) readable by the TMA, w9 the gluon weight's view
    (strides (C, 1, a multiple of 8): an MN-major B of W[tap]^T) with a
    16-byte aligned base, the float32 vectors ``vecs`` (a, b, gcoef)
    16-byte aligned), else "simt"."""
    c, n = w9.shape[1], w9.shape[2]
    s_tap, s_c, s_n = w9.stride()
    ok = (x2.dtype == torch.bfloat16 and w9.dtype == torch.bfloat16
          and x2.shape[0] >= 1 and all(d % 8 == 0 and d >= 8 for d in (c, n))
          and s_c == 1 and s_tap == c and s_n % 8 == 0
          and w9.data_ptr() % 16 == 0
          and all(_tma_ok(t) for t in (x2,) + tuple(acts))
          and all(_bulk_ok(v) for v in vecs))
    return "sm90" if ok else "simt"


def dgrad_epilogue_route(x, w_a, w_b, acts=(), vecs=()) -> str:
    """"sm90" when :func:`dgrad_epilogue` takes the Hopper kernels (bf16, K,
    N_a and N_b multiples of 8, both weights with the same stride-1 index,
    the activations ``acts`` readable by the TMA, the (3, N) coefficients
    ``vecs`` 16-byte aligned, at least one row), else "simt"."""
    k, na = w_a.shape
    nb = w_b.shape[1]
    ok = (x.dtype == torch.bfloat16 and x.shape[0] >= 1
          and all(d % 8 == 0 and d >= 8 for d in (k, na, nb))
          and w_a.dtype == w_b.dtype == torch.bfloat16
          and all(_tma_ok(t) for t in (x, w_a, w_b) + tuple(acts))
          and all(_bulk_ok(v) for v in vecs)
          and (w_a.stride(0) == 1) == (w_b.stride(0) == 1))
    return "sm90" if ok else "simt"


@functools.lru_cache(maxsize=256)
def sm90_wgrad_split(m: int, na: int, nb: int, k: int, sms: int,
                     taps: int = 1):
    """(splits, chunk) of the Hopper route's dW launch: the row range cut
    into ``splits`` chunks of a multiple of 64 rows, each chunk one block per
    output tile ((ceil(na / 128) + ceil(nb / 128)) x taps x ceil(k / bn)
    tiles; ``taps`` 9 for the 3x3 wgrad, one tap per column tile). The
    count minimises the waves of blocks over ``sms`` SMs times a chunk's
    rows, plus the float32 partials each split adds; ties go to fewer."""
    bn = sm90_bn(k)
    tiles = (-(-na // SM90_BM) - (-nb // SM90_BM)) * taps * -(-k // bn)
    row_s = _SM90_ROW_S * bn / 256
    part_s = (na + nb) * taps * k * 4 * 2 / _HBM_BYTES_S
    best = None
    for s in range(1, min(-(-m // SM90_BK), 64) + 1):
        chunk = -(-(-(-m // s)) // SM90_BK) * SM90_BK
        splits = -(-m // chunk)
        t = -(-tiles * splits // sms) * chunk * row_s + splits * part_s
        if best is None or t < best[0]:
            best = (t, splits, chunk)
    return best[1], best[2]


def _wgrad(name, ks, x, a, b, g, dzn, yout, gc, m, c, n, h, w):
    """dW in the gluon order (N, ks * ks * C), float32."""
    rows = ks * ks * c
    splits, chunk = _wgrad_split(m, rows, n, x.device)
    ws = torch.empty((splits, n, rows), dtype=torch.float32, device=x.device)
    code = kernel_library().mxt_conv_fused_wgrad(
        _DTYPE_CODE[x.dtype], ks, _ptr(x), _ptr(a), _ptr(b), _ptr(g),
        _ptr(dzn), _ptr(yout), _ptr(gc), _ptr(ws), splits, chunk, m, c, n,
        h, w, current_stream_handle(x))
    check_launch(code, name)
    return ws.sum(0)


def _g_operands(name, g, dzn, yout, gcoef, m, n, dtype):
    if g is not None:
        return _rows_of(name, g, (m, n), dtype), None, None, None
    if gcoef is None or tuple(gcoef.shape) != (3, n):
        raise ValueError(f"{name}: pass g, or dzn, yout and gcoef (3, {n})")
    return (None, _rows_of(name, dzn, (m, n), dtype),
            _rows_of(name, yout, (m, n), dtype),
            gcoef.to(torch.float32).contiguous())


@counted_kernel
def mm_fused(x, w, a=None, b=None, sc=None, asc=None, bsc=None, bias=None,
             stats: bool = True, emit_xhat: bool = False, _route=None):
    """CUDA kernel of the fused 1x1 conv forward (replaces the Pallas
    ``mm_fused``): x (M, K) contiguous float32 or bfloat16, w (K, N) of the
    same type with any strides. Returns (y[, stats (2, N)][, xhat]). The
    route is :func:`mm_fused_route`'s; ``_route="simt"`` forces the SIMT
    kernel (to time it beside the Hopper one; the lane never passes it)."""
    _check("mm_fused", x, w, a, b, sc, asc, bsc, bias)
    m, k = x.shape
    n = w.shape[1]
    if w.shape[0] != k:
        raise ValueError(f"mm_fused: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)}")
    if sc is not None and a is None:
        raise ValueError("mm_fused: the entry form needs a and b")
    if _route not in (None, "simt"):
        raise ValueError(f"mm_fused: _route {_route!r}")
    x = _rows_of("mm_fused", x, (m, k), x.dtype)
    sc = _rows_of("mm_fused", sc, (m, k), x.dtype)
    a, b = _vec("mm_fused", a, k), _vec("mm_fused", b, k)
    asc, bsc = _vec("mm_fused", asc, k), _vec("mm_fused", bsc, k)
    bias = _vec("mm_fused", bias, n)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    parts = (torch.empty((_blocks(m), 2, n), dtype=torch.float32,
                         device=x.device) if stats else None)
    xhat = torch.empty_like(x) if emit_xhat else None
    lib = kernel_library()
    stream = current_stream_handle(x)
    if (_route or mm_fused_route(x, w, sc, (a, b, asc, bsc))) == "sm90":
        code = lib.mxt_conv_fused_sm90_fwd(
            _ptr(x), _ptr(a), _ptr(b), _ptr(sc), _ptr(asc), _ptr(bsc),
            _ptr(w), w.stride(0), w.stride(1), _ptr(bias), _ptr(y),
            _ptr(parts), _ptr(xhat), m, k, n, sm90_bn(n), stream)
        check_launch(code, "mm_fused")
        mm_fused.sm90_launches += 1
    else:
        code = lib.mxt_conv_fused_fwd(
            _DTYPE_CODE[x.dtype], 1, _ptr(x), _ptr(a), _ptr(b), _ptr(sc),
            _ptr(asc), _ptr(bsc), _ptr(w), 0, w.stride(0), w.stride(1),
            _ptr(bias), _ptr(y), _ptr(parts), _ptr(xhat), m, k, n, 1, 1,
            stream)
        check_launch(code, "mm_fused")
    mm_fused.launches += 1
    out = [y]
    if stats:
        out.append(parts.sum(0))
    if emit_xhat:
        out.append(xhat)
    return tuple(out)


@counted_kernel
def mm_fused_bwd(w, x, g=None, dzn=None, yout=None, gcoef=None, a=None,
                 b=None, dsc=None, partners=(), out_mask: str = "none",
                 out_dtype=None, _route=None):
    """CUDA kernels of the fused 1x1 conv backward (replace the Pallas
    ``mm_fused_bwd``): one launch for dz and the partials, one for dW.
    Returns (dz (M, K), dW (K, N) float32, partials (1 + P, K) float32);
    dW is a view of a (N, K) tensor, the gluon weight order. The route is
    :func:`mm_fused_bwd_route`'s; on the Hopper route the dgrad launch
    also writes the bf16 G (when formed on load) and x^ = relu(a x + b)
    (when a is passed), the wgrad's operands. ``_route="simt"`` forces the
    SIMT kernels."""
    _check("mm_fused_bwd", x, w, g, dzn, yout, a, b, dsc, *partners)
    m, k = x.shape
    n = w.shape[1]
    if w.shape[0] != k:
        raise ValueError(f"mm_fused_bwd: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)}")
    if out_mask not in _MASK_CODE:
        raise ValueError(f"mm_fused_bwd: out_mask {out_mask!r}")
    if out_mask == "z" and a is None:
        raise ValueError("out_mask='z' masks on the load transform "
                         "z = a*x + b; pass a and b")
    if out_dtype not in (None, x.dtype):
        raise TypeError(f"mm_fused_bwd: out_dtype must be x's ({x.dtype})")
    if len(partners) > 2:
        raise ValueError("mm_fused_bwd: at most 2 partners")
    if _route not in (None, "simt"):
        raise ValueError(f"mm_fused_bwd: _route {_route!r}")
    name = "mm_fused_bwd"
    x = _rows_of(name, x, (m, k), x.dtype)
    g, dzn, yout, gc = _g_operands(name, g, dzn, yout, gcoef, m, n, x.dtype)
    dsc = _rows_of(name, dsc, (m, k), x.dtype)
    ps = [_rows_of(name, p, (m, k), x.dtype) for p in partners]
    a, b = _vec(name, a, k), _vec(name, b, k)
    n_p = len(ps)
    dz = torch.empty_like(x)
    part = torch.empty((_blocks(m), 1 + n_p, k), dtype=torch.float32,
                       device=x.device)
    lib = kernel_library()
    stream = current_stream_handle(x)
    p0 = _ptr(ps[0]) if n_p > 0 else None
    p1 = _ptr(ps[1]) if n_p > 1 else None
    if (_route or mm_fused_bwd_route(x, w, (g, dzn, yout, dsc, *ps),
                                     (a, b, gc))) == "sm90":
        # the dgrad launch writes the wgrad's operands: G (unless g is
        # passed) and x^ (when a is passed; else x^ is x)
        gm = g if g is not None else torch.empty((m, n), dtype=x.dtype,
                                                 device=x.device)
        xh = torch.empty_like(x) if a is not None else x
        code = lib.mxt_conv_fused_sm90_bwd_dgrad(
            _ptr(g), _ptr(dzn), _ptr(yout), _ptr(gc), _ptr(w), w.stride(0),
            w.stride(1), None if g is not None else _ptr(gm), _ptr(x),
            _ptr(a), _ptr(b), _ptr(dsc), p0, p1, n_p, _MASK_CODE[out_mask],
            _ptr(dz), _ptr(part), _ptr(xh) if a is not None else None, m, k,
            n, sm90_bn(k), stream)
        check_launch(code, name)
        splits, chunk = sm90_wgrad_split(m, n, 0, k, sm_count(x.device))
        ws = torch.empty((splits, n, k), dtype=torch.float32,
                         device=x.device)
        code = lib.mxt_conv_fused_sm90_dual_wgrad(
            _ptr(xh), _ptr(gm), None, _ptr(ws), splits, chunk, m, k, n, 0,
            sm90_bn(k), stream)
        check_launch(code, name)
        mm_fused_bwd.sm90_launches += 1
        dw = ws.sum(0)
    else:
        code = lib.mxt_conv_fused_dgrad(
            _DTYPE_CODE[x.dtype], 1, _ptr(g), _ptr(dzn), _ptr(yout),
            _ptr(gc), _ptr(w), 0, w.stride(0), w.stride(1), _ptr(x), _ptr(a),
            _ptr(b), _ptr(dsc), p0, p1, n_p, _MASK_CODE[out_mask], _ptr(dz),
            _ptr(part), m, k, n, 1, 1, stream)
        check_launch(code, name)
        dw = _wgrad(name, 1, x, a, b, g, dzn, yout, gc, m, k, n, 1, 1)
    mm_fused_bwd.launches += 1
    return dz, dw.t(), part.sum(0)


@counted_kernel
def dgrad_epilogue(w_a, w_b, x, dzn_a, yout_a, gcoef_a, dzn_b, yout_b,
                   gcoef_b, out_dtype=None, _route=None):
    """CUDA kernels of the dual 1x1 dgrad (replace the Pallas
    ``dgrad_epilogue``): one launch for dx = G_a w_a^T + G_b w_b^T, with
    both G formed on load and the two products meeting in one float32
    accumulator, one for dW_a and dW_b off the one x. w_a (K, N_a), w_b
    (K, N_b) of x's type with any strides. Returns (dx (M, K), dW_a
    (K, N_a) float32, dW_b (K, N_b) float32); the dW are views of (N, K)
    tensors, the gluon weight order. The route is
    :func:`dgrad_epilogue_route`'s; ``_route="simt"`` forces the SIMT
    kernels."""
    name = "dgrad_epilogue"
    _check(name, x, w_a, w_b, dzn_a, yout_a, gcoef_a, dzn_b, yout_b, gcoef_b)
    m, k = x.shape
    na, nb = w_a.shape[1], w_b.shape[1]
    if w_a.shape[0] != k or w_b.shape[0] != k or w_b.dtype != x.dtype:
        raise ValueError(f"{name}: x {tuple(x.shape)}, w_a "
                         f"{tuple(w_a.shape)} {w_a.dtype}, w_b "
                         f"{tuple(w_b.shape)} {w_b.dtype}")
    if out_dtype not in (None, x.dtype):
        raise TypeError(f"{name}: out_dtype must be x's ({x.dtype})")
    if _route not in (None, "simt"):
        raise ValueError(f"{name}: _route {_route!r}")
    x = _rows_of(name, x, (m, k), x.dtype)
    _, dzn_a, yout_a, gc_a = _g_operands(name, None, dzn_a, yout_a, gcoef_a,
                                         m, na, x.dtype)
    _, dzn_b, yout_b, gc_b = _g_operands(name, None, dzn_b, yout_b, gcoef_b,
                                         m, nb, x.dtype)
    dx = torch.empty_like(x)
    lib = kernel_library()
    stream = current_stream_handle(x)
    sm90 = (_route or dgrad_epilogue_route(
        x, w_a, w_b, (dzn_a, yout_a, dzn_b, yout_b), (gc_a, gc_b))) == "sm90"
    if sm90:
        # the dgrad launch also writes the bf16 G of both sets, which the
        # wgrad launch multiplies with x
        bn = sm90_bn(k)
        g_a = torch.empty((m, na), dtype=x.dtype, device=x.device)
        g_b = torch.empty((m, nb), dtype=x.dtype, device=x.device)
        code = lib.mxt_conv_fused_sm90_dual_dgrad(
            _ptr(dzn_a), _ptr(yout_a), _ptr(gc_a), _ptr(w_a), w_a.stride(0),
            w_a.stride(1), _ptr(g_a), _ptr(dzn_b), _ptr(yout_b), _ptr(gc_b),
            _ptr(w_b), w_b.stride(0), w_b.stride(1), _ptr(g_b), _ptr(dx), m,
            k, na, nb, bn, stream)
        check_launch(code, name)
        splits, chunk = sm90_wgrad_split(m, na, nb, k, sm_count(x.device))
    else:
        code = lib.mxt_conv_fused_dual_dgrad(
            _DTYPE_CODE[x.dtype], _ptr(dzn_a), _ptr(yout_a), _ptr(gc_a),
            _ptr(w_a), w_a.stride(0), w_a.stride(1), _ptr(dzn_b),
            _ptr(yout_b), _ptr(gc_b), _ptr(w_b), w_b.stride(0),
            w_b.stride(1), _ptr(dx), m, k, na, nb, stream)
        check_launch(code, name)
        splits, chunk = _wgrad_split(m, k, na + nb, x.device)
    ws = torch.empty((splits, na + nb, k), dtype=torch.float32,
                     device=x.device)
    if sm90:
        code = lib.mxt_conv_fused_sm90_dual_wgrad(
            _ptr(x), _ptr(g_a), _ptr(g_b), _ptr(ws), splits, chunk, m, k, na,
            nb, bn, stream)
        check_launch(code, name)
        dgrad_epilogue.sm90_launches += 1
    else:
        code = lib.mxt_conv_fused_dual_wgrad(
            _DTYPE_CODE[x.dtype], _ptr(x), _ptr(dzn_a), _ptr(yout_a),
            _ptr(gc_a), _ptr(dzn_b), _ptr(yout_b), _ptr(gc_b), _ptr(ws),
            splits, chunk, m, k, na, nb, stream)
        check_launch(code, name)
    dgrad_epilogue.launches += 1
    dw = ws.sum(0)
    return dx, dw[:na].t(), dw[na:].t()


def _bhw_rows(name, x2, bhw):
    B, H, W = (int(v) for v in bhw)
    if B * H * W != x2.shape[0]:
        raise ValueError(f"{name}: bhw {bhw} does not tile {x2.shape[0]} "
                         "rows")
    return B, H, W


@counted_kernel
def conv3_fused(x2, w9, a, b, bhw, stats: bool = True, _route=None):
    """CUDA kernel of the fused 3x3 conv forward (replaces the Pallas
    ``conv3_fused``): x2 (B*H*W, C) contiguous NHWC rows, w9 (9, C, N) of
    the same type with any strides. Returns (y (B*H*W, N)[, stats]). The
    route is :func:`conv3_fused_route`'s; ``_route="simt"`` forces the SIMT
    kernel."""
    _check("conv3_fused", x2, w9, a, b)
    m, c = x2.shape
    n = w9.shape[2]
    _, H, W = _bhw_rows("conv3_fused", x2, bhw)
    if tuple(w9.shape[:2]) != (9, c):
        raise ValueError(f"conv3_fused: w9 {tuple(w9.shape)} for C {c}")
    if _route not in (None, "simt"):
        raise ValueError(f"conv3_fused: _route {_route!r}")
    x2 = _rows_of("conv3_fused", x2, (m, c), x2.dtype)
    a, b = _vec("conv3_fused", a, c), _vec("conv3_fused", b, c)
    y = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    parts = (torch.empty((_blocks(m), 2, n), dtype=torch.float32,
                         device=x2.device) if stats else None)
    lib = kernel_library()
    stream = current_stream_handle(x2)
    if (_route or conv3_fused_route(x2, w9, (a, b))) == "sm90":
        code = lib.mxt_conv_fused_sm90_conv3(
            _ptr(x2), _ptr(a), _ptr(b), _ptr(w9), w9.stride(0), w9.stride(1),
            w9.stride(2), _ptr(y), _ptr(parts), m, c, n, H, W,
            sm90_bn(n), stream)
        check_launch(code, "conv3_fused")
        conv3_fused.sm90_launches += 1
    else:
        code = lib.mxt_conv_fused_fwd(
            _DTYPE_CODE[x2.dtype], 3, _ptr(x2), _ptr(a), _ptr(b), None, None,
            None, _ptr(w9), w9.stride(0), w9.stride(1), w9.stride(2), None,
            _ptr(y), _ptr(parts), None, m, c, n, H, W, stream)
        check_launch(code, "conv3_fused")
    conv3_fused.launches += 1
    return (y, parts.sum(0)) if stats else (y,)


@counted_kernel
def conv3_fused_bwd(w9, x2, a, b, dzn, yout, gcoef, bhw, _route=None):
    """CUDA kernels of the fused 3x3 conv backward (replace the Pallas
    ``conv3_fused_bwd``): one launch for dz and the partials, one for dW9.
    Returns (dz (B*H*W, C), dW9 (9, C, N) float32 — a view of a (N, 3, 3,
    C) tensor, the gluon order — and partials (2, C) float32). The route is
    :func:`conv3_fused_bwd_route`'s; on the Hopper route the dgrad launch
    also writes the bf16 G and x^ = relu(a x + b), the wgrad's operands.
    ``_route="simt"`` forces the SIMT kernels."""
    _check("conv3_fused_bwd", x2, w9, a, b, dzn, yout)
    m, c = x2.shape
    n = w9.shape[2]
    _, H, W = _bhw_rows("conv3_fused_bwd", x2, bhw)
    if tuple(w9.shape[:2]) != (9, c):
        raise ValueError(f"conv3_fused_bwd: w9 {tuple(w9.shape)} for C {c}")
    if _route not in (None, "simt"):
        raise ValueError(f"conv3_fused_bwd: _route {_route!r}")
    name = "conv3_fused_bwd"
    x2 = _rows_of(name, x2, (m, c), x2.dtype)
    _, dzn, yout, gc = _g_operands(name, None, dzn, yout, gcoef, m, n,
                                   x2.dtype)
    a, b = _vec(name, a, c), _vec(name, b, c)
    dz = torch.empty_like(x2)
    part = torch.empty((_blocks(m), 2, c), dtype=torch.float32,
                       device=x2.device)
    lib = kernel_library()
    stream = current_stream_handle(x2)
    if (_route or conv3_fused_bwd_route(x2, w9, (dzn, yout),
                                        (a, b, gc))) == "sm90":
        gm = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
        xh = torch.empty_like(x2)
        splits, chunk = sm90_wgrad_split(m, n, 0, c, sm_count(x2.device), 9)
        ws = torch.empty((splits, n, 9 * c), dtype=torch.float32,
                         device=x2.device)
        code = lib.mxt_conv_fused_sm90_conv3_bwd(
            _ptr(dzn), _ptr(yout), _ptr(gc), _ptr(w9), w9.stride(0),
            w9.stride(1), w9.stride(2), _ptr(gm), _ptr(x2), _ptr(a), _ptr(b),
            _ptr(dz), _ptr(part), _ptr(xh), _ptr(ws), splits, chunk, m, c, n,
            H, W, sm90_bn(c), stream)
        check_launch(code, name)
        conv3_fused_bwd.sm90_launches += 1
        dw = ws.sum(0)
    else:
        code = lib.mxt_conv_fused_dgrad(
            _DTYPE_CODE[x2.dtype], 3, None, _ptr(dzn), _ptr(yout), _ptr(gc),
            _ptr(w9), w9.stride(0), w9.stride(1), w9.stride(2), _ptr(x2),
            _ptr(a), _ptr(b), None, _ptr(x2), None, 1, _MASK_CODE["z"],
            _ptr(dz), _ptr(part), m, c, n, H, W, stream)
        check_launch(code, name)
        dw = _wgrad(name, 3, x2, a, b, None, dzn, yout, gc, m, c, n, H, W)
    conv3_fused_bwd.launches += 1
    return dz, dw.reshape(n, 9, c).permute(1, 2, 0), part.sum(0)
