"""int8 x int8 -> int32 products on the int8 tensor cores: the CUDA kernels
``qconv_s8`` and ``qgemm_s8`` (``csrc/quantized.cu``), their plain PyTorch
twins, the requantize epilogue they share, and the plans that route them.

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

Two routes, chosen by shape before the launch (:func:`qconv_plan`,
:func:`qgemm_plan`): the Hopper route (TMA boxes into a swizzled ring,
s8 ``wgmma``, split K where the tiles cannot fill the card) on
channels-last codes, and the first design (``mma.sync`` on an im2col
gather) for the shapes the plan names, as the stem's C 3, and behind the
private ``_route="simple"`` as its yardstick. On both routes the
convolution reads x (N, C, H, W) and w (O, C, kh, kw) in
``torch.channels_last`` memory (NHWC and OHWI) and writes y so; the
wrapper given another layout makes a channels-last copy and counts it
(:func:`layout_copies`). The int8 nets carry their codes so, so no copy
runs there. Results are values: every route equals the twins bit for bit.

CUDA tensors go through the kernels, CPU tensors through the twins (the
callers in ``ops/quantization.py`` choose by device); a kernel wrapper
given anything it cannot take raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from .common import (check_launch, counted_kernel, current_stream_handle,
                     kernel_library, sm_count)

__all__ = ["Requant", "QPlan", "qconv_s8", "qgemm_s8", "qconv_s8_reference",
           "qgemm_s8_reference", "requantize_reference", "conv_out_hw",
           "qconv_plan", "qgemm_plan", "layout_copies"]


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


# ------------------------------------------------------ the Hopper plan
# mirrored from csrc/quantized.cu (kQ* constants, QPlan<BN>)
_BM = 64                    # output rows of a block tile (kQBM)
_BK = 128                   # bytes of K a stage (kQBK)
_SMEM_BUDGET = 108 * 1024   # kQSmemBudget: the ring and the staging tile
_MAX_STAGES = 6             # kQMaxStages
_PAD = 4                    # kQPad: int32 padding of a staging row
_MAX_BOX = 64               # kQMaxBox: rows of a tile
_BLOCKS_PER_SM = 2          # kQBlocksPerSM
_MIN_SPLIT_STAGES = 2       # stages a K split takes at least
_SMS = 132                  # an H100's SMs: the plan's default
SMEM_LIMIT = 227 * 1024


class QPlan(NamedTuple):
    """How a product runs. ``route`` "tma" (the Hopper route) or
    "simple" (the first design), ``why`` what keeps a shape off the
    Hopper route ("" on it). On the Hopper route: the tile width ``bn``;
    a tile's rows, ``nb`` images x ``hb`` output rows x the output width
    (``rows`` in all; the GEMM's 64 units); the tiles; ``nk`` 128-byte
    stages of K; ``splits`` of K (work items a tile); the ring's
    ``stages`` and the block's dynamic shared memory ``smem``; the
    persistent grid's ``blocks`` (two an SM at most)."""

    route: str
    why: str = ""
    bn: int = 0
    hb: int = 0
    nb: int = 0
    rows: int = 0
    m_tiles: int = 0
    n_tiles: int = 0
    nk: int = 0
    splits: int = 1
    stages: int = 0
    smem: int = 0
    blocks: int = 0


def _tma_smem(bn: int):
    """(stages, dynamic shared memory) of a block of tile width ``bn``
    (quantized.cu: QPlan<BN>): the ring beside the staging tile."""
    stage = _BM * _BK + bn * _BK
    staging = max(_BM * (bn + _PAD), bn * (_BM + _PAD)) * 4
    stages = min(_MAX_STAGES, (_SMEM_BUDGET - staging) // stage)
    return stages, stages * stage + staging + 1024


def _tile_width(cols: int) -> int:
    return 32 if cols <= 32 else 64 if cols <= 64 else 128


def _splits(tiles: int, nk: int, blocks: int) -> int:
    """Splits of K so that the work items come near the grid's ``blocks``,
    each split at least ``_MIN_SPLIT_STAGES`` stages deep."""
    if tiles >= blocks:
        return 1
    return max(1, min(blocks // tiles, nk // _MIN_SPLIT_STAGES))


def _tma_plan(bn, hb, nb, rows, m_tiles, cols, nk, sms):
    n_tiles = -(-cols // bn)
    stages, smem = _tma_smem(bn)
    blocks = _BLOCKS_PER_SM * sms
    splits = _splits(m_tiles * n_tiles, nk, blocks)
    return QPlan("tma", "", bn, hb, nb, rows, m_tiles, n_tiles, nk, splits,
                 stages, smem, min(blocks, m_tiles * n_tiles * splits))


@functools.lru_cache(maxsize=1024)
def qconv_plan(x_shape, w_shape, stride=(1, 1), pad=(0, 0), dilate=(1, 1),
               groups: int = 1, sms: int = _SMS) -> QPlan:
    """The route and tiles of ``qconv_s8`` at these shapes. The Hopper
    route takes groups 1, C a multiple of 16 (TMA's 16-byte strides),
    stride 1 or a 1x1 with no padding (read through a map of doubled
    strides), and an output at most 64 wide (a tile is whole output rows
    of one or more images)."""
    n, _, h, w = (int(v) for v in x_shape)
    o, cg, kh, kw = (int(v) for v in w_shape)
    stride, pad, dilate = tuple(stride), tuple(pad), tuple(dilate)
    ho, wo = conv_out_hw(h, w, (kh, kw), stride, pad, dilate)
    if groups != 1:
        why = f"groups {groups}"
    elif cg % 16:
        why = f"C {cg} not a multiple of 16"
    elif stride != (1, 1) and (kh, kw, pad) != (1, 1, (0, 0)):
        why = f"stride {stride} with a {kh}x{kw} kernel and pad {pad}"
    elif wo > _MAX_BOX:
        why = f"output width {wo} > {_MAX_BOX}"
    else:
        why = ""
    if why:
        return QPlan("simple", why)
    hb_max = _MAX_BOX // wo
    if ho <= hb_max:            # whole images: as many as fit
        hb, nb = ho, max(1, min(n, _MAX_BOX // (ho * wo)))
    else:                       # bands of rows of one image, balanced
        bands = -(-ho // hb_max)
        hb, nb = -(-ho // bands), 1
    m_tiles = -(-n // nb) * -(-ho // hb)
    nk = kh * kw * -(-cg // _BK)
    return _tma_plan(_tile_width(o), hb, nb, nb * hb * wo, m_tiles, o, nk,
                     sms)


@functools.lru_cache(maxsize=1024)
def qgemm_plan(n: int, k: int, units: int, sms: int = _SMS) -> QPlan:
    """The route and tiles of ``qgemm_s8``: x (n, k) by w (units, k). The
    Hopper route takes K a multiple of 16 and swaps the operands: 64
    units a tile are wgmma's M, the batch its N (a tile of 32, 64 or
    128)."""
    if k % 16:
        return QPlan("simple", f"K {k} not a multiple of 16")
    return _tma_plan(_tile_width(n), 1, _BM, _BM, -(-units // _BM), n,
                     -(-k // _BK), sms)


_LAYOUT_COPIES = {"x": 0, "w": 0}


def layout_copies():
    """{"x": n, "w": n}: channels-last (or aligned) copies the wrappers
    made of operands given in another layout."""
    return dict(_LAYOUT_COPIES)


def _operand(t, what, channels_last):
    """``t`` as the kernels read it: channels-last (4-D) or row-major,
    16-byte aligned; a counted copy when it is not."""
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    if t.is_contiguous(memory_format=fmt) and t.data_ptr() % 16 == 0:
        return t
    _LAYOUT_COPIES[what] += 1
    return t.clone(memory_format=fmt)


def _check(name, x, w, epi, o, dense=True):
    for t, what in ((x, "x"), (w, "w")):
        if not t.is_cuda:
            raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                             f"{what} on {t.device}")
        if t.dtype != torch.int8:
            raise TypeError(f"{name}: {what} must be int8, got {t.dtype}")
        if dense and not t.is_contiguous():
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


_NO_EPI = Requant(None, False, 0.0, 0.0, False)


def _epi_args(epi):
    e = epi or _NO_EPI
    bias = e.bias.data_ptr() if e.bias is not None else None
    return (bias, int(e.relu), float(e.step), float(e.s127), int(e.zero))


def _launch_simple(name, gemm, x, w, y, epi, dims):
    bias, relu, step, s127, zero = _epi_args(epi)
    code = kernel_library().mxt_qmma_s8(
        gemm, 0 if epi is None else 1, x.data_ptr(), w.data_ptr(),
        y.data_ptr(), bias, *dims, relu, step, s127, zero,
        current_stream_handle(x))
    check_launch(code, name)


def _launch_tma(name, swap, a, b, y, epi, plan, geom):
    """The Hopper route: ``a`` the tiles' rows (x, or the swapped GEMM's
    weight), ``b`` their columns. Under split K the launch's own
    workspace: a slice of partials a split and tile, then a ticket a tile,
    which the launcher zeroes on the stream (a memset node in a graph), so
    no two launches share tickets however their streams or replays
    overlap."""
    bias, relu, step, s127, zero = _epi_args(epi)
    ws = None
    if plan.splits > 1:
        tiles = plan.m_tiles * plan.n_tiles
        ws = torch.empty(plan.splits * tiles * _BM * plan.bn + tiles,
                         dtype=torch.int32, device=a.device)
    g = (ctypes.c_int * 20)(*geom, plan.hb, plan.nb, plan.bn, plan.splits,
                            plan.blocks)
    code = kernel_library().mxt_qtma_s8(
        swap, 0 if epi is None else 1, a.data_ptr(), b.data_ptr(),
        y.data_ptr(), bias, None if ws is None else ws.data_ptr(),
        ctypes.addressof(g), relu, step, s127, zero,
        current_stream_handle(a))
    check_launch(code, name)


@counted_kernel
def qconv_s8(x, w, stride: Sequence[int] = (1, 1),
             pad: Sequence[int] = (0, 0), dilate: Sequence[int] = (1, 1),
             groups: int = 1, epi: Optional[Requant] = None, *,
             _route: Optional[str] = None):
    """CUDA int8 convolution (the reference's ``quantized_conv`` product):
    x (N, C, H, W) int8 by w (O, C / groups, kh, kw) int8, in any memory
    format (channels-last is read as it lies). Returns (N, O, Ho, Wo)
    int32, or int8 codes under ``epi``, in channels-last memory.
    ``_route="simple"`` forces the first design."""
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
    _check("qconv_s8", x, w, epi, o, dense=False)
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
    plan = qconv_plan(tuple(x.shape), tuple(w.shape), (sh, sw), (ph, pw),
                      (dh, dw), groups, sm_count(x.device))
    if _route not in (None, "simple"):
        raise ValueError(f"qconv_s8: unknown route {_route!r}")
    x = _operand(x, "x", True)
    w = _operand(w, "w", True)
    y = torch.empty((n, o, ho, wo), device=x.device,
                    dtype=torch.int32 if epi is None else torch.int8,
                    memory_format=torch.channels_last)
    if plan.route == "tma" and _route is None:
        _launch_tma("qconv_s8", 0, x, w, y, epi, plan,
                    (n, c, h, wd, o, kh, kw, sh, sw, ph, pw, dh, dw, ho, wo))
        qconv_s8.sm90_launches += 1
    else:
        _launch_simple("qconv_s8", 0, x, w, y, epi,
                       (n, c, h, wd, o, kh, kw, sh, sw, ph, pw, dh, dw,
                        groups, ho, wo))
    qconv_s8.launches += 1
    return y


@counted_kernel
def qgemm_s8(x, w, epi: Optional[Requant] = None, *,
             _route: Optional[str] = None):
    """CUDA int8 fully connected product (the reference's
    ``quantized_fully_connected``): x (N, K) int8 times w (units, K) int8
    transposed. Returns (N, units) int32, or int8 codes under ``epi``.
    ``_route="simple"`` forces the first design."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"qgemm_s8: x (N, K) and w (units, K), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    n, k = x.shape
    o = w.shape[0]
    _check("qgemm_s8", x, w, epi, o)
    if n * o >= 2 ** 31:
        raise ValueError("qgemm_s8: outputs of 2^31 elements or more")
    if _route not in (None, "simple"):
        raise ValueError(f"qgemm_s8: unknown route {_route!r}")
    y = torch.empty((n, o), device=x.device,
                    dtype=torch.int32 if epi is None else torch.int8)
    plan = qgemm_plan(n, k, o, sm_count(x.device))
    if plan.route == "tma" and _route is None:
        # swapped: the units are the tiles' rows, the batch their columns
        a = _operand(w, "w", False)
        b = _operand(x, "x", False)
        _launch_tma("qgemm_s8", 1, a, b, y, epi, plan,
                    (o, k, 1, 1, n, 1, 1, 1, 1, 0, 0, 1, 1, 1, 1))
        qgemm_s8.sm90_launches += 1
    else:
        _launch_simple("qgemm_s8", 1, x, w, y, epi,
                       (n, k, 1, 1, o, 1, 1, 1, 1, 0, 0, 1, 1, 1, 1, 1))
    qgemm_s8.launches += 1
    return y
