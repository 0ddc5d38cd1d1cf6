"""The arithmetic of the port's float32 route of ``mm_fused``,
``conv3_fused``, ``dgrad_epilogue``, ``mm_fused_bwd`` and
``conv3_fused_bwd`` (``ops/cuda/csrc/conv_fused_sm90.cu``:
``cf90_fwd_x3_kernel``, ``cf90_conv3_x3_kernel``,
``cf90_dual_dgrad_x3_kernel``, ``cf90_bwd_dgrad_x3_kernel``,
``cf90_dual_wgrad_x3_kernel``, ``cf90_conv3_dgrad_x3_kernel``,
``cf90_conv3_wgrad_x3_kernel`` and ``cf90_split3_kernel``), on the
CPU.

The kernels need the card, so these tests hold a plain-PyTorch emulation
of what they compute against the JAX package's Pallas kernels (interpret
mode under ``jax.default_matmul_precision("highest")``, with
``MXTPU_FUSED_IMPL=pallas`` and ``MXTPU_FUSED_CONV3=pallas``, as
``tests/test_torch_conv_fused.py`` runs them; where a shape does not tile
the Pallas grid, the JAX function's own dispatch takes its XLA twin) and
against float64:

* the load transform in float32 with both roundings of each step
  (relu(a x + b), relu(a x + b + asc sc + bsc); G = (dzn g0 - g1) -
  yout g2), the halo and the reduction tail masked after it;
* every float32 operand of a product split into three bf16 pieces,
  hi + mid + lo == x exactly;
* each 32-deep stage runs the six piece products (lo.hi, hi.lo, mid.mid,
  mid.hi, hi.mid, hi.hi, in that order) into a fresh float32 partial,
  which is then added to the running sum in stage order;
* the 1x1 forward's bias added in float32 before the store, x^ emitted
  in float32;
* the 3x3 as nine tap-shifted stages a 32-channel slice; its stats summed
  over the stored y per 128-row block in four 32-row ranges, in order;
* the dual dgrad over set a's stages then set b's into one accumulator,
  and the wgrad on G's and x's pieces, one float32 partial per row split
  (``sm90_wgrad_split(..., x3=True)``), the partials summed in order;
* the 1x1 backward's dgrad over G's 32-column stages (G direct or formed
  on load), dsc added and the mask (none, x > 0, a x + b > 0) applied
  after the product, its partials sum dz and sum dz p_j in the kernel's
  order (16 ranges of 8 rows a 128-row block, then the blocks), and its
  wgrad on G's and x^'s pieces, the dual wgrad's with one set;
* the 3x3 backward's dgrad (``cf90_conv3_dgrad_x3_kernel``) over nine
  mirrored tap-shifted stages of 32 G columns, G formed on load and the
  halo masked after it, the mask on z = a x + b and its partials (x its
  own partner) in the kernel's order, and its wgrad
  (``cf90_conv3_wgrad_x3_kernel``) on G's and the tap-shifted x^'s pieces,
  one float32 partial per row split (``sm90_wgrad_split(..., 9,
  x3=True)``), the partials summed in order.

The stage plan and the product order are read from the source. Inputs
come from numpy with a seed. The tolerance is ``CONV_TOL[float32]``: 1e-4
of the largest entry (max |a - b| / max(1, max |b|)).
"""
import ctypes
import importlib
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from incubator_mxnet_tpu_torch.ops.cuda import conv_fused as tcf

jcf = importlib.import_module("incubator_mxnet_tpu.ops.pallas.conv_fused")

TOL = 1e-4                 # CONV_TOL[float32]
DEPTH = 32                 # the float32 route's stage depth (kBK3)
# (A piece, B piece) of the six products of a stage, smallest first
ORDER = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))
SRC = (Path(tcf.__file__).resolve().parent / "csrc" / "conv_fused_sm90.cu"
       ).read_text()


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("MXTPU_FUSED_IMPL", "pallas")
    monkeypatch.setenv("MXTPU_FUSED_CONV3", "pallas")


def _rand(rs, *shape, positive=False):
    a = rs.randn(*shape).astype(np.float32)
    return np.abs(a) + 0.5 if positive else a


def _err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want))))


def _np(t):
    return np.asarray(jnp.asarray(t, jnp.float32)) if not isinstance(
        t, torch.Tensor) else t.detach().double().numpy()


# ----------------------------------------------------------- the split
def _split3(x):
    """x (float32) as three float32 tensors holding bf16 values, hi + mid
    + lo == x: ``split3`` / ``cf90_split3_kernel``, one round-to-nearest
    bf16 cast a piece, each residual exact in float32."""
    hi = x.to(torch.bfloat16).float()
    r1 = x - hi
    mid = r1.to(torch.bfloat16).float()
    return hi, mid, (r1 - mid).to(torch.bfloat16).float()


def _split_values(kind):
    rs = np.random.RandomState(7)
    if kind == "xhat":           # relu(a x + b): zeros and positives
        x = np.maximum(rs.randn(4096) * (np.abs(rs.randn(4096)) + 0.5)
                       + rs.randn(4096), 0.0)
    elif kind == "G":            # the BN backward's G over many scales
        x = rs.randn(4096) * 10.0 ** rs.randint(-8, 9, 4096)
    elif kind == "weights":      # He-scaled weights and their tails
        x = rs.randn(4096) * np.sqrt(2.0 / 2304) * 10.0 ** rs.randint(
            -6, 2, 4096)
    else:                        # near float32's extremes, and zeros
        top = np.float32(2.0 ** 128 * (1 - 2.0 ** -9))
        x = np.array([0.0, -0.0, 3.3e38, -3.3e38, 1e38, np.nextafter(
            top, np.float32(0)), 2.0 ** -110, -(2.0 ** -110), 1e-33,
            3.0 * 2.0 ** -110, 1.0, -1.0, 1 + 2.0 ** -23])
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.mark.parametrize("kind", ["xhat", "G", "weights", "extremes"])
def test_three_bf16_pieces_hold_a_float32_exactly(kind):
    """hi + mid + lo == x exactly for 0 and every |x| in [2^-110,
    2^128 (1 - 2^-9)); each piece is a bf16 value."""
    x = _split_values(kind)
    pieces = _split3(x)
    for p in pieces:
        assert torch.equal(p.to(torch.bfloat16).float(), p)
    total = sum(p.double() for p in pieces)
    exact = (x == 0) | (x.abs() >= 2.0 ** -110)
    assert bool(exact.all()) or kind == "extremes"
    assert torch.equal(total[exact], x.double()[exact])
    assert float((total - x.double()).abs().max()) <= 2.0 ** -134


class _SplitLibrary:
    """Stands in for the kernel library's ``mxt_conv_fused_sm90_split3`` on
    the CPU: reads each record {src, s_i, s_j, R, O, dst} of the
    descriptor and writes ``_split3``'s pieces of the strided float32
    source to dst (3, R, O) bf16, as ``cf90_split3_kernel`` does."""

    def __init__(self):
        self.launches = []

    def mxt_conv_fused_sm90_split3(self, n, desc, stream):
        self.launches.append(n)
        for k in range(n):
            src, s_i, s_j, r, o, dst = desc[6 * k:6 * k + 6]
            extent = (r - 1) * s_i + (o - 1) * s_j + 1
            flat = np.ctypeslib.as_array(
                ctypes.cast(src, ctypes.POINTER(ctypes.c_float)), (extent,))
            v = torch.from_numpy(np.lib.stride_tricks.as_strided(
                flat, (r, o), (4 * s_i, 4 * s_j)).copy())
            pieces = torch.stack(_split3(v)).to(torch.bfloat16).contiguous()
            ctypes.memmove(dst, pieces.data_ptr(), 2 * pieces.numel())
        return 0


def test_split_launch_takes_every_operand_in_one_call(monkeypatch):
    """``_pieces`` packs the dual dgrad's three operands (W_a^T and W_b^T
    from the gluon views, x) into one descriptor, one launch and one
    allocation: each view (3, R, O) holds its operand's pieces and starts
    16-byte aligned (the TMA's rule); the 3x3's W9 goes alone. The record
    layout is the source's."""
    assert "const long long* d = desc + 6 * k;" in SRC
    assert "constexpr int kSplitOps = 3;" in SRC
    lib = _SplitLibrary()
    monkeypatch.setattr(tcf, "kernel_library", lambda: lib)
    monkeypatch.setattr(tcf, "current_stream_handle", lambda t: 0)
    rs = np.random.RandomState(3)
    m, k, na, nb = 70, 24, 16, 40
    w_a = torch.from_numpy(_rand(rs, na, k)).t()        # (K, N_a), K unit
    w_b = torch.from_numpy(_rand(rs, nb, k)).t()
    x = torch.from_numpy(_rand(rs, m, k))
    views = tcf._pieces("dgrad_epilogue",
                        (w_a, na, k, w_a.stride(1), w_a.stride(0)),
                        (w_b, nb, k, w_b.stride(1), w_b.stride(0)),
                        (x, m, k, k, 1))
    assert lib.launches == [3]
    assert len({v.untyped_storage().data_ptr() for v in views}) == 1
    for view, want in zip(views, (w_a.t(), w_b.t(), x)):
        assert view.dtype == torch.bfloat16 and view.data_ptr() % 16 == 0
        assert view.shape == (3,) + tuple(want.shape)
        assert torch.equal(view.float(), torch.stack(_split3(want)))
        assert torch.equal(view.float().sum(0, dtype=torch.float64),
                           want.double())
    c, n = 16, 24
    w9 = torch.from_numpy(_rand(rs, n, 3, 3, c)).permute(1, 2, 3, 0).reshape(
        9, c, n)                                        # the gluon view
    wp, = tcf._pieces("conv3_fused",
                      (w9, 9 * c, n, w9.stride(1), w9.stride(2)))
    assert lib.launches == [3, 1]
    assert torch.equal(wp.float(), torch.stack(_split3(w9.reshape(9 * c, n))))


# ---------------------------------------------- the kernels' arithmetic
def _stage(a, b, order=ORDER):
    """One stage's products into a fresh float32 partial: a (M, d) and
    b (d, N) float32, d <= 32, each split in three pieces."""
    sa, sb = _split3(a), _split3(b)
    part = None
    for i, j in order:
        prod = sa[i] @ sb[j]
        part = prod if part is None else part + prod
    return part


def _mm_x3(a, b, order=ORDER):
    """a @ b as the float32 route forms it: 32-deep stages in order, each
    stage's products into a fresh partial added to the running sum."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], DEPTH):
        acc = acc + _stage(a[:, k0:k0 + DEPTH], b[k0:k0 + DEPTH], order)
    return acc


def _stats_in_kernel_order(y):
    """(2, N) sums of y and y^2 as ``store_tile_f32`` and the wrapper form
    them: per 128-row block, four ranges of 32 rows each summed row by row
    (y^2 by a fused multiply-add), the ranges added in order, then the
    blocks' rows summed (``parts.sum(0)``)."""
    rows = []
    for m0 in range(0, y.shape[0], 128):
        blk = y[m0:m0 + 128]
        t1 = t2 = torch.zeros(y.shape[1])
        for p in range(4):
            s1 = s2 = torch.zeros(y.shape[1])
            for r in range(32 * p, min(blk.shape[0], 32 * p + 32)):
                s1 = s1 + blk[r]
                s2 = (blk[r].double() ** 2 + s2.double()).float()
            t1, t2 = t1 + s1, t2 + s2
        rows.append(torch.stack([t1, t2]))
    return torch.stack(rows).sum(0)


def conv3_x3(x2, w9, a, b, bhw, stats=True, order=ORDER):
    """``cf90_conv3_x3_kernel`` emulated: x^ = relu(a x + b) in float32;
    stage (tap, 32-channel slice): the tile's rows shifted by the tap,
    those whose tapped pixel leaves their own image zeroed, the slice's
    channels of x^ against W9[tap]'s rows, six products."""
    B, H, W = bhw
    M, C = x2.shape
    xh = torch.clamp(x2 * a + b, min=0.0)
    m = torch.arange(M)
    hh, ww = (m // W) % H, m % W
    acc = torch.zeros(M, w9.shape[2])
    for tap in range(9):
        r, s = divmod(tap, 3)
        inside = ((hh + r - 1 >= 0) & (hh + r - 1 < H)
                  & (ww + s - 1 >= 0) & (ww + s - 1 < W))
        rows = torch.zeros(M, C)
        rows[inside] = xh[m[inside] + (r - 1) * W + (s - 1)]
        for c0 in range(0, C, DEPTH):
            acc = acc + _stage(rows[:, c0:c0 + DEPTH],
                               w9[tap, c0:c0 + DEPTH], order)
    return (acc, _stats_in_kernel_order(acc)) if stats else (acc,)


def _g(dzn, yout, gc):
    return (dzn * gc[0] - gc[1]) - yout * gc[2]


def dgrad_epilogue_x3(w_a, w_b, x, dzn_a, yout_a, gc_a, dzn_b, yout_b,
                      gc_b, sms=132, order=ORDER):
    """``cf90_dual_dgrad_x3_kernel`` then ``cf90_dual_wgrad_x3_kernel``
    emulated: both G formed in float32; dx over set a's 32-column stages,
    then set b's, into one accumulator; dW_set^T per row split (32-row
    stages of G's and x's pieces), the split partials summed in order."""
    ga, gb = _g(dzn_a, yout_a, gc_a), _g(dzn_b, yout_b, gc_b)
    M, K = x.shape
    na, nb = ga.shape[1], gb.shape[1]
    dx = torch.zeros(M, K)
    for g, w in ((ga, w_a), (gb, w_b)):
        wt = w.t()
        for n0 in range(0, g.shape[1], DEPTH):
            dx = dx + _stage(g[:, n0:n0 + DEPTH], wt[n0:n0 + DEPTH], order)
    splits, chunk = tcf.sm90_wgrad_split(M, na, nb, K, sms, x3=True)
    dw = None
    for sp in range(splits):
        rows = slice(sp * chunk, min(M, (sp + 1) * chunk))
        part = torch.cat([_mm_x3(g[rows].t().contiguous(), x[rows], order)
                          for g in (ga, gb)])
        dw = part if dw is None else dw + part
    return dx, dw[:na].t(), dw[na:].t()


# --------------------------------------------------------------- conv3
# (B, H, C, N): 3x3 maps of 7, 9 and 14 with 1-3 images; C 24 and 72 leave
# a channel tail in a 32-deep stage, N 136 a partial column tile; the
# Pallas kernel runs where nb H W tiles its grid (B 2 at 14), the JAX
# function's XLA twin elsewhere
C3_CASES = [(1, 7, 16, 32), (3, 7, 24, 40), (2, 9, 72, 16),
            (1, 14, 32, 24), (2, 14, 40, 136), (3, 9, 8, 8)]


def _conv3_inputs(case, seed):
    B, H, C, N = case
    rs = np.random.RandomState(seed)
    x2 = _rand(rs, B * H * H, C)
    w9 = _rand(rs, 9, C, N) * np.float32(0.2)
    a, b = _rand(rs, C, positive=True), _rand(rs, C)
    return (B, H, H), x2, w9, a, b


def _conv3_f64(x2, w9, a, b, bhw):
    """y in float64 from the float32 x^ (the reference's rounding point),
    and its stats."""
    B, H, W = bhw
    xh = torch.clamp(x2 * a + b, min=0.0).double()
    C, N = w9.shape[1], w9.shape[2]
    x4 = xh.reshape(B, H, W, C).permute(0, 3, 1, 2)
    w4 = w9.double().reshape(3, 3, C, N).permute(3, 2, 0, 1)
    y = torch.nn.functional.conv2d(x4, w4, padding=1).permute(
        0, 2, 3, 1).reshape(-1, N)
    return y, torch.stack([y.sum(0), (y * y).sum(0)])


@pytest.mark.parametrize("stats", [True, False])
@pytest.mark.parametrize("case", C3_CASES)
def test_conv3_emulation_matches_pallas_twin_and_float64(case, stats):
    bhw, x2, w9, a, b = _conv3_inputs(case, 20 + sum(case))
    t = [torch.from_numpy(v) for v in (x2, w9, a, b)]
    emu = conv3_x3(*t, bhw, stats)
    twin = tcf.conv3_fused_reference(*t, bhw, stats)
    nb = 2 if bhw[1] == 14 and bhw[0] % 2 == 0 else None
    with jax.default_matmul_precision("highest"):
        # the reference's Pallas path always takes a stats output
        jout = jcf.conv3_fused(*(jnp.asarray(v) for v in (x2, w9, a, b)),
                               bhw, True, block_b=nb)
    y64, st64 = _conv3_f64(*t, bhw)
    refs64 = (y64, st64) if stats else (y64,)
    assert len(emu) == len(twin) == len(refs64)
    for e, tw, j, r64 in zip(emu, twin, jout, refs64):
        assert _err(_np(e), _np(tw)) <= TOL
        assert _err(_np(e), _np(j)) <= TOL
        assert _err(_np(e), r64.numpy()) <= TOL


@pytest.mark.parametrize("case", C3_CASES[:4])
def test_conv3_six_products_hold_float32_and_one_does_not(case):
    """Against float64 the six products read no worse than the plain
    float32 twin (within 1e-6 of the largest entry) and well under the
    tolerance; the bf16 product alone (hi.hi) reads above it."""
    bhw, x2, w9, a, b = _conv3_inputs(case, 40 + sum(case))
    t = [torch.from_numpy(v) for v in (x2, w9, a, b)]
    y64 = _conv3_f64(*t, bhw)[0].numpy()
    six = _err(_np(conv3_x3(*t, bhw, False)[0]), y64)
    twin = _err(_np(tcf.conv3_fused_reference(*t, bhw, False)[0]), y64)
    one = _err(_np(conv3_x3(*t, bhw, False, order=((0, 0),))[0]), y64)
    assert six <= twin + 1e-6 and six <= TOL / 10
    assert one > TOL


def test_conv3_halo_is_masked_after_the_transform():
    """relu(a 0 + b) > 0 on every channel: a tap that leaves the image
    contributes nothing, which only masking after the transform gives."""
    bhw = (2, 7, 7)
    rs = np.random.RandomState(3)
    x2 = torch.from_numpy(_rand(rs, 98, 16))
    w9 = torch.from_numpy(_rand(rs, 9, 16, 8))
    a = torch.from_numpy(_rand(rs, 16, positive=True))
    b = torch.full((16,), 2.0)
    emu = conv3_x3(x2, w9, a, b, bhw, False)[0]
    assert _err(_np(emu), _conv3_f64(x2, w9, a, b, bhw)[0].numpy()) <= TOL
    # the padding taken through the transform instead reads far off
    xp = torch.nn.functional.pad(
        x2.reshape(2, 7, 7, 16).permute(0, 3, 1, 2), (1, 1, 1, 1))
    xh = torch.clamp(xp * a[:, None, None] + b[:, None, None], min=0.0)
    wrong = torch.nn.functional.conv2d(
        xh, w9.reshape(3, 3, 16, 8).permute(3, 2, 0, 1)).permute(
        0, 2, 3, 1).reshape(-1, 8)
    assert _err(_np(wrong), _np(emu)) > 1e-2


# ----------------------------------------------------- the dual dgrad
# (M, K, N_a, N_b): N_a != N_b; N tails of 8 and 24 in a 32-deep stage; K
# 40 and 136 not multiples of the 128-column tile
DUAL_CASES = [(64, 16, 8, 24), (96, 40, 72, 40), (160, 136, 24, 56)]


def _dual_inputs(case, seed):
    M, K, NA, NB = case
    rs = np.random.RandomState(seed)
    arrs = [_rand(rs, K, NA), _rand(rs, K, NB), _rand(rs, M, K)]
    for n in (NA, NB):
        arrs += [_rand(rs, M, n), _rand(rs, M, n),
                 _rand(rs, 3, n) * np.float32(0.5)]
    # (w_a, w_b, x, dzn_a, yout_a, gc_a, dzn_b, yout_b, gc_b)
    return arrs


def _dual_f64(w_a, w_b, x, dzn_a, yout_a, gc_a, dzn_b, yout_b, gc_b):
    ga = _g(dzn_a, yout_a, gc_a).double()
    gb = _g(dzn_b, yout_b, gc_b).double()
    xd = x.double()
    return (ga @ w_a.double().t() + gb @ w_b.double().t(), xd.t() @ ga,
            xd.t() @ gb)


@pytest.mark.parametrize("sms", [2, 132])
@pytest.mark.parametrize("case", DUAL_CASES)
def test_dual_dgrad_emulation_matches_pallas_twin_and_float64(case, sms):
    """``sms`` 2 cuts the wgrad's rows into several splits (chunks of 64),
    132 into as few as the card's would."""
    arrs = _dual_inputs(case, 30 + sum(case))
    t = [torch.from_numpy(v) for v in arrs]
    emu = dgrad_epilogue_x3(*t, sms=sms)
    twin = tcf.dgrad_epilogue_reference(*t)
    with jax.default_matmul_precision("highest"):
        jout = jcf.dgrad_epilogue(*(jnp.asarray(v) for v in arrs),
                                  block_m=16)
    refs64 = _dual_f64(*t)
    for e, tw, j, r64 in zip(emu, twin, jout, refs64):
        assert _err(_np(e), _np(tw)) <= TOL
        assert _err(_np(e), _np(j)) <= TOL
        assert _err(_np(e), r64.numpy()) <= TOL


@pytest.mark.parametrize("case", DUAL_CASES)
def test_dual_wgrad_split_partials_cover_the_rows_once(case):
    """The float32 route's dW split: chunks of a multiple of 64 rows that
    cover M once; cut finer (sms 2) or not at all, the emulated dW agree
    within the tolerance."""
    M, K, NA, NB = case
    for sms in (1, 2, 132):
        splits, chunk = tcf.sm90_wgrad_split(M, NA, NB, K, sms, x3=True)
        assert chunk % 64 == 0 and (splits - 1) * chunk < M <= splits * chunk
    t = [torch.from_numpy(v) for v in _dual_inputs(case, 9)]
    one = dgrad_epilogue_x3(*t, sms=1)
    two = dgrad_epilogue_x3(*t, sms=2)
    for u, v in zip(one[1:], two[1:]):
        assert _err(_np(u), _np(v)) <= TOL


# ------------------------------------------- the mainloop's load forms
@pytest.mark.parametrize("form", ["plain", "bnrelu", "entry"])
def test_three_piece_product_on_every_load_form(form):
    """The float32 route's product on x^ of each load form the fused
    kernels take (x, relu(a x + b), relu(a x + b + asc sc + bsc)), against
    the Pallas ``mm_fused`` and float64, K 72 (a tail of 8)."""
    rs = np.random.RandomState(50)
    M, K, N = 64, 72, 40
    x, w = _rand(rs, M, K), _rand(rs, K, N)
    vecs = dict(a=_rand(rs, K, positive=True), b=_rand(rs, K),
                sc=_rand(rs, M, K), asc=_rand(rs, K), bsc=_rand(rs, K))
    kw = {"plain": {}, "bnrelu": {k: vecs[k] for k in "ab"},
          "entry": vecs}[form]
    tx = torch.from_numpy(x)
    tk = {k: torch.from_numpy(v) for k, v in kw.items()}
    if form == "plain":
        xh = tx
    else:
        z = tx * tk["a"] + tk["b"]
        if form == "entry":
            z = z + tk["sc"] * tk["asc"] + tk["bsc"]
        xh = torch.clamp(z, min=0.0)
    y = _mm_x3(xh, torch.from_numpy(w))
    with jax.default_matmul_precision("highest"):
        jy = jcf.mm_fused(jnp.asarray(x), jnp.asarray(w), stats=False,
                          block_m=16, **{k: jnp.asarray(v)
                                         for k, v in kw.items()})[0]
    assert _err(_np(y), _np(jy)) <= TOL
    assert _err(_np(y), (xh.double() @ torch.from_numpy(w).double())
                .numpy()) <= TOL


# ---------------------------------------------------- mm_fused (float32)
def mm_fused_x3(x, w, a=None, b=None, sc=None, asc=None, bsc=None,
                bias=None, stats=True, emit_xhat=False, order=ORDER):
    """``cf90_fwd_x3_kernel`` emulated: x^ in float32 with
    ``cf90_fwd_kernel``'s operations (a x, + b, then the shortcut's asc sc
    added and bsc, each step rounded, then relu), the columns k >= K zero;
    32-deep stages of six products into a fresh partial each, added in
    stage order; the bias added in float32 before the store; the stats
    summed over the stored y in the kernel's order; x^ as emitted."""
    if a is None:
        xh = x
    else:
        z = x * a + b
        if sc is not None:
            z = z + sc * asc + bsc
        xh = torch.clamp(z, min=0.0)
    y = _mm_x3(xh, w, order)
    if bias is not None:
        y = y + bias
    out = [y]
    if stats:
        out.append(_stats_in_kernel_order(y))
    if emit_xhat:
        out.append(xh)
    return tuple(out)


# (M, K, N): K 16, 40 and 72 leave a tail in a 32-deep stage (x^'s
# columns past K are zero though relu(b) is not), N 136 a partial column
# tile; M a multiple of the Pallas row block, 304 and 208 not of 128
MM_CASES = [(64, 16, 24), (304, 40, 72), (208, 72, 136)]
MM_OPTS = {"bias, stats": dict(bias=True),
           "x^, stats": dict(emit_xhat=True),
           "bias, x^, no stats": dict(bias=True, emit_xhat=True,
                                      stats=False)}


def _mm_inputs(form, case, opts, seed):
    M, K, N = case
    rs = np.random.RandomState(seed)
    x, w = _rand(rs, M, K), _rand(rs, K, N)
    kw = {"bnrelu": dict(a=_rand(rs, K, positive=True), b=_rand(rs, K)),
          "entry": dict(a=_rand(rs, K, positive=True), b=_rand(rs, K),
                        sc=_rand(rs, M, K), asc=_rand(rs, K),
                        bsc=_rand(rs, K)),
          "plain": {}}[form]
    if opts.get("bias"):
        kw["bias"] = _rand(rs, N)
    flags = {k: v for k, v in opts.items() if k != "bias"}
    return x, w, kw, flags


def _mm_f64(x, w, kw, stats, emit_xhat):
    """y, stats and x^ in float64 from the float32 x^ (the reference's
    rounding point)."""
    xh = mm_fused_x3(x, w, **kw, stats=False, emit_xhat=True)[-1]
    y = xh.double() @ w.double()
    if kw.get("bias") is not None:
        y = y + kw["bias"].double()
    out = [y]
    if stats:
        out.append(torch.stack([y.sum(0), (y * y).sum(0)]))
    if emit_xhat:
        out.append(xh.double())
    return out


@pytest.mark.parametrize("opt", list(MM_OPTS))
@pytest.mark.parametrize("case", MM_CASES)
@pytest.mark.parametrize("form", ["plain", "bnrelu", "entry"])
def test_mm_fused_emulation_matches_pallas_twin_and_float64(form, case,
                                                            opt):
    opts = {"stats": True, **MM_OPTS[opt]}
    x, w, kw, flags = _mm_inputs(form, case, opts, 70 + sum(case))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    tk = {k: torch.from_numpy(v) for k, v in kw.items()}
    emu = mm_fused_x3(tx, tw, **tk, **flags)
    twin = tcf.mm_fused_reference(tx, tw, **tk, **flags)
    with jax.default_matmul_precision("highest"):
        jout = jcf.mm_fused(jnp.asarray(x), jnp.asarray(w), block_m=16,
                            **{k: jnp.asarray(v) for k, v in kw.items()},
                            **flags)
    refs64 = _mm_f64(tx, tw, tk, flags["stats"], flags.get("emit_xhat",
                                                           False))
    assert len(emu) == len(twin) == len(jout) == len(refs64)
    for e, t, j, r64 in zip(emu, twin, jout, refs64):
        assert _err(_np(e), _np(t)) <= TOL
        assert _err(_np(e), _np(j)) <= TOL
        assert _err(_np(e), r64.numpy()) <= TOL


@pytest.mark.parametrize("form", ["plain", "entry"])
def test_mm_fused_six_products_hold_float32_and_one_does_not(form):
    """Against float64 the six products read no worse than the plain
    float32 twin (within 1e-6 of the largest entry) and well under the
    tolerance; the bf16 product alone (hi.hi) reads above it."""
    x, w, kw, _ = _mm_inputs(form, (208, 72, 136), {}, 90)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    tk = {k: torch.from_numpy(v) for k, v in kw.items()}
    y64 = _mm_f64(tx, tw, tk, False, False)[0].numpy()
    six = _err(_np(mm_fused_x3(tx, tw, **tk, stats=False)[0]), y64)
    twin = _err(_np(tcf.mm_fused_reference(tx, tw, **tk, stats=False)[0]),
                y64)
    one = _err(_np(mm_fused_x3(tx, tw, **tk, stats=False,
                               order=((0, 0),))[0]), y64)
    assert six <= twin + 1e-6 and six <= TOL / 10
    assert one > TOL


def test_mm_fused_plan_and_transform_are_the_sources():
    """PlanFwdX3: x's raw box (and sc's in the entry form), W's pieces and
    1 KB of a, b, asc and bsc a stage, mirrored by
    ``sm90_x3_plan("fwd", entry)``: four stages, three in the entry form;
    the transform's operations and the tail mask after it, x^ written
    back over its raw box, and the bias in the epilogue, as the
    emulation above forms them."""
    assert ("using PlanFwdX3 = Plan3<(ENTRY ? 2 : 1) * kRaw3, 1024>;"
            in SRC)
    raw, pieces = 128 * DEPTH * 4, 3 * 128 * DEPTH * 2
    for entry, stages in ((False, 4), (True, 3)):
        stage = (2 if entry else 1) * raw + pieces + 1024
        plan = tcf.sm90_x3_plan("fwd", entry=entry)
        assert plan == {"bn": 128, "bk": DEPTH, "stages": stages,
                        "stage_bytes": stage,
                        "smem_bytes": stages * stage + 1024}
        assert plan["smem_bytes"] <= tcf.SM90_SMEM_LIMIT
        assert 4 * 32 * 4 <= 1024             # a, b, asc, bsc slices
    for line in (
            "v0 = affine(v0, ca.x, cb.x);",
            "v0 = __fadd_rn(__fadd_rn(v0, __fmul_rn(s2.x, cs.x)), cd.x);",
            "v0 = fmaxf(v0, 0.f);",
            "if (kl >= kleft) v0 = v1 = 0.f;",
            "*reinterpret_cast<float2*>(st + off) = make_float2(v0, v1);",
            "tma_store_2d(&txh, st + wg * kWgRaw3, k0, m0 + 64 * wg);",
            "v0 = __fadd_rn(v0, b0);"):
        assert line in SRC, line
    # the order: the tail mask after the transform, the write-back after
    # the mask, the split last
    body = SRC[SRC.index("cf90_fwd_x3_kernel(const"):]
    at = [body.index(t) for t in ("fmaxf(v0, 0.f)", "kl >= kleft",
                                  "make_float2(v0, v1)", "split3(v0, v1")]
    assert at == sorted(at)


def test_mm_fused_weight_pieces_come_from_the_gluon_view(monkeypatch):
    """The float32 forward's B is W's (3, K, N) pieces, the output index
    contiguous: from the gluon weight's (K, N) view (strides (1, K)) the
    split kernel takes its transposing path."""
    lib = _SplitLibrary()
    monkeypatch.setattr(tcf, "kernel_library", lambda: lib)
    monkeypatch.setattr(tcf, "current_stream_handle", lambda t: 0)
    rs = np.random.RandomState(4)
    k, n = 40, 24
    w = torch.from_numpy(_rand(rs, n, k)).t()           # (K, N), K unit
    assert w.stride() == (1, k)
    wp, = tcf._pieces("mm_fused", (w, k, n, w.stride(0), w.stride(1)))
    assert lib.launches == [1]
    assert wp.shape == (3, k, n) and wp.data_ptr() % 16 == 0
    assert torch.equal(wp.float(), torch.stack(_split3(w)))


# ------------------------------------------------- mm_fused_bwd (float32)
def _bwd_partials_in_kernel_order(dz, partners):
    """(1 + P, K) sums of dz and dz p_j as ``cf90_bwd_dgrad_x3_kernel`` and
    the wrapper form them: per 128-row block, 16 ranges of 8 rows each
    summed row by row (dz p_j by a fused multiply-add), the ranges added in
    order, then the blocks' rows summed (``part.sum(0)``)."""
    M, K = dz.shape
    blocks = []
    for m0 in range(0, M, 128):
        rows = []
        for pq in (None,) + tuple(partners):
            tot = torch.zeros(K)
            for rr in range(16):
                acc = torch.zeros(K)
                for r in range(m0 + 8 * rr, min(M, m0 + 8 * rr + 8)):
                    acc = (acc + dz[r] if pq is None else
                           (dz[r].double() * pq[r].double()
                            + acc.double()).float())
                tot = tot + acc
            rows.append(tot)
        blocks.append(torch.stack(rows))
    return torch.stack(blocks).sum(0)


def mm_fused_bwd_x3(w, x, g=None, dzn=None, yout=None, gcoef=None, a=None,
                    b=None, dsc=None, partners=(), out_mask="none", sms=132,
                    order=ORDER):
    """``cf90_bwd_dgrad_x3_kernel`` then the single-set
    ``cf90_dual_wgrad_x3_kernel`` emulated: G as it is or formed in
    float32; dz over G's 32-column stages against W^T, six products each;
    dsc, then the mask; the partials in the kernel's order; dW^T per row
    split (32-row stages of G's and x^'s pieces), the split partials
    summed in order."""
    G = g if g is not None else _g(dzn, yout, gcoef)
    M, K = x.shape
    N = w.shape[1]
    wt = w.t()
    dz = torch.zeros(M, K)
    for n0 in range(0, N, DEPTH):
        dz = dz + _stage(G[:, n0:n0 + DEPTH], wt[n0:n0 + DEPTH], order)
    if dsc is not None:
        dz = dz + dsc
    if out_mask == "x":
        dz = torch.where(x > 0.0, dz, 0.0)
    elif out_mask == "z":
        dz = torch.where(x * a + b > 0.0, dz, 0.0)
    xh = torch.clamp(x * a + b, min=0.0) if a is not None else x
    splits, chunk = tcf.sm90_wgrad_split(M, N, 0, K, sms, x3=True)
    dw = None
    for sp in range(splits):
        rows = slice(sp * chunk, min(M, (sp + 1) * chunk))
        part = _mm_x3(G[rows].t().contiguous(), xh[rows], order)
        dw = part if dw is None else dw + part
    return dz, dw.t(), _bwd_partials_in_kernel_order(dz, partners)


# the forms of the card's sweep (chip_smoke._conv_cases), the lane's
# expand form among them; (M, K, N): a K tail in a 128-wide column tile, an
# N tail in a 32-deep stage, several 128-row blocks and a short last one
# (M a multiple of the Pallas kernel's 16-row block)
MMB_FORMS = {
    "direct mask z 1 partner": dict(g=True, ab=True, mask="z", partners=1),
    "bn mask x dsc 2 partners": dict(dsc=True, mask="x", partners=2),
    "bn no mask": dict(mask="none"),
    "direct bnrelu x no mask": dict(g=True, ab=True, mask="none"),
    "expand bn bnrelu mask z partner x": dict(ab=True, mask="z",
                                              partner_x=True),
}
MMB_SHAPES = [(64, 16, 24), (160, 40, 72), (304, 136, 56)]


def _mmb_inputs(form, shape, seed):
    """Numpy operands and the keyword arguments of one form."""
    spec = MMB_FORMS[form]
    M, K, N = shape
    rs = np.random.RandomState(seed)
    x, w = _rand(rs, M, K), _rand(rs, K, N) * np.float32(0.3)
    kw = {"out_mask": spec["mask"]}
    if spec.get("g"):
        kw["g"] = _rand(rs, M, N)
    else:
        kw.update(dzn=_rand(rs, M, N), yout=_rand(rs, M, N),
                  gcoef=_rand(rs, 3, N) * np.float32(0.5))
    if spec.get("ab"):
        kw.update(a=_rand(rs, K, positive=True), b=_rand(rs, K))
    if spec.get("dsc"):
        kw["dsc"] = _rand(rs, M, K)
    parts = ("x",) if spec.get("partner_x") else tuple(
        _rand(rs, M, K) for _ in range(spec.get("partners", 0)))
    return x, w, kw, parts


def _torch_kw(x, kw, parts):
    tk = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
          for k, v in kw.items()}
    tx = torch.from_numpy(x)
    tk["partners"] = tuple(tx if isinstance(p, str) else torch.from_numpy(p)
                           for p in parts)
    return tx, tk


def _mmb_f64(w, x, g=None, dzn=None, yout=None, gcoef=None, a=None, b=None,
             dsc=None, partners=(), out_mask="none"):
    """dz, dW and the partials in float64 from float32 G and x^ (the
    reference's rounding points)."""
    G = (g if g is not None else _g(dzn, yout, gcoef)).double()
    dz = G @ w.double().t()
    if dsc is not None:
        dz = dz + dsc.double()
    zero = torch.zeros((), dtype=torch.float64)
    if out_mask == "x":
        dz = torch.where(x > 0.0, dz, zero)
    elif out_mask == "z":
        dz = torch.where(x * a + b > 0.0, dz, zero)
    xh = (torch.clamp(x * a + b, min=0.0) if a is not None else x).double()
    rows = [dz.sum(0)] + [(dz * p.double()).sum(0) for p in partners]
    return dz, xh.t() @ G, torch.stack(rows)


@pytest.mark.parametrize("shape", MMB_SHAPES)
@pytest.mark.parametrize("form", sorted(MMB_FORMS))
def test_mm_fused_bwd_emulation_matches_pallas_twin_and_float64(form, shape):
    """Every form: G direct or on load; mask none, x or z; with and without
    dsc; 0-2 partners (x its own partner in the lane's expand form)."""
    x, w, kw, parts = _mmb_inputs(form, shape, 40 + sum(shape))
    tx, tk = _torch_kw(x, kw, parts)
    tw = torch.from_numpy(w)
    emu = mm_fused_bwd_x3(tw, tx, **tk)
    twin = tcf.mm_fused_bwd_reference(tw, tx, **tk)
    refs64 = _mmb_f64(tw, tx, **tk)
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    jkw["partners"] = tuple(jnp.asarray(x if isinstance(p, str) else p)
                            for p in parts)
    with jax.default_matmul_precision("highest"):
        jout = jcf.mm_fused_bwd(jnp.asarray(w), jnp.asarray(x), block_m=16,
                                **jkw)
    for e, tw_, j, r64 in zip(emu, twin, jout, refs64):
        assert _err(_np(e), _np(tw_)) <= TOL
        assert _err(_np(e), _np(j)) <= TOL
        assert _err(_np(e), r64.numpy()) <= TOL


@pytest.mark.parametrize("form", ["bn mask x dsc 2 partners",
                                  "expand bn bnrelu mask z partner x"])
def test_mm_fused_bwd_six_products_hold_float32_and_one_does_not(form):
    """The six piece products read within the tolerance of float64; hi.hi
    alone (one bf16 product) reads above it: the control."""
    x, w, kw, parts = _mmb_inputs(form, (160, 136, 72), 7)
    tx, tk = _torch_kw(x, kw, parts)
    tw = torch.from_numpy(w)
    refs64 = _mmb_f64(tw, tx, **tk)
    six = mm_fused_bwd_x3(tw, tx, **tk)
    one = mm_fused_bwd_x3(tw, tx, order=((0, 0),), **tk)
    assert max(_err(_np(e), r.numpy()) for e, r in zip(six, refs64)) <= TOL
    assert max(_err(_np(e), r.numpy()) for e, r in zip(one, refs64)) > TOL


@pytest.mark.parametrize("shape", MMB_SHAPES)
def test_mm_fused_bwd_one_set_wgrad_splits_agree(shape):
    """The single-set wgrad's row split (N_b 0): chunks of a multiple of 64
    rows covering M once; cut finer (sms 2) or not at all (sms 1), dW
    agrees within the tolerance."""
    M, K, N = shape
    for sms in (1, 2, 132):
        splits, chunk = tcf.sm90_wgrad_split(M, N, 0, K, sms, x3=True)
        assert chunk % 64 == 0 and (splits - 1) * chunk < M <= splits * chunk
    x, w, kw, parts = _mmb_inputs("expand bn bnrelu mask z partner x",
                                  shape, 3)
    tx, tk = _torch_kw(x, kw, parts)
    tw = torch.from_numpy(w)
    one = mm_fused_bwd_x3(tw, tx, sms=1, **tk)[1]
    two = mm_fused_bwd_x3(tw, tx, sms=2, **tk)[1]
    assert _err(_np(one), _np(two)) <= TOL


def test_mm_fused_bwd_plan_and_epilogue_are_the_sources():
    """PlanBwdX3: dzn's and yout's boxes, W^T's pieces and 1 KB of g0, g1,
    g2 a stage, at least an epilogue chunk (four 128 x 32 float32 boxes
    and 1 KB of a and b); three stages; the epilogue's 32-column chunks,
    16 row ranges of 8 and x^'s pieces over the partners' boxes, as the
    emulation above sums and writes them; the wgrad takes one set."""
    assert ("using PlanBwdX3 = Plan3<2 * kRaw3, 1024, 4 * kRaw3 + 1024>;"
            in SRC)
    plan = tcf.sm90_x3_plan("bwd")
    raw, pieces = 128 * DEPTH * 4, 3 * 128 * DEPTH * 2
    assert plan["stage_bytes"] == max(2 * raw + pieces + 1024,
                                      4 * raw + 1024) == 66560
    assert plan["stages"] == 3 and plan["smem_bytes"] == 3 * 66560 + 1024
    # the static column sums ride beside the ring within a block's 227 KB
    assert "__shared__ float red[2][16][3][32];" in SRC
    assert plan["smem_bytes"] + 2 * 16 * 3 * 32 * 4 + 2 * 3 * 8 \
        <= tcf.SM90_SMEM_LIMIT
    for line in (
            "const int pc = 2 * (ct & 15), pr = ct >> 4;",
            "for (int r = 8 * pr; r < min(rows, 8 * pr + 8); ++r) {",
            "for (int i = 0; i < 16; ++i) v += red[e & 1][i][q][ct];",
            "unsigned char* xp = st + 2 * kRaw3;",
            "(Nb == 0) != (gp_b == nullptr)"):
        assert line in SRC, line
    # 24 KB of x^'s pieces fit the two partner boxes they are written over
    assert 3 * 128 * DEPTH * 2 <= 2 * raw


# --------------------------------------------- conv3_fused_bwd (float32)
def _tap_inside(M, bhw, dr, ds):
    """Rows m whose pixel shifted by (dr, ds) lies in m's own image."""
    _, H, W = bhw
    m = torch.arange(M)
    hh, ww = (m // W) % H + dr, m % W + ds
    return (hh >= 0) & (hh < H) & (ww >= 0) & (ww < W)


def _shifted(t, M, bhw, dr, ds):
    """t's rows m + dr W + ds where the shifted pixel is in m's image, 0
    elsewhere (the halo)."""
    inside = _tap_inside(M, bhw, dr, ds)
    m = torch.arange(M)[inside]
    out = torch.zeros_like(t)
    out[inside] = t[m + dr * bhw[2] + ds]
    return out


def conv3_bwd_x3(w9, x2, a, b, dzn, yout, gcoef, bhw, sms=132,
                 order=ORDER):
    """``cf90_conv3_dgrad_x3_kernel`` then ``cf90_conv3_wgrad_x3_kernel``
    emulated. dgrad: stage (tap (r, s), 32-column slice of G), tap-major:
    G formed in float32 on the rows m + (1 - r) W + (1 - s), the rows whose
    tapped pixel leaves their image zeroed AFTER the transform (the
    transform of a zero row is -g1), against W9[tap]^T's rows (the pieces
    of the (N, 9 C) transpose), six products into a fresh partial; then the
    mask on z = a x + b and the partials sum dz, sum dz x in the kernel's
    order. wgrad: per row split (``sm90_wgrad_split(..., 9, x3=True)``)
    and tap, 32-row stages of G (its halo rows zeroed) against x^ shifted
    by (r - 1, s - 1), the split partials summed in order."""
    M, C = x2.shape
    N = w9.shape[2]
    G = _g(dzn, yout, gcoef)
    dz = torch.zeros(M, C)
    for tap in range(9):
        r, s = divmod(tap, 3)
        rows = _shifted(G, M, bhw, 1 - r, 1 - s)
        wt = w9[tap].t()
        for n0 in range(0, N, DEPTH):
            dz = dz + _stage(rows[:, n0:n0 + DEPTH], wt[n0:n0 + DEPTH], order)
    z = x2 * a + b
    dz = torch.where(z > 0.0, dz, 0.0)
    xh = torch.clamp(z, min=0.0)
    splits, chunk = tcf.sm90_wgrad_split(M, N, 0, C, sms, 9, x3=True)
    dw = None
    for sp in range(splits):
        rows = slice(sp * chunk, min(M, (sp + 1) * chunk))
        taps = []
        for tap in range(9):
            r, s = divmod(tap, 3)
            inside = _tap_inside(M, bhw, r - 1, s - 1)
            ga = torch.where(inside[:, None], G, 0.0)
            xs = _shifted(xh, M, bhw, r - 1, s - 1)
            taps.append(_mm_x3(ga[rows].t().contiguous(), xs[rows], order))
        part = torch.cat(taps, 1)                    # (N, 9 C), tap C + c
        dw = part if dw is None else dw + part
    dw9 = dw.reshape(N, 9, C).permute(1, 2, 0)
    return dz, dw9, _bwd_partials_in_kernel_order(dz, (x2,))


# (B, H, C, N) of the card's 3x3 sweep: 7, 9 and 14 with 1-3 images (a
# 128-row block spans several images), C 24, 40 and 72 past a 32- or
# 128-wide tile, N 40, 72 and 136 tails in a 32-deep stage; the Pallas
# kernel runs where nb H W tiles its grid, the XLA twin elsewhere
C3B_CASES = [(1, 7, 16, 32), (3, 7, 24, 40), (2, 9, 72, 16),
             (2, 14, 40, 136), (3, 9, 8, 8), (1, 14, 136, 72)]


def _conv3_bwd_inputs(case, seed):
    B, H, C, N = case
    rs = np.random.RandomState(seed)
    M = B * H * H
    x2 = _rand(rs, M, C)
    w9 = _rand(rs, 9, C, N) * np.float32(0.2)
    a, b = _rand(rs, C, positive=True), _rand(rs, C)
    dzn, yout = _rand(rs, M, N), _rand(rs, M, N)
    gc = _rand(rs, 3, N) * np.float32(0.5)
    return (B, H, H), [w9, x2, a, b, dzn, yout, gc]


def _conv3_bwd_f64(w9, x2, a, b, dzn, yout, gcoef, bhw):
    """dz, dW9 and the partials in float64 from the float32 G and x^ (the
    reference's rounding points)."""
    B, H, W = bhw
    C, N = w9.shape[1], w9.shape[2]
    G = _g(dzn, yout, gcoef).double()
    z = x2 * a + b
    xh = torch.clamp(z, min=0.0).double()
    g4 = G.reshape(B, H, W, N).permute(0, 3, 1, 2)
    x4 = xh.reshape(B, H, W, C).permute(0, 3, 1, 2)
    w4 = w9.double().reshape(3, 3, C, N).permute(3, 2, 0, 1)
    dxh = torch.nn.grad.conv2d_input(x4.shape, w4, g4, padding=1).permute(
        0, 2, 3, 1).reshape(-1, C)
    dw4 = torch.nn.grad.conv2d_weight(x4, w4.shape, g4, padding=1)
    dz = torch.where(z > 0.0, dxh, torch.zeros((), dtype=torch.float64))
    p = torch.stack([dz.sum(0), (dz * x2.double()).sum(0)])
    return dz, dw4.permute(2, 3, 1, 0).reshape(9, C, N), p


@pytest.mark.parametrize("sms", [2, 132])
@pytest.mark.parametrize("case", C3B_CASES)
def test_conv3_bwd_emulation_matches_pallas_twin_and_float64(case, sms):
    """dz, dW9 and the partials of the emulated kernels against the port's
    twin, the JAX ``conv3_fused_bwd`` (Pallas in interpret mode where it
    tiles) and float64; ``sms`` 2 cuts the wgrad's rows into several
    splits, 132 into as few as the card's would."""
    bhw, arrs = _conv3_bwd_inputs(case, 60 + sum(case))
    t = [torch.from_numpy(v) for v in arrs]
    emu = conv3_bwd_x3(*t, bhw, sms=sms)
    twin = tcf.conv3_fused_bwd_reference(*t, bhw)
    nb = 2 if bhw[1] == 14 and bhw[0] % 2 == 0 else None
    with jax.default_matmul_precision("highest"):
        jout = jcf.conv3_fused_bwd(*(jnp.asarray(v) for v in arrs), bhw,
                                   block_b=nb)
    refs64 = _conv3_bwd_f64(*t, bhw)
    for e, tw, j, r64 in zip(emu, twin, jout, refs64):
        assert _err(_np(e), _np(tw)) <= TOL
        assert _err(_np(e), _np(j)) <= TOL
        assert _err(_np(e), r64.numpy()) <= TOL


@pytest.mark.parametrize("case", C3B_CASES[:4])
def test_conv3_bwd_six_products_hold_float32_and_one_does_not(case):
    """The six piece products read within the tolerance of float64 in dz,
    dW9 and the partials; hi.hi alone (one bf16 product a stage) reads
    above it: the control."""
    bhw, arrs = _conv3_bwd_inputs(case, 80 + sum(case))
    t = [torch.from_numpy(v) for v in arrs]
    refs64 = _conv3_bwd_f64(*t, bhw)
    six = conv3_bwd_x3(*t, bhw)
    one = conv3_bwd_x3(*t, bhw, order=((0, 0),))
    assert max(_err(_np(e), r.numpy()) for e, r in zip(six, refs64)) <= TOL
    assert max(_err(_np(e), r.numpy()) for e, r in zip(one, refs64)) > TOL


def test_conv3_bwd_halo_is_masked_after_g_is_formed():
    """g1 large on every column: a zero row of dzn and yout transforms to
    -g1, so a halo row masked before the transform (a zero read by the
    box) instead of after it reads far off in dz and dW9."""
    bhw, arrs = _conv3_bwd_inputs((2, 7, 16, 24), 5)
    arrs[6][1] = np.float32(3.0)
    t = [torch.from_numpy(v) for v in arrs]
    emu = conv3_bwd_x3(*t, bhw)
    refs64 = _conv3_bwd_f64(*t, bhw)
    for e, r in zip(emu, refs64):
        assert _err(_np(e), r.numpy()) <= TOL
    # the transform taken through the padding (G of a zero row, -g1)
    B, H, W = bhw
    M, C = t[1].shape
    N = t[0].shape[2]
    dzn4 = torch.nn.functional.pad(
        t[4].reshape(B, H, W, N).permute(0, 3, 1, 2), (1, 1, 1, 1))
    yout4 = torch.nn.functional.pad(
        t[5].reshape(B, H, W, N).permute(0, 3, 1, 2), (1, 1, 1, 1))
    gc = t[6][:, :, None, None]
    gpad = (dzn4 * gc[0] - gc[1]) - yout4 * gc[2]
    w4 = t[0].reshape(3, 3, C, N).permute(3, 2, 0, 1)
    wrong = torch.nn.functional.conv_transpose2d(gpad, w4, padding=2)
    wrong = wrong.permute(0, 2, 3, 1).reshape(-1, C)
    wrong = torch.where(t[1] * t[2] + t[3] > 0.0, wrong, 0.0)
    assert _err(_np(wrong), _np(emu[0])) > 1e-2


@pytest.mark.parametrize("case", C3B_CASES[:3])
def test_conv3_wgrad_split_partials_cover_the_rows_once(case):
    """The 3x3 wgrad's row split (nine taps, one a column tile): chunks of
    a multiple of 64 rows covering M once; cut finer (sms 2) or not at all
    (sms 1), dW9 agrees within the tolerance."""
    B, H, C, N = case
    M = B * H * H
    for sms in (1, 2, 132):
        splits, chunk = tcf.sm90_wgrad_split(M, N, 0, C, sms, 9, x3=True)
        assert chunk % 64 == 0 and (splits - 1) * chunk < M <= splits * chunk
    bhw, arrs = _conv3_bwd_inputs(case, 11)
    t = [torch.from_numpy(v) for v in arrs]
    one = conv3_bwd_x3(*t, bhw, sms=1)[1]
    two = conv3_bwd_x3(*t, bhw, sms=2)[1]
    assert _err(_np(one), _np(two)) <= TOL


def test_conv3_bwd_plans_and_taps_are_the_sources():
    """PlanConv3DgradX3 is PlanBwdX3's stage (dzn's and yout's shifted
    boxes, W9^T's pieces, g0, g1, g2) and epilogue chunk; PlanConv3WgradX3
    the wgrad's G^T pieces beside x^'s; ``sm90_x3_plan("conv3_dgrad")`` and
    ``("conv3_wgrad")`` mirror them, and both fit a block beside the static
    column sums. The tap shifts, the halo mask after G's transform, the
    centre tap's G pieces and the wgrad's shifted x^ box are the
    emulation's; the wrapper splits W9^T as one (N, 9 C) matrix."""
    assert ("using PlanConv3DgradX3 = Plan3<2 * kRaw3, 1024, 4 * kRaw3 + "
            "1024>;" in SRC)
    assert "using PlanConv3WgradX3 = Plan3<3 * kPieceA3, 0>;" in SRC
    raw, pieces = 128 * DEPTH * 4, 3 * 128 * DEPTH * 2
    dgrad = tcf.sm90_x3_plan("conv3_dgrad")
    wgrad = tcf.sm90_x3_plan("conv3_wgrad")
    assert dgrad == tcf.sm90_x3_plan("bwd")
    assert dgrad["stage_bytes"] == max(2 * raw + pieces + 1024,
                                       4 * raw + 1024)
    assert dgrad["stages"] == 3 and wgrad["stages"] == 4
    assert wgrad["stage_bytes"] == 3 * 128 * DEPTH * 2 + pieces
    assert dgrad["smem_bytes"] + 2 * 16 * 3 * 32 * 4 + 2 * 3 * 8 \
        <= tcf.SM90_SMEM_LIMIT
    assert wgrad["smem_bytes"] + 2 * 4 * 8 <= tcf.SM90_SMEM_LIMIT
    for line in (
            "const int shift = TAPS == 1 ? 0 : (1 - tap / 3) * p.W + "
            "1 - tap % 3;",
            "if (kl >= nl || !((q & 1) ? in1 : in0)) v0 = v1 = 0.f;",
            "if (tap == TAPS / 2 && sl % gridDim.x == blockIdx.x)",
            "&full[s], tap * p.K + c0 + 64 * e, r0, j);",
            "&txh, &full[s], c0 + 64 * e, r0 + dr * p.W + ds, j);",
            "bwd_dgrad_x3_tile<9, PlanConv3DgradX3>(",
            "launch<cf90_conv3_wgrad_x3_kernel>(PlanConv3WgradX3::kSmem"):
        assert line in SRC, line
    # the halo after the transform: bn_g first, then the mask, then split
    body = SRC[SRC.index("bwd_dgrad_x3_tile(const CUtensorMap"):]
    at = [body.index(t) for t in ("v0 = bn_g(v.x", "!((q & 1) ? in1 : in0)",
                                  "split3(v0, v1")]
    assert at == sorted(at)
    wrapper = Path(tcf.__file__).read_text()
    assert "(w9, n, 9 * c, w9.stride(2), w9.stride(1))" in wrapper


@pytest.mark.parametrize("layout", ["gluon", "contiguous"])
def test_conv3_bwd_weight_pieces_are_w9_transposed(monkeypatch, layout):
    """The float32 3x3 dgrad's B is W9^T's (3, N, 9 C) pieces, [n, tap C +
    c] = w9[tap, c, n], from the gluon view (strides (C, 1, 9 C)) and from
    a contiguous (9, C, N) weight alike."""
    lib = _SplitLibrary()
    monkeypatch.setattr(tcf, "kernel_library", lambda: lib)
    monkeypatch.setattr(tcf, "current_stream_handle", lambda t: 0)
    rs = np.random.RandomState(6)
    c, n = 16, 24
    if layout == "gluon":
        w9 = torch.from_numpy(_rand(rs, n, 3, 3, c)).permute(
            1, 2, 3, 0).reshape(9, c, n)
        assert w9.stride() == (c, 1, 9 * c)
    else:
        w9 = torch.from_numpy(_rand(rs, 9, c, n))
    wp, = tcf._pieces("conv3_fused_bwd",
                      (w9, n, 9 * c, w9.stride(2), w9.stride(1)))
    want = w9.permute(2, 0, 1).reshape(n, 9 * c)
    assert wp.shape == (3, n, 9 * c) and wp.data_ptr() % 16 == 0
    assert torch.equal(wp.float(), torch.stack(_split3(want)))


# ------------------------------------------------ the plan and the order
def _consts():
    return {k: v for k, v in re.findall(r"constexpr int (k\w+) = ([^;]+);",
                                        SRC)}


def _ternary(expr, pr):
    """Evaluates the source's chain c1 ? v1 : c2 ? v2 : ... : v for pr."""
    parts = [p.strip() for p in re.split(r"[?:]", expr)]
    while len(parts) > 1:
        cond, val, parts = parts[0], parts[1], parts[2:]
        if eval(cond.replace("||", " or "), {"pr": pr}):
            return int(val)
    return int(parts[0])


def test_product_order_is_the_sources():
    body = {f: re.search(rf"int {f}\(int pr\) \{{\s*return ([^;]+);", SRC)
            .group(1) for f in ("prod_a", "prod_b")}
    order = tuple((_ternary(body["prod_a"], pr), _ternary(body["prod_b"], pr))
                  for pr in range(6))
    assert order == ORDER
    # the smallest product first, hi.hi last, every pair of orders <= 2
    assert order[-1] == (0, 0) and all(i + j <= 2 for i, j in order)
    assert len(set(order)) == 6


def test_stage_plan_is_the_sources_and_fits_a_block():
    c = _consts()
    assert int(c["kBK3"].split()[0]) == tcf.SM90_X3_BK == DEPTH
    assert int(c["kBN3"].split()[0]) == tcf.SM90_X3_BN
    assert int(c["kMaxStages3"]) == tcf._SM90_X3_MAX_STAGES
    assert ("static constexpr int kStage = kCoef + COEF > MIN_STAGE ? "
            "kCoef + COEF") in SRC
    assert "using PlanConv3X3 = Plan3<kRaw3, 1024>;" in SRC
    assert "using PlanDgradX3 = Plan3<2 * kRaw3, 1024>;" in SRC
    assert "using PlanWgradX3 = Plan3<3 * kPieceA3, 0>;" in SRC
    raw = 128 * 128                            # kRaw3: 128 rows x 32 floats
    pieces = 3 * 128 * DEPTH * 2               # kB3
    for kernel, stage in (("conv3", raw + pieces + 1024),
                          ("dgrad", 2 * raw + pieces + 1024),
                          ("bwd", max(2 * raw + pieces + 1024,
                                      4 * raw + 1024)),
                          ("wgrad", 3 * 128 * DEPTH * 2 + pieces)):
        plan = tcf.sm90_x3_plan(kernel)
        stages = min(4, 200 * 1024 // stage)
        assert plan == {"bn": 128, "bk": DEPTH, "stages": stages,
                        "stage_bytes": stage,
                        "smem_bytes": stages * stage + 1024}
        assert 3 <= plan["stages"] <= 4
        assert plan["smem_bytes"] + 2 * 4 * 8 <= tcf.SM90_SMEM_LIMIT
        # the epilogue's float32 128 x 128 staging tile and column sums
        assert 128 * 128 * 4 + 2 * 2 * 256 * 4 <= plan["stages"] \
            * plan["stage_bytes"]
