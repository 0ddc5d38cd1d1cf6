"""The arithmetic of the port's bf16 flash-attention backward on Hopper
(``ops/cuda/csrc/flash_attention_sm90.cu``: ``flash_bwd_dq_wgmma_kernel``
and ``flash_bwd_dkv_wgmma_kernel``), on the CPU.

The kernels need the card, so these tests hold a plain-PyTorch emulation
of what they compute against the JAX package's Pallas kernels
(``_dq_pass_packed``, ``_dkv_pass_packed``, ``_bwd_fused_packed`` and the
head-major ``_dq_pass`` / ``_dkv_pass``, in interpret mode under
``jax.default_matmul_precision("highest")``, as
``tests/test_torch_flash_attention.py`` runs them) on bf16 inputs, from the
same lse and delta, against the port's plain twin, and against float64:

* dq: a block is 128 query rows, two warpgroups of 64; both walk the
  block's 64-key tiles, all of them or, causal, through the block's last
  row's diagonal (a tile a warpgroup's rows do not reach adds zeros);
* dk/dv: a block is 128 keys, two warpgroups of 64; both walk 64-query
  tiles from the first one at or below the block's first key's diagonal
  (causal) or from the first;
* within a tile, S and dP, and the gradient products after them, run a
  part of the tile at a time where the plan says so (dq 32 keys at d 64,
  dk/dv 32 or 16 queries at d 32 or 64);
* the packed layout scales q once in bf16 (by the scale rounded to bf16)
  before Q.K^T and uses it again in dK = dS^T (q scale); dq takes the
  scale at the end; the head-major layout scales the float32 scores and
  dS;
* P = 2^(s c - lse log2(e)), c = s_mul log2(e), masked entries (a key past
  the last one, or after its query under the top-left causal rule) 0;
  dS = P (dP - delta), rounded to bf16 before dQ and dK; P rounded to
  bf16 before dV; every product accumulated in float32.

The plans, the tile walks and the grids are read from the source. Inputs
come from numpy with a seed. The tolerance is the one the card holds the
bf16 gradients to (``chip_smoke.TRAIN_TOL[bf16]``: 5e-2, a few bf16 ulps
of entries of order 1 summed over 128-512 keys), since
``tests/test_torch_flash_attention.py`` states float32's only.
"""
import importlib
import math
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import chip_smoke
from incubator_mxnet_tpu_torch.ops.cuda import common
from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as tfa

jfa = importlib.import_module(
    "incubator_mxnet_tpu.ops.pallas.flash_attention")

SRC = (Path(tfa.__file__).resolve().parent / "csrc" /
       "flash_attention_sm90.cu").read_text()
BINDINGS = (Path(tfa.__file__).resolve().parent / "csrc" /
            "bindings.cpp").read_text()
CONST = {k: int(v) for k, v in
         re.findall(r"constexpr int (k[FB]\w+) = (\d+);", SRC)}
ROWS, KEYS = CONST["kFRows"], CONST["kFKeys"]
WG = ROWS // 2
TOL = chip_smoke.TRAIN_TOL[torch.bfloat16][1]
LOG2E = 1.4426950408889634
B, T, H = 2, 128, 4


def _bf16(*shape, seed):
    a = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    return torch.from_numpy(a).to(torch.bfloat16)


def _head_major(t, n_heads):
    if n_heads is None:
        return t
    b, s, hd = t.shape
    return t.view(b, s, n_heads, hd // n_heads).permute(0, 2, 1, 3)


def _packed(t, n_heads):
    if n_heads is None:
        return t
    b, h, s, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(b, s, h * d)


def _rows_hm(t, n_heads):
    return t if n_heads is None else t.permute(0, 2, 1)


def _round(x):
    return x.to(torch.bfloat16).float()


def _query(qh, scale, n_heads):
    """(the query as float32, the scores' factor s_mul)."""
    if n_heads is not None:
        return _round(qh.float() * _round(torch.tensor(scale))), 1.0
    return qh.float(), scale


def _dq_tiles(q0, sq, sk, causal):
    """Key tiles a dq block from row q0 walks (the kernel's ``n_blk``)."""
    nk = -(-sk // KEYS)
    return min(nk, (min(q0 + ROWS, sq) - 1) // KEYS + 1) if causal else nk


def _dkv_first(k0, causal):
    """The first query tile of a dk/dv block from key k0 (``qt0``)."""
    return k0 // KEYS if causal else 0


def emu_wgmma_backward(q, k, v, dout, lse, delta, causal, scale,
                       n_heads=None):
    """(dq, dk, dv) in bf16 of the two kernels on bf16 q, k, v, dout and
    the forward's float32 lse and delta, warpgroup by warpgroup, tile by
    tile and, within a tile, product by product (the plan's columns of one
    S product)."""
    qh, kh, vh, gh = (_head_major(t, n_heads) for t in (q, k, v, dout))
    l2 = _rows_hm(lse, n_heads).float() * torch.tensor(LOG2E)
    dl = _rows_hm(delta, n_heads).float()
    b, h, sq, d = qh.shape
    sk = kh.shape[2]
    qs, s_mul = _query(qh, scale, n_heads)
    c = torch.tensor(s_mul, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    kf, vf, gf = kh.float(), vh.float(), gh.float()
    ds_mul = 1.0 if n_heads is not None else scale
    plan = tfa.flash_wgmma_bwd_plan(d)
    nq_cols, kv_cols = plan["dq_cols"], plan["dkv_cols"]

    def p_ds(s, dp, lrow, drow, masked):
        p = torch.exp2(s * c - lrow).masked_fill(masked, 0.0)
        ds = p * (dp - drow)
        return p, ds * ds_mul if ds_mul != 1.0 else ds

    dq = torch.zeros((b, h, sq, d))
    for r0 in range(0, sq, WG):                # a warpgroup of a dq block
        r1 = min(r0 + WG, sq)
        rows = torch.arange(r0, r1)[:, None]
        acc = torch.zeros((b, h, r1 - r0, d))
        for kt in range(_dq_tiles(r0 - r0 % ROWS, sq, sk, causal)):
            for k0 in range(kt * KEYS, min(sk, (kt + 1) * KEYS), nq_cols):
                kk = slice(k0, k0 + nq_cols)
                cols = k0 + torch.arange(min(nq_cols, sk - k0))[None, :]
                s = qs[:, :, r0:r1] @ kf[:, :, kk].transpose(-1, -2)
                dp = gf[:, :, r0:r1] @ vf[:, :, kk].transpose(-1, -2)
                _, ds = p_ds(s, dp, l2[:, :, r0:r1, None],
                             dl[:, :, r0:r1, None], (cols > rows) & causal)
                acc = acc + _round(ds) @ kf[:, :, kk]
        dq[:, :, r0:r1] = acc * scale if n_heads is not None else acc
    dk = torch.zeros((b, h, sk, d))
    dv = torch.zeros((b, h, sk, d))
    nq = -(-sq // KEYS)
    for kw0 in range(0, sk, WG):               # a warpgroup of a dk/dv block
        kw1 = min(kw0 + WG, sk)
        keys = torch.arange(kw0, kw1)[:, None]
        acc_k = torch.zeros((b, h, kw1 - kw0, d))
        acc_v = torch.zeros((b, h, kw1 - kw0, d))
        for qt in range(_dkv_first(kw0 - kw0 % ROWS, causal), nq):
            for q0 in range(qt * KEYS, min(sq, (qt + 1) * KEYS), kv_cols):
                qq = slice(q0, q0 + kv_cols)
                qcols = q0 + torch.arange(min(kv_cols, sq - q0))[None, :]
                st = kf[:, :, kw0:kw1] @ qs[:, :, qq].transpose(-1, -2)
                dpt = vf[:, :, kw0:kw1] @ gf[:, :, qq].transpose(-1, -2)
                p, ds = p_ds(st, dpt, l2[:, :, None, qq], dl[:, :, None, qq],
                             (keys > qcols) & causal)
                acc_v = acc_v + _round(p) @ gf[:, :, qq]
                acc_k = acc_k + _round(ds) @ qs[:, :, qq]
        dk[:, :, kw0:kw1] = acc_k
        dv[:, :, kw0:kw1] = acc_v
    return tuple(_packed(t.to(torch.bfloat16), n_heads) for t in (dq, dk, dv))


def _inputs(layout, seed, d=32, sq=T, sk=T, causal=True, scale=None):
    """bf16 q, k, v, dout and the forward's lse and delta (the port's
    plain forward twin, as the backward's caller forms delta)."""
    if layout == "packed":
        shapes = ((B, sq, H * d), (B, sk, H * d), (B, sk, H * d),
                  (B, sq, H * d))
        n_heads = H
    else:
        shapes = ((B, H, sq, d), (B, H, sk, d), (B, H, sk, d),
                  (B, H, sq, d))
        n_heads = None
    q, k, v, g = (_bf16(*s, seed=seed + i) for i, s in enumerate(shapes))
    scale = scale or 1.0 / math.sqrt(d)
    out, lse = tfa.flash_forward_reference(q, k, v, causal=causal,
                                           scale=scale, n_heads=n_heads)
    prod = g.float() * out.float()
    delta = (prod.view(B, sq, H, d).sum(-1) if n_heads
             else prod.sum(-1))
    return (q, k, v, g, lse, delta), n_heads, scale


def _max_err(a, b):
    return float((torch.as_tensor(np.asarray(a, np.float32))
                  - torch.as_tensor(np.asarray(b, np.float32))
                  ).abs().max())


def _f(t):
    return t.float().numpy()


# ------------------------------------------------- against the references
@pytest.mark.parametrize("causal", [False, True])
def test_emulation_matches_the_packed_pallas_passes_in_bf16(causal):
    """Packed: the emulation against ``_dq_pass_packed``,
    ``_dkv_pass_packed`` and the fused ``_bwd_fused_packed``, from the
    same lse and delta."""
    ops, n_heads, scale = _inputs("packed", seed=10, causal=causal)
    jq, jk, jv, jg = (jnp.asarray(_f(t)).astype(jnp.bfloat16)
                      for t in ops[:4])
    jl, jd = (jnp.asarray(t.numpy()) for t in ops[4:])
    with jax.default_matmul_precision("highest"):
        jdq = jfa._dq_pass_packed(jq, jk, jv, jg, jl, jd, H, scale, causal,
                                  64, 64)
        jdk, jdv = jfa._dkv_pass_packed(jq, jk, jv, jg, jl, jd, H, scale,
                                        causal, 64, 64)
        fused = jfa._bwd_fused_packed(jq, jk, jv, jg, jl, jd, H, scale,
                                      causal, 64, 64)
    emu = emu_wgmma_backward(*ops, causal, scale, n_heads)
    for e, j, f in zip(emu, (jdq, jdk, jdv), fused):
        assert e.dtype == torch.bfloat16
        assert _max_err(_f(e), np.asarray(j, np.float32)) <= TOL
        assert _max_err(_f(e), np.asarray(f, np.float32)) <= TOL


@pytest.mark.parametrize("causal", [False, True])
def test_emulation_matches_the_head_major_pallas_passes_in_bf16(causal):
    ops, n_heads, scale = _inputs("head_major", seed=20, causal=causal)
    jq, jk, jv, jg = (jnp.asarray(_f(t)).astype(jnp.bfloat16)
                      for t in ops[:4])
    jl, jd = (jnp.asarray(t.numpy()) for t in ops[4:])
    with jax.default_matmul_precision("highest"):
        jdq = jfa._dq_pass(jq, jk, jv, jg, jl, jd, scale, causal, 64, 64)
        jdk, jdv = jfa._dkv_pass(jq, jk, jv, jg, jl, jd, scale, causal, 64,
                                 64)
    emu = emu_wgmma_backward(*ops, causal, scale, n_heads)
    for e, j in zip(emu, (jdq, jdk, jdv)):
        assert _max_err(_f(e), np.asarray(j, np.float32)) <= TOL


def _float64(q, k, v, dout, lse, delta, causal, scale, n_heads):
    """dq, dk and dv in float64 from the bf16 inputs, lse and delta (the
    packed query scaled in bf16 first, as every bf16 route does)."""
    qh, kh, vh, gh = (_head_major(t, n_heads).double()
                      for t in (q, k, v, dout))
    qs, s_mul = _query(_head_major(q, n_heads), scale, n_heads)
    qs = qs.double()
    s = (qs @ kh.transpose(-1, -2)) * s_mul
    if causal:
        keep = (torch.arange(s.shape[-2])[:, None]
                >= torch.arange(s.shape[-1])[None, :])
        s = s.masked_fill(~keep, -1e30)
    p = torch.exp(s - _rows_hm(lse, n_heads).double()[..., None])
    ds = p * (gh @ vh.transpose(-1, -2)
              - _rows_hm(delta, n_heads).double()[..., None])
    if n_heads is None:
        ds = ds * scale
    dq = ds @ kh * (scale if n_heads is not None else 1.0)
    return tuple(_packed(t, n_heads) for t in (
        dq, ds.transpose(-1, -2) @ qs, p.transpose(-1, -2) @ gh))


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("layout", ["packed", "head_major"])
def test_emulation_is_as_close_to_float64_as_the_twin(layout, d):
    """At each head dim, the emulation's error against the float64
    function is at most twice the plain twin's (both round dS and P to
    bf16), or 2^-6 where that is larger, and within the tolerance."""
    ops, n_heads, scale = _inputs(layout, seed=30 + d, d=d)
    emu = emu_wgmma_backward(*ops, True, scale, n_heads)
    twin = tfa.flash_backward_reference(*ops, causal=True, scale=scale,
                                        n_heads=n_heads)
    exact = _float64(*ops, True, scale, n_heads)
    for e, t, x in zip(emu, twin, exact):
        err_e = float((e.double() - x).abs().max())
        err_t = float((t.double() - x).abs().max())
        assert err_e <= max(2 * err_t, 2.0 ** -6) and err_e <= TOL


@pytest.mark.parametrize("sq,sk", [(200, 200), (96, 160), (160, 96),
                                   (1, 7), (300, 64), (64, 300)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("layout", ["packed", "head_major"])
def test_emulation_matches_the_twin_on_ragged_shapes(layout, causal, sq, sk):
    """Tail tiles (T 200), sq != sk (key tiles no query reaches under the
    top-left causal mask: their dk and dv are zero; query rows past every
    key), one row, warpgroups with no rows or keys (sq 300 or sk 300 leave
    the last block's second warpgroup 44, sq 1 none)."""
    ops, n_heads, _ = _inputs(layout, seed=40, sq=sq, sk=sk, causal=causal,
                              scale=0.17)
    emu = emu_wgmma_backward(*ops, causal, 0.17, n_heads)
    twin = tfa.flash_backward_reference(*ops, causal=causal, scale=0.17,
                                        n_heads=n_heads)
    for e, t in zip(emu, twin):
        assert e.shape == t.shape
        assert _max_err(_f(e), _f(t)) <= TOL


# ------------------------------------------------------ from the source
def test_backward_plan_mirrors_the_source():
    """FlashBwdPlan as the source writes it, mirrored by
    ``flash_wgmma_bwd_plan``: the block's own two 128-row tiles (Q and dO,
    or K and V), three stages of two 64-row tiles, 1 KB of alignment; two
    blocks an SM up to d 64 (128 registers a thread), one at d 128; the
    columns of one S product, a part of the tile that divides it; the
    launch bounds and the 228 KB an SM."""
    assert CONST["kBStages"] == 3
    for line in (
            "static constexpr int kOwn = kFRows * D * 2;",
            "static constexpr int kTile = kFKeys * D * 2;",
            "static constexpr int kSmem = 2 * kOwn + kBStages * 2 * kTile "
            "+ 1024;",
            "static constexpr int kDqBlocks = D <= 64 ? 2 : 1;",
            "static constexpr int kDqCols = D == 64 ? 32 : 64;",
            "static constexpr int kDkvBlocks = D <= 64 ? 2 : 1;",
            "static constexpr int kDkvCols = D == 32 ? 32 : D == 64 ? 16 : "
            "64;",
            "__launch_bounds__(kFThreads, FlashBwdPlan<D>::kDqBlocks)\n"
            "flash_bwd_dq_wgmma_kernel",
            "__launch_bounds__(kFThreads, FlashBwdPlan<D>::kDkvBlocks)\n"
            "flash_bwd_dkv_wgmma_kernel",
            "mbar_init(&fullq[s], 1 + 32);"):
        assert line in SRC, line
    for d in (32, 64, 128):
        plan = tfa.flash_wgmma_bwd_plan(d)
        smem = 2 * ROWS * d * 2 + 3 * 2 * KEYS * d * 2 + 1024
        blocks = 2 if d <= 64 else 1
        assert plan == {"rows": ROWS, "keys": KEYS, "queries": KEYS,
                        "stages": 3, "threads": CONST["kFThreads"],
                        "row_bytes": 128 if d >= 64 else 64,
                        "smem_bytes": smem, "dq_blocks": blocks,
                        "dq_cols": 32 if d == 64 else 64,
                        "dkv_blocks": blocks,
                        "dkv_cols": {32: 32, 64: 16, 128: 64}[d]}
        assert blocks * (smem + 2048) <= 228 * 1024
        assert 65536 // (blocks * plan["threads"]) >= (
            128 if d <= 64 else 255)
        for cols in (plan["dq_cols"], plan["dkv_cols"]):
            assert KEYS % cols == 0 and cols % 16 == 0
        # dk/dv's lse and delta slots ride beside the ring
        assert smem + 2 * 3 * KEYS * 4 <= 227 * 1024
    with pytest.raises(ValueError):
        tfa.flash_wgmma_bwd_plan(16)


@pytest.mark.parametrize("sq,sk", [(200, 200), (96, 160), (160, 96),
                                   (512, 512), (300, 64), (1, 7)])
@pytest.mark.parametrize("causal", [False, True])
def test_walks_cover_every_pair_once(sq, sk, causal):
    """dq's walk (a block's ``n_blk``) and dk/dv's (``qt0`` to the last
    query tile), as the source writes them, each visit every (query, key)
    pair the mask keeps exactly once, warpgroup by warpgroup."""
    for line in (
            "p.causal ? min(nk, (min(q0 + kFRows, p.sq) - 1) / kFKeys + 1) "
            ": nk;",
            "const int qt0 = p.causal ? k0 / QN : 0;",
            "const int n_blk = max(0, (p.sq + QN - 1) / QN - qt0);"):
        assert line in SRC, line
    keep = np.ones((sq, sk), bool)
    if causal:
        keep &= np.arange(sk)[None, :] <= np.arange(sq)[:, None]
    seen = np.zeros((sq, sk), int)
    for r0 in range(0, sq, WG):
        for kt in range(_dq_tiles(r0 - r0 % ROWS, sq, sk, causal)):
            seen[r0:r0 + WG, kt * KEYS:(kt + 1) * KEYS] += 1
    assert (seen[keep] == 1).all() and (seen[~keep] <= 1).all()
    seen[:] = 0
    for kw0 in range(0, sk, WG):
        for qt in range(_dkv_first(kw0 - kw0 % ROWS, causal),
                        -(-sq // KEYS)):
            seen[qt * KEYS:(qt + 1) * KEYS, kw0:kw0 + WG] += 1
    assert (seen[keep] == 1).all() and (seen[~keep] <= 1).all()


@pytest.mark.parametrize("t", [512, 200, 2048])
def test_grids_launch_the_longest_blocks_first(t):
    """dq's grid is (B H, q-tiles) with blockIdx.y 0 the last q-tile, dk/dv's
    (B H, k-tiles) with blockIdx.y 0 the first: under the causal mask both
    launch their longest walks first."""
    for line in (
            "dim3(B * p.H, (p.sq + kFRows - 1) / kFRows)",
            "dim3(B * p.H, (p.sk + kFRows - 1) / kFRows)",
            "const int k0 = blockIdx.y * kFRows;"):
        assert line in SRC, line
    n = -(-t // ROWS)
    dq = [_dq_tiles((n - 1 - y) * ROWS, t, t, True) for y in range(n)]
    dkv = [-(-t // KEYS) - _dkv_first(y * ROWS, True) for y in range(n)]
    assert dq == sorted(dq, reverse=True)
    assert dkv == sorted(dkv, reverse=True)


def test_the_library_exports_the_backward_entry_points():
    """mxt_flash_bwd_dq_sm90 and mxt_flash_bwd_dkv_sm90 are in
    bindings.cpp with as many parameters as their ctypes signatures."""
    for fn in ("mxt_flash_bwd_dq_sm90", "mxt_flash_bwd_dkv_sm90"):
        params = re.search(rf"int {fn}\(([^)]*)\)", BINDINGS).group(1)
        assert len(params.split(",")) == len(common._SIGNATURES[fn])


# ------------------------------------------------------------- the route
@pytest.mark.parametrize("route", [None, "wmma"])
@pytest.mark.parametrize("n_heads", [None, H])
@pytest.mark.parametrize("kernel", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_bf16_backward_refuses_cpu_tensors_on_either_route(kernel, n_heads,
                                                           route):
    """Neither bf16 route runs the plain twin: CPU tensors raise before
    the route is read, and nothing is counted on either counter."""
    tfa.reset_launch_counts()
    layout = "head_major" if n_heads is None else "packed"
    ops = _inputs(layout, seed=5)[0]
    fn = getattr(tfa, kernel)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(*ops, causal=True, n_heads=n_heads, _route=route)
    assert fn.launches == 0 and fn.sm90_launches == 0

