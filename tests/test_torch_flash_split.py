"""The arithmetic of the port's float32 flash-attention route
(``ops/cuda/csrc/flash_attention.cu``, the ``*_mma`` kernels), on the CPU.

The kernels need the card, so these tests hold a plain-PyTorch emulation
of what they compute against the JAX package's Pallas kernels (interpret
mode, ``jax.default_matmul_precision("highest")``, as
``tests/test_torch_flash_attention.py`` runs them) and against float64:

* every float32 operand of a product is split into three bf16 pieces,
  hi + mid + lo == x exactly;
* each 16-deep stage of a product runs the six piece products float32
  needs (lo.hi, hi.lo, mid.mid, mid.hi, hi.mid, hi.hi, in that order) into
  a fresh float32 partial, which is then added to the running result;
* the forward walks 64-key tiles with the online softmax; the backward is
  two passes (dq per q-tile over k-tiles; dk/dv per k-tile over q-tiles);
* the layouts' rounding points are the plain twins' (packed: q scaled in
  float32 first, dq scaled at the end; head-major: scores and ds scaled).

The shared-memory plan and the tile walks are read from the source.
Inputs come from numpy with a seed. Tolerances are the flash test file's:
1e-5 forward, 1e-4 gradients.
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

from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as tfa

jfa = importlib.import_module(
    "incubator_mxnet_tpu.ops.pallas.flash_attention")

B, T, H, D = 2, 128, 4, 32
FWD_ATOL = 1e-5
GRAD_ATOL = 1e-4
NEG_INF = -1e30
TILE = 64          # the kernels' key tile at d 32 and 64
STAGE = 16         # the depth of one mma.sync stage
SRC = (Path(tfa.__file__).resolve().parent / "csrc" / "flash_attention.cu"
       ).read_text()


def _rand(*shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ----------------------------------------------------------- the split
def _split3(x):
    """x (float32) as three float32 tensors holding bf16 values, hi + mid
    + lo == x: the kernels' ``split2``, one round-to-nearest bf16 cast a
    piece, each residual exact in float32."""
    hi = x.to(torch.bfloat16).float()
    r1 = x - hi
    mid = r1.to(torch.bfloat16).float()
    lo = (r1 - mid).to(torch.bfloat16).float()
    return hi, mid, lo


def _split_values(kind):
    rs = np.random.default_rng(7)
    if kind == "qkv":            # inputs and gradients over many scales
        x = rs.standard_normal(4096) * 10.0 ** rs.integers(-30, 31, 4096)
    elif kind == "P":            # softmax weights, down to exp(-76)
        x = np.exp(-rs.uniform(0, 76, 4096))
    elif kind == "dS":           # p (dp - delta): small, either sign
        x = rs.standard_normal(4096) * np.exp(-rs.uniform(0, 60, 4096))
    else:                        # near float32's extremes, and zeros
        top = np.float32(2.0 ** 128 * (1 - 2.0 ** -9))
        x = np.array([0.0, -0.0, 3.3e38, -3.3e38, 1e38, np.nextafter(
            top, np.float32(0)), 2.0 ** -110, -(2.0 ** -110), 1e-33,
            3.0 * 2.0 ** -110, 1.0, -1.0, 1 + 2.0 ** -23])
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.mark.parametrize("kind", ["qkv", "P", "dS", "extremes"])
def test_three_bf16_pieces_hold_a_float32_exactly(kind):
    """hi + mid + lo == x exactly for 0 and every |x| in [2^-110,
    2^128 (1 - 2^-9)) (the range where hi cannot round to infinity and lo
    is no finer than bf16's smallest subnormal); below it the split loses
    at most 2^-134. Each piece is a bf16 value."""
    x = _split_values(kind)
    pieces = _split3(x)
    for p in pieces:
        assert torch.equal(p.to(torch.bfloat16).float(), p)
    total = sum(p.double() for p in pieces)
    exact = (x == 0) | (x.abs() >= 2.0 ** -110)
    assert bool(exact.any())
    assert torch.equal(total[exact], x.double()[exact])
    assert float((total - x.double()).abs().max()) <= 2.0 ** -134


# ---------------------------------------------- the kernels' arithmetic
def _mm6(a, b, acc=None):
    """acc + a @ b as the kernels form it: a (..., M, K) and b (..., K, N)
    float32, K a multiple of 16, both split in three pieces; per 16-deep
    stage the six piece products, smallest first, summed into a fresh
    float32 partial that is then added to acc."""
    sa, sb = _split3(a), _split3(b)
    out = (torch.zeros(a.shape[:-1] + b.shape[-1:]) if acc is None
           else acc.clone())
    for c in range(0, a.shape[-1], STAGE):
        part = None
        for i, j in ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0)):
            prod = sa[i][..., c:c + STAGE] @ sb[j][..., c:c + STAGE, :]
            part = prod if part is None else part + prod
        out = out + part
    return out


def _layout(t, n_heads):
    if n_heads is None:
        return t
    b, s, hd = t.shape
    return t.view(b, s, n_heads, hd // n_heads).permute(0, 2, 1, 3)


def _unlayout(t, n_heads):
    if n_heads is None:
        return t
    b, h, s, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(b, s, h * d)


def _query(q, scale, n_heads):
    """(the query the products see, the factor left for the scores)"""
    if n_heads is None:
        return q, scale
    return q * torch.tensor(scale, dtype=torch.float32), 1.0


def _mask(sq, k0, n, sk, causal):
    rows = torch.arange(sq)[:, None]
    cols = k0 + torch.arange(n)[None, :]
    m = cols >= sk
    return m | (cols > rows) if causal else m


def emu_forward(q, k, v, causal, scale, n_heads=None):
    """(out, lse) of ``flash_fwd_mma_kernel``: 64-key tiles, the online
    softmax in float32, every product through :func:`_mm6`. A q-tile past
    the diagonal would add exact zeros, so every row walks every tile."""
    qh, kh, vh = (_layout(t, n_heads) for t in (q, k, v))
    qs, s_mul = _query(qh, scale, n_heads)
    b, h, sq, d = qh.shape
    sk = kh.shape[2]
    m = torch.full((b, h, sq, 1), NEG_INF)
    l = torch.zeros((b, h, sq, 1))
    o = torch.zeros((b, h, sq, d))
    for k0 in range(0, sk, TILE):
        kt, vt = kh[:, :, k0:k0 + TILE], vh[:, :, k0:k0 + TILE]
        s = _mm6(qs, kt.transpose(-1, -2)) * s_mul
        s = s.masked_fill(_mask(sq, k0, kt.shape[2], sk, causal), NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        o = _mm6(p, vt, o * corr)
        m = m_new
    ls = torch.clamp(l, min=1e-30)
    lse = (m + torch.log(ls))[..., 0]
    return (_unlayout(o / ls, n_heads),
            lse if n_heads is None else lse.permute(0, 2, 1))


def emu_backward(q, k, v, g, lse, delta, causal, scale, n_heads=None):
    """(dq, dk, dv) of ``flash_bwd_dq_mma_kernel`` (dq over 64-key tiles)
    and ``flash_bwd_dkv_mma_kernel`` (dk, dv over 64-row q-tiles), every
    product through :func:`_mm6`, P and dS split in registers."""
    qh, kh, vh, gh = (_layout(t, n_heads) for t in (q, k, v, g))
    lse_h = (lse if n_heads is None else lse.permute(0, 2, 1))[..., None]
    dl_h = (delta if n_heads is None else delta.permute(0, 2, 1))[..., None]
    qs, s_mul = _query(qh, scale, n_heads)
    sq, sk = qh.shape[2], kh.shape[2]

    def ds_of(s, dp, lse_t, dl_t, mask):
        p = torch.exp(s * s_mul - lse_t).masked_fill(mask, 0.0)
        ds = p * (dp - dl_t)
        return p, (ds if n_heads is not None else ds * scale)

    dq = torch.zeros_like(qh)
    for k0 in range(0, sk, TILE):
        kt, vt = kh[:, :, k0:k0 + TILE], vh[:, :, k0:k0 + TILE]
        dp = _mm6(gh, vt.transpose(-1, -2))
        s = _mm6(qs, kt.transpose(-1, -2))
        _, ds = ds_of(s, dp, lse_h, dl_h,
                      _mask(sq, k0, kt.shape[2], sk, causal))
        dq = _mm6(ds, kt, dq)
    if n_heads is not None:
        dq = dq * scale
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    for q0 in range(0, sq, TILE):
        qt, gt = qs[:, :, q0:q0 + TILE], gh[:, :, q0:q0 + TILE]
        st = _mm6(kh, qt.transpose(-1, -2))            # (.., sk, n)
        dpt = _mm6(vh, gt.transpose(-1, -2))
        mask = (torch.arange(sk)[:, None]
                > q0 + torch.arange(qt.shape[2])[None, :]) & causal
        p, ds = ds_of(st, dpt, lse_h[:, :, q0:q0 + TILE, 0][:, :, None],
                      dl_h[:, :, q0:q0 + TILE, 0][:, :, None], mask)
        dv = _mm6(p, gt, dv)
        dk = _mm6(ds, qt, dk)
    return tuple(_unlayout(t, n_heads) for t in (dq, dk, dv))


def _inputs(layout, seed, n=4):
    if layout == "packed":
        return [_rand(B, T, H * D, seed=seed + i) for i in range(n)], H
    return [_rand(B, H, T, D, seed=seed + i) for i in range(n)], None


def _jax_reference(layout, arrays, causal, scale):
    """out, lse and (dq, dk, dv) of the JAX package's Pallas kernels, and
    the delta they used."""
    jq, jk, jv, jg = map(jnp.asarray, arrays)
    with jax.default_matmul_precision("highest"):
        if layout == "packed":
            out, lse = jfa._fwd_packed(jq, jk, jv, H, scale, causal, 64, 64)
            delta = (jg * out).reshape(B, T, H, D).sum(-1)
            grads = jfa._bwd_fused_packed(jq, jk, jv, jg, lse, delta, H,
                                          scale, causal, 64, 64)
        else:
            out, lse = jfa._fwd(jq, jk, jv, scale, causal, 64, 64)
            grads = jfa._bwd(jq, jk, jv, out, lse, jg, scale, causal, 64,
                             64)
            delta = jnp.sum(jg * out, axis=-1)
    return out, lse, delta, grads


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("layout", ["packed", "head_major"])
def test_split_route_emulation_matches_jax(layout, causal):
    arrays, n_heads = _inputs(layout, seed=60)
    scale = 1.0 / math.sqrt(D)
    out, lse, delta, grads = _jax_reference(layout, arrays, causal, scale)
    q, k, v, g = (torch.from_numpy(a) for a in arrays)
    e_out, e_lse = emu_forward(q, k, v, causal, scale, n_heads)
    _close(e_out, out, FWD_ATOL)
    _close(e_lse, lse, FWD_ATOL)
    got = emu_backward(q, k, v, g, torch.from_numpy(np.array(lse)),
                       torch.from_numpy(np.array(delta)), causal, scale,
                       n_heads)
    for a, b in zip(got, grads):
        _close(a, b, GRAD_ATOL)


def _float64_attention(q, k, v, g, lse, delta, causal, scale, n_heads):
    """out, lse, dq, dk, dv in float64 (the packed query scaled in float32
    first, as every float32 route does)."""
    qh, kh, vh, gh = (_layout(t, n_heads) for t in (q, k, v, g))
    qs, s_mul = _query(qh, scale, n_heads)
    s = (qs.double() @ kh.double().transpose(-1, -2)) * s_mul
    if causal:
        s = s.masked_fill(_mask(T, 0, T, T, True), NEG_INF)
    out = torch.softmax(s, -1) @ vh.double()
    lse64 = torch.logsumexp(s, -1)
    lse_h = (lse if n_heads is None else lse.permute(0, 2, 1))[..., None]
    dl_h = (delta if n_heads is None else delta.permute(0, 2, 1))[..., None]
    p = torch.exp(s - lse_h.double())
    ds = p * (gh.double() @ vh.double().transpose(-1, -2) - dl_h.double())
    dq = ds @ kh.double() * scale
    dk = ds.transpose(-1, -2) @ qs.double() * (1.0 if n_heads else scale)
    dv = p.transpose(-1, -2) @ gh.double()
    return (_unlayout(out, n_heads),
            lse64 if n_heads is None else lse64.permute(0, 2, 1),
            *(_unlayout(t, n_heads) for t in (dq, dk, dv)))


@pytest.mark.parametrize("layout", ["packed", "head_major"])
def test_split_route_error_against_float64_is_float32s(layout):
    """Against float64 attention, the emulated split route errs at most
    twice the plain float32 twin (the FMA route's arithmetic). Measured on
    this file's inputs (seed 70, causal), max |x - float64|, split / twin:
    packed out 3.2e-07 / 7.6e-07, lse 4.4e-07 / 5.1e-07, dq 4.2e-07 /
    8.0e-07, dk 4.9e-07 / 1.1e-06, dv 1.2e-06 / 2.9e-06; head-major out
    3.4e-07 / 5.4e-07, lse 4.6e-07 / 4.9e-07, dq 4.5e-07 / 1.1e-06, dk
    6.6e-07 / 1.4e-06, dv 7.0e-07 / 2.3e-06."""
    arrays, n_heads = _inputs(layout, seed=70)
    scale = 1.0 / math.sqrt(D)
    q, k, v, g = (torch.from_numpy(a) for a in arrays)
    out, lse = tfa.flash_forward_reference(q, k, v, causal=True,
                                           scale=scale, n_heads=n_heads)
    prod = g * out
    delta = (prod.view(B, T, H, D).sum(-1) if n_heads else prod.sum(-1))
    twin = (out, lse, *tfa.flash_backward_reference(
        q, k, v, g, lse, delta, causal=True, scale=scale, n_heads=n_heads))
    emu = (*emu_forward(q, k, v, True, scale, n_heads),
           *emu_backward(q, k, v, g, lse, delta, True, scale, n_heads))
    exact = _float64_attention(q, k, v, g, lse, delta, True, scale,
                               n_heads)
    for name, e, t, x in zip(("out", "lse", "dq", "dk", "dv"), emu, twin,
                             exact):
        err_e = float((e.double() - x).abs().max())
        err_t = float((t.double() - x).abs().max())
        assert err_e <= 2 * err_t, (name, err_e, err_t)


# ------------------------------------------------- the plan, from source
SM_BYTES = 228 * 1024      # an H100 SM's shared memory, 1 KB kept a block


def _plan():
    """The kMma* constants, and MmaPlan's rule as a function of (kernel,
    head dim): (streamed rows N, own rows as pieces, shared bytes, blocks
    an SM)."""
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (kMma\w+) = (\d+);", SRC)}
    rows, pad = consts["kMmaRows"], consts["kMmaPad"]
    lo, fwd = consts["kMmaMinBlocks"], consts["kMmaFwdBlocks"]

    def plan(kind, d):
        n = consts[f"kMma{kind}N{d}"]
        own = 1 if kind == "Fwd" else 2
        n_pc = 2 if kind == "Dkv" else 1
        tiles = n * d * 4 + n_pc * 3 * n * (d + pad) * 2
        tail = tiles + (2 * n * 4 if kind == "Dkv" else 0)
        own_pieces = own * 3 * rows * (d + pad) * 2
        pieces = (lo * (own_pieces + tail + 1024) <= SM_BYTES
                  and own * rows * d * 4 <= tiles)
        smem = (own_pieces if pieces else own * rows * (d + pad) * 4) + tail
        blocks = (fwd if kind == "Fwd" and fwd * (smem + 1024) <= SM_BYTES
                  else lo)
        return n, pieces, smem, blocks
    return consts, plan


def test_shared_memory_plan_mirrors_the_source_and_fits_the_blocks():
    """MmaPlan as the source writes it: the own rows as pieces where two
    blocks still fit, the shared memory within a block's 227 KB, at least
    two blocks an SM (228 KB, 1 KB kept a block) at d 32, 64 and 128, the
    forward's three where they fit; 16-deep stages and whole 16-byte chunks
    a thread."""
    consts, plan = _plan()
    assert consts["kMmaRows"] == 64 and consts["kMmaThreads"] == 128
    assert consts["kMmaPad"] == 8
    assert "constexpr int kSmemPerSM = 228 * 1024;" in SRC
    for line in (
            "kMmaMinBlocks * (kOwnPiecesBytes + kTail + 1024) <= kSmemPerSM",
            "size_t(kOwn) * kMmaRows * D * 4 <=",
            "kOwnPieces ? kOwnPiecesBytes : size_t(kOwn) * kMmaRows * kLd * 4",
            "static constexpr size_t kSmem = kOwnBytes + kTail;",
            "K == kFwd && kMmaFwdBlocks * (kSmem + 1024) <= kSmemPerSM",
            "__launch_bounds__(kMmaThreads, MmaPlan<kDkv, D>::kBlocks)"):
        assert line in SRC, line
    for kind in ("Fwd", "Dq", "Dkv"):
        for d in (32, 64, 128):
            n, _, smem, blocks = plan(kind, d)
            assert n % 16 == 0 and (n * d // 4) % 128 == 0
            assert smem <= 227 * 1024 and blocks >= 2
            assert blocks * (smem + 1024) <= SM_BYTES, (kind, d, smem)
    # the lane's head dim: every kernel's own rows split once; 70, 97 and
    # 89.25 KB; the forward at three blocks an SM
    assert [plan(k, 64) for k in ("Fwd", "Dq", "Dkv")] == [
        (64, True, 71680, 3), (64, True, 99328, 2), (32, True, 91392, 2)]


def _k_tiles(n, sq, sk, q0, causal, rows=64):
    """``mma_k_tiles`` of the source."""
    nk = -(-sk // n)
    return min(nk, (min(q0 + rows, sq) - 1) // n + 1) if causal else nk


@pytest.mark.parametrize("sq,sk", [(200, 200), (96, 160), (160, 96),
                                   (512, 512)])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_tile_walks_cover_every_pair_once(sq, sk, d, causal):
    """Each kernel's grid and loop, as the source writes them, visit every
    (query row, key) pair the mask keeps exactly once, with tail tiles (T
    200) and sq != sk (key tiles that no query row reaches under the
    causal mask); the forward and dq launch their longest q-tile first."""
    consts, _ = _plan()
    assert ("return g.causal ? min(nk, (min(q0 + kMmaRows, g.sq) - 1) / N"
            " + 1) : nk;") in SRC
    assert SRC.count("const int q0 = (nq - 1 - static_cast<int>"
                     "(blockIdx.y)) * kMmaRows;") == 2
    assert "const int qt0 = g.causal ? k0 / N : 0;" in SRC
    assert SRC.count("dim3(bh, nq)") == 2 and SRC.count("dim3(bh, nk)") == 1
    rows = consts["kMmaRows"]
    keep = np.ones((sq, sk), bool)
    if causal:
        keep &= np.arange(sk)[None, :] <= np.arange(sq)[:, None]
    nq, nk = -(-sq // rows), -(-sk // rows)
    for kind in ("Fwd", "Dq"):
        n = consts[f"kMma{kind}N{d}"]
        seen = np.zeros((sq, sk), int)
        walks = []
        for y in range(nq):
            q0 = (nq - 1 - y) * rows
            tiles = _k_tiles(n, sq, sk, q0, causal, rows)
            walks.append(tiles)
            for kt in range(tiles):
                seen[q0:q0 + rows, kt * n:(kt + 1) * n] += 1
        assert walks[0] == max(walks)
        assert (seen[keep] == 1).all() and (seen[~keep] <= 1).all()
    n = consts[f"kMmaDkvN{d}"]
    seen = np.zeros((sq, sk), int)
    walks = []
    for y in range(nk):
        k0 = y * rows
        qt0 = k0 // n if causal else 0
        walks.append(max(0, -(-sq // n) - qt0))
        for qt in range(qt0, -(-sq // n)):
            seen[qt * n:(qt + 1) * n, k0:k0 + rows] += 1
    assert walks[0] == max(walks)
    assert (seen[keep] == 1).all() and (seen[~keep] <= 1).all()


# ----------------------------------------------------------- the routes
def test_route_is_chosen_by_type_and_fma_only_for_float32():
    assert tfa.flash_train_route(torch.float32) == "mma"
    assert tfa.flash_train_route(torch.bfloat16) == "wmma"
    with pytest.raises(TypeError):
        tfa.flash_train_route(torch.float16)
    f32 = torch.zeros(1)
    assert tfa._fma_code("flash_fwd", f32, None) == 0
    assert tfa._fma_code("flash_fwd", f32, "fma") == 1
    for bad, t in (("fma", f32.bfloat16()), ("simt", f32), ("mma", f32)):
        with pytest.raises(ValueError, match="_route"):
            tfa._fma_code("flash_fwd", t, bad)


@pytest.mark.parametrize("route", [None, "fma"])
@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv"])
def test_wrappers_refuse_cpu_tensors_on_either_route(kernel, route):
    """Neither route runs the plain twin: CPU tensors raise, and nothing is
    counted on either counter."""
    tfa.reset_launch_counts()
    q, k, v, g = (torch.from_numpy(a) for a in _inputs("packed", 0)[0])
    rows = torch.zeros(B, T, H)
    args = (q, k, v) if kernel == "flash_fwd" else (q, k, v, g, rows, rows)
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(tfa, kernel)(*args, causal=True, n_heads=H, _route=route)
    fn = getattr(tfa, kernel)
    assert fn.launches == 0 and fn.sm90_launches == 0
