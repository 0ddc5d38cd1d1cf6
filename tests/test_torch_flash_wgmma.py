"""The arithmetic of the port's bf16 flash-attention forward on Hopper
(``ops/cuda/csrc/flash_attention_sm90.cu``, ``flash_fwd_wgmma_kernel``),
on the CPU.

The kernel needs the card, so these tests hold a plain-PyTorch emulation
of what it computes against the JAX package's Pallas kernels
(``_fwd_packed`` and the head-major ``_fwd``, in interpret mode under
``jax.default_matmul_precision("highest")``, as
``tests/test_torch_flash_attention.py`` runs them) on bf16 inputs, against
the port's plain twin, and against float64:

* a block is 128 query rows, two warpgroups of 64; each walks 64-key
  tiles, all of them or, causal, through its own last row's diagonal;
* the packed layout scales q once in bf16 (by the scale rounded to bf16)
  before Q.K^T; the head-major layout scales the float32 scores;
* the online softmax in float32 with base-2 exponentials, the scale times
  log2(e) folded in: p = 2^(s c - m c), c = s_mul log2(e), m the row's
  running max of the unscaled scores; masked scores -1e30;
* P rounded to bf16 before P.V, every product accumulated in float32;
* out = O / l rounded to bf16 (times the reciprocal), lse = m s_mul +
  log(max(l, 1e-30)).

The block plan, the tile walk and the grid's block order are read from
the source. Inputs come from numpy with a seed. The tolerance is the one
the card holds the bf16 forward to (``chip_smoke.TRAIN_TOL[bf16]``, 2e-2:
a bf16 ulp is 2^-8 relative, 0.0078 at 2), since
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
         re.findall(r"constexpr int (kF\w+) = (\d+);", SRC)}
ROWS, KEYS = CONST["kFRows"], CONST["kFKeys"]
WG_ROWS = ROWS // 2
TOL = chip_smoke.TRAIN_TOL[torch.bfloat16][0]
NEG_INF = -1e30
LOG2E = 1.4426950408889634
B, T, H = 2, 128, 4


def _bf16(*shape, seed):
    """Seeded standard-normal values, rounded to bf16 (as numpy float32
    and as a torch bf16 tensor)."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t.float().numpy(), t


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


def _round(x):
    return x.to(torch.bfloat16).float()


def _tiles(r0, sq, sk, causal):
    """Key tiles the 64 rows from r0 visit (the kernel's ``tiles``)."""
    if r0 >= sq:
        return 0
    nk = -(-sk // KEYS)
    return min(nk, min(r0 + 63, sq - 1) // KEYS + 1) if causal else nk


def emu_wgmma_forward(q, k, v, causal, scale, n_heads=None):
    """(out bf16, lse float32) of ``flash_fwd_wgmma_kernel`` on bf16 q, k,
    v, warpgroup by warpgroup and tile by tile."""
    qh, kh, vh = (_head_major(t, n_heads) for t in (q, k, v))
    b, h, sq, d = qh.shape
    sk = kh.shape[2]
    if n_heads is not None:
        qs = _round(qh.float() * _round(torch.tensor(scale)))
        s_mul = 1.0
    else:
        qs, s_mul = qh.float(), scale
    c = torch.tensor(s_mul, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    out = torch.zeros((b, h, sq, d))
    lse = torch.zeros((b, h, sq))
    for r0 in range(0, sq, WG_ROWS):           # both warpgroups of a block
        r1 = min(r0 + WG_ROWS, sq)
        rows = torch.arange(r0, r1)[:, None]
        m = torch.full((b, h, r1 - r0, 1), NEG_INF)
        l = torch.zeros_like(m)
        o = torch.zeros((b, h, r1 - r0, d))
        for kt in range(_tiles(r0, sq, sk, causal)):
            k0 = kt * KEYS
            kt_, vt = kh[:, :, k0:k0 + KEYS].float(), vh[:, :, k0:k0 + KEYS]
            s = qs[:, :, r0:r1] @ kt_.transpose(-1, -2)
            cols = k0 + torch.arange(kt_.shape[2])[None, :]
            last = torch.clamp(rows, max=sk - 1) if causal else sk - 1
            s = s.masked_fill(cols > last, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp2((m - m_new) * c)
            p = torch.exp2(s * c - m_new * c)
            l = l * corr + p.sum(-1, keepdim=True)
            o = o * corr + _round(p) @ vt.float()
            m = m_new
        ls = torch.clamp(l, min=1e-30)
        out[:, :, r0:r1] = o * (1.0 / ls)
        lse[:, :, r0:r1] = (m * s_mul + torch.log(ls))[..., 0]
    return (_packed(out.to(torch.bfloat16), n_heads),
            lse if n_heads is None else lse.permute(0, 2, 1))


def _inputs(layout, seed, d=32, sq=T, sk=T):
    if layout == "packed":
        shapes = ((B, sq, H * d), (B, sk, H * d), (B, sk, H * d))
        n_heads = H
    else:
        shapes = ((B, H, sq, d), (B, H, sk, d), (B, H, sk, d))
        n_heads = None
    arrays = [_bf16(*s, seed=seed + i) for i, s in enumerate(shapes)]
    return arrays, n_heads


def _max_err(a, b):
    return float((torch.tensor(np.array(a, np.float32))
                  - torch.tensor(np.array(b, np.float32))).abs().max())


# ------------------------------------------------- against the references
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("layout", ["packed", "head_major"])
def test_wgmma_emulation_matches_the_pallas_kernels_in_bf16(layout, causal):
    arrays, n_heads = _inputs(layout, seed=70)
    scale = 1.0 / math.sqrt(32)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a, _ in arrays)
    with jax.default_matmul_precision("highest"):
        if layout == "packed":
            want, want_lse = jfa._fwd_packed(jq, jk, jv, H, scale, causal,
                                             64, 64)
        else:
            want, want_lse = jfa._fwd(jq, jk, jv, scale, causal, 64, 64)
    out, lse = emu_wgmma_forward(*(t for _, t in arrays), causal, scale,
                                 n_heads)
    assert out.dtype == torch.bfloat16
    assert _max_err(out.float(), np.asarray(want, np.float32)) <= TOL
    assert _max_err(lse, np.asarray(want_lse)) <= TOL


def _float64(q, k, v, causal, scale, n_heads):
    """out and lse in float64 from the bf16 inputs (the packed query
    scaled in bf16 first, as every bf16 route does)."""
    qh, kh, vh = (_head_major(t, n_heads) for t in (q, k, v))
    if n_heads is not None:
        qs, s_mul = _round(qh.float() * _round(torch.tensor(scale))), 1.0
    else:
        qs, s_mul = qh.float(), scale
    s = (qs.double() @ kh.double().transpose(-1, -2)) * s_mul
    if causal:
        keep = (torch.arange(s.shape[-2])[:, None]
                >= torch.arange(s.shape[-1])[None, :])
        s = s.masked_fill(~keep, NEG_INF)
    out = torch.softmax(s, -1) @ vh.double()
    lse = torch.logsumexp(s, -1)
    return (_packed(out, n_heads),
            lse if n_heads is None else lse.permute(0, 2, 1))


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("layout", ["packed", "head_major"])
def test_wgmma_emulation_is_as_close_to_float64_as_the_twin(layout, d):
    """At each head dim, the emulation's error against the float64
    function is at most twice the plain twin's (both round P and out to
    bf16), or 2^-8 (a bf16 ulp at 1) where that is larger, and within the
    tolerance."""
    arrays, n_heads = _inputs(layout, seed=80 + d, d=d)
    q, k, v = (t for _, t in arrays)
    scale = 1.0 / math.sqrt(d)
    emu = emu_wgmma_forward(q, k, v, True, scale, n_heads)
    twin = tfa.flash_forward_reference(q, k, v, causal=True, scale=scale,
                                       n_heads=n_heads)
    exact = _float64(q, k, v, True, scale, n_heads)
    for e, t, x in zip(emu, twin, exact):
        err_e = float((e.double() - x).abs().max())
        err_t = float((t.double() - x).abs().max())
        assert err_e <= max(2 * err_t, 2.0 ** -8) and err_e <= TOL


@pytest.mark.parametrize("sq,sk", [(200, 200), (96, 160), (160, 96),
                                   (1, 7), (300, 64)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("layout", ["packed", "head_major"])
def test_wgmma_emulation_matches_the_twin_on_ragged_shapes(layout, causal,
                                                           sq, sk):
    """Tail tiles (T 200), sq != sk (key tiles a warpgroup's rows never
    reach under the top-left causal mask, rows past every key), one row,
    a warpgroup with no rows (sq 300 leaves the last block's second
    warpgroup 44 rows, sq 1 none)."""
    arrays, n_heads = _inputs(layout, seed=90, d=32, sq=sq, sk=sk)
    q, k, v = (t for _, t in arrays)
    emu = emu_wgmma_forward(q, k, v, causal, 0.17, n_heads)
    twin = tfa.flash_forward_reference(q, k, v, causal=causal, scale=0.17,
                                       n_heads=n_heads)
    for e, t in zip(emu, twin):
        assert e.shape == t.shape
        assert _max_err(e.float(), t.float()) <= TOL


# ------------------------------------------------------ from the source
def test_plan_mirrors_the_source_and_fits_two_blocks():
    """FlashPlan as the source writes it, mirrored by flash_wgmma_plan:
    the Q tile and three stages of K and V, 1 KB of alignment, two blocks
    an SM at d 32 and 64 (128 registers a thread), one at d 128; the
    launch bound and the 228 KB an SM."""
    assert (ROWS, KEYS, CONST["kFStages"], CONST["kFThreads"]) == (
        128, 64, 3, 256)
    for line in (
            "static constexpr int kRowBytes = D >= 64 ? 128 : 64;",
            "static constexpr int kSmem = kQ + kFStages * 2 * kKV + 1024;",
            "static constexpr int kBlocks = D <= 64 ? 2 : 1;",
            "__launch_bounds__(kFThreads, FlashPlan<D>::kBlocks)"):
        assert line in SRC, line
    for d in (32, 64, 128):
        plan = tfa.flash_wgmma_plan(d)
        smem = ROWS * d * 2 + CONST["kFStages"] * 2 * KEYS * d * 2 + 1024
        assert plan == {"rows": ROWS, "keys": KEYS,
                        "stages": CONST["kFStages"],
                        "threads": CONST["kFThreads"],
                        "row_bytes": 128 if d >= 64 else 64,
                        "smem_bytes": smem,
                        "blocks": 2 if d <= 64 else 1}
        assert plan["blocks"] * (smem + 1024) <= 228 * 1024
        assert 65536 // (plan["blocks"] * plan["threads"]) >= (
            128 if d <= 64 else 255)
    with pytest.raises(ValueError):
        tfa.flash_wgmma_plan(16)


@pytest.mark.parametrize("sq", [512, 200, 96, 2048])
def test_grid_launches_each_q_tile_once_longest_first(sq):
    """The grid as the source writes it: (B H, q-tiles), blockIdx.y 0 the
    last q-tile, which walks the most key tiles under the causal mask, so
    the longest blocks are launched first."""
    assert "const dim3 grid(B * p.H, (p.sq + kFRows - 1) / kFRows);" in SRC
    assert ("const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * "
            "kFRows;") in SRC
    nq = -(-sq // ROWS)
    q0s = [(nq - 1 - y) * ROWS for y in range(nq)]
    assert sorted(q0s) == [qt * ROWS for qt in range(nq)]
    walks = [max(_tiles(q0, sq, sq, True), _tiles(q0 + WG_ROWS, sq, sq,
                                                   True)) for q0 in q0s]
    assert walks == sorted(walks, reverse=True)


@pytest.mark.parametrize("sq,sk", [(200, 200), (96, 160), (160, 96),
                                   (512, 512), (300, 64), (1, 7)])
@pytest.mark.parametrize("causal", [False, True])
def test_tile_walks_cover_every_pair_once(sq, sk, causal):
    """Each warpgroup's walk (``tiles``, as the source writes it) visits
    every (query row, key) pair the mask keeps exactly once; the block
    loads the larger of its warpgroups' walks, which the other releases
    unread."""
    assert ("return p.causal ? min(nk, (min(r0 + 63, p.sq - 1)) / kFKeys + "
            "1) : nk;") in SRC
    assert "const int n_blk = max(tiles(q0), tiles(q0 + 64));" in SRC
    keep = np.ones((sq, sk), bool)
    if causal:
        keep &= np.arange(sk)[None, :] <= np.arange(sq)[:, None]
    seen = np.zeros((sq, sk), int)
    for q0 in range(0, sq, ROWS):
        walks = [_tiles(r0, sq, sk, causal) for r0 in (q0, q0 + WG_ROWS)]
        assert max(walks) - min(walks) <= 1 or min(walks) == 0
        for r0, n in zip((q0, q0 + WG_ROWS), walks):
            for kt in range(n):
                seen[r0:r0 + WG_ROWS, kt * KEYS:(kt + 1) * KEYS] += 1
    assert (seen[keep] == 1).all() and (seen[~keep] <= 1).all()


def test_the_library_exports_the_wgmma_entry_point():
    """mxt_flash_fwd_sm90 is in bindings.cpp with as many parameters as
    its ctypes signature, and the source is in ``common.SOURCES``."""
    params = re.search(r"int mxt_flash_fwd_sm90\(([^)]*)\)",
                       BINDINGS).group(1)
    assert len(params.split(",")) == len(
        common._SIGNATURES["mxt_flash_fwd_sm90"])
    assert any(p.name == "flash_attention_sm90.cu" for p in common.SOURCES)


# ------------------------------------------------------------- the route
def test_route_is_wgmma_for_the_bf16_forward_only():
    """Every bf16 training kernel, the forward and (since the backward's
    Hopper kernels) dq and dk/dv, takes "wgmma"; "wmma" forces bf16 onto
    the old kernels and "fma" float32, through one route check."""
    assert tfa.flash_train_route(torch.bfloat16) == "wgmma"
    assert tfa.flash_train_route(torch.bfloat16, "flash_fwd") == "wgmma"
    for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert tfa.flash_train_route(torch.bfloat16, kernel) == "wgmma"
    assert tfa.flash_train_route(torch.float32) == "mma"
    with pytest.raises(ValueError, match="no training kernel"):
        tfa.flash_train_route(torch.bfloat16, "flash_bwd")
    bf, f32 = torch.zeros(1, dtype=torch.bfloat16), torch.zeros(1)
    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert tfa._route_of(kernel, bf, None) == "wgmma"
        assert tfa._route_of(kernel, bf, "wmma") == "wmma"
        assert tfa._route_of(kernel, f32, None) == "mma"
        assert tfa._route_of(kernel, f32, "fma") == "fma"
        for t, bad in ((f32, "wmma"), (bf, "fma"), (bf, "wgmma"),
                       (bf, "mma"), (f32, "simt")):
            with pytest.raises(ValueError, match="_route"):
                tfa._route_of(kernel, t, bad)


@pytest.mark.parametrize("route", [None, "wmma"])
@pytest.mark.parametrize("n_heads", [None, H])
def test_bf16_forward_refuses_cpu_tensors_on_either_route(n_heads, route):
    """Neither bf16 route runs the plain twin: CPU tensors raise before
    the route is read, and nothing is counted on either counter."""
    tfa.reset_launch_counts()
    layout = "head_major" if n_heads is None else "packed"
    q, k, v = (t for _, t in _inputs(layout, seed=5)[0])
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_fwd(q, k, v, causal=True, n_heads=n_heads, _route=route)
    assert tfa.flash_fwd.launches == 0 and tfa.flash_fwd.sm90_launches == 0
