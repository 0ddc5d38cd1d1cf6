"""The split route of the port's decode kernels
(``ops/cuda/csrc/decode_attention.cu``, ``decode_split_kernel``), on the CPU.

The kernels need the card, so these tests hold a plain-PyTorch emulation
of what they compute against the JAX package's plain decode references and
its Pallas kernels in interpret mode:

* a cell's span is cut into tiles of whole rows inside one page, and a
  split takes a run of consecutive tiles (``decode_split_plan``, from
  static shapes alone);
* within a split the online softmax runs tile by tile at the split's own
  running max, with the weights rounded to the value type before P.V;
* the live splits (those whose first row lies below the length) are
  combined in index order: rescaled by exp(m_i - max m) in float32 and
  rounded once; a cell with one live split is that split's result, and
  length 0 gives zeros.

The plan's constants and shared-memory formula are read from the source.
Inputs come from numpy with a seed. Tolerances: 1e-5 against the JAX
functions in float32 (sums run in another order), 2e-2 in bf16 against
the port's sequential twin (the weights round at another max).
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from incubator_mxnet_tpu.ops.pallas import (decode_attention_reference,
                                            flash_decode_step,
                                            flash_decode_step_paged,
                                            paged_decode_attention_reference)
from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as tfa

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_ATOL = 2e-2
NEG_INF = -1e30
SRC = (Path(tfa.__file__).resolve().parent / "csrc" / "decode_attention.cu"
       ).read_text()
CONSTS = {n: int(v) for n, v in
          re.findall(r"constexpr int (k\w+) = (\d+);", SRC)}

JAX_CONTIGUOUS = {"reference": decode_attention_reference,
                  "pallas_interpret": flash_decode_step}
JAX_PAGED = {"reference": paged_decode_attention_reference,
             "pallas_interpret": flash_decode_step_paged}


# ------------------------------------------------------------- the plan
def test_plan_constants_match_the_source():
    assert CONSTS["kSplitThreads"] == tfa._SPLIT_THREADS == 128
    assert CONSTS["kSplitTileBytes"] == tfa._SPLIT_TILE_BYTES
    assert CONSTS["kSplitChunkTiles"] == tfa._SPLIT_CHUNK_TILES
    assert CONSTS["kSplitTargetBlocks"] == tfa._SPLIT_TARGET_BLOCKS
    assert CONSTS["kSplitBarBytes"] == tfa._SPLIT_BAR_BYTES
    assert CONSTS["kSmemLimit"] == tfa._SMEM_LIMIT == 227 * 1024
    # two mbarriers a tile of the run fit their bytes
    assert 2 * CONSTS["kSplitChunkTiles"] * 8 <= CONSTS["kSplitBarBytes"]
    # the launcher's shared memory is the wrapper's formula
    flat = re.sub(r"\s+", " ", SRC)
    assert ("return kSplitBarBytes + (size_t)tiles_per_split * (2 * "
            "tile_bytes + (size_t)tile_rows * 4) + (size_t)kSplitWarps * "
            "(d + 1) * 4;") in flat


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128, 256])
def test_plan_fits_shared_memory(d, itemsize):
    """Every shape the wrappers take (d 8..256, page_len 1..8192, any cache
    length) gets tiles of at most kSplitTileBytes inside a page, runs of
    1..kSplitChunkTiles tiles that cover the span, and under 227 KB of
    shared memory a block."""
    for cells in (1, 3, 96, 4096):
        for page_len, n_pages in ((1, 1), (7, 3), (16, 8), (64, 8),
                                  (100, 5), (512, 1), (4096, 1), (8192, 1),
                                  (8192, 16), (64, 512), (300000, 1)):
            rows, tps, n_split, smem = tfa.decode_split_plan(
                cells, page_len, n_pages, d, itemsize)
            assert 1 <= rows <= page_len
            assert rows * d * itemsize <= tfa._SPLIT_TILE_BYTES \
                or rows == 1
            assert 1 <= tps <= tfa._SPLIT_CHUNK_TILES
            n_tiles = n_pages * -(-page_len // rows)
            assert (n_split - 1) * tps < n_tiles <= n_split * tps
            assert smem <= tfa._SMEM_LIMIT
            if n_tiles * cells <= tfa._SPLIT_TARGET_BLOCKS:
                assert tps == 1     # one tile a block while blocks are few


def _live(lengths, page_len, n_pages, rows, tps):
    """Live splits a cell, as the kernel counts them."""
    tpp = -(-page_len // rows)
    out = []
    for n in lengths:
        n = min(max(n, 0), page_len * n_pages)
        if n == 0:
            out.append(0)
            continue
        t_last = ((n - 1) // page_len) * tpp + ((n - 1) % page_len) // rows
        out.append(t_last // tps + 1)
    return out


def test_plan_at_the_serving_lane():
    """8 slots x 12 heads, cache 512 (page 64), d 64, bf16: one 64-row
    tile a block, 8 splits a cell, 768 blocks; at the ragged lengths of a
    serving run 360 of them work, the rest exit at once."""
    ragged = [8, 64, 65, 129, 200, 264, 333, 512]
    for page_len, n_pages in ((64, 8), (512, 1)):     # paged, contiguous
        rows, tps, n_split, smem = tfa.decode_split_plan(96, page_len,
                                                         n_pages, 64, 2)
        assert (rows, tps, n_split) == (64, 1, 8)
        assert 96 * n_split == 768
        assert smem < 20 * 1024
        assert sum(_live(ragged, page_len, n_pages, rows, tps)) * 12 == 360


# --------------------------------------------------------- the emulation
def _emulate(q, k_rows, v_rows, lengths, page_len, n_pages, plan, scale):
    """What ``decode_split_kernel`` computes. ``k_rows(cell, page, r0, r1)``
    gives rows [r0, r1) of the cell's page ``page`` (and ``v_rows`` the
    same of V); ``plan`` is (tile_rows, tiles_per_split, ...)."""
    S, H, d = q.shape
    rows, tps = plan[0], plan[1]
    tpp = -(-page_len // rows)
    qs = (q * torch.tensor(scale, dtype=q.dtype)).float()
    out = torch.zeros(S * H, d, dtype=torch.float32)
    live = _live([int(n) for n in lengths], page_len, n_pages, rows, tps)
    for cell in range(S * H):
        s = cell // H
        n = min(max(int(lengths[s]), 0), page_len * n_pages)
        parts = []
        for c in range(live[s]):
            m = torch.tensor(NEG_INF)
            l = torch.tensor(0.0)
            acc = torch.zeros(d)
            for t in range(c * tps, (c + 1) * tps):
                page, j = divmod(t, tpp)
                r0 = j * rows
                n_valid = min(rows, page_len - r0, n - (page * page_len + r0))
                if n_valid <= 0:
                    break
                kt = k_rows(cell, page, r0, r0 + n_valid)
                vt = v_rows(cell, page, r0, r0 + n_valid)
                sc = kt.float() @ qs.reshape(S * H, d)[cell]
                m_new = torch.maximum(m, sc.max())
                corr = torch.exp(m - m_new)
                p = torch.exp(sc - m_new)
                l = l * corr + p.sum()
                acc = acc * corr + p.to(vt.dtype).float() @ vt.float()
                m = m_new
            parts.append((m, l, acc))
        if len(parts) == 1:
            m, l, acc = parts[0]
            out[cell] = acc / torch.clamp(l, min=1e-30)
        elif parts:
            mx = torch.stack([p[0] for p in parts]).max()
            l = torch.tensor(0.0)
            acc = torch.zeros(d)
            for m_i, l_i, acc_i in parts:           # in split order
                w = torch.exp(m_i - mx)
                l = l + w * l_i
                acc = acc + w * acc_i
            out[cell] = acc / torch.clamp(l, min=1e-30)
    return out.reshape(S, H, d).to(q.dtype)


def emulate_contiguous(q, k, v, lengths, cells=None):
    S, H, C, d = k.shape
    plan = tfa.decode_split_plan(cells or S * H, C, 1, d, q.element_size())
    kc, vc = k.reshape(S * H, C, d), v.reshape(S * H, C, d)
    return _emulate(q, lambda c, p, a, b: kc[c, a:b],
                    lambda c, p, a, b: vc[c, a:b], lengths, C, 1, plan,
                    1.0 / math.sqrt(d))


def emulate_paged(q, k, v, bt, lengths, cells=None):
    S, H, d = q.shape
    n_pool, _, P, _ = k.shape
    n_pages = bt.shape[1]
    plan = tfa.decode_split_plan(cells or S * H, P, n_pages, d,
                                 q.element_size())
    btc = bt.long().clamp(0, n_pool - 1)

    def rows_of(pool):
        return lambda c, p, a, b: pool[btc[c // H, p], c % H, a:b]
    return _emulate(q, rows_of(k), rows_of(v), lengths, P, n_pages, plan,
                    1.0 / math.sqrt(d))


def _contiguous(S=6, H=2, C=320, d=16, seed=0):
    """At d 16 in float32 a tile is 128 rows, so C 320 is three tiles, the
    last partial: lengths 0, 1, a tile boundary -1/0/+1 and the full
    cache. Positions at or past a length hold large finite garbage."""
    rng = np.random.RandomState(seed)
    q = rng.randn(S, H, d).astype(np.float32)
    k = rng.randn(S, H, C, d).astype(np.float32)
    v = rng.randn(S, H, C, d).astype(np.float32)
    lengths = np.array([0, 1, 127, 128, 129, C], np.int32)[:S]
    for s, n in enumerate(lengths):
        k[s, :, n:] = 1e4
        v[s, :, n:] = -1e4
    return q, k, v, lengths


def _paged(S=6, H=2, P=16, n_pages=16, max_pages=4, d=16, seed=0):
    """A scrambled block table whose dead entries point at the trash page
    (the last one), filled with finite garbage; lengths 0, 1, a page
    boundary -1/0/+1 and full."""
    rng = np.random.RandomState(seed)
    k = rng.randn(n_pages + 1, H, P, d).astype(np.float32)
    v = rng.randn(n_pages + 1, H, P, d).astype(np.float32)
    k[n_pages] = 1e4 * rng.randn(H, P, d)
    v[n_pages] = -1e4 * rng.randn(H, P, d)
    q = rng.randn(S, H, d).astype(np.float32)
    bt = np.stack([rng.permutation(n_pages)[:max_pages] for _ in range(S)]
                  ).astype(np.int32)
    lengths = np.array([0, 1, P - 1, P, P + 1, P * max_pages], np.int32)[:S]
    for s, n in enumerate(lengths):
        bt[s, -(-n // P):] = n_pages
    return q, k, v, bt, lengths


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# cells=None: the plan of the call's own shape (one tile a split);
# 1 << 20: a plan of four-tile runs, as long caches get
PLANS = [None, 1 << 20]


@pytest.mark.parametrize("cells", PLANS)
@pytest.mark.parametrize("jax_fn", sorted(JAX_CONTIGUOUS))
def test_contiguous_emulation_matches_jax(jax_fn, cells):
    q, k, v, lengths = _contiguous()
    want = JAX_CONTIGUOUS[jax_fn](jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(lengths),
                                  block_k=64)
    got = emulate_contiguous(*_t(q, k, v, lengths), cells=cells)
    assert torch.count_nonzero(got[0]) == 0         # length 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("cells", PLANS)
@pytest.mark.parametrize("jax_fn", sorted(JAX_PAGED))
def test_paged_emulation_matches_jax(jax_fn, cells):
    q, k, v, bt, lengths = _paged()
    want = JAX_PAGED[jax_fn](jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(bt), jnp.asarray(lengths))
    got = emulate_paged(*_t(q, k, v, bt, lengths), cells=cells)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_emulation_splits_the_cells():
    """The shapes above do split: several live splits a cell, and runs of
    several tiles under the long-cache plan."""
    q, k, v, lengths = _contiguous()
    S, H, C, d = k.shape
    for cells, tps in ((None, 1), (1 << 20, 3)):
        plan = tfa.decode_split_plan(cells or S * H, C, 1, d, 4)
        assert plan[:2] == (128, tps)
    assert _live(lengths, C, 1, 128, 1) == [0, 1, 1, 1, 2, 3]
    q, k, v, bt, lengths = _paged()
    assert tfa.decode_split_plan(12, 16, 4, 16, 4)[:3] == (16, 1, 4)
    assert _live(lengths, 16, 4, 16, 1) == [0, 1, 1, 1, 2, 4]


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_bf16_emulation_near_the_sequential_twin(layout):
    """In bf16 the weights are rounded at each split's own max, so the
    split result differs from the page-sequential twin by rounding only."""
    if layout == "contiguous":
        q, k, v, lengths = _t(*_contiguous(d=64, C=256))
        args = [x.bfloat16() for x in (q, k, v)] + [lengths]
        got = emulate_contiguous(*args)
        want = tfa.decode_attention_reference(*args, block_k=64)
    else:
        q, k, v, bt, lengths = _t(*_paged(d=64, P=64))
        args = [x.bfloat16() for x in (q, k, v)] + [bt, lengths]
        got = emulate_paged(*args)
        want = tfa.paged_decode_attention_reference(*args)
    assert got.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs().max().item()
    assert err <= BF16_ATOL


@pytest.mark.parametrize("route", [None, "simple"])
@pytest.mark.parametrize("kernel", ["flash_decode_step",
                                    "flash_decode_step_paged"])
def test_every_route_refuses_cpu_tensors(kernel, route):
    """Both routes of both wrappers raise on CPU tensors (the plain twins
    are the dispatchers' business), and so does an unknown route; nothing
    is counted."""
    tfa.reset_launch_counts()
    q, k, v, bt, lengths = _t(*_paged())
    args = (q, k, v, lengths) if kernel == "flash_decode_step" else \
        (q, k, v, bt, lengths)
    fn = getattr(tfa, kernel)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(*args, _route=route)
    with pytest.raises(ValueError, match="_route 'fast'"):
        fn(*args, _route="fast")
    assert fn.launches == 0 and fn.sm90_launches == 0
