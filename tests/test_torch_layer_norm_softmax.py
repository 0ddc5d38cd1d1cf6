"""The port's layer-norm and softmax ops (``ops/cuda/layer_norm.py``,
``ops/cuda/softmax.py``) against the JAX package's Pallas kernels, on the
CPU.

The JAX functions run their Pallas kernels in interpret mode, as the JAX
package's own tests run them (``tests/test_pallas.py``); the port runs the
plain twins of its CUDA kernels, which is what a CPU tensor takes. Inputs
are made with numpy from a seed and handed to both; the JAX side runs
under ``jax.default_matmul_precision("highest")``. Tolerances: float32
1e-5 forward, 1e-4 gradients; bfloat16 2e-2 and 5e-2, scaled by the
magnitude where it exceeds 1 (the two frameworks round bf16 at other
places, and the inline route computes in bf16 throughout: one bf16 ulp at
|y| in [2, 4) is 0.0156)."""
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from incubator_mxnet_tpu_torch.ops import nn as tnn
from incubator_mxnet_tpu_torch.ops.cuda import common
from incubator_mxnet_tpu_torch.ops.cuda import layer_norm as tln
from incubator_mxnet_tpu_torch.ops.cuda import softmax as tsm

jln = importlib.import_module("incubator_mxnet_tpu.ops.pallas.layer_norm")
jsm = importlib.import_module("incubator_mxnet_tpu.ops.pallas.softmax")
jcommon = importlib.import_module("incubator_mxnet_tpu.ops.pallas.common")
jnn = importlib.import_module("incubator_mxnet_tpu.ops.nn")

TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 5e-2)}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

# (case, x shape): 2-D; 3-D; 12 rows (not a multiple of 8: the inline
# route); wide rows
SHAPES = [("2d", (64, 128)), ("3d", (4, 16, 96)), ("ragged", (3, 4, 64)),
          ("wide", (16, 8192))]


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(t):
    return np.asarray(t.detach().float())


def _jnp32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, atol, scaled=False):
    """|got - want| <= atol, times max(1, |want|) when ``scaled``."""
    want = np.asarray(want, np.float32)
    lim = atol * np.maximum(1.0, np.abs(want)) if scaled else atol
    assert np.all(np.abs(np.asarray(got, np.float32) - want) <= lim), \
        np.max(np.abs(np.asarray(got, np.float32) - want))


def _ln_case(shape, dt):
    d = shape[-1]
    x, g, b, dy = (_rand(shape, 1), _rand((d,), 2), _rand((d,), 3),
                   _rand(shape, 4))
    tx, tg, tb = (torch.from_numpy(a).to(TDT[dt]).requires_grad_(True)
                  for a in (x, g, b))
    ty = tln.layer_norm(tx, tg, tb)
    tgrads = torch.autograd.grad(ty, (tx, tg, tb),
                                 torch.from_numpy(dy).to(TDT[dt]))
    jx, jg, jb = (jnp.asarray(a, JDT[dt]) for a in (x, g, b))
    with jax.default_matmul_precision("highest"):
        jy, vjp = jax.vjp(lambda a, c, e: jln.layer_norm(a, c, e), jx, jg,
                          jb)
        jgrads = vjp(jnp.asarray(dy, JDT[dt]))
    return (ty, tgrads), (jy, jgrads)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case,shape", SHAPES)
def test_layer_norm_matches_pallas(case, shape, dt):
    if case == "wide" and dt == "bfloat16":
        shape = (8, 8192)
    (ty, tgrads), (jy, jgrads) = _ln_case(shape, dt)
    fwd, bwd = TOL[dt]
    bf16 = dt == "bfloat16"
    assert ty.dtype == TDT[dt] and tuple(ty.shape) == shape
    _close(_np(ty), _jnp32(jy), fwd, bf16)
    for name, t, j in zip(("dx", "dgamma", "dbeta"), tgrads, jgrads):
        assert t.dtype == TDT[dt], name
        # column sums over all rows: held relative to their largest entry
        scale = 1.0 if name == "dx" else max(1.0, np.abs(_jnp32(j)).max())
        _close(_np(t) / scale, _jnp32(j) / scale, bwd, bf16)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case,shape", SHAPES + [("lane", (64, 768))])
def test_one_pass_twin_matches_pallas_ln_bwd(case, shape, dt, monkeypatch):
    """Through ``layer_norm``'s autograd, the one-pass twin's (dx, dgamma,
    dbeta) against the Pallas ``_ln_bwd`` in interpret mode; the viable
    shapes of at most 1024 columns take the one-pass route (its column
    sums in the kernel's order), the wide one the two-pass route, the
    ragged one the inline formula."""
    if case == "wide" and dt == "bfloat16":
        shape = (8, 8192)
    calls = []
    sums = tln._onepass_column_sums

    def spy(v, plan):
        calls.append(plan)
        return sums(v, plan)
    monkeypatch.setattr(tln, "_onepass_column_sums", spy)
    (ty, tgrads), (jy, jgrads) = _ln_case(shape, dt)
    n, d = int(np.prod(shape[:-1])), shape[-1]
    onepass = tln.layer_norm_viable(n, d) and d <= 1024
    assert tln.layer_norm_bwd_route(d) == ("onepass" if d <= 1024
                                            else "twopass")
    plan = tln.layer_norm_bwd_plan(n, d, TDT[dt].itemsize)
    assert calls == ([plan] * 2 if onepass else [])
    _, bwd = TOL[dt]
    for name, t, j in zip(("dx", "dgamma", "dbeta"), tgrads, jgrads):
        assert t.dtype == TDT[dt] and tuple(t.shape) == tuple(j.shape)
        scale = 1.0 if name == "dx" else max(1.0, np.abs(_jnp32(j)).max())
        _close(_np(t) / scale, _jnp32(j) / scale, bwd, dt == "bfloat16")


def _column_sums_by_hand(v, plan):
    """The one-pass kernel's column sums, one float32 add at a time: each
    warp's rows, then the block's warps, the group's blocks and the
    groups, each in order."""
    rows, blocks, groups = plan
    n = v.shape[0]
    block_rows = []
    for b in range(blocks):
        warps = []
        for w in range(tln.BWD_WARPS):
            acc = np.zeros(v.shape[1], np.float32)
            for r in range(b * rows + w, min(n, (b + 1) * rows),
                           tln.BWD_WARPS):
                acc = (acc + v[r]).astype(np.float32)
            warps.append(acc)
        tot = warps[0]
        for acc in warps[1:]:
            tot = (tot + acc).astype(np.float32)
        block_rows.append(tot)
    group_rows = []
    for g in range(groups):
        members = block_rows[g * tln.BWD_GROUP:(g + 1) * tln.BWD_GROUP]
        tot = members[0]
        for acc in members[1:]:
            tot = (tot + acc).astype(np.float32)
        group_rows.append(tot)
    tot = group_rows[0]
    for acc in group_rows[1:]:
        tot = (tot + acc).astype(np.float32)
    return tot


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(64, 768), (2100, 1024), (1000, 100),
                                 (8, 64)])
def test_one_pass_column_sums_follow_the_kernel_order(n, d, dt):
    """The twin's dgamma and dbeta are the kernel's sums bit for bit: each
    warp's rows in order, then warps, blocks within a group, and groups
    (two levels of last-block sums once there are more than 16 blocks),
    over an H100's grid for the rows' type and width (bf16 rows up to d
    768: two blocks an SM)."""
    tx = torch.from_numpy(_rand((n, d), 20)).to(TDT[dt])
    tdy = (torch.from_numpy(_rand((n, d), 21)) * 3.0).to(TDT[dt])
    g, b = (torch.from_numpy(_rand((d,), s)) for s in (22, 23))
    _, mu, rstd = tln.layer_norm_reference(tx, g, b)
    _, dg, db = tln.layer_norm_backward_reference(tx, g, mu, rstd, tdy)
    plan = tln.layer_norm_bwd_plan(n, d, TDT[dt].itemsize)
    xn = ((tx.float() - mu) * rstd).numpy()
    dy = tdy.float().numpy()
    assert np.array_equal(dg.numpy(), _column_sums_by_hand(dy * xn, plan))
    assert np.array_equal(db.numpy(), _column_sums_by_hand(dy, plan))
    if n == 2100:                     # one block an SM, a ragged last one
        assert plan == (16, 132, 9)


def _layer_norm_cu():
    """layer_norm.cu's source and its one-pass backward's constants."""
    from pathlib import Path
    import re
    csrc = Path(tln.__file__).resolve().parent / "csrc"
    src = (csrc / "layer_norm.cu").read_text()
    rows = (csrc / "rows.cuh").read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (kBwd\w+) = (\d+);", src)}
    consts["kWarpRowMaxD"] = int(re.search(
        r"constexpr int kWarpRowMaxD = (\d+);", rows).group(1))
    return src, consts


def test_one_pass_plan_mirrors_the_kernel_source():
    """The one-pass backward as layer_norm.cu lays it out: the route cut
    at rows.cuh's warp-row bound (1024), 16-byte vector loads (4 float32
    or 8 bf16 values a lane, at most 8 vectors a lane), the grid one block
    an SM of eight warps for float32 rows and two for bf16 rows, groups of
    16, and each warp's column partials in (8, 2, d) float32 of dynamic
    shared memory (two blocks of it fit an SM up to d 1024); at the nd
    lane (16384, 768) in float32 on an H100 the partials and group sums
    it writes and reads stay near 1% of the bytes the call must move. The
    plan's blocks an SM follow the kernel's launch bound: two for bf16
    rows of at most 768 (24 values a lane), one above."""
    src, c = _layer_norm_cu()
    assert c["kWarpRowMaxD"] == tln.ONEPASS_MAX_D == 1024
    assert tln.layer_norm_bwd_route(1024) == "onepass"
    assert tln.layer_norm_bwd_route(1025) == "twopass"
    assert c["kBwdVecBytes"] == 16
    assert c["kBwdWarps"] == tln.BWD_WARPS
    assert c["kBwdGroup"] == tln.BWD_GROUP
    assert c["kBwdVecBytes"] == tln.BWD_VEC_BYTES
    assert c["kBwdTwoBlockValues"] == tln.BWD_TWO_BLOCK_VALUES == 24
    assert ("return sizeof(T) == 2 && kV * kBwdVecBytes / sizeof(T) <= "
            "kBwdTwoBlockValues\n             ? 2 : 1;" in src)
    # the kernel's vectors a lane: the smallest of 1, 2, 3, 4 (6, 8 for
    # float32) covering the row
    for esz, counts in ((4, (1, 2, 3, 4, 6, 8)), (2, (1, 2, 3, 4))):
        per = 16 // esz
        for d in (1, 64, 255, 256, 257, 512, 640, 768, 769, 1000, 1024):
            kv = next(k for k in counts if k * 32 * per >= d)
            two = esz == 2 and kv * per <= c["kBwdTwoBlockValues"]
            assert tln.layer_norm_bwd_blocks_per_sm(d, esz) == (2 if two
                                                                else 1)
    assert [tln.layer_norm_bwd_blocks_per_sm(d, 2)
            for d in (768, 769, 1024)] == [2, 1, 1]
    assert "extern __shared__ __align__(16) float part[];" in src
    assert ("const size_t smem = static_cast<size_t>(kBwdWarps) * 2 * a.d "
            "* 4;" in src)
    assert "ln_bwd_onepass_kernel<T, kV><<<a.blocks, 32 * kBwdWarps" in src
    for esz in (4, 2):                    # a lane's vectors at d = 1024
        assert -(-1024 // (32 * (16 // esz))) <= 8
    assert 2 * (8 * 2 * 1024 * 4) <= 227 * 1024
    n, d = 16384, 768
    rows, blocks, groups = tln.layer_norm_bwd_plan(n, d, 4)
    assert (rows, blocks, groups) == (125, 132, 9)
    assert tln.layer_norm_bwd_plan(n, d, 2) == (63, 261, 17)
    assert tln.layer_norm_bwd_plan(n, 1024, 2) == (125, 132, 9)
    assert (blocks - 1) * rows < n <= blocks * rows
    assert groups == -(-blocks // tln.BWD_GROUP) and groups <= 32
    moved = 3 * n * d * 4
    scratch = (2 * blocks + 2 * groups) * 2 * d * 4    # written, then read
    assert scratch <= 0.025 * moved
    for n in (8, 64, 1000, 16384, 196608):
        for dd, esz in ((768, 4), (768, 2), (1024, 2)):
            rows, blocks, groups = tln.layer_norm_bwd_plan(n, dd, esz)
            assert (blocks - 1) * rows < n <= blocks * rows


def test_sm_count_is_queried_once_per_device(monkeypatch):
    """The backward's grid reads the SM count from a per-device cache, not
    from ``get_device_properties`` on every call."""
    asked = []

    class Props:
        multi_processor_count = 132

    def props(index):
        asked.append(index)
        return Props()
    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    monkeypatch.setattr(common, "_SM_COUNTS", {})
    dev = torch.device("cuda", 3)
    assert [common.sm_count(dev) for _ in range(3)] == [132] * 3
    assert tln._bwd_rows_per_block(16384, dev) == 32
    assert asked == [3]


def _sm_case(shape, dt, **kw):
    x, dy = _rand(shape, 5), _rand(shape, 6)
    tx = torch.from_numpy(x).to(TDT[dt]).requires_grad_(True)
    length = kw.pop("length", None)
    tlen = None if length is None else torch.from_numpy(length)
    ty = tnn.softmax(tx, -1, length=tlen, **kw)
    (tdx,) = torch.autograd.grad(ty, (tx,), torch.from_numpy(dy).to(TDT[dt]))
    jlen = None if length is None else jnp.asarray(length)
    with jax.default_matmul_precision("highest"):
        jy, vjp = jax.vjp(lambda a: jnn.softmax(a, -1, length=jlen, **kw),
                          jnp.asarray(x, JDT[dt]))
        (jdx,) = vjp(jnp.asarray(dy, JDT[dt]))
    return ty, tdx, jy, jdx


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case,shape", SHAPES)
def test_softmax_matches_pallas(case, shape, dt, monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "softmax")   # the JAX side's kernel
    ty, tdx, jy, jdx = _sm_case(shape, dt)
    fwd, bwd = TOL[dt]
    assert ty.dtype == TDT[dt]
    _close(_np(ty), _jnp32(jy), fwd, dt == "bfloat16")
    _close(_np(tdx), _jnp32(jdx), bwd, dt == "bfloat16")


@pytest.mark.parametrize("kw", [
    {"temperature": 0.5},
    {"length": np.array([5, 128, 1, 77] * 4, dtype=np.int32)},
    {"temperature": 2.0, "length": np.array([3, 9] * 8, dtype=np.int32)},
])
def test_softmax_temperature_and_length_match(kw, monkeypatch):
    """Temperature first, then the -inf length mask, then the kernel (its
    twin here), as ``ops/nn.py:softmax`` orders them in the reference."""
    monkeypatch.setenv("MXTPU_PALLAS", "softmax")
    ty, tdx, jy, jdx = _sm_case((16, 128), "float32", **kw)
    _close(_np(ty), _jnp32(jy), 1e-5)
    _close(_np(tdx), _jnp32(jdx), 1e-4)


@pytest.mark.parametrize("axis", [0, 1])
def test_other_axes_take_the_plain_formula(axis):
    """Layer norm and softmax over a leading axis: the plain formulas, as
    the reference's dispatch sites leave them; nothing is launched."""
    x, g, b = _rand((8, 16, 32), 7), _rand((16,) if axis == 1 else (8,), 8), \
        _rand((16,) if axis == 1 else (8,), 9)
    common.reset_launch_counts()
    ty = tnn.layer_norm(*map(torch.from_numpy, (x, g, b)), axis=axis)
    tp = tnn.softmax(torch.from_numpy(x), axis=axis)
    with jax.default_matmul_precision("highest"):
        jy = jnn.layer_norm(*map(jnp.asarray, (x, g, b)), axis=axis)
        jp = jnn.softmax(jnp.asarray(x), axis=axis)
    _close(_np(ty), np.asarray(jy), 1e-5)
    _close(_np(tp), np.asarray(jp), 1e-6)
    assert set(common.launch_counts().values()) == {0}


def test_twins_match_the_pallas_kernels_outputs():
    """The kernels' twins against the Pallas kernels' own outputs: the
    forward's (y, mu, rstd) against ``_run_fwd``, the backward's (dx,
    dgamma, dbeta) against ``_ln_bwd``, the softmax against ``_run``."""
    n, d = 64, 256
    x, g, b, dy = _rand((n, d), 10), _rand((d,), 11), _rand((d,), 12), \
        _rand((n, d), 13)
    tx, tg, tb, tdy = map(torch.from_numpy, (x, g, b, dy))
    y, mu, rstd = tln.layer_norm_reference(tx, tg, tb)
    dx, dg, db = tln.layer_norm_backward_reference(tx, tg, mu, rstd, tdy)
    with jax.default_matmul_precision("highest"):
        jy, jmu, jrstd = jln._run_fwd(*map(jnp.asarray, (x, g, b)), 1e-5,
                                      64)
        jdx, jdg, jdb = jln._ln_bwd(1e-5, (jnp.asarray(x), jnp.asarray(g),
                                            jmu, jrstd), jnp.asarray(dy))
        jp = jsm._run(jnp.asarray(x), 64)
    for got, want in ((y, jy), (mu, jmu), (rstd, jrstd), (dx, jdx),
                      (tsm.softmax_reference(tx), jp)):
        assert tuple(got.shape) == tuple(want.shape)
        _close(_np(got), np.asarray(want), 1e-5)
    for got, want in ((dg, jdg), (db, jdb)):
        _close(_np(got) / np.abs(want).max(), np.asarray(want)
               / np.abs(want).max(), 1e-6)


@pytest.mark.parametrize("n,d", [(8, 64), (12, 64), (16, 768), (64, 3000),
                                 (24, 65536), (8, 65537), (16, 100),
                                 (40, 512)])
def test_viability_follows_the_reference(n, d):
    """The inline route is taken exactly where the reference takes it
    (``layer_norm.py:127-131``, ``softmax.py:62-67``)."""
    ln_ref = n % 8 == 0 and jcommon.pick_row_block(n, d, 256) != 0
    sm_ref = n % 8 == 0 and jcommon.pick_row_block(n, d) != 0
    assert tln.layer_norm_viable(n, d) == ln_ref
    assert tsm.softmax_viable(n, d) == sm_ref


@pytest.mark.parametrize("kernel", ["layer_norm_fwd", "layer_norm_bwd",
                                    "softmax_fwd"])
def test_kernel_wrappers_refuse_cpu_tensors(kernel):
    """A kernel wrapper never runs the twin: a CPU tensor raises, and the
    launch count stays 0."""
    common.reset_launch_counts()
    x = torch.zeros((8, 64))
    v = torch.ones(64)
    stats = torch.zeros((8, 1))
    args = {"layer_norm_fwd": (x, v, v),
            "layer_norm_bwd": (x, v, stats, stats, x),
            "softmax_fwd": (x,)}[kernel]
    fn = getattr(tln if kernel.startswith("layer") else tsm, kernel)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(*args)
    with pytest.raises(TypeError, match="not supported"):
        fn(*((args[0].double(),) + args[1:]))
    assert common.launch_counts()[kernel] == 0
