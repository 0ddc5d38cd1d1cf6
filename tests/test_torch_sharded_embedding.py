"""The port's sharded embedding engine (``parallel/embedding.py``,
``gluon.nn.ShardedEmbedding``, ``models/sparse_recommenders.py``) and the
store's ``row_sparse_pull`` against the JAX package, on the CPU.

The cases mirror the reference's ``tests/test_sharded_embedding.py``. The
port's mesh cases run as a gloo world of 8 CPU processes, one torch thread
each (``parallel.world.LocalWorld``, one world for the module; the
rank-side bodies are ``tests/_torch_embed_ranks.py``); the JAX side runs in
this process on ``conftest.py``'s 8 virtual CPU devices under
``jax.default_matmul_precision("highest")``. Inputs are numpy arrays from a
seed; tables, ids and cotangents take the reference's grid values
(``_grid``: sums of a few are exact in any order).

Tolerances: dedup, gathers, the routed and local row updates, the
single-layer backward and restored tables bit for bit; a training run
(DLRM at 1,000 rows, dim 8, K 4, batch 16; the sharded FM) against the
JAX package's ``make_sharded_train_step`` within rtol 1e-5 / atol 1e-6
(tables, dense parameters, losses), the dense tower's products summing in
other orders (Adam's FM run atol 1e-5: Adam moves a weight by about lr
whatever the size of its gradient, so a near-zero gradient's rounding moves
it by ~lr * 1e-4); Adam's rows alone within rtol 1e-6 / atol 1e-7 (the
reference's).
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.models import sparse_recommenders as jsr
from incubator_mxnet_tpu.parallel import embedding as jemb
from incubator_mxnet_tpu.parallel.mesh import set_mesh as jset_mesh
from incubator_mxnet_tpu_torch import telemetry as tel
from incubator_mxnet_tpu_torch.gluon.utils import params_from_jax
from incubator_mxnet_tpu_torch.models import sparse_recommenders as tsr
from incubator_mxnet_tpu_torch.ndarray import sparse as tsp
from incubator_mxnet_tpu_torch.ops.cuda import multi_tensor as mt
from incubator_mxnet_tpu_torch.optimizer import fused as tfu
from incubator_mxnet_tpu_torch.optimizer import optimizer as tom
from incubator_mxnet_tpu_torch.parallel import embedding as temb

import _torch_embed_ranks as R

STEP_TOL = dict(rtol=1e-5, atol=1e-6)
# Adam moves a weight by about lr whatever its gradient's size: where the
# tower's gradient is near zero, its rounding moves the row by ~lr * 1e-4
ADAM_TOL = dict(rtol=1e-5, atol=1e-5)
DLRM_CFG = dict(num_features=1000, embed_dim=8, num_dense=3,
                bottom_units=(8,), top_units=(8, 1))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = R.World(8, tmp_path_factory.mktemp("embed_world"))
    yield w
    w.close()


@pytest.fixture(autouse=True)
def _cpu_no_mesh():
    jset_mesh(None)
    with tmx.cpu():
        yield
    jset_mesh(None)


def _jmesh(n=8):
    m = Mesh(np.asarray(jax.devices()[:n]), ("data",))
    jset_mesh(m)
    return m


def _grid(rs, shape, scale=1.0 / 64):
    """Exactly representable float32 values (the reference's)."""
    return (rs.randint(-32, 33, shape) * scale).astype(np.float32)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ------------------------------------------------------------- dedup core
def test_dedup_ids_matches_jax():
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 50, (6, 9)).astype(np.int32)
    ju, ji, jc = map(np.asarray, jax.jit(jemb.dedup_ids)(jnp.asarray(ids)))
    tu, ti, tc = map(_np, temb.dedup_ids(torch.as_tensor(ids)))
    assert int(tc) == int(jc) == len(np.unique(ids))
    np.testing.assert_array_equal(tu, ju)
    np.testing.assert_array_equal(ti, ji)
    assert (tu[int(tc):] == -1).all()
    np.testing.assert_array_equal(tu[ti], ids.ravel())


# -------------------------------------------------------- forward parity
@pytest.mark.parametrize("use_mesh", [False, True])
def test_forward_parity_vs_dense_embedding(use_mesh, world):
    rs = np.random.RandomState(1)
    F, D = 40, 6
    w0 = _grid(rs, (F, D))
    ids = rs.randint(0, F, (8, 5)).astype(np.int32)
    with jmx.name.NameManager():
        je = jmx.gluon.nn.Embedding(F, D)
    je.initialize()
    je(jmx.nd.array(ids))
    je.weight.set_data(jmx.nd.array(w0))
    want = je(jmx.nd.array(ids)).asnumpy()
    if use_mesh:
        got = world.run(R.shard_gather, w0, ids)
        out = np.concatenate([g[0] for g in got])
        assert sum(g[1] for g in got) == ids.size
    else:
        with tmx.name.NameManager():
            se = tmx.gluon.nn.ShardedEmbedding(F, D)
            de = tmx.gluon.nn.Embedding(F, D)
        se.initialize()
        de.initialize()
        se.weight.set_data(tmx.nd.array(w0))
        de.weight.set_data(tmx.nd.array(w0))
        out = se(tmx.nd.array(ids)).asnumpy()
        np.testing.assert_array_equal(out, de(tmx.nd.array(ids)).asnumpy())
        assert se.weight.grad_req == "null"
    np.testing.assert_array_equal(out, want)


def test_eager_forward_on_a_born_sharded_table(world):
    """A table born sharded (each of 8 ranks makes its 1/8 from the seed)
    looks up the rows of the whole table ``init_table`` makes in one
    process, on every rank, ids past the table zero."""
    rows, dim = 1003, 4
    ids = np.random.RandomState(22).randint(-2, rows + 3, (6, 5))
    res = world.run(R.eager_forward, rows, dim, ids.astype(np.float32), 3)
    whole = _np(temb.init_table(rows, dim, mesh=None, key=3, device="cpu"))
    ok = (ids >= 0) & (ids < rows)
    for out, shape in res:
        assert shape == (temb.pad_rows(rows, 8) // 8, dim)
        np.testing.assert_array_equal(out[ok], whole[ids[ok]])
        np.testing.assert_array_equal(out[~ok], 0.0)


def test_dedup_off_escape_hatch(monkeypatch):
    monkeypatch.setenv("MXTPU_EMBED_DEDUP", "0")
    assert not temb.dedup_enabled() and not jemb.dedup_enabled()
    rs = np.random.RandomState(2)
    F, D = 30, 4
    table = _grid(rs, (F, D))
    ids = rs.randint(0, F, (4, 7)).astype(np.int32)
    out, cnt = temb.dedup_take(torch.as_tensor(table), torch.as_tensor(ids),
                               temb.dedup_enabled())
    jout, jcnt = jemb.dedup_take(jnp.asarray(table), jnp.asarray(ids), False)
    np.testing.assert_array_equal(_np(out), table[ids])
    np.testing.assert_array_equal(_np(out), np.asarray(jout))
    assert int(cnt) == int(jcnt) == ids.size


# ---------------------------------------------------- train-step parity
def _reference(kind, cfg, inputs, y, opt, opt_params, steps, mesh, seed,
               hoist=True, lrs=None):
    """The JAX package's sharded step: (numpy parameters by structural
    name, losses, tables and dense parameters by structural name after
    ``steps``, sorts a step, recomputes a step)."""
    os.environ["MXTPU_EMBED_HOIST"] = "1" if hoist else "0"
    try:
        jmx.random.seed(seed)
        with jmx.name.NameManager():
            net = (jsr.DLRM(**cfg) if kind == "dlrm"
                   else jsr.ShardedFactorizationMachine(**cfg))
        net.initialize(jmx.init.Xavier())
        net(*[jmx.nd.array(x) for x in inputs])
        rs = np.random.RandomState(seed)
        for p in net.collect_params().values():
            if getattr(p, "_embed_shard", None) is not None:
                p.set_data(jmx.nd.array(_grid(rs, p.shape)))
        arrays = {k: np.asarray(p.data().asnumpy())
                  for k, p in net._collect_params_with_prefix().items()}
        names = {p.name: k for k, p in
                 net._collect_params_with_prefix().items()}
        from incubator_mxnet_tpu import telemetry as jtel
        with jax.default_matmul_precision("highest"):
            step, state = jemb.make_sharded_train_step(
                net, jmx.gluon.loss.SigmoidBinaryCrossEntropyLoss(),
                optimizer=opt, optimizer_params=opt_params, mesh=mesh)
            s0 = jtel.counter(jemb.SORTS_COUNTER).value()
            r0 = jtel.counter(jemb.ROUTE_RECOMPUTE_COUNTER).value()
            losses = []
            for i in range(steps):
                if lrs is not None:
                    step.optimizer.set_learning_rate(lrs[i])
                state, loss, _ = step(state, *[jmx.nd.array(x)
                                               for x in inputs],
                                      jmx.nd.array(y))
                losses.append(float(jax.device_get(loss)))
        out = {"losses": losses,
               "tables": {names[t]: np.asarray(jax.device_get(
                   state.table(t))) for t in state.tables},
               "dense": {names[d]: np.asarray(jax.device_get(v))
                         for d, v in state.dense.items()},
               "sorts": (jtel.counter(jemb.SORTS_COUNTER).value() - s0)
               / steps,
               "recomputes": (jtel.counter(
                   jemb.ROUTE_RECOMPUTE_COUNTER).value() - r0) / steps}
        return arrays, out
    finally:
        os.environ.pop("MXTPU_EMBED_HOIST", None)


def _port_local(kind, arrays, cfg, inputs, y, opt, opt_params, steps,
                hoist=True, lrs=None):
    """The port's step without a mesh, in this process (the rank body's
    result layout)."""
    os.environ["MXTPU_EMBED_HOIST"] = "1" if hoist else "0"
    try:
        with tmx.name.NameManager():
            net = (tsr.DLRM(**cfg) if kind == "dlrm"
                   else tsr.ShardedFactorizationMachine(**cfg))
        net.initialize()
        params_from_jax(net, arrays)
        names = {p.name: k for k, p in
                 net._collect_params_with_prefix().items()}
        c0 = tel.gauge("sharded_step_compiles").value()
        step, state = temb.make_sharded_train_step(
            net, tmx.gluon.loss.SigmoidBinaryCrossEntropyLoss(),
            optimizer=opt, optimizer_params=opt_params, mesh=None)
        s0 = tel.counter(temb.SORTS_COUNTER).value()
        r0 = tel.counter(temb.ROUTE_RECOMPUTE_COUNTER).value()
        d0 = tel.counter(temb.DENSIFY_COUNTER).value()
        losses, stats = [], None
        for i in range(steps):
            if lrs is not None:
                step.optimizer.set_learning_rate(lrs[i])
            state, loss, stats = step(state, *[torch.as_tensor(x)
                                               for x in inputs],
                                      torch.as_tensor(y))
            losses.append(float(loss))
        return {"losses": losses,
                "tables": {names[t]: _np(state.table(t))
                           for t in state.tables},
                "dense": {names[d]: _np(v) for d, v in state.dense.items()},
                "sorts": (tel.counter(temb.SORTS_COUNTER).value() - s0)
                / steps,
                "recomputes": (tel.counter(temb.ROUTE_RECOMPUTE_COUNTER)
                               .value() - r0) / steps,
                "gauge": tel.gauge(temb.SORTS_GAUGE).value(),
                "routes": dict(step.routes),
                "dense_routes": dict(step.dense_routes),
                "builds": tel.gauge("sharded_step_compiles").value() - c0,
                "densify": tel.counter(temb.DENSIFY_COUNTER).value() - d0,
                "ratio": temb.note_dedup_stats(stats)}
    finally:
        os.environ.pop("MXTPU_EMBED_HOIST", None)


def _dlrm_batch(seed, F=1000, K=4, B=16, ND=3):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, F, (B, K)).astype(np.int32)
    xd = _grid(rs, (B, ND))
    y = (rs.rand(B) < 0.5).astype(np.float32).reshape(B, 1)
    return [ids, xd], y


def _assert_run(got, want, tol=STEP_TOL):
    np.testing.assert_allclose(got["losses"], want["losses"], **tol)
    for n, t in want["tables"].items():
        np.testing.assert_allclose(got["tables"][n], t, err_msg=n, **tol)
    for n, v in want["dense"].items():
        np.testing.assert_allclose(got["dense"][n], v, err_msg=n, **tol)


def _run_port(world, use_mesh, *args, **kw):
    if use_mesh:
        res = world.run(R.train_steps_kw, args, kw)
        for r in res[1:]:
            assert r["losses"] == res[0]["losses"]
        return res[0]
    return _port_local(*args, **kw)


@pytest.mark.parametrize("use_mesh", [False, True])
def test_train_parity_vs_jax(use_mesh, world):
    """DLRM (1,000 rows, dim 8, K 4, batch 16), 3 SGD steps against the JAX
    package's step, with the 8-way mesh and without one; SGD's lazy rows
    take the row kernel's route (its twin on the CPU)."""
    inputs, y = _dlrm_batch(3)
    mesh = _jmesh() if use_mesh else None
    arrays, want = _reference("dlrm", DLRM_CFG, inputs, y, "sgd",
                              {"learning_rate": 0.25}, 3, mesh, seed=3)
    got = _run_port(world, use_mesh, "dlrm", arrays, DLRM_CFG, inputs, y,
                    "sgd", {"learning_rate": 0.25}, 3)
    _assert_run(got, want)
    assert got["routes"]["twin"] == 3 and got["routes"]["tensor_step"] == 0
    # the tower's update: the multi_tensor_update route (its twin here)
    assert got["dense_routes"] == {"kernel": 0, "twin": 3, "tensor_step": 0}
    assert got["densify"] == 0


@pytest.mark.parametrize("use_mesh", [False, True])
def test_sharded_fm_matches_jax(use_mesh, world):
    """The sharded FM (two tables fed by one id tensor: one plan, one sort
    a step), 3 Adam steps against the JAX package's step."""
    rs = np.random.RandomState(8)
    F, K, B = 256, 6, 32
    ids = rs.randint(1, F, (B, K)).astype(np.int32)
    vals = _grid(rs, (B, K))
    y = (rs.rand(B) < 0.5).astype(np.float32).reshape(B, 1)
    cfg = dict(num_features=F, factor_size=4)
    mesh = _jmesh() if use_mesh else None
    arrays, want = _reference("fm", cfg, [ids, vals], y, "adam",
                              {"learning_rate": 0.05}, 3, mesh, seed=8)
    got = _run_port(world, use_mesh, "fm", arrays, cfg, [ids, vals], y,
                    "adam", {"learning_rate": 0.05}, 3)
    _assert_run(got, want, ADAM_TOL)
    assert got["routes"]["twin"] == 6          # 2 tables x 3 steps
    assert got["dense_routes"]["twin"] == 3    # w0, one update a step
    assert got["sorts"] == 1.0


def test_sharded_fm_trains():
    """The sharded FM's loss falls over 8 Adam steps on one device (the
    reference's ``test_sharded_fm_trains``)."""
    rs = np.random.RandomState(8)
    F, K, B = 64, 6, 32
    ids = rs.randint(1, F, (B, K)).astype(np.int32)
    vals = rs.rand(B, K).astype(np.float32)
    y = (rs.rand(B) < 0.5).astype(np.float32).reshape(B, 1)
    with tmx.name.NameManager():
        net = tsr.ShardedFactorizationMachine(F, 4)
    net.initialize(tmx.init.Xavier())
    net(tmx.nd.array(ids), tmx.nd.array(vals))
    step, state = temb.make_sharded_train_step(
        net, tmx.gluon.loss.SigmoidBinaryCrossEntropyLoss(),
        optimizer="adam", optimizer_params={"learning_rate": 0.05})
    losses = []
    for _ in range(8):
        state, loss, _ = step(state, torch.as_tensor(ids),
                              torch.as_tensor(vals), torch.as_tensor(y))
        losses.append(float(loss))
    assert losses[-1] < losses[0]


def test_single_layer_bitexact_backward():
    """The dedup backward (a sum by unique slot, scattered by row) equals
    JAX's dense scatter-add gradient bit for bit on grid values."""
    rs = np.random.RandomState(4)
    F, D, n = 32, 4, 24
    table = _grid(rs, (F, D))
    ids = rs.randint(0, F, (n,)).astype(np.int32)
    cot = _grid(rs, (n, D))
    gd = jax.grad(lambda t: jnp.sum(t[jnp.asarray(ids)]
                                    * jnp.asarray(cot)))(jnp.asarray(table))
    w = torch.zeros(F, D)
    opt = tom.SGD(learning_rate=-1.0)       # w += g: the gradient itself
    opt._update_count(0)
    h = opt.fused_hypers(0)

    def update(t, st, row_ids, g_rows):
        mt.update_rows("sgd", opt.tensor_step, t, st, row_ids, g_rows, h,
                       opt.multi_tensor_hypers(h))
    out, _, plan = temb.dedup_take(torch.as_tensor(table),
                                   torch.as_tensor(ids), True,
                                   with_plan=True)
    np.testing.assert_array_equal(_np(out), table[ids])
    temb._local_update(w, None, torch.as_tensor(cot), update, True,
                       plan=plan)
    np.testing.assert_array_equal(_np(w), np.asarray(gd))


@pytest.mark.parametrize("hoist", [False, True])
def test_shard_update_bitexact_8dev(hoist, world):
    """8 ranks: the routed sum and lazy row SGD (the re-derived route, and
    the gather's hoisted plan) equal the dense update bit for bit."""
    rs = np.random.RandomState(11)
    F, D = 64, 4
    table = _grid(rs, (F, D))
    ids = rs.randint(0, F, (16, 6)).astype(np.int32)
    gout = _grid(rs, (16, 6, D))
    got = np.concatenate(world.run(R.shard_update_sgd, table, ids, gout, 0.5,
                                   hoist))
    ref = table.astype(np.float64)
    dense_g = np.zeros((F, D), np.float64)
    np.add.at(dense_g, ids.ravel(), gout.reshape(-1, D))
    touched = np.unique(ids.ravel())
    ref[touched] -= 0.5 * dense_g[touched]
    np.testing.assert_array_equal(got, ref.astype(np.float32))


# ------------------------------------------- fused row-sparse optimizer
def _rsp(vals, rows, shape):
    return tsp.RowSparseNDArray(torch.as_tensor(vals),
                                torch.as_tensor(rows), shape)


def test_fused_sparse_update_matches_legacy_lazy_sgd():
    rs = np.random.RandomState(5)
    w0 = _grid(rs, (20, 3))
    rows = np.array([2, 5, 11], np.int64)
    vals = _grid(rs, (3, 3))
    w_fused = tmx.nd.array(w0)
    before = tfu.stats()["fused_step_sparse_updates"]
    tom.get_updater(tom.create("sgd", learning_rate=0.5)).update_batch(
        [0], [_rsp(vals, rows, (20, 3))], [w_fused])
    assert tfu.stats()["fused_step_sparse_updates"] == before + 1
    w_legacy = tmx.nd.array(w0)
    os.environ["MXTPU_FUSED_STEP"] = "0"
    try:
        tom.get_updater(tom.create("sgd", learning_rate=0.5)).update_batch(
            [0], [_rsp(vals, rows, (20, 3))], [w_legacy])
    finally:
        os.environ.pop("MXTPU_FUSED_STEP")
    np.testing.assert_array_equal(w_fused.asnumpy(), w_legacy.asnumpy())
    untouched = np.setdiff1d(np.arange(20), rows)
    np.testing.assert_array_equal(w_fused.asnumpy()[untouched],
                                  w0[untouched])


def test_fused_sparse_update_adam_lazy_rows():
    """Adam on the active rows only, no densify; the rows against the JAX
    package's ``Adam.tensor_step`` on the row slices."""
    rs = np.random.RandomState(6)
    w0 = _grid(rs, (16, 2))
    rows = np.array([1, 7], np.int64)
    vals = _grid(rs, (2, 2))
    w = tmx.nd.array(w0)
    d0 = tel.counter(temb.DENSIFY_COUNTER).value()
    tom.get_updater(tom.create("adam", learning_rate=0.1)).update_batch(
        [0], [_rsp(vals, rows, (16, 2))], [w])
    assert tel.counter(temb.DENSIFY_COUNTER).value() == d0
    from incubator_mxnet_tpu.optimizer import optimizer as jom
    h = {"lr": 0.1, "wd": 0.0, "rescale": 1.0, "clip": 0.0, "t": 1.0,
         "beta1": 0.9, "beta2": 0.999, "eps": 1e-8}
    ref, _ = jom.Adam(learning_rate=0.1).tensor_step(
        jnp.asarray(w0[rows]), jnp.asarray(vals),
        (jnp.zeros((2, 2)), jnp.zeros((2, 2))), h)
    got = w.asnumpy()
    np.testing.assert_allclose(got[rows], np.asarray(ref), rtol=1e-6,
                               atol=1e-7)
    untouched = np.setdiff1d(np.arange(16), rows)
    np.testing.assert_array_equal(got[untouched], w0[untouched])


def test_fused_sparse_varying_nnz_builds_nothing():
    """Row-sparse gradients of varying nnz: exact, and no plan is built for
    them (the reference pads to power-of-two buckets to bound its traces;
    the row update here is launch data)."""
    rs = np.random.RandomState(14)
    w0 = _grid(rs, (32, 3))
    w = tmx.nd.array(w0)
    upd = tom.get_updater(tom.create("sgd", learning_rate=0.5))
    expect = w0.copy()
    c0 = tfu.stats()["fused_step_compiles"]
    for rows in ([1, 4, 9], [2, 5, 11, 20], [3, 8], [6]):
        rows_np = np.array(rows, np.int64)
        vals = _grid(rs, (len(rows), 3))
        upd.update_batch([0], [_rsp(vals, rows_np, (32, 3))], [w])
        expect[rows_np] -= 0.5 * vals
    np.testing.assert_array_equal(w.asnumpy(), expect)
    assert tfu.stats()["fused_step_compiles"] - c0 <= 3


def test_fused_sparse_zero_nnz_skips_without_densify():
    rs = np.random.RandomState(16)
    w0 = _grid(rs, (10, 2))
    w = tmx.nd.array(w0)
    d0 = tel.counter(temb.DENSIFY_COUNTER).value()
    tom.get_updater(tom.create("adam", learning_rate=0.1)).update_batch(
        [0], [tsp.zeros("row_sparse", (10, 2))], [w])
    assert tel.counter(temb.DENSIFY_COUNTER).value() == d0
    np.testing.assert_array_equal(w.asnumpy(), w0)


def test_fused_sparse_momentum_sgd_keeps_legacy_path():
    rs = np.random.RandomState(15)
    w0 = _grid(rs, (12, 2))
    vals = _grid(rs, (2, 2))
    rows = np.array([3, 8], np.int64)
    results = {}
    for flag in ("1", "0"):
        w = tmx.nd.array(w0)
        os.environ["MXTPU_FUSED_STEP"] = flag
        try:
            upd = tom.get_updater(tom.create("sgd", learning_rate=0.5,
                                             momentum=0.9))
            upd.update_batch([0], [_rsp(vals, rows, (12, 2))], [w])
            upd.update_batch([0], [_rsp(vals, rows, (12, 2))], [w])
        finally:
            os.environ.pop("MXTPU_FUSED_STEP")
        results[flag] = w.asnumpy()
    np.testing.assert_array_equal(results["1"], results["0"])


def test_fused_sparse_census_skips_whole_step():
    rs = np.random.RandomState(12)
    w_dense = tmx.nd.array(_grid(rs, (6, 3)))
    w_sparse = tmx.nd.array(_grid(rs, (10, 3)))
    dense0, sparse0 = w_dense.asnumpy().copy(), w_sparse.asnumpy().copy()
    gd = tmx.nd.array(_grid(rs, (6, 3)))
    vals = _grid(rs, (2, 3))
    vals[1, 1] = np.nan
    gs = _rsp(vals, np.array([2, 7], np.int64), (10, 3))
    ok = tom.get_updater(tom.create("sgd", learning_rate=0.5)).update_batch(
        [0, 1], [gd, gs], [w_dense, w_sparse], census=True)
    assert ok is not None and not bool(ok.asnumpy())
    np.testing.assert_array_equal(w_dense.asnumpy(), dense0)
    np.testing.assert_array_equal(w_sparse.asnumpy(), sparse0)


# --------------------------------------- compile once, sorts, drop contract
def test_compile_once_and_zero_densify(world):
    """10 steps on the 8-way mesh under a changing learning rate: the step
    is built once, nothing densifies, the dedup gauge is the step's ratio,
    and the run follows the JAX package's under the same schedule."""
    inputs, y = _dlrm_batch(7)
    lrs = [0.1 / (i + 1) for i in range(10)]
    arrays, want = _reference("dlrm", DLRM_CFG, inputs, y, "sgd",
                              {"learning_rate": 0.1}, 10, _jmesh(), seed=7,
                              lrs=lrs)
    got = _run_port(world, True, "dlrm", arrays, DLRM_CFG, inputs, y, "sgd",
                    {"learning_rate": 0.1}, 10, lrs=lrs)
    assert got["builds"] == 1 and got["densify"] == 0
    assert got["ratio"] >= 1.0
    _assert_run(got, want)


@pytest.mark.parametrize("use_mesh", [False, True])
def test_route_plan_hoist_halves_sorts(use_mesh, world):
    """The hoisted plan runs half the route sorts of the re-derived one (1
    against 2 a table a step), no route recompute against one, and the
    same trajectory bit for bit; both as the JAX package counts them."""
    inputs, y = _dlrm_batch(3)
    mesh = _jmesh() if use_mesh else None
    res = {}
    for hoist in (True, False):
        arrays, want = _reference("dlrm", DLRM_CFG, inputs, y, "sgd",
                                  {"learning_rate": 0.25}, 3, mesh, seed=3,
                                  hoist=hoist)
        got = _run_port(world, use_mesh, "dlrm", arrays, DLRM_CFG, inputs,
                        y, "sgd", {"learning_rate": 0.25}, 3, hoist=hoist)
        assert (got["sorts"], got["recomputes"]) == (want["sorts"],
                                                     want["recomputes"])
        res[hoist] = got
    assert res[False]["sorts"] == 2 and res[True]["sorts"] == 1
    assert res[True]["gauge"] == 1
    assert res[True]["recomputes"] == 0 and res[False]["recomputes"] == 1
    for n in res[True]["tables"]:
        np.testing.assert_array_equal(res[True]["tables"][n],
                                      res[False]["tables"][n])
    for n in res[True]["dense"]:
        np.testing.assert_array_equal(res[True]["dense"][n],
                                      res[False]["dense"][n])


def test_route_negative_ids_drop_not_scramble(world):
    """Negative ids and an id past the table give zero rows on the 8-way
    route and the local gather, as in the JAX package."""
    rs = np.random.RandomState(21)
    F, D = 64, 4
    table = _grid(rs, (F, D))
    ids = rs.randint(0, F, (16, 4)).astype(np.int32)
    ids[::3, 0] = -1
    ids[1, 1] = F + 100
    got = np.concatenate([g[0] for g in world.run(R.shard_gather, table,
                                                  ids)])
    mask = (ids >= 0) & (ids < F)
    np.testing.assert_array_equal(got[~mask], 0.0)
    np.testing.assert_array_equal(got[mask], table[ids[mask]])
    loc, _ = temb.dedup_take(torch.as_tensor(table), torch.as_tensor(ids))
    jloc, _ = jemb.dedup_take(jnp.asarray(table), jnp.asarray(ids), True)
    np.testing.assert_array_equal(_np(loc), got)
    np.testing.assert_array_equal(_np(loc), np.asarray(jloc))


def test_hoisted_plan_threads_through_sharded_update(world):
    """One step on the 8-way mesh: the hoisted plan and the re-derived one
    give the same table bit for bit, with one sort."""
    inputs, y = _dlrm_batch(5)
    arrays, _ = _reference("dlrm", DLRM_CFG, inputs, y, "sgd",
                           {"learning_rate": 0.25}, 1, None, seed=5)
    h = _run_port(world, True, "dlrm", arrays, DLRM_CFG, inputs, y, "sgd",
                  {"learning_rate": 0.25}, 1, hoist=True)
    p = _run_port(world, True, "dlrm", arrays, DLRM_CFG, inputs, y, "sgd",
                  {"learning_rate": 0.25}, 1, hoist=False)
    for n in h["tables"]:
        np.testing.assert_array_equal(h["tables"][n], p["tables"][n])
    assert h["sorts"] == 1


# -------------------------------------------------- resharding restore
def test_resharding_restore_8_to_4_and_1(tmp_path, world):
    """A table saved by 8 ranks (``table_writer`` into one collective
    ``CheckpointManager.save``) verifies, restores onto 4 shards and onto
    one table bit for bit, and a corrupted shard file fails ``verify``."""
    from incubator_mxnet_tpu_torch.fault import CheckpointManager
    rs = np.random.RandomState(9)
    rows, dim = 100, 6                 # not a multiple of 8
    logical = rs.rand(rows, dim).astype(np.float32)
    padded = np.concatenate([logical, np.zeros((temb.pad_rows(rows, 8)
                                                - rows, dim), np.float32)])
    ok = world.run(R.save_table, str(tmp_path), padded, rows, 4)
    assert ok[0] is True
    step_dir = os.path.join(str(tmp_path), "step-7")
    parts = [temb.load_table(step_dir, "embed", shard=(4, i))[0]
             for i in range(4)]
    assert all(p.shape[0] == temb.pad_rows(rows, 4) // 4 for p in parts)
    np.testing.assert_array_equal(_np(torch.cat(parts))[:rows], logical)
    whole, _ = temb.load_table(step_dir, "embed", mesh=None)
    np.testing.assert_array_equal(_np(whole), logical)
    for i, p in enumerate(parts):           # the live route, no checkpoint
        np.testing.assert_array_equal(_np(temb.reshard_table(
            whole, rows, shard=(4, i))), _np(p))
    mgr = CheckpointManager(str(tmp_path), keep=2)
    assert mgr.verify(7)
    victim = os.path.join(step_dir, "embed.table.0.0.npy")
    with open(victim, "r+b") as f:
        f.seek(64)
        f.write(b"\xff\xff\xff\xff")
    assert not mgr.verify(7)


def test_collective_save_crash_keeps_latest_intact(tmp_path, world):
    """A sharded save that fails (a rank's writer dying after half its
    shard; rank 0 killed at each stage of the save by the ``ckpt.save``
    chaos point) publishes nothing torn: ``latest()`` is always an intact,
    verifying checkpoint and no staged directory is left behind."""
    rs = np.random.RandomState(20)
    rows = 60
    table = np.concatenate([rs.rand(rows, 4).astype(np.float32),
                            np.zeros((temb.pad_rows(rows, 8) - rows, 4),
                                     np.float32)])
    res = world.run(R.crash_saves, str(tmp_path), table, rows)[0]
    assert res[0] == (7, False, 7, True, [])
    assert res[1] == (8, True, 7, True, [])
    # rank 0 killed before it publishes (stages 0-4): step 7 stays the
    # newest; killed after (stage 5, before pruning): step 15 is published
    for step, raised, latest, ok, residue in res[2:7]:
        assert (raised, latest, ok, residue) == (True, 7, True, []), step
    assert res[7] == (15, True, 15, True, [])


def test_table_writer_async_one_process_with_state(tmp_path):
    """Without a mesh the writer rides ``save_async``; Adam's two state
    leaves restore with the table."""
    from incubator_mxnet_tpu_torch.fault import CheckpointManager
    rs = np.random.RandomState(19)
    t = torch.as_tensor(_grid(rs, (10, 3)))
    st = (torch.as_tensor(_grid(rs, (10, 3))),
          torch.as_tensor(_grid(rs, (10, 3))))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(3, writers=[temb.table_writer("t", t, state=st,
                                                 shard_rows=4)])
    mgr.wait()
    assert mgr.verify(3)
    got, got_st = temb.load_table(os.path.join(str(tmp_path), "step-3"), "t",
                                  state_struct=st)
    np.testing.assert_array_equal(_np(got), _np(t))
    for a, b in zip(got_st, st):
        np.testing.assert_array_equal(_np(a), _np(b))
    mgr.close()


def test_init_table_independent_of_world_size():
    """``init_table``'s rows do not depend on the number of shards (a
    chunk's generator is seeded by the key and the chunk), pads are zero,
    and the statistics are those of N(0, 1 / dim)."""
    rows, dim = 2_500_000, 4
    old = temb.INIT_CHUNK_ROWS
    temb.INIT_CHUNK_ROWS = 1 << 16
    try:
        whole = temb.init_table(rows, dim, mesh=None, key=5, device="cpu")
        assert whole.shape == (rows, dim)
        assert abs(float(whole.std()) - 0.5) < 2e-3
        assert abs(float(whole.mean())) < 2e-3

        class _M:                   # a stand-in mesh: 3 shards, index i
            axis_names = ("data",)
            shape = {"data": 3}
            device = torch.device("cpu")

            def __init__(self, i):
                self.i = i

            def axis_index(self, axis):
                return self.i
        parts = [temb.init_table(rows, dim, mesh=_M(i), key=5)
                 for i in range(3)]
        cat = torch.cat(parts)
        assert cat.shape[0] == temb.pad_rows(rows, 3)
        assert torch.equal(cat[:rows], whole)
        assert not cat[rows:].any()
    finally:
        temb.INIT_CHUNK_ROWS = old


# ------------------------------------------------------ kvstore dedup
def _both_kv():
    from incubator_mxnet_tpu import kvstore as jkv
    return jkv.create("local"), tmx.kvstore.create("local")


def test_kvstore_row_sparse_pull_dedup():
    rs = np.random.RandomState(10)
    val = _grid(rs, (12, 3))
    val[4] = 0.0
    jkv, tkv = _both_kv()
    jkv.init("emb", jmx.nd.array(val))
    tkv.init("emb", tmx.nd.array(val))
    rid = np.array([3, 3, 7, 4, 3, 7], np.int32)
    g0 = tel.counter("kvstore_rowsparse_rows_gathered_total").value()
    out = tsp.zeros("row_sparse", (12, 3))
    tkv.row_sparse_pull("emb", out=out, row_ids=tmx.nd.array(rid))
    assert tel.counter(
        "kvstore_rowsparse_rows_gathered_total").value() - g0 == 3
    from incubator_mxnet_tpu.ndarray import sparse as jsp
    jout = jsp.zeros("row_sparse", (12, 3))
    jkv.row_sparse_pull("emb", out=jout, row_ids=jmx.nd.array(rid))
    np.testing.assert_array_equal(_np(out.indices), np.asarray(jout.indices))
    np.testing.assert_array_equal(_np(out.data), np.asarray(jout.data))
    np.testing.assert_array_equal(_np(out.indices), [3, 7])
    dense_out = tmx.nd.zeros((12, 3))
    tkv.row_sparse_pull("emb", out=dense_out, row_ids=tmx.nd.array(rid))
    expect = np.zeros_like(val)
    expect[[3, 7]] = val[[3, 7]]
    np.testing.assert_array_equal(dense_out.asnumpy(), expect)
    assert tel.gauge(temb.DEDUP_RATIO_GAUGE).value() == pytest.approx(2.0)


def test_kvstore_row_sparse_pull_unsorted_store_and_oob_ids():
    rs = np.random.RandomState(13)
    data = _grid(rs, (3, 4)) + 1.0
    idx = np.array([7, 2, 5], np.int32)
    jkv, tkv = _both_kv()
    from incubator_mxnet_tpu.ndarray import sparse as jsp
    jkv.init("t", jsp.RowSparseNDArray(jnp.asarray(data), jnp.asarray(idx),
                                       (12, 4)))
    tkv.init("t", _rsp(data, idx.astype(np.int64), (12, 4)))
    out = tsp.zeros("row_sparse", (12, 4))
    tkv.row_sparse_pull("t", out=out, row_ids=tmx.nd.array(
        np.array([2, 7], np.int32)))
    np.testing.assert_array_equal(_np(out.indices), [2, 7])
    np.testing.assert_array_equal(_np(out.data), data[[1, 0]])
    jout = jsp.zeros("row_sparse", (12, 4))
    jkv.row_sparse_pull("t", out=jout, row_ids=jmx.nd.array(
        np.array([2, 7], np.int32)))
    np.testing.assert_array_equal(_np(out.data), np.asarray(jout.data))
    d = _grid(rs, (5, 2)) + 1.0
    tkv.init("d", tmx.nd.array(d))
    out2 = tsp.zeros("row_sparse", (5, 2))
    tkv.row_sparse_pull("d", out=out2, row_ids=tmx.nd.array(
        np.array([1, 99], np.int32)))
    np.testing.assert_array_equal(_np(out2.indices), [1])
    np.testing.assert_array_equal(_np(out2.data), d[[1]])
