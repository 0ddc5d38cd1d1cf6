"""The port's fused trainer step (``optimizer/fused.py`` and the plain twins
of ``ops/cuda/multi_tensor.py``) on the CPU, ported from
``tests/test_fused_step.py``: fused equals per-parameter bit for bit for
every registered optimizer (float32, and float16 with multi_precision),
fused on the port is within 1e-6 of fused on the JAX package after 10
steps, one dispatch a ``Trainer`` step, no plan built across a
learning-rate schedule, ``set_learning_rate`` or the guard's clip, bulk
chunks, the global census, in-place bytes, SGLD's fallback, and the lazy
row-sparse branch against the reference's. The kernels' table is held by
a plain-PyTorch emulation of the blocks over it; the kernel wrappers
refuse CPU tensors. The guard's census cases are in
``tests/test_torch_guard.py``. The kernels themselves run only on the
card (``chip_smoke.py`` phase 31)."""
import contextlib
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.ndarray import sparse as jsp
from incubator_mxnet_tpu.optimizer import fused as jfused
from incubator_mxnet_tpu.optimizer import optimizer as jopt
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import autograd, engine, gluon, nd
from incubator_mxnet_tpu_torch.ndarray import sparse as tsp
from incubator_mxnet_tpu_torch.optimizer import fused
from incubator_mxnet_tpu_torch.optimizer import optimizer as opt_mod
from incubator_mxnet_tpu_torch.ops.cuda import common
from incubator_mxnet_tpu_torch.ops.cuda import multi_tensor as mt
from incubator_mxnet_tpu_torch.test_utils import assert_no_retrace

SHAPES = [(4, 3), (7,), (2, 3, 2)]

# every registered optimizer (+ the option branches that change the rule:
# momentum on/off, centered, clip_gradient), as in the reference's tests
CONFIGS = [
    ("sgd", {}),
    ("sgd", {"momentum": 0.9}),
    ("sgd", {"momentum": 0.9, "clip_gradient": 0.5}),
    ("nag", {"momentum": 0.9}),
    ("signum", {}),
    ("adam", {}),
    ("adam", {"clip_gradient": 0.1}),
    ("adamw", {}),
    ("adagrad", {}),
    ("rmsprop", {}),
    ("rmsprop", {"centered": True}),
    ("adadelta", {}),
    ("ftrl", {}),
    ("adamax", {}),
    ("nadam", {}),
    ("ftml", {}),
    ("dcasgd", {}),
    ("dcasgd", {"momentum": 0.9}),
    ("lbsgd", {"momentum": 0.9}),
    ("lamb", {}),
    ("test", {}),
]
IDS = [f"{n}-{'-'.join(map(str, k.values())) or 'd'}" for n, k in CONFIGS]


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _run_pair(name, kwargs, dtype=np.float32, mp=False, steps=10,
              census=False, shapes=SHAPES):
    """The fused (update_batch) and per-parameter (per-key Updater) paths
    on the same inputs with a learning rate that changes every step;
    returns both final weight lists."""
    rng = np.random.RandomState(42)
    w0 = [rng.uniform(-1, 1, s).astype(dtype) for s in shapes]
    opt_f = opt_mod.create(name, learning_rate=0.05, multi_precision=mp,
                           **kwargs)
    opt_l = opt_mod.create(name, learning_rate=0.05, multi_precision=mp,
                           **kwargs)
    upd_f, upd_l = opt_mod.get_updater(opt_f), opt_mod.get_updater(opt_l)
    wf = [nd.array(w) for w in w0]
    wl = [nd.array(w) for w in w0]
    for step in range(steps):
        lr = 0.05 * (0.9 ** step)
        opt_f.set_learning_rate(lr)
        opt_l.set_learning_rate(lr)
        g0 = [rng.uniform(-1, 1, s).astype(dtype) for s in shapes]
        upd_f.update_batch(list(range(len(shapes))),
                           [nd.array(g) for g in g0], wf, census=census)
        for i in range(len(shapes)):
            upd_l(i, nd.array(g0[i]), wl[i])
    return wf, wl


def _run_reference_fused(name, kwargs, steps=10, shapes=SHAPES):
    """The JAX package's fused path on the inputs of :func:`_run_pair`."""
    rng = np.random.RandomState(42)
    w0 = [rng.uniform(-1, 1, s).astype(np.float32) for s in shapes]
    opt = jopt.create(name, learning_rate=0.05, **kwargs)
    upd = jopt.get_updater(opt)
    ws = [jmx.nd.array(w) for w in w0]
    for step in range(steps):
        opt.set_learning_rate(0.05 * (0.9 ** step))
        g0 = [rng.uniform(-1, 1, s).astype(np.float32) for s in shapes]
        upd.update_batch(list(range(len(shapes))),
                         [jmx.nd.array(g) for g in g0], ws)
    return ws


@pytest.mark.parametrize("name,kwargs", CONFIGS, ids=IDS)
def test_fused_matches_legacy_fp32(name, kwargs):
    """The kernel's rules take the fused chunk; the others, with no census
    to gate on, take the per-parameter update inside update_batch."""
    before = fused.stats()
    wf, wl = _run_pair(name, kwargs)
    after = fused.stats()
    takes = fused.kernel_route(opt_mod.create(name, **kwargs))
    assert (after["fused_step_dispatches"] > before["fused_step_dispatches"]) \
        is takes, "the route is not the optimizer class's"
    for a, b in zip(wf, wl):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


@pytest.mark.parametrize("mp", [False, True], ids=["f32", "f16-master"])
@pytest.mark.parametrize("name,kwargs", CONFIGS, ids=IDS)
def test_fused_under_census_matches_legacy(name, kwargs, mp):
    """Under the census every fused-eligible rule runs in the executor (the
    kernel's in its chunk, the others' ``tensor_step`` tensor by tensor,
    each selected by the census), bit for bit the per-parameter path."""
    before = fused.stats()
    wf, wl = _run_pair(name, kwargs, dtype=np.float16 if mp else np.float32,
                       mp=mp, census=True,
                       shapes=SHAPES[:2] if mp else SHAPES)
    assert fused.stats()["fused_step_dispatches"] > \
        before["fused_step_dispatches"]
    for a, b in zip(wf, wl):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


@pytest.mark.parametrize("name,kwargs", CONFIGS, ids=IDS)
def test_fused_matches_legacy_fp16_multi_precision(name, kwargs):
    wf, wl = _run_pair(name, kwargs, dtype=np.float16, mp=True,
                       shapes=SHAPES[:2])
    for a, b in zip(wf, wl):
        assert a.dtype == np.float16
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


@pytest.mark.parametrize("name,kwargs", CONFIGS, ids=IDS)
def test_fused_matches_the_reference_fused(name, kwargs):
    """Fused on the port within 1e-6 of fused on the JAX package after 10
    steps (the two frameworks round host scalars and a few reductions
    differently; the rules are the same)."""
    wf, _ = _run_pair(name, kwargs)
    with jax.default_matmul_precision("highest"):
        wj = _run_reference_fused(name, kwargs)
    for a, b in zip(wf, wj):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=0,
                                   atol=1e-6)


def test_census_select_is_exact_on_finite_grads():
    for name in ("sgd", "adam"):
        wf, wl = _run_pair(name, {"momentum": 0.9} if name == "sgd" else {},
                           census=True)
        for a, b in zip(wf, wl):
            np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


def test_sgld_falls_back_per_param():
    opt = opt_mod.create("sgld", learning_rate=0.05)
    assert not opt.supports_fused()
    upd = opt_mod.get_updater(opt)
    w = [nd.array(np.ones((3, 2), np.float32))]
    g = [nd.array(np.ones((3, 2), np.float32))]
    before = fused.stats()["fused_step_dispatches"]
    assert upd.update_batch([0], g, w, census=True) is None
    assert fused.stats()["fused_step_dispatches"] == before
    assert not np.allclose(w[0].asnumpy(), 1.0)   # the update still applied


def test_sparse_grads_fall_back_per_key():
    """Momentum-free SGD's row-sparse gradient takes the lazy branch (the
    dense tensor alone is a fused update), and its inactive rows stay."""
    opt = opt_mod.create("sgd", learning_rate=0.1)
    upd = opt_mod.get_updater(opt)
    dense_w = nd.array(np.ones((4, 2), np.float32))
    sparse_w = nd.array(np.ones((4, 2), np.float32))
    gd = nd.array(np.full((4, 2), 0.5, np.float32))
    gs = tsp.cast_storage(nd.array(
        np.array([[0.5, 0.5], [0, 0], [0, 0], [0.5, 0.5]], np.float32)),
        "row_sparse")
    before = fused.stats()
    upd.update_batch([0, 1], [gd, gs], [dense_w, sparse_w])
    after = fused.stats()
    assert after["fused_step_updates"] == before["fused_step_updates"] + 1
    assert after["fused_step_sparse_updates"] == \
        before["fused_step_sparse_updates"] + 1
    np.testing.assert_allclose(dense_w.asnumpy(), 0.95, rtol=1e-6)
    np.testing.assert_allclose(sparse_w.asnumpy()[0], 0.95, rtol=1e-6)
    np.testing.assert_allclose(sparse_w.asnumpy()[1], 1.0, rtol=1e-6)


# --------------------------------------------------------------- trainer
def _dense_trainer(optimizer="sgd", opt_params=None, **kw):
    net = gluon.nn.Dense(4, in_units=3)
    net.initialize(tmx.init.Xavier())
    tr = gluon.Trainer(net.collect_params(), optimizer,
                       opt_params or {"learning_rate": 0.1}, **kw)
    return net, tr


def _one_step(net, tr, batch=2):
    with autograd.record():
        loss = net(nd.ones((batch, 3))).sum()
    loss.backward()
    tr.step(batch)


def test_trainer_step_is_one_dispatch():
    net, tr = _dense_trainer()
    _one_step(net, tr)                     # state and the first plan
    before = fused.stats()
    for _ in range(5):
        _one_step(net, tr)
    after = fused.stats()
    assert after["fused_step_dispatches"] - before["fused_step_dispatches"] \
        == 5
    assert after["fused_step_compiles"] == before["fused_step_compiles"]
    assert after["per_param_compiles"] == before["per_param_compiles"]


def test_a_new_layout_builds_a_plan_on_the_cpu_too():
    """The CPU counts the plan builds the card makes, so the no-retrace
    tests here are not vacuous: a tensor of a new size is a new layout."""
    opt = opt_mod.create("sgd", learning_rate=0.1, momentum=0.9)
    upd = opt_mod.get_updater(opt)
    g = [nd.array(np.ones((2, 2), np.float32))]
    upd.update_batch([0], g, [nd.array(np.zeros((2, 2), np.float32))])
    with assert_no_retrace():
        upd.update_batch([0], g, [nd.array(np.zeros((2, 2), np.float32))])
    with pytest.raises(AssertionError, match="fused_step_compiles"):
        with assert_no_retrace():
            upd.update_batch([1], [nd.array(np.ones((3,), np.float32))],
                             [nd.array(np.zeros((3,), np.float32))])


def test_hybridized_eval_after_a_step_sees_the_new_weights():
    """The usual Gluon loop: a hybridized net evaluated outside
    ``record()``, a fused ``Trainer.step`` (in place), and an evaluation
    again: the compiled forward reads the stepped weights, equal bit for
    bit to the eager forward."""
    tmx.random.seed(4)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(8, in_units=3, activation="relu"),
            gluon.nn.Dense(4, in_units=8))
    net.initialize(tmx.init.Xavier())
    net.hybridize()
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9})
    x = nd.array(np.random.RandomState(4).rand(5, 3).astype(np.float32))
    for _ in range(3):
        before = net(x).asnumpy()
        before_dispatches = fused.stats()["fused_step_dispatches"]
        with autograd.record():
            loss = net(x).sum()
        loss.backward()
        tr.step(5)
        assert fused.stats()["fused_step_dispatches"] == \
            before_dispatches + 1
        got = net(x).asnumpy()
        net.hybridize(False)
        eager = net(x).asnumpy()
        net.hybridize()
        assert not np.array_equal(got, before)
        np.testing.assert_array_equal(got, eager)


def test_kernel_wrappers_bump_the_versions_of_what_they_write(monkeypatch):
    """A kernel writes through raw pointers, unseen by PyTorch: each
    wrapper bumps the version of every weight, master and state it
    handed the kernel (a compiled forward refreshes on a moved version),
    and leaves the gradients' alone. The launch is stubbed (no card)."""
    class _Library:
        def mxt_multi_tensor_update(self, *args):
            return 0

        def mxt_row_sparse_update(self, *args):
            return 0
    monkeypatch.setattr(mt, "kernel_library", _Library)
    monkeypatch.setattr(mt, "_check_cuda", lambda ts, name: "cpu")
    monkeypatch.setattr(mt, "_device_table", lambda table, dev: torch.zeros(1))
    monkeypatch.setattr(mt, "current_stream_handle", lambda t: 0)
    try:
        _stubbed_launches()
    finally:
        common.reset_launch_counts()       # the stubs launched nothing


def _stubbed_launches():
    w = [torch.zeros(6, dtype=torch.float16), torch.zeros(3)]
    g = [torch.ones(6, dtype=torch.float16), torch.ones(3)]
    s0 = [torch.zeros(6), torch.zeros(3)]
    masters = [torch.zeros(6), None]
    written = w + s0 + masters[:1]
    v0 = [t._version for t in written + g]
    mt.multi_tensor_update("sgd_mom", mt.Plan([6, 3], [3, 0]), w, g, s0,
                           None, masters, [(0.1, 0.0, 1.0, -1.0, (0.9,))] * 2)
    assert [t._version for t in written] == [v + 1 for v in v0[:5]]
    assert [t._version for t in g] == v0[5:]
    table, m, v = torch.zeros(4, 3), torch.zeros(4, 3), torch.zeros(4, 3)
    ids, rows = torch.tensor([1, 3]), torch.ones(2, 3)
    v0 = [t._version for t in (table, m, v, rows)]
    mt.row_sparse_update("adam", table, m, v, ids, rows,
                         (0.1, 0.0, 1.0, -1.0, (0.9, 0.1, 0.999, 0.001,
                                                1e-8)))
    assert [t._version for t in (table, m, v, rows)] == \
        [v0[0] + 1, v0[1] + 1, v0[2] + 1, v0[3]]


def test_trainer_no_retrace_across_lr_schedule():
    from incubator_mxnet_tpu_torch import lr_scheduler as lrs
    net, tr = _dense_trainer(
        opt_params={"learning_rate": 0.1, "momentum": 0.9,
                    "lr_scheduler": lrs.FactorScheduler(step=1, factor=0.9)})
    _one_step(net, tr)
    lr0 = tr.learning_rate
    with assert_no_retrace():
        for _ in range(9):
            _one_step(net, tr)
    assert tr.learning_rate < lr0          # the schedule stepped


def test_set_learning_rate_no_retrace_and_applies():
    opt = opt_mod.create("sgd", learning_rate=0.5)
    upd = opt_mod.get_updater(opt)
    w = [nd.array(np.zeros((2, 2), np.float32))]
    g = [nd.array(np.ones((2, 2), np.float32))]
    upd.update_batch([0], g, w)
    np.testing.assert_allclose(w[0].asnumpy(), -0.5, rtol=1e-6)
    opt.set_learning_rate(0.1)
    with assert_no_retrace():
        upd.update_batch([0], g, w)
    np.testing.assert_allclose(w[0].asnumpy(), -0.6, rtol=1e-6)


def test_guard_rescale_ladder_clip_applies_without_retrace():
    """The guard's rescale rung installs clip_gradient on a live optimizer:
    it takes effect on the next step and builds no plan."""
    opt = opt_mod.create("sgd", learning_rate=1.0)
    upd = opt_mod.get_updater(opt)
    w = [nd.array(np.zeros((3,), np.float32))]
    g = [nd.array(np.array([10.0, -10.0, 0.5], np.float32))]
    upd.update_batch([0], g, w)
    np.testing.assert_allclose(w[0].asnumpy(), [-10.0, 10.0, -0.5],
                               rtol=1e-6)
    w[0]._set_data(nd.array(np.zeros((3,), np.float32))._data)
    opt.clip_gradient = 1.0                # what guard._apply_rescale does
    opt.rescale_grad = 0.5
    with assert_no_retrace():
        upd.update_batch([0], g, w)
    np.testing.assert_allclose(w[0].asnumpy(), [-1.0, 1.0, -0.25],
                               rtol=1e-6)


def test_in_place_update_counts_the_reference_donated_bytes():
    """The reference donates the weight and momentum buffers (512 bytes for
    an 8x8 float32 weight with momentum); the port rewrites the same
    bytes in place: the weight keeps its tensor, the gradient is left as
    it was."""
    opt = opt_mod.create("sgd", learning_rate=0.1, momentum=0.9)
    upd = opt_mod.get_updater(opt)
    w = [nd.array(np.ones((8, 8), np.float32))]
    g = [nd.array(np.ones((8, 8), np.float32))]
    buf = w[0]._data
    before = fused.stats()["fused_step_donated_bytes"]
    upd.update_batch([0], g, w)
    assert w[0]._data is buf, "the weight was not updated in place"
    np.testing.assert_allclose(buf.numpy(), 0.9, rtol=1e-6)
    np.testing.assert_array_equal(g[0].asnumpy(), 1.0)
    assert fused.stats()["fused_step_donated_bytes"] - before == 512


def test_set_data_copies_so_in_place_steps_stay_private():
    """A parameter set from another's array (``copy_params``, ``nd.array``
    of a weight) holds its own tensor: the fused step's in-place update
    of one net leaves its twin as it was."""
    net, tr = _dense_trainer()
    twin, _ = _dense_trainer()
    tmx.test_utils.copy_params(net, twin)
    kept = nd.array(net.weight.data())
    w0 = twin.weight.data().asnumpy().copy()
    _one_step(net, tr)
    np.testing.assert_array_equal(twin.weight.data().asnumpy(), w0)
    np.testing.assert_array_equal(kept.asnumpy(), w0)
    assert not np.array_equal(net.weight.data().asnumpy(), w0)


def test_tied_weights_take_the_per_parameter_path():
    """Two rows sharing one weight buffer cannot both be rewritten in
    place: the step falls back per parameter (the reference's aliased
    case)."""
    opt = opt_mod.create("sgd", learning_rate=0.1)
    upd = opt_mod.get_updater(opt)
    shared = nd.array(np.ones((2, 2), np.float32))
    g = [nd.array(np.ones((2, 2), np.float32))] * 2
    before = fused.stats()["fused_step_dispatches"]
    upd.update_batch([0, 1], g, [shared, shared])
    assert fused.stats()["fused_step_dispatches"] == before
    np.testing.assert_allclose(shared.asnumpy(), 0.8, rtol=1e-6)


# ------------------------------------------------------- bulk size knob
def test_bulk_size_chunks_the_step():
    shapes = [(3, 2)] * 10
    rng = np.random.RandomState(1)
    g0 = [rng.rand(*s).astype(np.float32) for s in shapes]
    w0 = [rng.rand(*s).astype(np.float32) for s in shapes]

    def run(bulk):
        opt = opt_mod.create("adam", learning_rate=0.01)
        upd = opt_mod.get_updater(opt)
        ws = [nd.array(w) for w in w0]
        gs = [nd.array(g) for g in g0]
        before = fused.stats()["fused_step_dispatches"]
        with engine.bulk(bulk) if bulk is not None \
                else contextlib.nullcontext():
            upd.update_batch(list(range(10)), gs, ws)
        return ws, fused.stats()["fused_step_dispatches"] - before

    whole, n_whole = run(None)
    chunked, n_chunked = run(4)
    assert n_whole == 1
    assert n_chunked == 3                  # ceil(10 / 4)
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


def test_bulk_chunked_census_skips_whole_step():
    """A NaN anywhere skips EVERY chunk (one global census)."""
    shapes = [(3, 2)] * 10
    opt = opt_mod.create("sgd", learning_rate=0.1, momentum=0.9)
    upd = opt_mod.get_updater(opt)
    ws = [nd.array(np.ones(s, np.float32)) for s in shapes]
    gs = [nd.array(np.ones(s, np.float32)) for s in shapes]
    gs[7] = nd.array(np.full((3, 2), np.nan, np.float32))
    with engine.bulk(4):
        ok = upd.update_batch(list(range(10)), gs, ws, census=True)
    assert not bool(ok.asnumpy())
    for w in ws:
        np.testing.assert_array_equal(w.asnumpy(), 1.0)
    for i in range(10):
        np.testing.assert_array_equal(upd.states[i].asnumpy(), 0.0)


def test_bulk_size_zero_disables_fusion():
    net, tr = _dense_trainer()
    _one_step(net, tr)
    before = fused.stats()["fused_step_dispatches"]
    with engine.bulk(0):
        assert not fused.fused_enabled()
        _one_step(net, tr)
    assert fused.stats()["fused_step_dispatches"] == before
    assert fused.fused_enabled()


@pytest.mark.parametrize("var", ["MXTPU_FUSED_STEP",
                                 "MXTPU_EXEC_BULK_EXEC_TRAIN"])
def test_env_escape_hatch(monkeypatch, var):
    monkeypatch.setenv(var, "0")
    assert not fused.fused_enabled()
    net, tr = _dense_trainer()
    before = fused.stats()["fused_step_dispatches"]
    _one_step(net, tr)
    assert fused.stats()["fused_step_dispatches"] == before


def test_trainer_fused_and_per_parameter_steps_are_equal(monkeypatch):
    """The default Gluon loop: fused and per-parameter Trainer steps from
    the same weights give the same weights, bit for bit."""
    def run():
        tmx.random.seed(3)
        net, tr = _dense_trainer(opt_params={"learning_rate": 0.1,
                                             "momentum": 0.9, "wd": 1e-3})
        for _ in range(4):
            _one_step(net, tr)
        return [p.data().asnumpy() for p in net.collect_params().values()]
    fused_w = run()
    monkeypatch.setenv("MXTPU_FUSED_STEP", "0")
    per_param = run()
    for a, b in zip(fused_w, per_param):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------- the lazy row branch
@pytest.mark.parametrize("name,kwargs", [("sgd", {}), ("adam", {}),
                                         ("adamw", {"wd": 0.01})])
def test_lazy_row_sparse_branch_matches_the_reference(name, kwargs):
    """Three steps of row-sparse gradients through update_batch: the active
    rows move as the reference's lazy branch moves them (within 1e-6),
    the others stay bit for bit, and nothing densifies."""
    rng = np.random.RandomState(5)
    w0 = rng.uniform(-1, 1, (20, 6)).astype(np.float32)
    to = opt_mod.create(name, learning_rate=0.05, **kwargs)
    jo = jopt.create(name, learning_rate=0.05, **kwargs)
    tu, ju = opt_mod.get_updater(to), jopt.get_updater(jo)
    tw, jw = [nd.array(w0)], [jmx.nd.array(w0)]
    touched = set()
    before = fused.stats()["fused_step_sparse_updates"]
    for _ in range(3):
        rows = np.unique(rng.randint(0, 20, 5))
        touched |= set(rows.tolist())
        vals = rng.uniform(-1, 1, (len(rows), 6)).astype(np.float32)
        tu.update_batch([0], [tsp.row_sparse_array((vals, rows),
                                                   shape=(20, 6))], tw)
        ju.update_batch([0], [jsp.row_sparse_array((vals, rows.astype(
            np.int32)), shape=(20, 6))], jw)
    assert fused.stats()["fused_step_sparse_updates"] - before == 3
    got, want = tw[0].asnumpy(), jw[0].asnumpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    idle = sorted(set(range(20)) - touched)
    np.testing.assert_array_equal(got[idle], w0[idle])


def test_zero_nnz_row_sparse_grad_updates_nothing():
    opt = opt_mod.create("adam", learning_rate=0.1)
    upd = opt_mod.get_updater(opt)
    w = [nd.array(np.ones((5, 3), np.float32))]
    g = tsp.zeros("row_sparse", (5, 3))
    upd.update_batch([0], [g], w)
    np.testing.assert_array_equal(w[0].asnumpy(), 1.0)
    assert opt._index_update_count[0] == 1


def test_row_slice_step_drops_padding_ids():
    """Ids past the table are plan padding: read clipped, never written."""
    opt = opt_mod.create("sgd", learning_rate=1.0)
    h = {"lr": 1.0, "wd": 0.0, "rescale": 1.0, "clip": 0.0}
    w = torch.ones(4, 2)
    ids = torch.tensor([1, 4, 9])
    g = torch.ones(3, 2)
    fused.row_slice_step(opt.tensor_step, w, None, ids, g, h)
    np.testing.assert_array_equal(w.numpy(), [[1, 1], [0, 0], [1, 1],
                                              [1, 1]])


# ------------------------------------------- the kernels' table, emulated
def _emulate_update(kind, plan, tensors):
    """A plain-PyTorch emulation of ``multi_tensor_update_kernel`` over
    ``plan``'s table: each block finds its entry (the last whose first
    block is <= its index), takes that entry's CHUNK elements and applies
    the rule with the float32 hypers the table holds."""
    t = plan.table
    by_ptr = {x.data_ptr(): x.view(-1) for x in tensors if x is not None}
    for b in range(plan.n_blocks):
        k = int(np.nonzero(t["first_block"] <= b)[0][-1])
        e = t[k]
        lo = (b - int(e["first_block"])) * mt.CHUNK
        hi = min(lo + mt.CHUNK, int(e["n"]))
        master = by_ptr.get(int(e["master"]))
        w = (master if master is not None else by_ptr[int(e["w"])])[lo:hi]
        g = by_ptr[int(e["g"])][lo:hi]
        if master is not None:
            g = g.float()
        s0 = by_ptr[int(e["s0"])][lo:hi] if e["s0"] else None
        s1 = by_ptr[int(e["s1"])][lo:hi] if e["s1"] else None
        lr, wd, rs, clip = (float(e[f]) for f in ("lr", "wd", "rescale",
                                                  "clip"))
        c = [float(x) for x in e["c"]]
        gr = g * rs
        if clip >= 0:
            gr = torch.clamp(gr, -clip, clip)
        if kind == "adamw":
            m = c[0] * s0 + c[1] * gr
            v = c[2] * s1 + c[3] * torch.square(gr)
            nw = w - lr * ((m * c[5]) / (torch.sqrt(v * c[6]) + c[4])
                           + wd * w)
            s0.copy_(m)
            s1.copy_(v)
        else:
            gw = gr + wd * w
            if kind == "sgd":
                nw = w - lr * gw
            elif kind == "sgd_mom":
                m = c[0] * s0 - lr * gw
                nw = w + m
                s0.copy_(m)
            elif kind == "nag":
                m = c[0] * s0 + gw
                nw = w - lr * (gw + c[0] * m)
                s0.copy_(m)
            else:
                m = c[0] * s0 + c[1] * gw
                v = c[2] * s1 + c[3] * gw * gw
                nw = w - lr * m / (torch.sqrt(v) + c[4])
                s0.copy_(m)
                s1.copy_(v)
        w.copy_(nw)
        if master is not None:
            by_ptr[int(e["w"])][lo:hi].copy_(nw.to(torch.float16))


@pytest.mark.parametrize("name,kwargs,kind", [
    ("sgd", {"wd": 1e-3}, "sgd"),
    ("sgd", {"momentum": 0.9, "clip_gradient": 0.3}, "sgd_mom"),
    ("nag", {"momentum": 0.9}, "nag"),
    ("adam", {"wd": 1e-3}, "adam"),
    ("adamw", {"wd": 0.01}, "adamw")])
@pytest.mark.parametrize("mp", [False, True], ids=["f32", "f16-master"])
def test_table_emulation_equals_the_per_tensor_twin(name, kwargs, kind, mp):
    """Three steps over tensors that straddle the 16,384-element chunks:
    the emulated blocks over the packed table (pointers, first blocks,
    storage codes, float32 hypers) equal ``tensor_step`` tensor by tensor,
    bit for bit."""
    shapes = [(mt.CHUNK * 2 + 5,), (7, 3), (mt.CHUNK,), (130, 129)]
    dt = torch.float16 if mp else torch.float32
    rng = np.random.RandomState(9)
    opts = [opt_mod.create(name, learning_rate=0.05, multi_precision=mp,
                           **kwargs) for _ in range(2)]
    assert opts[0].multi_tensor_kind() == kind
    w0 = [torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32)).to(dt)
          for s in shapes]
    runs = []
    for which, opt in enumerate(opts):
        ws = [w.clone() for w in w0]
        sts = [opt.create_state_multi_precision(i, nd.from_torch(w))
               for i, w in enumerate(ws)]
        sts = [opt_mod._state_tensors(s) for s in sts]
        rng_g = np.random.RandomState(11)
        for step in range(3):
            gs = [torch.from_numpy(rng_g.uniform(-1, 1, s).astype(
                np.float32)).to(dt) for s in shapes]
            hs = []
            for i in range(len(ws)):
                opt._update_count(i)
                hs.append(opt.fused_hypers(i))
            masters = [s[0] if mp else None for s in sts]
            subs = [s[1] if mp else s for s in sts]
            if which == 0:
                mt.multi_tensor_update_reference(opt.tensor_step, ws, gs,
                                                 subs, hs, masters)
                continue
            leaves = [[x for x in mt._leaves(s) if x is not None]
                      for s in subs]
            codes = [mt.storage_code(w, g, ls, m) for w, g, ls, m in
                     zip(ws, gs, leaves, masters)]
            assert codes == [3 if mp else 0] * len(ws)
            plan = mt.Plan([w.numel() for w in ws], codes)
            assert plan.n_blocks == 3 + 1 + 1 + 2
            s0 = [ls[0] if ls else None for ls in leaves]
            s1 = [ls[1] if len(ls) > 1 else None for ls in leaves]
            plan.fill(ws, gs, s0, s1, masters,
                      [opt.multi_tensor_hypers(h) for h in hs])
            _emulate_update(kind, plan, ws + gs + s0 + s1 + masters)
        runs.append((ws, sts))
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a, b)
    for sa, sb in zip(runs[0][1], runs[1][1]):
        for a, b in zip(mt._leaves(sa), mt._leaves(sb)):
            assert (a is None and b is None) or torch.equal(a, b)


def test_census_twin_and_plan():
    gs = [torch.ones(5), torch.zeros(mt.CHUNK + 1, dtype=torch.float16)]
    assert bool(mt.all_finite_reference(gs))
    gs[1][mt.CHUNK] = float("inf")
    assert not bool(mt.all_finite_reference(gs))
    sizes, codes = mt.census_layout(gs)
    assert sizes == [5, mt.CHUNK + 1] and codes == [0, 1]
    assert mt.Plan(sizes, codes).n_blocks == 3
    with pytest.raises(TypeError):
        mt.census_layout([torch.ones(2, dtype=torch.float64)])


def test_storage_codes_and_what_the_kernel_refuses():
    f32, f16, bf16 = (torch.zeros(2, dtype=d) for d in
                      (torch.float32, torch.float16, torch.bfloat16))
    assert mt.storage_code(f32, f32, [f32]) == 0
    assert mt.storage_code(f16, f16, [f16, f16]) == 1
    assert mt.storage_code(bf16, bf16, []) == 2
    assert mt.storage_code(f16, f16, [f32], master=f32) == 3
    for bad in ((f32, f16, []), (f16, f16, [f32]),
                (torch.zeros(2, dtype=torch.float64),) * 2 + ([],)):
        with pytest.raises(TypeError):
            mt.storage_code(*bad)


def test_kernel_wrappers_refuse_cpu_tensors():
    w, g = torch.zeros(4, 3), torch.ones(4, 3)
    plan = mt.Plan([12], [0])
    with pytest.raises(ValueError, match="CUDA"):
        mt.multi_tensor_update("sgd", plan, [w], [g], None, None, None,
                               [(0.1, 0.0, 1.0, -1.0, ())])
    with pytest.raises(ValueError, match="CUDA"):
        mt.multi_tensor_all_finite(plan, [g])
    with pytest.raises(ValueError, match="CUDA"):
        mt.row_sparse_update("sgd", w, None, None, torch.tensor([1]),
                             torch.ones(1, 3), (0.1, 0.0, 1.0, -1.0, ()))
    assert common.launch_counts()["multi_tensor_update"] == 0


def test_kernel_source_matches_the_wrapper():
    """The table layout, chunk and rule numbers of multi_tensor.cu are the
    wrapper's, the source is built, and each entry point is bound with as
    many parameters as its ctypes signature."""
    src = (Path(mt.__file__).parent / "csrc" / "multi_tensor.cu").read_text()
    bindings = (Path(mt.__file__).parent / "csrc" /
                "bindings.cpp").read_text()
    assert f"kChunk = {mt.CHUNK};" in src
    assert f"sizeof(MTEntry) == {mt.ENTRY_DTYPE.itemsize}" in src
    kinds = dict(re.findall(r"k(Sgd|SgdMom|Nag|Adam|AdamW) = (\d)", src))
    assert {"Sgd": 0, "SgdMom": 1, "Nag": 2, "Adam": 3, "AdamW": 4} == {
        k: int(v) for k, v in kinds.items()}
    assert any(p.name == "multi_tensor.cu" for p in common.SOURCES)
    for fn in ("mxt_multi_tensor_update", "mxt_multi_tensor_all_finite",
               "mxt_row_sparse_update"):
        params = re.search(rf"int {fn}\(([^)]*)\)", bindings).group(1)
        assert len(params.split(",")) == len(common._SIGNATURES[fn]), fn


def test_kernel_route_is_the_optimizer_class():
    for name, takes in (("sgd", True), ("nag", True), ("adam", True),
                        ("adamw", True), ("lbsgd", False), ("rmsprop", False),
                        ("signum", False), ("test", False)):
        assert fused.kernel_route(opt_mod.create(name)) is takes, name
    assert jfused.stats().keys() <= fused.stats().keys()
