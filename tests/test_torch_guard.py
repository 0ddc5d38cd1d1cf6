"""The port's training guard (``incubator_mxnet_tpu_torch/guard.py``) on the
CPU: the policy, the NaN/Inf sentinel, the loss-spike detector, the
skip -> rescale -> rollback ladder with its LR backoff, the hung-step
watchdog, the chaos points, ``check_tensors`` and ``gluon.Trainer(guard=)``
skipping a NaN update on the per-parameter step and, through its device
census, on the fused step (the cases of ``tests/test_fused_step.py``);
the same scripted losses through the JAX package's guard give the same
ladder. Ported from ``tests/test_guard.py``; its cases that need ``fault.py`` (A10),
``module/`` or ``monitor.py`` (A11) wait for those items (ROADMAP.md).
The rollback rung restores through a checkpoint-manager double that keeps
weights in memory (``latest()`` / ``restore()``, the interface the guard
calls)."""
import logging
import math
import time

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import guard as jguard
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import chaos, gluon, nd
from incubator_mxnet_tpu_torch.guard import (OK, RESCALE, ROLLBACK, SKIP,
                                             GuardPolicy, GuardRollbackError,
                                             GuardTripError, StepHungError,
                                             TrainingGuard)


@pytest.fixture(autouse=True)
def _cpu_and_clean_chaos():
    chaos.reset()
    with tmx.cpu():
        yield
    chaos.reset()


class _MemoryCheckpoints:
    """Checkpoints in memory: ``save(step, net)``; ``latest()`` is the
    newest step not marked corrupt; ``restore`` loads a step's weights."""

    keep = 5

    def __init__(self):
        self.saved, self.corrupt = {}, set()

    def save(self, step, net):
        self.saved[step] = {k: p.data().asnumpy().copy() for k, p in
                            net._collect_params_with_prefix().items()}

    def latest(self):
        good = [s for s in self.saved if s not in self.corrupt]
        return max(good) if good else None

    def restore(self, net=None, trainer=None, module=None, step=None):
        for k, p in net._collect_params_with_prefix().items():
            p.set_data(nd.array(self.saved[step][k]))
        return {"step": step}


def _small_state(lr=0.1, optimizer="sgd", **trainer_kw):
    net = gluon.nn.Dense(4, in_units=3)
    net.initialize(tmx.init.Xavier())
    trainer = gluon.Trainer(net.collect_params(), optimizer,
                            {"learning_rate": lr}, **trainer_kw)
    with tmx.autograd.record():
        loss = net(nd.ones((2, 3))).sum()
    loss.backward()
    trainer.step(2)
    return net, trainer


# ------------------------------------------------------------------ policy
def test_policy_env_overrides(monkeypatch):
    monkeypatch.setenv("MXTPU_GUARD_SPIKE_WINDOW", "5")
    monkeypatch.setenv("MXTPU_GUARD_LR_BACKOFF", "0.25")
    monkeypatch.setenv("MXTPU_STEP_TIMEOUT", "1.5")
    p = GuardPolicy()
    assert p.spike_window == 5
    assert p.lr_backoff == 0.25
    assert p.step_timeout == 1.5
    # explicit kwargs win over the env
    p = GuardPolicy(spike_window=9, step_timeout=0.0)
    assert p.spike_window == 9 and p.step_timeout == 0.0


def test_policy_validates():
    with pytest.raises(ValueError):
        GuardPolicy(lr_backoff=0.0)
    with pytest.raises(ValueError):
        GuardPolicy(spike_window=1)


# ------------------------------------------------------- sentinels + ladder
def test_nan_ladder_skip_rescale_rollback():
    """The full degradation ladder on repeated NaN losses: skip, then
    rescale (grad-clip tightened, loss scale halved), then rollback to the
    noted checkpoint with the LR backed off."""
    net, tr = _small_state(lr=0.1)
    mgr = _MemoryCheckpoints()
    mgr.save(5, net)
    w5 = net.weight.data().asnumpy().copy()

    g = TrainingGuard(GuardPolicy(skip_limit=1, rescale_limit=1,
                                  max_rollbacks=2, spike_window=8,
                                  spike_min_history=4),
                      manager=mgr, net=net, trainer=tr)
    g.note_checkpoint(5)
    for i in range(4):
        assert g.check_loss(i, 1.0) == OK

    assert g.check_loss(10, float("nan")) == SKIP
    assert g.check_loss(11, float("inf")) == RESCALE
    assert tr.optimizer.clip_gradient == pytest.approx(1.0)
    assert g.loss_scale == pytest.approx(0.5)
    assert tr._scale == pytest.approx(0.5)     # rescale actually applied

    net.weight.set_data(nd.ones((4, 3)))       # poisoned state to rewind
    assert g.check_loss(12, float("nan")) == ROLLBACK
    np.testing.assert_allclose(net.weight.data().asnumpy(), w5)
    assert g.restored_meta["step"] == 5
    assert tr.learning_rate == pytest.approx(0.05)   # lr_backoff=0.5
    assert [e.action for e in g.events] == ["skip", "rescale", "rollback"]
    assert g.summary()["rollbacks"] == 1


def test_spike_detector_median_mad():
    g = TrainingGuard(GuardPolicy(spike_window=8, spike_min_history=4,
                                  spike_mad=6.0, skip_limit=5))
    for i in range(6):
        assert g.check_loss(i, 1.0 + 0.001 * i) == OK
    assert g.check_loss(7, 1.05) == OK          # ordinary wiggle
    assert g.check_loss(8, 100.0) == SKIP       # a real spike
    assert g.events[-1].kind == "spike"
    # the spike never entered the window: the next normal loss is clean
    assert g.check_loss(9, 1.01) == OK


def test_ladder_heals_after_clean_streak():
    g = TrainingGuard(GuardPolicy(skip_limit=1, rescale_limit=1,
                                  recovery_steps=3, spike_min_history=50))
    assert g.check_loss(1, float("nan")) == SKIP
    for i in range(3):
        assert g.check_loss(2 + i, 1.0) == OK
    # the clean streak reset the ladder: next trip skips again instead of
    # escalating to rescale
    assert g.check_loss(9, float("nan")) == SKIP


def test_chaos_points_inject_nan_and_spike():
    chaos.arm("guard.nan", prob=1.0, times=1)
    g = TrainingGuard(GuardPolicy(skip_limit=5, spike_min_history=4,
                                  spike_window=8))
    assert g.check_loss(1, 0.5) == SKIP
    assert g.events[-1].kind == "nan"
    assert "chaos:guard.nan" in g.events[-1].detail
    for i in range(5):
        assert g.check_loss(2 + i, 0.5) == OK
    chaos.arm("guard.spike", prob=1.0, times=1)
    assert g.check_loss(10, 0.5) == SKIP
    assert g.events[-1].kind == "spike"
    assert "chaos:guard.spike" in g.events[-1].detail


@pytest.mark.parametrize("kind", ["numpy", "tensor", "ndarray"])
def test_check_tensors_names_the_tensor(kind):
    """numpy arrays, torch tensors and NDArrays alike; the first
    non-finite one names the trip."""
    g = TrainingGuard(GuardPolicy(skip_limit=5))
    bad = np.ones((2, 2), np.float32)
    bad[1, 1] = np.nan
    wrap = {"numpy": lambda a: a, "tensor": torch.from_numpy,
            "ndarray": nd.array}[kind]
    assert g.check_tensors(3, [("grad:ok", wrap(np.ones(2, np.float32))),
                               ("grad:dense0_weight", wrap(bad))]) == SKIP
    assert g.events[-1].detail == "grad:dense0_weight"
    assert g.check_tensors(4, [("grad:ok", wrap(np.ones(2,
                                                        np.float32)))]) == OK


def test_rollback_without_manager_raises():
    g = TrainingGuard(GuardPolicy(skip_limit=0, rescale_limit=0))
    with pytest.raises(GuardTripError, match="no CheckpointManager"):
        g.check_loss(1, float("nan"))
    assert g.events[-1].action == "raise"


def test_rollback_budget_exhausted_raises():
    net, tr = _small_state()
    mgr = _MemoryCheckpoints()
    mgr.save(1, net)
    g = TrainingGuard(GuardPolicy(skip_limit=0, rescale_limit=0,
                                  max_rollbacks=1, recovery_steps=100),
                      manager=mgr, net=net, trainer=tr)
    g.note_checkpoint(1)
    assert g.check_loss(2, float("nan")) == ROLLBACK
    with pytest.raises(GuardTripError, match="rollback"):
        g.check_loss(3, float("nan"))


def test_rollback_pruned_target_surfaces_clear_error():
    """When every checkpoint the guarded run saved is gone (pruned or
    corrupt), rollback raises GuardRollbackError instead of restoring a
    step that predates guarded training; with none noted, it refuses at
    once."""
    net, tr = _small_state()
    mgr = _MemoryCheckpoints()
    for s in (0, 5, 7):                 # 0 pre-exists, NOT noted
        mgr.save(s, net)
    g = TrainingGuard(GuardPolicy(skip_limit=0, rescale_limit=0),
                      manager=mgr, net=net, trainer=tr)
    g.note_checkpoint(5)
    g.note_checkpoint(7)
    mgr.corrupt.update({5, 7})
    with pytest.raises(GuardRollbackError, match="predates"):
        g.check_loss(9, float("nan"))
    g2 = TrainingGuard(GuardPolicy(skip_limit=0, rescale_limit=0),
                       manager=mgr, net=net, trainer=tr)
    with pytest.raises(GuardRollbackError, match="before any"):
        g2.check_loss(1, float("nan"))


def test_lr_backoff_through_backoff_scheduler():
    from incubator_mxnet_tpu_torch.lr_scheduler import BackoffScheduler
    sched = BackoffScheduler(base_lr=0.2, factor=0.5, min_lr=0.01)
    net = gluon.nn.Dense(2, in_units=2)
    net.initialize(tmx.init.Xavier())
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.2, "lr_scheduler": sched})
    with tmx.autograd.record():
        loss = net(nd.ones((2, 2))).sum()
    loss.backward()
    tr.step(2)
    mgr = _MemoryCheckpoints()
    mgr.save(1, net)
    g = TrainingGuard(GuardPolicy(skip_limit=0, rescale_limit=0,
                                  lr_backoff=0.5),
                      manager=mgr, net=net, trainer=tr)
    g.note_checkpoint(1)
    assert g.check_loss(2, float("nan")) == ROLLBACK
    assert tr.optimizer.lr_scheduler.backoff == pytest.approx(0.5)
    assert tr.learning_rate == pytest.approx(0.1)
    assert "scheduler" in g.events[-1].detail
    # min_lr floors repeated backoffs
    for _ in range(10):
        sched.step_back()
    assert sched(0) == pytest.approx(0.01)


def test_ladder_matches_the_jax_guard():
    """One scripted loss sequence (NaN, spikes, a clean streak, an Inf)
    through both packages' guards: the same action for every step and the
    same events (step, kind, action)."""
    losses = [1.0, 1.01, 0.99, 1.02, 1.0, float("nan"), 1.0, 50.0, 1.01,
              1.0, 0.98, 1.0, 1.02, 80.0, float("inf"), 1.0]
    kw = dict(skip_limit=2, rescale_limit=3, spike_window=8,
              spike_min_history=4, spike_mad=6.0, recovery_steps=4)
    tg = TrainingGuard(GuardPolicy(**kw))
    jg = jguard.TrainingGuard(jguard.GuardPolicy(**kw))
    got = [tg.check_loss(i, v) for i, v in enumerate(losses)]
    want = [jg.check_loss(i, v) for i, v in enumerate(losses)]
    assert got == want
    assert [(e.step, e.kind, e.action) for e in tg.events] == \
        [(e.step, e.kind, e.action) for e in jg.events]
    assert tg.summary() == jg.summary()


def test_deferred_losses_flush_in_one_copy():
    """``note_loss`` keeps losses as tensors; ``flush_losses`` reads them
    in step order (one copy for the tensors) and returns the most severe
    action."""
    g = TrainingGuard(GuardPolicy(skip_limit=5))
    g.note_loss(1, torch.tensor(0.5))
    g.note_loss(2, nd.array(np.array([float("nan")], np.float32)))
    g.note_loss(3, 0.5)
    assert g.flush_losses() == SKIP
    assert g.host_syncs == 1 and g.last_flush == (3, OK)
    assert [(e.step, e.kind) for e in g.events] == [(2, "nan")]
    assert g.flush_losses() == OK               # the queue is empty


def test_fused_census_waits_for_the_fused_step():
    """A queued census resolves at the next fused step's hook (or an
    explicit flush): a passing one marks the step clean, a failing one
    trips the ladder with the census's detail."""
    g = TrainingGuard(GuardPolicy(skip_limit=5))
    g.note_device_census(torch.tensor(True))
    assert g.fused_grads_ok(None) and g.events == []
    g.note_device_census(torch.tensor(False))
    assert g.events == []                        # not read yet
    assert g.fused_grads_ok(None)                # SKIP: proceed
    assert [(e.kind, e.action, e.detail) for e in g.events] == [
        ("nan", SKIP, "fused census (device)")]
    g.note_device_census(nd.array(np.zeros((), np.float32)))
    assert g.flush_census() and len(g.events) == 2
    assert g.flush_census()                      # the queue is empty


# ------------------------------------------------------------- integrations
def test_trainer_guard_skips_nan_update():
    net, tr = _small_state(lr=0.1, guard=GuardPolicy(skip_limit=5))
    w = net.weight.data().asnumpy().copy()
    chaos.arm("guard.nan", prob=1.0, times=1)
    tr.step(2)                                  # sentinel trips: no update
    np.testing.assert_allclose(net.weight.data().asnumpy(), w)
    assert tr.guard.events[-1].kind == "nan"
    tr.step(2)                                  # clean: update applies
    assert not np.allclose(net.weight.data().asnumpy(), w)


def test_trainer_guard_checks_real_gradients(caplog, monkeypatch):
    """A NaN in a gradient (no chaos) is caught on the per-parameter step
    (``MXTPU_FUSED_STEP=0``; the fused step's census is the test below);
    a bound guard object is kept as given, and its logger records the
    trip."""
    monkeypatch.setenv("MXTPU_FUSED_STEP", "0")
    g = TrainingGuard(GuardPolicy(skip_limit=5))
    g.ensure_logger()
    net = gluon.nn.Dense(4, in_units=3)
    net.initialize(tmx.init.Xavier())
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                       guard=g)
    assert tr.guard is g and g.trainer is tr
    w = net.weight.data().asnumpy().copy()
    x = nd.array(np.array([[1.0, float("nan"), 0.0]] * 2, np.float32))
    with tmx.autograd.record():
        loss = net(x).sum()
    loss.backward()
    with caplog.at_level(logging.INFO):
        tr.step(2)
    np.testing.assert_array_equal(net.weight.data().asnumpy(), w)
    assert g.events[-1].kind == "nan" and "grad:" in g.events[-1].detail
    assert any("GUARD" in r.getMessage() for r in caplog.records)


# ------------------------------------- the fused step's census (ported
# from tests/test_fused_step.py)
def _dense_trainer(**kw):
    net = gluon.nn.Dense(4, in_units=3)
    net.initialize(tmx.init.Xavier())
    return net, gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1}, **kw)


def _one_step(net, tr, batch=2):
    with tmx.autograd.record():
        loss = net(nd.ones((batch, 3))).sum()
    loss.backward()
    tr.step(batch)


def _poisoned_step(net, tr):
    with tmx.autograd.record():
        loss = net(nd.ones((2, 3))).sum()
    loss.backward()
    gw = net.weight.grad()
    gw._set_data(nd.array(np.full(gw.shape, np.nan, np.float32))._data)
    tr.step(2)


def test_census_rollback_drops_inflight_step(monkeypatch):
    """A failed census that trips all the way to ROLLBACK drops the
    in-flight step: its gradients were computed against the pre-rollback
    weights."""
    from incubator_mxnet_tpu_torch import guard as guard_mod
    net, tr = _dense_trainer(guard=GuardPolicy(skip_limit=5))
    _one_step(net, tr)
    monkeypatch.setattr(guard_mod.TrainingGuard, "_trip",
                        lambda self, *a, **k: ROLLBACK)
    tr.guard.note_device_census(nd.array(np.zeros((), np.float32)))
    w = net.weight.data().asnumpy().copy()
    _one_step(net, tr)
    np.testing.assert_array_equal(net.weight.data().asnumpy(), w)


def test_fused_chaos_nan_parity():
    """The guard.nan chaos point skips the fused step synchronously, as it
    does the per-parameter one."""
    from incubator_mxnet_tpu_torch.optimizer import fused
    net, tr = _dense_trainer(guard=GuardPolicy(skip_limit=5))
    _one_step(net, tr)
    w = net.weight.data().asnumpy().copy()
    before = fused.stats()["fused_step_dispatches"]
    chaos.arm("guard.nan", prob=1.0, times=1)
    _one_step(net, tr)
    np.testing.assert_allclose(net.weight.data().asnumpy(), w)
    assert tr.guard.events[-1].kind == "nan"
    assert fused.stats()["fused_step_dispatches"] == before
    _one_step(net, tr)
    assert not np.allclose(net.weight.data().asnumpy(), w)


def test_fused_census_skips_nan_update_on_device():
    """A real non-finite gradient: the census skips the whole update on
    the device (weights and bias intact, no host read in the step), and
    the ladder trips when the census is read."""
    net, tr = _dense_trainer(guard=GuardPolicy(skip_limit=5))
    _one_step(net, tr)
    w = net.weight.data().asnumpy().copy()
    b = net.bias.data().asnumpy().copy()
    n_events = len(tr.guard.events)
    _poisoned_step(net, tr)
    np.testing.assert_array_equal(net.weight.data().asnumpy(), w)
    np.testing.assert_array_equal(net.bias.data().asnumpy(), b)
    tr.guard.flush_census()
    assert len(tr.guard.events) == n_events + 1
    assert tr.guard.events[-1].kind == "nan"
    assert "fused census" in tr.guard.events[-1].detail
    _one_step(net, tr)
    assert not np.allclose(net.weight.data().asnumpy(), w)


def test_fused_census_resolves_at_next_step():
    net, tr = _dense_trainer(guard=GuardPolicy(skip_limit=5))
    _one_step(net, tr)
    n_events = len(tr.guard.events)
    _poisoned_step(net, tr)
    assert len(tr.guard.events) == n_events      # not read yet
    _one_step(net, tr)
    assert len(tr.guard.events) == n_events + 1
    assert tr.guard.events[-1].kind == "nan"


def test_guard_ladder_counts_match_legacy():
    """The same injected-NaN schedule on the fused and the per-parameter
    step gives the same ladder events."""
    def run(fused_on):
        mp = pytest.MonkeyPatch()
        try:
            if not fused_on:
                mp.setenv("MXTPU_FUSED_STEP", "0")
            net, tr = _dense_trainer(
                guard=GuardPolicy(skip_limit=2, rescale_limit=1))
            _one_step(net, tr)
            chaos.arm("guard.nan", prob=1.0, times=2)
            for _ in range(4):
                _one_step(net, tr)
            return [(e.kind, e.action) for e in tr.guard.events]
        finally:
            mp.undo()
            chaos.reset()
    legacy, fused_events = run(False), run(True)
    assert fused_events == legacy
    assert [k for k, _ in fused_events] == ["nan", "nan"]


# --------------------------------------------------------------- watchdog
def test_watchdog_hang_raises_with_stacks(caplog):
    chaos.arm("guard.hang", prob=1.0, times=1)
    g = TrainingGuard(GuardPolicy(step_timeout=0.3))
    t0 = time.monotonic()
    with caplog.at_level(logging.ERROR,
                         logger="incubator_mxnet_tpu_torch.guard"):
        with pytest.raises(StepHungError, match="forward"):
            with g.watch("forward", step=3):
                pass            # the chaos hang fires inside the phase
    elapsed = time.monotonic() - t0
    assert elapsed < 3.0        # interrupted near the 0.3s deadline
    text = caplog.text
    assert "MXTPU_STEP_TIMEOUT" in text
    assert "Thread MainThread" in text          # stack dump present
    assert g.events[-1].kind == "hang" and g.events[-1].detail == "forward"
    g.close()


def test_watchdog_disabled_and_fast_phase():
    g = TrainingGuard(GuardPolicy(step_timeout=0.0))
    with g.watch("forward"):
        pass                    # no watchdog armed at all
    g2 = TrainingGuard(GuardPolicy(step_timeout=5.0))
    for phase in ("data", "forward", "step", "ckpt"):
        with g2.watch(phase, step=1):
            time.sleep(0.001)   # well under the deadline: no trip
    assert g2.events == []
    g2.close()


# ------------------------------------------------- satellite: Retry hygiene
def test_retry_backoff_never_overflows_and_stays_capped():
    r = chaos.Retry(max_attempts=10, base=0.05, cap=2.0, jitter=0.5, seed=1)
    for attempt in (0, 10, 63, 64, 1500, 10**6):
        d = r.backoff(attempt)
        assert 0.0 <= d <= 2.0
    # huge base must saturate at the cap, not raise
    r = chaos.Retry(max_attempts=2, base=1e300, cap=0.5, jitter=0.0)
    assert r.backoff(5000) == pytest.approx(0.5)


def test_retry_jitter_deterministic_under_test_seed(monkeypatch):
    monkeypatch.setenv("MXTPU_TEST_SEED", "7")
    a = chaos.Retry(max_attempts=5, base=0.1, cap=1.0, jitter=0.5)
    b = chaos.Retry(max_attempts=5, base=0.1, cap=1.0, jitter=0.5)
    assert [a.backoff(i) for i in range(6)] == \
        [b.backoff(i) for i in range(6)]
    c = chaos.Retry(max_attempts=5, base=0.1, cap=1.0, jitter=0.5, seed=9)
    d = chaos.Retry(max_attempts=5, base=0.1, cap=1.0, jitter=0.5, seed=9)
    assert [c.backoff(i) for i in range(6)] == \
        [d.backoff(i) for i in range(6)]


# --------------------------------------------- satellite: NaN-safe metrics
def test_metric_nan_update_does_not_poison_accumulator():
    m = tmx.metric.MAE()
    m.update([np.array([1.0, 2.0])], [np.array([1.5, 2.5])])
    assert m.get()[1] == pytest.approx(0.5)
    m.update([np.array([1.0, np.nan])], [np.array([1.0, 1.0])])
    assert m.get()[1] == pytest.approx(0.5)     # unchanged, not NaN
    assert m.num_nan == 1
    m.update([np.array([3.0])], [np.array([4.0])])
    assert m.get()[1] == pytest.approx(0.75)    # still accumulating


def test_metric_nan_safe_on_device_path():
    m = tmx.metric.MSE()
    m.update([nd.array(np.array([1.0, 2.0], np.float32))],
             [nd.array(np.array([1.0, 2.0], np.float32))])
    m.update([nd.array(np.array([np.nan], np.float32))],
             [nd.array(np.array([1.0], np.float32))])
    assert m.get()[1] == pytest.approx(0.0)
    assert m.num_nan == 1
    m.reset()
    assert m.num_nan == 0


def test_perplexity_nan_safe_drops_paired_count():
    m = tmx.metric.Perplexity(ignore_label=None)
    pred = np.full((4, 3), 1 / 3, np.float32)
    label = np.array([0, 1, 2, 0], np.float32)
    m.update([label], [pred])
    base = m.get()[1]
    assert math.isfinite(base)
    m.update([label], [np.full((4, 3), np.nan, np.float32)])
    assert m.get()[1] == pytest.approx(base)
    assert m.num_nan == 1
