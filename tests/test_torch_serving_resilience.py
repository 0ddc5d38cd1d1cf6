"""Serving resilience of the port's batch engine on the CPU: versioned hot
swaps (stage -> canary -> atomic flip -> drain -> release), deadline-aware
shedding with per-tenant queue quotas and priorities, and the per-model
self-healing ladder (retry -> rebuild -> degraded -> probe -> restore).
Ported from ``tests/test_serving_resilience.py``; its two HTTP-layer tests
(``:reload``, ``/readyz``, Retry-After) wait for the port's HTTP front end
(ROADMAP.md: the reference's ``tools/serve.py`` imports the JAX
package)."""
import threading
import time

import numpy as np
import pytest

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import chaos, serving, telemetry
from incubator_mxnet_tpu_torch.gluon import nn


def _mlp(seed=0, item_dim=16):
    tmx.random.seed(seed)
    with tmx.cpu():
        net = nn.HybridSequential()
        net.add(nn.Dense(32, activation="relu"), nn.Dense(10))
        net.initialize(tmx.init.Xavier())
        net.hybridize()
        net(tmx.nd.zeros((1, item_dim)))
    return net


def _engine(**kw):
    return serving.InferenceEngine(device="cpu", **kw)


@pytest.fixture
def threads_clean():
    """No chaos left armed, no serving threads left behind."""
    chaos.reset()

    def live():
        return sorted(t.name for t in threading.enumerate()
                      if t.name.startswith(("mxtpu-serve",
                                            "mxtpu-guard-watchdog")))
    before = live()
    yield
    chaos.reset()
    deadline = time.monotonic() + 5.0
    while live() != before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert live() == before, f"orphan threads: {live()} vs {before}"


def _slow(delay):
    def fn(x):
        time.sleep(delay)
        return x
    return fn


# ------------------------------------------------------------ hot swap
def test_hot_swap_under_load_bit_identity(threads_clean):
    """Swapping v1 -> v2 under continuous load drops nothing and every
    response is bit-exactly one version's output (never a blend)."""
    with _engine(max_batch=4, max_wait_ms=1.0) as eng:
        ep = eng.load_model("m", fn=lambda x: x + 1.0, item_shape=(4,))
        stop = threading.Event()
        deltas, errors = [], []

        def client(cid):
            i = 0
            while not stop.is_set():
                x = np.full((4,), float(cid * 1000 + i), np.float32)
                try:
                    out = ep.predict(x, timeout=30.0)
                    d = out - x
                    assert np.all(d == d[0])
                    deltas.append(float(d[0]))
                except Exception as e:  # noqa: BLE001 - recorded, asserted
                    errors.append(repr(e))
                i += 1

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.25)
        ep2 = eng.load_model("m", fn=lambda x: x + 2.0, item_shape=(4,))
        time.sleep(0.25)
        stop.set()
        for t in threads:
            t.join()
        assert ep2 is ep            # same Endpoint object, route kept
        assert ep.version == 2
        assert not errors, errors[:3]
        assert set(deltas) == {1.0, 2.0}      # both versions served
        assert deltas[-1] == 2.0
        assert telemetry.counter("mxtpu_serve_swaps_total").value(
            model="m", outcome="ok") >= 1.0


def test_hot_swap_net_stages_v2_and_releases_v1(threads_clean):
    """Swapping a ``net=`` model stages v2's buckets (no graph on the CPU:
    compiles stay 0), v2's answers equal v2's own forward of that bucket,
    and v1 is released (its entries and static parameters dropped)."""
    net1, net2 = _mlp(seed=0), _mlp(seed=1)
    x = np.arange(16, dtype=np.float32) / 16.0
    with tmx.cpu():
        ref2 = net2(tmx.nd.array(x[None])).asnumpy()[0]
    with _engine(max_batch=4, max_wait_ms=1.0) as eng:
        ep = eng.load_model("swapnet", net=net1, item_shape=(16,))
        ep.predict(x, timeout=30.0)
        v1 = ep.model
        before = eng.stats()["swapnet"]["compiles"]
        eng.load_model("swapnet", net=net2, item_shape=(16,))
        assert ep.model is not v1 and ep.version == 2
        assert v1._entries == {} and v1._state is None
        out = ep.predict(x, timeout=30.0)
        assert np.array_equal(out, ref2)
        assert eng.stats()["swapnet"]["compiles"] == before == 0
        assert eng.stats()["swapnet"]["buckets"] == [1, 2, 4]


def test_failed_canary_rolls_back(threads_clean):
    """A chaos-forced canary failure raises SwapError and leaves v1
    serving, untouched, at its old version."""
    with _engine(max_batch=2, max_wait_ms=1.0) as eng:
        ep = eng.load_model("m", fn=lambda x: x + 1.0, item_shape=(2,))
        chaos.arm("serve.swap_fail", 1.0, seed=3, times=1)
        with pytest.raises(serving.SwapError) as ei:
            eng.load_model("m", fn=lambda x: x + 2.0, item_shape=(2,))
        assert "canary" in str(ei.value)
        assert ep.version == 1
        out = ep.predict(np.zeros((2,), np.float32), timeout=30.0)
        assert float(out[0]) == 1.0           # still v1
        assert telemetry.counter("mxtpu_serve_swaps_total").value(
            model="m", outcome="canary_failed") >= 1.0


def test_canary_rejects_a_changed_output_contract(threads_clean):
    """A staged version whose outputs change row shape, or go non-finite
    on the all-zeros batch, fails its canary; v1 keeps serving."""
    with _engine(max_batch=2, max_wait_ms=1.0) as eng:
        ep = eng.load_model("c", fn=lambda x: x + 1.0, item_shape=(2,))
        with pytest.raises(serving.SwapError, match="row shape"):
            eng.load_model("c", fn=lambda x: np.concatenate([x, x], 1),
                           item_shape=(2,))
        with pytest.raises(serving.SwapError, match="non-finite"):
            eng.load_model("c", fn=lambda x: np.full_like(x, np.inf),
                           item_shape=(2,))
        assert ep.version == 1
        assert float(ep.predict(np.zeros(2, np.float32),
                                timeout=30.0)[0]) == 1.0


def test_failed_stage_rolls_back(threads_clean):
    """A v2 whose build violates the v1 contract (different item shape)
    is rejected at stage time; v1 never stops serving."""
    with _engine(max_batch=2, max_wait_ms=1.0) as eng:
        ep = eng.load_model("m", fn=lambda x: x * 2.0, item_shape=(2,))
        with pytest.raises(serving.SwapError):
            eng.load_model("m", fn=lambda x: x * 3.0, item_shape=(5,))
        assert ep.version == 1
        out = ep.predict(np.ones((2,), np.float32), timeout=30.0)
        assert float(out[0]) == 2.0
        assert telemetry.counter("mxtpu_serve_swaps_total").value(
            model="m", outcome="stage_failed") >= 1.0


# ------------------------------------------------------- deadline shed
def test_deadline_shed_guaranteed_miss_only(threads_clean):
    """Only a request whose queue wait alone already guarantees an SLO
    miss is shed; a request that can still make it is never shed."""
    with _engine(max_batch=1, max_wait_ms=1.0) as eng:
        ep = eng.load_model("slow", fn=_slow(0.15), item_shape=(1,))
        blocker = ep.submit(np.zeros((1,), np.float32))
        time.sleep(0.05)              # blocker now occupies the model
        doomed = ep.submit(np.zeros((1,), np.float32), deadline_ms=30)
        makeable = ep.submit(np.zeros((1,), np.float32),
                             deadline_ms=10_000)
        with pytest.raises(serving.DeadlineError) as ei:
            doomed.result(timeout=30.0)
        assert "shed before compute" in str(ei.value)
        makeable.result(timeout=30.0)
        blocker.result(timeout=30.0)
        assert telemetry.counter("mxtpu_serve_shed_total").value(
            model="slow", reason="deadline") >= 1.0


def test_deadline_unset_never_sheds(threads_clean):
    """Requests without a deadline are never shed no matter the wait."""
    with _engine(max_batch=1, max_wait_ms=1.0) as eng:
        ep = eng.load_model("slow", fn=_slow(0.05), item_shape=(1,))
        futs = [ep.submit(np.full((1,), i, np.float32))
                for i in range(8)]
        outs = [f.result(timeout=30.0) for f in futs]
        assert [float(o[0]) for o in outs] == list(map(float, range(8)))


def test_priority_orders_queue(threads_clean):
    """Higher-priority requests jump the queue at pack time."""
    order = []

    def fn(x):
        order.extend(np.asarray(x)[:, 0].tolist())
        return x
    eng = _engine(max_batch=1, max_wait_ms=1.0, start=False)
    ep = eng.load_model("p", fn=fn, item_shape=(1,))
    lo = ep.submit(np.full((1,), 1.0, np.float32), priority=0)
    hi = ep.submit(np.full((1,), 2.0, np.float32), priority=5)
    eng.start()
    hi.result(timeout=30.0)
    lo.result(timeout=30.0)
    eng.close()
    assert order[0] == 2.0, order


def test_tenant_quota_isolation(threads_clean):
    """Tenant A's flood hits its queue quota with a typed reject while
    tenant B (and quota-less traffic) keeps flowing."""
    with _engine(max_batch=1, max_wait_ms=1.0) as eng:
        ep = eng.load_model("q", fn=_slow(0.08), item_shape=(1,),
                            tenant_quota=2)
        ep.submit(np.zeros((1,), np.float32))   # occupy the model
        time.sleep(0.04)
        a = [ep.submit(np.zeros((1,), np.float32), tenant="A")
             for _ in range(2)]
        with pytest.raises(serving.QueueFullError) as ei:
            ep.submit(np.zeros((1,), np.float32), tenant="A")
        assert ei.value.reason == "quota"
        b = ep.submit(np.zeros((1,), np.float32), tenant="B")
        anon = ep.submit(np.zeros((1,), np.float32))
        for f in a + [b, anon]:
            f.result(timeout=30.0)
        assert telemetry.counter("mxtpu_serve_shed_total").value(
            model="q", reason="quota") >= 1.0


# --------------------------------------------------- self-healing ladder
class _Flaky:
    """Callable model with a rebuild() hook the ladder can exercise."""

    def __init__(self):
        self.rebuilds = 0

    def __call__(self, x):
        return x * 2.0

    def rebuild(self):
        self.rebuilds += 1


def test_ladder_walks_retry_rebuild_degrade_restore(threads_clean):
    """Three consecutive chaos dispatch failures walk retry -> rebuild ->
    degraded (fast-fail, ready() false); the probe then restores the
    model."""
    flaky = _Flaky()
    with _engine(max_batch=1, max_wait_ms=1.0) as eng:
        ep = eng.load_model("lad", fn=flaky, item_shape=(1,),
                            degrade_after=3, probe_every=0.05)
        chaos.arm("serve.dispatch_fail", 1.0, seed=2, times=3)
        for _ in range(3):
            with pytest.raises(serving.ServeError):
                ep.predict(np.ones((1,), np.float32), timeout=30.0)
        assert flaky.rebuilds == 1            # rung 2 fired once
        with pytest.raises(serving.ModelDegradedError) as ei:
            ep.submit(np.ones((1,), np.float32))
        assert "degraded" in str(ei.value)
        ok, states = eng.ready()
        assert not ok and states["lad"] == "degraded"
        assert eng.stats()["lad"]["state"] == "degraded"
        deadline = time.monotonic() + 10.0
        while not eng.ready()[0] and time.monotonic() < deadline:
            time.sleep(0.02)
        ok, states = eng.ready()
        assert ok and states["lad"] == "ready"
        out = ep.predict(np.ones((1,), np.float32), timeout=30.0)
        assert float(out[0]) == 2.0


def test_ladder_rebuilds_a_served_net(threads_clean):
    """The rebuild rung on a ``net=`` model builds every bucket's entry
    again from the static parameters; answers are unchanged."""
    net = _mlp(seed=2)
    x = np.linspace(0, 1, 16, dtype=np.float32)
    with _engine(max_batch=2, max_wait_ms=1.0) as eng:
        ep = eng.load_model("rb", net=net, item_shape=(16,),
                            degrade_after=3, probe_every=0.05)
        before = ep.predict(x, timeout=30.0)
        entries = dict(ep.model._entries)
        chaos.arm("serve.dispatch_fail", 1.0, seed=4, times=2)
        for _ in range(2):
            with pytest.raises(serving.ServeError):
                ep.predict(x, timeout=30.0)
        # the rung runs in the scheduler thread after the batch failed
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and not all(
                ep.model._entries.get(b, entries[b]) is not entries[b]
                for b in entries):
            time.sleep(0.01)
        with ep.model._lock:
            assert all(ep.model._entries[b] is not entries[b]
                       for b in entries)
        assert eng.ready()[0]
        assert np.array_equal(ep.predict(x, timeout=30.0), before)


def _wait_for(cond, seconds=10.0):
    deadline = time.monotonic() + seconds
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def _probe_now(eng, ep, every):
    with eng._cond:
        ep.probe_every_s = every
        ep._next_probe = 0.0
        eng._cond.notify_all()


def test_failed_rebuild_keeps_the_old_graphs_serving(threads_clean):
    """A rebuild rung whose build fails degrades the model and keeps its
    old bucket entries in place; a probe then runs on them, restores the
    model, and no slot is lost on the way."""
    net = _mlp(seed=3)
    x = np.linspace(0, 1, 16, dtype=np.float32)
    with _engine(max_batch=2, max_wait_ms=1.0) as eng:
        ep = eng.load_model("fr", net=net, item_shape=(16,),
                            degrade_after=3, probe_every=3600.0)
        model = ep.model
        before = ep.predict(x, timeout=30.0)
        entries = dict(model._entries)
        slots = model._free.qsize()
        builds = []

        def failing_build():
            builds.append(1)
            raise RuntimeError("capture failed")

        model._build = failing_build
        chaos.arm("serve.dispatch_fail", 1.0, seed=4, times=2)
        for _ in range(2):
            with pytest.raises(serving.ServeError):
                ep.predict(x, timeout=30.0)
        assert _wait_for(lambda: ep.state == "degraded")
        assert builds == [1] and "capture failed" in ep._degrade_err
        with model._lock:
            assert model._entries == entries
        assert model._free.qsize() == slots
        _probe_now(eng, ep, 0.05)
        assert _wait_for(lambda: eng.ready()[0])
        assert model._free.qsize() == slots
        assert np.array_equal(ep.predict(x, timeout=30.0), before)
        assert model._free.qsize() == slots


def test_failing_probes_return_their_slots(threads_clean):
    """Probes whose dispatch fails after the batch was packed (here: no
    graph for the bucket) hand their slot back each time: many more
    probes than slots neither hang the scheduler nor lose a slot, and
    the model stays degraded until a probe succeeds."""
    net = _mlp(seed=4)
    x = np.linspace(0, 1, 16, dtype=np.float32)
    with _engine(max_batch=2, max_wait_ms=1.0, inflight=2) as eng:
        ep = eng.load_model("fp", net=net, item_shape=(16,),
                            degrade_after=1, probe_every=3600.0)
        model = ep.model
        slots = model._free.qsize()
        before = ep.predict(x, timeout=30.0)
        packs = []
        pack = model.pack

        def counting_pack(rows, bucket):
            packs.append(bucket)
            return pack(rows, bucket)

        model.pack = counting_pack
        with model._lock:
            entries, model._entries = model._entries, {}
        with pytest.raises(serving.ServeError) as ei:
            ep.predict(x, timeout=30.0)
        assert "no graph for bucket" in str(ei.value)
        assert _wait_for(lambda: ep.state == "degraded")
        _probe_now(eng, ep, 0.001)
        assert _wait_for(lambda: len(packs) >= 3 * slots)
        assert ep.state == "degraded"
        with model._lock:
            model._entries = entries
        assert _wait_for(lambda: eng.ready()[0])
        assert model._free.qsize() == slots
        assert np.array_equal(ep.predict(x, timeout=30.0), before)


def test_swap_drains_a_batch_held_before_the_flip(threads_clean):
    """A batch that took v1 before the route flip counts as in flight
    from that moment: the swap releases v1 only after it is done."""
    net1, net2 = _mlp(seed=0), _mlp(seed=1)
    with _engine(max_batch=2, max_wait_ms=1.0) as eng:
        ep = eng.load_model("hold", net=net1, item_shape=(16,))
        v1 = eng._hold(ep)
        swap = threading.Thread(target=eng.load_model, args=("hold",),
                                kwargs=dict(net=net2, item_shape=(16,)))
        swap.start()
        try:
            assert _wait_for(lambda: ep.model is not v1)
            time.sleep(0.2)
            assert v1._state is not None and v1._entries
            assert swap.is_alive()
        finally:
            eng._unhold(v1)
            swap.join(30.0)
        assert not swap.is_alive()
        assert v1._entries == {} and v1._state is None


def test_degrade_flushes_queue_typed(threads_clean):
    """Entering degraded fails everything queued with the typed error."""
    with _engine(max_batch=1, max_wait_ms=1.0) as eng:
        ep = eng.load_model("d", fn=_slow(0.05), item_shape=(1,),
                            degrade_after=1, probe_every=60.0)
        chaos.arm("serve.dispatch_fail", 1.0, seed=5, times=2)
        futs = [ep.submit(np.zeros((1,), np.float32)) for _ in range(4)]
        failed = []
        for f in futs:
            with pytest.raises((serving.ServeError,
                                serving.ModelDegradedError)) as ei:
                f.result(timeout=30.0)
            failed.append(type(ei.value).__name__)
        assert "ModelDegradedError" in failed


def test_chaos_script_is_deterministic(threads_clean):
    """The same chaos script (skip/times) fails the same dispatch on every
    run."""
    def run():
        chaos.reset()
        chaos.arm("serve.dispatch_fail", 1.0, seed=9, times=1, skip=2)
        outcomes = []
        with _engine(max_batch=1, max_wait_ms=1.0) as eng:
            ep = eng.load_model("det", fn=lambda x: x, item_shape=(1,),
                                degrade_after=10)
            for i in range(6):
                try:
                    ep.predict(np.full((1,), i, np.float32), timeout=30.0)
                    outcomes.append("ok")
                except serving.ServeError:
                    outcomes.append("fail")
        chaos.reset()
        return outcomes

    first, second = run(), run()
    assert first == second
    assert first.count("fail") == 1 and first[2] == "fail", first
