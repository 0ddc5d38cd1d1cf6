"""The port's batch serving engine (``serving.InferenceEngine.load_model(
net=/fn=)``) on the CPU.

Against the JAX engine: the reference test's MLP (16 -> 32 ReLU -> 10) and
a ``resnet18_v1`` at 32 x 32, built in both packages with the JAX block's
parameters carried across (``gluon.utils.params_from_jax``); the same
seeded requests through both engines agree row by row within 1e-5 (MLP)
and 1e-4 (ResNet), the JAX side under
``jax.default_matmul_precision("highest")``.

Ported from ``tests/test_serving.py``: bucket padding, the deadline flush,
backpressure, weighted fairness, unload, the chaos points, the watchdog and
its flight dump, drain, telemetry. ``test_mlir_endpoint_and_batch_contract``
becomes the check that ``mlir=`` (A11) raises;
``test_launch_merge_handles_serving_rank`` waits for the HTTP front end
(ROADMAP.md). The reference's pack/pad bit identity across buckets rests on
a property of XLA's CPU backend; the port's contract is: a bucket's output
equals the same bucket's eager forward bit for bit, padding rows never
change real rows within a bucket, and rows agree across buckets within
1e-5.

New here: in-flight outputs survive the next dispatch of the same bucket
(each batch's outputs are copied into a slot of its own), the compiles
counter stays at 0 on the CPU (no graph), the bucket graph's launch-count
bookkeeping with a stub graph, a served net's random draws, and one engine
holding a batch and a generate endpoint.
"""
import contextlib
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import jax

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import serving as jserving
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import chaos, serving, telemetry
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.gluon.utils import params_from_jax
from incubator_mxnet_tpu_torch.guard import StepHungError
from incubator_mxnet_tpu_torch.ops.cuda import common
from incubator_mxnet_tpu_torch.ops.cuda import softmax as ksm

ROW_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _port_chaos_reset():
    """The port keeps its own chaos registry: nothing armed here may leak
    into the next test."""
    chaos.reset()
    yield
    chaos.reset()


@pytest.fixture
def engine_threads_clean():
    """The test leaves no serving or watchdog thread behind."""
    def live():
        return sorted(t.name for t in threading.enumerate()
                      if t.name.startswith(("mxtpu-serve",
                                            "mxtpu-guard-watchdog")))
    before = live()
    yield
    deadline = time.monotonic() + 5.0
    while live() != before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert live() == before, f"orphan threads: {live()} vs {before}"


def _mlp_make(mx):
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(32, activation="relu"),
            mx.gluon.nn.Dense(10))
    return net


def _mlp(seed=0):
    tmx.random.seed(seed)
    with tmx.cpu():
        net = _mlp_make(tmx)
        net.initialize(tmx.init.Xavier())
        net.hybridize()
        net(tmx.nd.zeros((1, 16)))
    return net


def _requests(n, shape=(16,), seed=0):
    rng = np.random.RandomState(seed)
    return [rng.rand(*shape).astype(np.float32) for _ in range(n)]


def _refs(net, xs):
    with tmx.cpu():
        return [net(tmx.nd.array(x[None])).asnumpy()[0] for x in xs]


def _engine(**kw):
    return serving.InferenceEngine(device="cpu", **kw)


def _rows_close(res, refs, tol=ROW_TOL):
    for a, b in zip(res, refs):
        np.testing.assert_allclose(a, b, **tol)


# ------------------------------------------------- against the JAX engine
def _jax_pair(make, x_np):
    """(jax net, port net) of ``make(package)``, the JAX net's parameters
    in both."""
    with jmx.name.NameManager():
        jnet = make(jmx)
    jnet.initialize(jmx.init.Xavier())
    with jax.default_matmul_precision("highest"):
        jnet(jmx.nd.array(x_np))
    with tmx.name.NameManager(), tmx.cpu():
        tnet = make(tmx)
        tnet.initialize()
    params_from_jax(tnet, {k: np.asarray(p.data().asnumpy()) for k, p in
                           jnet._collect_params_with_prefix().items()},
                    ctx=tmx.cpu())
    return jnet, tnet


def _serve_both(jnet, tnet, xs, item_shape, **kw):
    """The same requests through the JAX engine and the port's, both
    started after every request is queued (the same batches)."""
    with jax.default_matmul_precision("highest"):
        jeng = jserving.InferenceEngine(start=False, **kw)
        try:
            jep = jeng.load_model("m", net=jnet, item_shape=item_shape)
            jf = [jep.submit(x) for x in xs]
            jeng.start()
            jres = [f.result(120.0) for f in jf]
        finally:
            jeng.close()
    teng = _engine(start=False, **kw)
    try:
        tep = teng.load_model("m", net=tnet, item_shape=item_shape)
        tf = [tep.submit(x) for x in xs]
        teng.start()
        tres = [f.result(120.0) for f in tf]
    finally:
        teng.close()
    assert list(teng.dispatch_log) == list(jeng.dispatch_log)
    return jres, tres


def test_mlp_rows_match_the_jax_engine(engine_threads_clean):
    xs = _requests(11, seed=4)
    jnet, tnet = _jax_pair(_mlp_make, np.zeros((1, 16), np.float32))
    jres, tres = _serve_both(jnet, tnet, xs, (16,), max_batch=4,
                             max_wait_ms=1.0)
    _rows_close(tres, jres, dict(rtol=1e-5, atol=1e-5))


def test_resnet18_rows_match_the_jax_engine(engine_threads_clean):
    def make(mx):
        return mx.gluon.model_zoo.vision.resnet18_v1(classes=10)
    xs = _requests(5, shape=(3, 32, 32), seed=5)
    jnet, tnet = _jax_pair(make, np.zeros((1, 3, 32, 32), np.float32))
    jres, tres = _serve_both(jnet, tnet, xs, (3, 32, 32), max_batch=4,
                             max_wait_ms=1.0)
    _rows_close(tres, jres, dict(rtol=1e-4, atol=1e-4))


# ------------------------------------------------------------- core batching
def test_pack_pad_rows_match_one_request_forward(engine_threads_clean):
    """Batched and padded responses against the one-request forward of
    each, across every padding bucket, within 1e-5 (cross-bucket rows are
    not pinned bit for bit: the GEMM may differ with M)."""
    net = _mlp()
    xs = _requests(40)
    refs = _refs(net, xs)
    with _engine(max_batch=8, max_wait_ms=2.0) as eng:
        ep = eng.load_model("mlp", net=net, item_shape=(16,))
        futs = [ep.submit(x) for x in xs]
        res = [f.result(30.0) for f in futs]
    _rows_close(res, refs)
    # continuous batching actually batched (not 40 singleton dispatches)
    assert len(eng.dispatch_log) < len(xs)
    assert any(b == 8 for _, _, b in eng.dispatch_log)


def test_bucket_output_equals_its_eager_forward():
    """Each bucket's served output equals the net's eager forward of the
    same padded batch bit for bit, and zero padding against random
    padding leaves the real rows bit for bit unchanged."""
    net = _mlp()
    xs = _requests(8, seed=1)
    eng = _engine(start=False)
    try:
        m = eng.load_model("mlp", net=net, item_shape=(16,),
                           buckets=(1, 2, 4, 8)).model
        rng = np.random.RandomState(2)
        for b in m.buckets:
            for n in range(1, b + 1):
                zero = m.fetch(m.dispatch(m.pack(xs[:n], b), b))[0]
                batch = m.pack(xs[:n], b)
                batch.x[n:] = rng.rand(b - n, 16)
                noisy = m.fetch(m.dispatch(batch, b))[0]
                assert np.array_equal(zero, noisy), (b, n)
                padded = np.zeros((b, 16), np.float32)
                padded[:n] = np.stack(xs[:n])
                with tmx.cpu():
                    eager = net(tmx.nd.array(padded)).asnumpy()[:n]
                assert np.array_equal(zero, eager), (b, n)
    finally:
        eng.close()


def test_bucket_padding_sizes(engine_threads_clean):
    """A partial batch is padded to the smallest bucket that fits it."""
    net = _mlp()
    eng = _engine(max_batch=8, max_wait_ms=1.0, start=False)
    ep = eng.load_model("mlp", net=net, item_shape=(16,))
    for x in _requests(3):
        ep.submit(x)
    eng.start()
    eng.close(drain=True)
    assert list(eng.dispatch_log) == [("mlp", 3, 4)]


def test_deadline_flush(engine_threads_clean):
    """Fewer requests than the fill threshold still dispatch once the
    oldest request has waited max_wait_ms."""
    net = _mlp()
    with _engine(max_batch=64, max_wait_ms=30.0) as eng:
        ep = eng.load_model("mlp", net=net, item_shape=(16,))
        x = _requests(1)[0]
        t0 = time.perf_counter()
        out = ep.predict(x, timeout=30.0)
        waited = time.perf_counter() - t0
    np.testing.assert_allclose(out, _refs(net, [x])[0], **ROW_TOL)
    assert waited >= 0.025        # held for the deadline...
    assert waited < 10.0          # ...but flushed promptly after it
    assert eng.dispatch_log[0][1] == 1      # one real row


def test_item_shape_validation():
    net = _mlp()
    with _engine(max_batch=4) as eng:
        ep = eng.load_model("mlp", net=net, item_shape=(16,))
        with pytest.raises(ValueError, match=r"\(16,\)"):
            ep.submit(np.zeros((2, 16), np.float32))
        # a torch tensor or an NDArray is one request as well
        out = ep.predict(torch.zeros(16), timeout=30.0)
        with tmx.cpu():
            out2 = ep.predict(tmx.nd.zeros((16,)), timeout=30.0)
        assert np.array_equal(out, out2)


# ------------------------------------------------------------- backpressure
def test_backpressure_fast_reject(engine_threads_clean):
    """A full bounded queue rejects with the typed error immediately."""
    net = _mlp()
    eng = _engine(max_batch=4, queue_limit=4, start=False)
    ep = eng.load_model("mlp", net=net, item_shape=(16,))
    xs = _requests(6)
    futs = [ep.submit(x) for x in xs[:4]]
    for x in xs[4:]:
        with pytest.raises(serving.QueueFullError, match="queue full"):
            ep.submit(x)
    assert eng.stats()["mlp"]["rejected"] >= 2
    eng.start()
    eng.close(drain=True)
    _rows_close([f.result(0) for f in futs], _refs(net, xs[:4]))


def test_queue_full_chaos_reject(engine_threads_clean):
    net = _mlp()
    with _engine(max_batch=4) as eng:
        ep = eng.load_model("mlp", net=net, item_shape=(16,))
        chaos.arm("serve.queue_full", prob=1.0, seed=3, times=1)
        with pytest.raises(serving.QueueFullError, match="chaos"):
            ep.submit(_requests(1)[0])
        out = ep.predict(_requests(1)[0], timeout=30.0)
        assert out.shape == (10,)


# ------------------------------------------------------------ multi-tenancy
def test_multi_tenant_weighted_fairness(engine_threads_clean):
    """Two saturated tenants at weights 3:1 share dispatches 3:1,
    interleaved (smooth WRR)."""
    net = _mlp()
    eng = _engine(max_batch=2, start=False)
    a = eng.load_model("A", net=net, item_shape=(16,), weight=3)
    b = eng.load_model("B", net=net, item_shape=(16,), weight=1)
    for x in _requests(24):
        a.submit(x)
        b.submit(x)
    eng.start()
    eng.close(drain=True)
    order = [m for m, _, _ in eng.dispatch_log]
    assert order[:8].count("A") == 6
    assert order.count("A") == order.count("B") == 12
    for i in range(0, 16, 4):
        assert "B" in order[i:i + 4]


def test_unload_fails_pending(engine_threads_clean):
    net = _mlp()
    eng = _engine(max_batch=4, start=False)
    ep = eng.load_model("mlp", net=net, item_shape=(16,))
    fut = ep.submit(_requests(1)[0])
    eng.unload("mlp")
    with pytest.raises(serving.EngineClosedError):
        fut.result(1.0)
    eng.close()


# ------------------------------------------------------------------- chaos
def test_slow_model_degrades_to_blocking(engine_threads_clean):
    """serve.slow_model (no watchdog): every response still arrives,
    correct and unreordered."""
    net = _mlp()
    xs = _requests(8)
    chaos.arm("serve.slow_model", prob=1.0, seed=11)
    with _engine(max_batch=4, max_wait_ms=1.0) as eng:
        ep = eng.load_model("mlp", net=net, item_shape=(16,))
        futs = [ep.submit(x) for x in xs]
        res = [f.result(60.0) for f in futs]
    assert chaos.stats("serve.slow_model")[1] >= 1
    _rows_close(res, _refs(net, xs))


def test_slow_model_trips_watchdog_with_flight_dump(tmp_path, monkeypatch,
                                                    engine_threads_clean):
    """A chaos-slowed model past the timeout trips the hung-request
    watchdog: the batch fails with StepHungError, the flight recorder is
    dumped, and the engine keeps serving."""
    dump = tmp_path / "flight.jsonl"
    monkeypatch.setenv("MXTPU_TELEMETRY_DUMP", str(dump))
    net = _mlp()
    x = _requests(1)[0]
    chaos.arm("serve.slow_model", prob=1.0, seed=5, times=1)
    eng = _engine(max_batch=4, max_wait_ms=1.0, timeout_ms=50.0)
    eng.SLOW_CHAOS_S = 0.5
    try:
        ep = eng.load_model("mlp", net=net, item_shape=(16,))
        before = eng.stats()["mlp"]["hung"]
        with pytest.raises(StepHungError):
            ep.predict(x, timeout=60.0)
        assert eng.stats()["mlp"]["hung"] == before + 1
        assert dump.exists() and dump.stat().st_size > 0
        meta = json.loads(dump.read_text().splitlines()[0])
        assert meta["reason"].startswith("guard:hang")
        out = ep.predict(x, timeout=60.0)
        np.testing.assert_allclose(out, _refs(net, [x])[0], **ROW_TOL)
        # the hung batch handed its copy-out slot back
        assert ep.model._free.qsize() == eng.inflight + 3
    finally:
        eng.close()


def test_client_abort_drops_row_not_batch(engine_threads_clean):
    """serve.client_abort: an abandoned request's row is dropped; the rest
    of its batch is delivered."""
    net = _mlp()
    xs = _requests(2)
    chaos.arm("serve.client_abort", prob=1.0, seed=9, times=1)
    eng = _engine(max_batch=2, max_wait_ms=1.0, start=False)
    with eng:
        ep = eng.load_model("mlp", net=net, item_shape=(16,))
        fa, fb = ep.submit(xs[0]), ep.submit(xs[1])
        eng.start()
        outcomes = []
        for f, ref in zip((fa, fb), _refs(net, xs)):
            try:
                outcomes.append(bool(np.allclose(f.result(30.0), ref,
                                                 **ROW_TOL)))
            except serving.RequestAborted:
                outcomes.append("aborted")
    assert sorted(map(str, outcomes)) == ["True", "aborted"]


# -------------------------------------------------------------- lifecycle
def test_drain_on_shutdown(engine_threads_clean):
    """close(drain=True) serves everything queued, then tears down the
    scheduler, demux and watchdog threads."""
    net = _mlp()
    eng = _engine(max_batch=4, max_wait_ms=50.0, timeout_ms=5000.0,
                  start=False)
    ep = eng.load_model("mlp", net=net, item_shape=(16,))
    xs = _requests(10)
    futs = [ep.submit(x) for x in xs]
    eng.start()
    eng.close(drain=True)
    _rows_close([f.result(0) for f in futs], _refs(net, xs))
    with pytest.raises(serving.EngineClosedError):
        ep.submit(xs[0])
    eng.close()     # idempotent


def test_close_without_drain_fails_pending(engine_threads_clean):
    net = _mlp()
    eng = _engine(max_batch=64, max_wait_ms=60000.0, start=False)
    ep = eng.load_model("mlp", net=net, item_shape=(16,))
    fut = ep.submit(_requests(1)[0])
    eng.start()
    eng.close(drain=False)
    with pytest.raises(serving.EngineClosedError):
        fut.result(1.0)


def test_unported_sources_and_load_errors(engine_threads_clean):
    """``mlir=`` (an export artifact, A11) raises naming its item, and
    ``quantize=True`` converts a ``net=`` model to int8; a model source
    needs its item shape, a HybridBlock and the engine's device, and every
    output must lead with the batch axis."""
    net = _mlp()
    with _engine() as eng:
        with pytest.raises(NotImplementedError, match="A11"):
            eng.load_model("art", mlir="m.mlir", params="m.params")
        # int8 (A9) is ported: quantize=True converts the net at load
        qnet = _mlp(seed=1)
        qep = eng.load_model("q", net=qnet, item_shape=(16,),
                             quantize=True)
        assert type(list(qnet._children.values())[0]).__name__ == \
            "QuantizedDense"
        eng.unload("q")
        assert qep.buckets
        with pytest.raises(ValueError, match="net= models only"):
            eng.load_model("q", fn=lambda x: x, item_shape=(1,),
                           quantize=True)
        with pytest.raises(ValueError, match="item_shape"):
            eng.load_model("m", net=net)
        with pytest.raises(ValueError, match="item_shape"):
            eng.load_model("m", fn=lambda x: x)
        with pytest.raises(ValueError, match="exactly one"):
            eng.load_model("m", net=net, fn=lambda x: x, item_shape=(1,))
        with pytest.raises(TypeError, match="HybridBlock"):
            eng.load_model("m", net=object(), item_shape=(1,))
        # another device: a ValueError (without a card, resolving "cuda"
        # raises first)
        with pytest.raises((ValueError, tmx.NoCudaDeviceError)):
            eng.load_model("m", net=net, item_shape=(16,), ctx="cuda")

        class Summed(nn.HybridBlock):
            def forward(self, x):
                return x.sum()
        with pytest.raises(ValueError, match="batch axis"):
            eng.load_model("m", net=Summed(), item_shape=(4,))
        assert eng.stats() == {}
        ep = eng.load_model("m", net=net, item_shape=(16,), ctx=tmx.cpu(),
                            donate=True)
        assert ep.model.kind == "aot" and ep.model.model_bytes == sum(
            p.data().asnumpy().nbytes
            for p in net.collect_params().values())


def test_deferred_init_resolved_by_the_discovery_forward():
    """A net whose shapes are still deferred serves: one discovery forward
    at load materialises its parameters."""
    tmx.random.seed(3)
    with tmx.cpu():
        net = _mlp_make(tmx)
        net.initialize(tmx.init.Xavier())
    assert any(p._data is None for p in net.collect_params().values())
    x = _requests(1, seed=6)[0]
    with _engine(max_batch=2) as eng:
        ep = eng.load_model("m", net=net, item_shape=(16,))
        out = ep.predict(x, timeout=30.0)
    np.testing.assert_allclose(out, _refs(net, [x])[0], **ROW_TOL)


# ------------------------------------------------ copy-out slots, counters
def test_inflight_outputs_survive_the_next_dispatch(engine_threads_clean):
    """Two batches of one bucket dispatched before either is fetched: each
    keeps its own outputs (a slot a batch in flight). Through the engine,
    with ``inflight`` 2 and a slow fetch, every response is its own."""
    net = _mlp()
    xs = _requests(16, seed=3)
    refs = _refs(net, xs)
    eng = _engine(max_batch=2, max_wait_ms=1.0, inflight=2, start=False)
    try:
        ep = eng.load_model("mlp", net=net, item_shape=(16,))
        m = ep.model
        first = m.dispatch(m.pack(xs[:2], 2), 2)
        second = m.dispatch(m.pack(xs[2:4], 2), 2)
        _rows_close(m.fetch(second)[0], refs[2:4])
        _rows_close(m.fetch(first)[0], refs[:2])
        fetch = m.fetch

        def slow_fetch(batch):
            time.sleep(0.02)
            return fetch(batch)
        m.fetch = slow_fetch
        futs = [ep.submit(x) for x in xs]
        eng.start()
        _rows_close([f.result(30.0) for f in futs], refs)
        assert m._free.qsize() == eng.inflight + 3
    finally:
        eng.close()


def test_compiles_stay_zero_on_the_cpu(engine_threads_clean):
    """No graph on the CPU: the bodies run eagerly at every dispatch and
    ``mxtpu_serve_compiles_total`` does not move, at load, under traffic,
    at a rebuild or a swap."""
    net = _mlp()
    c = telemetry.counter("mxtpu_serve_compiles_total")
    with _engine(max_batch=4) as eng:
        ep = eng.load_model("cpu_compiles", net=net, item_shape=(16,))
        for x in _requests(6):
            ep.predict(x, timeout=30.0)
        ep.model.rebuild()
        eng.load_model("cpu_compiles", net=_mlp(seed=1), item_shape=(16,))
        assert all(e.step.graph is None
                   for e in ep.model._entries.values())
        assert sorted(ep.model._entries) == [1, 2, 4]
        assert eng.stats()["cpu_compiles"]["compiles"] == 0
    assert c.value(model="cpu_compiles") == 0


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1

    def reset(self):
        pass


class _Counted(nn.HybridBlock):
    """A forward that stands for a kernel: it counts one ``softmax_fwd``
    launch a call."""

    def forward(self, x):
        ksm.softmax_fwd.launches += 1
        return x * 2.0


def test_bucket_graph_launch_counts_follow_replays(engine_threads_clean):
    """A bucket's graph: what the wrappers counted while it was captured
    is the capture's record and stays out of the shared counts, and
    every dispatch (a replay) adds the record; the replay's static output
    is what the slot copies out."""
    with _engine(max_batch=2, max_wait_ms=1.0) as eng:
        ep = eng.load_model("counted", net=_Counted(), item_shape=(3,),
                            buckets=(2,))
        entry = ep.model._entries[2]
        common.reset_launch_counts()
        graph = _StubGraph()
        entry.inputs[0].copy_(torch.ones((2, 3)))
        entry.step.capture(graph, contextlib.nullcontext())
        assert entry.step.counts == {"softmax_fwd": (1, 0, 0)}
        assert common.launch_counts()["softmax_fwd"] == 0
        outs = [ep.predict(np.full(3, float(i), np.float32), timeout=30.0)
                for i in range(3)]
        assert graph.replays == 3
        assert common.launch_counts()["softmax_fwd"] == 3
        # the stub replays nothing: each batch reads the captured output
        assert all(np.array_equal(o, np.full(3, 2.0)) for o in outs)
    common.reset_launch_counts()


def test_counts_of_other_threads_stay_shared_during_a_capture():
    """A launch counted on another thread while a graph is captured is a
    real launch: it stays in the shared counts and out of the capture's
    record, and the capture leaves the shared counts alone."""
    from incubator_mxnet_tpu_torch.cuda_graph import CapturedStep
    common.reset_launch_counts()
    inside, counted = threading.Event(), threading.Event()

    def eager_launch():
        inside.wait(30.0)
        ksm.softmax_fwd.launches += 1
        counted.set()

    def body():
        inside.set()
        assert counted.wait(30.0)
        ksm.softmax_fwd.launches += 1
        return torch.zeros(2)

    other = threading.Thread(target=eager_launch)
    other.start()
    step = CapturedStep(body)
    step.capture(_StubGraph(), contextlib.nullcontext())
    other.join(30.0)
    assert step.counts == {"softmax_fwd": (1, 0, 0)}
    assert common.launch_counts()["softmax_fwd"] == 1
    step()
    assert common.launch_counts()["softmax_fwd"] == 2
    common.reset_launch_counts()


class _Noisy(nn.HybridBlock):
    def forward(self, x):
        return x + tmx.nd.random.normal(shape=x.shape)


def test_served_random_draws_follow_the_dispatch_counter(
        engine_threads_clean):
    """A served net's draws come from its bucket entry's generator, seeded
    from the model's dispatch counter: two engines serving the same
    requests in the same order draw the same numbers, and two dispatches
    of one request draw different ones."""
    def run():
        eng = _engine(max_batch=1, max_wait_ms=1.0)
        try:
            ep = eng.load_model("noisy", net=_Noisy(), item_shape=(4,))
            return [ep.predict(np.zeros(4, np.float32), timeout=30.0)
                    for _ in range(3)]
        finally:
            eng.close()
    a, b = run(), run()
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], a[1])


def test_one_engine_serves_batch_and_generate_endpoints(
        engine_threads_clean):
    """A batch endpoint and a generate endpoint side by side: both serve,
    ``ready`` and ``stats`` cover both kinds, and ``close`` ends every
    thread."""
    from incubator_mxnet_tpu_torch.models import transformer as tt
    cfg = tt.TransformerConfig(vocab_size=31, d_model=32, n_heads=2,
                               d_ff=64, n_layers=2, max_len=64)
    params = tt.init_transformer_params(torch.Generator().manual_seed(0),
                                        cfg, device="cpu")
    net = _mlp()
    x = _requests(1)[0]
    with _engine(max_batch=4, max_wait_ms=1.0) as eng:
        ep = eng.load_model("mixed_mlp", net=net, item_shape=(16,))
        gep = eng.load_model("mixed_lm", generate={
            "params": params, "cfg": cfg, "max_len": 64, "block": 16,
            "buckets": (16,), "slots": 2, "max_new_tokens": 3})
        toks = gep.generate(np.array([1, 2, 3], np.int32), timeout=60.0)
        out = ep.predict(x, timeout=30.0)
        assert len(toks) == 3
        np.testing.assert_allclose(out, _refs(net, [x])[0], **ROW_TOL)
        assert eng.ready() == (True, {"mixed_mlp": "ready",
                                      "mixed_lm": "ready"})
        st = eng.stats()
        assert st["mixed_lm"]["kind"] == "generate"
        assert st["mixed_lm"]["served"] == 1
        assert st["mixed_mlp"]["served"] == 1
        assert st["mixed_mlp"]["buckets"] == [1, 2, 4]
        with pytest.raises(serving.SwapError):
            eng.load_model("mixed_lm",
                           generate={"params": params, "cfg": cfg})


# ----------------------------------------------------- telemetry integration
def test_serve_metrics_in_registry_and_spans():
    net = _mlp()
    base_ok = telemetry.counter("mxtpu_serve_requests_total").value(
        model="tmetrics", outcome="ok")
    with _engine(max_batch=4, max_wait_ms=1.0) as eng:
        ep = eng.load_model("tmetrics", net=net, item_shape=(16,))
        for x in _requests(6):
            ep.predict(x, timeout=30.0)
    got = telemetry.counter("mxtpu_serve_requests_total").value(
        model="tmetrics", outcome="ok")
    assert got == base_ok + 6
    assert telemetry.histogram("mxtpu_serve_request_seconds").value(
        model="tmetrics", outcome="ok") >= 6
    assert telemetry.gauge("mxtpu_serve_model_bytes").value(
        model="tmetrics") == ep.model.model_bytes
    text = telemetry.render_prometheus()
    assert "mxtpu_serve_requests_total" in text
    assert "mxtpu_serve_queue_depth" in text
    phases = telemetry.phase_breakdown()
    for phase in ("enqueue", "batch_wait", "pad", "forward", "demux"):
        assert phase in phases, f"missing span phase {phase}"


def test_serve_metrics_on_http_endpoint():
    """The telemetry endpoint (a localhost port) exposes the
    ``mxtpu_serve_*`` series."""
    net = _mlp()
    with _engine(max_batch=2, max_wait_ms=1.0) as eng:
        ep = eng.load_model("thttp", net=net, item_shape=(16,))
        ep.predict(_requests(1)[0], timeout=30.0)
        port = telemetry.serve(port=0)
        try:
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=10).read()
        finally:
            telemetry.stop_serving()
    assert 'mxtpu_serve_requests_total{model="thttp"' in body.decode()


def test_failed_capture_frees_its_pool(monkeypatch):
    """A capture that fails (a forward that syncs with the host) raises,
    and first ends its pool's allocation and drops its reference to the
    pool: the allocator would otherwise keep the capture under way, and
    ``empty_cache()`` would free nothing for the rest of the process. The
    CUDA calls are stood in for on the CPU."""
    from incubator_mxnet_tpu_torch import cuda_graph
    calls = []

    class FailingCapture:
        def __init__(self, graph, pool, stream, capture_error_mode):
            calls.append(("capture", pool, capture_error_mode))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    class Stream:
        device = torch.device("cuda", 0)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 7))
    monkeypatch.setattr(torch.cuda, "graph", FailingCapture)
    monkeypatch.setattr(torch._C, "_cuda_endAllocateToPool",
                        lambda i, p: calls.append(("end", i, p)),
                        raising=False)
    monkeypatch.setattr(torch._C, "_cuda_releasePool",
                        lambda i, p: calls.append(("release", i, p)),
                        raising=False)
    step = cuda_graph.CapturedStep(lambda: [torch.ones(1)])
    with pytest.raises(RuntimeError, match="capturing"):
        cuda_graph.capture(step, Stream())
    assert calls == [("capture", (0, 7), "thread_local"),
                     ("end", 0, (0, 7)), ("release", 0, (0, 7))]
    assert step.graph is None
    # a pool the caller shares is the one released
    calls.clear()
    with pytest.raises(RuntimeError):
        cuda_graph.capture(step, Stream(), pool=(0, 3))
    assert calls[1:] == [("end", 0, (0, 3)), ("release", 0, (0, 3))]
