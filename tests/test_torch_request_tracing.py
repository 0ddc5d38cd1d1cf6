"""Per-request tracing on the port's serving engine, on the CPU: trace
context (W3C ``traceparent``), the ``Trace`` waterfall and its
attribution, the tail-sampling store, OpenMetrics exemplars, and the
waterfall of both serving paths: batch requests through ``fn=`` endpoints
(enqueue, admission, queue_wait, pad, dispatch, device, demux; the
shed trace retained; attribution closure on an idle box; the store
disabled) and generate requests (prefill chunks, per-token decode spans,
aggregation past the detail window, the shed trace). Ported from
``tests/test_request_tracing.py``; its two HTTP tests wait for the port's
HTTP front end (ROADMAP.md)."""
import re
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from incubator_mxnet_tpu.models import transformer as jt
from incubator_mxnet_tpu_torch import chaos, serving, telemetry
from incubator_mxnet_tpu_torch.models import transformer as tt

CACHE = 64


@pytest.fixture(autouse=True)
def _telemetry_reset():
    telemetry.reset()
    yield
    telemetry.reset()


@pytest.fixture
def threads_clean():
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


@pytest.fixture(scope="module")
def lm():
    """The reference test's LM, its JAX parameters carried across."""
    jcfg = jt.TransformerConfig(vocab_size=31, d_model=32, n_heads=2,
                                d_ff=64, n_layers=2, max_len=CACHE,
                                dtype=jnp.float32)
    jparams = jt.init_transformer_params(jax.random.PRNGKey(0), jcfg)
    cfg = tt.TransformerConfig(vocab_size=31, d_model=32, n_heads=2,
                               d_ff=64, n_layers=2, max_len=CACHE)
    return tt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              cfg, device="cpu"), cfg


def _slow(dt):
    def fn(x):
        time.sleep(dt)
        return x
    return fn


def _finished(status="ok", model="m", total=0.01):
    tr = telemetry.Trace("predict", model=model)
    tr.observe("work", total)
    tr.finish(status=status)
    tr.total_s = total          # fake the e2e latency for slow-N tests
    return tr


# ------------------------------------------------------------ Trace unit
def test_traceparent_parse_and_join():
    """Valid W3C traceparent joins the caller's trace; malformed or
    all-zero headers fall back to a fresh 128-bit id."""
    tid, psid = "ab" * 16, "cd" * 8
    assert telemetry.parse_traceparent(f"00-{tid}-{psid}-01") == (tid, psid)
    for bad in (None, "", "garbage", f"00-{tid}-{psid}",
                f"00-{'0' * 32}-{psid}-01",        # all-zero trace id
                f"00-{tid}-{'0' * 16}-01",         # all-zero span id
                f"00-{tid[:-2]}-{psid}-01",        # short trace id
                f"00-{tid}-{psid}-1",              # short flags
                f"ff-{tid}-{psid}-01",             # version 255 forbidden
                f"FF-{tid}-{psid}-01",
                f"00-{tid}-{psid}-01-extra"):      # v00: exactly 4 fields
        assert telemetry.parse_traceparent(bad) is None, bad
    # a future version MAY carry extra fields — parse the known prefix
    assert telemetry.parse_traceparent(
        f"cc-{tid}-{psid}-01-future-fields") == (tid, psid)
    joined = telemetry.Trace("predict", traceparent=f"00-{tid}-{psid}-01")
    assert joined.trace_id == tid and joined.parent_id == psid
    fresh = telemetry.Trace("predict", traceparent="junk")
    assert re.fullmatch(r"[0-9a-f]{32}", fresh.trace_id)
    assert fresh.trace_id != tid and fresh.parent_id is None
    # outbound propagation: a valid traceparent that joins back to us
    reparsed = telemetry.parse_traceparent(joined.traceparent())
    assert reparsed is not None and reparsed[0] == tid


def test_trace_span_tree_and_attach_mirror():
    """Nested spans record parent/depth; inside ``attach()`` the global
    telemetry spans mirror into the trace, and the previous context is
    restored on exit (no leak into the next request)."""
    tr = telemetry.Trace("predict", model="m")
    with tr.span("outer"):
        with tr.span("inner", k=1):
            pass
        with tr.attach():
            with telemetry.span("mirrored"):
                pass
    assert telemetry.current_trace() is None        # context restored
    spans = {s["name"]: s for s in tr.to_dict()["spans"]}
    assert spans["outer"]["depth"] == 0
    assert spans["inner"]["depth"] == 1
    assert spans["inner"]["parent"] == "outer"
    assert spans["inner"]["attrs"] == {"k": 1}
    assert spans["mirrored"]["parent"] == "outer"
    # outside attach(), global spans do NOT mirror
    with telemetry.span("unmirrored"):
        pass
    assert "unmirrored" not in {s["name"] for s in tr.to_dict()["spans"]}


def test_trace_finish_attribution_and_idempotence():
    """finish() stamps total vs sum-of-top-level-phases; the first call
    wins; chrome export carries every span."""
    tr = telemetry.Trace("predict", model="m")
    with tr.span("a"):
        time.sleep(0.02)
    tr.observe("b", 0.01)
    tr.finish()
    assert tr.status == "ok" and tr.total_s >= 0.02 - 1e-4
    assert abs(tr.attributed_s - (tr.total_s - tr.unattributed_s)) < 1e-6
    total0 = tr.total_s
    time.sleep(0.01)
    tr.finish(status="error")                       # idempotent: no-op
    assert tr.status == "ok" and tr.total_s == total0
    chrome = tr.to_chrome()
    assert len(chrome["traceEvents"]) == len(tr.to_dict()["spans"])


def test_trace_finished_is_immutable():
    """Spans recorded after finish() are counted, never appended — a
    stored trace must not mutate after the retention decision."""
    tr = telemetry.Trace("predict", model="m")
    tr.observe("work", 0.01)
    tr.finish()
    attributed = tr.attributed_s
    tr.observe("respond", 0.5)
    with tr.span("late"):
        pass
    d = tr.to_dict()
    assert [s["name"] for s in d["spans"]] == ["work"]
    assert d["post_finish_spans"] == 2
    assert tr.attributed_s == attributed


def test_trace_defer_retire_counts_post_result_spans():
    """A deferred trace stays open across the engine's finish() — the
    HTTP handler's respond span lands inside the waterfall and the
    engine-recorded outcome wins at retire()."""
    tr = telemetry.Trace("predict", model="m").defer()
    tr.observe("work", 0.01)
    tr.finish(status="shed", error=ValueError("late"))  # engine outcome
    assert not tr.finished and tr.status is None        # still open
    tr.observe("respond", 0.02)                         # lands
    tr.retire(status="ok")                              # engine wins
    assert tr.finished and tr.status == "shed"
    assert "ValueError" in tr.error
    d = tr.to_dict()
    assert sorted(s["name"] for s in d["spans"]) == ["respond", "work"]
    # both phases count toward attribution (the respond seconds were the
    # review's gap): closure holds with zero unattributed residual
    assert sum(s["dur_s"] for s in d["spans"]) >= 0.03 - 1e-6
    assert tr.unattributed_s == 0.0
    assert tr.to_dict()["post_finish_spans"] == 0
    # retire with no engine outcome applies the caller's view
    tr2 = telemetry.Trace("predict", model="m").defer()
    tr2.retire(status="rejected")
    assert tr2.finished and tr2.status == "rejected"


def test_trace_retirement_latch_single_shot():
    """_claim_retirement: only the first caller after close wins (the
    engine finish path and the handler retire path can race)."""
    tr = telemetry.Trace("predict", model="m")
    assert not tr._claim_retirement()       # not finished yet
    tr.finish()
    assert tr._claim_retirement()
    assert not tr._claim_retirement()


def test_trace_store_retention_policy():
    """Errors/sheds always kept; slowest-N per model kept; 1-in-K
    deterministic baseline; cap=0 disables retention entirely."""
    store = telemetry.TraceStore(cap=64, slow_n=2, sample_k=10)
    bad = _finished("error")
    assert store.offer(bad)                         # failures: always
    assert store.offer(_finished("shed"))
    fast = [_finished(total=0.001 * (i + 1)) for i in range(2)]
    for tr in fast:
        assert store.offer(tr)                      # seeds slow-N
    slow = _finished(total=9.0)
    assert store.offer(slow)                        # displaces min
    assert store.get(slow.trace_id) is not None
    sl = store.slowest("m")
    assert sl["trace_id"] == slow.trace_id and sl["total_s"] == 9.0
    assert "work" in sl["phases"]
    # middling ok-traces only survive the deterministic 1-in-K counter
    kept = sum(store.offer(_finished(total=0.002)) for _ in range(40))
    assert kept == 4                                # 45 offers so far
    assert store.get(bad.trace_id) is not None      # never evicted yet
    disabled = telemetry.TraceStore(cap=0)
    assert not disabled.offer(_finished("error"))
    assert len(disabled) == 0


def test_trace_store_slow_list_tracks_evictions():
    """_slow never dangles: a displaced slow entry leaves the store with
    its slot, a capacity-evicted slow trace is pruned from _slow, and
    slowest() falls back to the next retained ok-trace instead of
    silently returning None."""
    store = telemetry.TraceStore(cap=64, slow_n=2, sample_k=0)
    a = _finished(total=1.0)
    b = _finished(total=2.0)
    store.offer(a)
    store.offer(b)
    c = _finished(total=3.0)
    store.offer(c)                          # displaces a from slow-N
    assert store.get(a.trace_id) is None    # left with its slow slot
    assert store.slowest("m")["trace_id"] == c.trace_id
    # simulate the slowest trace vanishing from _traces (the drift the
    # fallback guards against): slowest() walks down to b, not None
    with store._lk:
        store._traces.pop(c.trace_id)
    sl = store.slowest("m")
    assert sl is not None and sl["trace_id"] == b.trace_id
    # capacity eviction prunes _slow: flood a tiny store with failures
    # (never sampled out) until the ok slow-traces are evicted
    small = telemetry.TraceStore(cap=3, slow_n=2, sample_k=0)
    ok1, ok2 = _finished(total=1.0), _finished(total=2.0)
    small.offer(ok1)
    small.offer(ok2)
    for _ in range(3):
        small.offer(_finished("error"))
    assert small.get(ok1.trace_id) is None
    assert small.get(ok2.trace_id) is None
    with small._lk:
        assert small._slow.get("m") == []   # pruned with the evictions
    assert small.slowest("m") is None


def test_trace_store_bounded_under_flood():
    """10k-request flood: memory stays at cap, and the stored failures
    are never evicted by a burst of successes."""
    store = telemetry.TraceStore(cap=128, slow_n=3, sample_k=7)
    bad_ids = []
    for _ in range(5):
        tr = _finished("error")
        store.offer(tr)
        bad_ids.append(tr.trace_id)
    for i in range(10_000):
        store.offer(_finished(total=0.001 + (i % 97) * 1e-5))
    assert len(store) <= 128
    for tid in bad_ids:
        assert store.get(tid) is not None, "failure evicted by flood"
    st = store.stats()
    assert st["offered"] == 10_005 and st["stored"] <= st["cap"]


def test_exemplar_exposition_parses():
    """OpenMetrics output carries exemplars (with the mandatory # EOF
    terminator) matching the spec grammar; the default 0.0.4 exposition
    is exemplar-free — the classic Prometheus text parser errors on
    exemplar syntax, so one would fail every production scrape."""
    h = telemetry.histogram("test_ex_seconds", buckets=(0.1, 1.0))
    h.observe(0.5, exemplar={"trace_id": "ab" * 16}, model="m")
    h.observe(0.05, model="m")                      # no exemplar
    text = telemetry.render_prometheus(openmetrics=True)
    pat = re.compile(r'test_ex_seconds_bucket\{[^}]*le="1"[^}]*\} '
                     r'\d+ # \{trace_id="[0-9a-f]{32}"\} 0\.5 \d+\.\d+')
    assert pat.search(text), text
    assert text.rstrip().endswith("# EOF")
    # the exemplar lands on its bucket line only — the le="0.1" line
    # (where the unexemplared 0.05 landed) carries none
    for line in text.splitlines():
        if 'test_ex_seconds_bucket{le="0.1"' in line:
            assert "#" not in line, line
    # classic 0.0.4: no exemplars, no OpenMetrics terminator, every
    # sample line parses under the 0.0.4 grammar
    plain = telemetry.render_prometheus()
    assert "# {" not in plain and "# EOF" not in plain
    sample = re.compile(r"^[A-Za-z_:][A-Za-z0-9_:]*(\{[^{}]*\})? "
                        r"(NaN|[+-]?Inf|[-+0-9.eE]+)$")
    for line in plain.splitlines():
        if line and not line.startswith("#"):
            assert sample.match(line), line


def test_metrics_content_negotiation():
    """negotiate_metrics: exemplars + OpenMetrics content type only when
    the Accept header asks for it."""
    h = telemetry.histogram("test_neg_seconds", buckets=(0.1, 1.0))
    h.observe(0.5, exemplar={"trace_id": "cd" * 16}, model="m")
    body, ctype = telemetry.negotiate_metrics(None)
    assert ctype.startswith("text/plain; version=0.0.4")
    assert "# {" not in body
    body, ctype = telemetry.negotiate_metrics(
        "application/openmetrics-text; version=1.0.0")
    assert ctype.startswith("application/openmetrics-text")
    assert "# {" in body and body.rstrip().endswith("# EOF")


# ------------------------------------------------------------ batch path
def test_batch_waterfall_completeness(threads_clean):
    """A batch-path request's trace records every phase of the serving
    waterfall with correct nesting, and lands in the tail store."""
    with serving.InferenceEngine(device="cpu", max_batch=4,
                                 max_wait_ms=1.0) as eng:
        ep = eng.load_model("m", fn=lambda x: x * 2.0, item_shape=(2,))
        fut = ep.submit(np.ones((2,), np.float32))
        fut.result(timeout=30.0)
        assert re.fullmatch(r"[0-9a-f]{32}", fut.trace_id)
        tr = fut.trace
        deadline = time.monotonic() + 5.0
        while tr.status is None and time.monotonic() < deadline:
            time.sleep(0.005)
        d = tr.to_dict()
        spans = {s["name"]: s for s in d["spans"]}
        for phase in ("enqueue", "queue_wait", "admission", "pad",
                      "dispatch", "device", "demux"):
            assert phase in spans, f"missing {phase}: {sorted(spans)}"
        assert spans["admission"]["parent"] == "enqueue"
        assert spans["pad"]["attrs"]["bucket"] >= 1
        assert spans["dispatch"]["attrs"]["version"] == 1
        assert d["status"] == "ok" and d["total_s"] > 0
        assert telemetry.trace_store().get(fut.trace_id) is tr


def test_attribution_closure_idle_box(threads_clean):
    """On an idle box the waterfall accounts for >=90% of end-to-end
    latency — the trace explains the request, not just brackets it."""
    with serving.InferenceEngine(device="cpu", max_batch=2,
                                 max_wait_ms=1.0) as eng:
        ep = eng.load_model("m", fn=_slow(0.02), item_shape=(1,))
        ep.predict(np.zeros((1,), np.float32), timeout=30.0)  # warm
        best = 0.0
        for _ in range(3):
            fut = ep.submit(np.zeros((1,), np.float32))
            fut.result(timeout=30.0)
            tr = fut.trace
            deadline = time.monotonic() + 5.0
            while tr.total_s is None and time.monotonic() < deadline:
                time.sleep(0.005)
            best = max(best, tr.attributed_s / tr.total_s)
            if best >= 0.9:
                break
        assert best >= 0.9, f"closure {best:.3f}"
        assert telemetry.counter(
            "mxtpu_serve_unattributed_seconds").value(model="m") < 0.1


def test_shed_trace_always_retained_with_shed_span(threads_clean):
    """A deadline-shed request's trace is retained regardless of
    sampling, carries the shed span, and mirrors into the flight ring."""
    with serving.InferenceEngine(device="cpu", max_batch=1,
                                 max_wait_ms=1.0) as eng:
        ep = eng.load_model("slow", fn=_slow(0.15), item_shape=(1,))
        blocker = ep.submit(np.zeros((1,), np.float32))
        time.sleep(0.05)
        doomed = ep.submit(np.zeros((1,), np.float32), deadline_ms=30)
        with pytest.raises(serving.DeadlineError) as ei:
            doomed.result(timeout=30.0)
        blocker.result(timeout=30.0)
        assert ei.value.trace_id == doomed.trace_id
        tr = telemetry.trace_store().get(doomed.trace_id)
        assert tr is not None and tr.status == "shed"
        names = [s["name"] for s in tr.to_dict()["spans"]]
        assert "shed" in names and "queue_wait" in names
        retired = [r for r in telemetry.records()
                   if r.get("t") == "trace_retired"
                   and r.get("trace_id") == doomed.trace_id]
        assert retired and retired[0]["status"] == "shed"


def test_store_disabled_zero_behavior_change(threads_clean, monkeypatch):
    """MXTPU_TRACE_STORE=0: identical outputs, ids still minted and
    returned, nothing retained, no slowest pointer in stats."""
    monkeypatch.setenv("MXTPU_TRACE_STORE", "0")
    telemetry.reset()
    with serving.InferenceEngine(device="cpu", max_batch=2,
                                 max_wait_ms=1.0) as eng:
        ep = eng.load_model("m", fn=lambda x: x + 1.0, item_shape=(2,))
        fut = ep.submit(np.zeros((2,), np.float32))
        out = fut.result(timeout=30.0)
        assert np.allclose(out, 1.0)
        assert re.fullmatch(r"[0-9a-f]{32}", fut.trace_id)
        assert len(telemetry.trace_store()) == 0
        deadline = time.monotonic() + 5.0
        while fut.trace.status is None and time.monotonic() < deadline:
            time.sleep(0.005)
        assert "slowest_trace" not in eng.stats()["m"]


# ------------------------------------------------------- generative path
def test_gen_waterfall_completeness(lm, threads_clean):
    """Generative trace: admission through retire with per-chunk prefill
    and one decode span per emitted token, page accounting attrs, and
    the slowest-trace pointer in stats()."""
    params, cfg = lm
    with serving.InferenceEngine(device="cpu") as eng:
        ep = eng.load_model("genlm", generate={
            "params": params, "cfg": cfg, "max_len": CACHE, "block": 16,
            "buckets": (8, 16), "max_new_tokens": 8, "page_len": 8,
            "prefill_chunk": 8})
        prompt = np.arange(2, 12, dtype=np.int32)     # 10 toks: 2 chunks
        fut = ep.submit(prompt, max_new_tokens=6)
        toks = fut.result(timeout=60.0)
        tr = fut.trace
        deadline = time.monotonic() + 5.0
        while tr.status is None and time.monotonic() < deadline:
            time.sleep(0.005)
        d = tr.to_dict()
        by_name = {}
        for s in d["spans"]:
            by_name.setdefault(s["name"], []).append(s)
        for phase in ("enqueue", "slot_wait", "page_claim",
                      "prefix_splice", "prefill_chunk", "decode",
                      "retire"):
            assert phase in by_name, f"missing {phase}: {sorted(by_name)}"
        assert len(by_name["prefill_chunk"]) == 2     # 10 toks / chunk 8
        chunks = sorted(s["attrs"]["chunk"]
                        for s in by_name["prefill_chunk"])
        assert chunks == [1, 2]
        assert len(by_name["decode"]) == len(toks)    # per-token ITL
        assert by_name["page_claim"][0]["attrs"]["pages"] >= 1
        assert by_name["retire"][0]["attrs"]["reason"] == "ok"
        assert by_name["prefill_chunk"][0]["attrs"]["version"] == 1
        assert d["status"] == "ok"
        assert d["attributed_s"] >= 0.5 * d["total_s"]
        # satellite: TTFT/ITL histograms observed live in the token loop
        assert telemetry.histogram(
            "mxtpu_serve_ttft_seconds").value(model="genlm") == 1.0
        assert telemetry.histogram(
            "mxtpu_serve_itl_seconds").value(model="genlm") \
            == len(toks) - 1
        slow = eng.stats()["genlm"].get("slowest_trace")
        assert slow is not None and "decode" in slow["phases"]


def test_gen_decode_spans_aggregate_past_detail_window(
        lm, threads_clean, monkeypatch):
    """Past the per-token detail window, decode samples aggregate
    N-per-span so a long generation never exhausts MAX_TRACE_SPANS and
    always keeps its retire span (token counts still tile the budget)."""
    monkeypatch.setattr(serving, "_DECODE_SPAN_DETAIL", 4)
    monkeypatch.setattr(serving, "_DECODE_SPAN_AGG", 4)
    params, cfg = lm
    with serving.InferenceEngine(device="cpu") as eng:
        ep = eng.load_model("genlm", generate={
            "params": params, "cfg": cfg, "max_len": CACHE, "block": 16,
            "buckets": (8,), "max_new_tokens": 24})
        fut = ep.submit(np.arange(2, 8, dtype=np.int32),
                        max_new_tokens=24)
        toks = fut.result(timeout=60.0)
        tr = fut.trace
        deadline = time.monotonic() + 5.0
        while tr.status is None and time.monotonic() < deadline:
            time.sleep(0.005)
        d = tr.to_dict()
        dec = [s for s in d["spans"] if s["name"] == "decode"]
        per_tok = [s for s in dec if "token" in s.get("attrs", {})]
        agg = [s for s in dec if "tokens" in s.get("attrs", {})]
        assert len(per_tok) == 4                      # detail window
        agg_total = sum(s["attrs"]["tokens"] for s in agg)
        assert agg_total == len(toks) - 4             # tail aggregated
        assert len(agg) <= -(-agg_total // 4) + 1
        assert d["dropped_spans"] == 0
        assert [s for s in d["spans"] if s["name"] == "retire"]


def test_gen_shed_trace_retained(lm, threads_clean):
    """A prompt shed while queued (deadline passed before a slot freed)
    keeps its trace with slot_wait + shed spans."""
    params, cfg = lm
    with serving.InferenceEngine(device="cpu") as eng:
        ep = eng.load_model("genlm", generate={
            "params": params, "cfg": cfg, "max_len": CACHE, "block": 16,
            "buckets": (8, 16), "max_new_tokens": 48, "slots": 1})
        # blocker occupies the only KV slot for 48 decode steps — far
        # past the doomed prompt's 1ms deadline
        blocker = ep.submit(np.arange(2, 8, dtype=np.int32),
                            max_new_tokens=48)
        time.sleep(0.005)
        doomed = ep.submit(np.arange(3, 9, dtype=np.int32),
                           max_new_tokens=8, deadline_ms=1)
        with pytest.raises(serving.DeadlineError):
            doomed.result(timeout=60.0)
        blocker.result(timeout=60.0)
        tr = telemetry.trace_store().get(doomed.trace_id)
        assert tr is not None and tr.status == "shed"
        names = [s["name"] for s in tr.to_dict()["spans"]]
        assert "shed" in names and "slot_wait" in names
