"""The PyTorch port's generative serving engine on the CPU, mirroring the
engine contracts of tests/test_generative_serving.py and
tests/test_paged_kv.py, plus greedy token streams held equal to the JAX
engine's in both the paged and the contiguous mode (same weights, carried
across with ``params_from_jax``; the JAX engine compiled under
``jax.default_matmul_precision("highest")``)."""
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from incubator_mxnet_tpu import serving as jserving
from incubator_mxnet_tpu.models import transformer as jt
from incubator_mxnet_tpu_torch import NoCudaDeviceError, chaos, serving
from incubator_mxnet_tpu_torch import telemetry
from incubator_mxnet_tpu_torch.models import transformer as tt

CACHE, PAGE, VOCAB = 64, 16, 31
MODES = {"paged": {"paged": 1, "buckets": (16, 64)},
         "contiguous": {"paged": 0, "buckets": (8, 16)}}


@pytest.fixture(autouse=True)
def _port_chaos_reset():
    """The port keeps its own chaos registry: nothing armed here may leak
    into the next test."""
    chaos.reset()
    yield
    chaos.reset()


@pytest.fixture(scope="module")
def lm():
    jcfg = jt.TransformerConfig(vocab_size=VOCAB, d_model=32, n_heads=2,
                                d_ff=64, n_layers=2, max_len=CACHE,
                                dtype=jnp.float32)
    jparams = jt.init_transformer_params(jax.random.PRNGKey(0), jcfg)
    tcfg = tt.TransformerConfig(vocab_size=VOCAB, d_model=32, n_heads=2,
                                d_ff=64, n_layers=2, max_len=CACHE)
    tparams = tt.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    return jparams, jcfg, tparams, tcfg


@pytest.fixture
def threads_clean():
    def live():
        return sorted(t.name for t in threading.enumerate()
                      if t.name.startswith("mxtpu-serve"))
    before = live()
    yield
    deadline = time.monotonic() + 5.0
    while live() != before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert live() == before, f"orphan threads: {live()} vs {before}"


def _prompts(n, lo=2, hi=8, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, (int(rng.randint(lo, hi)),)).astype(
        np.int32) for _ in range(n)]


def _spec(params, cfg, mode="paged", **kw):
    spec = {"params": params, "cfg": cfg, "max_len": CACHE, "block": PAGE,
            "max_new_tokens": 8, **MODES[mode]}
    spec.update(kw)
    return spec


def _engine(lm, mode="paged", queue_limit=None, **kw):
    _, _, params, cfg = lm
    eng = serving.InferenceEngine(device="cpu")
    ep = eng.load_model("genlm", generate=_spec(params, cfg, mode, **kw),
                        queue_limit=queue_limit)
    return eng, ep


def _wait_idle(ep, timeout=10.0):
    deadline = time.monotonic() + timeout
    while (ep.slots_in_use or (ep.pool is not None and (
            ep.pool.in_use() or ep.pool.reserved))) \
            and time.monotonic() < deadline:
        time.sleep(0.01)


# -------------------------------------------------------- against the JAX
@pytest.mark.parametrize("mode", sorted(MODES))
def test_greedy_streams_match_jax_engine(lm, mode, threads_clean):
    """Greedy token streams of the port's engine equal the JAX engine's
    for the same prompts, all in flight at once."""
    jparams, jcfg, _, _ = lm
    prompts = _prompts(4, lo=3, hi=14, seed=3)
    with jax.default_matmul_precision("highest"):
        jeng = jserving.InferenceEngine()
        try:
            jep = jeng.load_model("genlm", generate=_spec(
                jparams, jcfg, mode, slots=4))
            futs = [jep.submit(p, max_new_tokens=6) for p in prompts]
            want = [f.result(120.0) for f in futs]
        finally:
            jeng.close()
    eng, ep = _engine(lm, mode, slots=4)
    try:
        futs = [ep.submit(p, max_new_tokens=6) for p in prompts]
        got = [f.result(60.0) for f in futs]
    finally:
        eng.close()
    assert got == want


# ------------------------------------------------- engine contracts (port)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_tokens_identical_solo_vs_crowded(lm, mode, threads_clean):
    """A request's tokens are the same alone or among a crowd joining and
    leaving the decode batch every token (dead rows write to the trash
    page on the paged engine)."""
    eng, ep = _engine(lm, mode, slots=4)
    probe = _prompts(1, seed=7)[0]
    try:
        solo = ep.generate(probe, max_new_tokens=10, timeout=60.0)
        crowd = [ep.submit(p, max_new_tokens=2 + i % 7)
                 for i, p in enumerate(_prompts(12, seed=8))]
        crowded = ep.submit(probe, max_new_tokens=10).result(60.0)
        for f in crowd:
            f.result(60.0)
        assert crowded == solo
        assert any(occ > 1 for _, _, occ in ep.admit_log)
    finally:
        eng.close()


def test_prefill_bucket_selection(lm, threads_clean):
    eng, ep = _engine(lm, "contiguous", slots=2)
    try:
        for n, want in ((3, 8), (8, 8), (9, 16), (16, 16)):
            ep.generate(np.arange(n, dtype=np.int32) % VOCAB,
                        max_new_tokens=1, timeout=60.0)
            assert ep.admit_log[-1][:2] == (n, want)
        with pytest.raises(ValueError, match="exceeds the largest"):
            ep.submit(np.zeros(17, np.int32), max_new_tokens=1)
        with pytest.raises(ValueError, match="KV cache extent"):
            ep.submit(np.zeros(8, np.int32), max_new_tokens=CACHE)
    finally:
        eng.close()


def test_slot_exhaustion_backpressure(lm, threads_clean):
    eng, ep = _engine(lm, "contiguous", slots=1, queue_limit=1,
                      max_new_tokens=40)
    try:
        hog = ep.submit(_prompts(1)[0], max_new_tokens=40)
        next(hog.stream(timeout=60.0))   # slot held from the first token
        queued = ep.submit(_prompts(1, seed=1)[0], max_new_tokens=2)
        with pytest.raises(serving.QueueFullError, match="KV slots busy"):
            ep.submit(_prompts(1, seed=2)[0], max_new_tokens=2)
        assert hog.result(60.0) and len(queued.result(60.0)) == 2
    finally:
        eng.close()


def test_pool_exhaustion_typed(lm, threads_clean):
    """The allocator raises the typed error when drained, evicting
    prefix-cached pages LRU-first; a pool sized for one worst-case
    request serializes two requests without wedging."""
    pool = serving._PagePool(n_pages=2, page_len=8)
    pool.reserve(2)
    p0, p1 = pool.alloc_reserved(), pool.alloc_reserved()
    pool.register(b"k0", p0)
    pool.decref(p0)
    pool.decref(p1)
    assert pool.in_use() == 0 and pool.available() == 2
    pool.reserve(2)
    pool.alloc_reserved()
    assert pool.alloc_reserved() == p0 and pool.lookup(b"k0") is None
    with pytest.raises(serving.PagesExhaustedError):
        pool.alloc_reserved()
    eng, ep = _engine(lm, "paged", slots=4, pages=CACHE // PAGE,
                      prefix_cache=False, queue_limit=2)
    try:
        a = ep.submit(_prompts(1, seed=71)[0], max_new_tokens=40)
        b = ep.submit(_prompts(1, seed=73)[0], max_new_tokens=40)
        assert a.result(60.0) and b.result(60.0)
        assert all(occ == 1 for _, _, occ in ep.admit_log)
    finally:
        eng.close()


def test_eos_and_max_token_retirement(lm, threads_clean):
    probe = _prompts(1, seed=5)[0]
    eng, ep = _engine(lm, "paged", slots=2)
    try:
        full = ep.generate(probe, max_new_tokens=12, timeout=60.0)
        assert len(full) == 12
    finally:
        eng.close()
    eos = full[4]
    cut = full.index(eos)
    eng, ep = _engine(lm, "paged", slots=2, eos_id=eos)
    try:
        assert ep.generate(probe, max_new_tokens=12,
                           timeout=60.0) == full[:cut + 1]
        _wait_idle(ep)
        assert ep.slots_in_use == 0 and ep.pool.in_use() == 0
    finally:
        eng.close()


def test_streaming_future_ordering(lm, threads_clean):
    eng, ep = _engine(lm, "paged", slots=2)
    try:
        fut = ep.submit(_prompts(1, seed=3)[0], max_new_tokens=9)
        seen = []
        for tok in fut.stream(timeout=60.0):
            seen.append(tok)
            assert fut.tokens()[:len(seen)] == seen
        assert fut.t_first is not None and fut.t_first >= fut.t_submit
        assert fut.result(1.0) == seen and len(seen) == 9
    finally:
        eng.close()


def test_abort_and_cancel_free_slots_and_pages(lm, threads_clean):
    """Chaos aborts, an explicit mid-stream cancel and a cancel while
    queued all resolve with RequestAborted and free their slot and pages:
    the slot and page census return to zero."""
    eng, ep = _engine(lm, "paged", slots=3)
    try:
        chaos.arm("serve.client_abort", prob=0.2, seed=13)
        futs = [ep.submit(p, max_new_tokens=10)
                for p in _prompts(9, seed=6)]
        aborted = 0
        for f in futs:
            try:
                f.result(60.0)
            except serving.RequestAborted:
                aborted += 1
        chaos.reset()
        assert aborted > 0
        victim = ep.submit(_prompts(1, seed=67)[0], max_new_tokens=40)
        stream = victim.stream(timeout=60.0)
        next(stream)
        victim.cancel()
        with pytest.raises(serving.RequestAborted):
            for _ in stream:
                pass
        _wait_idle(ep)
        assert ep.slots_in_use == 0
        assert ep.pool.in_use() == 0 and ep.pool.reserved == 0
        assert telemetry.gauge("mxtpu_serve_kv_slots_in_use").value(
            model="genlm") == 0
        assert telemetry.gauge("mxtpu_serve_kv_pages_in_use").value(
            model="genlm") == 0
    finally:
        chaos.reset()
        eng.close()
    assert all(r == 0 for r in ep.pool.ref)
    eng, ep = _engine(lm, "paged", slots=1)
    try:
        fut = ep.submit(_prompts(1)[0], max_new_tokens=4)
        fut.cancel()
        with pytest.raises(serving.RequestAborted):
            fut.result(10.0)
    finally:
        eng.close()


def test_prefix_cache_hits_keep_tokens(lm, threads_clean):
    rng = np.random.RandomState(31)
    pre = rng.randint(0, VOCAB, (2 * PAGE,)).astype(np.int32)
    p1 = np.concatenate([pre, rng.randint(0, VOCAB, (3,)).astype(np.int32)])
    p2 = np.concatenate([pre, rng.randint(0, VOCAB, (5,)).astype(np.int32)])
    eng, ep = _engine(lm, "paged", slots=4, prefix_cache=False)
    try:
        ref = [ep.generate(p, max_new_tokens=6, timeout=60.0)
               for p in (p1, p2)]
    finally:
        eng.close()
    hits0 = telemetry.counter(
        "mxtpu_serve_prefix_hits_total").value(model="genlm")
    eng, ep = _engine(lm, "paged", slots=4, prefix_cache=True)
    try:
        out = [ep.generate(p, max_new_tokens=6, timeout=60.0)
               for p in (p1, p2)]
        st = eng.stats()["genlm"]
        assert st["prefix_hits"] - hits0 == 1
        assert st["prefix_tokens_reused"] >= 2 * PAGE
    finally:
        eng.close()
    assert out == ref


def test_chunked_prefill_matches_one_shot(lm, threads_clean):
    prompts = [_prompts(1, lo=40, hi=50, seed=41)[0],
               _prompts(1, lo=17, hi=30, seed=43)[0],
               _prompts(1, lo=3, hi=9, seed=47)[0]]
    eng, ep = _engine(lm, "paged", slots=4, prefix_cache=False)
    try:
        ref = [ep.generate(p, max_new_tokens=6, timeout=60.0)
               for p in prompts]
    finally:
        eng.close()
    eng, ep = _engine(lm, "paged", slots=4, prefix_cache=False,
                      prefill_chunk=PAGE)
    try:
        outs = [f.result(60.0) for f in
                [ep.submit(p, max_new_tokens=6) for p in prompts]]
    finally:
        eng.close()
    assert outs == ref


@pytest.mark.parametrize("mode", sorted(MODES))
def test_submit_rejects_bad_requests(lm, mode, threads_clean):
    """Out-of-vocab ids, an infeasible budget and bad sampling parameters
    are typed submit-time errors."""
    eng, ep = _engine(lm, mode, slots=1)
    probe = _prompts(1, seed=23)[0]
    try:
        for bad in (np.array([1, 999999], np.int32),
                    np.array([-1, 2], np.int32)):
            with pytest.raises(ValueError, match="token ids must be in"):
                ep.submit(bad)
        with pytest.raises(ValueError, match="KV cache extent"):
            ep.submit(np.zeros(8, np.int32), max_new_tokens=CACHE)
        for kw in ({"top_p": 1.5}, {"top_p": -0.1}):
            with pytest.raises(ValueError, match="top_p"):
                ep.submit(probe, **kw)
        for kw in ({"temperature": -0.5}, {"temperature": float("nan")},
                   {"top_k": -1}):
            with pytest.raises(ValueError):
                ep.submit(probe, **kw)
    finally:
        eng.close()


def test_sampling_seeded_and_top_k(lm, threads_clean):
    """Sampling is a pure function of the request: the same seed replays
    the same stream (also on a fresh engine); top_k=1 and a tiny nucleus
    collapse onto greedy; top_p=1.0 is nucleus-off; sampled tokens are in
    vocabulary; greedy stays identical beside sampling neighbours."""
    probe = _prompts(1, seed=13)[0]
    kw = dict(max_new_tokens=8, timeout=60.0)
    eng, ep = _engine(lm, "paged", slots=4)
    try:
        greedy = ep.generate(probe, **kw)
        a = ep.generate(probe, temperature=1.0, top_k=5, seed=42, **kw)
        b = ep.generate(probe, temperature=1.0, top_k=5, seed=42, **kw)
        assert a == b
        assert ep.generate(probe, temperature=2.5, top_k=1, seed=9,
                           **kw) == greedy
        assert ep.generate(probe, temperature=2.0, top_p=1e-6, seed=3,
                           **kw) == greedy
        assert ep.generate(probe, temperature=1.3, top_p=1.0, seed=23,
                           **kw) == ep.generate(probe, temperature=1.3,
                                                seed=23, **kw)
        free = ep.generate(probe, temperature=1.2, seed=5, **kw)
        assert all(0 <= t < VOCAB for t in free)
        futs = [ep.submit(probe, max_new_tokens=8),
                ep.submit(probe, max_new_tokens=8, temperature=1.0,
                          top_k=4, top_p=0.9, seed=7)]
        assert futs[0].result(60.0) == greedy
        futs[1].result(60.0)
    finally:
        eng.close()
    eng, ep = _engine(lm, "paged", slots=2)
    try:
        assert ep.generate(probe, temperature=1.0, top_k=5, seed=42,
                           **kw) == a
    finally:
        eng.close()


def test_sample_tokens_support_and_noise_determinism():
    """top_k restricts the support to the k highest logits, and the
    Gumbel noise is a function of (seed, position, token) only."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(4, 50, generator=g)
    ones = torch.ones(4)
    zeros_i = torch.zeros(4, dtype=torch.int64)
    top3 = logits.topk(3, dim=1).indices
    for seed in range(20):
        seeds = torch.full((4,), seed, dtype=torch.int64)
        toks = serving.sample_tokens(logits, ones, torch.full((4,), 3),
                                     torch.zeros(4), seeds,
                                     torch.arange(4))
        assert all(int(t) in top3[r].tolist() for r, t in enumerate(toks))
    n1 = serving._gumbel_noise(torch.tensor([7, 7]), torch.tensor([3, 4]),
                               50)
    n2 = serving._gumbel_noise(torch.tensor([7]), torch.tensor([3]), 50)
    assert torch.equal(n1[:1], n2) and not torch.equal(n1[0], n1[1])
    greedy = serving.sample_tokens(logits, torch.zeros(4), zeros_i,
                                   torch.zeros(4), zeros_i, zeros_i)
    assert torch.equal(greedy, logits.argmax(dim=1))


def test_drain_and_decode_failure(lm, monkeypatch, threads_clean):
    """A failing decode fails the live batch with the model error and the
    endpoint keeps serving; close(drain=True) caps a live generation and
    fails queued prompts with EngineClosedError."""
    monkeypatch.setenv("MXTPU_SERVE_GEN_DRAIN_TOKENS", "2")
    eng, ep = _engine(lm, "paged", slots=1, queue_limit=4,
                      max_new_tokens=50)
    real = ep.model.decode
    state = {"armed": True}

    def flaky(*a, **kw):
        if state["armed"]:
            state["armed"] = False
            raise RuntimeError("injected device failure")
        return real(*a, **kw)

    ep.model.decode = flaky
    with pytest.raises(RuntimeError, match="injected"):
        ep.submit(_prompts(1)[0], max_new_tokens=4).result(60.0)
    live = ep.submit(_prompts(1)[0], max_new_tokens=50)
    stream = live.stream(timeout=60.0)
    next(stream)
    queued = ep.submit(_prompts(1, seed=1)[0], max_new_tokens=2)
    eng.close(drain=True)
    assert len(live.result(60.0)) < 50
    with pytest.raises(serving.EngineClosedError):
        queued.result(60.0)


def test_device_rules_and_unported_sources(lm):
    """The engine defaults to the CUDA card and raises when there is none
    (no silent CPU run); of the model sources, an export artifact
    (``mlir=``, ROADMAP.md A11) is not ported yet."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(NoCudaDeviceError, match="device='cpu'"):
        serving.InferenceEngine()
    with pytest.raises(NoCudaDeviceError):
        tt.init_kv_cache(lm[3], 1, 16)
    eng = serving.InferenceEngine(device="cpu")
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP.md A11"):
            eng.load_model("m", mlir="m.mlir")
        eng.load_model("genlm", generate=_spec(lm[2], lm[3], slots=1))
        with pytest.raises(serving.SwapError):
            eng.load_model("genlm", generate=_spec(lm[2], lm[3], slots=1))
        assert eng.ready() == (True, {"genlm": "ready"})
    finally:
        eng.close()
