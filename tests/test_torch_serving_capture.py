"""The serving steps of ``incubator_mxnet_tpu_torch/serving.py`` on their
static input buffers, on the CPU, where the same step bodies that the card
captures as CUDA graphs run eagerly: greedy streams equal to the JAX
engine's (paged with chunked prefill, and contiguous) under the same
weights (``models.transformer.params_from_jax``; the JAX engine compiled
under ``jax.default_matmul_precision("highest")``), the prefills'
tensor positions equal to int ones bit for bit, the always-in-the-step
sampler's greedy rows equal to argmax, solo streams equal to crowded
ones, the launch-count bookkeeping of a captured step (deltas recorded at
capture, added at replay) with a stub body, and the compile and trace
counters, which no CPU engine moves."""
import contextlib
import copy
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from incubator_mxnet_tpu import serving as jserving
from incubator_mxnet_tpu.models import transformer as jt
from incubator_mxnet_tpu_torch import chaos, serving, telemetry
from incubator_mxnet_tpu_torch.models import transformer as tt
from incubator_mxnet_tpu_torch.ops.cuda import common
from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa

CACHE, PAGE, VOCAB = 64, 16, 29
MODES = {"paged_chunked": {"paged": 1, "buckets": (16, 32),
                           "prefill_chunk": PAGE, "prefix_cache": 0},
         "contiguous": {"paged": 0, "buckets": (8, 16, 32)}}


@pytest.fixture(autouse=True)
def _port_chaos_reset():
    chaos.reset()
    yield
    chaos.reset()


@pytest.fixture(scope="module")
def lm():
    jcfg = jt.TransformerConfig(vocab_size=VOCAB, d_model=32, n_heads=2,
                                d_ff=64, n_layers=2, max_len=CACHE,
                                dtype=jnp.float32)
    jparams = jt.init_transformer_params(jax.random.PRNGKey(3), jcfg)
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


def _prompts(n, lo=2, hi=30, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, (int(rng.randint(lo, hi)),)).astype(
        np.int32) for _ in range(n)]


def _spec(params, cfg, mode, **kw):
    return {"params": params, "cfg": cfg, "max_len": CACHE, "block": PAGE,
            "max_new_tokens": 8, **MODES[mode], **kw}


@contextlib.contextmanager
def _engine(lm, mode, name="capture_lm", **kw):
    _, _, params, cfg = lm
    eng = serving.InferenceEngine(device="cpu")
    try:
        yield eng, eng.load_model(name, generate=_spec(params, cfg, mode,
                                                       **kw))
    finally:
        eng.close()


# -------------------------------------------------------- against the JAX
@pytest.mark.parametrize("mode", sorted(MODES))
def test_greedy_streams_match_jax_engine(lm, mode, threads_clean):
    """Greedy streams through the static-buffer steps equal the JAX
    engine's compiled steps for the same prompts, all in flight at once;
    the paged engine takes prompts of up to 29 tokens in 16-token chunks
    (two chunks a long prompt, interleaved with other slots' decode
    steps)."""
    jparams, jcfg, _, _ = lm
    prompts = _prompts(5, lo=3, hi=30, seed=11)
    assert max(map(len, prompts)) > PAGE
    with jax.default_matmul_precision("highest"):
        jeng = jserving.InferenceEngine()
        try:
            jep = jeng.load_model("genlm", generate=_spec(
                jparams, jcfg, mode, slots=3))
            want = [f.result(120.0) for f in
                    [jep.submit(p, max_new_tokens=6) for p in prompts]]
        finally:
            jeng.close()
    with _engine(lm, mode, slots=3) as (_, ep):
        got = [f.result(60.0) for f in
               [ep.submit(p, max_new_tokens=6) for p in prompts]]
    assert got == want


@pytest.mark.parametrize("mode", sorted(MODES))
def test_solo_streams_equal_crowded(lm, mode, threads_clean):
    """A request's greedy and sampled streams are the same alone and
    among a crowd that joins and leaves the decode batch (the steps'
    static inputs are rewritten whole at every call)."""
    probe = _prompts(1, lo=18, hi=24, seed=5)[0]
    kw = dict(max_new_tokens=8)
    sampled = dict(temperature=0.9, top_k=6, seed=17)
    with _engine(lm, mode, slots=4) as (_, ep):
        solo = ep.generate(probe, timeout=60.0, **kw)
        solo_s = ep.generate(probe, timeout=60.0, **kw, **sampled)
        crowd = [ep.submit(p, max_new_tokens=2 + i % 5,
                           **(sampled if i % 2 else {}))
                 for i, p in enumerate(_prompts(10, seed=6))]
        mine = [ep.submit(probe, **kw), ep.submit(probe, **kw, **sampled)]
        for f in crowd:
            f.result(60.0)
        assert [f.result(60.0) for f in mine] == [solo, solo_s]
        assert any(occ > 1 for _, _, occ in ep.admit_log)


# ------------------------------------------------------- tensor positions
def _model_inputs(lm, seed, T=16):
    _, _, params, cfg = lm
    rng = np.random.RandomState(seed)
    tokens = torch.from_numpy(rng.randint(0, VOCAB, (1, T)).astype(
        np.int64))
    return params, cfg, tokens


@pytest.mark.parametrize("start,n_valid,T", [(0, 16, 16), (16, 9, 16),
                                             (48, 16, 32), (32, 1, 16)])
def test_paged_prefill_tensor_positions_equal_ints(lm, start, n_valid, T):
    """``transformer_prefill_paged`` with ``start`` and ``n_valid`` as 0-d
    tensors gives the int call's logits and pool bit for bit, the padded
    tail chunk at the end of the cache included (start 48 in a 32-token
    bucket: the padded rows' positions 64..79 run past max_len, are
    clipped, and write to the trash page)."""
    params, cfg, tokens = _model_inputs(lm, start + n_valid, T)
    cache = tt.init_paged_kv_cache(cfg, 8, PAGE, device="cpu")
    g = torch.Generator().manual_seed(1)
    for k in ("k", "v"):
        cache[k].normal_(generator=g)
    pages = torch.tensor([5, 2, 7, 0], dtype=torch.int64)
    a, b = copy.deepcopy(cache), copy.deepcopy(cache)
    with torch.inference_mode():
        _, la = tt.transformer_prefill_paged(params, tokens, cfg, a, pages,
                                             start, n_valid)
        _, lb = tt.transformer_prefill_paged(
            params, tokens, cfg, b, pages, torch.tensor(start),
            torch.tensor([n_valid])[0])
    assert torch.equal(la, lb) and la.shape == (VOCAB,)
    assert all(torch.equal(a[k], b[k]) for k in ("k", "v"))
    assert not torch.equal(a["k"], cache["k"])


@pytest.mark.parametrize("slot,length", [(0, 16), (2, 5), (1, 1)])
def test_contiguous_prefill_tensor_positions_equal_ints(lm, slot, length):
    """``transformer_prefill`` with ``slot`` and ``length`` as tensors
    (the K/V write a tensor-indexed copy, the logits row an
    ``index_select``) gives the int call's logits and cache bit for bit,
    and writes only its slot."""
    params, cfg, tokens = _model_inputs(lm, 7 + slot)
    cache = tt.init_kv_cache(cfg, 3, CACHE, device="cpu")
    a, b = copy.deepcopy(cache), copy.deepcopy(cache)
    with torch.inference_mode():
        _, la = tt.transformer_prefill(params, tokens, cfg, a, slot, length)
        _, lb = tt.transformer_prefill(params, tokens, cfg, b,
                                       torch.tensor(slot),
                                       torch.tensor([length]))
    assert torch.equal(la, lb)
    assert all(torch.equal(a[k], b[k]) for k in ("k", "v"))
    others = [s for s in range(3) if s != slot]
    assert not a["k"][:, others].any() and a["k"][:, slot, :, :16].any()


# ---------------------------------------------------------------- sampler
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sample_tokens_greedy_rows_are_argmax(dtype):
    """In a batch that mixes greedy and sampled rows, each row with
    ``temps == 0`` is the exact argmax of its logits, whatever its top_k,
    top_p and seed (the step samples every row; no host branch)."""
    g = torch.Generator().manual_seed(4)
    logits = (torch.randn(8, 97, generator=g) * 3).to(dtype)
    temps = torch.tensor([0, 1.0, 0, 0.7, 0, 2.0, 0, 0])
    topks = torch.tensor([0, 5, 3, 0, 1, 0, 50, 0])
    topps = torch.tensor([0, 0.9, 0.5, 0, 0, 1.0, 0.2, 0.95])
    seeds = torch.arange(8) * 1_000_003
    positions = torch.arange(8) + 40
    toks = serving.sample_tokens(logits, temps, topks, topps, seeds,
                                 positions)
    greedy = logits.argmax(dim=1)
    assert torch.equal(toks[temps == 0], greedy[temps == 0])
    assert toks.dtype == torch.int64 and toks.shape == (8,)
    assert all(0 <= int(t) < 97 for t in toks)


# ------------------------------------------------------------ step graphs
def test_step_inputs_are_views_of_one_buffer_a_kind():
    """On the CPU the host views are the device buffer itself: what a call
    writes is what the body reads, with nothing to copy; every field is a
    view of one int64 or one float32 buffer."""
    inp = serving._StepInputs(torch.device("cpu"),
                              {"tokens": (1, 4), "start": (), "pos": (1,)},
                              {"temp": (1,)})
    inp.h["tokens"][0, :2] = [7, 8]
    inp.h["start"][...] = 5
    inp.h["temp"][...] = 0.5
    inp.load()
    assert inp.t["tokens"].tolist() == [[7, 8, 0, 0]]
    assert inp.t["start"].shape == () and int(inp.t["start"]) == 5
    assert float(inp.t["temp"][0]) == 0.5
    base = inp.t["tokens"].untyped_storage().data_ptr()
    assert inp.t["pos"].untyped_storage().data_ptr() == base
    assert inp.t["tokens"].dtype == torch.int64
    assert inp.t["temp"].dtype == torch.float32


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_captured_launch_counts_follow_replays():
    """A captured step's counts: what the wrappers counted during capture
    (which launched nothing) is taken back, and every replay adds the
    capture's deltas, so ``launch_counts`` stays the launches made; an
    uncaptured step counts through its body."""
    common.reset_launch_counts()
    inp = serving._StepInputs(torch.device("cpu"), {"x": (2,)}, {})
    calls = []

    def body():
        calls.append(1)
        for _ in range(12):
            fa.flash_decode_step_paged.launches += 1
            fa.flash_decode_step_paged.sm90_launches += 1
        return inp.t["x"] + 1

    step = serving._StepGraph(body, inp)
    step()
    assert fa.flash_decode_step_paged.launches == 12
    graph = _StubGraph()
    step.capture(graph, contextlib.nullcontext())
    assert step.counts == {"flash_decode_step_paged": (12, 12, 0)}
    assert common.launch_counts()["flash_decode_step_paged"] == 12
    for _ in range(3):
        out = step()
    assert graph.replays == 3 and len(calls) == 2
    assert out is step.out
    assert common.launch_counts()["flash_decode_step_paged"] == 12 + 36
    assert common.sm90_launch_counts()["flash_decode_step_paged"] == 48
    assert common.x3_launch_counts()["flash_decode_step_paged"] == 0
    common.reset_launch_counts()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cpu_model_builds_one_step_a_bucket_and_no_graph(lm, mode):
    """``len(buckets) + 1`` steps on static inputs; on the CPU none is
    captured, and the decode step's block tables hold the trash page until
    the first call."""
    _, _, params, cfg = lm
    m = serving._GenerativeModel(
        params, cfg, slots=2, cache_len=CACHE, block=PAGE,
        buckets=MODES[mode]["buckets"], eos_id=None, max_new_tokens=4,
        name="capture_probe", paged=bool(MODES[mode]["paged"]),
        device="cpu")
    assert sorted(m._prefills) == list(MODES[mode]["buckets"])
    steps = list(m._prefills.values()) + [m._decode]
    assert all(s.graph is None for s in steps)
    if m.paged:
        assert (m._decode.inputs.t["bts"] == m.trash_page).all()
        assert (m._prefills[16].inputs.t["pages"] == m.trash_page).all()


def test_traffic_moves_no_compile_or_trace_counter_on_cpu(lm,
                                                          threads_clean):
    """The CPU engine captures nothing: loading and traffic leave
    ``mxtpu_serve_compiles_total`` and ``mxtpu_serve_gen_traces_total`` at
    0 for the model (the card's engine counts ``len(buckets) + 1`` of
    each at load, and traffic none)."""
    compiles = telemetry.counter("mxtpu_serve_compiles_total")
    traces = telemetry.counter("mxtpu_serve_gen_traces_total")
    for mode in sorted(MODES):
        with _engine(lm, mode, name=f"counted_{mode}", slots=2) as (_, ep):
            for p in _prompts(4, seed=9):
                ep.generate(p, max_new_tokens=3, timeout=60.0)
            assert compiles.value(model=f"counted_{mode}") == 0
            assert traces.value(model=f"counted_{mode}") == 0
