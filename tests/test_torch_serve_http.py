"""The port's HTTP front end (``incubator_mxnet_tpu_torch.tools.serve``)
on the CPU, over real sockets on ``127.0.0.1:0``.

Ported from the reference's HTTP tests, which wait for this front end:
``test_serving_resilience.py::test_http_reload_and_readyz`` and
``::test_http_shed_sets_retry_after`` (plus a 429 queue-full shed), and
``test_request_tracing.py::test_http_traceparent_roundtrip_and_trace_route``
and ``::test_http_exemplars_link_metrics_to_store``. New here: ``:predict``
in npy and JSON equal to ``Endpoint.predict`` bit for bit (an int8 MLP
served with ``quantize=``), a ``:generate`` stream and body equal to the
engine's own greedy stream, ``/v1/models``, ``--model`` exiting with an
error naming ROADMAP.md A11, ``main()`` in a subprocess (``--demo
--device cpu``: predict, SIGHUP hot swap, SIGTERM drain, exit 0), and a
shed request's deferred trace, retained in the trace store, keeping no
closed engine alive.
"""
import io
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import weakref
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import chaos, serving, telemetry
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.tools import serve as tserve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the fixture's model: a name of this file's own, since the metrics
#: registry and the trace store (slowest five traces a model) are the
#: process's, shared with the other serving test files of a worker
M = "m_http"


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


def _serve(eng, reloaders):
    httpd = ThreadingHTTPServer(
        ("127.0.0.1", 0), tserve.make_handler(eng, reloaders=reloaders))
    thr = threading.Thread(target=httpd.serve_forever,
                           name="mxtpu-test-http", daemon=True)
    thr.start()
    return httpd, thr


def _stop(httpd, thr, eng):
    httpd.shutdown()
    httpd.server_close()
    thr.join(timeout=5.0)
    eng.close()


@pytest.fixture
def http_engine(threads_clean):
    eng = serving.InferenceEngine(max_batch=2, max_wait_ms=1.0,
                                  device="cpu")
    eng.load_model(M, fn=lambda x: x + 1.0, item_shape=(2,))
    reloaders = {M: lambda: dict(fn=lambda x: x + 2.0, item_shape=(2,))}
    httpd, thr = _serve(eng, reloaders)
    try:
        yield eng, httpd.server_address[1]
    finally:
        _stop(httpd, thr, eng)


def _post(port, path, payload=None, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload or {}).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, dict(r.headers), json.loads(r.read() or b"{}")


def _get_json(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, dict(r.headers), json.loads(r.read())


def _slow(delay):
    def fn(x):
        time.sleep(delay)
        return x
    return fn


# ------------------------------------------------- the reference's tests
def test_http_reload_and_readyz(http_engine):
    """POST :reload hot-swaps and reports the new version; /readyz tracks
    per-model state; reload of an unknown model is 404."""
    eng, port = http_engine
    st, _, body = _post(port, f"/v1/models/{M}:reload")
    assert st == 200 and body["swapped"] and body["version"] == 2
    out = _post(port, f"/v1/models/{M}:predict", {"data": [0.0, 0.0]})
    assert out[2]["outputs"][0][0] == 2.0          # v2 live
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/readyz", timeout=30) as r:
        ready = json.loads(r.read())
        assert r.status == 200 and ready["ready"]
        assert ready["models"][M] == "ready"
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(port, "/v1/models/nope:reload")
    assert ei.value.code == 404


def test_http_shed_sets_retry_after(http_engine):
    """A 504 deadline shed and a 429 queue-full both carry Retry-After and
    a machine-readable reason."""
    eng, port = http_engine
    eng.load_model("slow", fn=_slow(0.2), item_shape=(1,))
    ep = eng._endpoints["slow"]
    blocker = ep.submit(np.zeros((1,), np.float32))
    time.sleep(0.05)
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(port, "/v1/models/slow:predict",
              {"data": [0.0], "deadline_ms": 20})
    err = ei.value
    assert err.code == 504
    assert int(err.headers["Retry-After"]) >= 1
    assert json.loads(err.read())["reason"] == "deadline"
    blocker.result(timeout=30.0)
    # a full queue: 429 with Retry-After and the reason
    eng.load_model("tiny", fn=_slow(0.3), item_shape=(1,), queue_limit=1,
                   max_batch=1)
    tiny = eng._endpoints["tiny"]
    held = [tiny.submit(np.zeros((1,), np.float32))]
    time.sleep(0.05)                        # the first is being served
    held.append(tiny.submit(np.zeros((1,), np.float32)))
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(port, "/v1/models/tiny:predict", {"data": [0.0]})
    err = ei.value
    assert err.code == 429
    assert int(err.headers["Retry-After"]) >= 1
    assert json.loads(err.read())["reason"] == "queue_full"
    for f in held:
        f.result(timeout=30.0)


def test_http_traceparent_roundtrip_and_trace_route(http_engine):
    """traceparent in -> joined trace id out on the response header and
    body; GET /v1/traces lists it; ?id= returns the waterfall with the
    HTTP respond span; unknown id is 404; a bad request still carries the
    header."""
    eng, port = http_engine
    caller = "f0" * 16
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/{M}:predict",
        data=json.dumps({"data": [0.0, 0.0]}).encode(),
        headers={"Content-Type": "application/json",
                 "traceparent": f"00-{caller}-{'ab' * 8}-01"})
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.headers["x-mxtpu-trace-id"] == caller
        assert json.loads(r.read())["trace_id"] == caller
    time.sleep(0.2)                     # demux finishes post-response
    st, _, listing = _get_json(port, f"/v1/traces?model={M}")
    assert st == 200 and listing["stored"] >= 1
    assert caller in [s["trace_id"] for s in listing["traces"]]
    st, _, detail = _get_json(port, f"/v1/traces?id={caller}")
    names = [s["name"] for s in detail["spans"]]
    for phase in ("enqueue", "queue_wait", "dispatch", "device",
                  "demux", "respond"):
        assert phase in names, names
    st, _, chrome = _get_json(port, f"/v1/traces?id={caller}&fmt=chrome")
    assert len(chrome["traceEvents"]) == len(detail["spans"])
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get_json(port, "/v1/traces?id=deadbeef")
    assert ei.value.code == 404
    bad = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/{M}:predict",
        data=b'{"nope": 1}',
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(bad, timeout=30)
    assert ei.value.code == 400
    assert re.fullmatch(r"[0-9a-f]{32}",
                        ei.value.headers["x-mxtpu-trace-id"])


def test_http_exemplars_link_metrics_to_store(http_engine):
    """/metrics under OpenMetrics negotiation exposes the request-latency
    histogram with an exemplar whose trace id resolves in /v1/traces; the
    default 0.0.4 scrape stays exemplar-free (the exemplar read is one of
    the fixture model's, ``M``)."""
    eng, port = http_engine
    for i in range(3):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/models/{M}:predict",
            data=json.dumps({"data": [float(i), 0.0]}).encode(),
            headers={"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=30).read()
    time.sleep(0.2)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/metrics",
        headers={"Accept": "application/openmetrics-text"})
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.headers["Content-Type"].startswith(
            "application/openmetrics-text")
        text = r.read().decode()
    m = re.search(r'mxtpu_serve_request_seconds_bucket\{[^}]*'
                  r'model="' + M + r'"[^}]*\} \d+ '
                  r'# \{trace_id="([0-9a-f]{32})"\}', text)
    assert m, "no exemplar on the latency histogram"
    assert text.rstrip().endswith("# EOF")
    st, _, detail = _get_json(port, f"/v1/traces?id={m.group(1)}")
    assert st == 200 and detail["trace_id"] == m.group(1)
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
        assert r.headers["Content-Type"].startswith(
            "text/plain; version=0.0.4")
        assert "# {" not in r.read().decode()


# --------------------------------------------------------------- new here
def _int8_mlp(seed=0):
    tmx.random.seed(seed)
    with tmx.cpu():
        net = nn.HybridSequential()
        net.add(nn.Dense(32, activation="relu"), nn.Dense(32,
                                                          activation="relu"),
                nn.Dense(10))
        net.initialize(tmx.init.Xavier())
        net(tmx.nd.zeros((1, 16)))
        calib = [tmx.nd.array(np.random.RandomState(9).rand(8, 16)
                              .astype(np.float32))]
    return net, calib


def test_http_predict_npy_and_json_equal_endpoint(threads_clean):
    """An int8 MLP (``quantize=``) over HTTP: :predict in npy (with the
    deadline/tenant/priority headers) and in JSON answers exactly what
    ``Endpoint.predict`` does; /v1/models carries its stats and bytes."""
    net, calib = _int8_mlp()
    eng = serving.InferenceEngine(max_batch=4, max_wait_ms=1.0,
                                  device="cpu")
    ep = eng.load_model("q", net=net, item_shape=(16,),
                        quantize={"calib_data": calib})
    httpd, thr = _serve(eng, {})
    port = httpd.server_address[1]
    try:
        x = np.random.RandomState(3).rand(16).astype(np.float32)
        want = ep.predict(x, timeout=30.0)
        buf = io.BytesIO()
        np.save(buf, x)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/models/q:predict",
            data=buf.getvalue(),
            headers={"Content-Type": "application/x-npy",
                     "X-Deadline-Ms": "30000", "X-Tenant": "a",
                     "X-Priority": "1"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.headers["Content-Type"] == "application/x-npy"
            got = np.load(io.BytesIO(r.read()), allow_pickle=False)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        st, _, body = _post(port, "/v1/models/q:predict",
                            {"data": x.tolist(), "deadline_ms": 30000,
                             "tenant": "b", "priority": 0})
        assert st == 200
        assert np.array_equal(np.asarray(body["outputs"][0], np.float32),
                              want)
        st, _, models = _get_json(port, "/v1/models")
        assert st == 200 and models["q"]["model_bytes"] == \
            ep.model.model_bytes
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, "/v1/models/nope:predict", {"data": [0.0]})
        assert ei.value.code == 404
    finally:
        _stop(httpd, thr, eng)


def test_http_generate_stream_and_body_equal_engine(threads_clean):
    """:generate streamed (JSON lines, one token each, then done) and
    whole (one tokens body) equal the engine's own greedy stream."""
    params, cfg = tserve._build_demo_lm("cpu")
    eng = serving.InferenceEngine(device="cpu")
    gep = eng.load_model("genlm", generate={"params": params, "cfg": cfg,
                                            "max_len": 64, "slots": 2})
    httpd, thr = _serve(eng, {})
    port = httpd.server_address[1]
    try:
        prompt = [5, 17, 3, 42, 8]
        want = list(gep.submit(np.asarray(prompt, np.int32),
                               max_new_tokens=16).result(60.0))
        assert len(want) == 16
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/models/genlm:generate",
            data=json.dumps({"tokens": prompt, "max_new_tokens": 16,
                             "stream": True}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            lines = [json.loads(ln) for ln in r.read().decode().splitlines()
                     if ln.strip()]
        assert [ln["token"] for ln in lines[:-1]] == want
        assert lines[-1]["done"] and lines[-1]["n"] == 16
        st, _, body = _post(port, "/v1/models/genlm:generate",
                            {"tokens": prompt, "max_new_tokens": 16,
                             "stream": False})
        assert st == 200 and list(body["tokens"]) == want
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, "/v1/models/genlm:predict", {"data": [0.0]})
        assert ei.value.code == 400
    finally:
        _stop(httpd, thr, eng)


def test_model_flag_names_a11(capsys):
    """``--model NAME=PREFIX`` serves an export() artifact, which is the
    symbolic slice: the server exits with an error naming A11."""
    with pytest.raises(SystemExit) as ei:
        tserve.main(["--model", "mnist=exports/mnist", "--device", "cpu"])
    assert ei.value.code == 2
    assert "A11" in capsys.readouterr().err


def test_main_demo_serves_reloads_and_drains():
    """``python -m incubator_mxnet_tpu_torch.tools.serve --demo --device
    cpu --port 0``: predicts, SIGHUP swaps the demo to v2, SIGTERM drains
    and the process exits 0."""
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "incubator_mxnet_tpu_torch.tools.serve",
         "--demo", "--device", "cpu", "--port", "0", "--max-wait-ms", "1"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        port = None
        t0 = time.monotonic()
        while port is None and time.monotonic() - t0 < 120:
            line = proc.stdout.readline()
            if not line:
                break
            m = re.search(r"listening on http://127\.0\.0\.1:(\d+)", line)
            if m:
                port = int(m.group(1))
        assert port is not None, proc.stderr.read()
        st, _, _ = _get_json(port, "/healthz")
        assert st == 200
        st, _, body = _post(port, "/v1/models/demo:predict",
                            {"data": [0.1] * 16})
        assert st == 200 and len(body["outputs"][0]) == 10
        proc.send_signal(signal.SIGHUP)
        t0 = time.monotonic()
        version = 1
        while version != 2 and time.monotonic() - t0 < 60:
            time.sleep(0.05)
            version = _get_json(port, "/v1/models")[2]["demo"].get(
                "version", version)
        assert version == 2
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err
        assert "drained" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_shed_trace_keeps_no_engine_alive(threads_clean):
    """A request shed at submit under a handler-deferred trace (the HTTP
    front end's): the trace store keeps the trace, not the exception, so
    the closed engine and its models are freed. Before the repair the
    recorded outcome held the QueueFullError, whose traceback held the
    submitting frames and through them the engine."""
    import gc

    def run():
        eng = serving.InferenceEngine(max_batch=1, max_wait_ms=1.0,
                                      device="cpu")
        ep = eng.load_model("tiny", fn=_slow(0.2), item_shape=(1,),
                            queue_limit=1, max_batch=1)
        held = [ep.submit(np.zeros((1,), np.float32))]
        time.sleep(0.05)
        held.append(ep.submit(np.zeros((1,), np.float32)))
        tr = telemetry.Trace("predict", model="tiny").defer()
        with pytest.raises(serving.QueueFullError):
            ep.predict(np.zeros((1,), np.float32), timeout=10.0, trace=tr)
        eng.retire_trace("tiny", tr, status="rejected")
        assert telemetry.trace_store().get(tr.trace_id) is not None
        for f in held:
            f.result(timeout=10.0)
        eng.close()
        return weakref.ref(eng)

    ref = run()
    gc.collect()
    assert ref() is None
