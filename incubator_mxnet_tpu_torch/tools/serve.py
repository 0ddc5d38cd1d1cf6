"""Model server: HTTP endpoints over the port's ``serving.InferenceEngine``.

Counterpart of the reference's ``tools/serve.py`` (the deployment story of
the C predict ABI, include/mxnet/c_predict_api.h): serve the built-in
demo MLP (``--demo``) and the tiny demo LM (``--generate-demo``) with
continuous batching, every concurrent client riding the same padded
bucket's CUDA graph. The engine runs on the card unless ``--device cpu``
is given::

    python -m incubator_mxnet_tpu_torch.tools.serve --demo --port 8000
    curl -s -X POST -H 'Content-Type: application/json' \\
        -d '{"data": [0.1, 0.2, ...]}' \\
        http://127.0.0.1:8000/v1/models/demo:predict
    # "data" is ONE request of the model's item shape (no batch dim) —
    # batching is the engine's job

Routes, as the reference's:
  POST /v1/models/<name>:predict   one request (npy bytes, with
                                   X-Deadline-Ms / X-Tenant / X-Priority
                                   headers, or JSON {"data": [...],
                                   "deadline_ms": D, "tenant": T,
                                   "priority": P}); the response mirrors
                                   the request format. 429 on
                                   backpressure or tenant quota (with
                                   Retry-After), 503 during drain or while
                                   the model is degraded, 504 with
                                   Retry-After when the scheduler shed the
                                   request past its deadline.
  POST /v1/models/<name>:generate  one prompt (JSON {"tokens": [...],
                                   "max_new_tokens": N, "stream": bool,
                                   "temperature": F, "top_k": K,
                                   "top_p": P, "seed": S,
                                   "deadline_ms": D}); streamed (the
                                   default) as chunked JSON lines, one
                                   {"token": t} a token then {"done":
                                   true}, else one {"tokens": [...]}
                                   body. 429/503/504 as for :predict.
  POST /v1/models/<name>:reload    hot swap: re-stage the model from its
                                   load source, canary, flip, drain, free;
                                   409 + {"error": ...} when the stage or
                                   canary fails (the live version keeps
                                   serving). SIGHUP reloads every model.
  GET  /v1/models                  loaded models and serving stats
  GET  /v1/traces                  the tail-sampled trace store
                                   (?model=, ?limit=; ?id=<trace_id> one
                                   waterfall, &fmt=chrome as chrome-trace
                                   JSON)
  GET  /metrics                    Prometheus exposition (exemplars under
                                   Accept: application/openmetrics-text)
  GET  /healthz                    liveness (200 while up)
  GET  /readyz                     readiness: 503 + the state map while a
                                   model is degraded

Every :predict/:generate response carries ``x-mxtpu-trace-id``; a W3C
``traceparent`` request header is joined. SIGTERM/SIGINT drain: in-flight
and queued requests finish, new ones get 503, then the process exits.
``--telemetry-dir`` writes this process's metrics snapshot to
``DIR/metrics-rankserve<rank>.json``. ``--model NAME=PREFIX`` (an
``export()`` artifact) is the symbolic slice, ROADMAP.md A11, and exits
with an error naming it.
"""
import argparse
import io
import json
import os
import signal
import sys
import threading
import time

import numpy as np

#: the reference's tiny generate-demo LM (its serve_bench.py GEN_* values)
GEN_VOCAB, GEN_DMODEL, GEN_HEADS, GEN_DFF, GEN_LAYERS, GEN_CACHE = (
    97, 128, 4, 256, 2, 256)


def _context(device):
    import incubator_mxnet_tpu_torch as mx
    return mx.cpu() if str(device) == "cpu" else mx.gpu(0)


def _build_demo_mlp(device="cuda", item_dim=16, classes=10, hidden=64,
                    seed=0):
    """Tiny deterministic MLP endpoint (the reference's demo), its
    parameters on ``device``."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.gluon import nn
    mx.random.seed(seed)
    with _context(device):
        net = nn.HybridSequential()
        net.add(nn.Dense(hidden, activation="relu"), nn.Dense(classes))
        net.initialize(mx.init.Xavier(rnd_type="uniform"))
        net.hybridize()
        net(mx.nd.zeros((1, item_dim)))
    return net, (item_dim,)


def _build_demo_lm(device="cuda", seed=0):
    """The tiny transformer LM of the reference's generate demo (vocab 97,
    d_model 128, 4 heads, d_ff 256, 2 layers, 256 positions, float32),
    seeded random parameters on ``device``. Returns (params, cfg)."""
    import torch
    from incubator_mxnet_tpu_torch.context import resolve_device
    from incubator_mxnet_tpu_torch.models.transformer import (
        TransformerConfig, init_transformer_params)
    cfg = TransformerConfig(vocab_size=GEN_VOCAB, d_model=GEN_DMODEL,
                            n_heads=GEN_HEADS, d_ff=GEN_DFF,
                            n_layers=GEN_LAYERS, max_len=GEN_CACHE,
                            dtype=torch.float32)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return init_transformer_params(gen, cfg, device=dev), cfg


def make_handler(engine, reloaders=None):
    """``reloaders`` maps model name -> zero-arg callable returning the
    ``engine.load_model`` kwargs that restage it (the ``:reload`` route
    and SIGHUP both drive hot swaps through it)."""
    from http.server import BaseHTTPRequestHandler

    from .. import serving, telemetry

    reloaders = reloaders if reloaders is not None else {}
    # shed responses suggest a concrete come-back time: one batching
    # window (rounded up) is when queue pressure can next have changed
    retry_after = str(max(1, int(-(-engine.max_wait_ms // 1000))))

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _send(self, code, body, ctype="application/json",
                  headers=None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code, obj, headers=None):
            self._send(code, (json.dumps(obj) + "\n").encode(),
                       headers=headers)

        def _send_shed(self, code, err, tid=None):
            """429/504 shed: typed reason + Retry-After so well-behaved
            clients back off instead of hammering."""
            self._send_json(code, {"error": str(err),
                                   "reason": getattr(err, "reason",
                                                     "deadline")},
                            headers=self._tid_headers(
                                tid, {"Retry-After": retry_after}))

        def _chunk(self, payload: bytes):
            self.wfile.write(f"{len(payload):X}\r\n".encode() + payload
                             + b"\r\n")

        def _new_trace(self, kind, model):
            """Request trace: joins the caller's W3C traceparent when
            the header is present, else starts a fresh 128-bit id.
            Deferred: the engine records its outcome but THIS handler
            closes the trace (``engine.retire_trace``) after the
            response is written, so respond/stream_write spans count
            toward attribution and stored traces never mutate."""
            return telemetry.Trace(
                kind, model=model,
                traceparent=self.headers.get("traceparent")).defer()

        def _tid_headers(self, tid, extra=None):
            h = dict(extra or {})
            if tid:
                h["x-mxtpu-trace-id"] = tid
            return h

        def _do_generate(self, name):
            try:
                ep = engine.endpoint(name)
            except KeyError:
                return self._send_json(404,
                                       {"error": f"no model {name!r}"})
            if not isinstance(ep, serving.GenerativeEndpoint):
                return self._send_json(
                    400, {"error": f"model {name!r} is not a generate "
                                   "endpoint"})
            tr = self._new_trace("generate", name)
            tid = tr.trace_id
            status = "rejected"     # until the engine owns the request
            try:
                return self._do_generate_traced(name, ep, tr, tid)
            finally:
                # the engine-recorded outcome (shed/error/ok) wins over
                # the handler's view when both landed
                engine.retire_trace(name, tr,
                                    status=self._last_status(status))

        def _last_status(self, default):
            s = getattr(self, "_trace_status", None)
            self._trace_status = None
            return s or default

        def _do_generate_traced(self, name, ep, tr, tid):
            n = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(n))
                tokens = np.asarray(body["tokens"], dtype=np.int32)
                max_new = body.get("max_new_tokens")
                stream = bool(body.get("stream", True))
                fut = ep.submit(
                    tokens, max_new_tokens=max_new,
                    temperature=float(body.get("temperature", 0.0)),
                    top_k=int(body.get("top_k", 0)),
                    top_p=float(body.get("top_p", 0.0)),
                    seed=int(body.get("seed", 0)),
                    deadline_ms=body.get("deadline_ms"), trace=tr)
            except serving.PagesExhaustedError as e:
                return self._send_shed(429, e, tid)
            except serving.QueueFullError as e:
                return self._send_shed(429, e, tid)
            except serving.EngineClosedError as e:
                return self._send_json(503, {"error": str(e)},
                                       headers=self._tid_headers(tid))
            except (ValueError, KeyError, TypeError) as e:
                return self._send_json(400, {"error": str(e)},
                                       headers=self._tid_headers(tid))
            timeout = getattr(engine, "http_request_timeout", 120.0)
            self._trace_status = "error"
            if not stream:
                try:
                    toks = fut.result(timeout)
                except serving.RequestAborted as e:
                    self._trace_status = "aborted"
                    return self._send_json(499, {"error": str(e)},
                                           headers=self._tid_headers(tid))
                except serving.DeadlineError as e:
                    self._trace_status = "shed"
                    return self._send_shed(504, e, tid)
                except TimeoutError as e:
                    fut.cancel()    # free the KV slot next iteration
                    self._trace_status = "hung"
                    return self._send_json(504, {"error": str(e)},
                                           headers=self._tid_headers(tid))
                except Exception as e:
                    return self._send_json(500, {"error": str(e)},
                                           headers=self._tid_headers(tid))
                t_resp = time.perf_counter()
                ret = self._send_json(200, {"tokens": toks,
                                            "trace_id": tid},
                                      headers=self._tid_headers(tid))
                tr.observe("respond", time.perf_counter() - t_resp)
                self._trace_status = "ok"
                return ret
            # chunked streaming: one JSON line per token as it lands
            self.send_response(200)
            self.send_header("Content-Type",
                             "application/jsonl; charset=utf-8")
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header("x-mxtpu-trace-id", tid)
            self.end_headers()
            write_s, chunks = 0.0, 0
            try:
                for tok in fut.stream(timeout=timeout):
                    t_w = time.perf_counter()
                    self._chunk((json.dumps({"token": int(tok)})
                                 + "\n").encode())
                    write_s += time.perf_counter() - t_w
                    chunks += 1
                tail = {"done": True, "n": len(fut.tokens()),
                        "trace_id": tid}
                self._trace_status = "ok"
            except TimeoutError:
                fut.cancel()        # free the KV slot next iteration
                self._trace_status = "hung"
                tail = {"error": "inter-token timeout", "aborted": True,
                        "trace_id": tid}
            except serving.RequestAborted:
                self._trace_status = "aborted"
                tail = {"error": "aborted", "aborted": True,
                        "trace_id": tid}
            except Exception as e:
                tail = {"error": str(e), "trace_id": tid}
            tr.observe("stream_write", write_s, chunks=chunks)
            try:
                self._chunk((json.dumps(tail) + "\n").encode())
                self.wfile.write(b"0\r\n\r\n")
            except OSError:
                # client hung up mid-stream: release its KV slot
                fut.cancel()
                self._trace_status = "aborted"

        def do_GET(self):
            if self.path.startswith("/healthz"):
                self._send_json(200, {"ok": True})
            elif self.path.startswith("/readyz"):
                all_ready, states = engine.ready()
                self._send_json(200 if all_ready else 503,
                                {"ready": all_ready, "models": states})
            elif self.path.startswith("/metrics"):
                # exemplars only when the scraper negotiates OpenMetrics
                # — the classic 0.0.4 parser rejects '# {...}' trailers
                text, ctype = telemetry.negotiate_metrics(
                    self.headers.get("Accept"))
                self._send(200, text.encode(), ctype)
            elif self.path.startswith("/v1/traces"):
                self._do_traces()
            elif self.path.startswith("/v1/models"):
                self._send_json(200, engine.stats())
            else:
                self._send_json(404, {"error": "not found"})

        def _do_traces(self):
            """Tail-sampled trace store: summaries, one waterfall by
            ?id=, chrome-trace export with &fmt=chrome."""
            from urllib.parse import parse_qs, urlparse
            q = parse_qs(urlparse(self.path).query)
            store = telemetry.trace_store()
            tid = (q.get("id") or [None])[0]
            if tid is None:
                try:
                    limit = int((q.get("limit") or [64])[0])
                except ValueError:
                    limit = 64
                model = (q.get("model") or [None])[0]
                out = store.stats()
                out["traces"] = store.summaries(model=model, limit=limit)
                return self._send_json(200, out)
            tr = store.get(tid)
            if tr is None:
                return self._send_json(
                    404, {"error": f"no retained trace {tid!r} (tail "
                                   "retention keeps errors/sheds, "
                                   "slowest-N, and 1-in-K survivors)"})
            if (q.get("fmt") or [None])[0] == "chrome":
                return self._send_json(200, tr.to_chrome())
            return self._send_json(200, tr.to_dict())

        def _do_reload(self, name):
            maker = reloaders.get(name)
            if maker is None:
                return self._send_json(
                    404, {"error": f"no reloadable model {name!r}"})
            try:
                ep = engine.load_model(name, **maker())
            except serving.SwapError as e:
                # stage/canary failed: the live version was never
                # unrouted — 409, nothing changed
                return self._send_json(409, {"error": str(e),
                                             "rolled_back": True})
            except Exception as e:
                return self._send_json(500, {"error": str(e)})
            return self._send_json(200, {"swapped": True,
                                         "version": ep.version})

        def do_POST(self):
            path = self.path
            if path.startswith("/v1/models/") and \
                    path.endswith(":generate"):
                return self._do_generate(
                    path[len("/v1/models/"):-len(":generate")])
            if path.startswith("/v1/models/") and \
                    path.endswith(":reload"):
                return self._do_reload(
                    path[len("/v1/models/"):-len(":reload")])
            if not (path.startswith("/v1/models/")
                    and path.endswith(":predict")):
                return self._send_json(404, {"error": "not found"})
            name = path[len("/v1/models/"):-len(":predict")]
            try:
                ep = engine.endpoint(name)
            except KeyError:
                return self._send_json(404,
                                       {"error": f"no model {name!r}"})
            if isinstance(ep, serving.GenerativeEndpoint):
                return self._send_json(
                    400, {"error": f"model {name!r} is a generate "
                                   "endpoint — POST to :generate"})
            tr = self._new_trace("predict", name)
            tid = tr.trace_id
            try:
                return self._do_predict_traced(name, ep, tr, tid)
            finally:
                engine.retire_trace(name, tr,
                                    status=self._last_status("rejected"))

        def _do_predict_traced(self, name, ep, tr, tid):
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n)
            as_npy = "x-npy" in (self.headers.get("Content-Type") or "")
            try:
                kw = {"trace": tr}
                if as_npy:
                    x = np.load(io.BytesIO(raw), allow_pickle=False)
                    # npy bodies carry SLO/tenant metadata in headers
                    if self.headers.get("X-Deadline-Ms"):
                        kw["deadline_ms"] = float(
                            self.headers["X-Deadline-Ms"])
                    if self.headers.get("X-Tenant"):
                        kw["tenant"] = self.headers["X-Tenant"]
                    if self.headers.get("X-Priority"):
                        kw["priority"] = int(self.headers["X-Priority"])
                else:
                    body = json.loads(raw)
                    x = np.asarray(body["data"],
                                   dtype=str(ep.model.dtype))
                    if body.get("deadline_ms") is not None:
                        kw["deadline_ms"] = float(body["deadline_ms"])
                    if body.get("tenant") is not None:
                        kw["tenant"] = str(body["tenant"])
                    if body.get("priority") is not None:
                        kw["priority"] = int(body["priority"])
                out = ep.predict(
                    x, timeout=getattr(engine, "http_request_timeout",
                                       120.0), **kw)
            except serving.QueueFullError as e:
                return self._send_shed(429, e, tid)
            except serving.DeadlineError as e:
                # the scheduler shed this request before compute: its
                # queue wait alone already guaranteed the SLO miss
                return self._send_shed(504, e, tid)
            except serving.ModelDegradedError as e:
                return self._send_json(503, {"error": str(e),
                                             "state": "degraded"},
                                       headers=self._tid_headers(tid))
            except serving.EngineClosedError as e:
                return self._send_json(503, {"error": str(e)},
                                       headers=self._tid_headers(tid))
            except TimeoutError as e:
                # never wedge an HTTP worker thread on a response that
                # will not come (e.g. a hung fetch with the watchdog off)
                self._trace_status = "hung"
                return self._send_json(504, {"error": str(e)},
                                       headers=self._tid_headers(tid))
            except (ValueError, KeyError) as e:
                return self._send_json(400, {"error": str(e)},
                                       headers=self._tid_headers(tid))
            except Exception as e:     # model/runtime failure
                self._trace_status = "error"
                return self._send_json(500, {"error": str(e)},
                                       headers=self._tid_headers(tid))
            t_resp = time.perf_counter()
            outs = out if isinstance(out, list) else [out]
            if as_npy:
                buf = io.BytesIO()
                np.save(buf, outs[0])
                self._send(200, buf.getvalue(), "application/x-npy",
                           headers=self._tid_headers(tid))
            else:
                self._send_json(200,
                                {"outputs": [o.tolist() for o in outs],
                                 "trace_id": tid},
                                headers=self._tid_headers(tid))
            tr.observe("respond", time.perf_counter() - t_resp)
            self._trace_status = "ok"

        def log_message(self, *args):   # request logging via metrics, not
            pass                        # per-request stderr lines

    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="continuous-batching model server")
    ap.add_argument("--model", action="append", default=[],
                    metavar="NAME=PREFIX[:WEIGHT]",
                    help="serve an export() artifact (ROADMAP.md A11: "
                         "not ported; exits with an error)")
    ap.add_argument("--demo", action="store_true",
                    help="serve the built-in tiny MLP as 'demo'")
    ap.add_argument("--generate-demo", action="store_true",
                    help="serve the built-in tiny transformer LM as "
                         "'genlm' (:generate streaming endpoint; slot/"
                         "bucket knobs via MXTPU_SERVE_GEN_*)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the engine's device (default: the card)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--max-wait-ms", type=float, default=None)
    ap.add_argument("--queue-limit", type=int, default=None)
    ap.add_argument("--timeout-ms", type=float, default=None,
                    help="hung-request watchdog deadline "
                         "(MXTPU_SERVE_TIMEOUT_MS)")
    ap.add_argument("--request-timeout", type=float, default=120.0,
                    help="per-HTTP-request wait bound in seconds "
                         "(504 when exceeded)")
    ap.add_argument("--telemetry-dir", default=None, metavar="DIR",
                    help="write this process's metrics snapshot to "
                         "DIR/metrics-rankserve<rank>.json at exit")
    args = ap.parse_args(argv)
    if args.model:
        ap.error(f"--model {args.model[0]!r}: serving an export() artifact "
                 "needs the symbolic slice's export and _StableHLOBlock "
                 "(ROADMAP.md A11), not ported yet")

    if args.telemetry_dir:
        os.makedirs(args.telemetry_dir, exist_ok=True)
        rank = os.environ.get("MXTPU_WORKER_RANK", "0")
        os.environ.setdefault(
            "MXTPU_TELEMETRY_METRICS",
            os.path.join(args.telemetry_dir,
                         f"metrics-rankserve{rank}.json"))

    from http.server import ThreadingHTTPServer

    from incubator_mxnet_tpu_torch import serving

    engine = serving.InferenceEngine(
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        queue_limit=args.queue_limit, timeout_ms=args.timeout_ms,
        device=args.device)
    engine.http_request_timeout = args.request_timeout
    #: name -> zero-arg callable returning load_model kwargs; :reload
    #: and SIGHUP hot-swap through these
    reloaders = {}
    if args.demo:
        def _demo_kwargs():
            net, item_shape = _build_demo_mlp(args.device)
            return {"net": net, "item_shape": item_shape}
        spec0 = _demo_kwargs()
        engine.load_model("demo", **spec0)
        reloaders["demo"] = _demo_kwargs
        print(f"serve: loaded demo MLP "
              f"(item shape {spec0['item_shape']})")
    if args.generate_demo:
        params, cfg = _build_demo_lm(args.device)
        gep = engine.load_model("genlm",
                                generate={"params": params, "cfg": cfg,
                                          "max_len": cfg.max_len})
        print(f"serve: loaded genlm (vocab {cfg.vocab_size}, "
              f"{gep.model.slots} KV slots x {gep.model.cache_len}, "
              f"prompt buckets {list(gep.buckets)})")
    if not engine.stats():
        engine.close()
        ap.error("nothing to serve: pass --demo and/or --generate-demo")

    httpd = ThreadingHTTPServer((args.host, args.port),
                                make_handler(engine, reloaders))

    def _drain_report():
        """Queued + in-flight work at drain time: generative models count
        their live KV slots, not just the prompt queue."""
        queued = gen_live = 0
        for name, ep in list(engine._endpoints.items()):
            queued += ep.pending()
            if isinstance(ep, serving.GenerativeEndpoint):
                gen_live += ep.slots_in_use
        return queued, gen_live

    def _drain(signum, frame):
        queued, gen_live = _drain_report()
        print(f"serve: signal {signum} — draining ({queued} queued, "
              f"{gen_live} live generation slots)", file=sys.stderr)
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    def _reload_all(signum, frame):
        # SIGHUP = hot swap every reloadable model; a failed canary
        # rolls that model back and keeps the old version serving
        def run():
            for name, maker in list(reloaders.items()):
                try:
                    ep = engine.load_model(name, **maker())
                    print(f"serve: SIGHUP swapped {name!r} "
                          f"-> v{ep.version}", file=sys.stderr)
                except serving.SwapError as e:
                    print(f"serve: SIGHUP swap of {name!r} rolled "
                          f"back: {e}", file=sys.stderr)
        threading.Thread(target=run, daemon=True,
                         name="mxtpu-serve-reload").start()

    signal.signal(signal.SIGTERM, _drain)
    signal.signal(signal.SIGINT, _drain)
    if hasattr(signal, "SIGHUP"):
        signal.signal(signal.SIGHUP, _reload_all)
    print(f"serve: listening on http://{args.host}:{httpd.server_port} "
          f"({', '.join(engine.stats())}) on {engine.device}", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        queued, gen_live = _drain_report()
        engine.close(drain=True)
        print(f"serve: drained ({queued} queued + {gen_live} live "
              "generation slots finished), bye")
    return 0


if __name__ == "__main__":
    sys.exit(main())
