"""Unified runtime telemetry: step-phase spans, crash flight recorder, and
an exportable metrics registry.

A copy of the JAX package's telemetry module (stdlib only), kept by the
PyTorch port so that it imports nothing of the JAX package; metric names
are unchanged. Separate observability shims — ``profiler.get_counter``
counters for the fused step and the async pipeline, ``guard.host_syncs``,
GuardEvent log lines, chaos ``points()`` stats — would have no shared
timeline: when a run tripped the watchdog or the rollback ladder, a stack
dump would carry zero history of what the last N steps were doing. This
module is the one substrate they all feed:

**Span tracer** — ``telemetry.span("forward_backward", retrace=True)``
context managers instrument the canonical step phases (``data`` /
``prefetch_wait``, ``forward_backward``, ``fused_dispatch``,
``loss_flush``, ``allreduce``, ``ckpt_publish``) across
``fault.auto_resume_fit``, ``gluon.Trainer``, ``module.fit``,
``io.DevicePrefetcher`` and ``CheckpointManager``. Each completed span
records wall + monotonic time, duration, rank, step index, nesting parent,
and free-form attrs. Span durations also feed the
``mxtpu_phase_seconds`` histogram so the per-phase breakdown is scrapeable.

**Flight recorder** — a lock-cheap bounded ring of per-STEP buckets
(default last 512 steps, ``MXTPU_TELEMETRY_RING``) holding completed
spans plus guard-ladder and chaos-injection events. Dumped as JSON-lines
automatically on ``StepHungError`` / ``GuardTripError`` (the guard's
``action == 'raise'`` emit path), on an unhandled crash (``sys.excepthook``
chain + atexit backstop), on ``SIGUSR1``, and on explicit
``telemetry.dump()``. The first line is a meta record (reason, pid, rank,
step, full metrics snapshot); every following line is one span/event.

**Metrics registry** — typed ``Counter`` / ``Gauge`` / ``Histogram`` with
labels behind one API. ``profiler.get_counter`` routes here (back-compat
shim kept), so the fused-step, pipeline, guard, chaos and kvstore stats
share one registry with three exports: Prometheus text exposition
(``render_prometheus()``, plus an optional ``MXTPU_TELEMETRY_PORT``
background HTTP endpoint serving ``/metrics`` and ``/flight``), JSON-lines
(``render_jsonl()``), and chrome-trace (``render_chrome_trace()`` over the
ring; the profiler's own trace file also carries registry counter events).
Every sample is tagged with this process's rank; ``snapshot()`` /
``merge_snapshots()`` aggregate multi-rank runs (``tools/launch.py``
merges per-rank snapshot files, ``kvstore.telemetry_allgather`` does it
in-band over the collective mesh).

Overhead contract (ci/run.sh perf-smoke gates it): recording is
append-to-a-list cheap, never syncs the device, and never touches the
host<->device boundary — a telemetry-on 20-step loop must stay within 5%
of telemetry-off. ``MXTPU_TELEMETRY=0`` disables ring recording and the
crash hooks entirely (the metrics registry stays live: always-on framework
counters must keep working).

This module is import-light ON PURPOSE: stdlib only, no jax, no intra-
package imports — ``profiler``/``chaos``/``guard`` import *it*, and
``tools/launch.py`` loads it standalone to merge per-rank snapshots
without dragging in the full framework.
"""
from __future__ import annotations

import atexit
import contextlib
import json
import math
import os
import random
import signal
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = ["enabled", "rank", "set_step", "current_step", "span",
           "observe_span", "event", "guard_event", "chaos_event", "records",
           "phase_breakdown", "phase_share", "dump", "dump_path",
           "Counter", "Gauge",
           "Histogram", "counter", "gauge", "histogram", "render_prometheus",
           "render_jsonl", "render_chrome_trace", "snapshot",
           "merge_snapshots", "serve", "stop_serving", "reset",
           "Trace", "TraceStore", "trace_store", "current_trace",
           "parse_traceparent"]

_TRUTHY = ("1", "true", "yes", "on")


def _env_flag(name: str, default: bool) -> bool:
    v = os.environ.get(name, "")
    if not v:
        return default
    return v.lower() in _TRUTHY


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name, "")
    try:
        return int(v) if v else default
    except ValueError:
        return default


# --------------------------------------------------------------------- state
_lock = threading.Lock()        # ring structure + config; NOT held per record
_enabled = _env_flag("MXTPU_TELEMETRY", True)
_ring_steps = max(1, _env_int("MXTPU_TELEMETRY_RING", 512))
#: records per bucket before it rotates: a step index that never advances
#: (interactive use, eval loops, a bare gluon loop that never calls
#: ``set_step``) fills continuation buckets instead of growing one bucket
#: without bound — the ring then evicts the OLDEST bucket, so the dump
#: always holds the newest records (flight-recorder semantics)
MAX_RECORDS_PER_STEP = 256

_step = 0
_rank: Optional[int] = None


def _make_bucket(step: int) -> Dict[str, Any]:
    return {"step": step, "records": []}


_buckets: "deque" = deque([_make_bucket(0)], maxlen=_ring_steps)
_cur = _buckets[-1]

_tls = threading.local()        # per-thread span nesting stack


def enabled() -> bool:
    """Ring recording + crash hooks on? (``MXTPU_TELEMETRY``, default 1.)
    The metrics registry works regardless — framework counters are
    always-on."""
    return _enabled


def rank() -> int:
    """This process's worker rank (``MXTPU_WORKER_RANK``, default 0) —
    stamped on every record and every metrics sample."""
    global _rank
    r = _rank
    if r is None:
        try:
            r = int(os.environ.get("MXTPU_WORKER_RANK", "0"))
        except ValueError:
            r = 0
        _rank = r
    return r


def set_step(step: int) -> None:
    """Advance the flight recorder to step ``step``: subsequent records land
    in its bucket. The training loops call this once per step; the ring
    evicts whole steps, oldest first, so "last ``MXTPU_TELEMETRY_RING``
    steps" is exact regardless of how many spans a step produced."""
    global _step, _cur
    step = int(step)
    if step == _step:
        return
    with _lock:
        if step == _step:
            return
        _step = step
        bucket = _make_bucket(step)
        _buckets.append(bucket)
        _cur = bucket


def current_step() -> int:
    return _step


def _record(rec: Dict[str, Any]) -> None:
    """Append one record to the current step bucket. Lock-free on the hot
    path: list.append is atomic under the GIL, and a record racing a
    ``set_step`` swap lands in either the old or new bucket — both fine."""
    bucket = _cur
    if len(bucket["records"]) >= MAX_RECORDS_PER_STEP:
        bucket = _rotate_full(bucket)
    bucket["records"].append(rec)


def _rotate_full(full: Dict[str, Any]) -> Dict[str, Any]:
    """A bucket hit MAX_RECORDS_PER_STEP without ``set_step`` advancing:
    start a continuation bucket for the SAME step so new records keep
    landing (the ring evicts the oldest bucket) — dropping the newest
    records would invert the flight recorder. Rare path, so taking the
    ring lock here is fine; the racing-writer check keeps one rotation
    per overflow."""
    global _cur
    with _lock:
        if _cur is full:
            bucket = _make_bucket(full["step"])
            bucket["cont"] = True
            _buckets.append(bucket)
            _cur = bucket
        return _cur


# --------------------------------------------------------------------- spans
class _Span:
    """Scoped phase timer. ``with telemetry.span("forward_backward",
    retrace=False) as sp: ... sp.set(queue_depth=3)`` — on exit the
    completed span (wall+monotonic start, duration, rank, step, nesting
    parent/depth, attrs) is appended to the flight recorder and its
    duration observed into the ``mxtpu_phase_seconds`` histogram."""

    __slots__ = ("name", "attrs", "_t0", "_wall", "_parent", "_depth")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> "_Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        self._parent = stack[-1] if stack else None
        self._depth = len(stack)
        stack.append(self.name)
        self._wall = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        stack = getattr(_tls, "stack", None)
        if stack:
            stack.pop()
        rec = {"t": "span", "name": self.name, "ts": self._wall,
               "mono": self._t0, "dur_ms": dur * 1e3, "step": _step,
               "rank": rank(), "depth": self._depth}
        if self._parent is not None:
            rec["parent"] = self._parent
        if self.attrs:
            rec["attrs"] = self.attrs
        _record(rec)
        _phase_hist().observe(dur, phase=self.name)
        # mirror into the attached request trace (if any): serving threads
        # attach a request's trace context around single-request work so
        # existing span instrumentation lands in its waterfall for free
        tr = getattr(_tls, "trace", None)
        if tr is not None:
            tr.observe(self.name, dur, **self.attrs)
        return False


class _NullSpan:
    """No-op stand-in when telemetry is disabled."""

    __slots__ = ()
    name = None
    attrs: Dict[str, Any] = {}

    def set(self, **attrs):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def span(name: str, **attrs):
    """Context manager timing one step phase. Cheap when disabled (a
    shared no-op object); never syncs the device."""
    if not _enabled:
        return _NULL_SPAN
    return _Span(name, attrs)


def observe_span(name: str, dur_s: float, **attrs) -> None:
    """Record an already-measured phase duration (for call sites that time
    themselves, like the prefetcher's blocking wait)."""
    if not _enabled:
        return
    rec = {"t": "span", "name": name, "ts": time.time() - dur_s,
           "mono": time.perf_counter() - dur_s, "dur_ms": dur_s * 1e3,
           "step": _step, "rank": rank(), "depth": 0}
    if attrs:
        rec["attrs"] = attrs
    _record(rec)
    _phase_hist().observe(dur_s, phase=name)
    tr = getattr(_tls, "trace", None)
    if tr is not None:
        tr.observe(name, dur_s, **attrs)


# -------------------------------------------------------------------- events
def event(rtype: str, **fields) -> None:
    """Record a non-span event (guard trip, chaos injection, custom marker)
    into the flight recorder, stamped with wall+monotonic time, rank and
    step index. ``rtype`` becomes the record's ``t`` field."""
    if not _enabled:
        return
    rec = {"t": rtype, "ts": time.time(), "mono": time.perf_counter(),
           "step": _step, "rank": rank()}
    rec.update(fields)
    _record(rec)


def guard_event(step, kind: str, action: str, value, detail: str) -> None:
    """Mirror one ``guard.GuardEvent`` into the flight recorder (and count
    it in ``guard_trips_total``), so a post-mortem dump shows the full
    ladder (skip -> rescale -> rollback) inline with the step spans."""
    counter("guard_trips_total",
            "Guard sentinel trips by kind and ladder action.").inc(
                1, kind=kind, action=action)
    if not _enabled:
        return
    try:
        value = float(value)
    except (TypeError, ValueError):
        value = None
    event("guard", guard_step=step, kind=kind, action=action, value=value,
          detail=str(detail))


def chaos_event(point: str, fired: bool, seed: int, evals: int) -> None:
    """Record one armed chaos-point evaluation (point name, seed,
    fire/no-fire) so chaos-lane failures are attributable from the dump
    alone. Only armed points reach here — disarmed points stay one dict
    lookup."""
    counter("chaos_evals_total",
            "Armed chaos-point evaluations by point and outcome.").inc(
                1, point=point, fired=str(bool(fired)).lower())
    if not _enabled:
        return
    event("chaos", point=point, fired=bool(fired), seed=int(seed),
          evals=int(evals))


# ------------------------------------------------------------ request traces
#: spans held per trace before the tail is dropped (a runaway decode must
#: not grow a trace without bound; ``dropped_spans`` records the loss)
MAX_TRACE_SPANS = 2048
#: spans a failing trace mirrors into the flight-recorder ring
MAX_RING_SPANS = 64

#: statuses that bypass tail sampling entirely — an operator must always
#: find the trace for a request that went wrong
_BAD_STATUSES = ("error", "shed", "hung", "degraded", "aborted",
                 "rejected", "cancelled")

#: id generator for traces/spans. Seeded from the OS once at import;
#: ``getrandbits`` is a single C call that never drops the GIL, so minting
#: an id on the submit hot path cannot hand the scheduler thread a
#: context-switch window (``os.urandom`` per-call does, and measurably
#: widens submit/dispatch races under load).
_id_rng = random.Random(int.from_bytes(os.urandom(16), "big"))


def parse_traceparent(header: Optional[str]
                      ) -> Optional[Tuple[str, str]]:
    """Parse a W3C ``traceparent`` header (``00-<32hex>-<16hex>-<2hex>``)
    into ``(trace_id, parent_span_id)``. Returns None on anything
    malformed — a bad header must never fail a request."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) < 4:
        return None
    version, tid, sid, flags = parts[0], parts[1], parts[2], parts[3]
    if len(version) != 2 or len(tid) != 32 or len(sid) != 16 \
            or len(flags) != 2:
        return None
    if version.lower() == "ff":     # version 255 is forbidden by the spec
        return None
    if version == "00" and len(parts) != 4:
        return None                 # version 00 has exactly four fields
    try:
        int(version, 16), int(tid, 16), int(sid, 16), int(flags, 16)
    except ValueError:
        return None
    if tid == "0" * 32 or sid == "0" * 16:
        return None
    return tid.lower(), sid.lower()


class _TraceSpan:
    """Scoped timer recording into one :class:`Trace` — the per-request
    analog of :class:`_Span`. Nesting is tracked per thread *inside the
    trace*, so a scheduler thread and a token-loop thread can both write
    spans without corrupting each other's parent/child chains."""

    __slots__ = ("_tr", "name", "attrs", "_t0")

    def __init__(self, tr: "Trace", name: str, attrs: Dict[str, Any]):
        self._tr = tr
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> "_TraceSpan":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_TraceSpan":
        self._tr._push(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        parent, depth = self._tr._pop()
        self._tr._add(self.name, self._t0, dur, self.attrs, parent, depth)
        return False


class Trace:
    """One request's timed waterfall: a 128-bit ``trace_id``, a tree of
    completed spans with attrs, and a thread-portable context handle
    (:meth:`attach`). Always-on and independent of ``MXTPU_TELEMETRY`` —
    the ring mirror for failing traces is the only part the kill switch
    gates. Thread-safe: serving's scheduler, demux, token-loop and HTTP
    threads all write into the same trace."""

    __slots__ = ("trace_id", "parent_id", "name", "model", "attrs",
                 "status", "error", "t_wall", "t_mono", "total_s",
                 "attributed_s", "unattributed_s", "dropped_spans",
                 "post_finish_spans", "_spans", "_stacks", "_lk", "_done",
                 "_deferred", "_outcome", "_retired")

    def __init__(self, name: str, model: Optional[str] = None,
                 traceparent: Optional[str] = None, **attrs):
        parsed = parse_traceparent(traceparent)
        if parsed is not None:
            self.trace_id, self.parent_id = parsed
        else:
            self.trace_id = f"{_id_rng.getrandbits(128) or 1:032x}"
            self.parent_id = None
        self.name = name
        self.model = model
        self.attrs: Dict[str, Any] = dict(attrs)
        self.status: Optional[str] = None
        self.error: Optional[str] = None
        self.t_wall = time.time()
        self.t_mono = time.perf_counter()
        self.total_s: Optional[float] = None
        self.attributed_s: Optional[float] = None
        self.unattributed_s: Optional[float] = None
        self.dropped_spans = 0
        self.post_finish_spans = 0
        self._spans: List[Dict[str, Any]] = []
        self._stacks: Dict[int, List[str]] = {}
        self._lk = threading.Lock()
        self._done = False
        self._deferred = False          # creator owns retirement
        self._outcome: Optional[Tuple[str, Optional[BaseException]]] = None
        self._retired = False           # one-shot account/offer latch

    # -- span recording ---------------------------------------------------
    def _push(self, name: str) -> None:
        tid = threading.get_ident()
        with self._lk:
            self._stacks.setdefault(tid, []).append(name)

    def _pop(self) -> Tuple[Optional[str], int]:
        tid = threading.get_ident()
        with self._lk:
            stack = self._stacks.get(tid)
            if not stack:
                return None, 0
            stack.pop()
            return (stack[-1] if stack else None), len(stack)

    def _add(self, name: str, t0_mono: float, dur_s: float,
             attrs: Optional[Dict[str, Any]], parent: Optional[str],
             depth: int) -> None:
        rec = {"name": name, "t0": round(t0_mono - self.t_mono, 6),
               "dur_s": round(dur_s, 6), "depth": depth,
               "tid": threading.get_ident()}
        if parent is not None:
            rec["parent"] = parent
        if attrs:
            rec["attrs"] = dict(attrs)
        with self._lk:
            if self._done:
                # a closed trace is immutable: its attribution and the
                # store's retention decision are already made. Late spans
                # are counted, never appended.
                self.post_finish_spans += 1
                return
            if len(self._spans) >= MAX_TRACE_SPANS:
                self.dropped_spans += 1
                return
            self._spans.append(rec)

    def span(self, name: str, **attrs) -> _TraceSpan:
        """Context manager timing one phase of this request."""
        return _TraceSpan(self, name, attrs)

    def observe(self, name: str, dur_s: float, **attrs) -> None:
        """Record an already-measured phase ending now (call sites that
        time themselves: queue waits, per-token ITL samples, phases
        measured once for a whole batch and stamped per request)."""
        tid = threading.get_ident()
        with self._lk:
            stack = self._stacks.get(tid)
        parent = stack[-1] if stack else None
        depth = len(stack) if stack else 0
        self._add(name, time.perf_counter() - dur_s, dur_s, attrs,
                  parent, depth)

    def annotate(self, **attrs) -> "Trace":
        with self._lk:
            self.attrs.update(attrs)
        return self

    # -- context handle ---------------------------------------------------
    @contextlib.contextmanager
    def attach(self):
        """Bind this trace as the calling thread's current trace context:
        ``telemetry.span(...)`` / ``observe_span(...)`` inside the block
        mirror into this trace's waterfall. Restores the previous binding
        on exit (exception-safe), so a serving thread that handles many
        requests never leaks one request's context into the next."""
        prev = getattr(_tls, "trace", None)
        _tls.trace = self
        try:
            yield self
        finally:
            _tls.trace = prev

    # -- retire -----------------------------------------------------------
    def defer(self) -> "Trace":
        """Hand retirement to this trace's creator (the HTTP handler):
        the engine's :meth:`finish` then only records its outcome and
        leaves the waterfall open, so post-result spans (``respond``,
        ``stream_write``) land inside the measured window and count
        toward attribution. The creator must call :meth:`retire` once
        the response is fully written."""
        with self._lk:
            if not self._done:
                self._deferred = True
        return self

    def retire(self, status: str = "ok",
               error: Optional[BaseException] = None) -> "Trace":
        """Close a creator-owned trace (see :meth:`defer`): applies the
        engine-recorded outcome when one landed (the engine knows the
        real disposition — shed, error, ok), else the caller's. A plain
        :meth:`finish` on a non-deferred trace; idempotent."""
        with self._lk:
            self._deferred = False
            if self._outcome is not None:
                status, error = self._outcome
                # a retained trace outlives its request: keep no exception,
                # whose traceback would hold the raising frames (and the
                # engine and models they reference)
                self._outcome = (status, None)
        return self.finish(status=status, error=error)

    def _claim_retirement(self) -> bool:
        """One-shot latch: True for exactly the first caller — the
        retire path that gets to account metrics and offer the trace to
        the store (engine and handler can race on cancel paths)."""
        with self._lk:
            if self._retired or not self._done:
                return False
            self._retired = True
            return True

    def finish(self, status: str = "ok",
               error: Optional[BaseException] = None) -> "Trace":
        """Close the trace: stamp the end-to-end duration and the
        attribution closure (total minus the sum of top-level phases =
        unattributed time). Idempotent — the first call wins. On a
        deferred trace (:meth:`defer`) the outcome is recorded but the
        waterfall stays open until :meth:`retire`. A trace ending in a
        failing status mirrors its waterfall into the flight-recorder
        ring so a crash dump carries the victim requests."""
        with self._lk:
            if self._done:
                return self
            if self._deferred:
                if self._outcome is None:
                    self._outcome = (status, error)
                return self
            self._done = True
            self.status = status
            if error is not None:
                self.error = f"{type(error).__name__}: {error}"
            self.total_s = round(time.perf_counter() - self.t_mono, 6)
            attributed = sum(s["dur_s"] for s in self._spans
                             if s["depth"] == 0)
            self.attributed_s = round(min(attributed, self.total_s), 6)
            self.unattributed_s = round(
                max(0.0, self.total_s - attributed), 6)
            spans = list(self._spans)
            self._stacks.clear()
        if status in _BAD_STATUSES and _enabled:
            event("trace_retired", trace_id=self.trace_id, name=self.name,
                  model=self.model, status=status, error=self.error,
                  total_s=self.total_s, n_spans=len(spans))
            for s in spans[:MAX_RING_SPANS]:
                event("trace_span", trace_id=self.trace_id,
                      name=s["name"], t0=s["t0"], dur_s=s["dur_s"],
                      **s.get("attrs", {}))
        return self

    @property
    def finished(self) -> bool:
        return self._done

    # -- exports ----------------------------------------------------------
    def traceparent(self) -> str:
        """This trace as an outgoing W3C ``traceparent`` value."""
        return f"00-{self.trace_id}-{_id_rng.getrandbits(64) or 1:016x}-01"

    def phase_totals(self) -> Dict[str, float]:
        """Summed seconds per top-level phase name — the operator-facing
        breakdown (``Endpoint.stats()`` slowest-request pointer)."""
        out: Dict[str, float] = {}
        with self._lk:
            spans = list(self._spans)
        for s in spans:
            if s["depth"] == 0:
                out[s["name"]] = round(
                    out.get(s["name"], 0.0) + s["dur_s"], 6)
        return out

    def to_dict(self) -> Dict[str, Any]:
        with self._lk:
            spans = sorted(self._spans, key=lambda s: s["t0"])
            return {"trace_id": self.trace_id, "parent_id": self.parent_id,
                    "name": self.name, "model": self.model,
                    "status": self.status, "error": self.error,
                    "ts": self.t_wall, "total_s": self.total_s,
                    "attributed_s": self.attributed_s,
                    "unattributed_s": self.unattributed_s,
                    "attrs": dict(self.attrs),
                    "dropped_spans": self.dropped_spans,
                    "post_finish_spans": self.post_finish_spans,
                    "spans": spans}

    def to_chrome(self) -> Dict[str, Any]:
        """This trace as a chrome-trace document (chrome://tracing /
        Perfetto): one complete event per span, threads preserved."""
        events = []
        d = self.to_dict()
        for s in d["spans"]:
            events.append({
                "name": s["name"], "ph": "X", "cat": "request",
                "ts": (d["ts"] + s["t0"]) * 1e6, "dur": s["dur_s"] * 1e6,
                "pid": os.getpid(), "tid": s.get("tid", 0),
                "args": {**s.get("attrs", {}),
                         "depth": s["depth"],
                         **({"parent": s["parent"]} if "parent" in s
                            else {})}})
        return {"traceEvents": events,
                "metadata": {"trace_id": d["trace_id"],
                             "model": d["model"], "status": d["status"],
                             "total_s": d["total_s"]}}


def current_trace() -> Optional[Trace]:
    """The trace attached to the calling thread, or None."""
    return getattr(_tls, "trace", None)


class TraceStore:
    """Bounded tail-sampled retention for finished traces (Dapper-style
    tail-based sampling, decided at retire when the outcome is known):

    * every error/shed/deadline/degraded trace is kept — never sampled out
    * the slowest ``slow_n`` ok-traces per model are kept (p99 debugging)
    * 1 in ``sample_k`` of the rest survives as a baseline (deterministic
      counter, not random — CI gates need reproducible retention)
    * everything else is dropped at retire; capacity eviction prefers ok
      traces oldest-first so a burst of successes cannot evict the stored
      failures

    ``MXTPU_TRACE_STORE`` (capacity, default 1024; 0 disables retention —
    traces still run and carry ids, nothing is stored),
    ``MXTPU_TRACE_SLOW_N`` (default 5), ``MXTPU_TRACE_SAMPLE``
    (default 100)."""

    def __init__(self, cap: Optional[int] = None,
                 slow_n: Optional[int] = None,
                 sample_k: Optional[int] = None):
        self.cap = (_env_int("MXTPU_TRACE_STORE", 1024)
                    if cap is None else int(cap))
        self.slow_n = (_env_int("MXTPU_TRACE_SLOW_N", 5)
                       if slow_n is None else int(slow_n))
        self.sample_k = (_env_int("MXTPU_TRACE_SAMPLE", 100)
                         if sample_k is None else int(sample_k))
        self._lk = threading.Lock()
        self._traces: "Dict[str, Trace]" = {}      # insertion-ordered
        self._slow: Dict[str, List[Tuple[float, str]]] = {}
        self._offered = 0
        self._kept = 0

    def __len__(self) -> int:
        with self._lk:
            return len(self._traces)

    def offer(self, tr: Optional[Trace]) -> bool:
        """Retention decision for a finished trace. Returns True iff the
        trace was kept. Never raises — this sits on every retire path."""
        if tr is None or self.cap <= 0:
            return False
        try:
            dur = tr.total_s if tr.total_s is not None else 0.0
            model = tr.model or ""
            with self._lk:
                self._offered += 1
                keep = tr.status in _BAD_STATUSES
                if not keep:
                    slow = self._slow.setdefault(model, [])
                    if len(slow) < self.slow_n:
                        slow.append((dur, tr.trace_id))
                        slow.sort()
                        keep = True
                    elif slow and dur > slow[0][0]:
                        # displaced trace leaves the store with its slow
                        # slot — no stale ids lingering until capacity
                        self._traces.pop(slow[0][1], None)
                        slow[0] = (dur, tr.trace_id)
                        slow.sort()
                        keep = True
                if not keep and self.sample_k > 0 \
                        and self._offered % self.sample_k == 0:
                    keep = True
                if not keep:
                    return False
                self._traces.pop(tr.trace_id, None)
                self._traces[tr.trace_id] = tr
                self._kept += 1
                while len(self._traces) > self.cap:
                    victim = None
                    for tid, t in self._traces.items():
                        if t.status not in _BAD_STATUSES:
                            victim = tid
                            break
                    if victim is None:      # all bad: evict oldest anyway
                        victim = next(iter(self._traces))
                    vt = self._traces.pop(victim, None)
                    if vt is not None:
                        # keep _slow consistent with _traces: an evicted
                        # trace must not leave a dangling slowest pointer
                        vslow = self._slow.get(vt.model or "")
                        if vslow:
                            vslow[:] = [e for e in vslow if e[1] != victim]
                return True
        except Exception:
            return False

    def get(self, trace_id: str) -> Optional[Trace]:
        with self._lk:
            return self._traces.get(trace_id)

    def slowest(self, model: str) -> Optional[Dict[str, Any]]:
        """Slowest retained ok-trace for ``model``: ``{trace_id, total_s,
        phases}`` — the operator's "start here" pointer."""
        with self._lk:
            slow = list(self._slow.get(model or "", ()))
            tr = dur = None
            for d, tid in reversed(slow):   # fastest-last: scan down
                t = self._traces.get(tid)
                if t is not None:
                    tr, dur = t, d
                    break
        if tr is None:
            return None
        return {"trace_id": tr.trace_id, "total_s": dur,
                "phases": tr.phase_totals()}

    def summaries(self, model: Optional[str] = None,
                  limit: int = 256) -> List[Dict[str, Any]]:
        """Newest-first one-line summaries for ``GET /v1/traces``."""
        with self._lk:
            traces = list(self._traces.values())
        out = []
        for tr in reversed(traces):
            if model and tr.model != model:
                continue
            out.append({"trace_id": tr.trace_id, "name": tr.name,
                        "model": tr.model, "status": tr.status,
                        "total_s": tr.total_s,
                        "unattributed_s": tr.unattributed_s,
                        "ts": tr.t_wall})
            if len(out) >= limit:
                break
        return out

    def stats(self) -> Dict[str, Any]:
        with self._lk:
            return {"stored": len(self._traces), "cap": self.cap,
                    "offered": self._offered, "kept": self._kept,
                    "slow_n": self.slow_n, "sample_k": self.sample_k}

    def clear(self) -> None:
        with self._lk:
            self._traces.clear()
            self._slow.clear()
            self._offered = 0
            self._kept = 0


_trace_store: Optional[TraceStore] = None


def trace_store() -> TraceStore:
    """The process-wide trace store (created lazily from the
    ``MXTPU_TRACE_*`` env family; ``reset()`` rebuilds it)."""
    global _trace_store
    ts = _trace_store
    if ts is None:
        with _lock:
            if _trace_store is None:
                _trace_store = TraceStore()
            ts = _trace_store
    return ts


# ------------------------------------------------------------ ring accessors
def records() -> List[Dict[str, Any]]:
    """Flat snapshot of every record currently in the ring, oldest step
    first."""
    with _lock:
        buckets = list(_buckets)
    out: List[Dict[str, Any]] = []
    for b in buckets:
        out.extend(b["records"])
    return out


def ring_steps() -> List[int]:
    """Step indices currently held by the ring, oldest first."""
    with _lock:
        return [b["step"] for b in _buckets]


def phase_breakdown() -> Dict[str, Dict[str, float]]:
    """Per-phase aggregate over the spans in the ring:
    ``{phase: {count, total_ms, max_ms}}`` — the BENCH json's
    phase-attribution block."""
    out: Dict[str, Dict[str, float]] = {}
    for rec in records():
        if rec.get("t") != "span":
            continue
        s = out.setdefault(rec["name"],
                           {"count": 0, "total_ms": 0.0, "max_ms": 0.0})
        d = rec.get("dur_ms", 0.0)
        s["count"] += 1
        s["total_ms"] += d
        s["max_ms"] = max(s["max_ms"], d)
    for s in out.values():
        s["total_ms"] = round(s["total_ms"], 3)
        s["max_ms"] = round(s["max_ms"], 3)
    return out


def phase_share(phase: str) -> float:
    """Fraction of ring wall-clock spent inside spans named ``phase``:
    total span time over the window from the first span start to the
    last span end. The input-starvation gate (``prefetch_wait`` share,
    io-smoke + perf-smoke) reads this; 0.0 when the ring holds no spans
    of any name."""
    spans = [r for r in records() if r.get("t") == "span"]
    if not spans:
        return 0.0
    t0 = min(r["mono"] for r in spans)
    t1 = max(r["mono"] + r.get("dur_ms", 0.0) / 1e3 for r in spans)
    wall = t1 - t0
    if wall <= 0:
        return 0.0
    mine = sum(r.get("dur_ms", 0.0) / 1e3 for r in spans
               if r["name"] == phase)
    return min(1.0, mine / wall)


# ------------------------------------------------------------------ the dump
_dump_lock = threading.Lock()
_last_dump: Optional[str] = None


def dump_path() -> str:
    """Where the flight recorder dumps: ``MXTPU_TELEMETRY_DUMP`` if set,
    else ``<tmpdir>/mxtpu-flight-<pid>.jsonl``."""
    p = os.environ.get("MXTPU_TELEMETRY_DUMP")
    if p:
        return p
    return os.path.join(tempfile.gettempdir(),
                        f"mxtpu-flight-{os.getpid()}.jsonl")


def dump(path: Optional[str] = None, reason: str = "explicit"
         ) -> Optional[str]:
    """Write the flight recorder as JSON-lines: one meta line (reason, pid,
    rank, current step, ring occupancy, full metrics snapshot) then one
    line per span/event, oldest step first. Overwrites the previous dump
    (the meta line records why). Returns the path, or None when telemetry
    is disabled. Never raises — this runs on crash paths."""
    global _last_dump
    if not _enabled:
        return None
    path = path or dump_path()
    try:
        recs = records()
        meta = {"t": "meta", "reason": reason, "ts": time.time(),
                "pid": os.getpid(), "rank": rank(), "step": _step,
                "n_records": len(recs), "ring_steps": _ring_steps,
                "metrics": snapshot()["metrics"]}
        with _dump_lock:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(path, "w") as f:
                f.write(json.dumps(meta) + "\n")
                for rec in recs:
                    f.write(json.dumps(rec, default=str) + "\n")
        _last_dump = path
        return path
    except Exception:
        return None


def last_dump() -> Optional[str]:
    return _last_dump


# ---------------------------------------------------------- metrics registry
_mlock = threading.Lock()
_metrics: Dict[str, "_Metric"] = {}

#: histogram bucket upper bounds (seconds) tuned for step phases: 100us..30s
DEFAULT_BUCKETS = (1e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
                   1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0, 30.0)


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Metric:
    """Base: name, HELP text, and a labels -> value map guarded by the
    registry lock (increments are cheap; the lock is uncontended in
    practice and never held across user code)."""

    mtype = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def samples(self) -> List[Tuple[Dict[str, str], float]]:
        with _mlock:
            return [(dict(k), v) for k, v in self._values.items()]

    def value(self, **labels) -> float:
        with _mlock:
            return self._values.get(_label_key(labels), 0.0)


class Counter(_Metric):
    """Monotonic counter. ``inc(v, **labels)``."""

    mtype = "counter"

    def inc(self, v: float = 1.0, **labels) -> float:
        if v < 0:
            raise ValueError("Counter can only increase")
        key = _label_key(labels)
        with _mlock:
            nv = self._values.get(key, 0.0) + v
            self._values[key] = nv
        return nv


class Gauge(_Metric):
    """Set/inc/dec gauge — the type behind ``profiler.get_counter`` (the
    legacy counters are set and decremented freely)."""

    mtype = "gauge"

    def set(self, v: float, **labels) -> float:
        with _mlock:
            self._values[_label_key(labels)] = float(v)
        return v

    def inc(self, v: float = 1.0, **labels) -> float:
        key = _label_key(labels)
        with _mlock:
            nv = self._values.get(key, 0.0) + v
            self._values[key] = nv
        return nv

    def dec(self, v: float = 1.0, **labels) -> float:
        return self.inc(-v, **labels)


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics): ``observe(v)``
    updates per-label bucket counts, sum and count. ``observe(v,
    exemplar={"trace_id": ...})`` additionally pins an OpenMetrics
    exemplar to the bucket the observation landed in — the link from a
    p99 bucket back to a stored request trace."""

    mtype = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        # labels -> [bucket counts..., +Inf count, sum, count]
        self._hv: Dict[Tuple[Tuple[str, str], ...], List[float]] = {}
        # labels -> {bucket index (str) -> [exemplar labels, value, ts]}
        self._ex: Dict[Tuple[Tuple[str, str], ...],
                       Dict[str, List[Any]]] = {}

    def observe(self, v: float, exemplar: Optional[Dict[str, str]] = None,
                **labels) -> None:
        key = _label_key(labels)
        with _mlock:
            h = self._hv.get(key)
            if h is None:
                h = self._hv[key] = [0.0] * (len(self.buckets) + 3)
            lo = len(self.buckets)          # index of the landing bucket
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    h[i] += 1
                    lo = min(lo, i)
            h[-3] += 1          # +Inf
            h[-2] += v          # sum
            h[-1] += 1          # count
            if exemplar:
                self._ex.setdefault(key, {})[str(lo)] = [
                    dict(exemplar), float(v), time.time()]

    def samples(self) -> List[Tuple[Dict[str, str], Dict[str, Any]]]:
        with _mlock:
            out = []
            for k, h in self._hv.items():
                val: Dict[str, Any] = {
                    "buckets": list(self.buckets),
                    "counts": list(h[:-2]), "sum": h[-2], "count": h[-1]}
                ex = self._ex.get(k)
                if ex:
                    val["exemplars"] = {i: list(e) for i, e in ex.items()}
                out.append((dict(k), val))
            return out

    def value(self, **labels) -> float:
        """Observation count for the label set (parity with _Metric)."""
        with _mlock:
            h = self._hv.get(_label_key(labels))
            return h[-1] if h else 0.0


def _register(cls, name: str, help: str, **kw):
    with _mlock:
        m = _metrics.get(name)
    if m is None:
        # construct outside the lock; setdefault resolves creation races
        candidate = cls(name, help, **kw)
        with _mlock:
            m = _metrics.setdefault(name, candidate)
    if not isinstance(m, cls):
        raise TypeError(f"metric {name!r} already registered as "
                        f"{m.mtype}, not {cls.mtype}")
    if help and not m.help:
        m.help = help
    return m


def counter(name: str, help: str = "") -> Counter:
    """Get-or-create the named Counter (one instance per name)."""
    return _register(Counter, name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return _register(Gauge, name, help)


def histogram(name: str, help: str = "",
              buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
    return _register(Histogram, name, help, buckets=buckets)


def _phase_hist() -> Histogram:
    return histogram("mxtpu_phase_seconds",
                     "Step-phase durations from the telemetry span tracer.")


# ------------------------------------------------------------------- exports
def _sanitize(name: str) -> str:
    out = []
    for i, ch in enumerate(name):
        if ch.isalnum() or ch in "_:":
            out.append(ch)
        else:
            out.append("_")
    s = "".join(out)
    if s and s[0].isdigit():
        s = "_" + s
    return s


def _fmt_value(v: float) -> str:
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    esc = {k: str(v).replace("\\", r"\\").replace('"', r"\"")
           .replace("\n", r"\n") for k, v in labels.items()}
    inner = ",".join(f'{_sanitize(k)}="{esc[k]}"'
                     for k in sorted(esc))
    return "{" + inner + "}"


def render_prometheus(snapshots: Optional[List[Dict[str, Any]]] = None,
                      openmetrics: bool = False) -> str:
    """Prometheus text exposition of the registry — or of explicit
    ``snapshot()`` dicts (the multi-rank aggregation path). Every sample
    carries a ``rank`` label; HELP/TYPE lines precede each metric family.

    Default output is classic text format 0.0.4, which has NO exemplar
    syntax — a trailing ``# {...}`` makes that parser reject the whole
    scrape. Histogram exemplars (the p99-to-trace link) are emitted only
    with ``openmetrics=True`` (client sent ``Accept:
    application/openmetrics-text``), which also appends the mandatory
    ``# EOF`` terminator."""
    snaps = snapshots if snapshots is not None else [snapshot()]
    # merge families across snapshots, preserving per-snapshot rank labels
    fams: Dict[str, Dict[str, Any]] = {}
    for snap in snaps:
        r = str(snap.get("rank", 0))
        for name, fam in snap["metrics"].items():
            dst = fams.setdefault(name, {"type": fam["type"],
                                         "help": fam.get("help", ""),
                                         "samples": []})
            for labels, val in fam["samples"]:
                labels = dict(labels)
                labels.setdefault("rank", r)
                dst["samples"].append((labels, val))
    lines: List[str] = []
    for name in sorted(fams):
        fam = fams[name]
        pname = _sanitize(name)
        if fam["help"]:
            lines.append(f"# HELP {pname} {fam['help']}")
        lines.append(f"# TYPE {pname} {fam['type']}")
        for labels, val in fam["samples"]:
            if fam["type"] == "histogram":
                buckets, counts = val["buckets"], val["counts"]
                exemplars = val.get("exemplars") or {}
                for i, (ub, c) in enumerate(
                        zip(list(buckets) + [float("inf")], counts)):
                    bl = dict(labels)
                    bl["le"] = _fmt_value(float(ub))
                    line = f"{pname}_bucket{_fmt_labels(bl)} {_fmt_value(c)}"
                    ex = exemplars.get(str(i)) if openmetrics else None
                    if ex:
                        # OpenMetrics exemplar: the p99-to-trace link
                        exl, exv, exts = ex
                        line += (f" # {_fmt_labels(exl)} "
                                 f"{_fmt_value(float(exv))} {exts:.3f}")
                    lines.append(line)
                lines.append(f"{pname}_sum{_fmt_labels(labels)} "
                             f"{_fmt_value(val['sum'])}")
                lines.append(f"{pname}_count{_fmt_labels(labels)} "
                             f"{_fmt_value(val['count'])}")
            else:
                lines.append(
                    f"{pname}{_fmt_labels(labels)} {_fmt_value(val)}")
    if openmetrics:
        lines.append("# EOF")
    return "\n".join(lines) + ("\n" if lines else "")


#: content types for the two metrics expositions a scraper can negotiate
PROM_CTYPE = "text/plain; version=0.0.4; charset=utf-8"
OPENMETRICS_CTYPE = ("application/openmetrics-text; version=1.0.0; "
                     "charset=utf-8")


def negotiate_metrics(accept: Optional[str]) -> Tuple[str, str]:
    """``(body, content_type)`` for one ``/metrics`` scrape given the
    request's ``Accept`` header: OpenMetrics (exemplars + ``# EOF``) when
    the client negotiates it, classic exemplar-free 0.0.4 otherwise —
    the one switch every HTTP metrics endpoint routes through."""
    om = "application/openmetrics-text" in (accept or "")
    return (render_prometheus(openmetrics=om),
            OPENMETRICS_CTYPE if om else PROM_CTYPE)


def render_jsonl() -> str:
    """Metrics registry as JSON-lines: one line per metric family."""
    snap = snapshot()
    lines = [json.dumps({"name": name, "rank": snap["rank"], **fam})
             for name, fam in sorted(snap["metrics"].items())]
    return "\n".join(lines) + ("\n" if lines else "")


def render_chrome_trace() -> str:
    """Flight-recorder spans as a chrome-trace JSON document (open in
    chrome://tracing / Perfetto). Complements the profiler's own dump:
    this one always exists, bounded to the ring."""
    events = []
    pid = os.getpid()
    for rec in records():
        if rec.get("t") == "span":
            events.append({"name": rec["name"], "ph": "X", "cat": "phase",
                           "ts": rec["ts"] * 1e6,
                           "dur": rec.get("dur_ms", 0.0) * 1e3,
                           "pid": pid, "tid": rec.get("rank", 0),
                           "args": {"step": rec.get("step"),
                                    **rec.get("attrs", {})}})
        else:
            events.append({"name": f"{rec['t']}", "ph": "i", "cat": rec["t"],
                           "ts": rec.get("ts", 0.0) * 1e6, "pid": pid,
                           "tid": rec.get("rank", 0), "s": "g",
                           "args": {k: v for k, v in rec.items()
                                    if k not in ("t", "ts", "mono")}})
    return json.dumps({"traceEvents": events}, indent=2)


# ------------------------------------------------------ multi-rank snapshots
def snapshot() -> Dict[str, Any]:
    """Serializable registry state: ``{"rank": r, "ts": ..., "metrics":
    {name: {type, help, samples: [[labels, value], ...]}}}``. Histogram
    values are ``{buckets, counts, sum, count}`` dicts. The unit every
    aggregation path (launch.py file merge, kvstore allgather) exchanges."""
    with _mlock:
        names = list(_metrics)
    metrics = {}
    for name in names:
        m = _metrics.get(name)
        if m is None:
            continue
        metrics[name] = {"type": m.mtype, "help": m.help,
                         "samples": [[labels, val]
                                     for labels, val in m.samples()]}
    return {"rank": rank(), "ts": time.time(), "metrics": metrics}


def merge_snapshots(snaps: List[Dict[str, Any]], sum_ranks: bool = True
                    ) -> List[Dict[str, Any]]:
    """Prepare per-rank snapshots for one exposition: returns the input
    snapshots plus (with ``sum_ranks``) a synthetic ``rank="all"``
    snapshot where counters and histograms with identical non-rank labels
    are summed across ranks (gauges stay per-rank only: summing queue
    depths or loss scales across ranks is meaningless). Feed the result to
    ``render_prometheus(snapshots=...)``."""
    if not sum_ranks:
        return list(snaps)
    agg: Dict[str, Dict[str, Any]] = {}
    for snap in snaps:
        for name, fam in snap["metrics"].items():
            if fam["type"] not in ("counter", "histogram"):
                continue
            dst = agg.setdefault(name, {"type": fam["type"],
                                        "help": fam.get("help", ""),
                                        "samples": {}})
            for labels, val in fam["samples"]:
                key = _label_key({k: v for k, v in dict(labels).items()
                                  if k != "rank"})
                cur = dst["samples"].get(key)
                if fam["type"] == "counter":
                    dst["samples"][key] = (cur or 0.0) + val
                else:
                    if cur is None:
                        dst["samples"][key] = {
                            "buckets": list(val["buckets"]),
                            "counts": list(val["counts"]),
                            "sum": val["sum"], "count": val["count"]}
                    elif cur["buckets"] == list(val["buckets"]):
                        cur["counts"] = [a + b for a, b in
                                         zip(cur["counts"], val["counts"])]
                        cur["sum"] += val["sum"]
                        cur["count"] += val["count"]
    merged = {"rank": "all", "ts": time.time(),
              "metrics": {name: {"type": fam["type"], "help": fam["help"],
                                 "samples": [[dict(k), v] for k, v in
                                             fam["samples"].items()]}
                          for name, fam in agg.items()}}
    return list(snaps) + [merged]


def load_snapshot_files(paths: Iterable[str]) -> List[Dict[str, Any]]:
    """Read ``snapshot()`` JSON files (one per rank — written at exit when
    ``MXTPU_TELEMETRY_METRICS`` is set; ``tools/launch.py`` points each
    rank at its own file). Unreadable files are skipped."""
    out = []
    for p in paths:
        try:
            with open(p) as f:
                out.append(json.load(f))
        except (OSError, ValueError):
            pass
    return out


# -------------------------------------------------------- HTTP /metrics
_http_server = None
_http_thread = None


def serve(port: Optional[int] = None) -> int:
    """Start the background metrics endpoint on 127.0.0.1: ``/metrics``
    serves the Prometheus exposition, ``/flight`` the flight-recorder
    JSON-lines, ``/trace`` the chrome-trace export. Returns the bound port
    (``port=0`` picks an ephemeral one). Idempotent."""
    global _http_server, _http_thread
    if _http_server is not None:
        return _http_server.server_port
    if port is None:
        port = _env_int("MXTPU_TELEMETRY_PORT", 0)
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.startswith("/metrics"):
                text, ctype = negotiate_metrics(
                    self.headers.get("Accept"))
                body = text.encode()
            elif self.path.startswith("/flight"):
                body = "\n".join(json.dumps(r, default=str)
                                 for r in records()).encode()
                ctype = "application/json"
            elif self.path.startswith("/traces"):
                # request-trace store (checked before the /trace prefix);
                # ?id= one waterfall, else newest-first summaries
                from urllib.parse import parse_qs, urlparse
                q = parse_qs(urlparse(self.path).query)
                store = trace_store()
                tid = (q.get("id") or [None])[0]
                if tid is None:
                    out = store.stats()
                    out["traces"] = store.summaries(
                        model=(q.get("model") or [None])[0])
                else:
                    tr = store.get(tid)
                    out = (tr.to_dict() if tr is not None
                           else {"error": f"no retained trace {tid!r}"})
                body = json.dumps(out).encode()
                ctype = "application/json"
            elif self.path.startswith("/trace"):
                body = render_chrome_trace().encode()
                ctype = "application/json"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):   # quiet: no per-scrape stderr noise
            pass

    _http_server = ThreadingHTTPServer(("127.0.0.1", int(port)), Handler)
    _http_thread = threading.Thread(target=_http_server.serve_forever,
                                    name="mxtpu-telemetry-http", daemon=True)
    _http_thread.start()
    return _http_server.server_port


def stop_serving() -> None:
    global _http_server, _http_thread
    srv, _http_server = _http_server, None
    thread, _http_thread = _http_thread, None
    if srv is not None:
        srv.shutdown()
        srv.server_close()
    if thread is not None:
        thread.join(timeout=2.0)


# ----------------------------------------------------------- crash plumbing
_hooks_installed = False
_crashed = False
_prev_excepthook: Optional[Callable] = None


def _crash_hook(exc_type, exc, tb):
    global _crashed
    _crashed = True
    try:
        event("crash", exc=f"{exc_type.__name__}: {exc}")
    except Exception:
        pass
    dump(reason=f"crash:{exc_type.__name__}")
    if _prev_excepthook is not None:
        _prev_excepthook(exc_type, exc, tb)


def _sigusr1(signum, frame):
    dump(reason="SIGUSR1")


def _atexit():
    # metrics snapshot for the launcher's multi-rank aggregation path
    mpath = os.environ.get("MXTPU_TELEMETRY_METRICS")
    if mpath:
        try:
            d = os.path.dirname(mpath)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(mpath, "w") as f:
                json.dump(snapshot(), f)
        except Exception:
            pass
    # backstop: a crash that never reached sys.excepthook (e.g. an embedded
    # interpreter swallowing it) still gets its flight record on disk
    if _crashed and _last_dump is None:
        dump(reason="crash:atexit")


def install_hooks() -> None:
    """Install the crash/signal plumbing once: ``sys.excepthook`` chain
    (unhandled crash -> dump), ``SIGUSR1`` -> dump, atexit metrics
    snapshot. Called at import when telemetry is enabled; safe to call
    again."""
    global _hooks_installed, _prev_excepthook
    if _hooks_installed or not _enabled:
        return
    _hooks_installed = True
    _prev_excepthook = sys.excepthook
    sys.excepthook = _crash_hook
    atexit.register(_atexit)
    if hasattr(signal, "SIGUSR1"):
        try:
            signal.signal(signal.SIGUSR1, _sigusr1)
        except (ValueError, OSError):
            pass        # not the main thread / unsupported platform


# ---------------------------------------------------------------- test reset
def reset(metrics: bool = True) -> None:
    """Re-read the env config and clear the ring (and, by default, the
    metrics registry). Test/bench hook — production code never calls it."""
    global _enabled, _ring_steps, _step, _rank, _buckets, _cur, _trace_store
    with _lock:
        _enabled = _env_flag("MXTPU_TELEMETRY", True)
        _ring_steps = max(1, _env_int("MXTPU_TELEMETRY_RING", 512))
        _step = 0
        _rank = None
        _buckets = deque([_make_bucket(0)], maxlen=_ring_steps)
        _cur = _buckets[-1]
        _trace_store = None     # next trace_store() re-reads MXTPU_TRACE_*
    if metrics:
        with _mlock:
            _metrics.clear()


# import-time side effects: crash hooks (enabled by default) and the
# optional scrape endpoint — both no-ops unless their env gates say go.
# MXTPU_TELEMETRY_HOOKS=0 suppresses both: tools/launch.py sets it while
# exec'ing this file standalone to merge rank snapshots, so the LAUNCHER
# never steals excepthook/atexit or clobbers a rank's metrics file.
if _env_flag("MXTPU_TELEMETRY_HOOKS", True):
    install_hooks()
    _port = _env_int("MXTPU_TELEMETRY_PORT", 0)
    if _port:
        # launch.py forwards MXTPU_TELEMETRY_PORT to every rank: offset by
        # rank so co-hosted ranks each get a scrapeable endpoint, and a
        # conflict (another job on the port) must never abort the import
        try:
            serve(_port + rank())
        except OSError as e:
            print(f"mxtpu telemetry: scrape endpoint on port "
                  f"{_port + rank()} unavailable ({e}); metrics registry "
                  f"still live", file=sys.stderr)
