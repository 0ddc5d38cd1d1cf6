"""Serving runtime in PyTorch: a continuous-batching inference engine over
captured forward steps, and iteration-level generative LM serving over a
KV cache, on one device.

Counterpart of ``incubator_mxnet_tpu/serving.py``, with the same public
surface, environment variables, validation messages, chaos points,
telemetry series and per-request tracing. One ``InferenceEngine`` serves
both kinds of endpoint::

    client -> Endpoint.submit(item) -> per-model bounded queue (typed
           fast reject when full; deadlines, tenant quotas, priorities)
           scheduler thread: smooth weighted round-robin over the models
             with a flush-ready queue; packs one model's waiting requests
             into the smallest padding bucket (fill threshold or
             max_wait_ms), pads, dispatches the bucket's forward
                 |  bounded in-flight queue (MXTPU_SERVE_INFLIGHT)
           demux thread: waits for the batch's outputs on the host (under
             the hung-request watchdog, guard.py), slices each row back to
             its request, resolves the ResponseFuture

    client -> GenerativeEndpoint.submit(prompt) -> bounded prompt queue
           token-loop thread (one per generate model), every turn: admit
             waiting prompts into free KV slots (and, paged, pages), run
             one prefill chunk per filling slot, run ONE fixed-shape
             decode step over every decode-ready slot, stream each emitted
             token to its GenerationFuture, retire finished slots.

``load_model(name, net=...)`` serves any ``HybridBlock``: one discovery
forward resolves deferred initialisation, the parameters are copied as
static buffers onto the engine's device, and each padding bucket, largest
first, becomes one CUDA graph (``cuda_graph.CapturedStep``) of the block's
inference forward over a static ``(bucket, *item_shape)`` input, all the
buckets' graphs drawing on one memory pool (``_AOTBlockModel``). Each
capture counts one in ``mxtpu_serve_compiles_total``, at load and at a
ladder ``rebuild()``, never from traffic. ``fn=`` serves any ``np batch ->
np outputs`` callable. ``load_model(name, generate={...})`` builds a
``_GenerativeModel`` over ``models.transformer`` (paged by default): its
``len(buckets) + 1`` steps (a prefill a prompt bucket, one decode step) are
CUDA graphs too, on static input buffers, replayed by the token loop.

Resilience as in the reference: a versioned hot swap (``load_model`` on a
loaded name: stage, canary, atomic flip, v1's in-flight batches drain
through v1's graphs, then ``release()``), deadline-aware shedding and
tenant quotas, and the self-healing ladder (retry -> rebuild ->
degraded -> probe -> restore). Chaos points ``serve.slow_model``,
``serve.queue_full``, ``serve.client_abort``, ``serve.dispatch_fail`` and
``serve.swap_fail``.

Differences from the JAX engine:

* the reference's AOT executable a bucket is a CUDA graph a bucket; on the
  CPU there is no graph: the same bodies run eagerly on the same static
  buffers at every call, and ``mxtpu_serve_compiles_total`` (and, for
  generate models, ``mxtpu_serve_gen_traces_total``) stays at 0;
* a bucket graph's outputs are static and ``inflight`` batches can be in
  flight at once, so each dispatch copies its outputs out on the model's
  serving stream into a pinned host slot of its own (one a batch in
  flight), with an event that the demux thread waits on; the padded
  input is packed into that slot's pinned staging rows, which are not
  refilled before the slot's event has passed;
* ``donate`` is accepted and moot: inputs land in static buffers;
* a served net's random draws come from its bucket entry's generator,
  seeded at each dispatch from the model's call counter (the reference
  folds that counter into ``PRNGKey(0)``), so its streams differ from
  ``jax.random``'s;
* ``mlir=`` (an exported artifact) is ROADMAP.md A11 and raises
  ``NotImplementedError``; ``quantize=`` converts a ``net=`` model to int8
  (``contrib.quantization``) before its buckets are captured, its int8
  products on the ``qconv_s8`` / ``qgemm_s8`` kernels, and
  ``mxtpu_serve_model_bytes`` counts the int8 buffers;
* a generate model's KV cache is updated in place, so a failed call
  leaves the other slots' K/V intact and ``_GenerativeModel.recover``
  never has to rebuild; sampling draws counter-based Gumbel noise hashed
  from (seed, position, token id) — occupancy-invariant and the same on
  CPU and GPU — so sampled streams differ from ``jax.random``'s; greedy
  streams are what is compared with the JAX engine.
"""
from __future__ import annotations

import contextlib
import hashlib
import os
import queue as _queue_mod
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as _np
import torch

from . import chaos
from . import telemetry as _telemetry
from .context import Context, resolve_device
from .cuda_graph import CapturedStep, capture as _capture_graph, first_call
from .guard import GuardPolicy, StepHungError, TrainingGuard

__all__ = ["ServeError", "QueueFullError", "EngineClosedError",
           "RequestAborted", "SwapError", "DeadlineError",
           "ModelDegradedError", "PagesExhaustedError", "ResponseFuture",
           "GenerationFuture", "Endpoint", "GenerativeEndpoint",
           "InferenceEngine", "default_buckets", "default_gen_buckets",
           "sample_tokens"]


class ServeError(RuntimeError):
    """Base class for serving-runtime errors."""


class QueueFullError(ServeError):
    """Backpressure: the model's bounded request queue is full (or a
    tenant is over its queue quota — ``reason == "quota"``). Fast
    reject at submit — the engine never buffers unboundedly."""

    reason = "queue_full"


class EngineClosedError(ServeError):
    """Submit after ``close()`` (or a request dropped by a no-drain
    shutdown)."""


class RequestAborted(ServeError):
    """``result()`` on a future the client cancelled."""


class SwapError(ServeError):
    """A staged hot swap failed (stage, contract or canary). The old
    version was never unrouted — it keeps serving untouched."""


class DeadlineError(ServeError):
    """Shed before compute: the request's queue wait alone already
    guaranteed an SLO miss (its deadline expired while still queued)."""


class ModelDegradedError(ServeError):
    """Fast-fail: the model walked the self-healing ladder
    (retry -> rebuild -> degraded) and is awaiting a successful probe
    batch; submits are rejected instead of queued into a black hole."""


class PagesExhaustedError(ServeError):
    """Typed paged-KV backpressure: the request's worst-case page need
    (``ceil((prompt + max_new) / page_len)``) exceeds what the pool can
    EVER provide (submit-time, permanent for this request shape), or —
    defensively — a reserved page could not be produced mid-flight.
    Requests that merely have to WAIT for pages queue normally and ride
    the existing ``QueueFullError`` / ``DeadlineError`` backpressure."""

    reason = "pages_exhausted"


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name, "")
    try:
        return int(v) if v else default
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name, "")
    try:
        return float(v) if v else default
    except ValueError:
        return default


def default_buckets(max_batch: int) -> Tuple[int, ...]:
    """Padding buckets for a fill threshold: powers of two up to
    ``max_batch`` (plus ``max_batch`` itself), or the ``MXTPU_SERVE_BUCKETS``
    comma list. A request batch of n rows is padded to the smallest
    bucket >= n, so at most one graph per power of two is resident."""
    spec = os.environ.get("MXTPU_SERVE_BUCKETS", "")
    if spec:
        out = sorted({int(b) for b in spec.split(",") if b.strip()})
        if not out or out[0] < 1:
            raise ValueError(f"bad MXTPU_SERVE_BUCKETS {spec!r}")
        return tuple(out)
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(sorted(set(out)))


#: shed-horizon inflation over the fastest observed service time: a
#: request is shed once queue wait + this multiple of the endpoint's
#: best-ever dispatch->delivery time overruns its deadline. >1 absorbs
#: scheduling/demux jitter so ACCEPTED requests land inside the SLO while
#: staying far under typical service — a request with real headroom is
#: never shed.
_SVC_SHED_FACTOR = 2.0


# ------------------------------------------------------------------ futures
class ResponseFuture:
    """One request's response slot. ``result(timeout)`` blocks; ``cancel()``
    marks the client gone (the demux then drops the row instead of
    delivering it — the ``serve.client_abort`` path)."""

    __slots__ = ("_ev", "_result", "_exc", "_cancelled", "t_submit",
                 "t_done", "trace")

    def __init__(self):
        self._ev = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None
        self._cancelled = False
        self.t_submit = time.perf_counter()
        self.t_done: Optional[float] = None   # stamped at resolution
        self.trace = None   # telemetry.Trace: this request's waterfall

    @property
    def trace_id(self) -> Optional[str]:
        return self.trace.trace_id if self.trace is not None else None

    def done(self) -> bool:
        return self._ev.is_set()

    def cancel(self) -> None:
        self._cancelled = True

    def cancelled(self) -> bool:
        return self._cancelled

    def _set_result(self, value) -> None:
        self._result = value
        self.t_done = time.perf_counter()
        self._ev.set()

    def _set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self.t_done = time.perf_counter()
        self._ev.set()

    def result(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError("serving response not ready")
        if self._cancelled:
            raise RequestAborted("request was cancelled by the client")
        if self._exc is not None:
            raise self._exc
        return self._result


class _Request:
    __slots__ = ("data", "future", "t_enq", "deadline", "tenant",
                 "priority", "trace")

    def __init__(self, data: _np.ndarray, future: ResponseFuture,
                 deadline: Optional[float] = None,
                 tenant: Optional[str] = None, priority: int = 0,
                 trace=None):
        self.data = data
        self.future = future
        self.t_enq = time.perf_counter()
        self.deadline = deadline    # absolute perf_counter() instant
        self.tenant = tenant
        self.priority = priority
        self.trace = trace          # telemetry.Trace (also on the future)


class GenerationFuture:
    """One generation request's streaming response. Tokens arrive one at
    a time as the decode loop emits them:

    * iterate (``for tok in fut.stream():`` or plain ``for tok in fut``)
      to consume tokens as they land;
    * ``result(timeout)`` blocks until the generation finishes and
      returns the full emitted-token list;
    * ``cancel()`` marks the client gone — the decode loop frees the
      request's KV slot the same iteration and ``result()``/iteration
      raise ``RequestAborted``.

    ``t_first`` records the first-token arrival (time-to-first-token)."""

    _END = object()

    __slots__ = ("_ev", "_q", "_tokens", "_exc", "_cancelled",
                 "t_submit", "t_first", "trace")

    def __init__(self):
        self._ev = threading.Event()
        self._q: "_queue_mod.Queue" = _queue_mod.Queue()
        self._tokens: List[int] = []
        self._exc: Optional[BaseException] = None
        self._cancelled = False
        self.t_submit = time.perf_counter()
        self.t_first: Optional[float] = None
        self.trace = None   # telemetry.Trace: this request's waterfall

    @property
    def trace_id(self) -> Optional[str]:
        return self.trace.trace_id if self.trace is not None else None

    def done(self) -> bool:
        return self._ev.is_set()

    def cancel(self) -> None:
        self._cancelled = True

    def cancelled(self) -> bool:
        return self._cancelled

    def tokens(self) -> List[int]:
        """Snapshot of the tokens emitted so far."""
        return list(self._tokens)

    # decode-loop side -----------------------------------------------------
    def _put_token(self, tok: int) -> None:
        if self.t_first is None:
            self.t_first = time.perf_counter()
        self._tokens.append(tok)
        self._q.put(tok)

    def _set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._ev.set()
        self._q.put(self._END)

    def _set_result(self) -> None:      # tokens already streamed
        self._ev.set()
        self._q.put(self._END)

    # client side ----------------------------------------------------------
    def result(self, timeout: Optional[float] = None) -> List[int]:
        if not self._ev.wait(timeout):
            raise TimeoutError("generation not finished")
        if self._cancelled:
            raise RequestAborted("generation was cancelled by the client")
        if self._exc is not None:
            raise self._exc
        return list(self._tokens)

    def stream(self, timeout: Optional[float] = None):
        """Yield tokens as they are emitted; raises the terminal error
        (if any) after the last token. ``timeout`` bounds the wait for
        EACH token (inter-token deadline), not the whole generation."""
        while True:
            try:
                item = self._q.get(timeout=timeout)
            except _queue_mod.Empty:
                raise TimeoutError("no token within the stream timeout")
            if item is self._END:
                break
            yield item
        if self._cancelled:
            raise RequestAborted("generation was cancelled by the client")
        if self._exc is not None:
            raise self._exc

    def __iter__(self):
        return self.stream()


class _GenRequest:
    __slots__ = ("prompt", "max_new", "future", "t_enq", "temperature",
                 "top_k", "top_p", "seed", "deadline", "trace")

    def __init__(self, prompt: _np.ndarray, max_new: int,
                 future: GenerationFuture, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 0.0, seed: int = 0,
                 deadline: Optional[float] = None, trace=None):
        self.prompt = prompt
        self.max_new = max_new
        self.future = future
        self.t_enq = time.perf_counter()
        self.temperature = temperature  # 0 = greedy argmax (the default)
        self.top_k = top_k              # 0 = full vocabulary
        self.top_p = top_p              # 0 = full vocabulary (nucleus off)
        self.seed = seed
        self.deadline = deadline        # absolute perf_counter() instant
        self.trace = trace              # telemetry.Trace (also on future)


#: per-token ``decode`` trace spans are recorded for the first K emitted
#: tokens; past that they aggregate N-per-span so a long generation's
#: tail never exhausts ``telemetry.MAX_TRACE_SPANS`` and loses its retire
#: span
_DECODE_SPAN_DETAIL = 256
_DECODE_SPAN_AGG = 64


class _GenSlot:
    """Decode-loop-local state of one occupied KV slot."""

    __slots__ = ("req", "pos", "remaining", "last_tok", "pages",
                 "reserved", "fill_next", "t_emit", "dec_acc_s",
                 "dec_acc_n")

    def __init__(self, req: _GenRequest, pos: int, remaining: int,
                 last_tok: int):
        self.req = req
        self.pos = pos              # next cache position to write
        self.remaining = remaining  # tokens this request may still emit
        self.last_tok = last_tok    # fed to the next decode step
        self.t_emit = time.perf_counter()   # last emission (ITL baseline)
        self.dec_acc_s = 0.0        # decode time not yet flushed as a span
        self.dec_acc_n = 0          # tokens in the pending aggregate span
        # paged-engine state (empty/zero on the contiguous path)
        self.pages: List[int] = []  # block-table row: pool page ids
        self.reserved = 0           # pages still promised, not yet alloc'd
        self.fill_next = 0          # next absolute position to prefill;
        #                             >= len(prompt) once decode-ready


def _prefix_page_keys(prompt: _np.ndarray, page_len: int,
                      limit: int) -> List[bytes]:
    """Chained prefix-cache keys at page granularity: key ``i`` digests
    tokens [0, (i+1) * page_len), so a page is reusable only when the
    ENTIRE prefix through it matches — page content is a pure function
    of its key (K/V at a position depend on all earlier tokens)."""
    h = hashlib.blake2b(digest_size=16)
    keys: List[bytes] = []
    flat = _np.ascontiguousarray(prompt, dtype=_np.int32)
    for i in range(limit):
        h.update(flat[i * page_len:(i + 1) * page_len].tobytes())
        keys.append(h.digest())
    return keys


class _PagePool:
    """Host-side free-list allocator over the paged KV pool: ref-counted
    pages, worst-case admission reservations, and the prefix-cache index.

    Single-consumer: only the endpoint's token-loop thread mutates it
    (submit-side code only READS ``n_pages``), so no lock. Page states:

    - ``free``: unreferenced, content garbage, allocatable;
    - ``cached``: unreferenced but still named by the prefix index — its
      content is a frozen full prompt-prefix page, reusable by a later
      prompt with the same prefix. Reclaimed LRU-first when the free list
      runs dry (eviction drops the index entry);
    - in use: ``ref[pid] > 0`` — one count per slot whose block table
      names the page. Sharing is page-granular and frozen: a sharer's own
      writes always land in pages it allocated fresh, never in a shared
      page.

    ``reserved`` tracks worst-case admission promises so concurrent slots
    cannot collectively over-commit: a request is only admitted when
    ``available() - reserved`` covers ALL pages it could ever need, and
    every later allocation draws down its reservation — so mid-generation
    exhaustion is structurally impossible (the ``PagesExhaustedError``
    raise below is a defensive invariant)."""

    def __init__(self, n_pages: int, page_len: int):
        self.n_pages = int(n_pages)
        self.page_len = int(page_len)
        self.trash = self.n_pages          # pool row the model never uses
        self.free: List[int] = list(range(self.n_pages))
        self.ref = [0] * self.n_pages
        self.reserved = 0
        self.index: Dict[bytes, int] = {}             # key -> pid
        self.by_page: Dict[int, bytes] = {}           # pid -> key
        self.cached: "OrderedDict[int, None]" = OrderedDict()  # LRU

    def available(self) -> int:
        return len(self.free) + len(self.cached)

    def in_use(self) -> int:
        return self.n_pages - self.available()

    def can_admit(self, need: int) -> bool:
        return self.available() - self.reserved >= need

    def reserve(self, need: int) -> None:
        self.reserved += need

    def unreserve(self, count: int) -> None:
        self.reserved -= count

    def alloc_reserved(self) -> int:
        """Allocate one page against an existing reservation (free list
        first, else evict the LRU cached page and drop its index
        entry)."""
        if self.free:
            pid = self.free.pop()
        elif self.cached:
            pid, _ = self.cached.popitem(last=False)
            key = self.by_page.pop(pid)
            del self.index[key]
        else:
            raise PagesExhaustedError(
                "page pool invariant violated: a reserved page could "
                "not be produced (free and cached lists both empty)")
        self.ref[pid] = 1
        self.reserved -= 1
        return pid

    def incref(self, pid: int) -> None:
        if self.ref[pid] == 0:
            self.cached.pop(pid, None)
        self.ref[pid] += 1

    def decref(self, pid: int) -> None:
        self.ref[pid] -= 1
        if self.ref[pid] == 0:
            if pid in self.by_page:
                self.cached[pid] = None    # stays reusable until evicted
            else:
                self.free.append(pid)

    def lookup(self, key: bytes) -> Optional[int]:
        return self.index.get(key)

    def register(self, key: bytes, pid: int) -> None:
        """Publish a frozen full prompt-prefix page for reuse (no-op if
        the key is already served by some page)."""
        if key not in self.index and pid not in self.by_page:
            self.index[key] = pid
            self.by_page[pid] = key

    def release_slot(self, slot: _GenSlot) -> None:
        """Idempotently return a retiring slot's pages + reservation."""
        pages, slot.pages = slot.pages, []
        for pid in pages:
            self.decref(pid)
        self.reserved -= slot.reserved
        slot.reserved = 0

    def flush_index(self) -> None:
        """Drop the prefix cache: cached pages return to the free list."""
        self.index.clear()
        self.by_page.clear()
        for pid in self.cached:
            self.free.append(pid)
        self.cached.clear()


def default_gen_buckets(cache_len: int) -> Tuple[int, ...]:
    """Prompt padding buckets for a generate endpoint: the
    ``MXTPU_SERVE_GEN_BUCKETS`` comma list, else powers of two from 16 up
    to half the cache extent (a prompt needs headroom to generate into)."""
    spec = os.environ.get("MXTPU_SERVE_GEN_BUCKETS", "")
    if spec:
        out = sorted({int(b) for b in spec.split(",") if b.strip()})
        if not out or out[0] < 1:
            raise ValueError(f"bad MXTPU_SERVE_GEN_BUCKETS {spec!r}")
        return tuple(out)
    top = max(cache_len // 2, 8)
    out, b = [], 16
    while b < top:
        out.append(b)
        b *= 2
    out.append(top)
    return tuple(sorted(set(out)))


# ----------------------------------------------------------------- sampling
_M32 = 0xFFFFFFFF


def _mix32(x):
    """32-bit integer finaliser on int64 tensors holding values in
    [0, 2**32): every product stays below 2**63, so the arithmetic is
    exact and identical on every device."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def _gumbel_noise(seeds, positions, vocab: int):
    """(R, vocab) float64 Gumbel noise, a pure function of
    (seed, position, token id) per row."""
    dev = seeds.device
    tok = torch.arange(vocab, dtype=torch.int64, device=dev)[None, :]
    h = _mix32((seeds.to(torch.int64) & _M32) ^ 0x9E3779B9)
    h = _mix32(h ^ (positions.to(torch.int64) & _M32))
    h = _mix32(h[:, None] ^ tok)
    u = ((h >> 8).to(torch.float64) + 0.5) / float(1 << 24)
    return -torch.log(-torch.log(u))


def sample_tokens(logits, temps, topks, topps, seeds, positions):
    """Next token per row of ``logits`` (R, vocab); every other argument is
    an (R,) tensor on the logits' device. ``temps == 0`` rows take the
    exact greedy argmax; other rows draw from the temperature-scaled
    softmax restricted to the ``topks`` highest logits (0 = all)
    intersected with the nucleus — the smallest set of top logits whose
    temperature-scaled mass reaches ``topps`` (<= 0 or >= 1 = all; ties
    at either threshold are kept). The draw is the argmax of the scaled
    masked logits plus Gumbel noise hashed from (seed, position, token
    id): a function of the request alone, never of batch occupancy."""
    logits = logits.float()
    greedy = logits.argmax(dim=1)
    vocab = logits.shape[1]
    k = torch.where(topks > 0, topks, torch.full_like(topks, vocab))
    k = k.clamp(1, vocab).to(torch.int64)
    desc = torch.sort(logits, dim=1, descending=True).values
    kth = desc.gather(1, (k - 1)[:, None])
    neg_inf = torch.full_like(logits, float("-inf"))
    masked = torch.where(logits >= kth, logits, neg_inf)
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps)).float()
    # topp >= 1 is nucleus-OFF: the float32 cumsum can top out just below
    # 1.0, and "first index reaching topp" would then collapse to rank 0
    cum = torch.cumsum(torch.softmax(desc / safe_t[:, None], dim=1), dim=1)
    first = (cum >= topps[:, None]).to(torch.int32).argmax(dim=1)
    pth = desc.gather(1, first[:, None].to(torch.int64))
    nucleus = ((topps > 0) & (topps < 1))[:, None]
    masked = torch.where(nucleus & (logits < pth), neg_inf, masked)
    scores = masked.double() / safe_t.double()[:, None] \
        + _gumbel_noise(seeds, positions, vocab)
    drawn = scores.argmax(dim=1)
    return torch.where(temps > 0, drawn, greedy)


# -------------------------------------------------------------------- steps
class _StepInputs:
    """A step's static inputs: named int64 and float32 fields, each kind
    packed into one device buffer that the step's body reads. ``h`` holds
    numpy views of a host buffer beside it (pinned, on the card; the
    device buffer itself, on the CPU) that a call writes, and
    :meth:`load` moves them with one copy a kind."""

    def __init__(self, device, ints, floats):
        self.t, self.h, self._pairs = {}, {}, []
        for dtype, fields in ((torch.int64, ints), (torch.float32, floats)):
            n = sum(int(_np.prod(shape)) for shape in fields.values())
            dev = torch.zeros(n, dtype=dtype, device=device)
            host = (torch.zeros(n, dtype=dtype, pin_memory=True)
                    if dev.is_cuda else dev)
            view = host.numpy()
            off = 0
            for name, shape in fields.items():
                k = int(_np.prod(shape))
                self.t[name] = dev[off:off + k].view(shape)
                self.h[name] = view[off:off + k].reshape(shape)
                off += k
            self._pairs.append((dev, host))

    def load(self) -> None:
        for dev, host in self._pairs:
            if dev is not host:
                dev.copy_(host, non_blocking=True)


class _StepGraph(CapturedStep):
    """One serving step: ``body()`` reads its :class:`_StepInputs` and
    returns the step's token tensor; a call loads the inputs, then runs
    the body or, once captured, replays its graph
    (:class:`cuda_graph.CapturedStep`)."""

    def __init__(self, body, inputs: _StepInputs):
        super().__init__(body)
        self.inputs = inputs

    def __call__(self):
        self.inputs.load()
        return super().__call__()


# -------------------------------------------------------------------- model
class _GenerativeModel:
    """KV-cache generation over the port's transformer — PAGED by default
    (block-table pool), with the dense slotted cache kept as
    ``paged=False``.

    Paged mode: the cache is a page pool ``(layers, n_pages + 1, heads,
    page_len, head_dim)`` (the +1 is the trash page) and the prefill /
    decode calls take the request's block-table row(s). Prompts (and
    prefill chunks) are padded to their bucket, so each call runs at one
    of ``len(buckets)`` prefill shapes or the one decode shape, each a
    step on static inputs (:class:`_StepGraph`), captured as a CUDA graph
    on the card (``_capture=False`` keeps them eager there: the yardstick
    of the captured engine, never a public knob).

    Decoding is greedy (argmax) by default; per-request ``temperature`` /
    ``top_k`` / ``top_p`` / ``seed`` ride as per-slot tensors through the
    same calls, and every step samples in its body (see
    :func:`sample_tokens`; greedy rows take the exact argmax). Greedy and
    sampled streams alike are a function of the request alone, at any
    batch occupancy."""

    kind = "generate"

    def __init__(self, params, cfg, *, slots: int, cache_len: int,
                 block: int, buckets: Sequence[int], eos_id: Optional[int],
                 max_new_tokens: int, name: str = "", paged: bool = False,
                 page_len: Optional[int] = None,
                 n_pages: Optional[int] = None, device=None,
                 _capture: bool = True):
        from .models.transformer import init_kv_cache, init_paged_kv_cache
        self.device = resolve_device(device)
        self._name = name
        self.cfg = cfg
        self.slots = int(slots)
        self.block = int(block)
        # cache extent rounds up to whole pages (the decode kernel walks
        # block-sized pages and skips the dead tail)
        self.cache_len = -(-int(cache_len) // self.block) * self.block
        if self.cache_len > cfg.max_len:
            raise ValueError(
                f"cache_len {cache_len} (rounded to {self.cache_len} by "
                f"block {self.block}) exceeds cfg.max_len {cfg.max_len}")
        self.eos_id = eos_id
        self.max_new_tokens = int(max_new_tokens)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError("generate needs at least one prompt bucket")
        if self.buckets[-1] > self.cache_len:
            raise ValueError(
                f"largest prompt bucket {self.buckets[-1]} exceeds the "
                f"cache extent {self.cache_len}")
        self.paged = bool(paged)
        if self.paged:
            self.page_len = int(page_len) if page_len else self.block
            if self.cache_len % self.page_len:
                raise ValueError(
                    f"page_len {self.page_len} must divide the cache "
                    f"extent {self.cache_len}")
            # per-slot block-table width: a slot can span at most the
            # full per-request extent
            self.max_pages = self.cache_len // self.page_len
            self.n_pages = (int(n_pages) if n_pages
                            else self.slots * self.max_pages)
            if self.n_pages < self.max_pages:
                raise ValueError(
                    f"pages {self.n_pages} cannot hold even one full "
                    f"request ({self.max_pages} pages of "
                    f"{self.page_len})")
            self.trash_page = self.n_pages
        self._params = _params_to(params, self.device)
        if self.paged:
            self._cache = init_paged_kv_cache(cfg, self.n_pages,
                                              self.page_len,
                                              device=self.device)
        else:
            self._cache = init_kv_cache(cfg, self.slots, self.cache_len,
                                        device=self.device)
        self.model_bytes = int(sum(t.nbytes for t in _leaves(self._params)))
        self.cache_bytes = int(sum(t.nbytes for t in self._cache.values()))
        self._build_steps(_capture)

    def bucket_for(self, n: int) -> Optional[int]:
        for b in self.buckets:
            if b >= n:
                return b
        return None

    # ------------------------------------------------------------ steps
    def _trace(self) -> None:
        """Bumped inside every step body: only a capture counts, so only
        load moves the counter and traffic never does."""
        if self._capturing:
            self._m_traces.inc(1, model=self._name)

    def _prefill_step(self, bucket: int) -> "_StepGraph":
        """The prefill step of one prompt bucket on its static inputs.
        Paged: the chunk's tokens (1, bucket), the block-table row, start,
        n_valid and the sampler's position n_total; contiguous: the
        tokens, slot and length (the sampler's position). The inputs hold
        a harmless call until the first request (the trash page, or slot
        0 of a cache no request holds yet)."""
        from .models.transformer import (transformer_prefill,
                                         transformer_prefill_paged)
        ints = {"tokens": (1, bucket), "topk": (1,), "seed": (1,),
                "pos": (1,)}
        if self.paged:
            ints.update(pages=(self.max_pages,), start=(), n_valid=())
        else:
            ints.update(slot=(), length=())
        inp = _StepInputs(self.device, ints, {"temp": (1,), "topp": (1,)})
        t = inp.t
        if self.paged:
            inp.h["pages"][...] = self.trash_page
            inp.h["n_valid"][...] = 1
        else:
            inp.h["length"][...] = 1

        def body():
            self._trace()
            if self.paged:
                _, logits = transformer_prefill_paged(
                    self._params, t["tokens"], self.cfg, self._cache,
                    t["pages"], t["start"], t["n_valid"])
            else:
                _, logits = transformer_prefill(
                    self._params, t["tokens"], self.cfg, self._cache,
                    t["slot"], t["length"])
            return sample_tokens(logits[None], t["temp"], t["topk"],
                                 t["topp"], t["seed"], t["pos"])
        return _StepGraph(body, inp)

    def _decode_step(self) -> "_StepGraph":
        """The fixed-shape decode step over the slot batch on its static
        inputs: tokens, positions, the sampler's rows and (paged) the
        (slots, max_pages) block tables, all-trash until the first step."""
        from .models.transformer import (transformer_decode_step,
                                         transformer_decode_step_paged)
        S = self.slots
        ints = {"tokens": (S,), "positions": (S,), "topks": (S,),
                "seeds": (S,)}
        if self.paged:
            ints["bts"] = (S, self.max_pages)
        inp = _StepInputs(self.device, ints, {"temps": (S,), "topps": (S,)})
        t = inp.t
        if self.paged:
            inp.h["bts"][...] = self.trash_page

        def body():
            self._trace()
            if self.paged:
                _, logits = transformer_decode_step_paged(
                    self._params, t["tokens"], t["positions"], self._cache,
                    t["bts"].to(torch.int32), self.cfg)
            else:
                _, logits = transformer_decode_step(
                    self._params, t["tokens"], t["positions"], self._cache,
                    self.cfg, block_k=self.block)
            return sample_tokens(logits, t["temps"], t["topks"], t["topps"],
                                 t["seeds"], t["positions"])
        return _StepGraph(body, inp)

    def _build_steps(self, capture: bool) -> None:
        """One step a prompt bucket and one decode step, ``len(buckets) +
        1``. On the card (unless ``capture`` is False, the eager
        yardstick) each is warmed on a capture stream of its own, then
        captured as a CUDA graph, all graphs drawing on one memory pool
        (the token loop replays them one at a time on one stream); each
        capture counts one compile. A capture that fails raises: the
        engine never falls back to eager steps."""
        self._capturing = False
        self._m_traces = _telemetry.counter(
            "mxtpu_serve_gen_traces_total",
            "Prefill/decode python traces per generate model (bumped "
            "inside the traced bodies: load-time only, never by traffic).")
        compiles = _telemetry.counter(
            "mxtpu_serve_compiles_total",
            "AOT executables compiled per model (one per padding bucket "
            "at load; serving traffic never adds more).")
        self._prefills = {b: self._prefill_step(b) for b in self.buckets}
        self._decode = self._decode_step()
        steps = list(self._prefills.values()) + [self._decode]
        for step in steps:
            step.inputs.load()
        if not capture or self.device.type != "cuda":
            return
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        pool = torch.cuda.graph_pool_handle()
        with torch.inference_mode():
            with torch.cuda.stream(stream):
                for step in steps:
                    step.body()
            stream.synchronize()
            for step in steps:
                self._capturing = True
                try:
                    _capture_graph(step, stream, pool)
                finally:
                    self._capturing = False
                compiles.inc(1, model=self._name)
        torch.cuda.synchronize(self.device)

    @staticmethod
    def _sampling(h, temperature, top_k, top_p, seed, position) -> None:
        h["temp"][...] = temperature
        h["topk"][...] = top_k
        h["topp"][...] = top_p
        h["seed"][...] = seed
        h["pos"][...] = position

    def _prefill_inputs(self, tokens: _np.ndarray):
        """The bucket's step for ``tokens``, its host views holding them
        padded with zeros."""
        step = self._prefills[self.bucket_for(len(tokens))]
        h = step.inputs.h
        h["tokens"][...] = 0
        h["tokens"][0, :len(tokens)] = tokens
        return step, h

    @torch.inference_mode()
    def prefill(self, prompt: _np.ndarray, slot: int,
                temperature: float = 0.0, top_k: int = 0,
                top_p: float = 0.0, seed: int = 0) -> int:
        """Contiguous mode: pad the prompt to its bucket, write the slot's
        K/V, return the first generated token (host int). Synchronous:
        admission happens between decode iterations."""
        n = len(prompt)
        step, h = self._prefill_inputs(prompt)
        h["slot"][...] = slot
        h["length"][...] = n
        self._sampling(h, temperature, top_k, top_p, seed, n)
        return int(step().cpu()[0])

    @torch.inference_mode()
    def prefill_chunk(self, chunk: _np.ndarray, pages: Sequence[int],
                      start: int, n_total: int, temperature: float = 0.0,
                      top_k: int = 0, top_p: float = 0.0,
                      seed: int = 0) -> int:
        """Paged mode: prefill ONE chunk of a prompt — ``chunk`` holds
        positions [start, start + len(chunk)), written through the
        request's block-table row ``pages`` (page ids, any length up to
        ``max_pages``; the tail is padded with the trash page). Returns
        the sampled token (meaningful only for the FINAL chunk, where
        ``start + len(chunk) == n_total``). A one-shot prefill is a
        single chunk with ``start=0``."""
        step, h = self._prefill_inputs(chunk)
        h["pages"][...] = self.trash_page
        h["pages"][:len(pages)] = pages
        h["start"][...] = start
        h["n_valid"][...] = len(chunk)
        self._sampling(h, temperature, top_k, top_p, seed, n_total)
        return int(step().cpu()[0])

    @torch.inference_mode()
    def decode(self, tokens: _np.ndarray, positions: _np.ndarray,
               temps: _np.ndarray, topks: _np.ndarray,
               topps: _np.ndarray, seeds: _np.ndarray,
               block_tables: Optional[_np.ndarray] = None) -> _np.ndarray:
        """One fixed-shape decode step over the whole slot batch; returns
        the (slots,) next-token ids. Paged mode additionally takes the
        (slots, max_pages) int32 block tables (dead/prefilling rows must
        be all-trash)."""
        h = self._decode.inputs.h
        h["tokens"][...] = tokens
        h["positions"][...] = positions
        h["temps"][...] = temps
        h["topks"][...] = topks
        h["topps"][...] = topps
        h["seeds"][...] = seeds
        if self.paged:
            h["bts"][...] = block_tables
        return self._decode().cpu().numpy()

    def recover(self) -> bool:
        """After a FAILED prefill/decode call: whether the live slots'
        K/V were lost. Always False here — the cache is updated in place,
        and a failed call can only have written the failing requests' own
        positions (their slots are retired) and the trash page."""
        return False


def _leaves(params):
    yield from (params[k] for k in params if k != "layers")
    for lp in params["layers"]:
        yield from lp.values()


def _params_to(params, device):
    out = {k: v.to(device) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: v.to(device) for k, v in lp.items()}
                     for lp in params["layers"]]
    return out


# ------------------------------------------------------------ batch models
class _Slot:
    """One in-flight batch's pinned host buffers (plain host tensors on the
    CPU), sized for the largest bucket: the padded input rows, each
    output's rows, and the event recorded after the batch's copy-out."""

    def __init__(self, device, item_shape, in_dtype, out_specs, rows):
        pin = device.type == "cuda"
        self.x = torch.zeros((rows,) + tuple(item_shape), dtype=in_dtype,
                             pin_memory=pin)
        self.xn = self.x.numpy()
        self.outs = [torch.empty((rows,) + tuple(shape), dtype=dt,
                                 pin_memory=pin) for shape, dt in out_specs]
        self.event = torch.cuda.Event() if pin else None


class _Batch:
    """A packed batch of one ``_AOTBlockModel``: its slot, bucket and real
    row count. ``close()`` hands the slot back once the batch's copy-out
    has passed (idempotent)."""

    __slots__ = ("_free", "slot", "bucket", "n")

    def __init__(self, free, slot: _Slot, bucket: int, n: int):
        self._free, self.slot, self.bucket, self.n = free, slot, bucket, n

    @property
    def x(self) -> _np.ndarray:
        """The padded input rows (a view of the slot's staging buffer)."""
        return self.slot.xn[:self.bucket]

    def close(self) -> None:
        slot, self.slot = self.slot, None
        if slot is None:
            return
        if slot.event is not None:
            slot.event.synchronize()
        self._free.put(slot)


def _torch_dtype(dtype: _np.dtype) -> torch.dtype:
    return torch.from_numpy(_np.zeros(0, dtype)).dtype


def _quantize_for_serving(net, quantize):
    """``load_model(quantize=...)``: ``net`` converted to int8 in place
    (the reference's forms: ``True`` for dynamic ranges, a dict of
    ``contrib.quantization.quantize_net`` arguments that may hold
    ``fold_bn``, or a bare calibration iterable). With neither calibration
    data nor thresholds, the ranges are dynamic (``calib_mode='none'``)."""
    from .contrib import quantization as _cq
    if quantize is True:
        spec = {}
    elif isinstance(quantize, dict):
        spec = dict(quantize)
    else:
        spec = {"calib_data": quantize}
    if spec.pop("fold_bn", False):
        _cq.fold_batchnorm(net)
    if spec.get("calib_data") is None and spec.get("thresholds") is None:
        spec.setdefault("calib_mode", "none")
    return _cq.quantize_net(net, **spec)


class _AOTBlockModel:
    """A ``HybridBlock`` served as one captured graph a padding bucket.

    At load: one discovery forward (inference mode) resolves deferred
    initialisation; the parameters are copied as static buffers onto
    ``device`` (``gluon.block._StaticForward``); each bucket, largest
    first, is one ``gluon.block._ForwardEntry`` — the block's inference
    forward over a static ``(bucket, *item_shape)`` input and the static
    parameters — which on the card runs eagerly once on the capture stream
    and is then captured (``cuda_graph.first_call``), all the buckets'
    graphs in one memory pool, each capture one count of
    ``mxtpu_serve_compiles_total``. A capture that fails raises, naming
    the block: a forward that syncs with the host cannot be served on the
    card. On the CPU the same bodies run eagerly at every dispatch and
    nothing is counted.

    ``pack`` writes the padded batch into a free slot's staging rows (it
    waits for one while all are in flight); ``dispatch`` copies them into
    the bucket's static input on the model's serving stream, replays the
    graph, copies the outputs into the slot and records the slot's event,
    all under the model's lock (a graph's static buffers are shared by
    every call of its bucket); ``fetch`` waits on that event, copies the
    real rows out and frees the slot. Every output must lead with the
    batch axis. Random draws come from the bucket entry's generator,
    seeded from the model's dispatch counter before each replay."""

    kind = "aot"

    def __init__(self, net, item_shape: Tuple[int, ...], dtype,
                 buckets: Sequence[int], name: str = "", device=None,
                 slots: int = 4):
        from .gluon.block import _StaticForward
        from . import ndarray as _nd
        if not hasattr(net, "_resolve_deferred"):
            raise TypeError(f"net= takes a HybridBlock, got {type(net)}")
        self.device = resolve_device(device)
        self._name = name
        self._net = net
        self.item_shape = tuple(int(d) for d in item_shape)
        self.dtype = _np.dtype(dtype)
        self._tdtype = _torch_dtype(self.dtype)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"bad buckets {buckets!r}")
        params = list(net.collect_params().values())
        deferred = [p for p in params if p._data is None]
        if deferred:
            ctx = next((p._deferred_init[1] for p in deferred
                        if p._deferred_init), None)
            net._resolve_deferred((_nd.zeros(
                (self.buckets[0],) + self.item_shape, ctx=ctx,
                dtype=self.dtype.name),))
        self._state = _StaticForward(net, params, device=self.device)
        self.model_bytes = int(sum(t.nbytes for t in self._state.static))
        # arrays a forward makes without a context land on the model's
        # device
        self._ctx = Context.from_torch(self.device)
        self._lock = threading.Lock()
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._rng_calls = 0
        self._compiles = _telemetry.counter(
            "mxtpu_serve_compiles_total",
            "AOT executables compiled per model (one per padding bucket "
            "at load; serving traffic never adds more).")
        self._out_specs = None
        self._entries = self._build()
        self._free: "_queue_mod.Queue" = _queue_mod.Queue()
        for _ in range(max(1, int(slots))):
            self._free.put(_Slot(self.device, self.item_shape,
                                 self._tdtype, self._out_specs,
                                 self.buckets[-1]))

    def _build(self) -> Dict[int, Any]:
        """One forward entry a bucket, largest first; on the card each is
        warmed and captured into the model's one graph pool. A build that
        fails frees the graphs it made and raises."""
        cuda = self.device.type == "cuda"
        pool = torch.cuda.graph_pool_handle() if cuda else None
        entries: Dict[int, Any] = {}
        try:
            self._build_into(entries, cuda, pool)
        except BaseException:
            self._reset_graphs(entries)
            raise
        return entries

    def _build_into(self, entries: Dict[int, Any], cuda: bool,
                    pool) -> None:
        from .gluon.block import _LEAF, _ForwardEntry
        from .ndarray.ndarray import NDArray
        for b in sorted(self.buckets, reverse=True):
            x = NDArray(torch.zeros((b,) + self.item_shape,
                                    dtype=self._tdtype, device=self.device),
                        _direct=True)
            entry = _ForwardEntry(self._state, [_LEAF], [x], False,
                                  self.device)
            entry.inputs[0].zero_()
            entry.gen.manual_seed(0)
            with self._ctx:
                if cuda:
                    outs = first_call(
                        entry.step, self.device, (entry.gen,),
                        f"serving model {self._name!r} (block "
                        f"{getattr(self._net, 'name', type(self._net))}, "
                        f"bucket {b})", pool)
                    self._compiles.inc(1, model=self._name)
                else:
                    outs = entry.step()
            entries[b] = entry
            self._check_outputs(b, outs)

    def _check_outputs(self, bucket: int, outs) -> None:
        specs = [(tuple(o.shape[1:]), o.dtype) for o in outs]
        if any(o.dim() == 0 or o.shape[0] != bucket for o in outs):
            raise ValueError(
                f"serving model {self._name!r}: every output must lead "
                f"with the batch axis; bucket {bucket} gave shapes "
                f"{[tuple(o.shape) for o in outs]}")
        if self._out_specs is None:
            self._out_specs = specs
        elif specs != self._out_specs:
            raise ValueError(
                f"serving model {self._name!r}: bucket {bucket}'s output "
                f"rows {specs} differ from bucket {self.buckets[-1]}'s "
                f"{self._out_specs}")

    @staticmethod
    def _reset_graphs(entries: Dict[int, Any]) -> None:
        for entry in entries.values():
            if entry.step.graph is not None:
                entry.step.graph.reset()

    def rebuild(self) -> None:
        """Self-healing ladder rung: once the serving stream's work has
        finished, capture every bucket again from the static parameters
        (``len(buckets)`` more compiles on the card), then put the new
        graphs in place of the old and free those. A build that fails
        raises and leaves the old graphs serving."""
        with self._lock:
            if self._stream is not None:
                self._stream.synchronize()
            entries = self._build()
            old, self._entries = self._entries, entries
            self._reset_graphs(old)

    def release(self) -> None:
        """Free this version's graphs, pool and static parameters after a
        hot swap drained it."""
        with self._lock:
            if self._stream is not None:
                self._stream.synchronize()
            old, self._entries = self._entries, {}
            self._reset_graphs(old)
            self._state = None

    def pack(self, rows: Sequence[_np.ndarray], bucket: int) -> _Batch:
        """``rows`` (each of ``item_shape``) padded with zeros to
        ``bucket`` rows in a free slot's staging buffer."""
        slot = self._free.get()
        batch = _Batch(self._free, slot, bucket, len(rows))
        try:
            x = batch.x
            if rows:
                _np.stack(rows, out=x[:len(rows)])
            x[len(rows):] = 0
        except BaseException:
            batch.close()
            raise
        return batch

    def dispatch(self, batch: _Batch, bucket: int) -> _Batch:
        slot = batch.slot
        try:
            with self._lock, self._ctx, (
                    torch.cuda.stream(self._stream)
                    if self._stream is not None
                    else contextlib.nullcontext()):
                entry = self._entries.get(bucket)
                if entry is None:
                    raise ServeError(
                        f"serving model {self._name!r} has no graph for "
                        f"bucket {bucket} (buckets {self.buckets}"
                        f"{', released' if self._state is None else ''})")
                self._rng_calls += 1
                entry.gen.manual_seed(self._rng_calls)
                entry.inputs[0].copy_(slot.x[:bucket], non_blocking=True)
                outs = entry.step()
                for h, o in zip(slot.outs, outs):
                    h[:bucket].copy_(o, non_blocking=True)
                if slot.event is not None:
                    slot.event.record(self._stream)
        except BaseException:
            if self._stream is not None:
                self._stream.synchronize()  # no copy still reads the slot
            batch.close()
            raise
        return batch

    def fetch(self, batch: _Batch) -> List[_np.ndarray]:
        """The batch's outputs on the host: its real rows (all ``bucket``
        rows of a padding-only batch), copied out of the slot, which goes
        back to the free list."""
        try:
            slot = batch.slot
            if slot.event is not None:
                slot.event.synchronize()
            k = batch.n or batch.bucket
            return [(h[:k].float() if h.dtype == torch.bfloat16
                     else h[:k]).numpy().copy() for h in slot.outs]
        finally:
            batch.close()


class _CallableModel:
    """Any ``np batch -> np outputs`` callable (tests, custom runtimes).
    Runs synchronously in the scheduler thread."""

    kind = "fn"

    def __init__(self, fn: Callable, item_shape: Tuple[int, ...], dtype,
                 buckets: Sequence[int]):
        self._fn = fn
        self.item_shape = tuple(item_shape)
        self.dtype = _np.dtype(dtype)
        self.buckets = tuple(sorted(buckets))

    def pack(self, rows: Sequence[_np.ndarray], bucket: int) -> _np.ndarray:
        xb = _np.zeros((bucket,) + self.item_shape, self.dtype)
        for i, r in enumerate(rows):
            xb[i] = r
        return xb

    def dispatch(self, np_batch: _np.ndarray, bucket: int):
        out = self._fn(np_batch)
        return out if isinstance(out, (list, tuple)) else [out]

    def fetch(self, outs) -> List[_np.ndarray]:
        return [_np.asarray(o) for o in outs]

    def rebuild(self) -> None:
        """Ladder hook: delegate to the callable's own ``rebuild()``
        when it has one (test doubles observe the ladder through it);
        otherwise a no-op — there is nothing compiled to rebuild."""
        rb = getattr(self._fn, "rebuild", None)
        if rb is not None:
            rb()


def _zeros_batch(model) -> List[_np.ndarray]:
    """The host outputs of an all-padding batch of ``model``'s smallest
    bucket (the canary's and the probe's batch)."""
    b = model.buckets[0]
    return model.fetch(model.dispatch(model.pack([], b), b))


# ---------------------------------------------------------------- endpoints
class Endpoint:
    """One loaded batch model: bounded request queue + padding buckets + a
    scheduling weight. Created by ``InferenceEngine.load_model``."""

    def __init__(self, engine: "InferenceEngine", name: str, model,
                 weight: float, queue_limit: int, max_batch: int,
                 max_wait_ms: float, deadline_ms: Optional[float] = None,
                 tenant_quota: Optional[int] = None,
                 degrade_after: Optional[int] = None,
                 probe_every: Optional[float] = None):
        self.engine = engine
        self.name = name
        self.model = model
        self.weight = float(weight)
        self.queue_limit = int(queue_limit)
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.buckets = model.buckets
        self._queue: deque = deque()
        self._wrr = 0.0
        # fill threshold: a full batch never exceeds the largest bucket
        self.fill = min(self.max_batch, self.buckets[-1])
        #: monotonically increasing across hot swaps; v1 at load
        self.version = 1
        #: default SLO per request, ms (0 = no deadline)
        self.deadline_ms = float(
            deadline_ms if deadline_ms is not None
            else _env_float("MXTPU_SERVE_DEADLINE_MS", 0.0))
        #: max queued requests per tenant (0 = no quota)
        self.tenant_quota = int(
            tenant_quota if tenant_quota is not None
            else _env_int("MXTPU_SERVE_QUOTA", 0))
        #: consecutive dispatch failures before the ladder marks the
        #: model degraded (the rung below it rebuilds the graphs)
        self.degrade_after = max(1, int(
            degrade_after if degrade_after is not None
            else _env_int("MXTPU_SERVE_DEGRADE_AFTER", 3)))
        #: seconds between probe batches while degraded
        self.probe_every_s = float(
            probe_every if probe_every is not None
            else _env_float("MXTPU_SERVE_PROBE_EVERY", 0.5))
        self.state = "ready"        # "ready" | "degraded"
        self.fail_streak = 0        # consecutive dispatch failures
        self._next_probe = 0.0      # perf_counter() of the next probe
        self._degrade_err = ""      # repr of the failure that degraded
        #: fastest observed dispatch->demux seconds — a service-time
        #: lower bound folded into the shed decision (0 = no data yet)
        self._svc_min = 0.0

    # engine-lock-free views (GIL-atomic reads; exact enough for stats)
    def pending(self) -> int:
        return len(self._queue)

    def submit(self, data, deadline_ms: Optional[float] = None,
               tenant: Optional[str] = None, priority: int = 0,
               trace=None) -> ResponseFuture:
        """Enqueue one request (an array of ``item_shape``). Returns a
        ``ResponseFuture``; raises ``QueueFullError`` on backpressure
        (``reason == "quota"`` when ``tenant`` is over its queue quota),
        ``ModelDegradedError`` while the self-healing ladder has the model
        down, and ``EngineClosedError`` after shutdown began (deadline
        sheds happen in the scheduler, through the future).
        ``deadline_ms`` overrides the endpoint default; higher
        ``priority`` dispatches first."""
        return self.engine._submit(self, data, deadline_ms=deadline_ms,
                                   tenant=tenant, priority=priority,
                                   trace=trace)

    def predict(self, data, timeout: Optional[float] = None, **kw):
        """Blocking convenience: ``submit(...).result(timeout)``."""
        return self.submit(data, **kw).result(timeout)

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]


class GenerativeEndpoint:
    """One loaded generate model: bounded prompt queue + KV slot pool +
    a dedicated token-loop thread. Created by
    ``InferenceEngine.load_model(name, generate={...})``."""

    def __init__(self, engine: "InferenceEngine", name: str,
                 model: _GenerativeModel, weight: float, queue_limit: int):
        self.engine = engine
        self.name = name
        self.model = model
        self.weight = float(weight)
        self.queue_limit = int(queue_limit)
        self.buckets = model.buckets
        self._queue: deque = deque()
        #: (prompt_len, bucket, occupancy-after-admission) log — the
        #: bucket-selection and join-mid-flight tests read it
        self.admit_log: deque = deque(maxlen=4096)
        #: live-slot census maintained by the token loop (GIL-atomic int)
        self.slots_in_use = 0
        # paged-engine wiring (set by _load_generate when model.paged)
        self.pool: Optional[_PagePool] = None
        self.prefix_cache = False
        self.prefill_chunk = 0      # 0 = one-shot prefill

    def pending(self) -> int:
        return len(self._queue)

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 0.0, seed: int = 0,
               deadline_ms: Optional[float] = None,
               trace=None) -> GenerationFuture:
        """Enqueue one prompt (1-D int token ids). Returns a streaming
        ``GenerationFuture``; raises ``QueueFullError`` on backpressure,
        ``ValueError`` when the prompt cannot fit a bucket or its
        generation budget cannot fit the KV cache, and
        ``PagesExhaustedError`` when (paged engine) the request could
        never fit the page pool even alone.

        ``temperature`` 0 (default) decodes greedy argmax, identical at
        any batch occupancy; > 0 samples the temperature-scaled softmax,
        restricted to the ``top_k`` highest logits when ``top_k`` > 0
        intersected with the ``top_p`` nucleus when ``top_p`` > 0.
        Sampling is seeded-deterministic: the stream is a pure function
        of (prompt, temperature, top_k, top_p, seed). A prompt still
        queued past ``deadline_ms`` is shed with ``DeadlineError``
        instead of occupying a KV slot it can no longer use."""
        return self.engine._submit_gen(self, prompt, max_new_tokens,
                                       temperature=temperature,
                                       top_k=top_k, top_p=top_p,
                                       seed=seed,
                                       deadline_ms=deadline_ms,
                                       trace=trace)

    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 timeout: Optional[float] = None, **kw) -> List[int]:
        """Blocking convenience: ``submit(...).result(timeout)``."""
        return self.submit(prompt, max_new_tokens, **kw).result(timeout)


# ------------------------------------------------------------------- engine
class InferenceEngine:
    """Continuous-batching scheduler over one device (``device``: default
    ``"cuda"``; raises when no card is present unless ``"cpu"`` is asked
    for). See the module docstring for the architecture; knobs
    (constructor arg, else env, else default):

    ==============  ========================  =======
    argument        env var                   default
    ==============  ========================  =======
    max_batch       MXTPU_SERVE_MAX_BATCH     8
    max_wait_ms     MXTPU_SERVE_MAX_WAIT_MS   5.0
    queue_limit     MXTPU_SERVE_QUEUE         256
    inflight        MXTPU_SERVE_INFLIGHT      2
    timeout_ms      MXTPU_SERVE_TIMEOUT_MS    0 (watchdog off)
    ==============  ========================  =======

    Batch models are served by the scheduler and demux threads
    (``start``); each generate model runs its own token-loop thread,
    started by ``load_model``.
    """

    #: demux-side sleep per fired ``serve.slow_model`` chaos eval — small
    #: increments so the watchdog's async StepHungError lands promptly
    SLOW_CHAOS_S = 0.05

    def __init__(self, max_batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 queue_limit: Optional[int] = None,
                 inflight: Optional[int] = None,
                 timeout_ms: Optional[float] = None,
                 start: bool = True, device=None):
        self.device = resolve_device(device)
        self.max_batch = int(max_batch if max_batch is not None
                             else _env_int("MXTPU_SERVE_MAX_BATCH", 8))
        self.max_wait_ms = float(
            max_wait_ms if max_wait_ms is not None
            else _env_float("MXTPU_SERVE_MAX_WAIT_MS", 5.0))
        self.queue_limit = int(queue_limit if queue_limit is not None
                               else _env_int("MXTPU_SERVE_QUEUE", 256))
        self.inflight = max(1, int(
            inflight if inflight is not None
            else _env_int("MXTPU_SERVE_INFLIGHT", 2)))
        timeout_ms = (timeout_ms if timeout_ms is not None
                      else _env_float("MXTPU_SERVE_TIMEOUT_MS", 0.0))
        self._timeout_s = float(timeout_ms) / 1e3
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._cond = threading.Condition()
        self._endpoints: "Dict[str, Any]" = {}
        self._running = True        # accepting submits
        self._draining = False      # flush thresholds waived
        self._closed = False
        self._started = False
        self._inflight: "_queue_mod.Queue" = _queue_mod.Queue(
            maxsize=self.inflight)
        self._sched_t: Optional[threading.Thread] = None
        self._demux_t: Optional[threading.Thread] = None
        self._batch_seq = 0
        #: in-flight batch census per dispatching model OBJECT id — a hot
        #: swap waits on it to drain v1 before freeing v1's buffers
        self._inflight_by_model: Dict[int, int] = {}
        #: scheduler-ordered (model, n_requests, bucket) log — bounded;
        #: the fairness tests and ``stats()`` read it
        self.dispatch_log: deque = deque(maxlen=4096)
        # hung-request watchdog: the guard's phase machinery, aimed at the
        # demux fetch; a trip dumps thread stacks + the flight recorder
        self._guard: Optional[TrainingGuard] = None
        if self._timeout_s > 0:
            self._guard = TrainingGuard(
                GuardPolicy(step_timeout=self._timeout_s))
            self._guard.ensure_logger()
        self._m_req = _telemetry.counter(
            "mxtpu_serve_requests_total",
            "Serving requests by model and outcome.")
        self._m_lat = _telemetry.histogram(
            "mxtpu_serve_request_seconds",
            "End-to-end request latency (submit -> response).")
        self._m_depth = _telemetry.gauge(
            "mxtpu_serve_queue_depth", "Waiting requests per model queue.")
        self._m_fill = _telemetry.gauge(
            "mxtpu_serve_bucket_fill",
            "Occupancy of the last dispatched bucket (rows/bucket).")
        self._m_batches = _telemetry.counter(
            "mxtpu_serve_batches_total",
            "Dispatched batches by model and padding bucket.")
        self._m_pad = _telemetry.counter(
            "mxtpu_serve_padded_rows_total",
            "Padding rows dispatched (bucket size minus real requests).")
        self._m_inflight = _telemetry.gauge(
            "mxtpu_serve_inflight", "Batches dispatched but not demuxed.")
        self._m_shed = _telemetry.counter(
            "mxtpu_serve_shed_total",
            "Requests shed before compute, by model and reason "
            "(deadline: queue wait alone already guaranteed the SLO "
            "miss; quota: tenant over its per-tenant queue quota).")
        self._m_swaps = _telemetry.counter(
            "mxtpu_serve_swaps_total",
            "Hot model swaps by model and outcome (ok / stage_failed / "
            "canary_failed / unsupported / lost_race).")
        self._m_state = _telemetry.gauge(
            "mxtpu_serve_model_state",
            "Self-healing ladder state per model: 0 ready, 1 "
            "rebuilding, 2 degraded (readiness flips at 2 -> /readyz).")
        self._m_compiles = _telemetry.counter(
            "mxtpu_serve_compiles_total",
            "AOT executables compiled per model (one per padding bucket "
            "at load; serving traffic never adds more).")
        self._m_model_bytes = _telemetry.gauge(
            "mxtpu_serve_model_bytes",
            "Resident parameter bytes per loaded model (int8-"
            "quantized models are ~4x smaller).")
        # generative decode serving (token loop per generate endpoint)
        self._gen_threads: List[threading.Thread] = []
        self._m_kv_slots = _telemetry.gauge(
            "mxtpu_serve_kv_slots_in_use",
            "Occupied KV-cache slots per generate model.")
        self._m_slot_wait = _telemetry.histogram(
            "mxtpu_serve_kv_slot_wait_seconds",
            "Prompt wait from submit to KV-slot admission (prefill).")
        self._m_gen_tokens = _telemetry.counter(
            "mxtpu_serve_gen_tokens_total",
            "Tokens emitted per generate model.")
        self._m_pages_in_use = _telemetry.gauge(
            "mxtpu_serve_kv_pages_in_use",
            "Referenced KV pages per paged generate model (excludes "
            "free and prefix-cached-but-unreferenced pages).")
        self._m_pages_total = _telemetry.gauge(
            "mxtpu_serve_kv_pages_total",
            "Page pool capacity per paged generate model.")
        self._m_prefix_hits = _telemetry.counter(
            "mxtpu_serve_prefix_hits_total",
            "Admissions that spliced at least one prefix-cached page.")
        self._m_prefix_tokens = _telemetry.counter(
            "mxtpu_serve_prefix_tokens_reused_total",
            "Prompt tokens served from prefix-cached pages instead of "
            "prefill compute.")
        self._m_unattr = _telemetry.counter(
            "mxtpu_serve_unattributed_seconds",
            "Request wall time not covered by any waterfall phase "
            "(attribution-closure residual), summed per model.")
        self._m_ttft = _telemetry.histogram(
            "mxtpu_serve_ttft_seconds",
            "Generative time-to-first-token (submit -> first emitted "
            "token).")
        self._m_itl = _telemetry.histogram(
            "mxtpu_serve_itl_seconds",
            "Generative inter-token latency between consecutive emitted "
            "tokens.")
        if start:
            self.start()

    # ------------------------------------------------------ request tracing
    def _trace_finish(self, model: str, tr, status: str,
                      error=None) -> None:
        """Retire one request's trace: close the waterfall, account the
        attribution residual, and hand it to the tail-sampling store. On
        a handler-deferred trace (``Trace.defer()``) this only records the
        engine's outcome — the handler closes it via
        :meth:`retire_trace`. Sits on every finish path — must never
        raise."""
        if tr is None:
            return
        try:
            tr.finish(status=status, error=error)
            self._account_trace(model, tr)
        except Exception:
            pass

    def retire_trace(self, model: str, tr, status: str = "ok",
                     error=None) -> None:
        """Close a handler-deferred trace (the engine-recorded outcome
        wins over ``status`` when both landed), then account and offer
        it exactly once. Safe on any trace; never raises."""
        if tr is None:
            return
        try:
            tr.retire(status=status, error=error)
            self._account_trace(model, tr)
        except Exception:
            pass

    def _account_trace(self, model: str, tr) -> None:
        """One-shot post-close accounting: the unattributed residual
        counter and the tail-store offer (the trace's retirement latch
        picks exactly one caller)."""
        if not tr.finished or not tr._claim_retirement():
            return
        if tr.unattributed_s:
            self._m_unattr.inc(tr.unattributed_s, model=model)
        _telemetry.trace_store().offer(tr)

    # ------------------------------------------------------------- loading
    def load_model(self, name: str, net=None, fn=None, mlir: str = None,
                   params: str = None, item_shape: Sequence[int] = None,
                   dtype="float32", buckets: Sequence[int] = None,
                   weight: float = 1.0, queue_limit: Optional[int] = None,
                   max_batch: Optional[int] = None,
                   max_wait_ms: Optional[float] = None,
                   donate: Optional[bool] = None, ctx=None,
                   quantize=None, generate=None,
                   deadline_ms: Optional[float] = None,
                   tenant_quota: Optional[int] = None,
                   degrade_after: Optional[int] = None,
                   probe_every: Optional[float] = None):
        """Load a model and return its ``Endpoint``. Exactly one of ``net``
        (a ``HybridBlock``: one captured graph a padding bucket, see
        ``_AOTBlockModel``) or ``fn`` (an ``np batch -> np outputs``
        callable) must be given; ``item_shape`` is ONE request's shape (no
        batch dim). ``buckets`` default to ``default_buckets(max_batch)``.
        ``donate`` is accepted and moot (inputs land in static buffers).
        ``ctx``, if given, must name the engine's device: a model lives on
        its engine's device. ``quantize`` (``net=`` only) converts the net
        to int8 in place before its buckets are captured: ``True``
        (dynamic ranges, no calibration), a dict of ``quantize_net``
        arguments that may hold ``fold_bn`` (fold BatchNorm first), or a
        bare calibration iterable (see ``_quantize_for_serving``).
        ``mlir=`` (an ``export()`` artifact) is ROADMAP.md A11 and raises
        ``NotImplementedError``.

        ``generate`` loads a generation endpoint instead: a dict with
        ``params`` (transformer parameters in the port's layout, e.g. from
        ``models.transformer.params_from_jax``) and ``cfg``
        (``models.transformer.TransformerConfig``), plus optional
        ``slots`` / ``max_len`` / ``block`` / ``buckets`` (prompt padding
        buckets) / ``eos_id`` / ``max_new_tokens`` / ``paged`` /
        ``page_len`` / ``pages`` / ``prefix_cache`` / ``prefill_chunk``
        overriding the ``MXTPU_SERVE_GEN_*`` env family. Returns a
        ``GenerativeEndpoint`` whose ``submit(prompt)`` streams tokens
        through a ``GenerationFuture``. Parameters are moved to the
        engine's device.

        **Hot swap** — ``load_model`` with the name of an already-loaded
        batch model stages the new version (every bucket captured) and
        canaries it against the live one (``MXTPU_SERVE_SWAP_CANARY=0``
        skips the canary), then flips the route atomically under the
        engine lock; the old version's in-flight batches drain through
        its own graphs, and it is released. A failed stage or canary
        raises ``SwapError`` with the old version still serving,
        untouched. The endpoint object, its queue and its scheduling
        config survive the swap; ``Endpoint.version`` increments.
        Generate endpoints do not hot-swap — unload first
        (``SwapError``)."""
        if generate is not None:
            if any(x is not None for x in (net, fn, mlir)):
                raise ValueError(
                    "generate= is exclusive with net=/fn=/mlir=")
            if self._endpoints.get(name) is not None:
                self._m_swaps.inc(1, model=name, outcome="unsupported")
                raise SwapError(
                    f"model {name!r} is already loaded and generate "
                    "endpoints do not hot-swap (live KV state) — "
                    "unload() first")
            return self._load_generate(name, generate, weight=weight,
                                       queue_limit=queue_limit)
        if sum(x is not None for x in (net, fn, mlir)) != 1:
            raise ValueError("pass exactly one of net=, fn=, mlir=")
        if quantize is not None and quantize is not False and net is None:
            raise ValueError("quantize= applies to net= models only")
        if mlir is not None:
            raise NotImplementedError(
                "load_model(mlir=...): serving an export() artifact needs "
                "the symbolic slice's export and _StableHLOBlock "
                "(ROADMAP.md A11), not ported yet")
        if ctx is not None and resolve_device(
                getattr(ctx, "torch_device", ctx)) != self.device:
            raise ValueError(
                f"load_model(ctx={ctx!r}): a model is served on its "
                f"engine's device, {self.device}")
        mb = int(max_batch if max_batch is not None else self.max_batch)
        if buckets is None:
            buckets = default_buckets(mb)

        def build():
            """Stage the model: for net= this captures every bucket.
            Deferred so a hot swap can stage v2 while v1 keeps serving
            and roll back on failure."""
            if item_shape is None:
                raise ValueError(
                    f"{'net' if net is not None else 'fn'}= needs "
                    "item_shape=")
            if net is not None:
                nn = net
                if quantize is not None and quantize is not False:
                    nn = _quantize_for_serving(net, quantize)
                # a slot for each batch the in-flight queue holds, the one
                # being demuxed, the one dispatched and waiting for room,
                # and a canary's
                return _AOTBlockModel(nn, tuple(item_shape), dtype,
                                      buckets, name=name,
                                      device=self.device,
                                      slots=self.inflight + 3)
            return _CallableModel(fn, tuple(item_shape), dtype, buckets)

        existing = self._endpoints.get(name)
        if existing is not None:
            return self._swap_model(name, existing, build)
        model = build()
        ep = Endpoint(self, name, model, weight,
                      queue_limit if queue_limit is not None
                      else self.queue_limit, mb,
                      max_wait_ms if max_wait_ms is not None
                      else self.max_wait_ms, deadline_ms=deadline_ms,
                      tenant_quota=tenant_quota,
                      degrade_after=degrade_after,
                      probe_every=probe_every)
        with self._cond:
            if self._closed or not self._running:
                raise EngineClosedError("engine is shut down")
            if name in self._endpoints:
                raise ValueError(f"model {name!r} already loaded")
            self._endpoints[name] = ep
        self._m_state.set(0, model=name)
        if getattr(model, "model_bytes", None) is not None:
            self._m_model_bytes.set(model.model_bytes, model=name)
        return ep

    # ------------------------------------------------------------ hot swap
    def _canary(self, name: str, old_model, new_model) -> None:
        """Stage gate: run an all-zeros batch of each version's smallest
        bucket through the staged version and the live one, and require
        structural parity — same output count, per-row shapes and dtypes,
        and finite staged outputs. Values are NOT compared (the weights
        changed; that is the point of the swap). Raises on any
        mismatch."""
        chaos.maybe_fail("serve.swap_fail", ServeError)
        new_h = _zeros_batch(new_model)
        old_h = _zeros_batch(old_model)
        if len(new_h) != len(old_h):
            raise ServeError(
                f"canary: staged version returns {len(new_h)} outputs, "
                f"live returns {len(old_h)}")
        for i, (nh, oh) in enumerate(zip(new_h, old_h)):
            if nh.shape[1:] != oh.shape[1:] or nh.dtype != oh.dtype:
                raise ServeError(
                    f"canary: output {i} row shape/dtype changed: "
                    f"{nh.shape[1:]}/{nh.dtype} vs live "
                    f"{oh.shape[1:]}/{oh.dtype}")
            if _np.issubdtype(nh.dtype, _np.floating) and \
                    not _np.all(_np.isfinite(nh)):
                raise ServeError(
                    f"canary: staged version output {i} is non-finite "
                    "on the probe batch")

    def _swap_model(self, name: str, old_ep, build) -> "Endpoint":
        """Zero-downtime versioned swap: stage -> canary -> atomic route
        flip -> drain v1's in-flight batches -> release v1. Any failure
        before the flip raises ``SwapError`` with v1 untouched and still
        serving. Called from ``load_model`` (the caller's thread — the
        scheduler keeps dispatching v1 throughout the stage)."""
        if isinstance(old_ep, GenerativeEndpoint):
            self._m_swaps.inc(1, model=name, outcome="unsupported")
            raise SwapError(
                f"model {name!r} is a generate endpoint and does not "
                "hot-swap (live KV state) — unload() first")
        v_old, v_new = old_ep.version, old_ep.version + 1
        with _telemetry.span("swap", model=name, version=v_new):
            old_model = old_ep.model
            try:
                new_model = build()
            except BaseException as e:
                self._m_swaps.inc(1, model=name, outcome="stage_failed")
                raise SwapError(
                    f"swap {name!r} v{v_old}->v{v_new}: stage failed "
                    f"({e}); v{v_old} untouched and still serving") from e
            if tuple(new_model.item_shape) != tuple(old_model.item_shape) \
                    or new_model.dtype != old_model.dtype:
                self._m_swaps.inc(1, model=name, outcome="stage_failed")
                raise SwapError(
                    f"swap {name!r} v{v_old}->v{v_new}: request contract "
                    f"changed (item shape {new_model.item_shape}/"
                    f"{new_model.dtype} vs {old_model.item_shape}/"
                    f"{old_model.dtype}) — queued requests could not "
                    f"carry over; v{v_old} untouched and still serving")
            if _env_int("MXTPU_SERVE_SWAP_CANARY", 1):
                try:
                    with _telemetry.span("canary", model=name,
                                         version=v_new):
                        self._canary(name, old_model, new_model)
                except BaseException as e:
                    self._m_swaps.inc(1, model=name,
                                      outcome="canary_failed")
                    raise SwapError(
                        f"swap {name!r} v{v_old}->v{v_new}: canary "
                        f"failed ({e}); v{v_old} untouched and still "
                        "serving") from e
            # atomic flip: same Endpoint object — queued requests carry
            # over; batches already dispatched drain to old_model (the
            # demux fetches from the model captured at dispatch)
            with self._cond:
                if self._endpoints.get(name) is not old_ep:
                    self._m_swaps.inc(1, model=name, outcome="lost_race")
                    raise SwapError(
                        f"swap {name!r}: endpoint was unloaded while "
                        "the new version was staging")
                old_ep.model = new_model
                old_ep.buckets = new_model.buckets
                old_ep.fill = min(old_ep.max_batch, new_model.buckets[-1])
                old_ep.version = v_new
                # fresh graphs: the failure ladder restarts
                old_ep.fail_streak = 0
                old_ep.state = "ready"
                self._cond.notify_all()
            self._m_state.set(0, model=name)
            # drain: wait until no in-flight batch still references v1
            deadline = time.perf_counter() + 30.0
            with self._cond:
                while self._inflight_by_model.get(id(old_model), 0) > 0:
                    left = deadline - time.perf_counter()
                    if left <= 0:
                        break
                    self._cond.wait(left)
            release = getattr(old_model, "release", None)
            if release is not None:
                release()
            self._m_swaps.inc(1, model=name, outcome="ok")
            if getattr(new_model, "model_bytes", None) is not None:
                self._m_model_bytes.set(new_model.model_bytes, model=name)
        return old_ep

    def _load_generate(self, name: str, spec, weight: float = 1.0,
                       queue_limit: Optional[int] = None
                       ) -> GenerativeEndpoint:
        spec = dict(spec)
        params = spec.pop("params", None)
        cfg = spec.pop("cfg", None)
        if params is None or cfg is None:
            raise ValueError("generate= needs 'params' and 'cfg'")
        slots = int(spec.pop("slots",
                             _env_int("MXTPU_SERVE_GEN_SLOTS", 8)))
        cache_len = int(spec.pop("max_len",
                                 _env_int("MXTPU_SERVE_GEN_MAX_LEN", 512)))
        block = int(spec.pop("block",
                             _env_int("MXTPU_SERVE_GEN_BLOCK", 64)))
        eos_id = spec.pop("eos_id", None)
        max_new = int(spec.pop("max_new_tokens",
                               _env_int("MXTPU_SERVE_GEN_MAX_TOKENS", 64)))
        buckets = spec.pop("buckets", None)
        paged = bool(int(spec.pop("paged",
                                  _env_int("MXTPU_SERVE_GEN_PAGED", 1))))
        page_len = int(spec.pop("page_len",
                                _env_int("MXTPU_SERVE_GEN_PAGE_LEN", 0)))
        n_pages = int(spec.pop("pages",
                               _env_int("MXTPU_SERVE_GEN_PAGES", 0)))
        prefix_cache = bool(int(spec.pop(
            "prefix_cache", _env_int("MXTPU_SERVE_GEN_PREFIX_CACHE", 1))))
        prefill_chunk = int(spec.pop(
            "prefill_chunk", _env_int("MXTPU_SERVE_GEN_PREFILL_CHUNK", 0)))
        if spec:
            raise ValueError(f"unknown generate= keys {sorted(spec)}")
        if slots < 1 or block < 1 or max_new < 1:
            raise ValueError("slots, block and max_new_tokens must be >= 1")
        if not paged and prefill_chunk:
            # chunked prefill is a block-table feature; the dense engine
            # has no per-chunk write path
            raise ValueError(
                "prefill_chunk requires the paged engine (paged=1)")
        if buckets is None:
            buckets = default_gen_buckets(cache_len)
        model = _GenerativeModel(
            params, cfg, slots=slots, cache_len=cache_len, block=block,
            buckets=buckets, eos_id=eos_id, max_new_tokens=max_new,
            name=name, paged=paged, page_len=page_len or None,
            n_pages=n_pages or None, device=self.device)
        ep = GenerativeEndpoint(self, name, model, weight,
                                queue_limit if queue_limit is not None
                                else self.queue_limit)
        if paged:
            ep.pool = _PagePool(model.n_pages, model.page_len)
            ep.prefix_cache = prefix_cache
            # a chunk is padded to a prompt bucket: cap at the largest
            # bucket, and round to whole pages so chunk boundaries stay
            # page-aligned
            if prefill_chunk:
                if model.page_len > model.buckets[-1]:
                    raise ValueError(
                        f"prefill_chunk requires page_len "
                        f"({model.page_len}) <= the largest prompt "
                        f"bucket ({model.buckets[-1]})")
                ep.prefill_chunk = max(
                    model.page_len,
                    min(int(prefill_chunk), model.buckets[-1])
                    // model.page_len * model.page_len)
            self._m_pages_total.set(model.n_pages, model=name)
            self._m_pages_in_use.set(0, model=name)
        with self._cond:
            if self._closed or not self._running:
                raise EngineClosedError("engine is shut down")
            if name in self._endpoints:
                raise ValueError(f"model {name!r} already loaded")
            self._endpoints[name] = ep
        self._m_model_bytes.set(model.model_bytes, model=name)
        t = threading.Thread(target=self._gen_loop, args=(ep,),
                             name=f"mxtpu-serve-gen-{name}", daemon=True)
        self._gen_threads.append(t)
        t.start()
        return ep

    # ------------------------------------------------------ generation loop
    def _submit_gen(self, ep: GenerativeEndpoint, prompt,
                    max_new_tokens: Optional[int],
                    temperature: float = 0.0, top_k: int = 0,
                    top_p: float = 0.0, seed: int = 0,
                    deadline_ms: Optional[float] = None,
                    trace=None) -> GenerationFuture:
        tr = trace if trace is not None else _telemetry.Trace(
            "generate", model=ep.name)
        try:
            return self._submit_gen_inner(
                ep, prompt, max_new_tokens, temperature, top_k, top_p,
                seed, deadline_ms, tr)
        except BaseException as e:
            if getattr(e, "trace_id", None) is None:
                try:
                    e.trace_id = tr.trace_id
                except Exception:
                    pass
            self._trace_finish(ep.name, tr, "rejected", error=e)
            raise

    def _submit_gen_inner(self, ep: GenerativeEndpoint, prompt,
                          max_new_tokens: Optional[int],
                          temperature: float, top_k: int,
                          top_p: float, seed: int,
                          deadline_ms: Optional[float],
                          tr) -> GenerationFuture:
        if isinstance(prompt, torch.Tensor):
            prompt = prompt.detach().cpu().numpy()
        arr = _np.ascontiguousarray(_np.asarray(prompt, dtype=_np.int32))
        temperature = float(temperature)
        top_p = float(top_p)
        top_k, seed = int(top_k), int(seed)
        if temperature < 0 or not _np.isfinite(temperature):
            raise ValueError(
                f"temperature must be finite and >= 0 (0 = greedy), "
                f"got {temperature}")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = full vocab), "
                             f"got {top_k}")
        if not (0.0 <= top_p <= 1.0):
            raise ValueError(f"top_p must be in [0, 1] (0 = nucleus "
                             f"off), got {top_p}")
        if arr.ndim != 1 or arr.size < 1:
            raise ValueError(
                f"model {ep.name!r} expects ONE 1-D prompt of token ids, "
                f"got shape {arr.shape} (batching is the engine's job)")
        model = ep.model
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else model.max_new_tokens)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if model.bucket_for(len(arr)) is None:
            raise ValueError(
                f"prompt of {len(arr)} tokens exceeds the largest padding "
                f"bucket {model.buckets[-1]} of model {ep.name!r}")
        vocab = int(model.cfg.vocab_size)
        if int(arr.min()) < 0 or int(arr.max()) >= vocab:
            # an out-of-range id would index past the embedding table
            raise ValueError(
                f"prompt token ids must be in [0, {vocab}) for model "
                f"{ep.name!r}; got range [{arr.min()}, {arr.max()}]")
        if len(arr) + max_new > model.cache_len:
            raise ValueError(
                f"prompt ({len(arr)}) + max_new_tokens ({max_new}) "
                f"exceeds the KV cache extent {model.cache_len} — raise "
                "max_len (MXTPU_SERVE_GEN_MAX_LEN) or trim the request")
        if model.paged:
            need = -(-(len(arr) + max_new) // model.page_len)
            if need > model.n_pages:
                # permanent infeasibility: typed backpressure at submit
                # time, not a wedge at admission time
                raise PagesExhaustedError(
                    f"prompt ({len(arr)}) + max_new_tokens ({max_new}) "
                    f"needs {need} KV pages but the pool has only "
                    f"{model.n_pages} — raise pages "
                    "(MXTPU_SERVE_GEN_PAGES) or trim the request")
        with tr.span("enqueue", n=int(arr.size), max_new=max_new), \
                _telemetry.span("enqueue", model=ep.name):
            forced_full = chaos.should_fail("serve.queue_full")
            with self._cond, tr.span("admission"):
                if self._closed or not self._running:
                    raise EngineClosedError("engine is shut down")
                if self._endpoints.get(ep.name) is not ep:
                    raise EngineClosedError(
                        f"model {ep.name!r} was unloaded")
                if forced_full or len(ep._queue) >= ep.queue_limit:
                    self._m_req.inc(1, model=ep.name, outcome="rejected")
                    raise QueueFullError(
                        f"model {ep.name!r}: queue full "
                        f"({len(ep._queue)}/{ep.queue_limit}) — all "
                        f"{model.slots} KV slots busy and the wait queue "
                        "is at capacity; retry with backoff"
                        + (" [chaos]" if forced_full else ""))
                fut = GenerationFuture()
                fut.trace = tr
                dl_ms = float(deadline_ms or 0.0)
                ep._queue.append(_GenRequest(
                    arr, max_new, fut, temperature=temperature,
                    top_k=top_k, top_p=top_p, seed=seed,
                    deadline=(fut.t_submit + dl_ms / 1e3
                              if dl_ms > 0 else None), trace=tr))
                self._m_depth.set(len(ep._queue), model=ep.name)
                self._cond.notify_all()
        return fut

    def _finish_gen(self, ep: GenerativeEndpoint, slot: _GenSlot,
                    outcome: str, error=None) -> None:
        # pages go back to the pool FIRST and unconditionally —
        # release_slot is idempotent and a dummy slot carries no pages,
        # so no retirement path can leak a page
        if ep.pool is not None:
            ep.pool.release_slot(slot)
        fut = slot.req.future
        if fut.done():
            return
        tr = slot.req.trace
        if error is not None and tr is not None:
            try:                        # error responses name their trace
                error.trace_id = tr.trace_id
            except Exception:
                pass
        if outcome == "aborted":
            fut.cancel()
            fut._set_exception(
                RequestAborted("client went away mid-generation"))
        elif error is not None:
            fut._set_exception(error)
        else:
            fut._set_result()
        self._m_req.inc(1, model=ep.name, outcome=outcome)
        self._m_lat.observe(
            time.perf_counter() - fut.t_submit,
            exemplar=({"trace_id": tr.trace_id} if tr is not None
                      else None),
            model=ep.name, outcome=outcome)
        if tr is not None:
            if slot.dec_acc_n:      # flush the pending decode aggregate
                tr.observe("decode", slot.dec_acc_s,
                           tokens=slot.dec_acc_n,
                           last_token=len(fut._tokens))
                slot.dec_acc_s, slot.dec_acc_n = 0.0, 0
            tr.observe("retire", 0.0, reason=outcome)
            self._trace_finish(ep.name, tr, outcome, error=error)

    def _gen_loop(self, ep: GenerativeEndpoint) -> None:
        """Iteration-level scheduler for ONE generate model: each loop
        turn admits waiting prompts into free KV slots, advances one
        prefill chunk per filling slot, runs one fixed-shape decode step
        over every decode-ready slot, streams the emitted tokens, and
        retires finished/aborted slots — so requests join and leave the
        decode batch every token, and (chunked prefill) a long prompt
        never stalls in-flight decodes for more than one chunk.

        Paged engine: admission is additionally gated on the page pool —
        a prompt is admitted only when its WORST-CASE page need (prompt
        + full token budget) fits ``available - reserved``, and that
        need is reserved up front, so a live generation can never hit
        exhaustion mid-flight. Head-of-line order is kept: when the
        head prompt cannot reserve, nothing behind it is admitted."""
        model = ep.model
        S = model.slots
        P = model.page_len if model.paged else 0
        pool = ep.pool
        slots: List[Optional[_GenSlot]] = [None] * S
        drain_cap = _env_int("MXTPU_SERVE_GEN_DRAIN_TOKENS", 8)
        capped = False

        def census() -> int:
            n = sum(1 for s in slots if s is not None)
            ep.slots_in_use = n
            self._m_kv_slots.set(n, model=ep.name)
            if pool is not None:
                self._m_pages_in_use.set(pool.in_use(), model=ep.name)
            return n

        def fail_all_live(e) -> None:
            """The live slots' K/V are gone: fail them all; the prefix
            index names lost pages now, so it must flush too."""
            for j, s2 in enumerate(slots):
                if s2 is not None:
                    self._finish_gen(ep, s2, "error", error=e)
                    slots[j] = None
            if pool is not None:
                pool.flush_index()

        while True:
            admit: List[Tuple[int, _GenRequest, int]] = []
            rejects: List[_GenRequest] = []
            sheds: List[_GenRequest] = []
            unloaded = closing = False
            with self._cond:
                while True:
                    unloaded = self._endpoints.get(ep.name) is not ep
                    closing = self._closed
                    if unloaded or closing:
                        # shutdown/unload: no new admissions, fail the
                        # wait queue (whether live slots then drain or
                        # fail too is decided below from the flags)
                        rejects.extend(ep._queue)
                        ep._queue.clear()
                        break
                    # deadline shed BEFORE a KV slot is spent
                    now = time.perf_counter()
                    expired = [r for r in ep._queue
                               if r.deadline is not None
                               and now >= r.deadline]
                    if expired:
                        sheds.extend(expired)
                        gone = {id(r) for r in expired}
                        ep._queue = deque(
                            r for r in ep._queue if id(r) not in gone)
                    free = [i for i, s in enumerate(slots) if s is None]
                    while free and ep._queue:
                        r = ep._queue[0]
                        if r.future.cancelled():
                            ep._queue.popleft()
                            rejects.append(r)   # aborted while waiting
                            continue
                        need = 0
                        if pool is not None:
                            need = -(-(len(r.prompt) + r.max_new) // P)
                            if not pool.can_admit(need):
                                # head-of-line waits for pages (an idle
                                # pool has reserved == 0 and every page
                                # available, and feasible-alone was
                                # checked at submit)
                                break
                            pool.reserve(need)
                        ep._queue.popleft()
                        admit.append((free.pop(0), r, need))
                    self._m_depth.set(len(ep._queue), model=ep.name)
                    # rejects must break too: a request cancelled while
                    # queued on an otherwise idle endpoint has to be
                    # resolved NOW, not at the next unrelated wake-up
                    if admit or rejects or sheds \
                            or any(s is not None for s in slots):
                        break
                    self._cond.wait()
            for r in sheds:
                self._m_shed.inc(1, model=ep.name, reason="deadline")
                if r.trace is not None:
                    r.trace.observe("slot_wait",
                                    time.perf_counter() - r.t_enq)
                    r.trace.observe("shed", 0.0, reason="deadline")
                self._finish_gen(
                    ep, _GenSlot(r, 0, 0, 0), "shed",
                    error=DeadlineError(
                        f"model {ep.name!r}: prompt shed before prefill "
                        f"— queued "
                        f"{(time.perf_counter() - r.t_enq) * 1e3:.1f}ms, "
                        "past its deadline"))
            for r in rejects:
                if r.future.cancelled():
                    self._finish_gen(ep, _GenSlot(r, 0, 0, 0), "aborted")
                else:
                    self._finish_gen(
                        ep, _GenSlot(r, 0, 0, 0), "cancelled",
                        error=EngineClosedError(
                            f"model {ep.name!r} "
                            + ("unloaded" if unloaded else
                               "closed before the prompt was admitted")))
            if unloaded or (closing and not self._draining):
                for i, s in enumerate(slots):
                    if s is not None:
                        self._finish_gen(ep, s, "cancelled",
                                         error=EngineClosedError(
                                             "engine closed mid-generation "
                                             "(drain disabled)"))
                        slots[i] = None
                census()
                return
            if closing and not capped:
                # bound the drain: every live generation may emit at most
                # drain_cap more tokens, then the loop exits
                capped = True
                for s in slots:
                    if s is not None:
                        s.remaining = min(s.remaining, drain_cap)
            # ---- admissions: claim a slot (and pages) ------------------
            for slot_i, r, need in admit:
                n = len(r.prompt)
                bucket = model.bucket_for(n)
                tr = r.trace
                wait = time.perf_counter() - r.t_enq
                self._m_slot_wait.observe(wait, model=ep.name)
                if tr is not None:
                    tr.annotate(version=1)
                    tr.observe("slot_wait", wait, slot=slot_i)
                if pool is None:
                    # contiguous engine: synchronous one-shot prefill
                    # into the slot's dense cache row
                    try:
                        with (tr.attach() if tr is not None
                              else contextlib.nullcontext()), \
                                _telemetry.span(
                                    "prefill", model=ep.name,
                                    bucket=bucket, n=n, version=1):
                            first = model.prefill(
                                r.prompt, slot_i,
                                temperature=r.temperature,
                                top_k=r.top_k, top_p=r.top_p,
                                seed=r.seed)
                    except BaseException as e:
                        self._finish_gen(ep, _GenSlot(r, 0, 0, 0),
                                         "error", error=e)
                        if model.recover():
                            fail_all_live(e)
                        continue
                    slot = _GenSlot(r, pos=n, remaining=r.max_new,
                                    last_tok=first)
                    slot.fill_next = n
                    slots[slot_i] = slot
                    ep.admit_log.append((n, bucket, census()))
                    self._emit_token(ep, slots, slot_i, first)
                    continue
                # paged engine: splice prefix-cached pages, allocate the
                # rest of the prompt extent against the reservation;
                # prefill itself runs in the chunk section below
                slot = _GenSlot(r, pos=n, remaining=r.max_new,
                                last_tok=-1)
                slot.reserved = need
                reused = 0
                try:
                    if ep.prefix_cache:
                        t_sp = time.perf_counter()
                        # cap reuse so >= 1 tail token always prefills
                        # (the final chunk produces first-token logits)
                        for key in _prefix_page_keys(r.prompt, P,
                                                     (n - 1) // P):
                            pid = pool.lookup(key)
                            if pid is None:
                                break
                            pool.incref(pid)
                            slot.pages.append(pid)
                            reused += 1
                        if reused:
                            pool.unreserve(reused)
                            slot.reserved -= reused
                            self._m_prefix_hits.inc(1, model=ep.name)
                            self._m_prefix_tokens.inc(reused * P,
                                                      model=ep.name)
                        if tr is not None:
                            tr.observe("prefix_splice",
                                       time.perf_counter() - t_sp,
                                       hit_pages=reused,
                                       tokens_reused=reused * P)
                    t_pc = time.perf_counter()
                    while len(slot.pages) * P < n:
                        slot.pages.append(pool.alloc_reserved())
                        slot.reserved -= 1
                    if tr is not None:
                        tr.observe("page_claim",
                                   time.perf_counter() - t_pc,
                                   need=need, pages=len(slot.pages))
                except BaseException as e:
                    # fails THIS request, not the endpoint: _finish_gen's
                    # release_slot returns what was claimed so far
                    self._finish_gen(ep, slot, "error", error=e)
                    continue
                slot.fill_next = reused * P
                slots[slot_i] = slot
                ep.admit_log.append((n, bucket, census()))
            # ---- prefill work: ONE chunk per filling slot per turn ----
            for i, s in enumerate(slots):
                if s is None or pool is None \
                        or s.fill_next >= len(s.req.prompt):
                    continue
                n = len(s.req.prompt)
                rest = n - s.fill_next
                take = min(ep.prefill_chunk, rest) if ep.prefill_chunk \
                    else rest
                final = s.fill_next + take >= n
                span_name = ("prefill_chunk" if ep.prefill_chunk
                             else "prefill")
                chunk_sz = ep.prefill_chunk or n
                tr = s.req.trace
                try:
                    with (tr.attach() if tr is not None
                          else contextlib.nullcontext()), \
                            _telemetry.span(
                                span_name, model=ep.name,
                                bucket=model.bucket_for(take), n=take,
                                chunk=s.fill_next // chunk_sz + 1,
                                chunks=-(-n // chunk_sz), version=1):
                        tok = model.prefill_chunk(
                            s.req.prompt[s.fill_next:s.fill_next + take],
                            s.pages, s.fill_next, n,
                            temperature=s.req.temperature,
                            top_k=s.req.top_k, top_p=s.req.top_p,
                            seed=s.req.seed)
                except BaseException as e:
                    self._finish_gen(ep, s, "error", error=e)
                    slots[i] = None
                    if model.recover():
                        fail_all_live(e)
                    continue
                s.fill_next += take
                s.t_emit = time.perf_counter()  # ITL baseline: chunk end
                if final:
                    if ep.prefix_cache:
                        # publish the now-frozen full prompt-prefix
                        # pages (no-op for spliced ones, already listed)
                        for ki, key in enumerate(
                                _prefix_page_keys(s.req.prompt, P,
                                                  n // P)):
                            pool.register(key, s.pages[ki])
                    s.last_tok = tok
                    self._emit_token(ep, slots, i, tok)
            # ---- abort sweep: freed the same iteration -----------------
            for i, s in enumerate(slots):
                if s is None:
                    continue
                if not s.req.future.cancelled() and \
                        chaos.should_fail("serve.client_abort"):
                    s.req.future.cancel()
                if s.req.future.cancelled():
                    self._finish_gen(ep, s, "aborted")
                    slots[i] = None
            # ---- one decode step over every decode-ready slot ----------
            live = [i for i, s in enumerate(slots)
                    if s is not None and s.fill_next >= len(s.req.prompt)]
            if not live:
                census()
                if closing:
                    if any(s is not None for s in slots):
                        continue    # mid-prefill: drain them too
                    return
                continue
            tokens = _np.zeros((S,), _np.int64)
            positions = _np.zeros((S,), _np.int64)
            temps = _np.zeros((S,), _np.float32)
            topks = _np.zeros((S,), _np.int64)
            topps = _np.zeros((S,), _np.float32)
            seeds = _np.zeros((S,), _np.int64)
            bts = None
            if pool is not None:
                # block tables: real rows ONLY for decode-ready slots —
                # every other row is all-trash, so dead/filling rows'
                # fixed-shape writes land in the trash page
                bts = _np.full((S, model.max_pages), pool.trash,
                               _np.int32)
            for i in live:
                s = slots[i]
                tokens[i] = s.last_tok
                positions[i] = s.pos
                temps[i] = s.req.temperature
                topks[i] = s.req.top_k
                topps[i] = s.req.top_p
                seeds[i] = s.req.seed
            try:
                if pool is not None:
                    for i in live:
                        s = slots[i]
                        if s.pos // P >= len(s.pages):
                            # this step writes into a new page: draw it
                            # from the slot's standing reservation
                            s.pages.append(pool.alloc_reserved())
                            s.reserved -= 1
                        bts[i, :len(s.pages)] = s.pages
                with _telemetry.span("decode_step", model=ep.name,
                                     occupancy=len(live)):
                    nxt = model.decode(tokens, positions, temps, topks,
                                       topps, seeds, block_tables=bts)
            except BaseException as e:
                for i in live:
                    self._finish_gen(ep, slots[i], "error", error=e)
                    slots[i] = None
                if model.recover() and pool is not None:
                    fail_all_live(e)
                census()            # so the endpoint keeps serving
                continue
            for i in live:
                s = slots[i]
                s.pos += 1
                s.last_tok = int(nxt[i])
                self._emit_token(ep, slots, i, s.last_tok)
            census()

    def _emit_token(self, ep: GenerativeEndpoint,
                    slots: List[Optional[_GenSlot]], slot_i: int,
                    tok: int) -> None:
        """Stream one emitted token; retire the slot on EOS or an
        exhausted token budget. Each emission lands a live latency
        sample: TTFT on the first token, ITL on every later one, plus a
        per-token ``decode`` span in the request's trace."""
        s = slots[slot_i]
        fut = s.req.future
        now = time.perf_counter()
        first = fut.t_first is None
        fut._put_token(tok)
        self._m_gen_tokens.inc(1, model=ep.name)
        tr = s.req.trace
        if first:
            self._m_ttft.observe(
                now - fut.t_submit,
                exemplar=({"trace_id": tr.trace_id} if tr is not None
                          else None),
                model=ep.name)
        else:
            self._m_itl.observe(now - s.t_emit, model=ep.name)
        if tr is not None:
            # the sample tiles the window since the previous emission (or
            # the prefill end); past the per-token detail window, samples
            # aggregate N-per-span so long generations keep their full
            # waterfall inside the trace's span budget
            k = len(fut._tokens)
            if k <= _DECODE_SPAN_DETAIL:
                tr.observe("decode", now - s.t_emit, token=k)
            else:
                s.dec_acc_s += now - s.t_emit
                s.dec_acc_n += 1
                if s.dec_acc_n >= _DECODE_SPAN_AGG:
                    tr.observe("decode", s.dec_acc_s,
                               tokens=s.dec_acc_n, last_token=k)
                    s.dec_acc_s, s.dec_acc_n = 0.0, 0
        s.t_emit = now
        s.remaining -= 1
        if (ep.model.eos_id is not None and tok == ep.model.eos_id) \
                or s.remaining <= 0 \
                or s.pos >= ep.model.cache_len:
            self._finish_gen(ep, s, "ok")
            slots[slot_i] = None

    def unload(self, name: str) -> None:
        """Remove an endpoint; its waiting requests fail with
        ``EngineClosedError``."""
        with self._cond:
            ep = self._endpoints.pop(name, None)
            if isinstance(ep, GenerativeEndpoint):
                # its token loop fails the wait queue + live slots itself
                self._cond.notify_all()
                return
            pending = list(ep._queue) if ep else []
            if ep:
                ep._queue.clear()
        for r in pending:
            self._finish(ep, r, error=EngineClosedError(
                f"model {name!r} unloaded"), outcome="cancelled")

    def endpoint(self, name: str):
        return self._endpoints[name]

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        """Start the scheduler + demux threads (idempotent). Constructed
        with ``start=False``, an engine queues submits without serving —
        the deterministic-ordering test hook."""
        with self._cond:
            if self._started or self._closed:
                return
            self._started = True
        self._sched_t = threading.Thread(
            target=self._sched_loop, name="mxtpu-serve-sched", daemon=True)
        self._demux_t = threading.Thread(
            target=self._demux_loop, name="mxtpu-serve-demux", daemon=True)
        self._sched_t.start()
        self._demux_t.start()

    def close(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Graceful shutdown: stop accepting, then (with ``drain``) flush
        every queue — deadline/fill thresholds waived — before joining
        both threads and the watchdog. ``drain=False`` fails waiting
        requests with ``EngineClosedError`` instead. Idempotent."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._running = False
            self._draining = bool(drain)
            self._cond.notify_all()
        sched_stuck = False
        if self._sched_t is not None:
            self._sched_t.join(timeout=timeout)
            sched_stuck = self._sched_t.is_alive()
        # token loops drain themselves: live generations finish under the
        # MXTPU_SERVE_GEN_DRAIN_TOKENS cap, queued prompts fail cleanly
        for t in self._gen_threads:
            t.join(timeout=timeout)
        # scheduler is parked: release anything it never dispatched
        with self._cond:
            leftovers = [(ep, r) for ep in self._endpoints.values()
                         for r in ep._queue
                         if not isinstance(ep, GenerativeEndpoint)]
            for ep in self._endpoints.values():
                if not isinstance(ep, GenerativeEndpoint):
                    ep._queue.clear()
        for ep, r in leftovers:
            self._finish(ep, r, error=EngineClosedError(
                "engine closed before the request was served"),
                outcome="cancelled")
        if sched_stuck:
            # a dispatch is blocked inside the scheduler (a sync model fn
            # or a wedged device): the sentinel could overtake its batch
            # and orphan those futures — leave the (daemon) demux running
            # to drain whatever eventually lands instead
            import logging
            logging.getLogger(__name__).warning(
                "serving: scheduler did not exit within %gs; demux left "
                "running to drain in-flight batches", timeout)
            return
        self._inflight.put(None)        # demux sentinel (after scheduler)
        if self._demux_t is not None:
            self._demux_t.join(timeout=timeout)
        if self._guard is not None:
            self._guard.close()

    def __enter__(self) -> "InferenceEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --------------------------------------------------------------- submit
    def _submit(self, ep: Endpoint, data,
                deadline_ms: Optional[float] = None,
                tenant: Optional[str] = None,
                priority: int = 0, trace=None) -> ResponseFuture:
        tr = trace if trace is not None else _telemetry.Trace(
            "predict", model=ep.name)
        try:
            return self._submit_locked_path(ep, data, deadline_ms, tenant,
                                            priority, tr)
        except BaseException as e:
            # a rejected request still gets a trace id (the HTTP layer
            # returns it on the error response) and its trace is always
            # retained — rejections are never sampled out
            if getattr(e, "trace_id", None) is None:
                try:
                    e.trace_id = tr.trace_id
                except Exception:
                    pass
            status = ("shed" if isinstance(e, DeadlineError)
                      else "degraded" if isinstance(e, ModelDegradedError)
                      else "rejected")
            self._trace_finish(ep.name, tr, status, error=e)
            raise

    def _submit_locked_path(self, ep: Endpoint, data,
                            deadline_ms: Optional[float],
                            tenant: Optional[str], priority: int,
                            tr) -> ResponseFuture:
        if isinstance(data, torch.Tensor):
            data = data.detach().cpu().numpy()
        arr = data.asnumpy() if hasattr(data, "asnumpy") else data
        arr = _np.ascontiguousarray(_np.asarray(arr, dtype=ep.model.dtype))
        if arr.shape != ep.model.item_shape:
            raise ValueError(
                f"model {ep.name!r} expects one request of shape "
                f"{ep.model.item_shape}, got {arr.shape} (batching is the "
                "engine's job — submit single items)")
        dl_ms = float(deadline_ms if deadline_ms is not None
                      else ep.deadline_ms)
        with tr.span("enqueue"), \
                _telemetry.span("enqueue", model=ep.name):
            # chaos check outside the engine lock (it takes its own lock
            # and mirrors into telemetry)
            forced_full = chaos.should_fail("serve.queue_full")
            with self._cond, tr.span("admission", tenant=tenant or ""):
                if self._closed or not self._running:
                    raise EngineClosedError("engine is shut down")
                if self._endpoints.get(ep.name) is not ep:
                    raise EngineClosedError(
                        f"model {ep.name!r} was unloaded")
                if ep.state == "degraded":
                    # ladder fast-fail: never queue into a black hole
                    self._m_req.inc(1, model=ep.name, outcome="degraded")
                    raise ModelDegradedError(
                        f"model {ep.name!r} v{ep.version} is degraded "
                        f"after {ep.degrade_after} consecutive dispatch "
                        f"failures (last: {ep._degrade_err}); probing "
                        f"every {ep.probe_every_s:g}s — retry after "
                        "recovery (watch /readyz)")
                if ep.tenant_quota > 0 and tenant is not None:
                    held = sum(1 for r in ep._queue if r.tenant == tenant)
                    if held >= ep.tenant_quota:
                        self._m_req.inc(1, model=ep.name,
                                        outcome="rejected")
                        self._m_shed.inc(1, model=ep.name, reason="quota")
                        err = QueueFullError(
                            f"model {ep.name!r}: tenant {tenant!r} is at "
                            f"its queue quota ({held}/{ep.tenant_quota}) "
                            "— its flood must not starve other tenants; "
                            "retry with backoff")
                        err.reason = "quota"
                        raise err
                if forced_full or len(ep._queue) >= ep.queue_limit:
                    self._m_req.inc(1, model=ep.name, outcome="rejected")
                    raise QueueFullError(
                        f"model {ep.name!r}: queue full "
                        f"({len(ep._queue)}/{ep.queue_limit}) — retry with "
                        "backoff" + (" [chaos]" if forced_full else ""))
                fut = ResponseFuture()
                fut.trace = tr
                req = _Request(
                    arr, fut,
                    deadline=(fut.t_submit + dl_ms / 1e3
                              if dl_ms > 0 else None),
                    tenant=tenant, priority=int(priority), trace=tr)
                ep._queue.append(req)
                self._m_depth.set(len(ep._queue), model=ep.name)
                self._cond.notify_all()
        return fut

    # ------------------------------------------------------------ scheduler
    def _ready_locked(self, now: float) -> List[Endpoint]:
        """Endpoints whose flush condition is met: fill threshold reached,
        head request past its deadline, or the engine is draining.
        Degraded endpoints never dispatch (their probe path does)."""
        out = []
        for ep in self._endpoints.values():
            if isinstance(ep, GenerativeEndpoint):
                continue                # its own token loop schedules it
            if ep.state != "ready":
                continue
            n = len(ep._queue)
            if not n:
                continue
            if (self._draining or n >= ep.fill
                    or (now - ep._queue[0].t_enq) >= ep.max_wait_s):
                out.append(ep)
        return out

    def _nearest_deadline_locked(self, now: float) -> Optional[float]:
        """Seconds until the scheduler next has work: a queue's flush
        deadline, a request's shed deadline, or a degraded model's next
        probe — whichever lands first."""
        best = None
        for ep in self._endpoints.values():
            if isinstance(ep, GenerativeEndpoint):
                continue
            if ep.state == "degraded":
                d = ep._next_probe - now
                best = d if best is None else min(best, d)
                continue
            if ep._queue:
                d = ep.max_wait_s - (now - ep._queue[0].t_enq)
                best = d if best is None else min(best, d)
                for r in ep._queue:
                    if r.deadline is not None:
                        best = min(best, r.deadline - now
                                   - _SVC_SHED_FACTOR * ep._svc_min)
        return best

    def _shed_expired_locked(self, now: float) -> List[Tuple[Endpoint,
                                                             _Request]]:
        """Deadline-aware admission control: pull every queued request
        that already cannot make its deadline — queue wait plus the
        fastest service this endpoint has EVER achieved (``_svc_min``)
        inflated by ``_SVC_SHED_FACTOR`` for scheduling slack overruns
        it — so compute is never spent on a guaranteed SLO miss. A
        request with real headroom is never shed; with no service
        observation yet the horizon degenerates to the bare deadline."""
        out: List[Tuple[Endpoint, _Request]] = []
        for ep in self._endpoints.values():
            if isinstance(ep, GenerativeEndpoint) or not ep._queue:
                continue
            horizon = now + _SVC_SHED_FACTOR * ep._svc_min
            if not any(r.deadline is not None and horizon >= r.deadline
                       for r in ep._queue):
                continue
            keep: deque = deque()
            for r in ep._queue:
                if r.deadline is not None and horizon >= r.deadline:
                    out.append((ep, r))
                else:
                    keep.append(r)
            ep._queue = keep
            self._m_depth.set(len(keep), model=ep.name)
        return out

    def _take_locked(self, ep: Endpoint) -> List[_Request]:
        """Pop up to one bucket's worth of requests, highest priority
        first (FIFO within a priority class — the sort is stable)."""
        n = min(len(ep._queue), ep.fill)
        if any(r.priority for r in ep._queue):
            picked = sorted(ep._queue, key=lambda r: -r.priority)[:n]
            taken = {id(r) for r in picked}
            ep._queue = deque(r for r in ep._queue
                              if id(r) not in taken)
        else:
            picked = [ep._queue.popleft() for _ in range(n)]
        self._m_depth.set(len(ep._queue), model=ep.name)
        return picked

    def _due_probe_locked(self, now: float) -> Optional[Endpoint]:
        """A degraded endpoint whose probe interval elapsed (claims the
        next slot so concurrent wake-ups don't double-probe)."""
        for ep in self._endpoints.values():
            if isinstance(ep, GenerativeEndpoint):
                continue
            if ep.state == "degraded" and now >= ep._next_probe:
                ep._next_probe = now + ep.probe_every_s
                return ep
        return None

    def _pick_wrr(self, ready: List[Endpoint]) -> Endpoint:
        """Smooth weighted round-robin (nginx-style): proportional share
        with maximal interleaving — a weight-3 tenant gets 3 of every 4
        batches but never 3-in-a-row starvation bursts beyond its share."""
        total = sum(ep.weight for ep in ready) or 1.0
        for ep in ready:
            ep._wrr += ep.weight
        chosen = max(ready, key=lambda ep: ep._wrr)
        chosen._wrr -= total
        return chosen

    def _sched_loop(self) -> None:
        while True:
            take: Optional[Tuple[Endpoint, List[_Request]]] = None
            shed: List[Tuple[Endpoint, _Request]] = []
            probe: Optional[Endpoint] = None
            with self._cond:
                while True:
                    now = time.perf_counter()
                    shed = self._shed_expired_locked(now)
                    if shed:
                        break
                    ready = self._ready_locked(now)
                    if ready:
                        ep = self._pick_wrr(ready)
                        take = (ep, self._take_locked(ep))
                        break
                    if not self._running:
                        # generative queues are the token loops' to
                        # drain — counting them here would park this
                        # thread in cond.wait with nobody to notify it
                        if not any(e._queue
                                   for e in self._endpoints.values()
                                   if not isinstance(
                                       e, GenerativeEndpoint)):
                            return      # drained (or told not to drain)
                        if not self._draining:
                            return      # close(drain=False): leftovers
                                        # are failed by close()
                    probe = self._due_probe_locked(now)
                    if probe is not None:
                        break
                    wait = self._nearest_deadline_locked(now)
                    self._cond.wait(wait if wait is None or wait > 0
                                    else 0.001)
            for ep, r in shed:
                waited_ms = (time.perf_counter() - r.t_enq) * 1e3
                self._m_shed.inc(1, model=ep.name, reason="deadline")
                if r.trace is not None:
                    r.trace.observe("queue_wait", waited_ms / 1e3)
                    r.trace.observe("shed", 0.0, reason="deadline")
                self._finish(ep, r, error=DeadlineError(
                    f"model {ep.name!r}: shed before compute — queued "
                    f"{waited_ms:.1f}ms, past the request deadline; the "
                    "SLO miss was already guaranteed"), outcome="shed")
            if shed:
                continue
            if probe is not None:
                self._probe(probe)
                continue
            self._dispatch(*take)

    def _hold(self, ep: Endpoint):
        """The endpoint's live model, counted in flight (under the lock
        a hot swap flips the route under, so its drain waits for this
        batch before it releases the old version)."""
        with self._cond:
            model = ep.model
            self._inflight_by_model[id(model)] = \
                self._inflight_by_model.get(id(model), 0) + 1
        return model

    def _unhold(self, model) -> None:
        with self._cond:
            mid = id(model)
            left = self._inflight_by_model.get(mid, 1) - 1
            if left <= 0:
                self._inflight_by_model.pop(mid, None)
            else:
                self._inflight_by_model[mid] = left
            self._cond.notify_all()

    def _dispatch(self, ep: Endpoint, reqs: List[_Request]) -> None:
        model = self._hold(ep)  # the demux fetches from the version that
        n = len(reqs)           # dispatched, even mid-swap
        bucket = next((b for b in model.buckets if b >= n),
                      model.buckets[-1])
        now = time.perf_counter()
        _telemetry.observe_span("batch_wait", now - reqs[0].t_enq,
                                model=ep.name, n=n, bucket=bucket)
        for r in reqs:          # per-request waterfall: time spent queued
            if r.trace is not None:
                r.trace.observe("queue_wait", now - r.t_enq)
        self._batch_seq += 1
        try:
            chaos.maybe_fail("serve.dispatch_fail", ServeError)
            with _telemetry.span("pad", model=ep.name, n=n, bucket=bucket):
                xb = model.pack([r.data for r in reqs], bucket)
            t_pad = time.perf_counter()
            with _telemetry.span("forward", model=ep.name, bucket=bucket):
                outs = model.dispatch(xb, bucket)
            t_fwd = time.perf_counter()
        except BaseException as e:      # compile/shape/model failure:
            self._unhold(model)         # fail the batch, keep serving
            for r in reqs:
                if r.trace is not None:
                    r.trace.observe("dispatch",
                                    time.perf_counter() - now,
                                    bucket=bucket, failed=True,
                                    version=ep.version)
                self._finish(ep, r, error=e, outcome="error")
            self._note_failure(ep, model, e)
            return
        for r in reqs:          # batch phases stamped per request, with
            if r.trace is not None:     # the version that dispatched
                r.trace.observe("pad", t_pad - now, bucket=bucket,
                                fill=round(n / float(bucket), 4))
                r.trace.observe("dispatch", t_fwd - t_pad, bucket=bucket,
                                version=ep.version)
        self._m_batches.inc(1, model=ep.name, bucket=str(bucket))
        self._m_pad.inc(bucket - n, model=ep.name)
        self._m_fill.set(n / float(bucket), model=ep.name)
        self._m_inflight.inc(1)
        self.dispatch_log.append((ep.name, n, bucket))
        self._inflight.put((ep, model, reqs, outs, self._batch_seq, now,
                            t_fwd))

    # --------------------------------------------------- self-healing ladder
    def _note_ok(self, ep: Endpoint, model) -> None:
        if ep.fail_streak:
            with self._cond:
                if self._endpoints.get(ep.name) is ep \
                        and ep.model is model:
                    ep.fail_streak = 0

    def _note_failure(self, ep: Endpoint, model, error) -> None:
        """One dispatch/demux failure walks the per-model ladder one
        rung (mirroring the guard's skip -> rescale -> rollback shape):
        retry (streak < rebuild rung) -> rebuild the executables from
        held params -> degraded at ``degrade_after``, probing back."""
        rebuild = degrade = False
        with self._cond:
            if self._endpoints.get(ep.name) is not ep \
                    or ep.model is not model or ep.state != "ready":
                return      # stale version/endpoint: not this model's rung
            ep.fail_streak += 1
            streak = ep.fail_streak
            if streak >= ep.degrade_after:
                degrade = True
            elif streak == ep.degrade_after - 1 \
                    and hasattr(model, "rebuild"):
                rebuild = True
        if rebuild:
            self._m_state.set(1, model=ep.name)
            try:
                with _telemetry.span("rebuild", model=ep.name,
                                     streak=streak):
                    model.rebuild()
                self._m_state.set(0, model=ep.name)
            except BaseException as e:
                error, degrade = e, True
        if degrade:
            self._degrade(ep, error)

    def _degrade(self, ep: Endpoint, error) -> None:
        with self._cond:
            if ep.state == "degraded" \
                    or self._endpoints.get(ep.name) is not ep:
                return
            ep.state = "degraded"
            ep._degrade_err = repr(error)
            ep._next_probe = time.perf_counter() + ep.probe_every_s
            pending = list(ep._queue)
            ep._queue.clear()
            self._m_depth.set(0, model=ep.name)
            self._cond.notify_all()
        self._m_state.set(2, model=ep.name)
        for r in pending:
            self._finish(ep, r, error=ModelDegradedError(
                f"model {ep.name!r} v{ep.version} went degraded while "
                f"this request was queued (cause: {ep._degrade_err})"),
                outcome="degraded")

    def _probe(self, ep: Endpoint) -> None:
        """One probe batch (all zeros, smallest bucket) against a
        degraded model; success flips it back to ready and resets the
        ladder. Runs in the scheduler thread between dispatches."""
        model = self._hold(ep)
        ok = False
        try:
            chaos.maybe_fail("serve.dispatch_fail", ServeError)
            with _telemetry.span("probe", model=ep.name,
                                 bucket=model.buckets[0]):
                _zeros_batch(model)
            ok = True
        except BaseException:
            pass        # stay degraded; next probe in probe_every_s
        finally:
            self._unhold(model)
        if not ok:
            return
        with self._cond:
            if self._endpoints.get(ep.name) is not ep \
                    or ep.model is not model or ep.state != "degraded":
                return
            ep.state = "ready"
            ep.fail_streak = 0
            ep._degrade_err = ""
            self._cond.notify_all()
        self._m_state.set(0, model=ep.name)

    # ---------------------------------------------------------------- demux
    def _watch(self, batch_id: int):
        if self._guard is None:
            return contextlib.nullcontext()
        return self._guard.watch("serve.forward", step=batch_id)

    def _slow_model_chaos(self) -> None:
        """``serve.slow_model``: the model's device compute crawls. Sleeps
        in 2 ms slices so the hung-request watchdog's async interrupt
        lands promptly (a single long C-level sleep would defer it)."""
        if not chaos.should_fail("serve.slow_model"):
            return
        deadline = time.perf_counter() + self.SLOW_CHAOS_S
        while time.perf_counter() < deadline:
            time.sleep(0.002)

    def _demux_loop(self) -> None:
        while True:
            item = self._inflight.get()
            if item is None:
                return
            ep, model, reqs, outs, batch_id, t_disp, t_fwd = item
            try:
                with self._watch(batch_id):
                    self._slow_model_chaos()
                    with _telemetry.span("demux", model=ep.name,
                                         n=len(reqs)):
                        # fetch from the model captured at dispatch: a
                        # swap mid-flight must not cross versions
                        host = model.fetch(outs)
                        t_host = time.perf_counter()
                        for i, r in enumerate(reqs):
                            tr = r.trace
                            if tr is not None:
                                # device compute: forward return ->
                                # host buffers ready (covers the
                                # in-flight queue wait, which overlaps
                                # the device)
                                tr.observe("device", t_host - t_fwd,
                                           version=ep.version)
                            t_dm = time.perf_counter()
                            res = [h[i] for h in host]
                            if tr is not None:
                                tr.observe(
                                    "demux",
                                    time.perf_counter() - t_dm,
                                    n=len(reqs))
                            self._finish(
                                ep, r,
                                value=res[0] if len(res) == 1 else res)
                svc = time.perf_counter() - t_disp
                if not ep._svc_min or svc < ep._svc_min:
                    ep._svc_min = svc
                self._note_ok(ep, model)
            except StepHungError as e:
                # watchdog fired: stacks + flight recorder are already
                # dumped (guard._emit action='raise'); fail ONLY this
                # batch and keep serving
                for r in reqs:
                    self._finish(ep, r, error=e, outcome="hung")
                self._note_failure(ep, model, e)
            except BaseException as e:
                for r in reqs:
                    self._finish(ep, r, error=e, outcome="error")
                self._note_failure(ep, model, e)
            finally:
                # a batch failed before its fetch still hands its slot back
                close = getattr(outs, "close", None)
                if close is not None:
                    close()
                self._m_inflight.dec(1)
                self._unhold(model)

    def _finish(self, ep: Endpoint, r: _Request, value=None, error=None,
                outcome: str = "ok") -> None:
        if r.future.done():
            return
        if error is not None and r.trace is not None:
            try:                        # error responses name their trace
                error.trace_id = r.trace.trace_id
            except Exception:
                pass
        aborted = r.future.cancelled()
        if not aborted and outcome == "ok" and \
                chaos.should_fail("serve.client_abort"):
            r.future.cancel()
            aborted = True
        if aborted:
            outcome = "aborted"
            r.future._set_exception(
                RequestAborted("client went away before the response"))
        elif error is not None:
            r.future._set_exception(error)
        else:
            r.future._set_result(value)
        self._m_req.inc(1, model=ep.name, outcome=outcome)
        tr = r.trace
        self._m_lat.observe(
            time.perf_counter() - r.future.t_submit,
            exemplar=({"trace_id": tr.trace_id} if tr is not None
                      else None),
            model=ep.name, outcome=outcome)
        self._trace_finish(ep.name, tr, outcome, error=error)

    # ---------------------------------------------------------------- stats
    def ready(self) -> Tuple[bool, Dict[str, str]]:
        """Per-model readiness for ``/readyz``: ``(all_ready, {model:
        state})``. ``/healthz`` stays process-liveness; THIS flips when
        the self-healing ladder marks a model degraded (and flips back
        on a successful probe batch). A closed engine is not ready."""
        with self._cond:
            states = {name: getattr(e, "state", "ready")
                      for name, e in self._endpoints.items()}
            closed = self._closed
        return (not closed
                and all(s == "ready" for s in states.values()), states)

    def stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-model serving counters (from the shared telemetry
        registry) + queue/bucket state."""
        out: Dict[str, Dict[str, Any]] = {}
        with self._cond:    # snapshot: load_model/unload mutate the dict
            endpoints = list(self._endpoints.items())
        for name, ep in endpoints:
            out[name] = {
                "pending": ep.pending(),
                "weight": ep.weight,
                "buckets": list(ep.buckets),
                "fill": getattr(ep, "fill", None),
                "model_bytes": getattr(ep.model, "model_bytes", None),
                "state": getattr(ep, "state", "ready"),
                "version": getattr(ep, "version", 1),
                "compiles": _telemetry.counter(
                    "mxtpu_serve_compiles_total").value(model=name),
                "shed": (self._m_shed.value(model=name, reason="deadline")
                         + self._m_shed.value(model=name, reason="quota")),
                "served": self._m_req.value(model=name, outcome="ok"),
                "rejected": self._m_req.value(model=name,
                                              outcome="rejected"),
                "errors": self._m_req.value(model=name, outcome="error"),
                "hung": self._m_req.value(model=name, outcome="hung"),
                "aborted": self._m_req.value(model=name, outcome="aborted"),
                "batches": sum(1 for m, _, _ in self.dispatch_log
                               if m == name),
            }
            # operator "start here" pointer: the slowest retained
            # request trace and its per-phase breakdown
            slow = _telemetry.trace_store().slowest(name)
            if slow is not None:
                out[name]["slowest_trace"] = slow
            if isinstance(ep, GenerativeEndpoint):
                out[name].update({
                    "kind": "generate",
                    "slots": ep.model.slots,
                    "slots_in_use": ep.slots_in_use,
                    "cache_len": ep.model.cache_len,
                    "cache_bytes": ep.model.cache_bytes,
                    "gen_tokens": self._m_gen_tokens.value(model=name),
                })
                if ep.pool is not None:
                    out[name].update({
                        "paged": True,
                        "page_len": ep.model.page_len,
                        "pages": ep.pool.n_pages,
                        "pages_in_use": ep.pool.in_use(),
                        "pages_cached": len(ep.pool.cached),
                        "prefix_hits": self._m_prefix_hits.value(
                            model=name),
                        "prefix_tokens_reused":
                            self._m_prefix_tokens.value(model=name),
                    })
        return out
