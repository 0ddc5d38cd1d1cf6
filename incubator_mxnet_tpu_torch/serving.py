"""Generative LM serving in PyTorch: iteration-level continuous batching
over a KV cache on one device.

Counterpart of the generative half of ``incubator_mxnet_tpu/serving.py``,
with the same public surface, environment variables, validation messages,
telemetry series and per-request tracing:

    client -> GenerativeEndpoint.submit(prompt) -> bounded prompt queue
           token-loop thread (one per generate model), every turn:
             admit waiting prompts into free KV slots (and, paged, pages:
             worst-case reservation, prefix-cache splice), run one prefill
             chunk per filling slot, run ONE fixed-shape decode step over
             every decode-ready slot, stream each emitted token to its
             GenerationFuture, retire EOS / max-token / aborted slots.

``InferenceEngine.load_model(name, generate={...})`` builds a
``_GenerativeModel`` over ``models.transformer`` and a
``GenerativeEndpoint``. The paged engine (block-table page pool with a
trash page, ``MXTPU_SERVE_GEN_PAGED=1``) is the default; ``paged=0`` keeps
the dense slotted cache. Decode-step attention runs through the port's
CUDA kernels on the card.

Differences from the JAX engine:

* execution is eager — there are no per-bucket AOT executables, so
  ``mxtpu_serve_compiles_total`` and ``mxtpu_serve_gen_traces_total`` are
  not emitted (capturing the prefill buckets and the decode step as CUDA
  graphs is later work);
* the KV cache is updated in place, so a failed call leaves the other
  slots' K/V intact and ``_GenerativeModel.recover`` never has to rebuild;
* sampling draws counter-based Gumbel noise hashed from (seed, position,
  token id) — a pure function of the request, occupancy-invariant, and the
  same on CPU and GPU — so sampled streams differ from ``jax.random``'s;
  greedy streams are what is compared with the JAX engine;
* only generate endpoints exist: ``load_model(net=/fn=/mlir=)`` raises
  ``NotImplementedError`` until the batch engine is ported.
"""
from __future__ import annotations

import contextlib
import hashlib
import os
import queue as _queue_mod
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as _np
import torch

from . import chaos
from . import telemetry as _telemetry
from .context import resolve_device

__all__ = ["ServeError", "QueueFullError", "EngineClosedError",
           "RequestAborted", "SwapError", "DeadlineError",
           "ModelDegradedError", "PagesExhaustedError", "GenerationFuture",
           "GenerativeEndpoint", "InferenceEngine", "default_gen_buckets",
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


# ------------------------------------------------------------------ futures
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


# -------------------------------------------------------------------- model
class _GenerativeModel:
    """KV-cache generation over the port's transformer — PAGED by default
    (block-table pool), with the dense slotted cache kept as
    ``paged=False``.

    Paged mode: the cache is a page pool ``(layers, n_pages + 1, heads,
    page_len, head_dim)`` (the +1 is the trash page) and the prefill /
    decode calls take the request's block-table row(s). Prompts (and
    prefill chunks) are padded to their bucket, so each call runs at one
    of ``len(buckets)`` prefill shapes or the one decode shape — the
    shapes a later CUDA-graph capture will pin.

    Decoding is greedy (argmax) by default; per-request ``temperature`` /
    ``top_k`` / ``top_p`` / ``seed`` ride as per-slot tensors through the
    same calls (see :func:`sample_tokens`). Greedy and sampled streams
    alike are a function of the request alone, at any batch occupancy."""

    kind = "generate"

    def __init__(self, params, cfg, *, slots: int, cache_len: int,
                 block: int, buckets: Sequence[int], eos_id: Optional[int],
                 max_new_tokens: int, name: str = "", paged: bool = False,
                 page_len: Optional[int] = None,
                 n_pages: Optional[int] = None, device=None):
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

    def bucket_for(self, n: int) -> Optional[int]:
        for b in self.buckets:
            if b >= n:
                return b
        return None

    def _tensor(self, a, dtype=torch.int64):
        return torch.as_tensor(a).to(device=self.device, dtype=dtype)

    def _sample(self, logits, temps, topks, topps, seeds, positions):
        if not _np.any(_np.asarray(temps) > 0):     # all greedy
            return logits.argmax(dim=1)
        return sample_tokens(
            logits, self._tensor(temps, torch.float32),
            self._tensor(topks), self._tensor(topps, torch.float32),
            self._tensor(seeds), self._tensor(positions))

    def _padded(self, tokens: _np.ndarray):
        bucket = self.bucket_for(len(tokens))
        xb = _np.zeros((1, bucket), _np.int64)
        xb[0, :len(tokens)] = tokens
        return self._tensor(xb)

    @torch.inference_mode()
    def prefill(self, prompt: _np.ndarray, slot: int,
                temperature: float = 0.0, top_k: int = 0,
                top_p: float = 0.0, seed: int = 0) -> int:
        """Contiguous mode: pad the prompt to its bucket, write the slot's
        K/V, return the first generated token (host int). Synchronous:
        admission happens between decode iterations."""
        from .models.transformer import transformer_prefill
        n = len(prompt)
        _, logits = transformer_prefill(self._params, self._padded(prompt),
                                        self.cfg, self._cache, slot, n)
        return int(self._sample(logits[None], [temperature], [top_k],
                                [top_p], [seed], [n])[0])

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
        from .models.transformer import transformer_prefill_paged
        pg = _np.full((self.max_pages,), self.trash_page, _np.int64)
        pg[:len(pages)] = pages
        _, logits = transformer_prefill_paged(
            self._params, self._padded(chunk), self.cfg, self._cache,
            self._tensor(pg), start, len(chunk))
        return int(self._sample(logits[None], [temperature], [top_k],
                                [top_p], [seed], [n_total])[0])

    @torch.inference_mode()
    def decode(self, tokens: _np.ndarray, positions: _np.ndarray,
               temps: _np.ndarray, topks: _np.ndarray,
               topps: _np.ndarray, seeds: _np.ndarray,
               block_tables: Optional[_np.ndarray] = None) -> _np.ndarray:
        """One fixed-shape decode step over the whole slot batch; returns
        the (slots,) next-token ids. Paged mode additionally takes the
        (slots, max_pages) int32 block tables (dead/prefilling rows must
        be all-trash)."""
        from .models.transformer import (transformer_decode_step,
                                         transformer_decode_step_paged)
        tok_t = self._tensor(tokens)
        pos_t = self._tensor(positions)
        if self.paged:
            _, logits = transformer_decode_step_paged(
                self._params, tok_t, pos_t, self._cache,
                self._tensor(block_tables, torch.int32), self.cfg)
        else:
            _, logits = transformer_decode_step(
                self._params, tok_t, pos_t, self._cache, self.cfg,
                block_k=self.block)
        toks = self._sample(logits, temps, topks, topps, seeds, positions)
        return toks.cpu().numpy()

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


# ---------------------------------------------------------------- endpoints
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
    """Continuous-batching generation server over one device (``device``:
    default ``"cuda"``; raises when no card is present unless ``"cpu"`` is
    asked for). ``queue_limit`` (else ``MXTPU_SERVE_QUEUE``, else 256)
    bounds each model's prompt queue. Each generate model runs its own
    token-loop thread, started by ``load_model``."""

    def __init__(self, queue_limit: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        self.queue_limit = int(queue_limit if queue_limit is not None
                               else _env_int("MXTPU_SERVE_QUEUE", 256))
        self._cond = threading.Condition()
        self._endpoints: "Dict[str, GenerativeEndpoint]" = {}
        self._running = True        # accepting submits
        self._draining = False      # live generations finish on close
        self._closed = False
        self._m_req = _telemetry.counter(
            "mxtpu_serve_requests_total",
            "Serving requests by model and outcome.")
        self._m_lat = _telemetry.histogram(
            "mxtpu_serve_request_seconds",
            "End-to-end request latency (submit -> response).")
        self._m_depth = _telemetry.gauge(
            "mxtpu_serve_queue_depth", "Waiting requests per model queue.")
        self._m_shed = _telemetry.counter(
            "mxtpu_serve_shed_total",
            "Requests shed before compute, by model and reason "
            "(deadline: queue wait alone already guaranteed the SLO "
            "miss; quota: tenant over its per-tenant queue quota).")
        self._m_swaps = _telemetry.counter(
            "mxtpu_serve_swaps_total",
            "Hot model swaps by model and outcome (ok / stage_failed / "
            "canary_failed / unsupported / lost_race).")
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
                   generate=None, weight: float = 1.0,
                   queue_limit: Optional[int] = None,
                   **kw) -> GenerativeEndpoint:
        """Load a generation endpoint: ``generate`` is a dict with
        ``params`` (transformer parameters in the port's layout, e.g. from
        ``models.transformer.params_from_jax``) and ``cfg``
        (``models.transformer.TransformerConfig``), plus optional
        ``slots`` / ``max_len`` / ``block`` / ``buckets`` (prompt padding
        buckets) / ``eos_id`` / ``max_new_tokens`` / ``paged`` /
        ``page_len`` / ``pages`` / ``prefix_cache`` / ``prefill_chunk``
        overriding the ``MXTPU_SERVE_GEN_*`` env family. Returns a
        ``GenerativeEndpoint`` whose ``submit(prompt)`` streams tokens
        through a ``GenerationFuture``. Parameters are moved to the
        engine's device. Generate endpoints do not hot-swap: loading an
        already-loaded name raises ``SwapError``.

        ``net=`` / ``fn=`` / ``mlir=`` (the batch engine) are not ported
        yet and raise ``NotImplementedError``."""
        if generate is None or any(x is not None for x in (net, fn, mlir)):
            if generate is not None:
                raise ValueError(
                    "generate= is exclusive with net=/fn=/mlir=")
            raise NotImplementedError(
                "batch serving (load_model net=/fn=/mlir=) is not ported "
                "to the PyTorch package yet — see ROADMAP.md, 'batch "
                "serving'")
        if kw:
            raise TypeError(f"unsupported load_model arguments {sorted(kw)}")
        if self._endpoints.get(name) is not None:
            self._m_swaps.inc(1, model=name, outcome="unsupported")
            raise SwapError(
                f"model {name!r} is already loaded and generate "
                "endpoints do not hot-swap (live KV state) — "
                "unload() first")
        return self._load_generate(name, generate, weight=weight,
                                   queue_limit=queue_limit)

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
        _telemetry.gauge(
            "mxtpu_serve_model_bytes",
            "Resident parameter bytes per loaded model (int8-"
            "quantized models are ~4x smaller).").set(
                model.model_bytes, model=name)
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
        """Remove an endpoint; its token loop fails the waiting prompts
        and live generations with ``EngineClosedError``."""
        with self._cond:
            self._endpoints.pop(name, None)
            self._cond.notify_all()

    def endpoint(self, name: str) -> GenerativeEndpoint:
        return self._endpoints[name]

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        """A no-op kept for the reference's interface: each generate
        endpoint's token loop starts at ``load_model``, and there is no
        shared scheduler thread until the batch engine is ported."""

    def close(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Graceful shutdown: stop accepting, then (with ``drain``) let
        live generations finish under the ``MXTPU_SERVE_GEN_DRAIN_TOKENS``
        cap while queued prompts fail with ``EngineClosedError``; with
        ``drain=False`` live generations fail too. Joins every token-loop
        thread. Idempotent."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._running = False
            self._draining = bool(drain)
            self._cond.notify_all()
        for t in self._gen_threads:
            t.join(timeout=timeout)

    def __enter__(self) -> "InferenceEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------------------------------------------------------- stats
    def ready(self) -> Tuple[bool, Dict[str, str]]:
        """Per-model readiness for ``/readyz``: ``(all_ready, {model:
        state})``. A closed engine is not ready."""
        with self._cond:
            states = {name: "ready" for name in self._endpoints}
            closed = self._closed
        return (not closed, states)

    def stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-model serving counters (from the shared telemetry
        registry) + queue/slot/page state."""
        out: Dict[str, Dict[str, Any]] = {}
        with self._cond:    # snapshot: load_model/unload mutate the dict
            endpoints = list(self._endpoints.items())
        for name, ep in endpoints:
            out[name] = {
                "kind": "generate",
                "pending": ep.pending(),
                "weight": ep.weight,
                "buckets": list(ep.buckets),
                "model_bytes": ep.model.model_bytes,
                "state": "ready",
                "version": 1,
                "shed": self._m_shed.value(model=name, reason="deadline"),
                "served": self._m_req.value(model=name, outcome="ok"),
                "rejected": self._m_req.value(model=name,
                                              outcome="rejected"),
                "errors": self._m_req.value(model=name, outcome="error"),
                "aborted": self._m_req.value(model=name, outcome="aborted"),
                "slots": ep.model.slots,
                "slots_in_use": ep.slots_in_use,
                "cache_len": ep.model.cache_len,
                "cache_bytes": ep.model.cache_bytes,
                "gen_tokens": self._m_gen_tokens.value(model=name),
            }
            # operator "start here" pointer: the slowest retained
            # request trace and its per-phase breakdown
            slow = _telemetry.trace_store().slowest(name)
            if slow is not None:
                out[name]["slowest_trace"] = slow
            if ep.pool is not None:
                out[name].update({
                    "paged": True,
                    "page_len": ep.model.page_len,
                    "pages": ep.pool.n_pages,
                    "pages_in_use": ep.pool.in_use(),
                    "pages_cached": len(ep.pool.cached),
                    "prefix_hits": self._m_prefix_hits.value(model=name),
                    "prefix_tokens_reused":
                        self._m_prefix_tokens.value(model=name),
                })
        return out
