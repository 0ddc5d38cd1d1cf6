"""Shared fault-tolerant input service.

Counterpart of ``incubator_mxnet_tpu/input_service.py``. One supervised
pool of crash-isolated decode workers feeds every local rank: the service
decodes each GLOBAL batch exactly once and hands each rank its
deterministic row slice (``elastic.shard_batch`` over a ``GroupView``),
so N ranks cost one decode, not N.

Transport is ``_dataloader_worker.py``'s subprocess + shared-memory
protocol (plain subprocesses, not ``multiprocessing``: fork would copy
the parent's CUDA context, spawn re-imports ``__main__``). Workers run
with ``CUDA_VISIBLE_DEVICES=""`` and build batches under ``cpu()``, so
none initialises CUDA; each reports ``torch.cuda.is_initialized()`` at
its exit (``worker_reports``). Work items are tagged ``g<gen>p<pos>``:
the generation makes ``reset()`` drain-safe (stale results are unlinked
on arrival, never delivered) and the position keys the reorder window.
Delivered batches are host arrays (``device=True`` moves each slice to
the current context's device; ``io.DevicePrefetcher`` copies ahead
instead).

Fault contract:

* **Worker death** (exit / EOF / heartbeat): the supervisor respawns the
  slot up to ``MXTPU_IO_WORKER_RESTARTS`` times and replays its
  in-flight work items **exactly once**: results the dead worker already
  reported are kept (the reader drains the pipe before posting EOF),
  unreported items are re-dispatched, so the delivered stream is
  bit-identical to an unkilled run. Segments a worker created but never
  reported are reaped by their deterministic name (``mxtpu<pid>x<tag>``).
* **Corrupt records** are quarantined, not fatal: the worker backfills
  the row with an intact neighbour, reports (uri, offset, why), and the
  supervisor counts ``mxtpu_io_records_skipped_total{reason}`` and
  appends the quarantine file (``record_skips``). Past
  ``MXTPU_IO_MAX_SKIP`` total skips the service raises a typed
  ``InputCorruptionError`` instead of wedging.
* **Starvation**: every consumer wait is a ``prefetch_wait`` span and an
  ``mxtpu_io_prefetch_wait_seconds`` observation; ``starvation_share()``
  is the share of wall time consumers spent blocked.

Chaos points (scriptable via ``MXTPU_CHAOS``, see chaos.py):
``io.worker_kill`` (worker suicide before a batch), ``io.record_corrupt``
(per-record decode failure), ``io.decode_stall`` (slow decode,
``MXTPU_IO_STALL_S`` seconds per fire).

Elastic: ``elastic_rebuild(view)`` re-points the per-rank slicing at a
new ``GroupView`` without touching workers or the window: decoded global
batches survive a remesh. (The controller that drives it,
``fault.auto_resume_fit(elastic=...)``, is ROADMAP.md A10c.)

``num_workers=0`` decodes inline (no subprocesses): same sharding,
windowing, quarantine and chaos semantics.
"""
from __future__ import annotations

import json as _json
import os
import queue as _queue_mod
import subprocess as _subprocess
import sys as _sys
import tempfile as _tempfile
import threading
import time as _time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from .base import MXTPUError
from .context import cpu
from .io import DataBatch, DataIter

__all__ = ["InputService", "InputServiceError", "InputCorruptionError",
           "InputWorkerError", "RecordFileDataset", "record_skips",
           "quarantine_path"]


class InputServiceError(MXTPUError):
    """Base for typed input-service failures."""


class InputCorruptionError(InputServiceError):
    """The corrupt-record skip budget (``MXTPU_IO_MAX_SKIP``) is
    exhausted. ``skipped`` counts quarantined records; ``quarantine``
    names the file listing (uri, offset, why) per record."""

    def __init__(self, msg: str, skipped: int = 0,
                 quarantine: Optional[str] = None):
        super().__init__(msg)
        self.skipped = skipped
        self.quarantine = quarantine


class InputWorkerError(InputServiceError):
    """A worker slot exhausted its restart budget
    (``MXTPU_IO_WORKER_RESTARTS``)."""


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return float(v) if v not in (None, "") else default


def quarantine_path() -> str:
    """Where quarantined-record lines land: ``MXTPU_IO_QUARANTINE`` if
    set, else ``<tmpdir>/mxtpu-quarantine-<pid>.jsonl``."""
    p = os.environ.get("MXTPU_IO_QUARANTINE")
    if p:
        return p
    return os.path.join(_tempfile.gettempdir(),
                        f"mxtpu-quarantine-{os.getpid()}.jsonl")


_quarantine_lock = threading.Lock()


def record_skips(skipped, pool: str = "input_service",
                 quarantine: Optional[str] = None) -> int:
    """Account a batch's quarantined records: bump
    ``mxtpu_io_records_skipped_total{reason}`` and append one JSON line
    ``{"uri", "offset", "why", "pool"}`` per record to the quarantine
    file. Never raises (a full disk must not take down the run).
    Returns the number of records counted. Shared by the input service,
    the gluon DataLoader worker pool and ImageRecordIter's process
    route."""
    skipped = list(skipped or ())
    if not skipped:
        return 0
    from . import telemetry as _telemetry
    c = _telemetry.counter(
        "mxtpu_io_records_skipped_total",
        "Corrupt/undecodable records quarantined (skipped) by reason.")
    path = quarantine or quarantine_path()
    try:
        with _quarantine_lock:
            with open(path, "a") as f:
                for uri, offset, why in skipped:
                    reason = (str(why).split(":", 1)[0].strip()[:40]
                              or "unknown")
                    c.inc(1, reason=reason)
                    f.write(_json.dumps({"uri": str(uri),
                                         "offset": int(offset),
                                         "why": str(why),
                                         "pool": pool}) + "\n")
    except OSError:
        for uri, offset, why in skipped:
            reason = str(why).split(":", 1)[0].strip() or "unknown"
            c.inc(1, reason=reason)
    return len(skipped)


def _unlink_shm(name: str) -> bool:
    """Best-effort unlink of a shared-memory segment by name."""
    from multiprocessing import shared_memory
    try:
        seg = shared_memory.SharedMemory(name=name)
    except (FileNotFoundError, OSError):
        return False
    seg.close()
    try:
        # unlink also unregisters the attach-time tracker registration;
        # an extra explicit unregister would double-remove and make the
        # tracker process spew KeyError tracebacks
        seg.unlink()
    except (FileNotFoundError, OSError):
        pass
    return True


def _read_record_at(handle, offset: int, uri: str) -> bytes:
    """Read one (possibly multi-part) RecordIO record at ``offset``;
    raises IOError naming the uri+offset on any framing violation. The
    text before the first ``:`` is the quarantine reason label — keep it
    a fixed low-cardinality prefix."""
    import struct
    _MAGIC = 0xced7230a
    _LFLAG_BITS = 29
    _LFLAG_MASK = (1 << _LFLAG_BITS) - 1
    handle.seek(offset)
    parts: List[bytes] = []
    while True:
        hdr = handle.read(8)
        if len(hdr) < 8:
            raise IOError(f"truncated header: {uri} @ {offset}")
        magic, lword = struct.unpack("<II", hdr)
        if magic != _MAGIC:
            raise IOError(f"invalid magic: {magic:#x} in {uri} @ {offset}")
        length = lword & _LFLAG_MASK
        buf = handle.read(length)
        if len(buf) < length:
            raise IOError(f"truncated payload: {uri} @ {offset}")
        pad = (-length) % 4
        if pad:
            handle.read(pad)
        parts.append(buf)
        if (lword >> _LFLAG_BITS) in (0, 3):
            return b"".join(parts)
        parts.append(struct.pack("<I", _MAGIC))


class RecordFileDataset:
    """Picklable random-access view over a RecordIO file: sample ``i``
    is the raw payload of the i-th record (optionally transformed). The
    file handle is reopened lazily per process, so instances cross the
    subprocess-worker pickle boundary. ``describe(i)`` names the
    (uri, byte offset) pair the quarantine file records."""

    def __init__(self, rec_path: str, transform=None):
        from .io import _scan_record_offsets
        self._path = rec_path
        self._transform = transform
        self._offsets = [int(o) for o in _scan_record_offsets(rec_path)]
        self._handle = None

    def __len__(self) -> int:
        return len(self._offsets)

    def describe(self, i: int) -> Tuple[str, int]:
        return self._path, self._offsets[int(i)]

    def __getstate__(self):
        d = dict(self.__dict__)
        d["_handle"] = None
        return d

    def __getitem__(self, i: int):
        if self._handle is None:
            self._handle = open(self._path, "rb")
        raw = _read_record_at(self._handle, self._offsets[int(i)],
                              self._path)
        return self._transform(raw) if self._transform else raw


class _RankStream(DataIter):
    """One rank's view of the shared service: ``next()`` yields that
    rank's deterministic row slice of the service's global batch
    stream. All streams of one service share decode work, the reorder
    window and the fault machinery; they must advance in lockstep
    within the window depth (training ranks do)."""

    def __init__(self, service: "InputService", sid: int,
                 rank: Optional[int]):
        super().__init__(service.batch_size)
        self._service = service
        self._sid = sid
        self.rank = rank
        self.current_batch: Optional[DataBatch] = None

    def next(self) -> DataBatch:
        return self._service._next_for(self._sid, self.rank)

    def iter_next(self) -> bool:
        try:
            self.current_batch = self.next()
            return True
        except StopIteration:
            return False

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getpad(self):
        return self.current_batch.pad

    def getindex(self):
        return self.current_batch.index

    def reset(self):
        self._service.reset()


class InputService(DataIter):
    """Fault-tolerant shared input service (module docstring has the
    full contract).

    Parameters
    ----------
    dataset : picklable sequence (``__len__`` + ``__getitem__``); an
        optional ``describe(i) -> (uri, offset)`` feeds the quarantine
        file (``RecordFileDataset`` provides it).
    batch_size : GLOBAL batch rows per step; each rank receives its
        ``shard_batch`` slice of them.
    num_workers : decode subprocesses; 0 (default, or
        ``MXTPU_IO_WORKERS``) decodes inline.
    view : ``elastic.GroupView`` (or an int world size) the per-rank
        slicing uses; ``elastic_rebuild(view)`` re-points it live.
    rank : the rank this service's own iterator yields slices for;
        ``None`` (default) yields the full global batch — the
        single-process mesh-training shape ``auto_resume_fit`` expects.
        Additional ranks attach via ``stream(rank)``.
    shuffle/seed : epoch order is ``permutation(len(dataset))`` keyed
        by ``(seed, epoch)`` — bit-stable across resume, respawn and
        reshard. Advance epochs via ``set_epoch()``; ``reset()`` alone
        replays the same epoch (resume semantics).
    device : move delivered slices to the current context's device
        (``io.device_transfer``); default False: compose with
        ``DevicePrefetcher`` for an asynchronous copy instead.
    """

    def __init__(self, dataset, batch_size: int, *,
                 num_workers: Optional[int] = None, view=None,
                 rank: Optional[int] = None, shuffle: bool = False,
                 seed: int = 0, batchify_fn=None, device: bool = False,
                 window: Optional[int] = None,
                 max_restarts: Optional[int] = None,
                 heartbeat_s: Optional[float] = None,
                 max_skip: Optional[int] = None,
                 quarantine: Optional[str] = None):
        super().__init__(int(batch_size))
        if batch_size <= 0:
            raise ValueError(f"batch_size must be > 0, got {batch_size}")
        self._dataset = dataset
        self._batchify = batchify_fn or self._default_batchify
        self._view = self._as_view(view)
        self._shuffle = bool(shuffle)
        self._seed = int(seed)
        self._device = bool(device)
        self._workers = (_env_int("MXTPU_IO_WORKERS", 0)
                         if num_workers is None else int(num_workers))
        self._window_cap = max(2, _env_int("MXTPU_IO_WINDOW",
                                           max(4, 2 * self._workers))
                               if window is None else int(window))
        self._max_restarts = (_env_int("MXTPU_IO_WORKER_RESTARTS", 8)
                              if max_restarts is None else int(max_restarts))
        self._hb = (_env_float("MXTPU_IO_HEARTBEAT_S", 0.0)
                    if heartbeat_s is None else float(heartbeat_s))
        self._max_skip = (_env_int("MXTPU_IO_MAX_SKIP", 1024)
                          if max_skip is None else int(max_skip))
        self._quarantine = quarantine or quarantine_path()

        self._steps = len(dataset) // int(batch_size)
        self._epoch = 0
        self._order = self._order_for(0)
        self._gen = 0

        self._cond = threading.Condition()
        self._cursors: Dict[int, int] = {}
        self._next_sid = 0
        self._default_sid: Optional[int] = None
        self._window: Dict[int, Any] = {}
        self._busy: set = set()        # inline mode: positions mid-decode
        self._next_dispatch = 0
        self._fatal: Optional[BaseException] = None
        self._closed = False
        self._skips = 0
        self._delivered = 0
        self._restarts_total = 0

        # worker-pool state (populated lazily on first demand)
        self._procs: Optional[List[_subprocess.Popen]] = None
        self._inflight: List[List[Tuple[str, int]]] = \
            [[] for _ in range(self._workers)]
        self._restarts = [0] * self._workers
        self._ready = [False] * self._workers
        self._last_out = [0.0] * self._workers
        self._hb_killed = [False] * self._workers
        self._readers: List[threading.Thread] = []
        self._sup: Optional[threading.Thread] = None
        self._rq: "_queue_mod.Queue" = _queue_mod.Queue()
        self._cfg_path: Optional[str] = None
        #: one {"pid", "cuda_initialized", "cuda_visible_devices"} a
        #: worker process that exited, as it reported at its exit
        self.worker_reports: List[Dict[str, Any]] = []

        # starvation accounting: (wait_s, step_wall_s) per delivery
        self._waits: deque = deque(maxlen=512)
        self._last_deliver_t: Optional[float] = None

        self._self_rank = rank
        from . import telemetry as _telemetry
        self._hist_wait = _telemetry.histogram(
            "mxtpu_io_prefetch_wait_seconds",
            "Time a consumer blocked waiting for the input service.")
        self._g_depth = _telemetry.gauge(
            "mxtpu_io_queue_depth",
            "Decoded batches parked in the input-service reorder window.")
        self._g_inflight = _telemetry.gauge(
            "mxtpu_io_inflight",
            "Work items dispatched to input-service workers, not yet done.")

    # ------------------------------------------------------------- helpers
    @staticmethod
    def _as_view(view):
        from .elastic import GroupView
        if view is None:
            return GroupView(0, (0,))
        if isinstance(view, GroupView):
            return view
        return GroupView(0, tuple(range(int(view))))

    @staticmethod
    def _default_batchify(samples):
        from .gluon.data.dataloader import default_batchify_fn
        return default_batchify_fn(samples)

    def _order_for(self, epoch: int):
        import numpy as np
        n = len(self._dataset)
        if not self._shuffle:
            return np.arange(n)
        rng = np.random.RandomState(
            (self._seed * 1000003 + epoch * 7919 + 0x5F17) % (2 ** 31))
        return rng.permutation(n)

    def _indices_for(self, pos: int) -> List[int]:
        lo = pos * self.batch_size
        return [int(i) for i in self._order[lo:lo + self.batch_size]]

    # --------------------------------------------------------- public API
    @property
    def view(self):
        return self._view

    def __len__(self) -> int:
        return self._steps

    def stream(self, rank: Optional[int]) -> _RankStream:
        """A per-rank consumer of the shared batch stream. Create
        streams before consuming (or right after ``reset()``)."""
        with self._cond:
            sid = self._register_sid_locked()
        return _RankStream(self, sid, rank)

    def _register_sid_locked(self) -> int:
        if any(c > 0 for c in self._cursors.values()):
            raise RuntimeError(
                "InputService.stream(): attach streams before consuming "
                "(or immediately after reset()) — a late joiner behind "
                "the reorder window could never catch up")
        sid = self._next_sid
        self._next_sid += 1
        self._cursors[sid] = 0
        return sid

    def set_epoch(self, epoch: int) -> None:
        """Re-key the (shuffled) epoch order; takes effect at the next
        ``reset()``. ``auto_resume_fit`` calls this each epoch sweep so
        mid-epoch resumes and elastic re-entries replay the SAME order
        while fresh epochs draw a new one."""
        epoch = int(epoch)
        with self._cond:
            if epoch != self._epoch:
                self._epoch = epoch
                self._order = self._order_for(epoch)

    def reset(self) -> None:
        """Restart the current epoch's stream from position 0. Bumps
        the generation: results of in-flight work items from before the
        reset are unlinked on arrival, never delivered."""
        with self._cond:
            if self._closed:
                raise RuntimeError("InputService is closed")
            self._gen += 1
            for fl in self._inflight:
                fl.clear()
            self._window.clear()
            self._busy.clear()
            for sid in self._cursors:
                self._cursors[sid] = 0
            self._next_dispatch = 0
            self._last_deliver_t = None
            if self._procs is not None:
                self._dispatch_locked()
            self._cond.notify_all()

    def elastic_rebuild(self, view) -> None:
        """Adopt a new ``GroupView`` after an elastic resize: only the
        delivery-time row slicing changes — workers, the window and the
        already-decoded global batches all survive the remesh (sharding
        is applied at delivery, not at decode)."""
        view = self._as_view(view)
        with self._cond:
            self._view = view
        from . import telemetry as _telemetry
        _telemetry.event("io_elastic_rebuild", world=view.world,
                         view_epoch=view.epoch)

    def next(self) -> DataBatch:
        with self._cond:
            if self._default_sid is None:
                self._default_sid = self._register_sid_locked()
        return self._next_for(self._default_sid, self._self_rank)

    def iter_next(self) -> bool:
        try:
            self.current_batch = self.next()
            return True
        except StopIteration:
            return False

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getpad(self):
        return self.current_batch.pad

    def getindex(self):
        return self.current_batch.index

    provide_data = None
    provide_label = None

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            return {"steps": self._steps, "delivered": self._delivered,
                    "skipped": self._skips,
                    "restarts": self._restarts_total,
                    "window": len(self._window),
                    "world": self._view.world,
                    "starvation_share": self.starvation_share()}

    def starvation_share(self, last: Optional[int] = None) -> float:
        """Fraction of recent wall time consumers spent blocked on the
        service (the ``prefetch_wait`` share).
        Over the last ``last`` deliveries (all retained when None)."""
        entries = list(self._waits)
        if last:
            entries = entries[-int(last):]
        if not entries:
            return 0.0
        total = sum(dt for _w, dt in entries)
        if total <= 0:
            return 0.0
        return min(1.0, sum(w for w, _dt in entries) / total)

    # ----------------------------------------------------------- delivery
    def _next_for(self, sid: int, rank: Optional[int]) -> DataBatch:
        with self._cond:
            if self._fatal is not None:
                raise self._fatal
            if self._closed:
                raise RuntimeError("InputService is closed")
            pos = self._cursors[sid]
        if pos >= self._steps:
            raise StopIteration
        tree, waited = self._ensure(pos)
        with self._cond:
            self._cursors[sid] = pos + 1
            low = min(self._cursors.values())
            for k in [k for k in self._window if k < low]:
                del self._window[k]
            self._delivered += 1
            self._g_depth.set(len(self._window))
            if self._procs is not None:
                self._dispatch_locked()
            self._cond.notify_all()
        self._note_wait(waited)
        return self._shard(tree, rank, pos)

    def _ensure(self, pos: int):
        """Block until the global batch for step ``pos`` is in the
        window; returns (batch_tree, seconds_waited)."""
        t0 = _time.perf_counter()
        if self._workers == 0:
            tree = self._ensure_inline(pos)
        else:
            with self._cond:
                if self._procs is None:
                    self._start_workers_locked()
                while pos not in self._window:
                    if self._fatal is not None:
                        raise self._fatal
                    if self._closed:
                        raise RuntimeError("InputService is closed")
                    self._cond.wait(0.1)
                tree = self._window[pos]
        return tree, _time.perf_counter() - t0

    def _ensure_inline(self, pos: int):
        with self._cond:
            while True:
                if self._fatal is not None:
                    raise self._fatal
                if pos in self._window:
                    return self._window[pos]
                if pos in self._busy:
                    self._cond.wait(0.05)
                    continue
                self._busy.add(pos)
                break
        try:
            from . import chaos as _chaos
            from ._dataloader_worker import _gather
            with cpu():     # host batches, as the workers make them
                samples, skipped = _gather(self._dataset,
                                           self._indices_for(pos),
                                           chaos=_chaos)
                tree = self._batchify(samples)
        except BaseException:
            with self._cond:
                self._busy.discard(pos)
                self._cond.notify_all()
            raise
        with self._cond:
            self._busy.discard(pos)
            self._account_skips_locked(skipped)
            self._window[pos] = tree
            self._g_depth.set(len(self._window))
            self._cond.notify_all()
            if self._fatal is not None:
                raise self._fatal
        return tree

    def _shard(self, tree, rank: Optional[int], pos: int) -> DataBatch:
        rows = None
        if rank is not None:
            from .elastic import shard_batch
            rows = shard_batch(self.batch_size, self._view, rank)

        def cut(a):
            out = a if rows is None else a[rows[0]:rows[1]]
            if self._device:
                from .io import device_transfer
                out = device_transfer(out)
            return out

        if isinstance(tree, (list, tuple)):
            if len(tree) == 2:
                data, label = [cut(tree[0])], [cut(tree[1])]
            else:
                data, label = [cut(t) for t in tree], None
        else:
            data, label = [cut(tree)], None
        return DataBatch(data=data, label=label, pad=0, index=pos)

    def _note_wait(self, waited: float) -> None:
        from . import telemetry as _telemetry
        self._hist_wait.observe(waited)
        if waited > 0.0:
            _telemetry.observe_span("prefetch_wait", waited,
                                    pool="input_service",
                                    depth=len(self._window))
        now = _time.perf_counter()
        with self._cond:
            if self._last_deliver_t is not None:
                self._waits.append((waited,
                                    max(now - self._last_deliver_t, 1e-9)))
            self._last_deliver_t = now

    def _account_skips_locked(self, skipped) -> None:
        n = record_skips(skipped, pool="input_service",
                         quarantine=self._quarantine)
        if not n:
            return
        self._skips += n
        if self._skips > self._max_skip and self._fatal is None:
            self._fatal = InputCorruptionError(
                f"input service quarantined {self._skips} records "
                f"(> MXTPU_IO_MAX_SKIP={self._max_skip}); quarantine "
                f"file: {self._quarantine}", skipped=self._skips,
                quarantine=self._quarantine)

    # -------------------------------------------------------- worker pool
    def _start_workers_locked(self) -> None:
        import pickle
        worker_py = os.path.join(
            os.path.dirname(os.path.abspath(__file__)),
            "_dataloader_worker.py")
        with _tempfile.NamedTemporaryFile(suffix=".pkl",
                                          delete=False) as f:
            pickle.dump((self._dataset, self._batchify), f)
            self._cfg_path = f.name
        self._worker_py = worker_py
        self._procs = [None] * self._workers  # type: ignore[list-item]
        for slot in range(self._workers):
            self._spawn_locked(slot)
        self._sup = threading.Thread(target=self._supervise,
                                     name="mxtpu-io-supervisor",
                                     daemon=True)
        self._sup.start()
        self._dispatch_locked()

    def _spawn_locked(self, slot: int) -> None:
        # fresh chaos salt per incarnation: a respawned worker draws its
        # own deterministic fault sequence instead of replaying the death
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   # '' means cwd in sys.path; spell it out for the child
                   PYTHONPATH=os.pathsep.join(p or os.getcwd()
                                              for p in _sys.path),
                   MXTPU_IO_ANNOUNCE="1",
                   MXTPU_CHAOS_SALT=f"io:{slot}:{self._restarts[slot]}")
        proc = _subprocess.Popen(
            [_sys.executable, self._worker_py, self._cfg_path],
            stdin=_subprocess.PIPE, stdout=_subprocess.PIPE, env=env,
            text=True, bufsize=1)
        self._procs[slot] = proc
        self._ready[slot] = False
        self._last_out[slot] = _time.monotonic()
        t = threading.Thread(target=self._reader, args=(proc, slot),
                             name=f"mxtpu-io-reader-{slot}", daemon=True)
        self._readers = [r for r in self._readers if r.is_alive()]
        self._readers.append(t)
        t.start()

    def _reader(self, proc, slot: int) -> None:
        """Per-incarnation pipe reader: completed result lines strictly
        precede the EOF marker in the result queue, so work a dying
        worker finished is never replayed (exactly-once)."""
        rq = self._rq
        try:
            for line in proc.stdout:
                line = line.rstrip("\n")
                if line:
                    rq.put((slot, "line", (proc, line)))
        except (OSError, ValueError):
            pass
        rq.put((slot, "eof", proc))

    def _supervise(self) -> None:
        hb_poll = min(self._hb / 4.0, 0.5) if self._hb > 0 else 0.5
        while True:
            try:
                slot, kind, payload = self._rq.get(timeout=hb_poll)
            except _queue_mod.Empty:
                self._heartbeat_check()
                continue
            if kind == "exit":
                return
            with self._cond:
                try:
                    if kind == "line":
                        self._handle_line_locked(slot, *payload)
                    else:
                        self._handle_eof_locked(slot, payload)
                except Exception as e:  # supervisor must never die silent
                    if self._fatal is None and not self._closed:
                        self._fatal = e
                self._cond.notify_all()

    def _drop_line(self, line: str) -> None:
        try:
            _tag, name, _meta = line.split(":", 2)
        except ValueError:
            return
        _unlink_shm(name)

    def _handle_line_locked(self, slot: int, proc, line: str) -> None:
        if line.startswith("#exit:"):
            try:
                self.worker_reports.append(_json.loads(line[6:]))
            except ValueError:
                pass
            return
        if self._closed or proc is not self._procs[slot]:
            self._drop_line(line)   # stale incarnation / post-close output
            return
        self._last_out[slot] = _time.monotonic()
        if line.startswith("#"):
            if line == "#ready":
                self._ready[slot] = True
            return
        try:
            tag, name, meta_s = line.split(":", 2)
            meta = _json.loads(meta_s)
        except ValueError:
            return   # torn line: the worker is dying; EOF replays it
        entry = next((e for e in self._inflight[slot] if e[0] == tag), None)
        if entry is None:
            _unlink_shm(name)       # pre-reset generation: discard
            return
        self._inflight[slot].remove(entry)
        from .gluon.data.dataloader import _from_shm
        tree = _from_shm(name, meta)
        self._account_skips_locked(meta.get("skipped") or ())
        self._window[entry[1]] = tree
        self._g_depth.set(len(self._window))
        self._g_inflight.set(sum(len(fl) for fl in self._inflight))

    def _handle_eof_locked(self, slot: int, proc) -> None:
        if self._closed or proc is not self._procs[slot]:
            return
        reason = "heartbeat" if self._hb_killed[slot] else "exit"
        self._hb_killed[slot] = False
        try:
            proc.wait(timeout=5)
        except Exception:
            try:
                proc.kill()
            except OSError:
                pass
        # a death between shm create and the stdout report orphans a
        # segment the parent never heard of; its name is deterministic
        # (pid + tag) — reap before replaying
        for tag, _pos in self._inflight[slot]:
            _unlink_shm(f"mxtpu{proc.pid}x{tag}")
        self._restarts[slot] += 1
        self._restarts_total += 1
        from . import telemetry as _telemetry
        _telemetry.counter(
            "mxtpu_io_worker_restarts_total",
            "Input-service worker respawns by detection reason.").inc(
                1, reason=reason, pool="input_service")
        _telemetry.event("io_worker_restart", slot=slot, reason=reason,
                         incarnation=self._restarts[slot])
        if self._restarts[slot] > self._max_restarts:
            head = self._inflight[slot][0] if self._inflight[slot] else None
            self._fatal = InputWorkerError(
                f"input-service worker slot {slot} died "
                f"{self._restarts[slot]} times (> MXTPU_IO_WORKER_RESTARTS"
                f"={self._max_restarts}); head-of-line work item: {head}")
            return
        self._spawn_locked(slot)
        for tag, pos in self._inflight[slot]:   # exactly-once replay
            self._send_locked(slot, tag, pos)

    def _heartbeat_check(self) -> None:
        if self._hb <= 0:
            return
        now = _time.monotonic()
        with self._cond:
            if self._closed or self._fatal is not None \
                    or self._procs is None:
                return
            for slot in range(self._workers):
                if (self._inflight[slot] and self._ready[slot]
                        and not self._hb_killed[slot]
                        and now - self._last_out[slot] > self._hb):
                    # stalled with work in flight: kill; the reader's EOF
                    # marker drives the normal respawn+replay path
                    self._hb_killed[slot] = True
                    self._last_out[slot] = now
                    try:
                        self._procs[slot].kill()
                    except OSError:
                        pass

    def _send_locked(self, slot: int, tag: str, pos: int) -> None:
        idxs = ",".join(str(i) for i in self._indices_for(pos))
        proc = self._procs[slot]
        try:
            proc.stdin.write(f"{tag}:{idxs}\n")
            proc.stdin.flush()
        except (BrokenPipeError, OSError):
            pass          # already dying; the EOF marker handles replay

    def _dispatch_locked(self) -> None:
        if (self._fatal is not None or self._closed
                or self._procs is None):
            return
        base = min(self._cursors.values()) if self._cursors else 0
        while (self._next_dispatch < self._steps
               and self._next_dispatch < base + self._window_cap):
            pos = self._next_dispatch
            self._next_dispatch += 1
            slot = pos % self._workers
            tag = f"g{self._gen}p{pos}"
            self._inflight[slot].append((tag, pos))
            self._send_locked(slot, tag, pos)
        self._g_inflight.set(sum(len(fl) for fl in self._inflight))

    # ----------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Shut the pool down: close worker stdin (they exit after
        finishing in-flight work), join readers + supervisor, unlink
        every outstanding shared-memory segment. Idempotent."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._gen += 1
            procs = list(self._procs) if self._procs is not None else []
            self._cond.notify_all()
        for p in procs:
            try:
                p.stdin.close()
            except OSError:
                pass
        deadline = _time.monotonic() + 10.0
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - _time.monotonic()))
            except Exception:
                try:
                    p.kill()
                    p.wait(timeout=5)
                except Exception:
                    pass
        for t in list(self._readers):
            t.join(timeout=5)
        if self._sup is not None:
            # FIFO: every reader line/EOF precedes this sentinel, so the
            # supervisor has unlinked every reported segment by exit
            self._rq.put((-1, "exit", None))
            self._sup.join(timeout=5)
            self._sup = None
        with self._cond:
            for slot, fl in enumerate(self._inflight):
                pid = procs[slot].pid if slot < len(procs) else None
                for tag, _pos in fl:
                    if pid is not None:
                        _unlink_shm(f"mxtpu{pid}x{tag}")
                fl.clear()
            self._window.clear()
            self._g_depth.set(0)
            self._g_inflight.set(0)
        if self._cfg_path:
            try:
                os.unlink(self._cfg_path)
            except OSError:
                pass
            self._cfg_path = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
