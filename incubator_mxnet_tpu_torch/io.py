"""Data iterators.

Counterpart of ``incubator_mxnet_tpu/io.py`` (ref: python/mxnet/io/io.py —
DataDesc, DataBatch, DataIter:178, ResizeIter, PrefetchingIter,
NDArrayIter:489; C++ iterators src/io/iter_mnist.cc,
iter_image_recordio_2.cc).

Where arrays land: an iterator makes its NDArrays on the current context
of the thread that calls ``next()`` (the card by default, the CPU inside
``with mx.cpu():``), as the reference's land on JAX's default device.
``PrefetchingIter`` runs its sources under the context current where it
was made. ``DevicePrefetcher`` runs its source under ``cpu()`` in its
producer thread, so the batches are host arrays, then stages them in
pinned memory and copies them to its device on a CUDA stream of its own;
the consumer's stream waits for each copy before the batch is handed out.

``ImageRecordIter`` takes, in the reference's order, the native threaded
pipeline (``_native.ImageRecordPipeline``), the process pool of
``_recdecode.py`` workers (``preprocess_procs > 0`` without the native
library) or the in-process Python route; ``route`` says which.
"""
from __future__ import annotations

import collections
import logging
import os
import queue as _queue_mod
import threading
import time as _time
import weakref
from collections import namedtuple
from typing import List, Optional

import numpy as _np
import torch

from .context import cpu, current_context, resolve_device
from .ndarray import sparse as _sp
from .ndarray.ndarray import NDArray, _wrap, array as nd_array, concat

__all__ = ["DataDesc", "DataBatch", "DataIter", "ResizeIter",
           "PrefetchingIter", "DevicePrefetcher", "NDArrayIter", "MNISTIter",
           "ImageRecordIter", "CSVIter", "LibSVMIter", "device_transfer"]

_LOG = logging.getLogger(__name__)

STALL_COUNTER = "mxtpu_pipeline_stall_ms"
DEPTH_GAUGE = "mxtpu_pipeline_depth"


def _join_prefetch_threads(threads, wake, deadline: float = 5.0) -> None:
    """Wake the worker threads (they may be parked on an Event or a Queue)
    and join each within ``deadline`` seconds, so ``close()`` never hangs
    on a stuck source; daemon threads that outlive it exit with the
    process."""
    end = _time.monotonic() + deadline
    for t in threads:
        while t.is_alive() and _time.monotonic() < end:
            wake()
            t.join(timeout=0.05)


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """(ref: io.py:DataDesc)"""

    def __new__(cls, name, shape, dtype=_np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return f"DataDesc[{self.name},{self.shape},{self.dtype},{self.layout}]"

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch:
    """(ref: io.py:DataBatch)"""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None:
            assert isinstance(data, (list, tuple)), \
                "Data must be list of NDArrays"
        if label is not None:
            assert isinstance(label, (list, tuple)), \
                "Label must be list of NDArrays"
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data]
        label_shapes = [l.shape for l in self.label] if self.label else None
        return (f"{self.__class__.__name__}: data shapes: {data_shapes} "
                f"label shapes: {label_shapes}")


class DataIter:
    """Base iterator (ref: io.py:178 DataIter)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


class ResizeIter(DataIter):
    """Resize epoch length (ref: io.py:ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size
        if hasattr(data_iter, "default_bucket_key"):
            self.default_bucket_key = data_iter.default_bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Thread-prefetching composite iterator (ref: io.py:PrefetchingIter;
    C++ analog src/io/iter_prefetcher.h).

    One thread a source, each running under the context current where the
    iterator was made. ``close()`` (or leaving a ``with``) joins them; a
    thread holds only a weak reference while parked, so an iterator that
    is dropped unclosed is still collected. A source error re-raises in
    the consumer, naming the shard and, where the error carries them, the
    record file and byte offset."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        assert self.n_iter > 0
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0].shape[0] * self.n_iter
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()
        self.started = True
        self.current_batch = [None for _ in range(self.n_iter)]
        self.next_batch = [None for _ in range(self.n_iter)]
        self._errors: List[Optional[BaseException]] = \
            [None for _ in range(self.n_iter)]
        ctx = current_context()

        def prefetch_func(ref, i):
            while True:
                self = ref()
                if self is None or not self.started:
                    return
                taken = self.data_taken[i]
                del self
                if not taken.wait(timeout=0.1):
                    continue
                self = ref()
                if self is None or not self.started:
                    return
                try:
                    with ctx:
                        self.next_batch[i] = self.iters[i].next()
                except StopIteration:
                    self.next_batch[i] = None
                except BaseException as e:
                    self._errors[i] = e
                    self.next_batch[i] = None
                self.data_taken[i].clear()
                self.data_ready[i].set()
        self.prefetch_threads = [
            threading.Thread(target=prefetch_func,
                             args=(weakref.ref(self), i), daemon=True)
            for i in range(self.n_iter)]
        for thread in self.prefetch_threads:
            thread.start()

    def close(self):
        """Stop and join the prefetch threads. Idempotent; the iterator is
        unusable after."""
        self.started = False

        def wake():
            for e in self.data_taken:
                e.set()
        _join_prefetch_threads(getattr(self, "prefetch_threads", []), wake)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _raise_worker_error(self):
        for i, e in enumerate(self._errors):
            if e is not None:
                self._errors[i] = None
                where = f"shard {i}/{self.n_iter}"
                uri = getattr(e, "mxtpu_uri", None)
                off = getattr(e, "mxtpu_offset", None)
                if uri is not None:
                    where += f" ({uri}" + \
                        (f" @ byte {off})" if off is not None else ")")
                err = RuntimeError(
                    f"PrefetchingIter worker {i} failed on its source "
                    f"iterator [{where}]: {e}")
                err.mxtpu_shard = i
                err.mxtpu_uri = uri
                err.mxtpu_offset = off
                raise err from e

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(x, DataDesc) else DataDesc(*x)
                     for x in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(x, DataDesc) else DataDesc(*x)
                     for x in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)], [])

    def reset(self):
        # wait for every fetch started before the reset, so none of them
        # can deliver a batch of the old epoch after it
        if not self.started:
            raise RuntimeError("PrefetchingIter is closed")
        for e in self.data_ready:
            while not e.wait(timeout=1.0):
                self._raise_worker_error()
        self._raise_worker_error()
        for i in self.iters:
            i.reset()
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def iter_next(self):
        if not self.started:
            return False
        for e in self.data_ready:
            while not e.wait(timeout=1.0):
                self._raise_worker_error()
        self._raise_worker_error()
        if self.next_batch[0] is None:
            return False
        self.current_batch = self.next_batch[0]
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


# ---------------------------------------------------------------------------
# the device prefetcher
# ---------------------------------------------------------------------------

def _mesh_block(t, device, sharded):
    """(this rank's block of the batch leaf ``t`` along dim 0 under the
    current mesh's data sharding, the mesh's device), or None: with an
    explicit ``device``, ``sharded=False``, no mesh, a data axis of one,
    or a batch that does not split evenly (the reference's rule, which
    then replicates)."""
    if device is not None or sharded is False:
        return None
    from .parallel.mesh import _block, data_sharding, get_mesh
    spec = data_sharding(t.shape[0] if t.dim() else None)
    if spec is None:
        return None
    mesh = get_mesh()
    return _block(t, spec, mesh), mesh.device


def _leaf_tensor(a):
    """(tensor, kind) of a batch leaf: an NDArray, a tensor or a numpy
    array (narrowed to the reference's 32-bit types); (None, None) for
    anything else, which passes through."""
    if isinstance(a, NDArray):
        return a._data, "nd"
    if isinstance(a, torch.Tensor):
        return a, "tensor"
    if isinstance(a, _np.ndarray):
        return nd_array(a, ctx=cpu())._data, "nd"
    return None, None


def device_transfer(a, device=None, sharded=None):
    """One batch leaf on ``device`` (a torch device or name; None is the
    current context's): NDArrays and numpy arrays come back as NDArrays,
    tensors as tensors, anything else as it is. A copy from the host is
    synchronous here; ``DevicePrefetcher`` does the asynchronous one.
    With no ``device`` and a current mesh (unless ``sharded=False``) the
    leaf comes back as this rank's block of the batch over the mesh's data
    axis, on the mesh's device (:func:`_mesh_block`)."""
    t, kind = _leaf_tensor(a)
    if t is None:
        return a
    blk = _mesh_block(t, device, sharded)
    if blk is not None:
        t, dev = blk
    else:
        dev = (current_context().torch_device if device is None
               else resolve_device(device))
    out = t.to(dev)
    return _wrap(out) if kind == "nd" else out


def _map_leaves(batch, fn):
    """``batch`` (a DataBatch, a list or tuple of them or of leaves, or a
    leaf) with every leaf replaced by ``fn(leaf)``."""
    if isinstance(batch, DataBatch):
        return DataBatch(
            data=[fn(a) for a in batch.data]
            if batch.data is not None else None,
            label=[fn(a) for a in batch.label]
            if batch.label is not None else None,
            pad=batch.pad, index=batch.index, bucket_key=batch.bucket_key,
            provide_data=batch.provide_data,
            provide_label=batch.provide_label)
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map_leaves(b, fn) for b in batch)
    return fn(batch)


def _device_prefetch_put(ref, gen: int, item) -> bool:
    """Bounded put for the producer: gives up when a ``reset()`` or
    ``close()`` superseded its generation, or when the prefetcher was
    collected; holds only a weak reference while it waits."""
    while True:
        self = ref()
        if self is None or not self._live(gen):
            return False
        q = self._queue
        del self
        try:
            q.put((gen,) + item, timeout=0.05)
            return True
        except _queue_mod.Full:
            continue


def _device_prefetch_produce(ref, gen: int):
    """The producer loop, a daemon thread holding only a weak reference to
    the prefetcher between batches: dropping the last strong reference
    ends it."""
    from . import chaos as _chaos
    it = None
    try:
        while True:
            self = ref()
            if self is None or not self._live(gen):
                return
            with cpu():
                if it is None:
                    it = iter(self._source)
                if _chaos.should_fail("pipeline.stall"):
                    _time.sleep(self.STALL_CHAOS_S)
                try:
                    batch = next(it)
                except StopIteration:
                    _device_prefetch_put(ref, gen, ("done", None))
                    return
            item = ("ok", self._to_device(batch))
            del self
            if not _device_prefetch_put(ref, gen, item):
                return
    except BaseException as e:
        _device_prefetch_put(ref, gen, ("err", e))


class DevicePrefetcher(DataIter):
    """Moves the next ``depth`` batches of a source to the device on a
    background thread, so a training step reads device-resident arrays
    while the host decodes, batches and copies the steps after it (ref:
    the reference's ``io.DevicePrefetcher``).

    ``source`` is any ``DataIter``, gluon ``DataLoader`` or iterable of
    batches; it runs in the producer thread under ``cpu()``, so its
    arrays are host arrays. ``depth`` defaults to ``MXTPU_PREFETCH_DEPTH``
    (2); ``device`` to the current context's device (the card by
    default). On a CUDA device each batch is staged in pinned host memory
    and copied with ``non_blocking=True`` on a stream of the prefetcher's
    own, which records an event; ``next()`` makes the consumer's current
    stream wait on that event and calls ``record_stream`` on every
    delivered tensor, so neither the step's read nor the allocator's reuse
    of the memory can overtake the copy. A leaf already on the device
    passes as it is.

    A generation count makes ``reset()`` safe mid-epoch (batches of the
    old generation are dropped, never delivered); ``close()`` joins the
    producer. The chaos point ``pipeline.stall`` delays the producer: the
    consumer then blocks, and no batch is reordered or dropped. Telemetry:
    ``mxtpu_pipeline_stall_ms`` (counter, ms the consumer waited for a
    batch), ``mxtpu_pipeline_depth`` (gauge, batches queued when the
    consumer fetched) and a ``prefetch_wait`` span for every wait.
    With no ``device`` and a current mesh (unless ``sharded=False``) each
    leaf is cut to this rank's block over the mesh's data axis on the host
    and copied to the mesh's device (``device_transfer``'s rule)."""

    #: producer-side sleep per fired ``pipeline.stall`` chaos eval
    STALL_CHAOS_S = 0.05

    def __init__(self, source, depth: Optional[int] = None, sharded=None,
                 device=None):
        super().__init__(getattr(source, "batch_size", 0))
        from .parallel.mesh import get_mesh
        mesh = get_mesh() if device is None and sharded is not False \
            else None
        self._sharded = mesh is not None
        if mesh is not None:
            device = mesh.device
        if depth is None:
            depth = int(os.environ.get("MXTPU_PREFETCH_DEPTH", "2"))
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.depth = int(depth)
        self.device = (current_context().torch_device if device is None
                       else resolve_device(device))
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._source = source
        self._lock = threading.Lock()
        self._gen = 0
        self._closed = False
        self._queue: "_queue_mod.Queue" = _queue_mod.Queue(maxsize=self.depth)
        self._thread: Optional[threading.Thread] = None
        from . import telemetry as _telemetry
        self._c_stall = _telemetry.counter(
            STALL_COUNTER, "Milliseconds the consumer of a DevicePrefetcher "
            "waited for a batch.")
        self._c_depth = _telemetry.gauge(
            DEPTH_GAUGE, "Batches a DevicePrefetcher held when its consumer "
            "fetched one.")
        self._start()

    # ------------------------------------------------------------- producer
    def _start(self):
        with self._lock:
            if self._closed:
                raise RuntimeError("DevicePrefetcher is closed")
            gen = self._gen
        self._thread = threading.Thread(
            target=_device_prefetch_produce, args=(weakref.ref(self), gen),
            name="mxtpu-device-prefetch", daemon=True)
        self._thread.start()

    def _live(self, gen: int) -> bool:
        with self._lock:
            return gen == self._gen and not self._closed

    def _to_device(self, batch):
        """(the batch on the device, the copy's event or None, its tensors
        on the device)."""
        if self._stream is None:
            return _map_leaves(batch, lambda a: self._transfer(a)), None, ()
        moved = []

        def move(a):
            t, kind = _leaf_tensor(a)
            if t is None:
                return a
            blk = _mesh_block(t, None, None) if self._sharded else None
            if blk is not None:
                t = blk[0]
            if t.device != self.device:
                if t.device.type == "cpu" and not t.is_pinned():
                    t = t.pin_memory()
                t = t.to(self.device, non_blocking=True)
                moved.append(t)
            return _wrap(t) if kind == "nd" else t
        with torch.cuda.stream(self._stream):
            out = _map_leaves(batch, move)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event, tuple(moved)

    def _transfer(self, a):
        if not self._sharded:
            return device_transfer(a, self.device)
        t, kind = _leaf_tensor(a)
        blk = _mesh_block(t, None, None) if t is not None else None
        if blk is None:
            return device_transfer(a, self.device)
        out = blk[0].to(self.device)
        return _wrap(out) if kind == "nd" else out

    # ------------------------------------------------------------- consumer
    def next(self):
        if self._thread is None:
            self._start()
        while True:
            try:
                gen, kind, item = self._queue.get_nowait()
                waited = 0.0
            except _queue_mod.Empty:
                t0 = _time.perf_counter()
                gen, kind, item = self._queue.get()
                waited = _time.perf_counter() - t0
            if gen != self._gen:
                continue
            self._c_stall.inc(waited * 1e3)
            self._c_depth.set(self._queue.qsize())
            if waited > 0.0:
                from . import telemetry as _telemetry
                _telemetry.observe_span("prefetch_wait", waited,
                                        depth=self._queue.qsize())
            if kind == "err":
                self._thread = None
                raise item
            if kind == "done":
                self._thread = None
                raise StopIteration
            out, event, moved = item
            if event is not None:
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(event)
                for t in moved:
                    t.record_stream(cur)
            return out

    def iter_next(self):
        try:
            self.current_batch = self.next()
            return True
        except StopIteration:
            return False

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad

    @property
    def provide_data(self):
        return getattr(self._source, "provide_data", None)

    @property
    def provide_label(self):
        return getattr(self._source, "provide_label", None)

    # ------------------------------------------------------------ lifecycle
    def _retire(self):
        """End the current generation, unblock and join the producer, and
        drop the batches it queued."""
        with self._lock:
            self._gen += 1
        thread, self._thread = self._thread, None

        def wake():
            try:
                self._queue.get_nowait()
            except _queue_mod.Empty:
                pass
        if thread is not None:
            _join_prefetch_threads([thread], wake)
        while True:
            try:
                self._queue.get_nowait()
            except _queue_mod.Empty:
                break

    def reset(self):
        if self._closed:
            raise RuntimeError("DevicePrefetcher is closed")
        self._retire()
        if hasattr(self._source, "reset"):
            self._source.reset()
        self._start()

    def quiesce(self):
        """Stop and join the producer and drop the queued batches; the
        next ``next()`` (or ``reset()``) starts it again."""
        if self._closed:
            raise RuntimeError("DevicePrefetcher is closed")
        self._retire()

    def elastic_rebuild(self, view):
        """Adopt a new ``elastic.GroupView``: quiesce, then hand the view
        to the source's own ``elastic_rebuild`` (``InputService``
        re-points its per-rank slicing); the next ``next()`` restarts the
        producer."""
        self.quiesce()
        rb = getattr(self._source, "elastic_rebuild", None)
        if rb is not None:
            rb(view)

    def set_epoch(self, epoch: int):
        """Forward an epoch to a source that orders by it."""
        se = getattr(self._source, "set_epoch", None)
        if se is not None:
            se(epoch)

    def close(self, close_source: bool = False):
        """Stop and join the producer; with ``close_source`` the source's
        own ``close()`` too. Idempotent."""
        if self._closed:
            return
        self._retire()
        self._closed = True
        if close_source and hasattr(self._source, "close"):
            self._source.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# in-memory iterators
# ---------------------------------------------------------------------------

def _init_data(data, allow_empty, default_name):
    """(ref: io.py:_init_data)"""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (_np.ndarray, NDArray, _sp.BaseSparseNDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = collections.OrderedDict([(default_name, data[0])])
        else:
            data = collections.OrderedDict(
                [(f"_{i}_{default_name}", d) for i, d in enumerate(data)])
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of "
                        "them or dict with them as values")
    for k, v in data.items():
        if not isinstance(v, (NDArray, _sp.BaseSparseNDArray)):
            try:
                data[k] = nd_array(v)
            except Exception:
                raise TypeError(f"Invalid type '{type(v)}' for {k}")
    return list(data.items())


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (ref: io.py:489 NDArrayIter): shuffle
    (numpy's global generator), and a last batch padded, discarded or
    rolled over. CSR data is sliced a batch at a time, in order, with the
    last partial batch discarded (as in the reference)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        if any(isinstance(v, _sp.BaseSparseNDArray)
               for _, v in self.data + self.label) \
                and last_batch_handle != "discard":
            raise NotImplementedError(
                "`NDArrayIter` only supports ``CSRNDArray`` with "
                "`last_batch_handle` set to `discard`.")
        self.idx = _np.arange(self.data[0][1].shape[0])
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.batch_size = batch_size
        self.cursor = -self.batch_size
        self.num_data = self.idx.shape[0]
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype) for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype) for k, v in self.label]

    def hard_reset(self):
        if self.shuffle:
            self._shuffle_data()
        self.cursor = -self.batch_size

    def reset(self):
        if self.shuffle:
            self._shuffle_data()
        if (self.last_batch_handle == "roll_over"
                and 0 < self.cursor < self.num_data):
            self.cursor = -self.batch_size + (self.cursor % self.num_data) \
                % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if not self.iter_next():
            raise StopIteration
        data = self.getdata()
        label = self.getlabel()
        if data[0].shape[0] != self.batch_size:
            if self.last_batch_handle == "discard":
                raise StopIteration
            if self.last_batch_handle == "pad":
                data = self._pad_batch(data)
                label = self._pad_batch(label)
        return DataBatch(data=data, label=label, pad=self.getpad(),
                         index=None)

    def _pad_batch(self, arrs):
        out = []
        for a in arrs:
            n_missing = self.batch_size - a.shape[0]
            if n_missing:
                filler = a[0:1].tile([n_missing] + [1] * (a.ndim - 1))
                a = concat(a, filler, dim=0)
            out.append(a)
        return out

    def _getdata(self, data_source, start, end):
        sel = self.idx[start:end]
        return [x.slice((start,), (end,)) if isinstance(x, _sp.CSRNDArray)
                else x.take(nd_array(sel, ctx=x.context, dtype="int32"),
                            axis=0)
                if self.shuffle else x[start:end] for _, x in data_source]

    def getdata(self):
        end = min(self.cursor + self.batch_size, self.num_data)
        return self._getdata(self.data, self.cursor, end)

    def getlabel(self):
        end = min(self.cursor + self.batch_size, self.num_data)
        return self._getdata(self.label, self.cursor, end)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0

    def _shuffle_data(self):
        _np.random.shuffle(self.idx)


class MNISTIter(NDArrayIter):
    """MNIST iterator (ref: src/io/iter_mnist.cc:80): the idx files when
    present, else ``gluon.data.vision.MNIST``'s seeded synthetic set."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, silent=False, seed=0,
                 input_shape=None, **kwargs):
        from .gluon.data.vision.datasets import MNIST as _MNIST
        root = os.path.dirname(image) or os.path.join(
            "~", ".mxtpu", "datasets", "mnist")
        train = "train" in os.path.basename(image)
        ds = _MNIST(root=root, train=train)
        imgs = ds._data.asnumpy().astype(_np.float32) / 255.0
        if flat:
            imgs = imgs.reshape(len(imgs), -1)
        else:
            imgs = imgs.transpose(0, 3, 1, 2)
        labels = _np.asarray(ds._label, _np.float32)
        super().__init__(imgs, labels, batch_size, shuffle,
                         last_batch_handle="discard")


class CSVIter(DataIter):
    """CSV iterator (ref: src/io/iter_csv.cc CSVIter)."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=128, round_batch=True,
                 **kwargs):
        super().__init__(batch_size)
        data = _np.loadtxt(data_csv, delimiter=",", dtype=_np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        label = (_np.loadtxt(label_csv, delimiter=",", dtype=_np.float32)
                 if label_csv else _np.zeros(len(data), _np.float32))
        self._inner = NDArrayIter(data, label, batch_size,
                                  last_batch_handle="pad" if round_batch
                                  else "discard")
        self.provide_data = self._inner.provide_data
        self.provide_label = self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def iter_next(self):
        return self._inner.iter_next()


class LibSVMIter(DataIter):
    """LibSVM sparse-format iterator (ref: src/io/iter_libsvm.cc): each
    line ``label idx:value ...``; yields CSR data batches of
    ``data_shape`` features and dense labels, the last partial batch
    discarded."""

    def __init__(self, data_libsvm, data_shape, label_shape=(1,),
                 batch_size=128, **kwargs):
        super().__init__(batch_size)
        n_features = data_shape[0] if isinstance(data_shape, (tuple, list)) \
            else data_shape
        rows, cols, vals, labels = [], [], [], []
        with open(data_libsvm) as f:
            for line in f:
                parts = line.strip().split()
                if not parts:
                    continue
                for tok in parts[1:]:
                    j, v = tok.split(":")
                    rows.append(len(labels))
                    cols.append(int(j))
                    vals.append(float(v))
                labels.append(float(parts[0]))
        dense = _np.zeros((len(labels), n_features), _np.float32)
        dense[rows, cols] = vals
        csr = _sp.csr_matrix(nd_array(dense))
        self._inner = NDArrayIter(csr, _np.asarray(labels, _np.float32),
                                  batch_size, last_batch_handle="discard")
        self.provide_data = self._inner.provide_data
        self.provide_label = self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def iter_next(self):
        return self._inner.iter_next()


# ---------------------------------------------------------------------------
# image records
# ---------------------------------------------------------------------------

def _scan_record_offsets(path):
    """Byte offsets of every record in a RecordIO file (a walk over the
    headers, no payload read); a torn final record is not indexed."""
    import struct as _struct
    magic_word = 0xced7230a
    lflag_bits = 29
    lflag_mask = (1 << lflag_bits) - 1
    offsets = []
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        pos = 0
        while True:
            start = pos
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    return offsets
                magic, lword = _struct.unpack("<II", hdr)
                if magic != magic_word:
                    raise IOError(f"corrupt RecordIO at {pos}")
                cflag = lword >> lflag_bits
                length = lword & lflag_mask
                skip = length + ((-length) % 4)
                f.seek(skip, 1)
                pos += 8 + skip
                if pos > size:
                    return offsets
                if cflag in (0, 3):
                    break
            offsets.append(start)


def _resize_np(img, w, h):
    """Nearest-neighbour resize (the reference's, without cv2)."""
    ys = (_np.arange(h) * img.shape[0] / h).astype(_np.int64)
    xs = (_np.arange(w) * img.shape[1] / w).astype(_np.int64)
    return img[ys][:, xs]


class ImageRecordIter(DataIter):
    """Image RecordIO iterator (ref: src/io/iter_image_recordio_2.cc:736):
    decodes and augments record packs into batches, NCHW float32
    normalised, or NHWC uint8 with ``dtype="uint8"`` (raw pixels for
    normalisation on the device).

    Its routes, in the reference's order: ``"native"``, the threaded C++
    pipeline (``preprocess_procs`` or ``preprocess_threads`` workers; a
    sample's augmentation is seeded by (seed, sample, epoch), so batches
    do not depend on the worker count); ``"procs"``, ``preprocess_procs``
    ``_recdecode.py`` processes over shared memory when the native
    library is unavailable; ``"python"``, in this process. ``route``
    holds the one taken, and a route other than the native one is logged
    with the reason. A final partial batch wraps to the epoch's start and
    reports the wrapped count in ``pad``."""

    def __init__(self, path_imgrec=None, path_imgidx=None,
                 data_shape=(3, 224, 224), batch_size=128, shuffle=False,
                 rand_crop=False, rand_mirror=False, mean_r=0, mean_g=0,
                 mean_b=0, std_r=1, std_g=1, std_b=1, preprocess_threads=4,
                 label_width=1, resize=0, seed=0, preprocess_procs=0,
                 dtype="float32", **kwargs):
        super().__init__(batch_size)
        from .recordio import IndexedRecordIO, RecordIO
        from . import _native
        self._data_shape = tuple(data_shape)
        self._shuffle = shuffle
        self._rand_crop = rand_crop
        self._rand_mirror = rand_mirror
        self._label_width = label_width
        self._resize = resize
        self._rng = _np.random.RandomState(seed)
        self._last_pad = 0
        self._dtype = dtype
        self._mean = _np.array([mean_r, mean_g, mean_b],
                               _np.float32).reshape(3, 1, 1)
        self._std = _np.array([std_r, std_g, std_b],
                              _np.float32).reshape(3, 1, 1)
        self._pipe = None
        self._procs = None
        self._pending = None
        if path_imgrec and not _native.available():
            _LOG.warning("ImageRecordIter: no native pipeline (%s); "
                         "decoding with PIL on the %s route",
                         _native.load_error(),
                         "procs" if preprocess_procs > 0 else "python")
        if path_imgrec and _native.available():
            try:
                self._pipe = _native.ImageRecordPipeline(
                    path_imgrec, batch_size, self._data_shape,
                    label_width=label_width, shuffle=shuffle, seed=seed,
                    num_workers=(preprocess_procs if preprocess_procs > 0
                                 else preprocess_threads),
                    rand_crop=rand_crop, rand_mirror=rand_mirror,
                    resize=resize, mean=[mean_r, mean_g, mean_b],
                    std=[std_r, std_g, std_b], emit_uint8=(dtype == "uint8"))
                self.route = "native"
                return
            except RuntimeError as e:
                _LOG.warning("ImageRecordIter: the native pipeline refused "
                             "%s (%s); decoding with PIL", path_imgrec, e)
                self._pipe = None
        if path_imgrec and preprocess_procs > 0:
            self.route = "procs"
            self._init_procs(path_imgrec, preprocess_procs, seed)
            return
        self.route = "python"
        if path_imgidx:
            self._rec = IndexedRecordIO(path_imgidx, path_imgrec, "r")
            self._keys = list(self._rec.keys)
        else:
            self._rec = RecordIO(path_imgrec, "r")
            self._keys = None
            self._records = []
            while True:
                item = self._rec.read()
                if item is None:
                    break
                self._records.append(item)
        self._order = None
        self.reset()

    @property
    def provide_data(self):
        if self._dtype == "uint8" and self.route in ("native", "procs"):
            c, h, w = self._data_shape
            return [DataDesc("data", (self.batch_size, h, w, c),
                             dtype=_np.uint8, layout="NHWC")]
        return [DataDesc("data", (self.batch_size,) + self._data_shape)]

    @property
    def provide_label(self):
        if self._label_width == 1:
            return [DataDesc("softmax_label", (self.batch_size,))]
        return [DataDesc("softmax_label",
                         (self.batch_size, self._label_width))]

    def _init_procs(self, path, n_procs, seed):
        import json as _json
        import subprocess as _subprocess
        import sys as _sys
        from multiprocessing import shared_memory
        # plain subprocesses and pipes: fork would copy a live CUDA
        # context, and spawn re-imports __main__
        self._offsets = _scan_record_offsets(path)
        self._rec_path = path
        c, h, w = self._data_shape
        bs = self.batch_size
        slot_bytes = bs * h * w * c + bs * self._label_width * 4
        self._n_slots = max(2 * n_procs, 4)
        self._shms = [shared_memory.SharedMemory(create=True,
                                                 size=slot_bytes)
                      for _ in range(self._n_slots)]
        worker_py = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "_recdecode.py")
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        self._result_q = _queue_mod.Queue()
        self._procs = []
        self._readers = []
        for i in range(n_procs):
            pr = _subprocess.Popen(
                [_sys.executable, worker_py], stdin=_subprocess.PIPE,
                stdout=_subprocess.PIPE, env=env, text=True, bufsize=1)
            cfg = dict(rec_path=path, offsets=list(map(int, self._offsets)),
                       shape=[c, h, w], label_width=self._label_width,
                       resize=self._resize, rand_crop=self._rand_crop,
                       rand_mirror=self._rand_mirror, seed=seed + 13 * i,
                       shm_names=[sh.name for sh in self._shms])
            pr.stdin.write(_json.dumps(cfg) + "\n")
            pr.stdin.flush()
            th = threading.Thread(target=self._reader_loop, args=(pr,),
                                  daemon=True)
            th.start()
            self._procs.append(pr)
            self._readers.append(th)
        self._rr = 0
        self._epoch_order = None
        self.reset()

    def _reader_loop(self, pr):
        for line in pr.stdout:
            line = line.strip()
            if line:
                # slot:count[:skipped]
                fields = line.split(":")
                nskip = int(fields[2]) if len(fields) > 2 else 0
                if nskip:
                    from .input_service import record_skips
                    record_skips([[self._rec_path, -1,
                                   "decode: worker-quarantined record"]]
                                 * nskip, pool="imgrec")
                self._result_q.put((int(fields[0]), int(fields[1])))
        self._result_q.put(("__worker_dead__", pr.pid))

    def _mp_dispatch(self):
        """Send decode tasks to the workers in turn, one a free slot."""
        n = len(self._offsets)
        while self._free_slots and self._next_task * self.batch_size < n:
            start = self._next_task * self.batch_size
            idxs = ",".join(str(int(self._epoch_order[(start + i) % n]))
                            for i in range(self.batch_size))
            slot = self._free_slots.pop()
            pr = self._procs[self._rr % len(self._procs)]
            self._rr += 1
            try:
                pr.stdin.write(f"{slot}:{idxs}\n")
                pr.stdin.flush()
            except BrokenPipeError:
                raise RuntimeError("decode worker died; check stderr of the "
                                   "worker process") from None
            pad = max(0, (self._next_task + 1) * self.batch_size - n)
            self._slot_seq[slot] = (self._next_task, pad)
            self._inflight += 1
            self._next_task += 1

    def _mp_close(self):
        if self._procs:
            procs, self._procs = self._procs, None
            for pr in procs:
                try:
                    pr.stdin.close()
                except OSError:
                    pass
            for pr in procs:
                try:
                    pr.wait(timeout=5)
                except Exception:
                    pr.kill()
            for sh in self._shms:
                try:
                    sh.close()
                    sh.unlink()
                except FileNotFoundError:
                    pass

    def close(self):
        if self._procs is not None:
            self._mp_close()
        if self._pipe is not None:
            self._pipe.close()
            self._pipe = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def reset(self):
        if self._procs is not None:
            # drain in-flight work so no slot is handed out twice
            while getattr(self, "_inflight", 0):
                if self._done:
                    _seq, (slot, _bs, _pad) = self._done.popitem()
                    self._free_slots.append(slot)
                    self._inflight -= 1
                    continue
                slot, _bs = self._result_q.get()
                if slot == "__worker_dead__":
                    raise RuntimeError(
                        f"decode worker pid {_bs} died; see its stderr")
                self._free_slots.append(slot)
                self._slot_seq.pop(slot, None)
                self._inflight -= 1
            n = len(self._offsets)
            self._epoch_order = (self._rng.permutation(n) if self._shuffle
                                 else _np.arange(n))
            self._free_slots = list(range(self._n_slots))
            self._inflight = 0
            self._next_task = 0
            self._next_yield = 0
            self._slot_seq = {}
            self._done = {}
            self._pending = None
            self._mp_dispatch()
            return
        if self._pipe is not None:
            self._pipe.reset()
            self._pending = None
            return
        n = len(self._keys) if self._keys is not None else len(self._records)
        self._order = (self._rng.permutation(n) if self._shuffle
                       else _np.arange(n))
        self._cursor = 0

    def iter_next(self):
        if self._procs is not None:
            # workers finish out of order: hold results in a reorder
            # buffer and hand them out in dispatch order
            if self._pending is None and (self._inflight or self._done):
                while self._next_yield not in self._done:
                    slot, bs = self._result_q.get()
                    if slot == "__worker_dead__":
                        raise RuntimeError(
                            f"decode worker pid {bs} died mid-epoch (bad "
                            "record or crash); see its stderr")
                    seq, pad = self._slot_seq.pop(slot)
                    self._done[seq] = (slot, bs, pad)
                slot, bs, pad = self._done.pop(self._next_yield)
                self._cur_pad = pad
                self._next_yield += 1
                self._inflight -= 1
                c, h, w = self._data_shape
                img = _np.ndarray((bs, h, w, c), _np.uint8,
                                  buffer=self._shms[slot].buf)
                lab = _np.ndarray((bs, self._label_width), _np.float32,
                                  buffer=self._shms[slot].buf,
                                  offset=bs * h * w * c)
                if self._dtype == "uint8":
                    data = img.copy()
                else:
                    data = ((img.transpose(0, 3, 1, 2).astype(_np.float32)
                             - self._mean) / self._std)
                labels = lab.copy()
                self._free_slots.append(slot)
                self._mp_dispatch()
                self._pending = (data, labels)
            return self._pending is not None
        if self._pipe is not None:
            if self._pending is None:
                self._pending = self._pipe.next_batch()
            return self._pending is not None
        return self._cursor < len(self._order)

    def _batch(self, data, label, pad):
        self._last_pad = pad
        lab = label[:, 0] if self._label_width == 1 else label
        return DataBatch(data=[nd_array(data)], label=[nd_array(lab)],
                         pad=pad)

    def next(self):
        from .recordio import unpack_img
        if self._procs is not None:
            if not self.iter_next():
                raise StopIteration
            data, label = self._pending
            self._pending = None
            return self._batch(data, label, getattr(self, "_cur_pad", 0))
        if self._pipe is not None:
            if not self.iter_next():
                raise StopIteration
            data, label, pad = self._pending
            self._pending = None
            return self._batch(data, label, pad)
        if not self.iter_next():
            raise StopIteration
        imgs, labels = [], []
        n = len(self._order)
        pad = max(0, self._cursor + self.batch_size - n)
        c, h, w = self._data_shape
        for i in range(self.batch_size):
            idx = self._order[(self._cursor + i) % n]
            raw = (self._rec.read_idx(self._keys[idx])
                   if self._keys is not None else self._records[idx])
            header, img = unpack_img(raw)
            img = img.astype(_np.float32)
            if img.ndim == 2:
                img = img[:, :, None]
            # the native pipeline's order: resize the shorter side, crop
            # (random or centre), mirror, normalise
            if self._resize > 0 and min(img.shape[:2]) != self._resize:
                r = self._resize / min(img.shape[:2])
                nh = max(h, int(img.shape[0] * r + 0.5))
                nw = max(w, int(img.shape[1] * r + 0.5))
                img = _resize_np(img, nw, nh)
            if img.shape[0] < h or img.shape[1] < w:
                img = _resize_np(img, w, h)
            if img.shape[0] > h or img.shape[1] > w:
                if self._rand_crop:
                    y0 = self._rng.randint(0, img.shape[0] - h + 1)
                    x0 = self._rng.randint(0, img.shape[1] - w + 1)
                else:
                    y0 = (img.shape[0] - h) // 2
                    x0 = (img.shape[1] - w) // 2
                img = img[y0:y0 + h, x0:x0 + w]
            img = img.transpose(2, 0, 1)[:c]
            if self._rand_mirror and self._rng.rand() < 0.5:
                img = img[:, :, ::-1]
            imgs.append((img - self._mean) / self._std)
            lab = _np.atleast_1d(_np.asarray(header.label, _np.float32))
            row = _np.zeros(self._label_width, _np.float32)
            row[:min(len(lab), self._label_width)] = lab[:self._label_width]
            labels.append(row)
        self._cursor += self.batch_size
        return self._batch(_np.stack(imgs).astype(_np.float32),
                           _np.stack(labels), pad)

    def getpad(self):
        return self._last_pad
