"""Gluon DataLoader.

Counterpart of ``incubator_mxnet_tpu/gluon/data/dataloader.py`` (ref:
python/mxnet/gluon/data/dataloader.py — DataLoader with process workers
over shared memory:26-104, default_batchify_fn, last_batch modes).

Batches are assembled on the host: in this process (``num_workers=0``),
in a producer thread (``thread_pool=True``, the default), or in
``num_workers`` subprocesses (``thread_pool=False``; ``_dataloader_worker
.py`` over shared memory, the dataset and batchify function pickled, so
they must come from importable modules). Workers run with
``CUDA_VISIBLE_DEVICES=""`` and under ``cpu()``, so none of them touches
the card; each reports at exit whether CUDA was initialised in it
(``worker_reports``). A dead worker is respawned and its batches sent
again, at most ``MXTPU_LOADER_RETRIES`` (3) times a batch, so every batch
arrives once and in order.

The loop hands each batch out on the current context of the thread that
iterates (the card by default): with ``device_prefetch`` (a depth, or
``MXTPU_PREFETCH_DEPTH``) through ``io.DevicePrefetcher``, which copies
ahead on a stream of its own; without it, copied when it is handed out.
"""
from __future__ import annotations

import queue
import threading

import numpy as _np
import torch

from ...context import cpu, current_context
from ...ndarray.ndarray import NDArray, _wrap, array as nd_array
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch (ref: dataloader.py:default_batchify_fn)."""
    if isinstance(data[0], NDArray):
        return _wrap(torch.stack([d._data for d in data]))
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(i) for i in data]
    return nd_array(_np.asarray(data))


default_mp_batchify_fn = default_batchify_fn


def _rebuild_tree(struct, arrays, pos=0):
    if struct == "leaf":
        return nd_array(arrays[pos], ctx=cpu()), pos + 1
    out = []
    for st in struct:
        item, pos = _rebuild_tree(st, arrays, pos)
        out.append(item)
    return out, pos


def _from_shm(name, meta):
    """A batch from a worker's shared-memory segment and its JSON meta,
    copied once into host tensors; the segment is unlinked."""
    from multiprocessing import shared_memory
    # attaching registers the name with this process's resource tracker
    # and unlink() unregisters it
    shm = shared_memory.SharedMemory(name=name)
    try:
        arrays = [_np.ndarray(tuple(shape), dtype, buffer=shm.buf,
                              offset=off)
                  for shape, dtype, off in meta["metas"]]
        out, _ = _rebuild_tree(meta["struct"], arrays)
        del arrays
        return out
    finally:
        shm.close()
        shm.unlink()


class DataLoader:
    """(ref: dataloader.py:DataLoader)"""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=True, device_prefetch=None):
        self._dataset = dataset
        self._pin_memory = pin_memory
        # device_prefetch: io.DevicePrefetcher over the host batches;
        # True or a depth turns it on, None defers to MXTPU_PREFETCH_DEPTH
        import os as _os
        if device_prefetch is None:
            device_prefetch = _os.environ.get("MXTPU_PREFETCH_DEPTH")
        if device_prefetch is True:
            # explicit opt-in: the env var may tune the depth but a
            # disabling "0" does not override the constructor argument
            device_prefetch = \
                int(_os.environ.get("MXTPU_PREFETCH_DEPTH") or 0) or 2
        self._device_prefetch = (int(device_prefetch)
                                 if device_prefetch not in (None, False, "")
                                 else 0)
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler "
                                 "is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif (batch_size is not None or shuffle or sampler is not None
              or last_batch is not None):
            raise ValueError("batch_size, shuffle, sampler and last_batch "
                             "must not be specified if batch_sampler is "
                             "specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = num_workers if num_workers >= 0 else 0
        self._thread_pool = thread_pool
        self._prefetch = max(0, int(prefetch) if prefetch is not None
                             else 2 * self._num_workers)
        self._batchify_fn = batchify_fn or default_batchify_fn
        #: one {"pid", "cuda_initialized", "cuda_visible_devices"} a
        #: process worker of the last pass, as it reported at its exit
        self.worker_reports = []

    def _iter_processes(self):
        """Supervised subprocess worker pool, batches returned via shared
        memory (ref: dataloader.py:26-104 _MultiWorkerIter / worker_loop).
        Plain subprocesses: fork would copy the parent's CUDA context,
        and spawn re-imports the parent's __main__.

        A dead worker (chaos kill, segfault in a C extension transform,
        OOM) is detected via EOF/torn output or a broken stdin pipe,
        respawned in its slot, and its in-flight batch indices are
        re-dispatched — the iterator still yields every batch exactly
        once, in order. Retries are bounded per batch
        (MXTPU_LOADER_RETRIES, default 3) so a poison sample that kills
        every worker it touches surfaces as an error, not a livelock.
        Batch->slot assignment is static (seq % num_workers): each worker
        preserves order within its slot, so collection stays strictly
        round-robin even across respawns."""
        import json as _json
        import os as _os
        import pickle as _pickle
        import subprocess as _sp
        import sys as _sys
        import tempfile as _tempfile
        from multiprocessing import shared_memory as _shm

        worker_py = _os.path.join(
            _os.path.dirname(_os.path.abspath(__file__)), "..", "..",
            "_dataloader_worker.py")
        with _tempfile.NamedTemporaryFile(suffix=".pkl",
                                          delete=False) as f:
            _pickle.dump((self._dataset, self._batchify_fn), f)
            cfg_path = f.name
        env = dict(_os.environ, CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=_os.pathsep.join(
                       [p for p in _sys.path if p]))
        n = self._num_workers
        max_retries = int(_os.environ.get("MXTPU_LOADER_RETRIES", "3"))
        respawns = [0] * n
        retries: dict = {}           # seq -> re-dispatch count
        assigned = [[] for _ in range(n)]  # in-flight seqs, dispatch order
        done = {}
        procs = []
        self.worker_reports = []

        def spawn(slot):
            # the chaos salt varies per (slot, incarnation): a respawned
            # worker draws a fresh — still deterministic — fault
            # sequence instead of replaying its predecessor's death
            wenv = dict(env,
                        MXTPU_CHAOS_SALT=f"loader:{slot}:{respawns[slot]}")
            return _sp.Popen([_sys.executable, worker_py, cfg_path],
                             stdin=_sp.PIPE, stdout=_sp.PIPE, env=wenv,
                             text=True, bufsize=1)

        try:
            procs = [spawn(i) for i in range(n)]
            batches = list(self._batch_sampler)
            next_dispatch = 0
            next_yield = 0
            depth = max(self._prefetch, n)

            def send(slot, seq):
                idxs = ",".join(str(int(i)) for i in batches[seq])
                procs[slot].stdin.write(f"{seq}:{idxs}\n")
                procs[slot].stdin.flush()

            def harvest(line, slot):
                """Record one completed batch line; False if torn."""
                if not line.endswith("\n"):
                    return False
                try:
                    seq_s, name, meta = line.strip().split(":", 2)
                    seq = int(seq_s)
                    done[seq] = (name, _json.loads(meta))
                except ValueError:
                    return False
                if seq in assigned[slot]:
                    assigned[slot].remove(seq)
                return True

            def revive(slot):
                """Reap a dead worker, salvage batches it finished before
                dying, reap any shm orphan it left, respawn it,
                re-dispatch the rest of its queue."""
                while True:
                    pr = procs[slot]
                    try:
                        pr.kill()
                    except OSError:
                        pass
                    try:
                        pr.wait(timeout=5)
                    except Exception:
                        pass
                    # completed lines still buffered in the dead pipe are
                    # DONE work — re-running them would double-yield
                    try:
                        for line in pr.stdout:
                            harvest(line, slot)
                    except (OSError, ValueError):
                        pass
                    # a death between shm create and the stdout report
                    # orphans a segment the parent never heard of; its
                    # name is deterministic (worker pid + seq) — reap it
                    # before re-dispatching so respawns can't accumulate
                    # leaked /dev/shm space
                    for seq in assigned[slot]:
                        try:
                            seg = _shm.SharedMemory(
                                name=f"mxtpu{pr.pid}x{seq}")
                            seg.close()
                            seg.unlink()   # also unregisters the attach
                        except FileNotFoundError:
                            pass
                    # only the HEAD of the queue can have killed the
                    # worker (it processes its slot strictly in order);
                    # blaming the whole queue would let a neighbor's
                    # deaths condemn a never-attempted batch as poison
                    if assigned[slot]:
                        head = assigned[slot][0]
                        retries[head] = retries.get(head, 0) + 1
                        if retries[head] > max_retries:
                            raise RuntimeError(
                                f"DataLoader batch {head} died with "
                                f"{retries[head]} workers (poison sample? "
                                f"dataset/batchify must be picklable + "
                                f"importable)")
                    respawns[slot] += 1
                    from ... import telemetry as _telemetry
                    _telemetry.counter(
                        "mxtpu_io_worker_restarts_total",
                        "Input-service worker respawns by detection "
                        "reason.").inc(1, reason="exit", pool="dataloader")
                    procs[slot] = spawn(slot)
                    try:
                        for seq in assigned[slot]:
                            send(slot, seq)
                        return
                    except (BrokenPipeError, OSError):
                        continue   # died again already; bounded above

            def dispatch():
                nonlocal next_dispatch
                while (next_dispatch < len(batches)
                       and sum(map(len, assigned)) < depth):
                    slot = next_dispatch % n
                    assigned[slot].append(next_dispatch)
                    seq = next_dispatch
                    next_dispatch += 1
                    try:
                        send(slot, seq)
                    except (BrokenPipeError, OSError):
                        revive(slot)   # re-sends assigned[slot] incl. seq

            dispatch()
            while next_yield < len(batches):
                while next_yield not in done:
                    # collect strictly round-robin from the worker slot
                    # that owns the next sequence number
                    slot = next_yield % n
                    line = procs[slot].stdout.readline()
                    if not harvest(line, slot):
                        revive(slot)   # EOF or torn line: worker died
                    dispatch()
                name, meta = done.pop(next_yield)
                if meta.get("skipped"):
                    # worker-quarantined corrupt records (backfilled in
                    # the batch): count + name them centrally
                    from ...input_service import record_skips
                    record_skips(meta["skipped"], pool="dataloader")
                yield _from_shm(name, meta)
                next_yield += 1
        finally:
            for pr in procs:
                try:
                    pr.stdin.close()
                except OSError:
                    pass
            # drain undelivered batches and unlink their shm segments —
            # abandoning iteration early must not leak /dev/shm files
            # (workers finish in-flight tasks after stdin EOF, report and
            # exit)
            for pr in procs:
                try:
                    for line in pr.stdout:
                        line = line.strip()
                        if line.startswith("#exit:"):
                            self.worker_reports.append(
                                _json.loads(line[len("#exit:"):]))
                        elif line:
                            _seq, name, meta = line.split(":", 2)
                            done[int(_seq)] = (name, _json.loads(meta))
                except (OSError, ValueError):
                    pass
            for name, _meta in done.values():
                try:
                    seg = _shm.SharedMemory(name=name)
                    seg.close()
                    seg.unlink()
                except FileNotFoundError:
                    pass
            for pr in procs:
                try:
                    pr.wait(timeout=5)
                except Exception:
                    pr.kill()
            _os.unlink(cfg_path)

    def _make_batch(self, indices):
        with cpu():
            return self._batchify_fn([self._dataset[i] for i in indices])

    def __iter__(self):
        if self._device_prefetch:
            from ...io import DevicePrefetcher
            pf = DevicePrefetcher(self._iter_host(),
                                  depth=self._device_prefetch)
            try:
                yield from pf
            finally:
                pf.close()
            return
        from ...io import _map_leaves, device_transfer
        device = current_context().torch_device
        for batch in self._iter_host():
            yield batch if device.type == "cpu" else _map_leaves(
                batch, lambda a: device_transfer(a, device))

    def _iter_host(self):
        """The batches on the host, in order."""
        if self._num_workers == 0:
            for batch_idx in self._batch_sampler:
                yield self._make_batch(batch_idx)
            return
        if not self._thread_pool:
            yield from self._iter_processes()
            return
        # threaded prefetch pipeline
        q: "queue.Queue" = queue.Queue(maxsize=max(self._prefetch, 2))
        sentinel = object()

        def producer():
            try:
                for batch_idx in self._batch_sampler:
                    q.put(("ok", self._make_batch(batch_idx)))
            except Exception as e:  # propagate worker errors to consumer
                q.put(("err", e))
            q.put(("done", sentinel))

        threads = [threading.Thread(target=producer, daemon=True)]
        for t in threads:
            t.start()
        while True:
            kind, item = q.get()
            if kind == "err":
                raise item
            if kind == "done":
                break
            yield item
        for t in threads:
            t.join()

    def __len__(self):
        return len(self._batch_sampler)
