"""Standalone DataLoader worker (subprocess transport, shared-memory
batches): the role of the reference's multiprocessing worker_loop (ref:
python/mxnet/gluon/data/dataloader.py:26-104).

Counterpart of ``incubator_mxnet_tpu/_dataloader_worker.py``. Protocol:
argv[1] is the path of a pickle of (dataset, batchify_fn); stdin lines
``seq:idx,idx,...``; stdout lines ``seq:shm_name:json_meta``, where the
meta describes the (nested) array structure; at stdin's end one line
``#exit:{"pid", "cuda_initialized", "cuda_visible_devices"}``, then the
worker exits; with ``MXTPU_IO_ANNOUNCE=1`` (the input service's workers)
it first writes ``#ready`` once it has loaded the pickle. The parent runs
it with ``CUDA_VISIBLE_DEVICES=""``, and it builds every batch under
``cpu()``, so it never touches the card; its torch ops run on one
thread, since its siblings share the cores.
Subprocesses rather than ``multiprocessing``: fork would copy the
parent's CUDA context, and spawn re-imports the parent's ``__main__``.

Like any process-based loader, it needs a dataset and batchify function
picklable from importable modules.
"""
from __future__ import annotations

# FIRST, before any stdlib import that is not interpreter-preloaded:
# running as a script puts THIS package directory at sys.path[0], where
# operator.py / random.py / io.py shadow the stdlib modules of the same
# name. Only sys/os are safe to import here (preloaded at startup).
# Skipped when imported as a package module: then sys.path was never
# polluted.
import os as _os
import sys as _sys
if not __package__:
    _pkg_dir = _os.path.dirname(_os.path.abspath(__file__))
    _sys.path[:] = [p for p in _sys.path
                    if _os.path.abspath(p or _os.getcwd()) != _pkg_dir]

import json
import pickle
import sys

import numpy as np


def _np_tree(batch):
    from incubator_mxnet_tpu_torch.ndarray.ndarray import NDArray
    if isinstance(batch, NDArray):
        return "leaf", [batch.asnumpy()]
    if isinstance(batch, np.ndarray):
        return "leaf", [batch]
    if isinstance(batch, (list, tuple)):
        structs, arrays = [], []
        for item in batch:
            st, ar = _np_tree(item)
            structs.append(st)
            arrays.extend(ar)
        return structs, arrays
    return "leaf", [np.asarray(batch)]


def _chaos_check():
    """Injected worker death (points ``loader.worker`` and
    ``io.worker_kill``, armed via the inherited MXTPU_CHAOS env;
    MXTPU_CHAOS_SALT — set per incarnation by the parent — keeps the
    draw deterministic without every respawn replaying its
    predecessor's death). Fired BEFORE the batch is built so no
    shared-memory segment is orphaned: the parent detects EOF,
    respawns, and re-dispatches this batch."""
    try:
        from incubator_mxnet_tpu_torch import chaos as _chaos
        fail = (_chaos.should_fail("loader.worker")
                or _chaos.should_fail("io.worker_kill"))
    except Exception:
        return
    if fail:
        _os._exit(17)


def _describe(dataset, i):
    """(uri, offset) attribution for the quarantine file: datasets that
    know their storage (RecordFileDataset) expose ``describe(i)``;
    anything else is named by type + index."""
    try:
        d = dataset.describe(int(i))
        return str(d[0]), int(d[1])
    except Exception:
        return f"dataset:{type(dataset).__name__}", int(i)


def _gather(dataset, indices, chaos=None):
    """Fetch ``dataset[i]`` for each index with corrupt-record
    quarantine: a sample that raises (or draws the ``io.record_corrupt``
    chaos point) is skipped and back-filled with the first intact sample
    of the batch so downstream shapes stay fixed. Returns
    ``(samples, skipped)`` where skipped is ``[[uri, offset, why], ...]``.
    Raises the last error only if EVERY sample in the batch is corrupt —
    then there is nothing to back-fill with and the step cannot proceed.

    ``io.decode_stall`` (evaluated once per batch) sleeps
    ``MXTPU_IO_STALL_S`` seconds to simulate a slow disk/decoder for
    heartbeat and starvation tests."""
    import time as _t
    if chaos is None:
        try:
            from incubator_mxnet_tpu_torch import chaos
        except Exception:
            chaos = None
    if chaos is not None and chaos.should_fail("io.decode_stall"):
        _t.sleep(float(_os.environ.get("MXTPU_IO_STALL_S", "0.05")))
    samples, skipped, bad_slots, last_err = [], [], [], None
    for slot, i in enumerate(indices):
        why = None
        try:
            if chaos is not None and chaos.should_fail("io.record_corrupt"):
                raise IOError("chaos: injected record corruption "
                              "(io.record_corrupt)")
            samples.append(dataset[i])
            continue
        except Exception as e:
            why, last_err = str(e) or type(e).__name__, e
        uri, offset = _describe(dataset, i)
        skipped.append([uri, offset, why])
        bad_slots.append(slot)
        samples.append(None)
    intact = next((s for s in samples if s is not None), None)
    if intact is None and indices:
        raise IOError(
            f"all {len(indices)} records in batch corrupt; last error: "
            f"{last_err}") from last_err
    for slot in bad_slots:
        samples[slot] = intact
    return samples, skipped


def _exit_report() -> str:
    """The line a worker writes at its exit: whether CUDA was initialised
    in this process."""
    torch = sys.modules.get("torch")
    return "#exit:" + json.dumps({
        "pid": _os.getpid(),
        "cuda_initialized": bool(torch is not None
                                 and torch.cuda.is_initialized()),
        "cuda_visible_devices": _os.environ.get("CUDA_VISIBLE_DEVICES")})


def main():
    import torch
    from incubator_mxnet_tpu_torch.context import cpu
    torch.set_num_threads(1)    # one core a worker: the workers share them
    with cpu():
        _serve()


def _serve():
    from multiprocessing import shared_memory
    with open(sys.argv[1], "rb") as f:
        dataset, batchify_fn = pickle.load(f)
    out = sys.stdout
    if _os.environ.get("MXTPU_IO_ANNOUNCE") == "1":
        # the input service's heartbeat arms only after this line, so the
        # cold start (importing torch and the package) is never taken for
        # a decode hang
        out.write("#ready\n")
        out.flush()
    try:
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            seq_s, idx_s = line.split(":", 1)
            indices = [int(x) for x in idx_s.split(",")]
            _chaos_check()
            samples, skipped = _gather(dataset, indices)
            batch = batchify_fn(samples)
            struct, arrays = _np_tree(batch)
            total = max(1, sum(a.nbytes for a in arrays))
            # deterministic name (pid + seq): if this worker dies between
            # creating the segment and reporting it, the parent's
            # supervision can reconstruct the name and reap the orphan —
            # an anonymous segment would leak /dev/shm on every death
            name_hint = f"mxtpu{_os.getpid()}x{seq_s}"
            try:
                shm = shared_memory.SharedMemory(create=True, size=total,
                                                 name=name_hint)
            except FileExistsError:
                # stale garbage under our (reused) pid: reclaim the name
                try:
                    stale = shared_memory.SharedMemory(name=name_hint)
                    stale.close()
                    stale.unlink()
                except OSError:
                    pass
                shm = shared_memory.SharedMemory(create=True, size=total,
                                                 name=name_hint)
            metas, off = [], 0
            for a in arrays:
                view = np.ndarray(a.shape, a.dtype, buffer=shm.buf,
                                  offset=off)
                view[...] = a
                metas.append([list(a.shape), str(a.dtype), off])
                off += a.nbytes
            name = shm.name
            # parent owns the segment: detach from this worker's tracker
            try:
                from multiprocessing import resource_tracker
                resource_tracker.unregister(shm._name, "shared_memory")
            except Exception:
                pass
            shm.close()
            md = {"struct": struct, "metas": metas}
            if skipped:
                md["skipped"] = skipped
            meta = json.dumps(md)
            out.write(f"{seq_s}:{name}:{meta}\n")
            out.flush()
        out.write(_exit_report() + "\n")
        out.flush()
    except (BrokenPipeError, KeyboardInterrupt):
        pass


if __name__ == "__main__":
    main()
