"""Fault tolerance: periodic checkpoints with automatic resume.

Counterpart of ``incubator_mxnet_tpu/fault.py``. The reference's failure
handling is thin: ps-lite heartbeats surface dead nodes (ref:
include/mxnet/kvstore.h:353 get_num_dead_node, src/kvstore/kvstore_dist.h:121)
and restarted nodes rejoin through ``is_recovery`` (kvstore_dist.h:52),
but nothing brings training state back. This module does:

``CheckpointManager`` — atomic rolling checkpoints of (params, optimizer
state, epoch/step, RNG state) with a SHA-256 manifest and ``latest()``
discovery, so a relaunched job continues from its last step. A save whose
``writers`` include a sharded table's (``parallel.embedding.table_writer``
on a mesh) is collective: every rank of the world writes its own files into
one staged directory, and rank 0 writes the manifest and publishes after a
barrier.
``auto_resume_fit`` — a Gluon train loop with a save every N steps and a
resume on start. Its ``elastic=`` (resizing the world in a run) is
ROADMAP.md A10c and raises.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import pickle
import queue as _queue_mod
import shutil
import tempfile
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as _np

from . import chaos
from . import telemetry as _telemetry

_A10C = ("auto_resume_fit(elastic=...): resizing the world in a run is "
         "ROADMAP.md A10c (not ported)")

__all__ = ["CheckpointManager", "auto_resume_fit"]

_log = logging.getLogger(__name__)


class _AsyncCkptWriter:
    """One background writer thread per CheckpointManager: save jobs run
    strictly in submit order (a newer checkpoint can never publish before
    an older one), errors are remembered and re-raised at the next
    ``submit``/``drain`` so a failed save is never silently swallowed."""

    def __init__(self):
        self._q: "_queue_mod.Queue" = _queue_mod.Queue()
        self._cv = threading.Condition()
        self._pending = 0
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._loop, name="mxtpu-ckpt-writer", daemon=True)
        self._thread.start()

    @property
    def ident(self) -> Optional[int]:
        return self._thread.ident

    def _loop(self):
        while True:
            job = self._q.get()
            if job is None:
                return
            try:
                job()
            except BaseException as e:
                with self._cv:
                    if self._error is None:
                        self._error = e
                _log.exception("async checkpoint save failed")
            finally:
                with self._cv:
                    self._pending -= 1
                    self._cv.notify_all()

    def _raise_pending_error(self):
        with self._cv:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def submit(self, job: Callable[[], None]):
        self._raise_pending_error()
        with self._cv:
            self._pending += 1
        self._q.put(job)

    def drain(self, raise_error: bool = True):
        """Block until every submitted save finished. With ``raise_error``
        the first failure is re-raised (and consumed); without, it stays
        parked for the next ``submit``/``close`` — readers that only need
        the on-disk state settled (rollback picking the newest INTACT
        checkpoint) must not crash on a failure whose save simply never
        published."""
        with self._cv:
            while self._pending:
                self._cv.wait()
        if raise_error:
            self._raise_pending_error()

    def close(self):
        try:
            self.drain()
        finally:
            self._q.put(None)
            self._thread.join(timeout=5)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


_MODULE = ("CheckpointManager(module=...): the Module API is ROADMAP.md A11 "
           "(not ported)")


def _collective(writers) -> bool:
    """Does a writer save a table sharded over several ranks?"""
    return any(getattr(w, "collective", None) for w in (writers or ()))


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


class CheckpointManager:
    """Atomic rolling checkpoints under ``directory``.

    Layout: ``step-<N>/`` holding ``meta.json``, ``params.npz``,
    ``trainer.bin`` (optimizer states via Trainer/Module serialization) and
    ``rng.bin``. Writes go to a temp dir then ``os.replace`` — a crash
    mid-save never corrupts the latest checkpoint (the property the
    reference's plain save_checkpoint files lack,
    python/mxnet/model.py:383)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._writer: Optional[_AsyncCkptWriter] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def _write_stages(self, step: int, extra, write_params, write_states,
                      rng_blob: bytes, collective: bool = False):
        """The staged checkpoint write shared by the sync and async paths:
        state files, the per-file SHA-256 manifest written LAST inside
        meta.json (a checkpoint without a verifiable manifest is not a
        checkpoint — restore() skips it, so torn states from a kill are
        never resumed from), then the atomic publish. ``ckpt.save`` chaos
        stages 1..5 fire here; stage 0 fires in the caller before any
        snapshot is taken. The whole publish is one ``ckpt_publish``
        telemetry span (on the background writer's thread for async
        saves), so checkpoint cost is attributable in the flight dump."""
        with _telemetry.span("ckpt_publish", ckpt_step=int(step)):
            return self._write_stages_inner(step, extra, write_params,
                                            write_states, rng_blob,
                                            collective)

    def _write_stages_inner(self, step, extra, write_params, write_states,
                            rng_blob, collective=False):
        if collective:
            return self._write_collective(step, extra, write_params,
                                          write_states, rng_blob)
        tmp = tempfile.mkdtemp(dir=self.directory, prefix=".tmp-")
        try:
            meta = {"step": int(step), "extra": extra or {}}
            if write_params is not None:
                write_params(tmp)
            chaos.maybe_fail("ckpt.save")      # stage 1: params written
            if write_states is not None:
                write_states(tmp)
            chaos.maybe_fail("ckpt.save")      # stage 2: optimizer written
            with open(os.path.join(tmp, "rng.bin"), "wb") as f:
                f.write(rng_blob)
            meta["manifest"] = {
                name: _sha256(os.path.join(tmp, name))
                for name in sorted(os.listdir(tmp))}
            chaos.maybe_fail("ckpt.save")      # stage 3: before manifest
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            chaos.maybe_fail("ckpt.save")      # stage 4: before publish
            final = os.path.join(self.directory, f"step-{step}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        chaos.maybe_fail("ckpt.save")          # stage 5: before prune
        self._prune()
        return os.path.join(self.directory, f"step-{step}")

    def _write_collective(self, step, extra, write_params, write_states,
                          rng_blob):
        """The staged write of a sharded save, on every rank of the world:
        rank 0 makes the staged directory (named by the step, so every
        rank finds it), every rank writes its files, and once every rank
        has written (an all-reduce of their failures) rank 0 writes the
        params, the RNG state and the manifest over every rank's files,
        publishes and prunes. A last all-reduce tells every rank whether
        rank 0 got through: a failure anywhere raises on every rank, and
        nothing torn is published. The chaos stages fire on rank 0."""
        import torch
        import torch.distributed as dist
        rank = dist.get_rank()
        tmp = os.path.join(self.directory, f".tmp-step-{step}")
        final = os.path.join(self.directory, f"step-{step}")

        def any_rank(err) -> bool:
            flag = torch.tensor([int(err is not None)])
            dist.all_reduce(flag)
            return bool(flag[0])
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        dist.barrier()
        err = None
        try:
            if rank == 0:
                chaos.maybe_fail("ckpt.save")   # stage 0: before any write
            if write_states is not None:
                write_states(tmp)
        except Exception as e:          # every rank must reach the reduce
            err = e
        if any_rank(err):
            if rank == 0:
                shutil.rmtree(tmp, ignore_errors=True)
            raise err or IOError(f"checkpoint step-{step}: another rank "
                                 "failed to write its files")
        if rank == 0:
            try:
                meta = {"step": int(step), "extra": extra or {}}
                if write_params is not None:
                    write_params(tmp)
                chaos.maybe_fail("ckpt.save")   # stage 1: params written
                chaos.maybe_fail("ckpt.save")   # stage 2: states written
                with open(os.path.join(tmp, "rng.bin"), "wb") as f:
                    f.write(rng_blob)
                meta["manifest"] = {
                    name: _sha256(os.path.join(tmp, name))
                    for name in sorted(os.listdir(tmp))}
                chaos.maybe_fail("ckpt.save")   # stage 3: before manifest
                with open(os.path.join(tmp, "meta.json"), "w") as f:
                    json.dump(meta, f)
                chaos.maybe_fail("ckpt.save")   # stage 4: before publish
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)
                chaos.maybe_fail("ckpt.save")   # stage 5: before prune
                self._prune()
            except Exception as e:
                shutil.rmtree(tmp, ignore_errors=True)
                err = e
        if any_rank(err):
            raise err or IOError(f"checkpoint step-{step}: rank 0 failed "
                                 "to publish it")
        return final

    @staticmethod
    def _rng_blob() -> bytes:
        from . import random as _random
        return pickle.dumps(_random.get_state())

    def save(self, step: int, net=None, trainer=None, module=None,
             extra: Optional[Dict[str, Any]] = None, writers=None,
             param_filter=None):
        """Snapshot training state at ``step``, synchronously.

        The ``ckpt.save`` chaos point is evaluated at every stage of the
        save sequence (after each state file, before the manifest, before
        and after the atomic rename) — a kill at any of them must leave
        ``latest()`` pointing at an intact, checksum-valid checkpoint.

        ``writers``: extra ``fn(tmp_dir)`` callbacks that drop files into
        the staged directory — they ride the SHA-256 manifest and atomic
        publish like the built-in files (the sharded-embedding table
        writer ``parallel.embedding.table_writer`` plugs in here).

        ``param_filter``: ``fn(name, param) -> bool`` selecting which of
        the net's parameters land in ``params.npz`` (a sharded table's
        padded shape depends on the number of ranks: it round-trips
        through ``table_writer`` / ``load_table``).

        A save with a sharded table's writer is collective: every rank of
        the world calls it (``_write_collective``).
        """
        if module is not None:
            raise NotImplementedError(_MODULE)
        collective = _collective(writers)
        if not collective:
            chaos.maybe_fail("ckpt.save")      # stage 0: before any write

        def write_params(tmp):
            if net is not None:
                net.save_parameters(os.path.join(tmp, "params.npz"),
                                    param_filter=param_filter)

        def write_states(tmp):
            if trainer is not None and (not collective or _rank() == 0):
                trainer.save_states(os.path.join(tmp, "trainer.bin"))
            for wfn in (writers or ()):
                wfn(tmp)
        return self._write_stages(step, extra, write_params, write_states,
                                  self._rng_blob(), collective)

    def save_async(self, step: int, net=None, trainer=None,
                   extra: Optional[Dict[str, Any]] = None, writers=None,
                   param_filter=None):
        """Snapshot training state at ``step`` without blocking the step
        loop on a device-to-host copy or file I/O. On the calling thread
        only device copies are made (params by ``NDArray.copy``, optimizer
        state by ``Trainer.snapshot_states``: the fused step updates the
        live tensors in place afterwards) and the RNG and hyperparameters
        pickled; the host copies, the SHA-256 manifest and the atomic
        publish run on the background writer (an unfinished save is an
        unpublished temporary directory). Failures surface at the next
        save or ``wait()``. A save with a sharded table's writer runs
        synchronously (its barriers belong on the callers' threads).

        ``writers``: extra staged-directory callbacks, run on the writer
        thread; they copy their device state when made
        (``parallel.embedding.table_writer`` does)."""
        if _collective(writers):
            # a sharded save runs barriers across the ranks: synchronously,
            # on the callers' threads
            return self.save(step, net=net, trainer=trainer, extra=extra,
                             writers=writers, param_filter=param_filter)
        states_fn = trainer.snapshot_states() if trainer is not None else None
        if trainer is not None and states_fn is None:
            # kvstore-held optimizer state cannot be snapshotted: sync save
            # (decided BEFORE the param snapshot and before chaos stage 0 —
            # save() fires its own, keeping exactly one stage 0 per save)
            return self.save(step, net=net, trainer=trainer, extra=extra,
                             writers=writers, param_filter=param_filter)
        chaos.maybe_fail("ckpt.save")          # stage 0: before any write
        params_snap = None
        if net is not None:
            params_snap = {k: v.data().copy() for k, v in
                           net._collect_params_with_prefix().items()
                           if param_filter is None or param_filter(k, v)}
        rng_blob = self._rng_blob()
        if self._writer is None:
            self._writer = _AsyncCkptWriter()

        def write_params(tmp):
            if params_snap is not None:
                from .ndarray.ndarray import save as nd_save
                nd_save(os.path.join(tmp, "params.npz"), params_snap)

        def write_states(tmp):
            if states_fn is not None:
                with open(os.path.join(tmp, "trainer.bin"), "wb") as f:
                    f.write(states_fn())
            for wfn in (writers or ()):
                wfn(tmp)

        def job():
            self._write_stages(step, extra, write_params, write_states,
                               rng_blob)
        self._writer.submit(job)
        _telemetry.gauge("pipeline_async_saves").inc()
        return os.path.join(self.directory, f"step-{step}")

    # -------------------------------------------------- async-writer sync
    def _drain_async(self):
        # settle the on-disk state without consuming a parked save error:
        # latest()/restore() must degrade to the newest intact checkpoint
        # (the failed save never published); the error still surfaces at
        # the next save_async submit or wait()/close()
        w = self._writer
        if w is not None and threading.get_ident() != w.ident:
            w.drain(raise_error=False)

    def wait(self):
        """Block until every in-flight async save has published; re-raise
        the first background failure."""
        w = self._writer
        if w is not None and threading.get_ident() != w.ident:
            w.drain(raise_error=True)

    def close(self):
        """Drain and stop the background writer (restarted lazily by the
        next ``save_async``). Re-raises the first background failure."""
        w, self._writer = self._writer, None
        if w is not None:
            w.close()

    # ----------------------------------------------------------- integrity
    def verify(self, step: int) -> bool:
        """True iff checkpoint ``step`` exists and every manifest entry
        hashes clean. Pre-manifest checkpoints (no ``manifest`` key) are
        accepted when their files are present — they predate the
        integrity contract."""
        d = os.path.join(self.directory, f"step-{step}")
        try:
            with open(os.path.join(d, "meta.json")) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            return False
        manifest = meta.get("manifest")
        if manifest is None:
            return os.path.isdir(d)
        try:
            return all(_sha256(os.path.join(d, name)) == digest
                       for name, digest in manifest.items())
        except OSError:
            return False

    def _prune(self):
        steps = self.list_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step-{s}"),
                          ignore_errors=True)

    # ------------------------------------------------------------- load
    def list_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step-"):
                try:
                    steps.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(steps)

    def _newest_intact(self) -> Tuple[Optional[int], List[int]]:
        """(newest step passing verify() or None, newer steps skipped as
        corrupt) — the one intact-selection policy behind both
        ``latest()`` and ``restore()``."""
        skipped: List[int] = []
        for s in reversed(self.list_steps()):
            if self.verify(s):
                if skipped:
                    _log.warning(
                        "checkpoint(s) %s failed integrity check; falling "
                        "back to step %d", skipped, s)
                return s, skipped
            skipped.append(s)
        if skipped:
            _log.warning("no intact checkpoint under %s (corrupt: %s)",
                         self.directory, skipped)
        return None, skipped

    def latest(self, intact_only: bool = True) -> Optional[int]:
        """Newest checkpoint step; with ``intact_only`` (default) the
        newest that passes ``verify`` — corrupt/torn directories are
        skipped, not returned."""
        self._drain_async()   # an in-flight async save is not yet a ckpt
        if not intact_only:
            steps = self.list_steps()
            return steps[-1] if steps else None
        return self._newest_intact()[0]

    def restore(self, net=None, trainer=None, module=None,
                step: Optional[int] = None,
                allow_missing: bool = False,
                param_filter=None) -> Optional[Dict[str, Any]]:
        """Load the newest *intact* (or given) checkpoint into
        net/trainer/module. A corrupt newest checkpoint is skipped with a
        warning and the next intact one is loaded (``meta["fallback_from"]``
        records the steps skipped). Returns the meta dict, or None if no
        intact checkpoint exists. An explicitly requested ``step`` that
        fails verification raises instead of silently degrading.

        ``allow_missing``: tolerate net parameters absent from
        ``params.npz`` — the elastic path saves sharded tables through
        ``table_writer`` (not the parameter file) and re-installs them
        itself after this returns.

        ``param_filter``: load only the parameters the predicate keeps
        (mirror of ``save(param_filter=)``). The elastic path uses it to
        skip sharded tables even when a PRE-elastic checkpoint kept them
        inside ``params.npz`` — their saved padding is the writer
        mesh's, so a dense load at a different device count would fail
        on shape; the controller re-pads and re-installs them itself."""
        self._drain_async()   # rollback/resume must see published saves
        skipped: List[int] = []
        if step is not None:
            if not self.verify(step):
                raise IOError(
                    f"checkpoint step-{step} under {self.directory} is "
                    f"missing or fails its integrity manifest")
        else:
            step, skipped = self._newest_intact()
        if step is None:
            return None
        d = os.path.join(self.directory, f"step-{step}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        if skipped:
            meta["fallback_from"] = skipped
        if module is not None:
            raise NotImplementedError(_MODULE)
        if net is not None:
            # ignore_extra only under a filter: the file may hold
            # filtered-out entries (a pre-elastic checkpoint's table)
            net.load_parameters(os.path.join(d, "params.npz"),
                                allow_missing=allow_missing,
                                ignore_extra=param_filter is not None,
                                param_filter=param_filter)
        if trainer is not None and os.path.exists(
                os.path.join(d, "trainer.bin")):
            trainer.load_states(os.path.join(d, "trainer.bin"))
        rng_path = os.path.join(d, "rng.bin")
        if os.path.exists(rng_path):
            from . import random as _random
            with open(rng_path, "rb") as f:
                _random.set_state(pickle.load(f))
        return meta


def auto_resume_fit(net, trainer, loss_fn, data_iter, *, ckpt_dir: str,
                    num_epochs: int, save_every: int = 100, keep: int = 3,
                    batch_fn: Optional[Callable] = None,
                    on_step: Optional[Callable] = None,
                    guard=None, sync_every: Optional[int] = None,
                    async_save: Optional[bool] = None,
                    prefetch: Optional[int] = None,
                    elastic=None) -> Dict[str, Any]:
    """Gluon train loop with periodic checkpoints and a resume on start.

    Returns {"resumed_from": step or None, "final_step": N, "guard": stats
    or None}. Kill the process at any point and rerun the same call: the
    run goes on from the last saved step. Checkpoints record the batch
    index inside the epoch and a resume skips the epoch's processed prefix,
    so a kill mid-epoch neither replays nor skips batches. A resume that
    fell back past a corrupt newest checkpoint is logged as degraded.

    ``guard`` (a ``guard.GuardPolicy`` or a ``guard.TrainingGuard``): the
    step's loss feeds the NaN and spike sentinels, every ``check_every``
    steps the gradients too, each phase (data, forward, step, ckpt) runs
    under the hung-step watchdog, and a tripped ladder skips, rescales or
    rolls back to the newest intact checkpoint (with the learning rate
    backed off). A rollback rewinds the model, optimizer and step but keeps
    the data iterator's position.

    ``sync_every`` (``MXTPU_SYNC_EVERY``, default 1): 1 reads the guarded
    loss on the host every step; N > 1 queues it on the device
    (``guard.note_loss``), reads N at once, and wires the guard into
    ``trainer.step`` so the fused step's device census skips NaN updates
    on the device.

    ``async_save`` (``MXTPU_ASYNC_CKPT``, default on): a checkpoint copies
    its tensors on the device and publishes (manifest, atomic rename) on a
    background writer; ``restore``/``latest`` and rollbacks wait for it,
    and so does the run's end.

    ``prefetch`` (``MXTPU_PREFETCH_DEPTH``; only when set): wraps
    ``data_iter`` in an ``io.DevicePrefetcher`` of that depth.

    ``elastic`` (a controller resizing the world in the run) is
    ROADMAP.md A10c and raises.
    """
    import contextlib
    import sys as _sys

    from . import autograd
    from .guard import OK as _OK, ROLLBACK as _ROLLBACK, TrainingGuard

    if elastic is not None:
        raise NotImplementedError(_A10C)
    if sync_every is None:
        sync_every = int(os.environ.get("MXTPU_SYNC_EVERY", "1"))
    sync_every = max(1, int(sync_every))
    if async_save is None:
        async_save = os.environ.get("MXTPU_ASYNC_CKPT", "1").lower() \
            not in ("0", "false")
    own_prefetch = False
    if prefetch is None and os.environ.get("MXTPU_PREFETCH_DEPTH"):
        prefetch = int(os.environ["MXTPU_PREFETCH_DEPTH"])
    if prefetch:
        from .io import DevicePrefetcher
        # a DataLoader that prefetches to the device already must not be
        # wrapped twice
        if not (isinstance(data_iter, DevicePrefetcher)
                or getattr(data_iter, "_device_prefetch", 0)):
            data_iter = DevicePrefetcher(data_iter, depth=prefetch)
            own_prefetch = True

    mgr = CheckpointManager(ckpt_dir, keep=keep)
    save_fn = mgr.save_async if async_save else mgr.save
    g: Optional[TrainingGuard] = None
    close_guard = False
    unbind_trainer_guard = False
    if guard is not None:
        if isinstance(guard, TrainingGuard):
            g = guard
        else:
            g = TrainingGuard(guard)
            close_guard = True      # ours: stop its watchdog at the end
        g.bind(manager=mgr, net=net, trainer=trainer)
        g.ensure_logger(_log)
        if sync_every > 1 and getattr(trainer, "_guard", None) is None:
            # deferred losses cannot drop an applied update after the fact:
            # the fused step's device census skips NaN updates instead
            trainer._guard = g
            unbind_trainer_guard = True

    @contextlib.contextmanager
    def _watch(phase):
        # the watchdog's deadline and a telemetry span a phase
        with (g.watch(phase, step=step) if g is not None
              else contextlib.nullcontext()):
            with _telemetry.span(phase):
                yield

    meta = mgr.restore(net=net, trainer=trainer)
    step = meta["step"] if meta else 0
    start_epoch = meta["extra"].get("epoch", 0) if meta else 0
    start_batch = meta["extra"].get("batch", 0) if meta else 0
    resumed_from = step if meta else None
    if meta and g is not None:
        g.note_checkpoint(step)
    if meta and meta.get("fallback_from"):
        _log.warning(
            "degraded resume: checkpoint(s) %s corrupt, resumed from "
            "step %d (epoch %d, batch %d)", meta["fallback_from"], step,
            start_epoch, start_batch)

    try:
        for epoch in range(start_epoch, num_epochs):
            skip_batches = start_batch if epoch == start_epoch else 0
            se = getattr(data_iter, "set_epoch", None)
            if se is not None:
                # epoch-keyed order (InputService): a resume replays this
                # epoch's permutation bit for bit
                se(epoch)
            data_iter.reset()
            batches = enumerate(data_iter)
            while True:
                _telemetry.set_step(step + 1)
                with _watch("data"):
                    try:
                        batch_idx, batch = next(batches)
                    except StopIteration:
                        break
                    except Exception as e:
                        from .input_service import InputCorruptionError
                        if isinstance(e, InputCorruptionError):
                            # the skip budget is spent: a typed stop with
                            # the flight recorder dumped, never a wedge
                            _telemetry.guard_event(
                                step + 1, "input_corruption", "abort",
                                float(getattr(e, "skipped", 0) or 0),
                                detail=str(e))
                            _telemetry.dump(reason="input_corruption")
                        raise
                if batch_idx < skip_batches:
                    continue
                if batch_fn is not None:
                    x, y = batch_fn(batch)
                else:
                    x, y = batch.data[0], batch.label[0]
                with _watch("forward"):
                    with autograd.record():
                        out = net(x)
                        loss = loss_fn(out, y).mean()
                    loss.backward()
                if g is not None and sync_every == 1:
                    g.host_syncs += 1
                    action = g.check_loss(step + 1, float(loss.asnumpy()))
                    if action == _OK and g.policy.check_every \
                            and (step + 1) % g.policy.check_every == 0:
                        pairs = [(f"grad:{p.name}", gr)
                                 for p in trainer._params
                                 if p.grad_req != "null"
                                 for gr in p.list_grad()]
                        action = g.check_tensors(step + 1, pairs)
                    if action == _ROLLBACK:
                        # model, optimizer and RNG rewound by the guard;
                        # the step counter follows, fresh data goes on
                        step = g.restored_meta["step"]
                        continue
                    if action != _OK:
                        continue        # skip / rescale: drop this update
                elif g is not None:
                    # deferred: queue the device scalar, one host read
                    # every sync_every steps
                    g.note_loss(step + 1, loss)
                    if (step + 1) % sync_every == 0:
                        if g.flush_losses() == _ROLLBACK:
                            step = g.restored_meta["step"]
                            continue    # the gradients predate the restore
                        if g.last_flush[0] == step + 1 \
                                and g.last_flush[1] != _OK:
                            # this step's own loss tripped before its
                            # update: drop it, as sync_every=1 would
                            continue
                rollbacks_before = g.rollbacks if g is not None else 0
                with _watch("step"):
                    trainer.step(x.shape[0])
                if g is not None and g.rollbacks > rollbacks_before:
                    # the trainer's census tripped to a rollback inside
                    # step(): state restored, the update dropped
                    step = g.restored_meta["step"]
                    continue
                step += 1
                if on_step is not None:
                    on_step(step, loss)
                if step % save_every == 0:
                    if g is not None and sync_every > 1 \
                            and g.flush_losses() == _ROLLBACK:
                        step = g.restored_meta["step"]
                        continue
                    with _watch("ckpt"):
                        save_fn(step, net=net, trainer=trainer,
                                extra={"epoch": epoch,
                                       "batch": batch_idx + 1})
                    if g is not None:
                        g.note_checkpoint(step)
            if g is not None and sync_every > 1 \
                    and g.flush_losses() == _ROLLBACK:
                step = g.restored_meta["step"]
        with _watch("ckpt"):
            save_fn(step, net=net, trainer=trainer,
                    extra={"epoch": num_epochs, "batch": 0})
    finally:
        # taken before any nested handler runs: inside an except block
        # exc_info() names the exception caught there
        propagating = _sys.exc_info()[0] is not None
        if close_guard:
            g.close()       # stop the watchdog thread we started
        if unbind_trainer_guard:
            trainer._guard = None
        if own_prefetch:
            data_iter.close()   # before mgr.close: its raise must not leak
        try:
            mgr.close()     # publish every async save, stop the writer
        except Exception:
            if not propagating:
                raise
            _log.exception("async checkpoint save failed during teardown")
    return {"resumed_from": resumed_from, "final_step": step,
            "guard": g.summary() if g is not None else None}
