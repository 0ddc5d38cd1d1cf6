"""Training guardrails: NaN sentinel, loss-spike detector, rollback ladder,
and a hung-step watchdog.

Counterpart of ``incubator_mxnet_tpu/guard.py``: the same policy, ladder,
events, chaos points (``guard.nan``, ``guard.spike``, ``guard.hang``) and
``MXTPU_GUARD_*`` / ``MXTPU_STEP_TIMEOUT`` variables.

``TrainingGuard`` wraps any train step and enforces a **degradation ladder**
instead of crashing or corrupting:

  trip 1..skip_limit                 -> SKIP     drop the poisoned update
  ..+rescale_limit                   -> RESCALE  halve loss scale, tighten
                                                 optimizer grad clipping
  beyond                             -> ROLLBACK restore the newest intact
                                                 checkpoint and back off the
                                                 learning rate
  rollback budget spent/unavailable  -> raise GuardTripError

Trips come from three sentinels:

* **NaN/Inf sentinel** — ``check_loss`` on the per-step loss scalar, and
  (every ``check_every`` steps) ``check_tensors`` over gradients/params.
* **Loss-spike detector** — rolling median + MAD over the last
  ``spike_window`` accepted losses; a loss above
  ``median + spike_mad * 1.4826 * MAD`` trips the same ladder.
* **Hung-step watchdog** — ``watch(phase)`` arms a monitor thread with a
  per-phase deadline (``MXTPU_STEP_TIMEOUT``); on expiry it dumps every
  Python thread's stack to the log and raises ``StepHungError`` naming the
  phase in the armed thread. The serving engine's hung-request watchdog
  (``serving.InferenceEngine(timeout_ms=)``) is this one.

Every trip emits a structured ``GuardEvent`` through registered listeners
(``callback.GuardEventLogger``) and into the telemetry flight recorder.

Differences from the reference:

* the rollback rung restores through any manager with ``latest()`` and
  ``restore(net=, trainer=, module=, step=)`` (``fault.CheckpointManager``),
  or through ``restore_fn``;
* the fused trainer step's census is a one-byte flag that
  ``multi_tensor_all_finite`` leaves on the card (``optimizer/fused.py``);
  ``flush_census`` reads it with one ``.cpu()`` a queued step;
* ``flush_losses`` reads the queued losses with one ``.cpu()`` where the
  reference calls ``jax.device_get``, and bumps ``host_syncs`` only (the
  reference's ``profiler`` counter: ``profiler.py`` is ROADMAP.md A11).

A guarded loss check costs one scalar device->host sync per step; the
unguarded path is untouched.
"""
from __future__ import annotations

import contextlib
import ctypes
import logging
import math
import os
import sys
import threading
import time
import traceback
from collections import deque, namedtuple
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as _np
import torch

from . import chaos
from . import telemetry as _telemetry

__all__ = ["GuardPolicy", "TrainingGuard", "GuardEvent", "GuardTripError",
           "GuardRollbackError", "StepHungError", "OK", "SKIP", "RESCALE",
           "ROLLBACK"]

_log = logging.getLogger(__name__)

# ladder actions returned by check_loss/check_tensors
OK, SKIP, RESCALE, ROLLBACK = "ok", "skip", "rescale", "rollback"

GuardEvent = namedtuple("GuardEvent",
                        ["step", "kind", "action", "value", "detail"])
GuardEvent.__doc__ = """One structured guard record.

kind: 'nan' | 'spike' | 'hang'; action: 'skip' | 'rescale' | 'rollback' |
'raise'; value: the offending loss/timeout; detail: free-form context
(tensor name, restored step, phase)."""


class GuardTripError(RuntimeError):
    """Degradation ladder exhausted: rollback budget spent, or rollback
    demanded with no CheckpointManager bound."""


class GuardRollbackError(GuardTripError):
    """Rollback demanded but no acceptable checkpoint exists (all pruned by
    ``keep`` or corrupt) — raised instead of silently restoring a
    checkpoint that predates guarded training."""


class StepHungError(RuntimeError):
    """A guarded phase overran its ``MXTPU_STEP_TIMEOUT`` deadline. Thread
    stacks were dumped to the log by the watchdog before this was raised."""


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name, "")
    try:
        return float(v) if v else default
    except ValueError:
        raise ValueError(f"{name} must be a number, got {v!r}")


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name, "")
    try:
        return int(v) if v else default
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {v!r}")


def _tensor(t):
    """The torch tensor under an NDArray, else ``t``."""
    data = getattr(t, "_data", None)
    return data if torch.is_tensor(data) else t


def _all_finite(t) -> bool:
    """Every entry finite (one device->host read of a flag for a tensor
    on the card)."""
    t = _tensor(t)
    if torch.is_tensor(t):
        return bool(torch.isfinite(t.detach()).all())
    a = _np.asarray(t)
    return not _np.issubdtype(a.dtype, _np.inexact) or \
        bool(_np.isfinite(a).all())


def _fetch_scalars(values) -> List[float]:
    """The first entry of each value as a float: the values on one card
    come back in one copy."""
    out: List[Optional[float]] = [None] * len(values)
    on_dev = [(i, _tensor(v)) for i, v in enumerate(values)
              if torch.is_tensor(_tensor(v))]
    if on_dev:
        host = torch.stack([t.detach().reshape(-1)[0].float()
                            for _, t in on_dev]).cpu().tolist()
        for (i, _), v in zip(on_dev, host):
            out[i] = v
    for i, v in enumerate(values):
        if out[i] is None:
            out[i] = float(_np.asarray(v).ravel()[0])
    return out


class GuardPolicy:
    """Guard thresholds. Every argument left ``None`` resolves from its
    ``MXTPU_GUARD_*`` env var (read at construction, so spawned workers
    inherit one plan), then from the built-in default:

    =================  ==============================  =======
    argument           env var                         default
    =================  ==============================  =======
    spike_window       MXTPU_GUARD_SPIKE_WINDOW        32
    spike_mad          MXTPU_GUARD_SPIKE_MAD           8.0
    spike_min_history  MXTPU_GUARD_SPIKE_MIN_HISTORY   8
    skip_limit         MXTPU_GUARD_SKIPS               2
    rescale_limit      MXTPU_GUARD_RESCALES            2
    lr_backoff         MXTPU_GUARD_LR_BACKOFF          0.5
    max_rollbacks      MXTPU_GUARD_MAX_ROLLBACKS       3
    check_every        MXTPU_GUARD_CHECK_EVERY         0 (off)
    recovery_steps     MXTPU_GUARD_RECOVERY            16
    rescale_clip       MXTPU_GUARD_CLIP                1.0
    step_timeout       MXTPU_STEP_TIMEOUT              0 (off)
    =================  ==============================  =======
    """

    def __init__(self, spike_window: Optional[int] = None,
                 spike_mad: Optional[float] = None,
                 spike_min_history: Optional[int] = None,
                 skip_limit: Optional[int] = None,
                 rescale_limit: Optional[int] = None,
                 lr_backoff: Optional[float] = None,
                 max_rollbacks: Optional[int] = None,
                 check_every: Optional[int] = None,
                 recovery_steps: Optional[int] = None,
                 rescale_clip: Optional[float] = None,
                 step_timeout: Optional[float] = None):
        def pick(val, env, default, conv):
            return conv(env, default) if val is None else val
        self.spike_window = int(pick(
            spike_window, "MXTPU_GUARD_SPIKE_WINDOW", 32, _env_int))
        self.spike_mad = float(pick(
            spike_mad, "MXTPU_GUARD_SPIKE_MAD", 8.0, _env_float))
        self.spike_min_history = int(pick(
            spike_min_history, "MXTPU_GUARD_SPIKE_MIN_HISTORY", 8, _env_int))
        self.skip_limit = int(pick(
            skip_limit, "MXTPU_GUARD_SKIPS", 2, _env_int))
        self.rescale_limit = int(pick(
            rescale_limit, "MXTPU_GUARD_RESCALES", 2, _env_int))
        self.lr_backoff = float(pick(
            lr_backoff, "MXTPU_GUARD_LR_BACKOFF", 0.5, _env_float))
        self.max_rollbacks = int(pick(
            max_rollbacks, "MXTPU_GUARD_MAX_ROLLBACKS", 3, _env_int))
        self.check_every = int(pick(
            check_every, "MXTPU_GUARD_CHECK_EVERY", 0, _env_int))
        self.recovery_steps = int(pick(
            recovery_steps, "MXTPU_GUARD_RECOVERY", 16, _env_int))
        self.rescale_clip = float(pick(
            rescale_clip, "MXTPU_GUARD_CLIP", 1.0, _env_float))
        self.step_timeout = float(pick(
            step_timeout, "MXTPU_STEP_TIMEOUT", 0.0, _env_float))
        if self.spike_window < 2:
            raise ValueError("spike_window must be >= 2")
        if not (0.0 < self.lr_backoff <= 1.0):
            raise ValueError("lr_backoff must be in (0, 1]")


# --------------------------------------------------------------- watchdog
_set_async_exc = ctypes.pythonapi.PyThreadState_SetAsyncExc


class _Watchdog:
    """One daemon monitor thread per guard, armed per phase with a deadline.

    On expiry it dumps every Python thread's stack to the log, emits a
    structured 'hang' event, and raises ``StepHungError`` in the armed
    thread via ``PyThreadState_SetAsyncExc``. Async delivery lands at the
    next bytecode boundary — a Python-level hang (and the ``guard.hang``
    chaos loop) is interrupted promptly; a hang stuck inside a C call still
    gets its stack dump within the deadline even if the raise must wait for
    the call to return.
    """

    def __init__(self, guard: "TrainingGuard"):
        self._guard = guard
        self._cond = threading.Condition()
        # armed slot: (phase, tid, deadline_monotonic, timeout, step, token)
        self._armed: Optional[Tuple] = None
        self._token = 0
        self._fired: Dict[int, int] = {}   # token -> tid, pending async exc
        self._stop = False
        self._thread: Optional[threading.Thread] = None

    def arm(self, phase: str, tid: int, timeout: float,
            step: Optional[int]) -> int:
        with self._cond:
            if self._thread is None or not self._thread.is_alive():
                # first arm, or re-arm after close(): revive the monitor
                self._stop = False
                self._thread = threading.Thread(
                    target=self._loop, name="mxtpu-guard-watchdog",
                    daemon=True)
                self._thread.start()
            self._token += 1
            self._armed = (phase, tid, time.monotonic() + timeout, timeout,
                           step, self._token)
            self._cond.notify_all()
            return self._token

    def mark_delivered(self, token: int) -> None:
        """The armed thread caught the StepHungError for ``token`` — its
        disarm must not treat the fire as a near-miss."""
        with self._cond:
            self._fired.pop(token, None)

    def disarm(self, token: int) -> None:
        fired_tid = None
        with self._cond:
            if self._armed is not None and self._armed[5] == token:
                self._armed = None
                self._cond.notify_all()
            fired_tid = self._fired.pop(token, None)
        if fired_tid is not None:
            # the phase completed after the deadline but before async
            # delivery: clear the pending exception (no-op if delivered)
            _set_async_exc(ctypes.c_ulong(fired_tid), None)
            _log.warning("guard watchdog: phase finished after its deadline "
                         "expired (near-miss); pending StepHungError cleared")

    def stop(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
            thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=1.0)

    def _loop(self) -> None:
        while True:
            with self._cond:
                while self._armed is None and not self._stop:
                    self._cond.wait()
                if self._stop:
                    return
                phase, tid, deadline, timeout, step, token = self._armed
                remaining = deadline - time.monotonic()
                if remaining > 0:
                    self._cond.wait(remaining)
                    continue        # re-check: disarmed or re-armed meanwhile
                self._armed = None
                self._fired[token] = tid
            self._fire(phase, tid, timeout, step, token)

    def _fire(self, phase: str, tid: int, timeout: float,
              step: Optional[int], token: int) -> None:
        # diagnostics FIRST — the stack dump and event must be on record
        # before the interrupt lands; the async exception is then posted
        # under the lock, where the token check makes post-vs-disarm
        # atomic: disarm() can never clear a not-yet-posted exception and
        # leave a stray StepHungError to erupt at some later bytecode
        frames = sys._current_frames()
        dumps = []
        for t in threading.enumerate():
            frame = frames.get(t.ident)
            if frame is not None:
                dumps.append("Thread %s (id %s):\n%s" % (
                    t.name, t.ident, "".join(traceback.format_stack(frame))))
        _log.error(
            "guard watchdog: phase %r exceeded MXTPU_STEP_TIMEOUT=%gs at "
            "step %s — dumping %d thread stacks\n%s",
            phase, timeout, step, len(dumps), "\n".join(dumps))
        self._guard._emit(GuardEvent(step, "hang", "raise", timeout, phase))
        with self._cond:
            if token not in self._fired:
                return      # phase completed while we logged: don't post
            if _set_async_exc(ctypes.c_ulong(tid),
                              ctypes.py_object(StepHungError)) != 1:
                self._fired.pop(token, None)
                _log.error("guard watchdog: failed to interrupt thread %s",
                           tid)


# ------------------------------------------------------------ the guard
class TrainingGuard:
    """Stateful guard enforcing the degradation ladder for one train run.

    Bind the things it may act on (``bind(manager=, net=, trainer=,
    module=)``); feed it the per-step loss via ``check_loss`` (and
    optionally gradients/params via ``check_tensors``); wrap phases in
    ``watch("data"|"forward"|"step"|"ckpt")``. ``gluon.Trainer``
    accepts ``guard=GuardPolicy(...)`` (or a guard) and checks each step's
    gradients itself, and so does ``fault.auto_resume_fit`` (the
    reference's ``module.BaseModule.fit`` is ROADMAP.md A11).
    """

    def __init__(self, policy: Optional[GuardPolicy] = None,
                 manager=None, net=None, trainer=None, module=None):
        self.policy = policy if policy is not None else GuardPolicy()
        self.manager = manager
        self.net = net
        self.trainer = trainer
        self.module = module
        # elastic override: when set, rollbacks restore through this
        # callable (``step=`` kwarg) instead of manager.restore — the
        # ElasticController's restore also re-installs sharded embedding
        # tables under the CURRENT mesh, which a plain params.npz load
        # cannot (the table's padded shape is mesh-dependent)
        self.restore_fn: Optional[Callable] = None
        self.events: List[GuardEvent] = []
        self.skipped = 0
        self.rescales = 0
        self.rollbacks = 0
        self.loss_scale = 1.0
        self.restored_meta: Optional[Dict[str, Any]] = None
        self._listeners: List[Callable[[GuardEvent], None]] = []
        self._window: deque = deque(maxlen=self.policy.spike_window)
        self._trips = 0          # ladder position (numerics sentinels)
        self._elastic_trips = 0  # resize-failure ladder — separate, so
        # numeric trips never spend the reshard-retry budget (and an
        # elastic rollback never wipes the numerics ladder position)
        self._clean = 0          # clean steps since the last trip
        self._tstep = 0          # trainer-level step counter (grads_ok)
        self._noted: List[int] = []   # checkpoint steps observed this run
        self._pending_losses: List = []   # (step, device loss-scalar) queue
        self._pending_census: List = []   # (step, device all-finite flag)
        self.host_syncs = 0      # blocking device->host loss fetches
        # (step, action) of the LAST loss processed by flush_losses: lets a
        # flush-boundary caller drop the current step's not-yet-applied
        # update when its own loss tripped (matching sync_every=1)
        self.last_flush = (0, OK)
        self._watchdog = _Watchdog(self)

    # -------------------------------------------------------------- wiring
    def bind(self, manager=None, net=None, trainer=None, module=None,
             restore_fn=None) -> "TrainingGuard":
        if manager is not None:
            self.manager = manager
        if net is not None:
            self.net = net
        if trainer is not None:
            self.trainer = trainer
        if module is not None:
            self.module = module
        if restore_fn is not None:
            self.restore_fn = restore_fn
        return self

    def add_listener(self, fn: Callable[[GuardEvent], None]) -> None:
        self._listeners.append(fn)

    def ensure_logger(self, logger=None) -> None:
        """Attach a ``callback.GuardEventLogger`` unless one is already
        listening — integrations call this so a guard shared across
        layers logs each event once, not once per layer."""
        from .callback import GuardEventLogger
        if not any(isinstance(fn, GuardEventLogger)
                   for fn in self._listeners):
            self.add_listener(GuardEventLogger(logger)
                              if logger is not None else GuardEventLogger())

    def note_checkpoint(self, step: int) -> None:
        """Record that an intact checkpoint exists at ``step`` — the floor
        rollback is allowed to restore to. Integrations call this after
        every successful save (and after resume)."""
        self._noted.append(int(step))

    def _emit(self, event: GuardEvent) -> None:
        self.events.append(event)
        _log.warning("guard: step=%s kind=%s action=%s value=%s detail=%s",
                     event.step, event.kind, event.action, event.value,
                     event.detail)
        # mirror into the flight recorder: the post-mortem dump
        # shows the full ladder inline with the step-phase spans
        _telemetry.guard_event(event.step, event.kind, event.action,
                               event.value, event.detail)
        for fn in self._listeners:
            try:
                fn(event)
            except Exception:
                _log.exception("guard listener %r failed", fn)
        if event.action == "raise":
            # the ladder is about to escalate to GuardTripError /
            # StepHungError: persist the last-N-steps flight record NOW,
            # while the timeline that led here is still in the ring
            path = _telemetry.dump(
                reason=f"guard:{event.kind}:{event.detail or 'raise'}")
            if path:
                _log.error("guard: flight recorder dumped to %s", path)

    def summary(self) -> Dict[str, Any]:
        kinds: Dict[str, int] = {}
        for e in self.events:
            kinds[e.kind] = kinds.get(e.kind, 0) + 1
        return {"trips": kinds, "skipped": self.skipped,
                "rescales": self.rescales, "rollbacks": self.rollbacks,
                "loss_scale": self.loss_scale}

    def close(self) -> None:
        self._watchdog.stop()

    # ----------------------------------------------------------- sentinels
    def check_loss(self, step: int, value: float) -> str:
        """NaN/Inf sentinel + spike detector over the step's loss scalar.
        Returns the ladder action: OK (proceed), SKIP/RESCALE (drop this
        update), or ROLLBACK (state was restored — see ``restored_meta``).
        """
        v = float(value)
        # both chaos points advance every call so an env fault plan's
        # skip/times counters stay step-aligned
        inject_nan = chaos.should_fail("guard.nan")
        inject_spike = chaos.should_fail("guard.spike")
        if inject_nan:
            return self._trip(step, "nan", float("nan"), "chaos:guard.nan")
        if inject_spike:
            # an injected spike trips unconditionally — even before the
            # detector has min_history — so a chaos plan never silently
            # spends its fire budget feeding a synthetic 1e4 loss into the
            # window as accepted history
            base = abs(v) if math.isfinite(v) and v != 0.0 else 1.0
            return self._trip(step, "spike", base * 1e4,
                              "chaos:guard.spike")
        if not math.isfinite(v):
            return self._trip(step, "nan", v, "")
        threshold = self._spike_threshold()
        if threshold is not None and v > threshold:
            return self._trip(step, "spike", v, f"threshold={threshold:.6g}")
        self._window.append(v)
        self._mark_clean()
        return OK

    def check_tensors(self, step: int,
                      tensors: Iterable[Tuple[str, Any]]) -> str:
        """NaN/Inf sentinel over named gradient/param tensors. Forces a
        device sync; run it every ``policy.check_every`` steps."""
        if chaos.should_fail("guard.nan"):
            return self._trip(step, "nan", float("nan"), "chaos:guard.nan")
        for name, t in tensors:
            if not _all_finite(t):
                return self._trip(step, "nan", float("nan"), name)
        self._mark_clean()
        return OK

    def grads_ok(self, trainer) -> bool:
        """Trainer-level hook: True means proceed with the update. Checks
        gradient finiteness every ``check_every`` steps (0 -> every step
        in this context — the trainer has no loss to watch instead).
        Forces a device sync; the fused trainer path uses
        ``fused_grads_ok`` + the device-side census instead."""
        self._tstep += 1
        every = max(1, self.policy.check_every)
        if self._tstep % every:
            return True
        pairs = []
        for param in trainer._params:
            if param.grad_req == "null":
                continue
            for i, g in enumerate(param.list_grad()):
                pairs.append((f"grad:{param.name}[{i}]", g))
        return self.check_tensors(self._tstep, pairs) == OK

    # ------------------------------------------------- fused device census
    def fused_grads_ok(self, trainer) -> bool:
        """Pre-step hook for the fused trainer step. Resolves the PREVIOUS
        step's device-side finiteness census (its value is long computed,
        so the read does not stall the stream: the guard's NaN sentinel
        is asynchronous instead of a host sync a step) and fires the
        ``guard.nan`` chaos point exactly like the per-parameter hook.
        Real non-finite gradients are caught by the census: the update was
        already skipped ON DEVICE, so a SKIP/RESCALE trip here only
        advances the ladder. A ROLLBACK trip restored an older checkpoint:
        the caller's gradients were computed against the pre-rollback
        weights, so this step is dropped too."""
        self._tstep += 1
        if not self.flush_census():
            return False
        every = max(1, self.policy.check_every)
        if self._tstep % every:
            return True
        if chaos.should_fail("guard.nan"):
            return self._trip(self._tstep, "nan", float("nan"),
                              "chaos:guard.nan") == OK
        return True

    def note_device_census(self, ok) -> None:
        """Queue a fused step's all-finite flag (an NDArray still on the
        device). Resolved by the next ``fused_grads_ok`` or an explicit
        ``flush_census()``."""
        self._pending_census.append((self._tstep, ok))

    def flush_census(self) -> bool:
        """Resolve queued device censuses: a failed census trips the
        ladder. The poisoned update was already skipped on the device, so
        on a SKIP/RESCALE trip the parameters and optimizer state are
        intact and training may proceed (returns True). A ROLLBACK trip
        restored an older checkpoint: returns False so the caller drops
        any update computed against the pre-rollback weights."""
        proceed = True
        pending, self._pending_census = self._pending_census, []
        for step, ok in pending:
            val = ok.asnumpy() if hasattr(ok, "asnumpy") else ok
            if bool(val):
                self._mark_clean()
            elif self._trip(step, "nan", float("nan"),
                            "fused census (device)") == ROLLBACK:
                proceed = False
        return proceed

    # --------------------------------------------------- deferred loss queue
    def note_loss(self, step: int, loss) -> None:
        """Queue a step's loss WITHOUT materializing it on the host — the
        async alternative to a per-step ``check_loss(float(loss.asnumpy()))``
        sync. The scalar stays a device array until ``flush_losses``
        fetches the whole queue in ONE transfer (every
        ``MXTPU_SYNC_EVERY`` steps / at epoch end), by
        which point its value has long materialized, so the fetch does not
        stall the pipeline."""
        self._pending_losses.append((int(step), loss))

    def flush_losses(self) -> str:
        """Materialize every queued loss in one host transfer and run each
        through ``check_loss`` in step order (chaos points advance exactly
        as in the synchronous path — once per step, just later). Returns
        the most severe ladder action taken. A ROLLBACK drops the rest of
        the queue: those losses were produced against pre-restore weights.

        Deferred semantics: a SKIP/RESCALE trip can no longer retroactively
        drop the already-applied update of the offending step — under
        deferral the fused device census (``note_device_census``) is the
        NaN authority that skips poisoned updates ON DEVICE; this queue
        drives the spike detector and the ladder bookkeeping. The one
        exception is the flush-boundary step itself: its update is not yet
        applied when the caller flushes, so ``last_flush`` lets the caller
        (``fault.auto_resume_fit``) drop it exactly as ``sync_every=1``
        would."""
        if not self._pending_losses:
            return OK
        pending, self._pending_losses = self._pending_losses, []
        with _telemetry.span("loss_flush", queued=len(pending)):
            vals = _fetch_scalars([l for _, l in pending])
        self.host_syncs += 1
        severity = {OK: 0, SKIP: 1, RESCALE: 2, ROLLBACK: 3}
        worst = OK
        for (step, _), v in zip(pending, vals):
            action = self.check_loss(step, v)
            self.last_flush = (step, action)
            if severity[action] > severity[worst]:
                worst = action
            if action == ROLLBACK:
                break
        return worst

    def _spike_threshold(self) -> Optional[float]:
        if len(self._window) < max(3, self.policy.spike_min_history):
            return None
        arr = _np.asarray(self._window, dtype=_np.float64)
        med = float(_np.median(arr))
        mad = float(_np.median(_np.abs(arr - med)))
        # 1.4826*MAD ~ sigma for a normal; floor it at 5% of the median so
        # a near-flat window (MAD ~ 0) flags only multiple-of-the-loss
        # spikes, not ordinary wiggle above the median
        sigma = max(1.4826 * mad, 0.05 * abs(med), 1e-8)
        return med + self.policy.spike_mad * sigma

    def _mark_clean(self) -> None:
        self._clean += 1
        if self._trips and self._clean >= self.policy.recovery_steps:
            self._trips = 0     # ladder heals after a sustained clean streak

    # -------------------------------------------------------------- ladder
    def _trip(self, step: int, kind: str, value: float, detail: str) -> str:
        self._clean = 0
        self._trips += 1
        p = self.policy
        if self._trips <= p.skip_limit:
            action = SKIP
        elif self._trips <= p.skip_limit + p.rescale_limit:
            action = RESCALE
            detail = (detail + " " if detail else "") + self._apply_rescale()
        else:
            action = ROLLBACK
            detail = (detail + " " if detail else "") + self._apply_rollback(
                step, kind, value)
            self._trips = 0
            self._window.clear()
            # deferred losses queued before the restore were produced
            # against the now-discarded trajectory — flushing them would
            # re-trip the ladder on a run the rollback already fixed
            self._pending_losses = []
        self.skipped += 1
        self._emit(GuardEvent(step, kind, action, value, detail.strip()))
        return action

    def elastic_trip(self, step: int, detail: str) -> str:
        """Advance the ladder for a FAILED elastic resize attempt
        (``elastic.ElasticController``): the first ``skip_limit +
        rescale_limit`` trips mean "retry the reshard" (SKIP), counted
        on the elastic ladder's OWN counter — numeric sentinel trips
        never spend the reshard-retry budget, and vice versa (cleared
        per-transition by ``elastic_clear``); beyond
        that the trip is a ROLLBACK — a checkpoint OLDER than the newest
        is restored when one was noted this run (the newest — usually
        the quiesce save every retry already reshards from — may itself
        be what's failing the resize), through ``restore_fn`` when bound
        so tables land on the current mesh. No loss-scale or LR fiddling
        on either tier: a resize failure is not a numerics failure. A
        spent rollback budget raises GuardTripError: a failed resize
        degrades down the ladder but never wedges."""
        self._elastic_trips += 1
        p = self.policy
        if self._elastic_trips <= p.skip_limit + p.rescale_limit:
            action = SKIP
        else:
            action = ROLLBACK
            detail = (detail + " " if detail else "") + self._apply_rollback(
                step, "elastic", float("nan"),
                prefer_older=True, backoff_lr=False)
            self._elastic_trips = 0
        self._emit(GuardEvent(step, "elastic", action, None,
                              detail.strip()))
        return action

    def elastic_clear(self) -> None:
        """A resize completed: the elastic retry ladder starts fresh
        (its budget is per-transition, not per-run)."""
        self._elastic_trips = 0

    def _optimizer(self):
        if self.trainer is not None:
            return getattr(self.trainer, "_optimizer", None)
        if self.module is not None:
            return getattr(self.module, "_optimizer", None)
        return None

    def _apply_rescale(self) -> str:
        """Halve the effective gradient/loss scale and tighten clipping.

        The halving is applied where it actually takes effect: through the
        trainer's persistent grad-scale (folded into
        ``optimizer.rescale_grad`` on every ``Trainer.step``), or directly
        on ``optimizer.rescale_grad`` for module-level optimizers.
        ``loss_scale`` records the cumulative multiplier."""
        self.rescales += 1
        self.loss_scale *= 0.5
        notes = [f"loss_scale={self.loss_scale:g}"]
        opt = self._optimizer()
        if self.trainer is not None:
            self.trainer._scale *= 0.5
            notes.append(f"grad_scale={self.trainer._scale:g}")
        elif opt is not None and getattr(opt, "rescale_grad", None):
            opt.rescale_grad = opt.rescale_grad * 0.5
            notes.append(f"rescale_grad={opt.rescale_grad:g}")
        if opt is not None:
            if getattr(opt, "clip_gradient", None):
                opt.clip_gradient = opt.clip_gradient * 0.5
            else:
                opt.clip_gradient = self.policy.rescale_clip
            notes.append(f"clip={opt.clip_gradient:g}")
        return " ".join(notes)

    def _apply_rollback(self, step: int, kind: str, value: float,
                        prefer_older: bool = False,
                        backoff_lr: bool = True) -> str:
        p = self.policy
        self.rollbacks += 1
        if self.rollbacks > p.max_rollbacks:
            self._emit(GuardEvent(step, kind, "raise", value,
                                  f"rollback budget {p.max_rollbacks} spent"))
            raise GuardTripError(
                f"guard: ladder exhausted at step {step} — "
                f"{p.max_rollbacks} rollback(s) already spent and the "
                f"{kind} sentinel tripped again")
        if self.manager is None:
            self._emit(GuardEvent(step, kind, "raise", value,
                                  "no CheckpointManager bound"))
            raise GuardTripError(
                f"guard: ladder reached rollback at step {step} but no "
                "CheckpointManager is bound — pass ckpt_dir/guard through "
                "fault.auto_resume_fit or bind(manager=...)")
        target = self.manager.latest()
        if not self._noted:
            self._emit(GuardEvent(step, kind, "raise", value,
                                  "no checkpoint observed this run"))
            raise GuardRollbackError(
                f"guard: rollback demanded at step {step} before any "
                "checkpoint was saved under this guard — refusing to "
                f"restore {'step-%d' % target if target is not None else 'nothing'} "
                "from a previous run silently")
        floor = min(self._noted)
        if target is None or target < floor:
            self._emit(GuardEvent(step, kind, "raise", value,
                                  f"targets {sorted(set(self._noted))} "
                                  "pruned or corrupt"))
            raise GuardRollbackError(
                f"guard: rollback demanded at step {step} but every "
                f"checkpoint this run saved ({sorted(set(self._noted))}) was "
                f"pruned by keep={getattr(self.manager, 'keep', '?')} or is "
                f"corrupt; newest intact is "
                f"{'step-%d' % target if target is not None else 'none'} — "
                "refusing to restore state that predates guarded training")
        if prefer_older:
            # elastic tier: try noted checkpoints STRICTLY older than
            # the newest first — the newest may be what's failing the
            # resize; a corrupt older candidate falls through to the
            # next (and finally to the newest)
            for cand in sorted({n for n in self._noted
                                if floor <= n < target}, reverse=True):
                try:
                    self.restored_meta = self._restore_target(cand)
                except (GuardTripError, GuardRollbackError):
                    raise
                except Exception as e:
                    _log.warning("guard: elastic rollback candidate "
                                 "step-%d failed (%r); trying older",
                                 cand, e)
                    continue
                lr = self._backoff_lr() if backoff_lr else "lr=kept"
                return f"restored=step-{cand} (pre-newest) {lr}"
        self.restored_meta = self._restore_target(target)
        lr_note = self._backoff_lr() if backoff_lr else "lr=kept"
        return f"restored=step-{target} {lr_note}"

    def _restore_target(self, target: int):
        if self.restore_fn is not None:
            return self.restore_fn(step=target)
        return self.manager.restore(
            net=self.net, trainer=self.trainer, module=self.module,
            step=target)

    def _backoff_lr(self) -> str:
        """Apply the LR-backoff multiplier through the lr_scheduler when one
        exists (BackoffScheduler.step_back, else scaling its base_lr), or
        directly through the optimizer lr."""
        mult = self.policy.lr_backoff
        opt = self._optimizer()
        if opt is None:
            return "lr=unbound"
        sched = getattr(opt, "lr_scheduler", None)
        if sched is not None:
            if hasattr(sched, "step_back"):
                sched.step_back(mult)
            else:
                for attr in ("base_lr", "base_lr_orig", "final_lr",
                             "warmup_final_lr", "stop_factor_lr"):
                    if hasattr(sched, attr):
                        setattr(sched, attr, getattr(sched, attr) * mult)
            return f"lr_backoff={mult} (scheduler)"
        opt.set_learning_rate(opt.learning_rate * mult)
        return f"lr={opt.learning_rate:.6g}"

    # ------------------------------------------------------------ watchdog
    @contextlib.contextmanager
    def watch(self, phase: str, step: Optional[int] = None):
        """Arm the hung-step watchdog around one phase (data/forward/step/
        ckpt). No-op when ``policy.step_timeout`` is unset. Phases do not
        nest — arming replaces the previous deadline."""
        timeout = self.policy.step_timeout
        if not timeout or timeout <= 0:
            yield
            return
        token = self._watchdog.arm(phase, threading.get_ident(), timeout,
                                   step)
        try:
            if chaos.should_fail("guard.hang"):
                self._simulated_hang(timeout)
            yield
        except StepHungError:
            self._watchdog.mark_delivered(token)
            raise StepHungError(
                f"step hung: phase {phase!r} exceeded "
                f"MXTPU_STEP_TIMEOUT={timeout:g}s"
                + (f" at step {step}" if step is not None else "")
                + " (thread stacks dumped to log)") from None
        finally:
            self._watchdog.disarm(token)

    def _simulated_hang(self, timeout: float) -> None:
        """Cooperative hang for the ``guard.hang`` chaos point: a pure
        Python sleep loop, so the watchdog's async StepHungError is
        delivered within one tick of the deadline. Bounded — if the
        watchdog is somehow disabled the loop exits on its own."""
        deadline = time.monotonic() + max(20.0 * timeout, timeout + 5.0)
        while time.monotonic() < deadline:
            time.sleep(0.002)
