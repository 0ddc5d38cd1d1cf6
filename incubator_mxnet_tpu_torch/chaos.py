"""Deterministic fault injection + shared retry policy.

The reference's fault story stops at ps-lite heartbeats surfacing dead
nodes (ref: include/mxnet/kvstore.h:353 get_num_dead_node,
src/kvstore/kvstore_dist.h:52 is_recovery); SURVEY §5.3 asks the TPU
build to *exceed* it. Exceeding it credibly requires exercising the
failure paths on demand — this module is that harness:

``maybe_fail("ps.push")`` — named injection points scattered through the
transport/data/persistence layers. Disarmed points cost one dict lookup;
armed points draw from a per-point seeded RNG so a failing run replays
bit-identically (the property ad-hoc ``kill -9`` chaos lacks).

Arming: programmatic (``chaos.arm("loader.worker", prob=0.1, seed=7)``)
or via the ``MXTPU_CHAOS`` env spec ``point:prob:seed[:times[:skip]]``
(comma-separated list) so subprocess workers and launch.py-spawned ranks
inherit the same fault plan. ``MXTPU_CHAOS_SALT`` perturbs the seed
deterministically per worker incarnation (set by the DataLoader: slot +
respawn count) so a respawned worker does not replay its predecessor's
death on the very first task.

``Retry`` — one policy object (exponential backoff + decorrelated jitter
+ deadline/attempt caps) for every reconnect/respawn loop, replacing the
hand-rolled sleep loops that each layer grew independently.

Registered points (grep for ``maybe_fail``/``should_fail``):
  ps.drop       client-side connection drop before a PS frame is sent
  ps.push       server-side failure while applying a push
  loader.worker DataLoader subprocess suicide before producing a batch
  ckpt.save     CheckpointManager.save, evaluated at each save stage
  guard.nan     TrainingGuard observes the step loss (or grads) as NaN
  guard.spike   TrainingGuard observes the step loss spiked (x1e4)
  guard.hang    a guarded phase hangs past MXTPU_STEP_TIMEOUT
  pipeline.stall io.DevicePrefetcher's producer sleeps before a batch —
                a slow loader; the consumer degrades to blocking without
                reordering or dropping batches
  serve.slow_model   serving demux: the model's device compute crawls —
                the engine degrades to blocking (and, past
                MXTPU_SERVE_TIMEOUT_MS, trips the hung-request watchdog)
  serve.queue_full   serving submit behaves as if the model queue were
                full: fast typed QueueFullError reject (backpressure)
  serve.client_abort a response's client went away before demux — the
                row is dropped without wedging the batch
  serve.dispatch_fail  a serving batch dispatch (or a degraded model's
                probe batch) fails — consecutive fires walk the
                engine's self-healing ladder: retry -> rebuild the
                executable -> degraded -> probe auto-restore
  serve.swap_fail    a hot model swap's canary fails deterministically —
                the swap rolls back (SwapError) with the live version
                untouched and still serving
  elastic.rank_kill  a simulated rank dies (elastic.SimulatedMembership:
                the group view shrinks, survivors quiesce + reshard);
                evaluated once per elastic view poll, so skip/times
                scripting pins the death to an exact step
  elastic.join  a previously dead simulated rank rejoins — the view
                grows and the same quiesce/reshard machinery scales the
                mesh back up (evaluated only while some rank is dead)
  elastic.resize_fail  an elastic reshard attempt fails before any state
                moves — the resize falls down the guard ladder (retry ->
                rollback -> GuardTripError) instead of wedging
  io.worker_kill  an input-service (or _recdecode) decode worker exits
                before building its batch — the supervisor respawns the
                slot and replays its in-flight work items exactly once,
                so the delivered stream stays bit-identical
  io.record_corrupt  one record draws as corrupt during decode — the
                quarantine path: skip + backfill + counted in
                mxtpu_io_records_skipped_total, bounded by
                MXTPU_IO_MAX_SKIP before a typed InputCorruptionError
  io.decode_stall  a decode worker sleeps MXTPU_IO_STALL_S before its
                batch — a slow disk/decoder; drives the heartbeat
                detector and the prefetch_wait starvation gate
"""
from __future__ import annotations

import os
import random as _random_mod
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["ChaosError", "RetryError", "Retry", "arm", "disarm", "reset",
           "maybe_fail", "should_fail", "points", "stats"]


class ChaosError(RuntimeError):
    """An injected fault. Never raised unless a point is armed."""


class _Point:
    __slots__ = ("name", "prob", "seed", "times", "skip", "rng",
                 "evals", "fired", "from_env")

    def __init__(self, name: str, prob: float, seed: int,
                 times: Optional[int] = None, skip: int = 0,
                 from_env: bool = False):
        if not (0.0 <= prob <= 1.0):
            raise ValueError(f"chaos prob must be in [0,1], got {prob}")
        self.name = name
        self.prob = float(prob)
        self.seed = int(seed)
        self.times = times
        self.skip = int(skip)
        self.from_env = from_env
        # per-point stream: point name and per-incarnation salt fold into
        # the seed so distinct points (and respawned workers) draw
        # independent — but still reproducible — sequences
        salt = os.environ.get("MXTPU_CHAOS_SALT", "")
        mix = zlib.crc32(f"{name}|{salt}".encode())
        self.rng = _random_mod.Random(self.seed ^ mix)
        self.evals = 0
        self.fired = 0

    def fire(self) -> bool:
        self.evals += 1
        if self.evals <= self.skip:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        if self.rng.random() < self.prob:
            self.fired += 1
            return True
        return False


_lock = threading.Lock()
_registry: Dict[str, _Point] = {}
# (MXTPU_CHAOS, MXTPU_CHAOS_SALT) last applied: a salt change must re-arm
# env points too, since the salt is folded into every point's seed
_env_spec_seen: Optional[Tuple[str, str]] = None


def _env_key() -> Tuple[str, str]:
    return (os.environ.get("MXTPU_CHAOS", ""),
            os.environ.get("MXTPU_CHAOS_SALT", ""))


def _parse_env_spec(spec: str) -> List[Tuple[str, float, int,
                                             Optional[int], int]]:
    """``point:prob:seed[:times[:skip]],...`` -> arm() argument tuples."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) < 2:
            raise ValueError(
                f"bad MXTPU_CHAOS entry {part!r}: need point:prob[:seed"
                f"[:times[:skip]]]")
        name = fields[0]
        prob = float(fields[1])
        seed = int(fields[2]) if len(fields) > 2 and fields[2] else 0
        times = int(fields[3]) if len(fields) > 3 and fields[3] else None
        skip = int(fields[4]) if len(fields) > 4 and fields[4] else 0
        out.append((name, prob, seed, times, skip))
    return out


def _sync_env_locked() -> None:
    """Re-arm env-specified points when MXTPU_CHAOS changes (monkeypatched
    env in tests, or first use in a freshly spawned worker)."""
    global _env_spec_seen
    key = _env_key()
    if key == _env_spec_seen:
        return
    _env_spec_seen = key
    for name in [n for n, p in _registry.items() if p.from_env]:
        del _registry[name]
    for name, prob, seed, times, skip in _parse_env_spec(key[0]):
        # programmatic arming wins over the env for the same point
        if name not in _registry:
            _registry[name] = _Point(name, prob, seed, times, skip,
                                     from_env=True)


def arm(name: str, prob: float = 1.0, seed: int = 0,
        times: Optional[int] = None, skip: int = 0) -> None:
    """Arm injection point ``name``: each evaluation fails with ``prob``
    from a stream seeded by ``seed``. ``times`` caps total fires;
    ``skip`` passes the first N evaluations untouched (deterministic
    "kill at the k-th stage" scripting)."""
    with _lock:
        _registry[name] = _Point(name, prob, seed, times, skip)


def disarm(name: str) -> None:
    with _lock:
        _registry.pop(name, None)


def reset() -> None:
    """Disarm everything, including env-armed points (until MXTPU_CHAOS
    or MXTPU_CHAOS_SALT changes again)."""
    global _env_spec_seen
    with _lock:
        _registry.clear()
        _env_spec_seen = _env_key()


def should_fail(name: str) -> bool:
    """Evaluate point ``name``; True means the caller must fail now.
    Non-raising variant for callers that fail by other means
    (``os._exit`` in the DataLoader worker).

    Every evaluation of an ARMED point is mirrored into the telemetry
    flight recorder (point, seed, fire/no-fire) so a chaos-lane failure is
    attributable from the post-mortem dump alone; disarmed points stay one
    dict lookup with no telemetry cost."""
    with _lock:
        _sync_env_locked()
        pt = _registry.get(name)
        if pt is None:
            return False
        fired = pt.fire()
        seed, evals = pt.seed, pt.evals
    # outside the lock: the recorder must never nest under the chaos lock
    from . import telemetry as _telemetry
    _telemetry.chaos_event(name, fired, seed, evals)
    return fired


def maybe_fail(name: str, exc: Callable[[str], BaseException] = ChaosError
               ) -> None:
    """Raise ``exc`` if the armed point fires; no-op when disarmed."""
    if should_fail(name):
        raise exc(f"chaos: injected fault at {name!r}")


def points() -> Dict[str, Dict[str, Any]]:
    """Armed points -> {prob, seed, times, skip, evals, fired}."""
    with _lock:
        _sync_env_locked()
        return {n: {"prob": p.prob, "seed": p.seed, "times": p.times,
                    "skip": p.skip, "evals": p.evals, "fired": p.fired}
                for n, p in _registry.items()}


def stats(name: str) -> Tuple[int, int]:
    """(evaluations, fires) for a point; (0, 0) if never armed."""
    with _lock:
        pt = _registry.get(name)
        return (pt.evals, pt.fired) if pt is not None else (0, 0)


# --------------------------------------------------------------------- retry
class RetryError(RuntimeError):
    """All attempts exhausted; ``__cause__`` holds the last error."""


class Retry:
    """Exponential backoff + jitter + deadline, shared by every layer.

    ``attempts()`` yields attempt indices, sleeping between them, and
    stops when ``max_attempts`` or ``deadline`` (seconds, wall-clock from
    first attempt) is exhausted. ``call(fn)`` wraps the loop: returns
    ``fn()``'s value on first success, raises ``RetryError`` (chaining
    the last exception) when attempts run out. A seeded RNG makes the
    jitter — hence the timing of a chaos run — reproducible; when no seed
    is given, ``MXTPU_TEST_SEED`` (the chaos CI lane's fixed seed) is used
    so CI backoff timing never depends on wall-clock entropy, and only
    outside CI does the jitter fall back to fresh entropy (decorrelating
    production workers).
    """

    def __init__(self, max_attempts: Optional[int] = None,
                 deadline: Optional[float] = None, base: float = 0.05,
                 cap: float = 2.0, jitter: float = 0.5,
                 seed: Optional[int] = None,
                 sleep: Callable[[float], None] = time.sleep):
        if max_attempts is None and deadline is None:
            raise ValueError("Retry needs max_attempts and/or deadline")
        self.max_attempts = max_attempts
        self.deadline = deadline
        self.base = float(base)
        self.cap = float(cap)
        self.jitter = float(jitter)
        if seed is None:
            env_seed = os.environ.get("MXTPU_TEST_SEED")
            if env_seed:
                seed = int(env_seed)
        self._rng = _random_mod.Random(seed)
        self._sleep = sleep

    def backoff(self, attempt: int) -> float:
        """Delay before attempt ``attempt+1`` (full-jitter on the upper
        half: delay in [d/2, d] of the exponential envelope). Always in
        [0, cap]: the exponent saturates (2.0**1025 would raise
        OverflowError) so deadline-bounded loops can retry indefinitely."""
        d = min(self.cap, self.base * (2.0 ** min(attempt, 63)))
        return min(self.cap, max(0.0, d * (1.0 - self.jitter
                                           * self._rng.random())))

    def attempts(self):
        start = time.monotonic()
        n = 0
        while True:
            yield n
            n += 1
            if self.max_attempts is not None and n >= self.max_attempts:
                return
            delay = self.backoff(n - 1)
            if self.deadline is not None:
                remaining = self.deadline - (time.monotonic() - start)
                if remaining <= 0:
                    return
                delay = min(delay, remaining)
            self._sleep(max(0.0, delay))

    def call(self, fn: Callable, *args,
             retry_on: Tuple[type, ...] = (Exception,),
             on_retry: Optional[Callable[[int, BaseException], None]] = None,
             **kwargs):
        last: Optional[BaseException] = None
        n = 0
        for attempt in self.attempts():
            n = attempt + 1
            try:
                return fn(*args, **kwargs)
            except retry_on as e:
                last = e
                if on_retry is not None:
                    on_retry(attempt, e)
        raise RetryError(f"gave up after {n} attempt(s): {last}") from last
