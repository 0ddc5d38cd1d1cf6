"""The host-side async parameter server behind ``kvstore('dist_async')``.

Counterpart of ``incubator_mxnet_tpu/_ps.py``. The reference's
``dist_async`` applies each worker's push on the server the moment it
arrives, with no barrier across workers, and a pull returns whatever the
server holds then (ref: src/kvstore/kvstore_dist_server.h:325-358
DataHandleEx -> ApplyUpdates; tests/nightly/dist_async_kvstore.py). Here
rank 0 keeps the key -> value state (numpy, on the host) in a socket loop;
workers push gradients and pull weights over TCP in length-prefixed pickle
frames. Updates are applied under a lock (the serialized executor of the
reference's ``exec_.Exec``, kvstore_dist_server.h:227), on CPU tensors by
the port's optimizer.

The synchronous types do not use it: ``dist_sync`` sums over
``torch.distributed``. Async SGD's staleness is not a collective.

Security: frames are pickles (numpy payloads), so a connection is code
execution, as on the reference's ps-lite transport; the trust boundary is
the cluster network. A 32-byte shared-token handshake rejects stray
connections; ``tools/launch.py`` makes a random ``MXTPU_PS_TOKEN`` a job.
When the coordinator is not loopback, an explicit token is required.
Frames are capped (``MXTPU_PS_MAX_FRAME``, default 1 GiB).

The server's profiler commands (``send_command_to_servers``) need
``profiler.py``, which is ROADMAP.md A11: the server answers them with an
error naming it.
"""
from __future__ import annotations

import logging
import os
import pickle
import socket
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from . import chaos
from .chaos import ChaosError, Retry

_LEN = struct.Struct("!Q")

_log = logging.getLogger(__name__)

# one-time "dead detection is degraded" warning (heartbeats disabled):
# process-global so a job with several servers/stores warns exactly once
_eof_degraded_warned = False
_eof_warn_lock = threading.Lock()


def _hb_interval() -> float:
    """Client heartbeat period (seconds); <= 0 disables heartbeats."""
    return float(os.environ.get("MXTPU_PS_HEARTBEAT", "2.0"))


def _dead_timeout() -> float:
    """Silence threshold before a registered rank counts as dead (ref:
    ps-lite van heartbeat_timeout). Default 3 missed heartbeats; with
    heartbeats disabled the silence-based signal disables (never-dead)
    instead of flagging every idle rank — liveness then degrades to the
    socket EOF/reset fallback in ``_client_loop`` (a registered
    connection dropping marks its rank dead immediately, with a one-time
    degraded-detection warning)."""
    val = os.environ.get("MXTPU_PS_DEAD_TIMEOUT")
    if val is not None:
        return float(val)
    hb = _hb_interval()
    if hb <= 0:
        return float("inf")
    return 3.0 * max(hb, 0.1)


def _barrier_timeout() -> float:
    """Barrier deadline before the waiter gets a TimeoutError naming the
    missing ranks. The default matches MXTPU_PS_CONNECT_TIMEOUT: a rank
    the connect path is still willing to wait for (slow interpreter
    start under load) must not already have failed its peers' first
    barrier."""
    val = os.environ.get("MXTPU_PS_BARRIER_TIMEOUT")
    if val is not None:
        return float(val)
    return float(os.environ.get("MXTPU_PS_CONNECT_TIMEOUT", "300"))


def _warn_degraded_liveness() -> None:
    """One-time warning that heartbeats are off and dead detection has
    degraded to connection EOF/reset (no silence-based signal: a rank
    that wedges without dropping its socket is never flagged)."""
    global _eof_degraded_warned
    with _eof_warn_lock:
        if _eof_degraded_warned:
            return
        _eof_degraded_warned = True
    _log.warning(
        "async PS heartbeats disabled (MXTPU_PS_HEARTBEAT <= 0): dead "
        "detection degraded to socket EOF/reset from registered "
        "connections — a rank that hangs without closing its socket "
        "will never be flagged dead")


def _call_retries() -> int:
    """Reconnect+resend attempts for one RPC after its connection broke
    (MXTPU_PS_CALL_RETRIES, default 3). Driven through the shared
    ``chaos.Retry`` policy — capped backoff with seeded jitter — so a
    server bounce mid-resize doesn't fail the survivor that notices
    first, and the survivors don't all hammer the recovering server in
    lockstep."""
    return max(1, int(os.environ.get("MXTPU_PS_CALL_RETRIES", "3")))


class PSUnreachableError(ConnectionError):
    """``_connect`` exhausted the full MXTPU_PS_CONNECT_TIMEOUT patience
    window: the server is gone, not mid-bounce. Still a ConnectionError
    for callers; the resend retry loop treats it as terminal (other,
    fast connection failures — a bouncing server's handshake dying —
    stay retryable)."""


class _ServerGone(RuntimeError):
    """Terminal wrapper for PSUnreachableError inside the resend retry
    (deliberately NOT an OSError subclass, so ``Retry.call(retry_on=
    (ConnectionError, OSError, ...))`` does not multiply the connect
    window by the attempt budget)."""


def _send_msg(sock: socket.socket, obj) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


def _max_frame() -> int:
    return int(os.environ.get("MXTPU_PS_MAX_FRAME", str(1 << 30)))


# profiler.set_config keys whose values are strings by contract; every
# other knob is bool/int and gets typed coercion (the reference's
# KVStoreServerProfilerCommand parses typed values — a raw "0" string is
# truthy and would wrongly enable boolean knobs like aggregate_stats)
_PROFILER_STRING_KEYS = frozenset({"filename", "profile_process"})


def _parse_profiler_config(body: str) -> Dict[str, Any]:
    """Parse a kSetConfig "key=value,key=value" body with typed values."""
    def _coerce(v: str):
        low = v.lower()
        if low in ("true", "false"):
            return low == "true"
        if low in ("0", "1"):
            return bool(int(low))
        if low.lstrip("+-").isdigit():
            return int(low)
        return v

    cfg: Dict[str, Any] = {}
    for kv in body.split(","):
        if "=" in kv:
            kk, vv = kv.split("=", 1)
            kk, vv = kk.strip(), vv.strip()
            cfg[kk] = vv if kk in _PROFILER_STRING_KEYS else _coerce(vv)
    return cfg


def _recv_msg(sock: socket.socket):
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if n > _max_frame():
        raise ConnectionError(f"frame of {n} bytes exceeds "
                              f"MXTPU_PS_MAX_FRAME={_max_frame()}")
    return pickle.loads(_recv_exact(sock, n))


def ps_token() -> bytes:
    """Shared 32-byte secret for the connection handshake.

    Always a sha256 digest (fixed 32 bytes on the wire regardless of the
    secret's length). Loopback jobs may fall back to an address-derived
    token — anything that can reach 127.0.0.1 already owns the host —
    but multi-host jobs must set MXTPU_PS_TOKEN (launch.py does).
    """
    import hashlib
    tok = os.environ.get("MXTPU_PS_TOKEN")
    if tok:
        return hashlib.sha256(tok.encode()).digest()
    coord = os.environ.get("MXTPU_COORDINATOR", "127.0.0.1:49875")
    host = coord.rsplit(":", 1)[0]
    if host not in ("127.0.0.1", "localhost", "::1"):
        raise RuntimeError(
            "dist_async across hosts requires an explicit MXTPU_PS_TOKEN "
            "(tools/launch.py generates one); a token derived from the "
            "coordinator address is guessable by anyone who can reach it")
    return hashlib.sha256(("mxtpu-ps:" + coord).encode()).digest()


def ps_address() -> str:
    """Server address: MXTPU_PS_ADDR, else coordinator host : port+1."""
    addr = os.environ.get("MXTPU_PS_ADDR")
    if addr:
        return addr
    coord = os.environ.get("MXTPU_COORDINATOR", "127.0.0.1:49875")
    host, port = coord.rsplit(":", 1)
    return f"{host}:{int(port) + 1}"


class AsyncPSServer:
    """Rank-0-owned key/value state with apply-on-push (no barrier).

    Also the job's **membership authority** (elastic training, docs/
    fault_tolerance.md "Elastic training"): the set of live registered
    ranks forms an epoch-numbered *group view*. A rank death (heartbeat
    silence past MXTPU_PS_DEAD_TIMEOUT, or socket EOF when heartbeats
    are disabled), a join/rejoin ``register``, or a clean ``stop``
    publishes a new view — the epoch bumps and ``view`` requests return
    the survivors. The elastic controller (ROADMAP.md A10c) is to poll
    this to drive quiesce → reshard → resume."""

    def __init__(self, addr: str, num_workers: int):
        host, port = addr.rsplit(":", 1)
        self._num_workers = num_workers
        self._store: Dict[Any, np.ndarray] = {}
        self._push_counts: Dict[Any, int] = {}
        self._dedup: Dict[bytes, tuple] = {}   # client_id -> (seq, reply)
        self._cid_locks: Dict[bytes, threading.Lock] = {}
        self._updater = None
        self._lock = threading.Lock()
        self._barrier_lock = threading.Lock()
        self._barrier_cond = threading.Condition(self._barrier_lock)
        self._barrier_count = 0
        self._barrier_gen = 0
        # liveness: rank -> {"last_seen": monotonic, "cid": bytes}. Fed by
        # register/heartbeat/any traffic; read by the dead_nodes op (the
        # reference's ps-lite van heartbeats -> get_num_dead_node).
        self._ranks: Dict[int, Dict[str, Any]] = {}
        # ranks counted into the CURRENT barrier generation -> their cid,
        # so a dead worker's stale entry can be withdrawn when it rejoins
        self._barrier_entered: Dict[int, bytes] = {}
        # elastic group view: epoch-numbered live-rank set, refreshed
        # lazily against the dead set on every view/view_barrier/register
        self._view_epoch = 0
        self._view_ranks: set = set()
        # view-scoped quiesce barrier (separate from the fixed-size
        # ``barrier``): completes when every TARGET rank has entered.
        # The target starts as the caller's explicit rank set (elastic
        # passes the ranks continuing through a resize) or the live view
        # at first entry, and only ever SHRINKS while waiting — a rank
        # dying mid-quiesce drops out instead of wedging the rendezvous,
        # and a rank joining mid-quiesce must NOT grow it (a joiner has
        # nothing in flight to quiesce; it is the next epoch's business)
        self._vb_gen = 0
        self._vb_entered: Dict[int, bytes] = {}
        self._vb_target: Optional[set] = None
        if _hb_interval() <= 0:
            _warn_degraded_liveness()
        self._conns: set = set()
        self._closed = False
        self._inflight = 0
        self._inflight_cond = threading.Condition()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(num_workers + 4)
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()
        # the server dies with its owner process (by design — ps-lite's
        # server role ends at Finalize), but daemon threads die MID-SEND:
        # drain in-flight replies first so peers' last requests (their
        # finalize barrier, typically) are answered before teardown
        import atexit
        atexit.register(self._drain_inflight)

    # ------------------------------------------------------------- handlers
    def _apply_push(self, key, grad: np.ndarray):
        # injected server-side failure BEFORE any state mutation: the
        # handler thread dies, the connection drops, and the client's
        # resend must apply the push exactly once
        chaos.maybe_fail("ps.push")
        with self._lock:  # serialized, ref exec_.Exec
            if self._updater is not None and key in self._store:
                import torch
                from .ndarray.ndarray import _wrap
                w = _wrap(torch.from_numpy(np.array(self._store[key])))
                g = _wrap(torch.from_numpy(np.array(grad)))
                self._updater(key, g, w)
                self._store[key] = w._data.numpy()
            else:
                # no updater: the stored value BECOMES the merged push (ref
                # kvstore_dist_server.h ApplyUpdates, stored = merged — not
                # an accumulate onto the init value)
                self._store[key] = grad.copy()
            self._push_counts[key] = self._push_counts.get(key, 0) + 1

    def _register(self, rank: int, cid: bytes, is_recovery: bool,
                  conn=None):
        """Record a rank's (re)join. A different cid for an
        already-known rank means the previous incarnation died: drop its
        resend-dedup state and withdraw any stale entry it left in the
        pending barrier, so the rejoined worker's fresh barrier call
        counts exactly once (the reference's ``is_recovery`` rejoin,
        kvstore_dist.h:52)."""
        with self._lock:
            old = self._ranks.get(rank)
            # a (re)join clears any EOF-based dead flag and republishes
            # the group view (the reference's is_recovery rejoin is the
            # membership event elastic scale-up keys off)
            # the registering CONNECTION is recorded too: the client
            # keeps one cid across reconnects, so cid alone cannot tell
            # an old socket's late EOF from the current one (see
            # _mark_conn_dead)
            self._ranks[rank] = {"last_seen": time.monotonic(),
                                 "cid": cid, "conn": conn}
            self._refresh_view_locked()
        # a same-cid reconnect (is_recovery from a live client) keeps its
        # dedup state — that state is exactly what makes resends safe
        replaced = old is not None and old["cid"] != cid
        if replaced:
            with self._lock:
                self._dedup.pop(old["cid"], None)
                self._cid_locks.pop(old["cid"], None)
            with self._barrier_cond:
                if self._barrier_entered.get(rank) == old["cid"]:
                    del self._barrier_entered[rank]
                    self._barrier_count -= 1
                # ...and from the view barrier: the dead incarnation
                # never finished quiescing, so its entry must not let
                # the rendezvous complete around the restarted process
                if self._vb_entered.get(rank) == old["cid"]:
                    del self._vb_entered[rank]

    def _touch(self, rank: Optional[int]):
        if rank is None:
            return
        with self._lock:
            info = self._ranks.get(rank)
            if info is not None:
                info["last_seen"] = time.monotonic()

    def _dead_locked(self) -> set:
        """Dead rank set (caller holds ``_lock``): silent past the dead
        timeout, or EOF-flagged when heartbeats are disabled."""
        horizon = time.monotonic() - _dead_timeout()
        return {r for r, info in self._ranks.items()
                if info.get("dead") or info["last_seen"] < horizon}

    def _refresh_view_locked(self) -> Tuple[int, List[int]]:
        """Recompute the live-rank group view (caller holds ``_lock``);
        any membership change — death, join, clean stop — bumps the view
        epoch. Returns (epoch, sorted live ranks)."""
        live = set(self._ranks) - self._dead_locked()
        if live != self._view_ranks:
            self._view_ranks = live
            self._view_epoch += 1
        return self._view_epoch, sorted(live)

    def group_view(self) -> Tuple[int, List[int]]:
        """Current (epoch, live ranks) — the membership authority's word
        on who is in the job right now."""
        with self._lock:
            return self._refresh_view_locked()

    def dead_nodes(self) -> List[int]:
        """Registered ranks silent longer than MXTPU_PS_DEAD_TIMEOUT (or
        EOF-flagged when heartbeats are disabled)."""
        with self._lock:
            return sorted(self._dead_locked())

    def _handle(self, msg, ctx):
        op = msg[0]
        if op == "push":
            _, key, grad = msg
            self._apply_push(key, grad)
            return ("ok",)
        if op == "pull":
            with self._lock:
                val = self._store.get(msg[1])
            return ("val", None if val is None else val.copy())
        if op == "init":
            _, key, val = msg
            with self._lock:
                if key not in self._store:
                    self._store[key] = val.copy()
            return ("ok",)
        if op == "set_optimizer":
            from .optimizer import get_updater
            optimizer = pickle.loads(msg[1])
            with self._lock:
                self._updater = get_updater(optimizer)
            return ("ok",)
        if op == "push_count":
            with self._lock:
                return ("val", self._push_counts.get(msg[1], 0))
        if op == "register":
            _, rank, is_recovery = msg
            ctx["rank"] = int(rank)
            self._register(int(rank), ctx["cid"], bool(is_recovery),
                           conn=ctx.get("conn"))
            return ("ok",)
        if op == "hb":
            # last_seen is already touched per-message in _client_loop;
            # the frame exists to generate traffic during idle stretches
            return ("ok",)
        if op == "dead_nodes":
            return ("val", self.dead_nodes())
        if op == "view":
            return ("val", self.group_view())
        if op == "view_barrier":
            return self._view_barrier(ctx,
                                      msg[1] if len(msg) > 1 else None)
        if op == "command":
            # server-side profiler control (ref: include/mxnet/kvstore.h:49
            # KVStoreServerProfilerCommand): heads 0..3 = kSetConfig /
            # kState / kPause / kResume need profiler.py (ROADMAP.md A11)
            _, head, body = msg
            if head not in (0, 1, 2, 3):
                return ("err", f"unknown command head {head}")
            if head == 0:
                _parse_profiler_config(str(body))
            return ("err", "server profiler commands need profiler.py, "
                    "ROADMAP.md A11 (not ported)")
        if op == "barrier":
            timeout = _barrier_timeout()
            with self._barrier_cond:
                gen = self._barrier_gen
                rank = ctx.get("rank")
                if rank is not None:
                    self._barrier_entered[rank] = ctx["cid"]
                self._barrier_count += 1
                if self._barrier_count == self._num_workers:
                    self._barrier_count = 0
                    self._barrier_gen += 1
                    self._barrier_entered.clear()
                    self._barrier_cond.notify_all()
                else:
                    deadline = time.monotonic() + timeout
                    while gen == self._barrier_gen and not self._closed:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            # name the laggards, then withdraw our own
                            # entry so a retried barrier counts once.
                            # Withdraw the count ONLY if _register hasn't
                            # already done it for us (a dead-and-rejoined
                            # rank): a double decrement would corrupt the
                            # count and wedge every later barrier.
                            missing = sorted(
                                set(range(self._num_workers))
                                - set(self._barrier_entered))
                            if rank is None:
                                self._barrier_count -= 1
                            elif (self._barrier_entered.get(rank)
                                    == ctx["cid"]):
                                del self._barrier_entered[rank]
                                self._barrier_count -= 1
                            return ("barrier_timeout", timeout, missing)
                        self._barrier_cond.wait(min(remaining, 1.0))
                        # a rank parked in this barrier is demonstrably
                        # alive — keep its last_seen fresh even though its
                        # client can't heartbeat (the RPC lock is held for
                        # the duration of the blocking barrier call)
                        self._touch(rank)
                    if gen == self._barrier_gen:
                        # woken by close(), not by completion: an "ok"
                        # here would let workers sail past an UNMET
                        # barrier on stale state — fail loudly instead
                        return ("err", "server closed during barrier")
            return ("ok",)
        return ("err", f"unknown op {op!r}")

    def _view_barrier(self, ctx, ranks=None):
        """Quiesce rendezvous: completes when every TARGET rank has
        entered. The target is the caller's explicit ``ranks`` (elastic
        resizes pass the ranks continuing through the transition) or the
        live view at first entry, and then only SHRINKS — a rank that
        dies while the survivors quiesce is dropped and the rendezvous
        completes without it, while a recovery rejoin landing
        mid-quiesce does NOT grow the target (the joiner has nothing in
        flight and never enters this rendezvous — growing would wedge
        the survivors for the full timeout). On timeout the reply names
        the target ranks that never arrived (the satellite contract: a
        wedged quiesce is attributable from the error alone)."""
        timeout = _barrier_timeout()
        deadline = time.monotonic() + timeout
        with self._barrier_cond:
            rank = ctx.get("rank")
            gen = self._vb_gen
            if rank is not None:
                self._vb_entered[rank] = ctx["cid"]
            if ranks is not None:
                tgt = {int(r) for r in ranks}
                self._vb_target = tgt if self._vb_target is None \
                    else self._vb_target & tgt
            while True:
                if gen != self._vb_gen:
                    return ("ok",)   # completed by another arrival
                # lock order _barrier_cond -> _lock matches _touch
                with self._lock:
                    _, live = self._refresh_view_locked()
                if self._vb_target is None:
                    self._vb_target = set(live)
                self._vb_target &= set(live)      # shrink-only
                if self._vb_target <= set(self._vb_entered):
                    self._vb_gen += 1
                    self._vb_entered = {}
                    self._vb_target = None
                    self._barrier_cond.notify_all()
                    return ("ok",)
                if self._closed:
                    return ("err", "server closed during view barrier")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    missing = sorted(self._vb_target
                                     - set(self._vb_entered))
                    if rank is not None \
                            and self._vb_entered.get(rank) == ctx["cid"]:
                        del self._vb_entered[rank]
                    if not self._vb_entered:
                        self._vb_target = None   # don't leak a stale
                        # target into the next rendezvous generation
                    return ("barrier_timeout", timeout, missing)
                self._barrier_cond.wait(min(remaining, 0.5))
                # the waiter's client thread holds its call lock for the
                # whole barrier, starving its heartbeat thread — touch
                # it here so a parked rank is not flagged dead. The
                # trade-off: a waiter that DIES after entering stays
                # "live" until its handler thread unwinds post-barrier
                # (silence-based detection then fires and the follow-up
                # view change reshards it away).
                self._touch(rank)

    def _mark_conn_dead(self, ctx):
        """EOF/reset fallback for heartbeat-less liveness: the registered
        connection of ``ctx``'s rank dropped uncleanly — with no
        heartbeat signal to age it out, flag the rank dead NOW (cleared
        by its next ``register``). With heartbeats on, silence-based
        detection stays the authority (a live client may legitimately
        reconnect, and its old socket's EOF must not flag it). The flag
        requires the dropping connection to be the rank's CURRENT
        registered one — the client reuses its cid across reconnects,
        so an old socket's late EOF arriving after a re-register must
        not kill the live rank."""
        if _hb_interval() > 0:
            return
        rank = ctx.get("rank")
        if rank is None:
            return
        with self._lock:
            info = self._ranks.get(rank)
            if info is not None and info["cid"] == ctx["cid"] \
                    and info.get("conn") is ctx.get("conn"):
                info["dead"] = True
                self._refresh_view_locked()
        # wake quiesce barriers: their view target may just have shrunk
        with self._barrier_cond:
            self._barrier_cond.notify_all()

    def _client_loop(self, conn):
        ctx: Dict[str, Any] = {"cid": b"", "rank": None, "conn": conn}
        try:
            # handshake BEFORE any pickle.loads of payload frames; the
            # token is exactly 32 bytes and TCP may split it — read exact.
            # A 16-byte client id follows: it keys the resend-dedup state
            # so a reconnecting worker's retry of an already-applied push
            # is answered from cache, not applied twice (ref ps-lite
            # resend semantics dedup by message id).
            hello = _recv_exact(conn, 32)
            if hello != ps_token():
                conn.close()
                return
            cid = _recv_exact(conn, 16)
            with self._lock:
                cid_lock = self._cid_locks.setdefault(cid, threading.Lock())
            ctx["cid"] = cid
            while True:
                seq, msg = _recv_msg(conn)
                self._touch(ctx["rank"])
                if msg[0] == "stop":
                    # clean shutdown: deregister so a departed worker is
                    # not reported dead after job end
                    rank = ctx["rank"]
                    if rank is not None:
                        with self._lock:
                            info = self._ranks.get(rank)
                            if info is not None and info["cid"] == cid:
                                del self._ranks[rank]
                                # a departed rank leaves the group view
                                # too (elastic scale-down on clean exit)
                                self._refresh_view_locked()
                    _send_msg(conn, ("ok",))
                    break
                # in-flight accounting brackets handle+reply so the
                # owner process's exit can drain pending replies (see
                # _drain_inflight) — without it, rank 0 returning from
                # its own barrier and exiting kills this daemon thread
                # BEFORE the peer's barrier reply is flushed, and the
                # peer dies with 'peer closed' at job end
                with self._inflight_cond:
                    self._inflight += 1
                try:
                    # check-and-handle must be atomic per client id: a
                    # retried frame racing the still-in-flight original
                    # (old conn's handler hasn't stored its dedup entry
                    # yet) would apply the push twice. Only
                    # non-idempotent ops are cached — their replies are
                    # tiny ("ok",) tuples, so the cache never pins a
                    # pulled weight array.
                    with cid_lock:
                        last = self._dedup.get(cid)
                        if last is not None and last[0] == seq:
                            reply = last[1]   # duplicate, answered from cache
                        else:
                            reply = self._handle(msg, ctx)
                            if msg[0] in ("push", "barrier",
                                          "view_barrier",
                                          "set_optimizer"):
                                self._dedup[cid] = (seq, reply)
                    _send_msg(conn, reply)
                finally:
                    # refresh liveness after handling too: a slow apply
                    # (first-push jit compile) keeps the client blocked —
                    # and silent — for the whole duration
                    self._touch(ctx["rank"])
                    with self._inflight_cond:
                        self._inflight -= 1
                        self._inflight_cond.notify_all()
        except (ConnectionError, OSError, ChaosError):
            # ChaosError: an injected server-side fault plays as a
            # connection-handler crash — drop the conn, client resends.
            # With heartbeats disabled this EOF/reset is the ONLY
            # liveness signal: flag the rank dead (degraded detection)
            self._mark_conn_dead(ctx)
        finally:
            self._conns.discard(conn)
            conn.close()

    def _drain_inflight(self, timeout: float = 5.0):
        """Block (bounded) until every received request has had its
        reply handed to the kernel — called at owner-process exit. A
        closed server skips the wait: its replies are undeliverable."""
        if self._closed:
            return
        deadline = time.monotonic() + timeout
        with self._inflight_cond:
            while self._inflight > 0 and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._inflight_cond.wait(min(remaining, 0.1))

    def _accept_loop(self):
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            self._conns.add(conn)
            threading.Thread(target=self._client_loop, args=(conn,),
                             daemon=True).start()

    def close(self):
        """Tear down the listener AND live client connections — a close is
        a server death as far as workers are concerned (they reconnect).

        shutdown() before close(): the accept/recv threads are blocked in
        syscalls holding kernel refs to these sockets — a bare close()
        releases the fd but leaves the kernel socket (and the LISTEN port)
        alive until the blocked syscall returns, which it never would.
        """
        self._closed = True
        # wake barrier waiters (their replies are undeliverable now) and
        # unpin this instance from the atexit registry so the weight
        # _store of a closed server can be garbage-collected
        with self._barrier_cond:
            self._barrier_cond.notify_all()
        with self._inflight_cond:
            self._inflight_cond.notify_all()
        import atexit
        try:
            atexit.unregister(self._drain_inflight)
        except Exception:
            pass
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        for conn in list(self._conns):
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass


class AsyncPSClient:
    """Per-worker connection to the rank-0 server (retries with
    exponential backoff while the server process is still starting).

    The deadline defaults to MXTPU_PS_CONNECT_TIMEOUT (300 s): on a
    loaded host the server rank's interpreter may take minutes just to
    import and bind under CPU contention, and the reference's ps-lite
    tolerates slow peers the same way — Postoffice barriers with long
    timeouts (ref: src/kvstore/kvstore_dist.h:105) rather than a fast
    connect failure."""

    def __init__(self, addr: str, timeout: Optional[float] = None,
                 rank: Optional[int] = None):
        if timeout is None:
            timeout = float(os.environ.get("MXTPU_PS_CONNECT_TIMEOUT",
                                           "300"))
        self._addr = addr
        self._timeout = timeout
        self._lock = threading.Lock()
        self._sock = None
        self._cid = os.urandom(16)   # keys server-side resend dedup
        self._seq = 0
        self._rank = rank
        self._ever_connected = False
        self._hb_stop = threading.Event()
        self._connect()
        if rank is not None and _hb_interval() > 0:
            self._hb_thread = threading.Thread(
                target=self._hb_loop, daemon=True,
                name=f"mxtpu-ps-hb-{rank}")
            self._hb_thread.start()

    def _connect(self):
        host, port = self._addr.rsplit(":", 1)
        deadline = time.monotonic() + self._timeout

        def attempt():
            # exponential backoff (shared Retry policy): fast first
            # retries for the common ephemeral-port race, sparse capped
            # polling thereafter so a starved server rank isn't further
            # starved by spinning. Per-attempt timeout is the REMAINING
            # deadline: a black-holed connect must not stretch the total
            # wait past ~MXTPU_PS_CONNECT_TIMEOUT.
            sock = socket.create_connection(
                (host, int(port)),
                timeout=max(1.0, deadline - time.monotonic()))
            # connect timeout must NOT stay armed: a peer may sit in a
            # long jit compile before its next barrier()/push()
            sock.settimeout(None)
            return sock

        try:
            self._sock = Retry(deadline=self._timeout, base=0.05, cap=2.0
                               ).call(attempt, retry_on=(OSError,))
        except chaos.RetryError as e:
            raise PSUnreachableError(
                f"async PS at {self._addr} unreachable after "
                f"{self._timeout:.0f}s: {e.__cause__}") from e.__cause__
        self._sock.sendall(ps_token() + self._cid)
        if self._rank is not None:
            # (re)announce this rank; a reconnect is a recovery — the
            # server refreshes liveness and, if the cid changed (process
            # restart), re-syncs barrier/dedup state (ref is_recovery)
            self._seq += 1
            _send_msg(self._sock,
                      (self._seq, ("register", self._rank,
                                   self._ever_connected)))
            _recv_msg(self._sock)
        self._ever_connected = True

    def _hb_loop(self):
        """Periodic liveness beacon feeding the server's last-seen map.
        Failures are swallowed: a down server is the *real* calls'
        problem to surface; heartbeats just go quiet (which is exactly
        what marks this rank dead on the server)."""
        while not self._hb_stop.wait(_hb_interval()):
            try:
                self._call("hb", _retry=False)
            except Exception:
                pass

    def _call(self, *msg, _retry: bool = True):
        with self._lock:
            self._seq += 1
            frame = (self._seq, msg)
            try:
                if _retry and chaos.should_fail("ps.drop"):
                    # injected disconnect: tear the socket down before
                    # the frame is sent so the resend path must recover
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    raise ConnectionError("chaos: injected ps.drop")
                _send_msg(self._sock, frame)
                return _recv_msg(self._sock)
            except (ConnectionError, OSError, EOFError):
                if not _retry:
                    raise
                # server restarted (ref ps-lite recovery: workers survive
                # a server bounce and resend) — reconnect and resend
                # through the shared Retry policy: MXTPU_PS_CALL_RETRIES
                # attempts with capped, seeded-jitter backoff, so a
                # server bounce during an elastic resize doesn't fail the
                # survivor that notices first (the old path retried
                # exactly once, bare). The (client_id, seq) pair lets the
                # server answer an already-applied push from cache
                # instead of applying the gradient twice; state recovery
                # is the server owner's concern.
                def _resend():
                    try:
                        self._sock.close()   # drop a half-dead socket
                    except OSError:
                        pass
                    try:
                        self._connect()
                    except PSUnreachableError as ce:
                        # _connect already retried for the FULL
                        # MXTPU_PS_CONNECT_TIMEOUT patience window; the
                        # server is gone, not bouncing — more resend
                        # attempts would just multiply that window
                        raise _ServerGone(str(ce)) from ce
                    _send_msg(self._sock, frame)
                    return _recv_msg(self._sock)

                retry = Retry(max_attempts=_call_retries(),
                              base=0.05, cap=2.0)
                try:
                    return retry.call(
                        _resend,
                        retry_on=(ConnectionError, OSError, EOFError))
                except _ServerGone as e:
                    raise ConnectionError(
                        f"async PS call {msg[0]!r} failed: {e}"
                    ) from e.__cause__
                except chaos.RetryError as e:
                    raise ConnectionError(
                        f"async PS call {msg[0]!r} failed after "
                        f"{_call_retries()} reconnect attempt(s): "
                        f"{e.__cause__}") from e.__cause__

    def init(self, key, val: np.ndarray):
        self._call("init", key, np.asarray(val))

    def push(self, key, grad: np.ndarray):
        self._call("push", key, np.asarray(grad))

    def pull(self, key) -> Optional[np.ndarray]:
        return self._call("pull", key)[1]

    def push_count(self, key) -> int:
        return self._call("push_count", key)[1]

    def set_optimizer(self, optimizer_bytes: bytes):
        self._call("set_optimizer", optimizer_bytes)

    def command(self, head: int, body: str):
        """Server-side profiler command (ref: kvstore.h
        SendCommandToServers). Raises on a server-side error reply."""
        reply = self._call("command", int(head), str(body))
        if reply[0] != "ok":
            raise RuntimeError(f"server command ({head}, {body!r}) "
                               f"failed: {reply[1:]}")

    def dead_nodes(self) -> List[int]:
        """Ranks the server currently considers dead (silent past
        MXTPU_PS_DEAD_TIMEOUT)."""
        return self._call("dead_nodes")[1]

    def num_dead_node(self) -> int:
        """(ref: kvstore.h:353 get_num_dead_node)"""
        return len(self.dead_nodes())

    def group_view(self) -> Tuple[int, Tuple[int, ...]]:
        """The server's current (epoch, live ranks) group view. The epoch
        bumps on every membership change (death / join / clean stop) —
        elastic controllers poll this at step boundaries and resize when
        it moves."""
        epoch, ranks = self._call("view")[1]
        return int(epoch), tuple(int(r) for r in ranks)

    def view_barrier(self, ranks=None):
        """Rendezvous over ``ranks`` (default: the live group view at
        first entry) — the elastic quiesce barrier. The target only
        shrinks while waiting: a rank that dies is dropped and the
        barrier completes without it; a rank that joins does not grow
        it. Raises TimeoutError naming the target ranks that never
        arrived."""
        if ranks is None:
            reply = self._call("view_barrier")
        else:
            reply = self._call("view_barrier",
                               sorted(int(r) for r in ranks))
        if reply and reply[0] == "barrier_timeout":
            raise TimeoutError(
                f"elastic quiesce barrier timed out after {reply[1]:.0f}s "
                f"(tune MXTPU_PS_BARRIER_TIMEOUT); view ranks that never "
                f"arrived: {reply[2]}")
        if reply and reply[0] == "err":
            raise ConnectionError(f"view barrier failed: {reply[1]}")

    def barrier(self):
        reply = self._call("barrier")
        if reply and reply[0] == "barrier_timeout":
            raise TimeoutError(
                f"async PS barrier timed out after {reply[1]:.0f}s "
                f"(tune MXTPU_PS_BARRIER_TIMEOUT); ranks that never "
                f"arrived: {reply[2]}")
        if reply and reply[0] == "err":
            raise ConnectionError(f"async PS barrier failed: {reply[1]}")

    def close(self):
        # never reconnect-retry on shutdown: when rank 0's server is
        # already gone (normal job end), a retrying "stop" would block a
        # full connect-timeout per worker. The stop handshake is also
        # TIME-BOUNDED: close() commonly runs from KVStore.__del__ at
        # interpreter shutdown, when the server's daemon handler threads
        # may already be unschedulable (rank 0 hosts the server in the
        # SAME dying process) — an unbounded _recv_msg there wedges the
        # process forever with the reply never coming, which is exactly
        # how test_dist_async_staleness_no_lockstep used to "time out"
        # AFTER both ranks had already passed their assertions
        # (faulthandler-diagnosed). The reply is best-effort;
        # the sent "stop" frame alone is enough for a live server.
        self._hb_stop.set()
        try:
            self._sock.settimeout(5.0)
        except OSError:
            pass
        # acquire with a timeout: a heartbeat _call can be holding the
        # lock while blocked in an unbounded recv on the dead server
        # (settimeout above does not interrupt a recv already in
        # progress) — waiting on the lock unboundedly would recreate the
        # shutdown wedge via the hb path. On timeout we skip the stop
        # handshake and tear the socket down; shutdown() (NOT just
        # close(), which cannot interrupt a recv pinned by another
        # thread's in-flight syscall) unblocks the stuck heartbeat recv
        # with an error it swallows.
        got = self._lock.acquire(timeout=6.0)
        if got:
            try:
                self._seq += 1
                _send_msg(self._sock, (self._seq, ("stop",)))
                _recv_msg(self._sock)
            except (ConnectionError, OSError, EOFError):
                pass
            finally:
                self._lock.release()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
