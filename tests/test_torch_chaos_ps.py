"""The port's async parameter server (``_ps.py``): liveness, rejoin and
barrier timeouts, on the CPU.

The cases mirror the reference's ``tests/test_chaos_ps.py`` (its non-slow
ones) with the reference's fast-liveness settings (heartbeat 0.2 s, dead
after 0.8 s, barriers 5 s unless a case sets its own): a rank that dies is
reported dead and clears on rejoin, a clean stop is not a death, an
injected server-side push failure and injected client disconnects apply
each push exactly once (the resend dedup), a barrier timeout names the
missing ranks and leaves the next barrier whole, and a rank that dies
inside a barrier leaves no stale entry. Then the chaos-injected pushes of
one seeded plan against the JAX package's server: the same values pulled,
the same push counts.
"""
import threading
import time

import numpy as np
import pytest

from incubator_mxnet_tpu_torch import _ps, chaos

pytestmark = pytest.mark.chaos


@pytest.fixture()
def fast_liveness(monkeypatch):
    monkeypatch.setenv("MXTPU_PS_HEARTBEAT", "0.2")
    monkeypatch.setenv("MXTPU_PS_DEAD_TIMEOUT", "0.8")
    monkeypatch.setenv("MXTPU_PS_BARRIER_TIMEOUT", "5")


def _server(num_workers):
    srv = _ps.AsyncPSServer("127.0.0.1:0", num_workers)
    return srv, f"127.0.0.1:{srv._sock.getsockname()[1]}"


def test_heartbeat_liveness_and_rejoin(fast_liveness):
    srv, addr = _server(2)
    c0 = _ps.AsyncPSClient(addr, rank=0)
    c1 = _ps.AsyncPSClient(addr, rank=1)
    try:
        assert c0.num_dead_node() == 0
        # rank 1 dies without a goodbye: heartbeats stop, socket drops
        c1._hb_stop.set()
        c1._sock.close()
        deadline = time.monotonic() + 10
        while c0.dead_nodes() != [1]:
            assert time.monotonic() < deadline, c0.dead_nodes()
            time.sleep(0.1)
        # a restarted incarnation rejoins under the same rank
        c1b = _ps.AsyncPSClient(addr, rank=1)
        deadline = time.monotonic() + 10
        while c0.num_dead_node() != 0:
            assert time.monotonic() < deadline, c0.dead_nodes()
            time.sleep(0.1)
        c1b.close()
    finally:
        c0.close()
        srv.close()


def test_clean_stop_is_not_a_death(fast_liveness):
    srv, addr = _server(2)
    c0 = _ps.AsyncPSClient(addr, rank=0)
    c1 = _ps.AsyncPSClient(addr, rank=1)
    try:
        c1.close()                      # polite goodbye deregisters
        time.sleep(1.0)
        assert c0.dead_nodes() == []
    finally:
        c0.close()
        srv.close()


def test_server_side_push_chaos_applies_exactly_once(fast_liveness):
    srv, addr = _server(1)
    c = _ps.AsyncPSClient(addr, rank=0)
    try:
        c.init("w", np.zeros(3, np.float32))
        chaos.arm("ps.push", prob=1.0, times=1)
        c.push("w", np.ones(3, np.float32))   # first try crashes server-side
        assert c.push_count("w") == 1
        np.testing.assert_allclose(c.pull("w"), np.ones(3))
    finally:
        c.close()
        srv.close()


def test_client_disconnect_chaos_dedups_resend(fast_liveness):
    srv, addr = _server(1)
    c = _ps.AsyncPSClient(addr, rank=0)
    try:
        c.init("w", np.zeros(3, np.float32))
        chaos.arm("ps.drop", prob=0.5, seed=3)
        for i in range(20):
            c.push("w", np.full(3, float(i), np.float32))
        evals, fired = chaos.stats("ps.drop")
        chaos.disarm("ps.drop")
        assert fired > 0                       # the fault plan did fire
        assert c.push_count("w") == 20         # ...but applied exactly once
        np.testing.assert_allclose(c.pull("w"), np.full(3, 19.0))
    finally:
        c.close()
        srv.close()


def test_barrier_timeout_names_missing_ranks(fast_liveness, monkeypatch):
    monkeypatch.setenv("MXTPU_PS_BARRIER_TIMEOUT", "1.0")
    srv, addr = _server(3)
    c0 = _ps.AsyncPSClient(addr, rank=0)
    c1 = _ps.AsyncPSClient(addr, rank=1)
    try:
        with pytest.raises(TimeoutError) as ei:
            c0.barrier()
        msg = str(ei.value)
        assert "MXTPU_PS_BARRIER_TIMEOUT" in msg
        assert "[1, 2]" in msg or "[2]" in msg  # rank 1 may not have entered
        # the withdrawn entry must not poison the next, complete barrier
        monkeypatch.setenv("MXTPU_PS_BARRIER_TIMEOUT", "30")
        c2 = _ps.AsyncPSClient(addr, rank=2)
        done = []
        ts = [threading.Thread(target=lambda c=c: done.append(c.barrier()))
              for c in (c1, c2)]
        for t in ts:
            t.start()
        c0.barrier()
        for t in ts:
            t.join(10)
        assert not any(t.is_alive() for t in ts)
        c2.close()
    finally:
        c0.close()
        c1.close()
        srv.close()


def test_dead_worker_rejoin_resyncs_barrier(fast_liveness, monkeypatch):
    """A worker that died INSIDE a barrier must not leave a stale entry:
    its restarted incarnation re-enters and the barrier completes with
    exactly num_workers arrivals (ref is_recovery rejoin)."""
    monkeypatch.setenv("MXTPU_PS_BARRIER_TIMEOUT", "30")
    srv, addr = _server(2)
    c0 = _ps.AsyncPSClient(addr, rank=0)
    c1 = _ps.AsyncPSClient(addr, rank=1)
    try:
        t = threading.Thread(target=lambda: _swallow(c1.barrier))
        t.start()
        deadline = time.monotonic() + 10    # wait for rank 1 to be counted
        while not srv._barrier_entered:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        c1._hb_stop.set()
        c1._sock.close()                    # rank 1 dies mid-barrier
        # restarted incarnation: register withdraws the stale entry.
        # Bounded POLL, not an instant assert: the dead incarnation's
        # barrier thread is concurrently retrying (reconnect + register
        # + resend on the old cid, serialized behind the server's
        # cid_lock), so under suite load the count can transiently read
        # stale between those threads — the contract is that it SETTLES
        # at 0, which this pins without the load-sensitive race (the
        # flake once observed under a loaded parallel run).
        c1b = _ps.AsyncPSClient(addr, rank=1)
        deadline = time.monotonic() + 10
        while True:
            with srv._barrier_cond:
                if srv._barrier_count == 0:
                    break
            assert time.monotonic() < deadline, \
                "stale barrier entry survived"
            time.sleep(0.05)
        # ...and a fresh 2-party barrier completes
        done = []
        t2 = threading.Thread(target=lambda: done.append(c1b.barrier()))
        t2.start()
        c0.barrier()
        t2.join(10)
        assert not t2.is_alive()
        t.join(5)    # the dead incarnation's thread unblocks via dedup
        c1b.close()
    finally:
        c0.close()
        srv.close()


def test_zombie_barrier_waiter_timeout_after_rejoin(fast_liveness,
                                                    monkeypatch):
    """A dead rank's zombie barrier handler times out AFTER the rejoin
    already withdrew its entry; it must not decrement the count a second
    time (that corrupts the count and wedges every later barrier)."""
    monkeypatch.setenv("MXTPU_PS_BARRIER_TIMEOUT", "2")
    srv, addr = _server(2)
    c0 = _ps.AsyncPSClient(addr, rank=0)
    c1 = _ps.AsyncPSClient(addr, rank=1)
    try:
        t = threading.Thread(target=lambda: _swallow(c1.barrier))
        t.start()
        deadline = time.monotonic() + 10
        while not srv._barrier_entered:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        c1._hb_stop.set()
        c1._sock.close()                     # dies mid-barrier
        c1b = _ps.AsyncPSClient(addr, rank=1)   # rejoin withdraws entry
        time.sleep(3.0)                      # let the zombie waiter expire
        with srv._barrier_cond:
            assert srv._barrier_count == 0, "double-withdrawn barrier count"
        done = []
        t2 = threading.Thread(target=lambda: done.append(c1b.barrier()))
        t2.start()
        c0.barrier()                         # completes with exactly 2
        t2.join(10)
        assert not t2.is_alive()
        t.join(5)
        c1b.close()
    finally:
        c0.close()
        srv.close()


def _swallow(fn):
    try:
        fn()
    except Exception:
        pass


def test_seeded_drop_plan_matches_jax_server(fast_liveness):
    """One seeded ``ps.drop`` plan on the port's server and on the JAX
    package's: the same pulls and push counts (each push applied once)."""
    from incubator_mxnet_tpu import _ps as jps
    from incubator_mxnet_tpu import chaos as jchaos
    out = {}
    for name, ps, ch in (("port", _ps, chaos), ("jax", jps, jchaos)):
        srv = ps.AsyncPSServer("127.0.0.1:0", 1)
        c = ps.AsyncPSClient(f"127.0.0.1:{srv._sock.getsockname()[1]}",
                             rank=0)
        try:
            c.init("w", np.zeros(3, np.float32))
            ch.arm("ps.drop", prob=0.5, seed=5)
            for i in range(10):
                c.push("w", np.full(3, float(i), np.float32))
            fired = ch.stats("ps.drop")[1]
            ch.disarm("ps.drop")
            out[name] = (fired, c.push_count("w"), c.pull("w"))
        finally:
            c.close()
            srv.close()
    assert out["port"][0] == out["jax"][0] > 0
    assert out["port"][1] == out["jax"][1] == 10
    np.testing.assert_array_equal(out["port"][2], out["jax"][2])
