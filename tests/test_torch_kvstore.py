"""The port's stores (``kvstore.py``, ``_ps.py``, ``kvstore_server.py``) and
``Trainer``'s distributed paths, on the CPU.

The cases mirror the reference's ``tests/test_kvstore_compression.py``,
``tests/test_dist_async.py`` (its non-slow cases) and
``test_sparse_profiler_dist.py::test_dist_kvstore_multiprocess``, holding
the port against the JAX package where both compute a value: 2-bit
compression's emissions and residuals bit for bit; the async server's
apply-on-push and row-sparse round trip exactly. The distributed cases run
the port alone: 2 processes through the port's ``tools.launch`` (its
environment; the store joins a gloo world), and a 2-rank gloo world
(``parallel.world.LocalWorld``, rank bodies in ``_torch_embed_ranks.py``)
where ``Trainer(kvstore="dist_sync")`` steps (with and without
``update_on_kvstore``) each rank's half of a batch and must equal one
process stepping the whole batch within 1e-6. The server's profiler
commands name ROADMAP.md A11.
"""
import os
import socket
import struct
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import _ps, nd
from incubator_mxnet_tpu_torch.kvstore import _GradientCompression
from incubator_mxnet_tpu_torch.ndarray import sparse as sp
from incubator_mxnet_tpu_torch.optimizer import SGD

import _torch_embed_ranks as R

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu():
    with mx.cpu():
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = R.World(2, tmp_path_factory.mktemp("kv_world"))
    yield w
    w.close()


# ------------------------------------------------- 2-bit compression
def test_two_bit_levels():
    from incubator_mxnet_tpu.kvstore import _GradientCompression as JGC
    g = np.linspace(-2, 2, 41).astype(np.float32)
    q = _GradientCompression(threshold=0.5).compress("k", nd.array(g))
    jq = JGC(threshold=0.5).compress("k", jmx.nd.array(g))
    q = q.asnumpy()
    np.testing.assert_array_equal(q, jq.asnumpy())
    assert set(np.unique(q)).issubset({-0.5, 0.0, 0.5})
    assert q[0] == -0.5 and q[-1] == 0.5 and q[20] == 0.0


def test_error_feedback_residual_accumulates():
    from incubator_mxnet_tpu.kvstore import _GradientCompression as JGC
    gc, jgc = _GradientCompression(0.5), JGC(0.5)
    total = np.zeros((4,), np.float32)
    for _ in range(25):
        q = gc.compress("k", nd.array(np.full((4,), 0.2, np.float32)))
        jq = jgc.compress("k", jmx.nd.array(np.full((4,), 0.2, np.float32)))
        np.testing.assert_array_equal(q.asnumpy(), jq.asnumpy())
        total += q.asnumpy()
    np.testing.assert_allclose(total, 5.0, atol=0.5)
    np.testing.assert_array_equal(gc._residual["k"].numpy(),
                                  np.asarray(jgc._residual["k"]))


def test_kvstore_push_applies_compression():
    kv = mx.kvstore.create("local")
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    seen = []
    kv._updater = lambda k, g, w: (seen.append(g.asnumpy().copy()),
                                   w._set_data(w._data - g._data))[0]
    kv.init("w", nd.zeros((4,)))
    for _ in range(25):
        kv.push("w", nd.array(np.full((4,), 0.2, np.float32)))
    out = nd.zeros((4,))
    kv.pull("w", out=out)
    for g in seen:
        assert set(np.unique(g)).issubset({-0.5, 0.0, 0.5}), g
    np.testing.assert_allclose(out.asnumpy(), -5.0, atol=0.5)


def test_compression_rejects_unknown_type():
    kv = mx.kvstore.create("local")
    with pytest.raises(ValueError):
        kv.set_gradient_compression({"type": "1bit"})


@pytest.mark.parametrize("name", ["local", "local_allreduce_cpu",
                                  "local_allreduce_device", "device", "nccl",
                                  "dist_sync", "dist_device_sync",
                                  "dist_async", "dist"])
def test_create_every_type(name):
    """Every type ``create`` takes makes a working store in one process
    (the ``dist`` types with a world of one): push a list of two, pull the
    sum, as the JAX package's."""
    kv = mx.kvstore.create(name.upper() if name == "dist" else name)
    assert kv.type == name and kv.rank == 0 and kv.num_workers == 1
    kv.init(3, nd.zeros((2, 2)))
    kv.push(3, [nd.ones((2, 2)), nd.ones((2, 2)) * 2])
    out = nd.zeros((2, 2))
    kv.pull(3, out=out)
    np.testing.assert_array_equal(out.asnumpy(), 3.0)
    kv.barrier()
    assert kv.group_view() == (0, (0,)) or kv.group_view()[1] == (0,)
    assert len(kv.telemetry_allgather()) == 1
    kv.close()
    with pytest.raises(ValueError):
        mx.kvstore.create("ring")


# -------------------------------------------------------- async PS
def test_async_apply_on_push_single_process():
    """No updater: the stored value becomes the push; with an optimizer,
    applied on push (as the JAX package's server)."""
    out = {}
    for name, pkg in (("port", mx), ("jax", jmx)):
        kv = pkg.kvstore.create("dist_async")
        kv.init("w", pkg.nd.array(np.zeros(4, np.float32)))
        kv.push("w", pkg.nd.array(np.ones(4, np.float32)))
        o = pkg.nd.array(np.zeros(4, np.float32))
        kv.pull("w", out=o)
        first = o.asnumpy().copy()
        kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.5,
                                           rescale_grad=1.0, wd=0.0))
        kv.push("w", pkg.nd.array(np.ones(4, np.float32)))
        kv.pull("w", out=o)
        out[name] = (first, o.asnumpy().copy())
        kv.close()
    np.testing.assert_allclose(out["port"][0], 1.0)
    np.testing.assert_allclose(out["port"][1], 0.5)
    for a, b in zip(out["port"], out["jax"]):
        np.testing.assert_array_equal(a, b)


def test_ps_handshake_chunked_token():
    server = _ps.AsyncPSServer("127.0.0.1:0", 1)
    port = server._sock.getsockname()[1]
    server._store["w"] = np.ones(3, np.float32)
    try:
        hello = _ps.ps_token() + b"\x01" * 16
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        s.sendall(hello[:7])
        time.sleep(0.05)
        s.sendall(hello[7:20])
        time.sleep(0.05)
        s.sendall(hello[20:])
        _ps._send_msg(s, (1, ("pull", "w")))
        kind, val = _ps._recv_msg(s)
        assert kind == "val"
        np.testing.assert_allclose(val, 1.0)
        s.close()
    finally:
        server.close()


def test_ps_resend_dedup():
    server = _ps.AsyncPSServer("127.0.0.1:0", 1)
    port = server._sock.getsockname()[1]
    try:
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        s.sendall(_ps.ps_token() + b"\x02" * 16)
        _ps._send_msg(s, (1, ("init", "w", np.zeros(2, np.float32))))
        assert _ps._recv_msg(s)[0] == "ok"
        grad = np.ones(2, np.float32)
        _ps._send_msg(s, (2, ("push", "w", grad)))
        assert _ps._recv_msg(s)[0] == "ok"
        _ps._send_msg(s, (2, ("push", "w", grad)))   # the retry
        assert _ps._recv_msg(s)[0] == "ok"
        _ps._send_msg(s, (3, ("pull", "w")))
        _, val = _ps._recv_msg(s)
        np.testing.assert_allclose(val, 1.0)          # applied once
        s.close()
    finally:
        server.close()


def test_ps_frame_length_capped(monkeypatch):
    monkeypatch.setenv("MXTPU_PS_MAX_FRAME", "1024")
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack("!Q", 1 << 40))
        with pytest.raises(ConnectionError, match="exceeds"):
            _ps._recv_msg(b)
    finally:
        a.close()
        b.close()


def test_ps_token_required_offhost(monkeypatch):
    from incubator_mxnet_tpu import _ps as jps
    monkeypatch.delenv("MXTPU_PS_TOKEN", raising=False)
    monkeypatch.setenv("MXTPU_COORDINATOR", "10.0.0.5:49875")
    with pytest.raises(RuntimeError, match="MXTPU_PS_TOKEN"):
        _ps.ps_token()
    monkeypatch.setenv("MXTPU_PS_TOKEN", "job-secret")
    assert _ps.ps_token() == jps.ps_token() and len(_ps.ps_token()) == 32


def test_ps_client_survives_server_restart():
    server = _ps.AsyncPSServer("127.0.0.1:0", 1)
    port = server._sock.getsockname()[1]
    client = _ps.AsyncPSClient(f"127.0.0.1:{port}")
    client.init("w", np.zeros(4, np.float32))
    client.push("w", np.ones(4, np.float32))
    np.testing.assert_allclose(client.pull("w"), 1.0)
    server.close()
    server2 = _ps.AsyncPSServer(f"127.0.0.1:{port}", 1)
    try:
        client.push("w", np.full(4, 3.0, np.float32))
        np.testing.assert_allclose(client.pull("w"), 3.0)
    finally:
        client.close()
        server2.close()


def test_async_row_sparse_roundtrip():
    """Sparse keys live dense on the server; ``row_sparse_pull``
    re-sparsifies; the SGD push applies on the pushed row only (as the JAX
    package's)."""
    dense0 = np.arange(12, dtype=np.float32).reshape(4, 3)
    grad = np.zeros((4, 3), np.float32)
    grad[1] = 1.0
    kv = mx.kvstore.create("dist_async")
    kv.init("w", sp.cast_storage(nd.array(dense0), "row_sparse"))
    kv.set_optimizer(SGD(learning_rate=1.0, rescale_grad=1.0, wd=0.0))
    kv.push("w", sp.cast_storage(nd.array(grad), "row_sparse"))
    out = nd.array(np.zeros((4, 3), np.float32))
    kv.row_sparse_pull("w", out=out, row_ids=nd.array(
        np.arange(4, dtype=np.float32)))
    expect = dense0.copy()
    expect[1] -= 1.0
    np.testing.assert_allclose(out.asnumpy(), expect)
    kv.close()


def test_server_profiler_command_names_a11():
    """The server's profiler commands (heads 0..3) need profiler.py
    (ROADMAP.md A11): each answers with an error that raises; an unknown
    head raises too; the store stays usable."""
    server = _ps.AsyncPSServer("127.0.0.1:0", 1)
    port = server._sock.getsockname()[1]
    try:
        client = _ps.AsyncPSClient(f"127.0.0.1:{port}")
        for head, body in ((0, "filename=x.json,aggregate_stats=0"),
                           (1, "run"), (2, ""), (3, "")):
            with pytest.raises(RuntimeError, match="A11"):
                client.command(head, body)
        with pytest.raises(RuntimeError, match="unknown command head"):
            client.command(99, "")
        client.init("w", np.zeros(4, np.float32))
        client.push("w", np.ones(4, np.float32))
        np.testing.assert_allclose(client.pull("w"), 1.0)
        client.close()
    finally:
        server.close()
    assert _ps._parse_profiler_config("filename=a.json,aggregate_stats=0,"
                                      "x=12") == {
        "filename": "a.json", "aggregate_stats": False, "x": 12}


# ------------------------------------------------- across processes
def test_dist_kvstore_multiprocess(tmp_path):
    """2 workers through the port's launcher (``tools.launch``): each pushes
    rank + 1, both pull the cross-process sum; the telemetry allgather
    returns both ranks' snapshots."""
    worker = tmp_path / "worker.py"
    worker.write_text(textwrap.dedent("""
        import os, sys
        sys.path.insert(0, %r)
        import numpy as np
        import incubator_mxnet_tpu_torch as mx
        from incubator_mxnet_tpu_torch import nd

        with mx.cpu():
            kv = mx.kvstore.create("dist_sync")
            rank, n = kv.rank, kv.num_workers
            assert n == 2, n
            kv.init("w", nd.zeros((4,)))
            kv.push("w", nd.ones((4,)) * (rank + 1))
            kv.barrier()
            out = nd.zeros((4,))
            kv.pull("w", out=out)
            np.testing.assert_allclose(out.asnumpy(), 3.0)
            assert len(kv.telemetry_allgather()) == 2
            open(os.path.join(%r, f"ok_{rank}"), "w").write("1")
    """) % (REPO, str(tmp_path)))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    try:
        r = subprocess.run(
            [sys.executable, "-m", "incubator_mxnet_tpu_torch.tools.launch",
             "-n", "2", "--coordinator", f"127.0.0.1:{port}",
             sys.executable, str(worker)],
            capture_output=True, timeout=240, env=env, cwd=REPO)
    except subprocess.TimeoutExpired as e:
        raise AssertionError(f"dist workers wedged; stderr tail: "
                             f"{(e.stderr or b'').decode()[-2000:]}")
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert (tmp_path / "ok_0").exists() and (tmp_path / "ok_1").exists()


def _dense_problem():
    rs = np.random.RandomState(4)
    return (rs.randn(4, 6).astype(np.float32),
            rs.randn(4).astype(np.float32),
            rs.randn(8, 6).astype(np.float32),
            rs.randn(8, 4).astype(np.float32))


def _one_process(w, b, x, y, lr, kvstore="device", update_on_kvstore=None):
    from incubator_mxnet_tpu_torch import autograd, gluon
    with mx.name.NameManager():
        net = gluon.nn.Dense(4, in_units=6)
    net.initialize()
    net.weight.set_data(nd.array(w))
    net.bias.set_data(nd.array(b))
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": lr, "momentum": 0.9},
                       kvstore=kvstore, update_on_kvstore=update_on_kvstore)
    for _ in range(2):
        with autograd.record():
            loss = ((net(nd.array(x)) - nd.array(y)) ** 2).sum()
        loss.backward()
        tr.step(x.shape[0])
    out = net.weight.data().asnumpy(), net.bias.data().asnumpy(), tr
    return out


@pytest.mark.parametrize("update_on_kvstore", [None, False, True])
def test_trainer_dist_sync_matches_one_process(update_on_kvstore, world):
    """``Trainer(kvstore="dist_sync")`` on 2 ranks, each stepping half of
    the batch (2 steps, SGD momentum 0.9), equals one process stepping the
    whole batch (within 1e-6): by default and with ``update_on_kvstore``
    the update runs on the store (a push and a pull a parameter), without
    it the fused step after one all-reduce of the gradients."""
    w, b, x, y = _dense_problem()
    res = world.run(R.trainer_dist_step, "dist_sync", w, b, x, y, 0.01,
                    update_on_kvstore)
    want_w, want_b, _ = _one_process(w, b, x, y, 0.01)
    for got_w, got_b, uok, rank, n in res:
        assert n == 2 and uok == (update_on_kvstore is not False)
        np.testing.assert_allclose(got_w, want_w, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_b, want_b, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(res[0][0], res[1][0])
    sums = world.run(R.kv_push_pull, "dist_sync")
    for out, snaps in sums:
        np.testing.assert_array_equal(out, 3.0)
        assert snaps == 2


@pytest.mark.parametrize("kvstore,compression", [
    ("dist_async", None), ("local", {"type": "2bit", "threshold": 1e-3})])
def test_trainer_store_paths_one_process(kvstore, compression):
    """One process: ``dist_async`` (the update applied on the rank-0
    server) equals the local step within 1e-6; 2-bit compression
    (``compression_params``, a store made for it) equals the JAX package's
    Trainer within 1e-6."""
    from incubator_mxnet_tpu_torch import autograd, gluon
    w, b, x, y = _dense_problem()
    with mx.name.NameManager():
        net = gluon.nn.Dense(4, in_units=6)
    net.initialize()
    net.weight.set_data(nd.array(w))
    net.bias.set_data(nd.array(b))
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.01},
                       kvstore=kvstore, compression_params=compression)
    with autograd.record():
        loss = ((net(nd.array(x)) - nd.array(y)) ** 2).sum()
    loss.backward()
    tr.step(x.shape[0])
    got = net.weight.data().asnumpy()
    if compression is None:
        assert tr._update_on_kvstore and tr._kvstore._is_async
        np.testing.assert_allclose(got, _one_step(w, b, x, y), rtol=1e-6,
                                   atol=1e-6)
        tr._kvstore.close()
    else:
        with jmx.name.NameManager():
            jnet = jmx.gluon.nn.Dense(4, in_units=6)
        jnet.initialize()
        jnet.weight.set_data(jmx.nd.array(w))
        jnet.bias.set_data(jmx.nd.array(b))
        jtr = jmx.gluon.Trainer(jnet.collect_params(), "sgd",
                                {"learning_rate": 0.01}, kvstore=kvstore,
                                compression_params=compression)
        with jmx.autograd.record():
            jl = ((jnet(jmx.nd.array(x)) - jmx.nd.array(y)) ** 2).sum()
        jl.backward()
        jtr.step(x.shape[0])
        np.testing.assert_allclose(got, jnet.weight.data().asnumpy(),
                                   rtol=1e-6, atol=1e-6)


def _one_step(w, b, x, y):
    from incubator_mxnet_tpu_torch import autograd, gluon
    with mx.name.NameManager():
        net = gluon.nn.Dense(4, in_units=6)
    net.initialize()
    net.weight.set_data(nd.array(w))
    net.bias.set_data(nd.array(b))
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.01})
    with autograd.record():
        loss = ((net(nd.array(x)) - nd.array(y)) ** 2).sum()
    loss.backward()
    tr.step(x.shape[0])
    return net.weight.data().asnumpy()


def test_kvstore_server_role_and_optimizer_pickle():
    """``KVStoreServer`` applies an optimizer command; the port's optimizer
    pickles (what ``set_optimizer`` ships to the async server)."""
    import pickle
    from incubator_mxnet_tpu_torch import kvstore_server
    from incubator_mxnet_tpu_torch.optimizer import create
    kv = mx.kvstore.create("local")
    opt = create("adam", learning_rate=0.02)
    kvstore_server.KVStoreServer(kv)._controller()(0, pickle.dumps(opt))
    assert kv.updater is not None
    assert kv.updater.optimizer.lr == pytest.approx(0.02)
    kvstore_server.KVStoreServer(kv).run()      # a world of one: no wait
