"""The port's small modules of this slice on the CPU, against the JAX
package on the same numpy inputs: ``util``, ``log``, ``misc``,
``libinfo``; ``gluon.contrib.nn`` (``Concurrent``, ``HybridConcurrent``,
``Identity``, ``SparseEmbedding``, ``SyncBatchNorm``, ``PixelShuffle2D``);
``gluon.contrib.rnn`` (``VariationalDropoutCell``, ``LSTMPCell`` and the
nine convolutional cells, weights carried across, forward and gradients
within 1e-5); ``contrib.autograd``, ``contrib.io.DataLoaderIter``,
``contrib.ndarray`` and ``contrib.tensorboard.LogMetricsCallback``."""
import json
import logging
from collections import namedtuple

import jax
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.gluon import contrib as jcontrib
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.gluon import contrib as tcontrib
from incubator_mxnet_tpu_torch.ndarray import sparse as tsp

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu(), jax.default_matmul_precision("highest"):
        yield


def _rand(seed, *shape):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _carry(jblock, tblock):
    """The reference block's initialized weights into the port's, by
    order."""
    jp = list(jblock.collect_params().values())
    tp = list(tblock.collect_params().values())
    assert [p.shape for p in jp] == [p.shape for p in tp]
    for a, b in zip(jp, tp):
        b.set_data(tmx.nd.array(a.data().asnumpy()))


def _run(mx, block, inputs, record=True):
    """block(*inputs) under autograd with every input's gradient: (output
    arrays, input gradients, parameter gradients)."""
    xs = [mx.nd.array(x) for x in inputs]
    for x in xs:
        x.attach_grad()
    with mx.autograd.record(train_mode=record):
        out = block(*xs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        flat = []
        for o in outs:
            flat += o if isinstance(o, list) else [o]
        # a fixed random head, so that no gradient is zero by symmetry
        loss = sum((o * o * mx.nd.array(np.random.RandomState(99).uniform(
            0.5, 1.5, o.shape).astype(np.float32))).sum() for o in flat)
    loss.backward()
    params = [p.grad().asnumpy() for p in block.collect_params().values()
              if p.grad_req != "null"]
    return ([o.asnumpy() for o in flat], [x.grad.asnumpy() for x in xs],
            params)


def _same(t, j, tol=TOL):
    for a, b in zip(t, j):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, **tol)


# ------------------------------------------------------ small modules
def test_util_log_misc_libinfo(tmp_path):
    from incubator_mxnet_tpu import libinfo as jlib
    d = tmp_path / "a" / "b"
    tmx.util.makedirs(str(d))
    assert d.is_dir()
    tmx.util.makedirs(str(d))

    @tmx.util.use_np_shape
    def f(x):
        return x + 1
    assert f(1) == 2 and f.__name__ == "f"
    assert not hasattr(tmx.util, "parse_xla_opts")
    log = tmx.log.get_logger("port_extras", level=tmx.log.INFO)
    assert log.level == logging.INFO and tmx.log.getLogger("port_extras") \
        is log
    fmt = tmx.log._Formatter()
    rec = logging.LogRecord("x", logging.WARNING, "p.py", 3, "hi", (), None)
    assert "hi" in fmt.format(rec) and fmt.format(rec).startswith("\x1b[31mW")
    sched = tmx.misc.FactorScheduler(step=2, factor=0.5)
    jsched = jmx.misc.FactorScheduler(step=2, factor=0.5)
    sched.base_lr = jsched.base_lr = 1.0
    assert [sched(n) for n in range(1, 8)] == [jsched(n)
                                               for n in range(1, 8)]
    assert issubclass(tmx.misc.LearningRateScheduler,
                      tmx.lr_scheduler.LRScheduler)
    assert tmx.__version__ == jlib.__version__ == "1.5.0"
    feats = tmx.libinfo.features()
    assert set(feats) == {"CUDA", "CUDA_VERSION", "KERNEL_SOURCES",
                          "KERNELS_BUILT", "NATIVE_HOST_RUNTIME", "INT8",
                          "DIST"}
    assert "multi_tensor.cu" in feats["KERNEL_SOURCES"]
    assert not any("XLA" in k or "TPU" in k or "PALLAS" in k for k in feats)
    assert all(p.endswith("libmxtpu.so")
               for p in tmx.libinfo.find_lib_path())


# ------------------------------------------------------ gluon.contrib.nn
@pytest.mark.parametrize("hybrid", [False, True])
def test_concurrent(hybrid):
    blocks = []
    for g, c in ((jmx.gluon, jcontrib), (tmx.gluon, tcontrib)):
        net = (c.nn.HybridConcurrent if hybrid else c.nn.Concurrent)(axis=1)
        with net.name_scope():
            net.add(g.nn.Dense(3, in_units=4), g.nn.Dense(2, in_units=4),
                    c.nn.Identity())
        net.initialize()
        blocks.append(net)
    _carry(*blocks)
    x = _rand(0, 5, 4)
    _same(_run(tmx, blocks[1], [x]), _run(jmx, blocks[0], [x]))


def test_identity_and_pixel_shuffle():
    x = _rand(1, 2, 12, 3, 5)
    for factor in (2, (3, 2)):
        t = tcontrib.nn.PixelShuffle2D(factor)
        j = jcontrib.nn.PixelShuffle2D(factor)
        _same(_run(tmx, t, [x]), _run(jmx, j, [x]))
    np.testing.assert_array_equal(
        tcontrib.nn.Identity()(tmx.nd.array(x)).asnumpy(), x)


def test_sparse_embedding_row_sparse_gradient():
    ids = np.array([[3, 1], [3, 7]], np.float32)
    t = tcontrib.nn.SparseEmbedding(10, 4)
    j = jcontrib.nn.SparseEmbedding(10, 4)
    for b in (t, j):
        b.initialize()
    _carry(j, t)
    outs = {}
    for tag, mx, b in (("port", tmx, t), ("ref", jmx, j)):
        with mx.autograd.record():
            loss = (b(mx.nd.array(ids)) ** 2).sum()
        loss.backward()
        outs[tag] = b.weight.row_sparse_grad()
    g = outs["port"]
    assert isinstance(g, tsp.RowSparseNDArray)
    np.testing.assert_array_equal(g.indices.numpy(), [1, 3, 7])
    np.testing.assert_allclose(g.asnumpy(), outs["ref"].asnumpy(), **TOL)
    assert "SparseEmbedding(10 -> 4)" == repr(t)


@pytest.mark.parametrize("train", [True, False])
def test_sync_batch_norm_is_the_reference_batch_norm(train):
    t = tcontrib.nn.SyncBatchNorm(in_channels=3, num_devices=1)
    j = jcontrib.nn.SyncBatchNorm(in_channels=3, num_devices=1)
    for b in (t, j):
        b.initialize()
    _carry(j, t)
    x = _rand(2, 4, 3, 5, 5) * 3 + 1
    _same(_run(tmx, t, [x], record=train), _run(jmx, j, [x], record=train))
    for pt, pj in zip(t.collect_params().values(),
                      j.collect_params().values()):
        np.testing.assert_allclose(pt.data().asnumpy(), pj.data().asnumpy(),
                                   **TOL)


# ----------------------------------------------------- gluon.contrib.rnn
CONV_CELLS = [(f"Conv{d}D{kind}Cell", d) for d in (1, 2, 3)
              for kind in ("RNN", "LSTM", "GRU")]


@pytest.mark.parametrize("name,dims", CONV_CELLS,
                         ids=[n for n, _ in CONV_CELLS])
def test_conv_rnn_cells(name, dims):
    spatial = (5, 4, 3)[:dims]
    kw = dict(input_shape=(2,) + spatial, hidden_channels=3, i2h_kernel=3,
              h2h_kernel=3, i2h_pad=1)
    t = getattr(tcontrib.rnn, name)(**kw)
    j = getattr(jcontrib.rnn, name)(**kw)
    for c in (t, j):
        c.initialize()
    x = _rand(3, 2, 4, 2, *spatial)            # (N, T, C, spatial)
    res = {}
    for tag, mx, c in (("ref", jmx, j), ("port", tmx, t)):
        if tag == "port":
            _carry(j, t)

        def unroll(seq, c=c):
            outs, states = c.unroll(4, seq, layout="NTC",
                                    merge_outputs=True)
            return [outs] + list(states)
        res[tag] = _run(mx, _Fn(unroll), [x])
    _same(res["port"][:2], res["ref"][:2])
    pt = [p.grad().asnumpy() for p in t.collect_params().values()]
    pj = [p.grad().asnumpy() for p in j.collect_params().values()]
    _same([pt], [pj])


class _Fn:
    """A callable as a block with no parameters (for :func:`_run`)."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)

    def collect_params(self):
        return {}


def test_lstmp_cell():
    t = tcontrib.rnn.LSTMPCell(6, 3, input_size=4)
    j = jcontrib.rnn.LSTMPCell(6, 3, input_size=4)
    for c in (t, j):
        c.initialize()
    _carry(j, t)
    x = _rand(4, 2, 5, 4)
    res = {}
    for tag, mx, c in (("port", tmx, t), ("ref", jmx, j)):
        res[tag] = _run(mx, _Fn(lambda seq, c=c: list(c.unroll(
            5, seq, layout="NTC", merge_outputs=True)[1]) + [c.unroll(
                5, seq, layout="NTC", merge_outputs=True)[0]]), [x])
    _same(res["port"][:2], res["ref"][:2])
    assert [s["shape"] for s in t.state_info(2)] == [(2, 3), (2, 6)]


def test_variational_dropout_cell_keeps_one_mask_an_unroll():
    """The masks are fixed for every step of an unroll and drawn anew for
    the next (the port's generator is not JAX's: the masks' structure is
    compared, and with p 0 the output equals the base cell's)."""
    base = tmx.gluon.rnn.RNNCell(4, input_size=3)
    cell = tcontrib.rnn.VariationalDropoutCell(base, drop_inputs=0.5,
                                               drop_outputs=0.5)
    cell.initialize()
    x = tmx.nd.array(np.ones((2, 6, 3), np.float32))
    with tmx.autograd.record():
        cell.unroll(6, x, layout="NTC", merge_outputs=True)
        m1 = cell.drop_inputs_mask.asnumpy()
        cell.unroll(6, x, layout="NTC", merge_outputs=True)
        m2 = cell.drop_inputs_mask.asnumpy()
    assert set(np.unique(m1)) <= {0.0, 2.0} and m1.shape == (2, 3)
    assert not np.array_equal(m1, m2) or np.unique(m1).size == 1
    # no dropout: the base cell's output, and the reference's
    jbase = jmx.gluon.rnn.RNNCell(4, input_size=3)
    jbase.initialize()
    base2 = tmx.gluon.rnn.RNNCell(4, input_size=3)
    base2.initialize()
    _carry(jbase, base2)
    out_base, _ = base2.unroll(6, x, layout="NTC", merge_outputs=True)
    plain = tcontrib.rnn.VariationalDropoutCell(base2)
    out_plain, _ = plain.unroll(6, x, layout="NTC", merge_outputs=True)
    np.testing.assert_array_equal(out_plain.asnumpy(), out_base.asnumpy())
    jout, _ = jcontrib.rnn.VariationalDropoutCell(jbase).unroll(
        6, jmx.nd.array(np.ones((2, 6, 3), np.float32)), layout="NTC",
        merge_outputs=True)
    np.testing.assert_allclose(out_plain.asnumpy(), jout.asnumpy(), **TOL)


# ------------------------------------------------------------ contrib
def test_contrib_autograd_old_api():
    from incubator_mxnet_tpu.contrib import autograd as jag
    from incubator_mxnet_tpu_torch.contrib import autograd as tag

    def f(a, b):
        return (a * b + a * a).sum()
    a, b = _rand(5, 3), _rand(6, 3)
    tg, tl = tag.grad_and_loss(f)(tmx.nd.array(a), tmx.nd.array(b))
    jg, jl = jag.grad_and_loss(f)(jmx.nd.array(a), jmx.nd.array(b))
    np.testing.assert_allclose(tl.asnumpy(), jl.asnumpy(), **TOL)
    _same([[g.asnumpy() for g in tg]], [[g.asnumpy() for g in jg]])
    only = tag.grad(f, argnum=1)(tmx.nd.array(a), tmx.nd.array(b))
    np.testing.assert_allclose(only[0].asnumpy(), a, **TOL)
    with tag.train_section():
        assert tmx.autograd.is_recording() and tmx.autograd.is_training()
    with tag.test_section():
        assert not tmx.autograd.is_recording()
    assert tag.set_is_training(False) is False


def test_contrib_io_data_loader_iter():
    from incubator_mxnet_tpu.contrib import io as jio
    from incubator_mxnet_tpu_torch.contrib import io as tio
    x = _rand(7, 10, 3)
    y = np.arange(10, dtype=np.float32)
    got = []
    for mx, io_mod in ((tmx, tio), (jmx, jio)):
        ds = mx.gluon.data.ArrayDataset(x, y)
        it = io_mod.DataLoaderIter(mx.gluon.data.DataLoader(ds, batch_size=4),
                                   dtype="float32")
        assert it.provide_data[0].shape == (4, 3)
        assert it.provide_label[0].shape == (4,)
        epochs = []
        for _ in range(2):
            epochs.append([(b.data[0].asnumpy(), b.label[0].asnumpy())
                           for b in it])
            it.reset()
        got.append(epochs)
    for et, ej in zip(*got):
        assert len(et) == len(ej) == 3
        for (dt, lt), (dj, lj) in zip(et, ej):
            np.testing.assert_array_equal(dt, dj)
            np.testing.assert_array_equal(lt, lj)


def test_contrib_ndarray_is_nd_contrib():
    from incubator_mxnet_tpu_torch.contrib import ndarray as cnd
    assert cnd.edge_id is tmx.nd.contrib.edge_id
    assert cnd.box_nms is tmx.nd.contrib.box_nms
    assert tmx.contrib.ndarray is cnd


def test_log_metrics_callback_writes_jsonl(tmp_path):
    from incubator_mxnet_tpu_torch.contrib.tensorboard import \
        LogMetricsCallback
    cb = LogMetricsCallback(str(tmp_path / "logs"), prefix="train")
    metric = tmx.metric.Accuracy()
    metric.update([tmx.nd.array([1, 0, 1])],
                  [tmx.nd.array([[0.2, 0.8], [0.9, 0.1], [0.7, 0.3]])])
    Param = namedtuple("BatchEndParam", ["epoch", "nbatch", "eval_metric",
                                         "locals"])
    cb(Param(0, 1, metric, None))
    cb(Param(0, 2, None, None))
    cb(Param(0, 3, metric, None))
    lines = [json.loads(s) for s in
             (tmp_path / "logs" / "scalars.jsonl").read_text().splitlines()]
    assert [(r["tag"], r["step"]) for r in lines] == [
        ("train-accuracy", 1), ("train-accuracy", 3)]
    assert abs(lines[0]["value"] - 2 / 3) < 1e-7


def test_contrib_namespaces():
    assert set(tmx.contrib.__all__) >= {"autograd", "io", "ndarray",
                                        "tensorboard", "quantization",
                                        "text"}
    for name in ("nn", "rnn", "data"):
        assert hasattr(tmx.gluon.contrib, name)
    assert set(tcontrib.rnn.__all__) == set(jcontrib.rnn.__all__)
    assert set(tcontrib.nn.basic_layers.__all__) == set(
        jcontrib.nn.basic_layers.__all__)
