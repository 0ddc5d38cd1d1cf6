"""The word-LM slice as a whole on the CPU: ``models/word_lm.py``
``RNNModel`` forward, the functional train step (``parallel/dp.py``) and
the imperative ``Trainer`` + ``autograd.record()`` step, against the JAX
package.

Both packages build ``RNNModel("lstm", vocab 50, embed = hidden 32,
2 layers, dropout 0)``, tied and untied; the JAX net is initialised with
Xavier and its parameters cross by name with ``params_from_jax``. Tokens
are (T 7, B 8) from a numpy seed, so the LSTM runs the fused path on both
sides (the port's kernel twins, the JAX Pallas kernels in interpret mode
under ``MXTPU_PALLAS=lstm_cell,lstm_scan`` and
``jax.default_matmul_precision("highest")``). Tolerances: float32 loss
rtol 1e-4 and every parameter within 1e-4 of its largest entry after three
SGD steps at lr 1.0; under bf16 compute (bf16 projections, float32 carries
and masters, as the reference runs bench.py's lane) 2e-2.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.models import word_lm as jwl
from incubator_mxnet_tpu.parallel import dp as jdp
from incubator_mxnet_tpu_torch.gluon.utils import params_from_jax
from incubator_mxnet_tpu_torch.models import word_lm as twl
from incubator_mxnet_tpu_torch.parallel import dp as tdp

V, E, T, B = 50, 32, 7, 8


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "lstm_cell,lstm_scan")
    with jax.default_matmul_precision("highest"), tmx.cpu():
        yield


def _make(mx, wl, tied):
    with mx.name.NameManager():
        return wl.RNNModel("lstm", vocab_size=V, num_embed=E, num_hidden=E,
                           num_layers=2, dropout=0.0, tie_weights=tied)


def _nets(tied, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randint(0, V, (T, B)).astype(np.int32)
    y = rs.randint(0, V, (T, B)).astype(np.int32)
    jmx.random.seed(seed)
    jnet = _make(jmx, jwl, tied)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x))
    tnet = _make(tmx, twl, tied)
    tnet.initialize()
    params_from_jax(tnet, {k: p.data().asnumpy() for k, p in
                           jnet._collect_params_with_prefix().items()})
    return jnet, tnet, x, y


def _rel(a, b):
    a = a.detach().float().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(jnp.asarray(b, jnp.float32))
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12)


@pytest.mark.parametrize("tied", [False, True])
def test_forward_matches_jax(tied):
    jnet, tnet, x, _ = _nets(tied)
    jout, jstate = jnet(jmx.nd.array(x))
    tout, tstate = tnet(tmx.nd.array(x))
    assert tout.shape == (T, B, V)
    assert _rel(tout._data, jout.asnumpy()) < 1e-5
    for t, j in zip(tstate, jstate):
        assert _rel(t._data, j.asnumpy()) < 1e-5
    names = sorted(tnet.collect_params())
    assert names == sorted(jnet.collect_params())
    if tied:
        # one parameter, seen under both structural names
        assert tnet.decoder.weight is tnet.encoder.weight
        # the shared weight, the decoder's bias and the 8 LSTM leaves
        assert len(names) == 1 + 1 + 8


def test_tied_weights_save_and_load_as_one(tmp_path):
    jnet, tnet, x, _ = _nets(True, seed=1)
    path = str(tmp_path / "lm.params")
    tnet.save_parameters(path)
    fresh = _make(tmx, twl, True)
    fresh.load_parameters(path)
    assert fresh.decoder.weight is fresh.encoder.weight
    a, _ = tnet(tmx.nd.array(x))
    b, _ = fresh(tmx.nd.array(x))
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    # the reference reads the port's file
    jfresh = _make(jmx, jwl, True)
    jfresh.load_parameters(path)
    c, _ = jfresh(jmx.nd.array(x))
    assert _rel(a._data, c.asnumpy()) < 1e-5


@pytest.mark.parametrize("tied,dtype", [(False, "float32"), (True, "float32"),
                                        (False, "bfloat16")])
def test_make_train_step_matches_jax(tied, dtype):
    jnet, tnet, x, y = _nets(tied, seed=2)
    bf16 = dtype == "bfloat16"
    jstep, jp, ja, js = jdp.make_train_step(
        jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
        learning_rate=1.0, donate=False,
        compute_dtype=jnp.bfloat16 if bf16 else None)
    tstep, tp, ta, ts = tdp.make_train_step(
        tnet, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
        learning_rate=1.0, compute_dtype=torch.bfloat16 if bf16 else None)
    jl, tl = [], []
    for _ in range(3):
        jp, ja, js, loss = jstep(jp, ja, js, jnp.asarray(x), jnp.asarray(y),
                                 jax.random.PRNGKey(0), jnp.float32(1.0))
        jl.append(float(loss))
        tp, ta, ts, loss = tstep(tp, ta, ts, torch.from_numpy(x),
                                 torch.from_numpy(y))
        tl.append(float(loss))
    tol = 2e-2 if bf16 else 1e-4
    assert jl[-1] < jl[0]
    np.testing.assert_allclose(tl, jl, rtol=tol)
    assert sorted(tp) == sorted(jp)
    for n in jp:
        assert tp[n].dtype == torch.float32
        assert _rel(tp[n], jp[n]) < tol, n


def test_trainer_record_step_matches_jax():
    jnet, tnet, x, y = _nets(False, seed=3)
    outs = []
    for mx, net in ((jmx, jnet), (tmx, tnet)):
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 1.0})
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        with mx.autograd.record():
            out, _ = net(mx.nd.array(x))
            loss = loss_fn(out, mx.nd.array(y))
        loss.backward()
        trainer.step(T * B)
        outs.append({k: p.data().asnumpy()
                     for k, p in net.collect_params().items()})
    jw, tw = outs
    for k in jw:
        assert _rel(torch.from_numpy(tw[k]), jw[k]) < 1e-4, k


def test_symbolic_pieces_raise():
    assert twl.default_buckets() == jwl.default_buckets()
    with pytest.raises(NotImplementedError, match="A11"):
        twl.lm_sym_gen(V, E, E)
