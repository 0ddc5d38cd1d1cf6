"""int8 serving in the port: ``InferenceEngine.load_model(net=...,
quantize=...)`` on the CPU (``device="cpu"``: the bucket bodies run
eagerly, no graph, ``mxtpu_serve_compiles_total`` at 0).

A port of all eight tests of the reference's
``tests/test_quantized_serving.py`` (calibration at load, one compile a
bucket — on the CPU none, and none from traffic —, int8 parameter bytes,
the padding-bucket bit-stability contract, saved thresholds, BN folding,
degenerate calibration, dynamic ranges), plus one parity test: the same
int8 MLP, its float32 parameters carried from the JAX net and calibrated
on the same batch, serves each row exactly as the JAX engine does (the
calibrated thresholds of the JAX net handed to the port, so both convert
to the same int8 net; integer products are exact and the float32 steps
the same, so rows agree bit for bit).
"""
import json
import threading

import numpy as np
import pytest

import jax

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import serving as jserving
from incubator_mxnet_tpu.contrib import quantization as jq
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import autograd, serving, telemetry
from incubator_mxnet_tpu_torch.contrib.quantization import (
    QuantizedChain, get_thresholds, quantize_net)
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.gluon.utils import params_from_jax
from incubator_mxnet_tpu_torch.test_utils import copy_params

ITEM = 32


def _mlp_make(mx, layers=4, hidden=64, classes=8):
    net = mx.gluon.nn.HybridSequential()
    for _ in range(layers):
        net.add(mx.gluon.nn.Dense(hidden, activation="relu"))
    net.add(mx.gluon.nn.Dense(classes))
    return net


def _mlp(seed=0):
    tmx.random.seed(seed)
    with tmx.cpu():
        net = _mlp_make(tmx)
        net.initialize(tmx.init.Xavier())
        net(tmx.nd.zeros((1, ITEM)))
    return net


def _twin_pair(seed=0):
    a, b = _mlp(seed), _mlp(seed + 1)
    copy_params(a, b)
    return a, b


def _calib(seed=9, n=16):
    rng = np.random.RandomState(seed)
    with tmx.cpu():
        return [tmx.nd.array(rng.rand(n, ITEM).astype(np.float32))]


@pytest.fixture
def engine():
    eng = serving.InferenceEngine(max_batch=64, max_wait_ms=2.0,
                                  device="cpu")
    yield eng
    eng.close()


def test_quantize_kwarg_accuracy_and_bytes(engine):
    fp32, qsrc = _twin_pair()
    epf = engine.load_model("fp32", net=fp32, item_shape=(ITEM,))
    epq = engine.load_model("int8", net=qsrc, item_shape=(ITEM,),
                            quantize={"calib_data": _calib()})
    x = np.random.RandomState(3).rand(ITEM).astype(np.float32)
    ref = epf.predict(x, timeout=30.0)
    out = epq.predict(x, timeout=30.0)
    assert np.abs(out - ref).max() / (np.abs(ref).max() + 1e-9) < 0.1
    g = telemetry.gauge("mxtpu_serve_model_bytes")
    ratio = g.value(model="int8") / g.value(model="fp32")
    assert ratio < 0.35, ratio
    st = engine.stats()
    assert st["int8"]["model_bytes"] == g.value(model="int8")
    assert st["fp32"]["model_bytes"] == g.value(model="fp32")


def test_quantize_kwarg_requires_net(engine):
    with pytest.raises(ValueError, match="net="):
        engine.load_model("bad", fn=lambda b: b, item_shape=(ITEM,),
                          quantize={"calib_data": _calib()})


def test_one_compile_per_bucket_and_stable_after_traffic(engine):
    """On the CPU a bucket is no graph: no compile at load (the card
    counts ``len(buckets)``, ``chip_smoke.py`` phase 25) and none from
    traffic."""
    _, qsrc = _twin_pair()
    compiles = telemetry.counter("mxtpu_serve_compiles_total")
    before = compiles.value(model="int8c")
    ep = engine.load_model("int8c", net=qsrc, item_shape=(ITEM,),
                           quantize={"calib_data": _calib()})
    at_load = compiles.value(model="int8c") - before
    assert at_load == 0 and len(ep.model._entries) == len(ep.buckets)
    rng = np.random.RandomState(5)
    futs = [ep.submit(rng.rand(ITEM).astype(np.float32)) for _ in range(48)]
    for f in futs:
        f.result(timeout=30.0)
    assert compiles.value(model="int8c") - before == at_load


def test_bit_stable_across_padding_buckets(engine):
    _, qsrc = _twin_pair()
    ep = engine.load_model("int8s", net=qsrc, item_shape=(ITEM,),
                           quantize={"calib_data": _calib()})
    rng = np.random.RandomState(7)
    x0 = rng.rand(ITEM).astype(np.float32)
    solo = ep.predict(x0, timeout=30.0)       # bucket 1, padded alone
    xs = [x0] + [rng.rand(ITEM).astype(np.float32) for _ in range(63)]
    results = [None] * 64

    def client(i):
        results[i] = ep.predict(xs[i], timeout=30.0)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(64)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(r is not None for r in results)
    assert np.array_equal(solo, results[0])
    full = serving_rows(ep, xs)
    assert np.array_equal(full[0], solo)


def serving_rows(ep, xs):
    """``xs`` as one batch of the largest bucket, through the model."""
    b = ep.buckets[-1]
    return ep.model.fetch(ep.model.dispatch(ep.model.pack(xs[:b], b),
                                            b))[0]


def test_saved_thresholds_through_serving(engine):
    """Calibrate once offline, serve from the saved thresholds with no
    calibration data: the same endpoint bit for bit."""
    src = _mlp()
    offline, qsrc, qsrc2 = _mlp(seed=1), _mlp(seed=2), _mlp(seed=3)
    for dst in (offline, qsrc, qsrc2):
        copy_params(src, dst)
    qoff = quantize_net(offline, calib_data=_calib(), calib_mode="entropy")
    saved = json.loads(json.dumps(get_thresholds(qoff)))
    ep_cal = engine.load_model(
        "cal", net=qsrc, item_shape=(ITEM,),
        quantize={"calib_data": _calib(), "calib_mode": "entropy"})
    ep_saved = engine.load_model(
        "saved", net=qsrc2, item_shape=(ITEM,),
        quantize={"thresholds": saved})
    x = np.random.RandomState(11).rand(ITEM).astype(np.float32)
    assert np.array_equal(ep_cal.predict(x, timeout=30.0),
                          ep_saved.predict(x, timeout=30.0))


def test_fold_bn_conv_net_through_serving(engine):
    """quantize={"fold_bn": True}: a Conv/BN net folds and converts at
    load and serves within tolerance of its fp32 twin."""
    rng = np.random.RandomState(13)

    def conv_net():
        with tmx.cpu():
            net = nn.HybridSequential()
            net.add(nn.Conv2D(8, kernel_size=3, padding=1, use_bias=False))
            net.add(nn.BatchNorm())
            net.add(nn.Activation("relu"))
            net.add(nn.Conv2D(8, kernel_size=3, padding=1))
            net.add(nn.Flatten())
            net.add(nn.Dense(6))
            net.initialize(tmx.init.Xavier())
            with autograd.pause(train_mode=False):
                net(tmx.nd.zeros((1, 3, 8, 8)))
        return net

    a, b = conv_net(), conv_net()
    copy_params(a, b)
    with tmx.cpu():
        calib = [tmx.nd.array(rng.rand(4, 3, 8, 8).astype(np.float32))]
    epf = engine.load_model("cfp32", net=a, item_shape=(3, 8, 8))
    epq = engine.load_model(
        "cint8", net=b, item_shape=(3, 8, 8),
        quantize={"calib_data": calib, "fold_bn": True})
    assert [type(c) for c in b._children.values()][0] is QuantizedChain
    x = rng.rand(3, 8, 8).astype(np.float32)
    ref = epf.predict(x, timeout=30.0)
    out = epq.predict(x, timeout=30.0)
    assert np.abs(out - ref).max() / (np.abs(ref).max() + 1e-9) < 0.15


def test_all_zero_calibration_serves_finite(engine):
    _, qsrc = _twin_pair()
    with tmx.cpu():
        zeros = [tmx.nd.zeros((8, ITEM))]
    ep = engine.load_model("zeros", net=qsrc, item_shape=(ITEM,),
                           quantize={"calib_data": zeros})
    out = ep.predict(np.random.RandomState(17).rand(ITEM)
                     .astype(np.float32), timeout=30.0)
    assert np.isfinite(out).all()
    out0 = ep.predict(np.zeros(ITEM, np.float32), timeout=30.0)
    assert np.isfinite(out0).all()


def test_dynamic_quantize_serves(engine):
    """quantize=True (no calibration): dynamic per-batch ranges, 0-d
    tensors never read on the host (so a bucket can be captured)."""
    _, qsrc = _twin_pair()
    ep = engine.load_model("dyn", net=qsrc, item_shape=(ITEM,),
                           quantize=True)
    out = ep.predict(np.random.RandomState(19).rand(ITEM)
                     .astype(np.float32), timeout=30.0)
    assert np.isfinite(out).all()


def test_served_int8_rows_match_the_jax_engine():
    """The same int8 MLP served by both engines: the JAX net calibrated on
    a batch, its float32 parameters and its thresholds carried to the
    port, seeded requests through both engines, every row equal bit for
    bit."""
    rng = np.random.RandomState(21)
    calib = rng.rand(16, ITEM).astype(np.float32)
    xs = [rng.rand(ITEM).astype(np.float32) for _ in range(12)]
    with jmx.name.NameManager():
        jnet = _mlp_make(jmx)
    jnet.initialize(jmx.init.Xavier())
    with jax.default_matmul_precision("highest"):
        jnet(jmx.nd.array(calib))
    arrays = {k: np.asarray(p.data().asnumpy()) for k, p in
              jnet._collect_params_with_prefix().items()}
    with tmx.name.NameManager(), tmx.cpu():
        tnet = _mlp_make(tmx)
        tnet.initialize()
    params_from_jax(tnet, arrays, ctx=tmx.cpu())
    with jax.default_matmul_precision("highest"):
        jeng = jserving.InferenceEngine(max_batch=4, max_wait_ms=2.0)
        try:
            jep = jeng.load_model("q", net=jnet, item_shape=(ITEM,),
                                  quantize={"calib_data":
                                            [jmx.nd.array(calib)]})
            saved = jq.get_thresholds(jnet)
            jrows = [jep.predict(x, timeout=60.0) for x in xs]
        finally:
            jeng.close()
    eng = serving.InferenceEngine(max_batch=4, max_wait_ms=2.0,
                                  device="cpu")
    try:
        ep = eng.load_model("q", net=tnet, item_shape=(ITEM,),
                            quantize={"thresholds": saved})
        trows = [ep.predict(x, timeout=60.0) for x in xs]
    finally:
        eng.close()
    for a, b in zip(jrows, trows):
        assert np.array_equal(a, b)
