"""The slice as a whole on the CPU: records in, a ResNet trained.

Both packages read the same JPEG record file (written by the port's
``recordio.pack_img``) through their own ``ImageRecordIter`` (the native
pipeline, ``dtype="uint8"``: raw NHWC pixels) and train the same small
NHWC ``ResNetV1(BottleneckV1, [2, 2], [16, 32, 64])`` (as
``tests/test_torch_resnet_train.py`` builds it, the fused stages on) for
3 SGD steps with momentum. The port's batches go through
``io.DevicePrefetcher(device="cpu")`` and the centre
``image.random_crop_flip``; the reference's through its own
``image.random_crop_flip``; both then cast to float32 / 255 in NCHW. The
JAX net's parameters cross with ``params_from_jax``. Tolerances, those of
``test_torch_resnet_train.py``: the input batches exactly; each step's
loss within rtol 1e-4; every parameter after the 3 steps within 1e-4 of
its largest entry (a conv bias right before a BatchNorm, moved by float
noise only, within 1e-6 absolute).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import _native as jnat
from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jres
from incubator_mxnet_tpu.parallel import dp as jdp
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import image as timg
from incubator_mxnet_tpu_torch import io as tio
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from incubator_mxnet_tpu_torch.gluon.utils import params_from_jax
from incubator_mxnet_tpu_torch.parallel import dp as tdp
from incubator_mxnet_tpu_torch.recordio import IRHeader, MXRecordIO, pack_img

B, SRC, HW, STEPS, LR = 4, 40, 32, 3, 0.05


@pytest.fixture(autouse=True)
def _fused_env(monkeypatch):
    monkeypatch.setenv("MXTPU_FUSED_RESNET", "1")
    monkeypatch.setenv("MXTPU_FUSED_MIN_MID", "8")
    with tmx.cpu():
        yield


def _make(mx, res):
    with mx.name.NameManager():
        return res.ResNetV1(res.BottleneckV1, [2, 2], [16, 32, 64],
                            classes=10, layout="NHWC")


def _records(path):
    rs = np.random.RandomState(0)
    w = MXRecordIO(path, "w")
    for i in range(B * STEPS):
        img = rs.randint(0, 255, (SRC, SRC, 3), dtype=np.uint8)
        w.write(pack_img(IRHeader(0, float(rs.randint(0, 10)), i, 0), img,
                         quality=90))
    w.close()
    return path


def _noise(name):
    return "_stage" in name and name.endswith("_bias")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12)


def _port_batches(path):
    it = tio.ImageRecordIter(path_imgrec=path, data_shape=(3, SRC, SRC),
                             batch_size=B, dtype="uint8")
    assert it.route == "native"
    with tio.DevicePrefetcher(it, depth=2, device="cpu") as pf:
        for batch in pf:
            x = timg.random_crop_flip(batch.data[0], (HW, HW),
                                      rand_crop=False, rand_mirror=False)
            yield (x._data.permute(0, 3, 1, 2).float() / 255.0,
                   batch.label[0]._data.to(torch.int32))


def _reference_batches(path):
    it = jmx.io.ImageRecordIter(path_imgrec=path, data_shape=(3, SRC, SRC),
                                batch_size=B, dtype="uint8")
    for batch in it:
        x = jmx.image.random_crop_flip(
            jnp.asarray(batch.data[0].asnumpy()), (HW, HW),
            jax.random.PRNGKey(0), rand_crop=False, rand_mirror=False)
        yield (jnp.transpose(x.astype(jnp.float32) / 255.0, (0, 3, 1, 2)),
               jnp.asarray(batch.label[0].asnumpy().astype(np.int32)))


def test_record_fed_steps_match_the_reference(tmp_path):
    if not jnat.available():
        pytest.skip("the reference's native library did not build")
    path = _records(str(tmp_path / "train.rec"))
    jmx.random.seed(0)
    jnet = _make(jmx, jres)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(np.zeros((1, 3, HW, HW), np.float32)))
    tnet = _make(tmx, tres)
    tnet.initialize()
    params_from_jax(tnet, {k: np.asarray(p.data().asnumpy()) for k, p in
                           jnet._collect_params_with_prefix().items()})

    jstep, jp, ja, js = jdp.make_train_step(
        jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
        learning_rate=LR, momentum=0.9, donate=False)
    jlosses = []
    with jax.default_matmul_precision("highest"):
        for x, y in _reference_batches(path):
            jp, ja, js, jl = jstep(jp, ja, js, x, y, jax.random.PRNGKey(0),
                                   jnp.float32(LR))
            jlosses.append(float(jl))
    tstep, tp, ta, ts = tdp.make_train_step(
        tnet, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
        learning_rate=LR, momentum=0.9)
    tlosses, seen = [], []
    for (x, y), (jx, jy) in zip(_port_batches(path),
                                _reference_batches(path)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
        tp, ta, ts, tl = tstep(tp, ta, ts, x, y)
        tlosses.append(float(tl))
        seen.append(y.numpy())
    assert len(tlosses) == len(jlosses) == STEPS
    assert len(np.unique(np.concatenate(seen))) > 1
    for t, j in zip(tlosses, jlosses):
        assert abs(t - j) <= 1e-4 * abs(j)
    for n in jp:
        got = tp[n].detach().numpy()
        if _noise(n):
            assert np.max(np.abs(got - np.asarray(jp[n]))) < 1e-6, n
        else:
            assert _rel(got, jp[n]) < 1e-4, n
