"""One width of each zoo family the port added (AlexNet, DenseNet-121,
SqueezeNet 1.0 and 1.1, Inception V3, MobileNet 0.25, MobileNet v2 0.25)
in training against the JAX package, on the CPU, with the weights, inputs
and sizes of ``test_torch_model_zoo_families.py``.

The training forward (the ``Dropout`` rates set to 0 in both nets, since
the two frameworks draw different masks; BatchNorm on batch statistics)
within 2e-3 of the output's largest entry: at batch 2 a batch-statistics
BatchNorm amplifies rounding (MobileNet v2 measured 7.4e-4). The
gradients of ``sum(y * c)`` for a fixed random ``c``, recorded with
``train_mode=False`` (BatchNorm on its running statistics: at batch 2
the batch-statistics backward is ill-conditioned, and float32 runs of
either package differ from a float64 one by 1-18% of the largest
gradient entry, DenseNet-121 at 221 and MobileNet at 16 measured),
within 5e-4 of the net's largest gradient entry (DenseNet-161's deepest
measured 2.2e-4). Float32; the JAX side hybridized under
``jax.default_matmul_precision("highest")``.
"""
import numpy as np
import pytest

import jax

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

from test_torch_model_zoo_families import CASES, _close, _pair

WIDTHS = ("alexnet", "densenet121", "squeezenet1.0", "squeezenet1.1",
          "inceptionv3", "mobilenet0.25", "mobilenetv2_0.25")


@pytest.fixture(autouse=True)
def _env():
    with jax.default_matmul_precision("highest"), tmx.cpu():
        yield


def _dropouts_off(net, mod):
    for blk in net._children.values():
        if isinstance(blk, mod.gluon.nn.Dropout):
            blk._rate = 0.0
        _dropouts_off(blk, mod)


def _grads(mod, net, x, c):
    with mod.autograd.record(train_mode=False):
        y = net(mod.nd.array(x))
        loss = (y * mod.nd.array(c)).sum()
    loss.backward()
    return {k: p.grad().asnumpy() for k, p in
            net._collect_params_with_prefix().items()
            if p.grad_req != "null"}


@pytest.mark.parametrize("name", WIDTHS)
def test_family_training_forward_and_backward_match_jax(name):
    jnet, tnet, x, c = _pair(name, CASES[name])
    _dropouts_off(jnet, jmx)
    _dropouts_off(tnet, tmx)
    with jmx.autograd.train_mode():
        jy = jnet(jmx.nd.array(x)).asnumpy()
    with tmx.autograd.train_mode():
        ty = tnet(tmx.nd.array(x)).asnumpy()
    _close(ty, jy, 2e-3, "train")
    jg, tg = _grads(jmx, jnet, x, c), _grads(tmx, tnet, x, c)
    assert sorted(tg) == sorted(jg)
    scale = max(np.abs(g).max() for g in jg.values())
    for k in jg:
        assert tg[k].shape == jg[k].shape, k
        assert np.abs(tg[k] - jg[k]).max() <= 5e-4 * scale, k
