"""The port's AlexNet, DenseNet, SqueezeNet, Inception V3 and MobileNet
v1/v2 zoo families against the JAX package's, on the CPU: the eval
forward of every family and width, the ``get_model`` names, and
SqueezeNet's pooling convention. (``test_torch_model_zoo_training.py``
holds one width of each family in training.)

Both packages build the net by its ``get_model`` name (10 classes) with
the same random weights and BatchNorm statistics (Xavier's uniform
bound, statistics and affine terms uniform), which cross by structural
name through ``params_from_jax``. At batch 2 and the smallest input each
net accepts (AlexNet 63, DenseNet 221, SqueezeNet 1.0 213 and 1.1 209,
Inception V3 299; MobileNet at 64, where a training forward is
well-conditioned: at 16 its last BatchNorms see one pixel of two images),
the eval forward, every ``Dropout`` off, within 1e-4 of the output's
largest entry (float32; the JAX side hybridized under
``jax.default_matmul_precision("highest")``; MobileNet's depthwise stack
measured 5.8e-5), and bitwise stable from one call to the next.

SqueezeNet's ``ceil_mode=True`` pools take MXNet's "full" convention
(out = ceil((L + 2p - k) / s) + 1), which PyTorch's ``ceil_mode`` shares
except where the last window would start in the right padding; the
output shapes and values of such pools (values within 1e-6) are held
against the reference and that formula.
"""
import numpy as np
import pytest

import jax

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from incubator_mxnet_tpu_torch.gluon.utils import params_from_jax

CASES = {"alexnet": 63, "densenet121": 221, "densenet161": 221,
         "densenet169": 221, "densenet201": 221, "squeezenet1.0": 213,
         "squeezenet1.1": 209, "inceptionv3": 299, "mobilenet1.0": 64,
         "mobilenet0.75": 64, "mobilenet0.5": 64, "mobilenet0.25": 64,
         "mobilenetv2_1.0": 64, "mobilenetv2_0.75": 64,
         "mobilenetv2_0.5": 64, "mobilenetv2_0.25": 64}


@pytest.fixture(autouse=True)
def _env():
    with jax.default_matmul_precision("highest"), tmx.cpu():
        yield


def _close(got, want, tol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, \
        (name, np.abs(got - want).max(), scale)


def _pair(name, size, seed=0):
    """(JAX net, port net, x, c) with the same random weights and
    BatchNorm statistics in both. The port's net infers the shapes; the
    JAX net takes them as given and runs hybridized, since its eager
    first call compiles op by op."""
    rs = np.random.RandomState(seed)
    x = rs.rand(2, 3, size, size).astype(np.float32)
    with tmx.name.NameManager():
        tnet = tvision.get_model(name, classes=10)
    tnet.initialize()
    tnet(tmx.nd.array(x[:1]))
    arrays = {}
    for k, p in tnet._collect_params_with_prefix().items():
        shape = tuple(p.shape)
        if k.endswith(("running_mean", "beta", "bias")):
            a = rs.uniform(-0.5, 0.5, shape)
        elif k.endswith(("running_var", "gamma")):
            a = rs.uniform(0.5, 1.5, shape)
        else:                               # Xavier's uniform bound
            fan = np.prod(shape[1:]) if len(shape) > 1 else shape[0]
            bound = np.sqrt(6.0 / (fan + shape[0] * np.prod(shape[2:])))
            a = rs.uniform(-bound, bound, shape)
        arrays[k] = a.astype(np.float32)
    params_from_jax(tnet, arrays)
    with jmx.name.NameManager():
        jnet = jvision.get_model(name, classes=10)
    for k, p in jnet._collect_params_with_prefix().items():
        p.shape = arrays[k].shape
    jnet.initialize()
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(arrays[k]))
    jnet.hybridize()
    return jnet, tnet, x, rs.randn(2, 10).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_family_eval_forward_matches_jax(name):
    jnet, tnet, x, _ = _pair(name, CASES[name])
    jy = jnet(jmx.nd.array(x)).asnumpy()
    ty = tnet(tmx.nd.array(x)).asnumpy()
    assert ty.shape == (2, 10)
    _close(ty, jy, 1e-4, "eval")
    assert np.array_equal(ty, tnet(tmx.nd.array(x)).asnumpy())


def test_get_model_names_match_the_reference():
    names = sorted(CASES) + [f"resnet{n}_v{v}" for n in (18, 50)
                             for v in (1, 2)] + ["vgg11", "vgg16_bn"]
    for name in names:
        with tmx.name.NameManager():
            t = tvision.get_model(name)
        with jmx.name.NameManager():
            j = jvision.get_model(name)
        assert type(t).__name__ == type(j).__name__, name
    with pytest.raises(ValueError, match="not supported"):
        tvision.get_model("resnet19_v1")
    with pytest.raises(RuntimeError, match="pretrained"):
        tvision.get_model("alexnet", pretrained=True)
    assert tvision.inception_v3 is tvision.get_model.__globals__[
        "inception_v3"]


@pytest.mark.parametrize("size,k,s,p", [(55, 3, 2, 0), (54, 3, 2, 0),
                                        (27, 3, 2, 0), (13, 3, 2, 0),
                                        (7, 3, 2, 1), (3, 1, 2, 1),
                                        (8, 2, 3, 1)])
def test_ceil_mode_pooling_follows_mxnets_full_convention(size, k, s, p):
    x = np.random.RandomState(size).randn(1, 2, size, size).astype(
        np.float32)
    want_len = -(-(size + 2 * p - k) // s) + 1
    for kind in ("MaxPool2D", "AvgPool2D"):
        tl = getattr(tmx.gluon.nn, kind)(k, s, p, ceil_mode=True)
        jl = getattr(jmx.gluon.nn, kind)(k, s, p, ceil_mode=True)
        ty = tl(tmx.nd.array(x)).asnumpy()
        jy = jl(jmx.nd.array(x)).asnumpy()
        assert ty.shape == jy.shape == (1, 2, want_len, want_len), kind
        np.testing.assert_allclose(ty, jy, rtol=1e-6, atol=1e-6)
