"""The port's Gluon API (``gluon/``, ``optimizer``, ``lr_scheduler``)
against the JAX package's, on the CPU.

Every case builds the same block in both packages inside a fresh
``NameManager`` (so the reference's automatic names line up), initialises
the JAX block, carries its parameters across with
``gluon.utils.params_from_jax`` and feeds both the same numpy input. The
JAX side runs under ``jax.default_matmul_precision("highest")``.
Tolerances: 1e-5 (absolute and relative) for forward values, 1e-4 for
parameters after optimizer steps and for losses with logs and exponents.
"""
import os

import numpy as np
import pytest

import jax
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.gluon.utils import params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with tmx.cpu():
        yield


def _np(a):
    return a.asnumpy() if hasattr(a, "asnumpy") else np.asarray(a)


def _arrays(jnet):
    return {k: np.asarray(p.data().asnumpy())
            for k, p in jnet._collect_params_with_prefix().items()}


def _pair(make, x_np, init="xavier", train=False, materialise=True):
    """(jax block, port block) of ``make(package)`` with the JAX block's
    parameters in both; the JAX block is run once on ``x_np`` so deferred
    shapes resolve."""
    with jmx.name.NameManager():
        jnet = make(jmx)
    with tmx.name.NameManager():
        tnet = make(tmx)
    jnet.initialize(jmx.init.Xavier() if init == "xavier" else None)
    tnet.initialize()
    if materialise:
        with jmx.autograd.pause(train_mode=False):
            jnet(jmx.nd.array(x_np))
    params_from_jax(tnet, _arrays(jnet))
    return jnet, tnet


def _run(net, mx, x_np, train=False):
    ctx = (mx.autograd.record() if train
           else mx.autograd.pause(train_mode=False))
    with jax.default_matmul_precision("highest"), ctx:
        return _np(net(mx.nd.array(x_np)))


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


LAYERS = {
    "dense_relu": (lambda mx: mx.gluon.nn.Dense(8, activation="relu"),
                   (4, 6)),
    "dense_no_flatten": (lambda mx: mx.gluon.nn.Dense(8, flatten=False,
                                                      in_units=6),
                         (2, 3, 6)),
    "conv2d_nchw": (lambda mx: mx.gluon.nn.Conv2D(6, 3, strides=2,
                                                  padding=1),
                    (2, 3, 9, 9)),
    "conv2d_nhwc": (lambda mx: mx.gluon.nn.Conv2D(6, (3, 1), padding=(1, 0),
                                                  layout="NHWC",
                                                  use_bias=False),
                    (2, 7, 7, 4)),
    "conv1d": (lambda mx: mx.gluon.nn.Conv1D(5, 3, dilation=2), (2, 3, 12)),
    "conv2d_transpose": (lambda mx: mx.gluon.nn.Conv2DTranspose(
        4, 3, strides=2, in_channels=3), (2, 3, 5, 5)),
    "maxpool_nhwc": (lambda mx: mx.gluon.nn.MaxPool2D(3, 2, 1,
                                                      layout="NHWC"),
                     (2, 9, 9, 4)),
    "avgpool_ceil": (lambda mx: mx.gluon.nn.AvgPool2D(
        2, ceil_mode=True, count_include_pad=False), (2, 3, 7, 7)),
    "global_avg_nhwc": (lambda mx: mx.gluon.nn.GlobalAvgPool2D(
        layout="NHWC"), (2, 5, 5, 3)),
    "global_max": (lambda mx: mx.gluon.nn.GlobalMaxPool2D(), (2, 3, 5, 5)),
    "batchnorm": (lambda mx: mx.gluon.nn.BatchNorm(), (4, 3, 5, 5)),
    "instancenorm": (lambda mx: mx.gluon.nn.InstanceNorm(in_channels=3),
                     (2, 3, 6)),
    "layernorm": (lambda mx: mx.gluon.nn.LayerNorm(), (4, 16)),
    "flatten": (lambda mx: mx.gluon.nn.Flatten(), (2, 3, 4)),
    "activation_tanh": (lambda mx: mx.gluon.nn.Activation("tanh"), (4, 5)),
    "leaky": (lambda mx: mx.gluon.nn.LeakyReLU(0.1), (4, 5)),
    "prelu": (lambda mx: mx.gluon.nn.PReLU(), (4, 5)),
    "elu": (lambda mx: mx.gluon.nn.ELU(0.5), (4, 5)),
    "selu": (lambda mx: mx.gluon.nn.SELU(), (4, 5)),
    "swish": (lambda mx: mx.gluon.nn.Swish(), (4, 5)),
    "gelu": (lambda mx: mx.gluon.nn.GELU(), (4, 5)),
    "dropout_predict": (lambda mx: mx.gluon.nn.Dropout(0.5), (4, 5)),
    "reflection_pad": (lambda mx: mx.gluon.nn.ReflectionPad2D(1),
                       (1, 2, 4, 4)),
    "hybrid_lambda": (lambda mx: mx.gluon.nn.HybridLambda(
        lambda F, x: F.relu(x) * 2), (3, 4)),
}


def _sequential(mx):
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Conv2D(4, 3, padding=1), mx.gluon.nn.BatchNorm(),
                mx.gluon.nn.Activation("relu"), mx.gluon.nn.MaxPool2D(),
                mx.gluon.nn.Flatten(), mx.gluon.nn.Dense(5))
    return net


LAYERS["hybrid_sequential"] = (_sequential, (2, 3, 8, 8))


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_forward_matches_reference(name):
    make, shape = LAYERS[name]
    x = _x(*shape)
    jnet, tnet = _pair(make, x)
    np.testing.assert_allclose(_run(tnet, tmx, x), _run(jnet, jmx, x),
                               **TOL)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_batchnorm_training_forward_and_running_stats(layout):
    axis = 1 if layout == "NCHW" else -1
    x = _x(4, 3, 5, 5) if layout == "NCHW" else _x(4, 5, 5, 3)
    make = lambda mx: mx.gluon.nn.BatchNorm(axis=axis, momentum=0.8)  # noqa
    jnet, tnet = _pair(make, x)
    np.testing.assert_allclose(_run(tnet, tmx, x, train=True),
                               _run(jnet, jmx, x, train=True), **TOL)
    for p in ("running_mean", "running_var"):
        np.testing.assert_allclose(
            _np(getattr(tnet, p).data()), _np(getattr(jnet, p).data()),
            **TOL)


def test_hybridize_keeps_the_forward_and_the_aux_writes():
    x = _x(2, 3, 8, 8)
    jnet, tnet = _pair(_sequential, x)
    jnet.hybridize()
    tnet.hybridize()
    for train in (False, True):
        np.testing.assert_allclose(_run(tnet, tmx, x, train=train),
                                   _run(jnet, jmx, x, train=train), **TOL)
    bn = "1.running_mean"
    np.testing.assert_allclose(
        _np(tnet._collect_params_with_prefix()[bn].data()),
        _np(jnet._collect_params_with_prefix()[bn].data()), **TOL)


def test_forward_hooks_survive_a_detach():
    """MXNet keys hook handles uniquely. The reference keys them by the
    count of live hooks, so a hook registered after a detach replaces a
    live one (ROADMAP.md C); the port keeps both."""
    x = _x(2, 6)
    fired = {}

    def hook(tag):
        return lambda block, inp, out: fired.setdefault(tag, 0)

    for mx in (jmx, tmx):
        fired.clear()
        with mx.name.NameManager():
            net = mx.gluon.nn.Dense(3, in_units=6)
        net.initialize()
        first = net.register_forward_hook(hook("a"))
        net.register_forward_hook(hook("b"))
        first.detach()
        net.register_forward_hook(hook("c"))
        net(mx.nd.array(x))
        assert set(fired) == ({"c"} if mx is jmx else {"b", "c"})


def test_parameter_names_match_reference():
    from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jres
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import \
        resnet as tres

    def names(mx, res):
        with mx.name.NameManager():
            nets = [_sequential(mx), mx.gluon.nn.Dense(3),
                    res.resnet18_v1(classes=5),
                    res.ResNetV1(res.BottleneckV1, [2, 2], [8, 16, 32],
                                 layout="NHWC")]
        return [(list(n.collect_params().keys()),
                 sorted(n._collect_params_with_prefix())) for n in nets]
    assert names(tmx, tres) == names(jmx, jres)


def test_deferred_init_resolves_on_first_forward():
    with tmx.name.NameManager():
        net = tmx.gluon.nn.Dense(4)
    net.initialize()
    assert net.weight.shape == (4, 0)
    with pytest.raises(tmx.gluon.DeferredInitializationError):
        net.weight.data()
    out = net(tmx.nd.array(_x(3, 7)))
    assert out.shape == (3, 4) and net.weight.shape == (4, 7)
    assert net.weight.data().context == tmx.cpu()


def test_save_and_load_parameters_across_packages(tmp_path):
    x = _x(2, 3, 8, 8)
    with jmx.name.NameManager():
        jnet = _sequential(jmx)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x))
    jnet.save_parameters(str(tmp_path / "jax.params"))
    with tmx.name.NameManager():
        tnet = _sequential(tmx)
    tnet.load_parameters(str(tmp_path / "jax.params"))
    np.testing.assert_allclose(_run(tnet, tmx, x), _run(jnet, jmx, x),
                               **TOL)
    # and back: perturb the port's weights, save, load into the JAX net
    w = tnet._collect_params_with_prefix()["0.weight"]
    w.set_data(w.data() * 1.5)
    tnet.save_parameters(str(tmp_path / "port.params"))
    jnet.load_parameters(str(tmp_path / "port.params"))
    np.testing.assert_allclose(_run(jnet, jmx, x), _run(tnet, tmx, x),
                               **TOL)
    with tmx.name.NameManager():
        short = tmx.gluon.nn.Dense(2, in_units=3)
    short.initialize()
    with pytest.raises(ValueError, match="not present"):
        short.load_parameters(str(tmp_path / "port.params"),
                              allow_missing=True)


def test_params_from_jax_keeps_bfloat16_bits():
    x = _x(4, 6)
    jnet, tnet = _pair(LAYERS["dense_relu"][0], x)
    jnet.cast("bfloat16")
    arrays = {k: np.asarray(p.data()._data)
              for k, p in jnet._collect_params_with_prefix().items()}
    assert arrays["weight"].dtype.name == "bfloat16"
    params_from_jax(tnet, arrays)
    w = tnet.weight.data()._data
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(w.view(torch.int16).numpy(),
                                  arrays["weight"].view(np.int16))
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tnet, {**arrays, "weight": arrays["weight"][:2]})
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(tnet, {"weight": arrays["weight"]})


def _losses(mx):
    L = mx.gluon.loss
    return {
        "l2": (L.L2Loss(), "reg"), "l1": (L.L1Loss(), "reg"),
        "sigmoid_bce": (L.SigmoidBinaryCrossEntropyLoss(), "bin"),
        "sigmoid_bce_prob": (L.SigmoidBCELoss(from_sigmoid=True), "prob"),
        "softmax_ce": (L.SoftmaxCrossEntropyLoss(), "cls"),
        "softmax_ce_dense": (L.SoftmaxCELoss(sparse_label=False), "dense"),
        "kldiv": (L.KLDivLoss(from_logits=False), "dense"),
        "huber": (L.HuberLoss(rho=0.5), "reg"),
        "hinge": (L.HingeLoss(), "sign"),
        "squared_hinge": (L.SquaredHingeLoss(), "sign"),
        "logistic": (L.LogisticLoss(), "sign"),
        "poisson": (L.PoissonNLLLoss(), "count"),
        "l2_weighted": (L.L2Loss(weight=0.3), "reg"),
    }


def _loss_inputs(kind, rs):
    pred = rs.randn(6, 5).astype(np.float32)
    if kind == "reg":
        return pred, rs.randn(6, 5).astype(np.float32)
    if kind == "bin":
        return pred, rs.randint(0, 2, (6, 5)).astype(np.float32)
    if kind == "prob":
        return 1 / (1 + np.exp(-pred)), rs.randint(0, 2, (6, 5)).astype(
            np.float32)
    if kind == "cls":
        return pred, rs.randint(0, 5, (6,)).astype(np.int32)
    if kind == "dense":
        lab = rs.rand(6, 5).astype(np.float32)
        return pred, lab / lab.sum(1, keepdims=True)
    if kind == "sign":
        return pred, np.sign(rs.randn(6, 5)).astype(np.float32)
    return pred, rs.poisson(2.0, (6, 5)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(_losses(jmx)))
def test_loss_matches_reference(name):
    tloss, kind = _losses(tmx)[name]
    jloss, _ = _losses(jmx)[name]
    pred, label = _loss_inputs(kind, np.random.RandomState(1))
    sw = np.random.RandomState(2).rand(6, 1).astype(np.float32)
    for extra in ((), (sw,)) if name != "poisson" else ((),):
        t = _np(tloss(*(tmx.nd.array(a) for a in (pred, label) + extra)))
        with jax.default_matmul_precision("highest"):
            j = _np(jloss(*(jmx.nd.array(a) for a in (pred, label) + extra)))
        np.testing.assert_allclose(t, j, **STEP_TOL)


def test_triplet_cosine_and_ctc_losses_match_reference():
    rs = np.random.RandomState(3)
    a, p, n = (rs.randn(4, 6).astype(np.float32) for _ in range(3))
    lab = np.array([1, -1, 1, -1], np.float32)
    logits = rs.randn(2, 7, 5).astype(np.float32)
    labels = np.array([[1, 2, 1], [3, -1, -1]], np.float32)
    for tl, jl, args in (
            (tmx.gluon.loss.TripletLoss(), jmx.gluon.loss.TripletLoss(),
             (a, p, n)),
            (tmx.gluon.loss.CosineEmbeddingLoss(),
             jmx.gluon.loss.CosineEmbeddingLoss(), (a, p, lab)),
            (tmx.gluon.loss.CTCLoss(), jmx.gluon.loss.CTCLoss(),
             (logits, labels))):
        t = _np(tl(*(tmx.nd.array(v) for v in args)))
        with jax.default_matmul_precision("highest"):
            j = _np(jl(*(jmx.nd.array(v) for v in args)))
        np.testing.assert_allclose(t, j, **STEP_TOL)


def _mlp(mx):
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(16, activation="relu", in_units=6),
                mx.gluon.nn.Dense(4, in_units=16))
    return net


TRAINERS = {
    "sgd_momentum_wd": ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                                "wd": 1e-3}),
    "sgd_clip": ("sgd", {"learning_rate": 0.1, "clip_gradient": 0.05}),
    "adam": ("adam", {"learning_rate": 0.01, "wd": 1e-4}),
    "nag": ("nag", {"learning_rate": 0.05, "momentum": 0.9}),
    "rmsprop_centered": ("rmsprop", {"learning_rate": 0.01,
                                     "centered": True}),
    "adagrad": ("adagrad", {"learning_rate": 0.1}),
    "adamw": ("adamw", {"learning_rate": 0.01, "wd": 0.01}),
    "signum": ("signum", {"learning_rate": 0.01}),
    "ftml": ("ftml", {"learning_rate": 0.01}),
    "nadam": ("nadam", {"learning_rate": 0.01}),
}


@pytest.mark.parametrize("case", sorted(TRAINERS))
def test_trainer_steps_match_reference(case):
    opt, kw = TRAINERS[case]
    x = _x(8, 6, seed=4)
    y = np.random.RandomState(5).randint(0, 4, (8,)).astype(np.int32)
    jnet, tnet = _pair(_mlp, x)
    for mx, net in ((jmx, jnet), (tmx, tnet)):
        tr = mx.gluon.Trainer(net.collect_params(), opt, dict(kw))
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        for _ in range(3):
            with jax.default_matmul_precision("highest"):
                with mx.autograd.record():
                    loss = loss_fn(net(mx.nd.array(x)), mx.nd.array(y))
                loss.backward()
                tr.step(8)
    for k, p in jnet._collect_params_with_prefix().items():
        np.testing.assert_allclose(
            _np(tnet._collect_params_with_prefix()[k].data()),
            _np(p.data()), err_msg=k, **STEP_TOL)


def test_trainer_state_round_trip_and_local_stores(tmp_path):
    x = _x(8, 6, seed=4)
    with tmx.name.NameManager():
        net = _mlp(tmx)
    net.initialize(tmx.init.Xavier())
    tr = tmx.gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 0.01}, kvstore="local")
    with tmx.autograd.record():
        loss = (net(tmx.nd.array(x)) ** 2).mean()
    loss.backward()
    tr.step(1)
    tr.save_states(str(tmp_path / "s"))
    tr2 = tmx.gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 0.01}, kvstore=None)
    tr2.load_states(str(tmp_path / "s"))
    for k, v in tr._updaters[0].states.items():
        for a, b in zip(v, tr2._updaters[0].states[k]):
            np.testing.assert_array_equal(_np(a), _np(b))
    assert tr2.optimizer.param_dict[0] is tr._params[0]
    for bad in (dict(kvstore="dist_sync"), dict(update_on_kvstore=True)):
        with pytest.raises(NotImplementedError):
            tmx.gluon.Trainer(net.collect_params(), "sgd", **bad)
    # guard= takes a GuardPolicy or a TrainingGuard (tests/test_torch_guard.py)
    with pytest.raises(TypeError, match="GuardPolicy"):
        tmx.gluon.Trainer(net.collect_params(), "sgd", guard="skip")


def test_lr_mult_applies_as_in_mxnet():
    """MXNet multiplies a parameter's lr by its ``lr_mult`` under a
    Trainer; the reference's Trainer keys ``param_dict`` by index and its
    optimizer looks names up, so ``lr_mult`` is ignored there (ROADMAP.md
    C). The port does what MXNet does."""
    x = _x(4, 6, seed=6)
    with tmx.name.NameManager():
        net = tmx.gluon.nn.Dense(3, in_units=6)
    net.initialize(tmx.init.Xavier())
    net.weight.lr_mult = 0.0
    w0 = _np(net.weight.data()).copy()
    b0 = _np(net.bias.data()).copy()
    tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.5})
    with tmx.autograd.record():
        loss = net(tmx.nd.array(x)).sum()
    loss.backward()
    tr.step(1)
    np.testing.assert_array_equal(_np(net.weight.data()), w0)
    assert not np.allclose(_np(net.bias.data()), b0)


SCHEDULERS = {
    "factor": ("FactorScheduler", dict(step=3, factor=0.5, base_lr=1.0,
                                       warmup_steps=2)),
    "multifactor": ("MultiFactorScheduler", dict(step=[2, 5, 9], factor=0.3,
                                                 base_lr=0.5)),
    "poly": ("PolyScheduler", dict(max_update=12, base_lr=0.2, pwr=2,
                                   final_lr=0.01, warmup_steps=3,
                                   warmup_mode="constant",
                                   warmup_begin_lr=0.05)),
    "cosine": ("CosineScheduler", dict(max_update=10, base_lr=0.4,
                                       final_lr=0.02, warmup_steps=2)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_lr_scheduler_matches_reference(name):
    cls, kw = SCHEDULERS[name]
    t = getattr(tmx.lr_scheduler, cls)(**kw)
    j = getattr(jmx.lr_scheduler, cls)(**kw)
    assert [t(i) for i in range(15)] == [j(i) for i in range(15)]


def test_optimizer_registry_and_updater():
    opt = tmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9)
    assert isinstance(opt, tmx.optimizer.SGD)
    with pytest.raises(KeyError):
        tmx.optimizer.create("no_such_optimizer")
    upd = tmx.optimizer.get_updater(opt)
    w = tmx.nd.array(np.ones((3,), np.float32))
    g = tmx.nd.array(np.full((3,), 2.0, np.float32))
    upd(0, g, w)
    upd(0, g, w)
    # mom1 = -0.2, w1 = 0.8; mom2 = 0.9 * -0.2 - 0.2 = -0.38, w2 = 0.42
    np.testing.assert_allclose(_np(w), np.full(3, 0.42), rtol=1e-6)


def test_split_and_load_and_clip_global_norm():
    data = tmx.nd.array(_x(6, 2))
    parts = tmx.gluon.utils.split_and_load(data, [tmx.cpu(), tmx.cpu()])
    assert [p.shape for p in parts] == [(3, 2), (3, 2)]
    with pytest.raises(ValueError):
        tmx.gluon.utils.split_data(data, 4)
    arrs = [tmx.nd.array(np.full((2,), 3.0, np.float32)),
            tmx.nd.array(np.full((2,), 4.0, np.float32))]
    jarrs = [jmx.nd.array(np.full((2,), 3.0, np.float32)),
             jmx.nd.array(np.full((2,), 4.0, np.float32))]
    n = tmx.gluon.utils.clip_global_norm(arrs, 1.0)
    jn = jmx.gluon.utils.clip_global_norm(jarrs, 1.0)
    assert abs(n - jn) < 1e-5
    for a, b in zip(arrs, jarrs):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
    with pytest.raises(RuntimeError):
        tmx.gluon.utils.download("http://example.invalid/none.bin",
                                 path=os.devnull + ".missing")


def test_symbolic_and_sharded_pieces_raise():
    with pytest.raises(NotImplementedError, match="A11"):
        tmx.gluon.SymbolBlock(None, None)
    with pytest.raises(NotImplementedError, match="A10"):
        tmx.gluon.nn.ShardedEmbedding(10, 4)
    with tmx.name.NameManager():
        net = tmx.gluon.nn.Dense(2, in_units=2)
    with pytest.raises(NotImplementedError, match="A11"):
        net.export("x")
