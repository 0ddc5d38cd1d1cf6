"""Rematerialisation on the CPU: ``make_train_step(remat=...)`` and
``hybridize(remat=...)`` (``parallel/dp.py`` ``REMAT_POLICIES``) against
the JAX package's policies and against the port's own step without one.

The nets: the Dense 64-64-8 MLP of ``tests/test_parallel.py:421`` on
(256, 32) inputs (tolerances as that test has them: loss rtol 1e-5,
parameters rtol 1e-4 / atol 1e-5 against JAX; a policy changes no value of
the port's own step, so there the results are equal bit for bit); a
Dense-BatchNorm-Dense block for ``hybridize(remat=...)`` (the reference's
``tests/test_gluon.py:220`` check: loss rtol 1e-6, gradients rtol 1e-5 /
atol 1e-6, and the running statistics written once); the small fused
NHWC ResNet of ``tests/test_torch_resnet_train.py``, where a policy runs
BatchNorm as its plain composition (every parameter within 1e-4 of its
largest entry). The JAX side runs under
``jax.default_matmul_precision("highest")``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.parallel import dp as jdp
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from incubator_mxnet_tpu_torch.gluon.utils import params_from_jax
from incubator_mxnet_tpu_torch.parallel import dp as tdp

POLICIES = ("dots", "dots_reduces", "dots_no_batch", "nothing",
            "everything")


@pytest.fixture(autouse=True)
def _env():
    with jax.default_matmul_precision("highest"), tmx.cpu():
        yield


def _mlp_of(mx, dropout=0.0):
    with mx.name.NameManager():
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Dense(64, activation="relu"),
                mx.gluon.nn.Dense(64, activation="relu"))
        if dropout:
            net.add(mx.gluon.nn.Dropout(dropout))
        net.add(mx.gluon.nn.Dense(8))
    return net


@pytest.fixture(scope="module")
def mlp():
    rs = np.random.RandomState(3)
    x = rs.rand(256, 32).astype(np.float32)
    y = rs.randint(0, 8, (256,)).astype(np.int32)
    jmx.random.seed(11)
    jnet = _mlp_of(jmx)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x[:1]))
    with tmx.cpu():
        tnet = _mlp_of(tmx)
        tnet.initialize()
        tnet(tmx.nd.array(x[:1]))
        params_from_jax(tnet, {k: p.data().asnumpy() for k, p in
                               jnet._collect_params_with_prefix().items()})
    return jnet, tnet, x, y


def _port_step(tnet, x, y, remat, **kw):
    step, p, a, s = tdp.make_train_step(
        tnet, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        learning_rate=0.1, donate=False, remat=remat, **kw)
    p2, _, _, loss = step(p, a, s, torch.from_numpy(x), torch.from_numpy(y))
    return p2, loss


def _jax_step(jnet, x, y, remat):
    step, p, a, s = jdp.make_train_step(
        jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        learning_rate=0.1, donate=False, remat=remat)
    p2, _, _, loss = step(p, a, s, jnp.asarray(x), jnp.asarray(y),
                          jax.random.PRNGKey(0), jnp.float32(0.1))
    return p2, float(loss)


def _saves_mm(ctx, op, *args, **kwargs):
    return op.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.addmm)


@pytest.mark.parametrize("remat", POLICIES + ("callable",))
def test_train_step_policy_matches_jax_and_the_plain_step(mlp, remat):
    jnet, tnet, x, y = mlp
    jremat = jax.checkpoint_policies.dots_saveable if remat == "callable" \
        else remat
    jp, jloss = _jax_step(jnet, x, y, jremat)
    tp, tloss = _port_step(tnet, x, y,
                           _saves_mm if remat == "callable" else remat)
    np.testing.assert_allclose(float(tloss), jloss, rtol=1e-5)
    for n in jp:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   rtol=1e-4, atol=1e-5, err_msg=n)
    pp, ploss = _port_step(tnet, x, y, None)
    assert torch.equal(tloss, ploss)
    for n in pp:
        assert torch.equal(tp[n], pp[n]), n


@pytest.mark.parametrize("remat", [None, "nothing", "dots"])
def test_a_policy_runs_the_forward_again_in_the_backward(mlp, remat):
    """A pre-hook: the recompute stops once it has what the backward
    needs, before the block's forward hooks would run."""
    _, tnet, x, y = mlp
    calls = []
    handle = list(tnet._children.values())[0].register_forward_pre_hook(
        lambda *a: calls.append(1))
    try:
        _port_step(tnet, x, y, remat)
    finally:
        handle.detach()
    assert len(calls) == (1 if remat is None else 2)


def test_unknown_policy_raises_and_the_env_is_read(mlp, monkeypatch):
    _, tnet, x, y = mlp
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    with pytest.raises(ValueError, match="unknown remat policy"):
        tdp.make_train_step(tnet, loss_fn, remat="bogus")
    monkeypatch.setenv("MXTPU_REMAT", "bogus")
    with pytest.raises(ValueError, match="unknown remat policy"):
        tdp.make_train_step(tnet, loss_fn)
    monkeypatch.setenv("MXTPU_REMAT", "nothing")
    calls = []
    handle = list(tnet._children.values())[0].register_forward_pre_hook(
        lambda *a: calls.append(1))
    try:
        _port_step(tnet, x, y, None)
    finally:
        handle.detach()
    assert len(calls) == 2


def test_random_draws_are_kept_for_the_recompute():
    """Dropout under a policy: the recompute sees the forward's mask, so
    the step equals the step without a policy from the same seed."""
    rs = np.random.RandomState(4)
    x = rs.rand(64, 32).astype(np.float32)
    y = rs.randint(0, 8, (64,)).astype(np.int32)
    tmx.random.seed(4)
    net = _mlp_of(tmx, dropout=0.5)
    net.initialize(tmx.init.Xavier())
    net(tmx.nd.array(x[:1]))
    got = {}
    for remat in (None, "nothing", "dots"):
        tmx.random.seed(9)
        got[remat] = _port_step(net, x, y, remat)
    for remat in ("nothing", "dots"):
        assert torch.equal(got[remat][1], got[None][1])
        for n in got[None][0]:
            assert torch.equal(got[remat][0][n], got[None][0][n]), n


def test_fused_resnet_step_under_a_policy(monkeypatch):
    """The fused stages' Functions are recomputed under the policy; the
    per-block BatchNorm runs its plain composition."""
    monkeypatch.setenv("MXTPU_FUSED_RESNET", "1")
    monkeypatch.setenv("MXTPU_FUSED_MIN_MID", "8")
    rs = np.random.RandomState(0)
    x = rs.rand(4, 3, 32, 32).astype(np.float32)
    y = rs.randint(0, 10, (4,)).astype(np.int32)
    tmx.random.seed(0)
    with tmx.name.NameManager():
        net = tres.ResNetV1(tres.BottleneckV1, [2, 2], [16, 32, 64],
                            classes=10, layout="NHWC")
    net.initialize(tmx.init.Xavier())
    net(tmx.nd.array(x[:1]))
    pp, ploss = _port_step(net, x, y, None)
    for remat in ("dots", "nothing"):
        tp, tloss = _port_step(net, x, y, remat)
        assert abs(float(tloss) - float(ploss)) <= 1e-5 * abs(float(ploss))
        for n in pp:
            scale = max(float(pp[n].abs().max()), 1e-12)
            assert float((tp[n] - pp[n]).abs().max()) < 1e-4 * scale, n


# ------------------------------------------------------ hybridize(remat=)
def _bn_block(seed, remat):
    tmx.random.seed(seed)
    with tmx.name.NameManager():
        net = tmx.gluon.nn.HybridSequential()
        net.add(tmx.gluon.nn.Dense(32), tmx.gluon.nn.BatchNorm(),
                tmx.gluon.nn.Activation("relu"),
                tmx.gluon.nn.Dense(16, activation="relu"),
                tmx.gluon.nn.Dense(4))
    net.initialize(tmx.init.Xavier())
    net.hybridize(remat=remat)
    return net


def _record(net, x):
    with tmx.autograd.record():
        out = net(x)
        loss = (out ** 2).mean()
    loss.backward()
    return (float(loss.asnumpy()),
            [p.grad().asnumpy() for p in net.collect_params().values()
             if p.grad_req != "null"],
            [p.data().asnumpy() for p in net.collect_params().values()
             if p.grad_req == "null"])


@pytest.mark.parametrize("remat", POLICIES)
def test_hybridize_remat_matches_plain(remat):
    x = tmx.nd.array(np.random.RandomState(0).rand(8, 12)
                     .astype(np.float32))
    loss0, grads0, stats0 = _record(_bn_block(5, None), x)
    net = _bn_block(5, remat)
    loss1, grads1, stats1 = _record(net, x)
    assert np.isclose(loss0, loss1, rtol=1e-6)
    for a, b in zip(grads0, grads1):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    # BatchNorm's running statistics moved once, by the forward
    for a, b in zip(stats0, stats1):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
    assert net._static is None           # a recording call stays eager


def test_hybridize_remat_matches_the_reference_gradients():
    x = np.random.RandomState(1).rand(8, 12).astype(np.float32)
    grads = []
    for mx in (jmx, tmx):
        mx.random.seed(5)
        with mx.name.NameManager():
            net = mx.gluon.nn.HybridSequential()
            net.add(mx.gluon.nn.Dense(32, activation="relu"),
                    mx.gluon.nn.Dense(16, activation="relu"),
                    mx.gluon.nn.Dense(4))
        net.initialize(mx.init.Xavier())
        net(mx.nd.array(x[:1]))
        if mx is tmx:
            params_from_jax(net, jparams)
        else:
            jparams = {k: p.data().asnumpy() for k, p in
                       net._collect_params_with_prefix().items()}
        net.hybridize(remat="dots")
        with mx.autograd.record():
            loss = (net(mx.nd.array(x)) ** 2).mean()
        loss.backward()
        grads.append([p.grad().asnumpy()
                      for p in net.collect_params().values()])
    for j, t in zip(*grads):
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-6)


def test_hybridize_unknown_policy_raises_at_the_call():
    net = _bn_block(5, "not-a-policy")
    with pytest.raises(ValueError, match="unknown remat policy"):
        net(tmx.nd.ones((2, 12)))
