"""The static-buffer training step (``parallel/dp.py`` ``make_train_step``
and ``DataParallelTrainer``) on the CPU, against the JAX package's jitted
step.

On the card the port captures one CUDA graph a key (x's and y's shapes
and types; a generator is a value) and replays it; on the CPU the same body
runs eagerly on the same static buffers, which is what these tests hold:
the values, the donation semantics, the entries built, ``lr`` as a tensor
and ``unroll_steps`` as one body of several updates.

Nets: the small NHWC ``ResNetV1(BottleneckV1, [2, 2], [16, 32, 64])`` of
``tests/test_torch_resnet_train.py`` (fused stages on the kernels' plain
twins, batch 4 at 32 x 32), the word LM of
``tests/test_torch_word_lm_train.py`` (vocab 50, 2 x 32 LSTM, T 7, B 8)
and the Dense 64-64-8 MLP of
``tests/test_parallel.py:421`` on (16, 32) inputs; the JAX side runs under
``jax.default_matmul_precision("highest")`` and ``donate=False``, weights
cross with ``params_from_jax``. Tolerances: the loss 1e-4 relative,
every parameter within 1e-4 of its largest entry after three steps (the
MLP's bit-for-bit claims are between two runs of the port).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jres
from incubator_mxnet_tpu.models import word_lm as jwl
from incubator_mxnet_tpu.parallel import dp as jdp
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from incubator_mxnet_tpu_torch.gluon.utils import params_from_jax
from incubator_mxnet_tpu_torch.models import word_lm as twl
from incubator_mxnet_tpu_torch.parallel import dp as tdp

TOL = 1e-4


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("MXTPU_FUSED_RESNET", "1")
    monkeypatch.setenv("MXTPU_FUSED_MIN_MID", "8")
    monkeypatch.setenv("MXTPU_PALLAS", "lstm_cell,lstm_scan")
    with jax.default_matmul_precision("highest"), tmx.cpu():
        yield


def _rel(a, b):
    a = a.detach().float().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(jnp.asarray(b, jnp.float32))
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12)


def _cross(jnet, tnet):
    params_from_jax(tnet, {k: np.asarray(p.data().asnumpy()) for k, p in
                           jnet._collect_params_with_prefix().items()})


def _resnet():
    rs = np.random.RandomState(0)
    x = rs.rand(4, 3, 32, 32).astype(np.float32)
    y = rs.randint(0, 10, (4,)).astype(np.int32)
    nets = []
    for mx, res in ((jmx, jres), (tmx, tres)):
        mx.random.seed(0)
        with mx.name.NameManager():
            net = res.ResNetV1(res.BottleneckV1, [2, 2], [16, 32, 64],
                               classes=10, layout="NHWC")
        net.initialize(mx.init.Xavier())
        net(mx.nd.array(x[:1]))
        nets.append(net)
    _cross(*nets)
    return nets[0], nets[1], x, y


def _word_lm():
    rs = np.random.RandomState(2)
    x = rs.randint(0, 50, (7, 8)).astype(np.int32)
    y = rs.randint(0, 50, (7, 8)).astype(np.int32)
    nets = []
    for mx, wl in ((jmx, jwl), (tmx, twl)):
        mx.random.seed(2)
        with mx.name.NameManager():
            net = wl.RNNModel("lstm", vocab_size=50, num_embed=32,
                              num_hidden=32, num_layers=2, dropout=0.0)
        net.initialize(mx.init.Xavier())
        net(mx.nd.array(x))
        nets.append(net)
    _cross(*nets)
    return nets[0], nets[1], x, y


def _mlp_of(mx, dropout=0.0):
    with mx.name.NameManager():
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Dense(64, activation="relu"),
                mx.gluon.nn.Dense(64, activation="relu"))
        if dropout:
            net.add(mx.gluon.nn.Dropout(dropout))
        net.add(mx.gluon.nn.Dense(8))
    return net


def _mlp(seed=3, n=16, dropout=0.0):
    rs = np.random.RandomState(seed)
    x = rs.rand(n, 32).astype(np.float32)
    y = rs.randint(0, 8, (n,)).astype(np.int32)
    nets = []
    for mx in (jmx, tmx):
        mx.random.seed(seed)
        net = _mlp_of(mx, dropout)
        net.initialize(mx.init.Xavier())
        net(mx.nd.array(x[:1]))
        nets.append(net)
    _cross(*nets)
    return nets[0], nets[1], x, y


def _jax_steps(jnet, x, y, n, lr, momentum=0.0, unroll=1):
    step, p, a, s = jdp.make_train_step(
        jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
        learning_rate=lr, momentum=momentum, donate=False,
        unroll_steps=unroll)
    losses = []
    for _ in range(n):
        p, a, s, loss = step(p, a, s, jnp.asarray(x), jnp.asarray(y),
                             jax.random.PRNGKey(0), jnp.float32(lr))
        losses.append(float(loss))
    return p, a, losses


def _port_step(tnet, lr, momentum=0.0, **kw):
    return tdp.make_train_step(
        tnet, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
        learning_rate=lr, momentum=momentum, **kw)


def _port_steps(step, state, x, y, n, **kw):
    p, a, s = state
    losses = []
    for _ in range(n):
        p, a, s, loss = step(p, a, s, torch.from_numpy(x),
                             torch.from_numpy(y), **kw)
        losses.append(float(loss))
    return p, a, s, losses


def _same_as_jax(tp, jp, tl, jl, skip=()):
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    assert sorted(tp) == sorted(jp)
    for n in jp:
        if n in skip:
            continue
        assert _rel(tp[n], jp[n]) < TOL, n


def test_resnet_three_steps_match_jax_on_the_static_buffers():
    jnet, tnet, x, y = _resnet()
    jp, ja, jl = _jax_steps(jnet, x, y, 3, 0.05, momentum=0.9)
    step, *state = _port_step(tnet, 0.05, momentum=0.9)
    tp, ta, ts, tl = _port_steps(step, state, x, y, 3)
    # the biases right before a BatchNorm move by float noise only
    noise = [n for n in jp if n.endswith("_bias") and "_stage" in n]
    _same_as_jax(tp, jp, tl, jl, skip=noise)
    for n in noise:
        assert np.max(np.abs(tp[n].numpy() - np.asarray(jp[n]))) < 1e-6, n
    for n in ja:
        assert _rel(ta[n], ja[n]) < TOL, n
    assert tp is step.params and ta is step.aux and ts is step.opt_state
    assert step._cache_size() == 1


@pytest.mark.parametrize("donate", [True, False])
def test_word_lm_three_steps_match_jax(donate):
    jnet, tnet, x, y = _word_lm()
    jp, _, jl = _jax_steps(jnet, x, y, 3, 1.0)
    step, *state = _port_step(tnet, 1.0, donate=donate)
    tp, _, _, tl = _port_steps(step, state, x, y, 3)
    _same_as_jax(tp, jp, tl, jl)
    assert (tp is step.params) == donate


def test_unroll_two_equals_two_steps_and_the_reference_scan():
    jnet, tnet, x, y = _mlp()
    xs, ys = np.stack([x, x[::-1]]), np.stack([y, y[::-1]])
    jstep, jp, ja, js = jdp.make_train_step(
        jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
        learning_rate=0.1, momentum=0.9, donate=False, unroll_steps=2)
    jp, ja, js, jloss = jstep(jp, ja, js, jnp.asarray(xs), jnp.asarray(ys),
                              jax.random.PRNGKey(0), jnp.float32(0.1))
    ustep, *state = _port_step(tnet, 0.1, momentum=0.9, unroll_steps=2)
    up, _, us, uloss = ustep(*state, torch.from_numpy(xs),
                             torch.from_numpy(ys))
    sstep, *state = _port_step(tnet, 0.1, momentum=0.9)
    sp, _, ss, l0 = sstep(*state, torch.from_numpy(x), torch.from_numpy(y))
    sp, _, ss, l1 = sstep(sp, _, ss, torch.from_numpy(x[::-1].copy()),
                          torch.from_numpy(y[::-1].copy()))
    assert abs(float(uloss) - (float(l0) + float(l1)) / 2) < 1e-7
    for n in sp:
        assert torch.equal(up[n], sp[n]), n
        assert torch.equal(us["mom"][n], ss["mom"][n]), n
    assert ustep._cache_size() == 1
    _same_as_jax(up, jp, [float(uloss)], [float(jloss)])


def test_donate_returns_the_static_dicts_and_copies_nothing_back():
    _, tnet, x, y = _mlp()
    step, p0, a0, s0 = _port_step(tnet, 0.1, momentum=0.9)
    assert p0 is step.params and s0 is step.opt_state
    w = p0[next(iter(p0))]
    p1, a1, s1, _ = step(p0, a0, s0, torch.from_numpy(x),
                         torch.from_numpy(y))
    assert p1 is p0 and a1 is a0 and s1 is s0
    # updated in place: the tensor the caller holds moved
    assert w is step.params[next(iter(p0))]
    before = w.clone()
    step(p1, a1, s1, torch.from_numpy(x), torch.from_numpy(y))
    assert not torch.equal(w, before)


def test_no_donate_leaves_the_inputs_untouched():
    _, tnet, x, y = _mlp()
    step, p0, a0, s0 = _port_step(tnet, 0.1, momentum=0.9, donate=False)
    assert p0 is not step.params
    keep = {n: v.clone() for n, v in p0.items()}
    p1, a1, s1, l1 = step(p0, a0, s0, torch.from_numpy(x),
                          torch.from_numpy(y))
    for n, v in p0.items():
        assert torch.equal(v, keep[n]), n
        assert p1[n] is not step.params[n]
    # the same inputs again give the same step, bit for bit
    p2, _, _, l2 = step(p0, a0, s0, torch.from_numpy(x),
                        torch.from_numpy(y))
    assert torch.equal(l1, l2)
    for n in p1:
        assert torch.equal(p1[n], p2[n]), n


def test_a_new_lr_builds_no_entry_and_takes_effect():
    _, tnet, x, y = _mlp()
    step, *state = _port_step(tnet, 0.1, donate=False)
    p1, _, _, _ = step(*state, torch.from_numpy(x), torch.from_numpy(y))
    p2, _, _, _ = step(*state, torch.from_numpy(x), torch.from_numpy(y),
                       lr=0.3)
    p3, _, _, _ = step(*state, torch.from_numpy(x), torch.from_numpy(y),
                       lr=torch.tensor(0.3))
    assert step._cache_size() == 1
    other, *ostate = _port_step(tnet, 0.3, donate=False)
    po, _, _, _ = other(*ostate, torch.from_numpy(x), torch.from_numpy(y))
    for n in po:
        assert torch.equal(p2[n], po[n]) and torch.equal(p3[n], po[n]), n
        assert not torch.equal(p1[n], po[n]), n


def test_a_new_x_shape_builds_one_entry():
    _, tnet, x, y = _mlp()
    step, *state = _port_step(tnet, 0.1, donate=False)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for _ in range(2):
        step(*state, xt, yt)
    assert step._cache_size() == 1
    step(*state, xt[:8], yt[:8])
    step(*state, xt[:8], yt[:8])
    assert step._cache_size() == 2
    with pytest.raises(TypeError):
        step(*state, xt, yt, key=1)
    with pytest.raises(ValueError):
        step({}, state[1], state[2], xt, yt)


def test_three_generators_share_one_entry_as_values():
    """``key`` is a value, as the reference's traced key is: three
    generators build one entry, two with the same state draw the same
    dropout, and each is advanced as an eager step advances it."""
    _, tnet, x, y = _mlp(dropout=0.5)
    step, *state = _port_step(tnet, 0.1, donate=False)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    gens = [torch.Generator().manual_seed(s) for s in (1, 2, 1)]
    losses = [step(*state, xt, yt, key=g)[3] for g in gens]
    assert step._cache_size() == 1
    assert torch.equal(losses[0], losses[2])
    assert not torch.equal(losses[0], losses[1])
    assert torch.equal(gens[0].get_state(), gens[2].get_state())
    assert not torch.equal(gens[0].get_state(),
                           torch.Generator().manual_seed(1).get_state())
    again = step(*state, xt, yt, key=gens[0])[3]
    assert not torch.equal(again, losses[0])
    assert step._cache_size() == 1


def test_dropout_draws_from_the_generator_and_a_reseed_repeats_them():
    """The word LM lane's dropout: each call advances the generator, and
    ``random.seed`` after the first call (after the capture, on the card)
    repeats a call's draws."""
    _, tnet, x, y = _mlp(dropout=0.5)
    step, *state = _port_step(tnet, 0.1, donate=False)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    tmx.random.seed(7)
    _, _, _, la = step(*state, xt, yt)
    _, _, _, lb = step(*state, xt, yt)
    assert not torch.equal(la, lb)
    tmx.random.seed(7)
    _, _, _, lc = step(*state, xt, yt)
    assert torch.equal(la, lc)
    assert step._cache_size() == 1


def test_data_parallel_trainer_matches_jax():
    jnet, tnet, x, y = _mlp()
    losses = []
    for mx, dp, net, X, Y in ((jmx, jdp, jnet, jnp.asarray(x),
                               jnp.asarray(y)),
                              (tmx, tdp, tnet, torch.from_numpy(x),
                               torch.from_numpy(y))):
        tr = dp.DataParallelTrainer(
            net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            {"learning_rate": 0.1, "momentum": 0.9})
        got = [float(tr.step(X, Y).asnumpy()) for _ in range(2)]
        tr.set_learning_rate(0.05)
        got.append(float(tr.step(X, Y).asnumpy()))
        losses.append(got)
        if mx is tmx:
            assert tr._step_fn._cache_size() == 1
            tp = tr._params
            tr.sync_to_net()
            w = net.collect_params()[next(iter(tp))].data()._data
            assert torch.equal(w, tp[next(iter(tp))])
            assert w.data_ptr() != tp[next(iter(tp))].data_ptr()
        else:
            jp = tr._params
    _same_as_jax(tp, jp, losses[1], losses[0])
