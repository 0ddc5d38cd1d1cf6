"""The slice as a whole on the CPU: the fused ResNet stage
(``gluon/model_zoo/vision/_fused_resnet.py``) and the functional train step
(``parallel/dp.py``) against the JAX package.

Both packages build the same small NHWC ``ResNetV1(BottleneckV1, [2, 2],
[16, 32, 64])`` (mid widths 8 and 16), the JAX net initialised with
Xavier and its parameters carried across with ``params_from_jax``; the
port runs the plain twins of its CUDA kernels (CPU tensors). Inputs are
batch 4 at 32 x 32 from a numpy seed. ``MXTPU_FUSED_MIN_MID=8`` lets both
stages fuse, ``MXTPU_FUSED_RESNET=1`` turns the fused path on. The JAX
side runs under ``jax.default_matmul_precision("highest")`` with its own
dispatch (XLA twins at these widths: the same values as its Pallas
kernels, which ``test_torch_conv_fused.py`` holds the port's twins to).

This depth and batch is not chaotic: the whole-net gradients of the two
packages agree to ~1e-5 of each leaf's largest entry, where the reference
warns that ResNet-50 at 64 x 64 in float32 is (``tests/test_fused_resnet.py
:454-458``). Tolerances: stage outputs and gradients 1e-4 of the largest
entry; the loss rtol 1e-5; every whole-net gradient leaf and every
parameter after an SGD step within 1e-4 of its largest entry; the conv
biases right before a BatchNorm, whose gradients are float noise on both
sides, within 1e-4 of the largest gradient of all leaves (their values
within 1e-6); the bf16 compute step within 2e-2.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.gluon.model_zoo.vision import _fused_resnet as jfr
from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jres
from incubator_mxnet_tpu.parallel import dp as jdp
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import \
    _fused_resnet as tfr
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from incubator_mxnet_tpu_torch.gluon.utils import params_from_jax
from incubator_mxnet_tpu_torch.parallel import dp as tdp

B, HW = 4, 32


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


@pytest.fixture(scope="module")
def nets():
    rs = np.random.RandomState(0)
    x = rs.rand(B, 3, HW, HW).astype(np.float32)
    y = rs.randint(0, 10, (B,)).astype(np.int32)
    jmx.random.seed(0)
    jnet = _make(jmx, jres)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x[:1]))
    with tmx.cpu():
        tnet = _make(tmx, tres)
        tnet.initialize()
        params_from_jax(tnet, {k: np.asarray(p.data().asnumpy()) for k, p in
                               jnet._collect_params_with_prefix().items()})
    return jnet, tnet, x, y


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12)


def _noise(name):
    """A conv bias right before a BatchNorm: BN subtracts the batch mean,
    so its gradient is zero up to float noise on both sides."""
    return name.startswith("bias") or ("_stage" in name
                                       and name.endswith("_bias"))


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) \
        else np.asarray(jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("conv_dgrad", ["off", "on"])
@pytest.mark.parametrize("stage_idx,stride", [(4, 1), (5, 2)])
def test_fused_stage_forward_and_vjp_match_jax(nets, stage_idx, stride,
                                                conv_dgrad, monkeypatch):
    """The port's block 0 always sums its conv1 and projection dgrads in
    one ``dgrad_epilogue``; the reference does so with its ``conv_dgrad``
    gate on and adds two ``mm_fused_bwd`` results with it off. Both
    reference branches give the port's values."""
    if conv_dgrad == "on":
        monkeypatch.setenv("MXTPU_PALLAS", "conv_dgrad")
    jnet, tnet, _, _ = nets
    jblocks = list(list(jnet.features._children.values())[stage_idx]
                   ._children.values())
    tblocks = list(list(tnet.features._children.values())[stage_idx]
                   ._children.values())
    cin = jblocks[0].body[0].weight.shape[-1]
    rs = np.random.RandomState(stage_idx)
    x = rs.rand(B, 8, 8, cin).astype(np.float32)
    jparams = jfr.stage_params_from_blocks(jblocks)
    with jax.default_matmul_precision("highest"):
        jy, vjp = jax.vjp(lambda xv, pl: jfr.fused_stage(stride, xv, pl)[0],
                          jnp.asarray(x), jparams)
        ct = rs.randn(*jy.shape).astype(np.float32)
        jdx, jdp_ = vjp(jnp.asarray(ct))
    tparams = [{k: v.detach().clone().requires_grad_(True)
                for k, v in d.items()}
               for d in tfr.stage_params_from_blocks(tblocks)]
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, stats = tfr.fused_stage(stride, tx, tparams)
    assert not any(t.requires_grad for pair in stats for t in pair)
    leaves = [v for d in tparams for v in d.values()]
    grads = torch.autograd.grad(ty, [tx] + leaves, torch.from_numpy(ct))
    assert _rel(_np(ty), jy) < 1e-4
    assert _rel(_np(grads[0]), jdx) < 1e-4
    flat = iter(grads[1:])
    scale = max(float(jnp.max(jnp.abs(v))) for d in jdp_ for v in d.values())
    for i, d in enumerate(tparams):
        for k in d:
            got, want = _np(next(flat)), np.asarray(jdp_[i][k])
            if _noise(k):
                assert np.max(np.abs(got - want)) < 1e-4 * scale, (i, k)
            else:
                assert _rel(got, want) < 1e-4, (i, k)


def _jax_grads(jnet, x, y):
    loss_fn = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    allp = jnet.collect_params()
    params = {n: p.data()._data for n, p in allp.items()
              if p.grad_req != "null"}
    aux = {n: p.data()._data for n, p in allp.items()
           if p.grad_req == "null"}

    def loss_of(p):
        out = jdp.functional_call(jnet, {**p, **aux},
                                  jmx.nd.array(x)._data, training=True,
                                  rng_key=jax.random.PRNGKey(0))
        return jnp.mean(loss_fn(jmx.nd.NDArray(out, _direct=True),
                                jmx.nd.array(y))._data)
    with jax.default_matmul_precision("highest"):
        return jax.value_and_grad(loss_of)(params)


def test_train_step_loss_and_every_gradient_match_jax(nets, monkeypatch):
    jnet, tnet, x, y = nets
    jloss, jgrads = _jax_grads(jnet, x, y)
    calls = []
    real = tfr.fused_stage
    monkeypatch.setattr(tfr, "fused_stage",
                        lambda *a: calls.append(1) or real(*a))
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    allp = tnet.collect_params()
    leaves = {n: p.data()._data.detach().clone().requires_grad_(True)
              for n, p in allp.items() if p.grad_req != "null"}
    aux = {n: p.data()._data.clone() for n, p in allp.items()
           if p.grad_req == "null"}
    loss = tdp._forward_loss(tnet, loss_fn, {**leaves, **aux},
                             torch.from_numpy(x), torch.from_numpy(y), None)
    assert len(calls) == 2                # both stages took the fused path
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert set(leaves) == set(jgrads)
    scale = max(float(jnp.max(jnp.abs(v))) for v in jgrads.values())
    for (n, g) in zip(leaves, grads):
        if _noise(n):
            assert np.max(np.abs(_np(g) - np.asarray(jgrads[n]))) \
                < 1e-4 * scale, n
        else:
            assert _rel(_np(g), jgrads[n]) < 1e-4, n


def test_make_train_step_matches_jax(nets):
    jnet, tnet, x, y = nets
    loss_fn = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    jstep, jp, ja, js = jdp.make_train_step(
        jnet, loss_fn, optimizer="sgd", learning_rate=0.05, momentum=0.9,
        donate=False)
    with jax.default_matmul_precision("highest"):
        for _ in range(2):
            jp, ja, js, jl = jstep(jp, ja, js, jnp.asarray(x),
                                   jnp.asarray(y), jax.random.PRNGKey(0),
                                   jnp.float32(0.05))
    tstep, tp, ta, ts = tdp.make_train_step(
        tnet, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
        learning_rate=0.05, momentum=0.9)
    for _ in range(2):
        tp, ta, ts, tl = tstep(tp, ta, ts, torch.from_numpy(x),
                               torch.from_numpy(y))
    assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl))
    for n in jp:
        if _noise(n):                 # zero at init, moved by noise only
            assert np.max(np.abs(_np(tp[n]) - np.asarray(jp[n]))) < 1e-6, n
        else:
            assert _rel(_np(tp[n]), jp[n]) < 1e-4, n
    # the forward's BatchNorm running-stat writes come back as the aux
    for n in ja:
        assert _rel(_np(ta[n]), ja[n]) < 1e-4, n
    moved = [n for n in ta if "running" in n
             and not np.allclose(_np(ta[n]), _np(
                 tnet.collect_params()[n].data()._data))]
    assert len(moved) == len(ta)


def test_bf16_compute_keeps_float32_masters(nets):
    jnet, tnet, x, y = nets
    jstep, jp, ja, js = jdp.make_train_step(
        jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
        learning_rate=0.05, momentum=0.9, compute_dtype=jnp.bfloat16,
        donate=False)
    jp, ja, js, jl = jstep(jp, ja, js, jnp.asarray(x), jnp.asarray(y),
                           jax.random.PRNGKey(0), jnp.float32(0.05))
    tstep, tp, ta, ts = tdp.make_train_step(
        tnet, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
        learning_rate=0.05, momentum=0.9, compute_dtype=torch.bfloat16)
    tp, ta, ts, tl = tstep(tp, ta, ts, torch.from_numpy(x),
                           torch.from_numpy(y))
    assert tl.dtype == torch.float32
    assert all(v.dtype == torch.float32 for v in tp.values())
    assert all(v.dtype == torch.float32 for v in ta.values())
    assert all(v.dtype == torch.float32 for v in ts["mom"].values())
    assert abs(float(tl) - float(jl)) <= 2e-2 * abs(float(jl))
    for n in ("resnetv10_stage2_conv2d0_weight", "resnetv10_dense0_weight"):
        assert _rel(_np(tp[n]), jp[n]) < 2e-2, n


def test_functional_call_differentiates_with_recording_off(nets,
                                                           monkeypatch):
    """The grad-mode trap: nd ops run under ``torch.no_grad`` when MXNet
    is not recording, and the fused path runs only when not recording. A
    functional call keeps recording off and the caller's grad mode on, so
    the fused stages run AND autograd sees them; an eager forward under
    ``record()`` takes the per-block path; an eager forward outside both
    builds no graph."""
    _, tnet, x, _ = nets
    seen = []
    real = tfr.fused_stage

    def spy(*a):
        seen.append(tmx.autograd.is_recording())
        return real(*a)
    monkeypatch.setattr(tfr, "fused_stage", spy)
    allp = tnet.collect_params()
    vals = {n: p.data()._data.detach().clone().requires_grad_(
        p.grad_req != "null") for n, p in allp.items()}
    out = tdp.functional_call(tnet, vals, torch.from_numpy(x))
    assert seen == [False, False] and out.requires_grad
    g = torch.autograd.grad(out.sum(), vals["resnetv10_stage1_conv2d0_weight"])
    assert float(g[0].abs().sum()) > 0
    seen.clear()
    with tmx.autograd.record():
        rec = tnet(tmx.nd.array(x))
    assert seen == [] and rec._data.requires_grad
    with tmx.autograd.pause(train_mode=True):
        eager = tnet(tmx.nd.array(x))
    assert seen == [False, False] and not eager._data.requires_grad
    np.testing.assert_allclose(eager.asnumpy(), rec.asnumpy(), rtol=1e-4,
                               atol=1e-5)


def test_fused_forward_updates_moving_stats_like_batchnorm(nets,
                                                           monkeypatch):
    """An eager training forward through the fused stages moves the
    running statistics by the rule of nn.BatchNorm: the same values as the
    per-block path's writes."""
    _, tnet, x, _ = nets
    names = [n for n in tnet.collect_params() if "running" in n
             and "stage" in n]
    before = {n: tnet.collect_params()[n].data().asnumpy().copy()
              for n in names}
    after = {}
    for fused in ("1", "0"):
        monkeypatch.setenv("MXTPU_FUSED_RESNET", fused)
        for n in names:
            tnet.collect_params()[n].data()._set_data(
                torch.from_numpy(before[n]))
        with tmx.autograd.pause(train_mode=True):
            tnet(tmx.nd.array(x))
        after[fused] = {n: tnet.collect_params()[n].data().asnumpy().copy()
                        for n in names}
    for n in names:
        assert not np.allclose(after["1"][n], before[n]), n
        np.testing.assert_allclose(after["1"][n], after["0"][n], rtol=1e-4,
                                   atol=1e-5, err_msg=n)


def test_dispatch_rules_follow_the_reference(monkeypatch):
    assert tfr.fused_path_enabled("NHWC", True)
    assert not tfr.fused_path_enabled("NCHW", True)
    assert not tfr.fused_path_enabled("NHWC", False)
    monkeypatch.setenv("MXTPU_FUSED_RESNET", "0")
    assert not tfr.fused_path_enabled("NHWC", True)
    with tmx.name.NameManager():
        bn_net = tres.ResNetV1(tres.BottleneckV1, [2], [16, 32],
                               layout="NHWC")
    blk = list(bn_net.features._children.values())[4]
    assert tfr.stage_bns_use_default_hparams(list(blk._children.values()))
    list(blk._children.values())[0].body[1]._epsilon = 1e-3
    assert not tfr.stage_bns_use_default_hparams(
        list(blk._children.values()))


def test_not_ported_pieces_raise():
    with pytest.raises(NotImplementedError, match="A10"):
        tdp.make_train_step(None, None, mesh=object())
    with pytest.raises(ValueError, match="unknown remat policy"):
        with tmx.name.NameManager():
            net = tmx.gluon.nn.Dense(2, in_units=2)
        net.initialize()
        tdp.make_train_step(net, None, remat="bogus")
    with pytest.raises(NotImplementedError, match="A11"):
        tdp.export_train_step(None, None, "x", None, None)
    with pytest.raises(NotImplementedError, match="A6"):
        tmx.gluon.model_zoo.get_model("alexnet")
    assert isinstance(tmx.gluon.model_zoo.get_model("resnet18_v2"),
                      tres.ResNetV2)
