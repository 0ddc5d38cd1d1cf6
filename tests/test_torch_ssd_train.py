"""The SSD slice as a whole on the CPU: ``models/ssd.py`` forward, targets,
loss and gradients, bench.py's functional SGD step, the ``Trainer`` +
``autograd.record()`` step and ``detect``, against the JAX package.

Both packages build the same net; the JAX net is initialised with Xavier
and its parameters cross by structural name with ``params_from_jax``.
Inputs are synthetic one-object scenes from a numpy seed. The JAX side
runs under ``jax.default_matmul_precision("highest")`` with its Pallas
detection kernels in interpret mode (``MXTPU_PALLAS=multibox_target,nms``)
and, for the channels-last ResNet backbone, ``MXTPU_S2D_STEM=0`` (the
port runs the stem convolution as it is). Tolerances (float32): forward
outputs 1e-5 of their largest entry; anchors, ``box_mask`` and
``cls_target`` identical, ``box_target`` within 1e-6; loss rtol 1e-5 and
every gradient within 1e-4 of the net's largest gradient entry; after
three SGD steps every parameter within 1e-4 (one Trainer step: 1e-5) of
max(1, its largest entry).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.models import ssd as jssd
from incubator_mxnet_tpu.ops import detection as jdet
from incubator_mxnet_tpu.parallel import dp as jdp
from incubator_mxnet_tpu_torch.gluon.utils import params_from_jax
from incubator_mxnet_tpu_torch.models import ssd as tssd
from incubator_mxnet_tpu_torch.ops import detection as tdet
from incubator_mxnet_tpu_torch.parallel import dp as tdp


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "multibox_target,nms")
    monkeypatch.setenv("MXTPU_S2D_STEM", "0")
    with jax.default_matmul_precision("highest"), tmx.cpu():
        yield


def _synth_batch(rng, batch, size=48):
    """Images with one bright square; label row (cls, x1, y1, x2, y2)."""
    imgs = rng.rand(batch, 3, size, size).astype(np.float32) * 0.2
    labels = np.full((batch, 2, 5), -1.0, np.float32)
    for i in range(batch):
        x0, y0 = rng.randint(4, size // 2, 2)
        w = rng.randint(size // 4, size // 2)
        cls = rng.randint(2)
        imgs[i, cls, y0:y0 + w, x0:x0 + w] += 0.7
        labels[i, 0] = [cls, x0 / size, y0 / size, (x0 + w) / size,
                        (y0 + w) / size]
    return imgs, labels


def _pair(build_j, build_t, x, seed=0):
    """(JAX net, port net) with the JAX net's Xavier weights in both."""
    jmx.random.seed(seed)
    with jmx.name.NameManager():
        jnet = build_j()
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x[:1]))
    with tmx.name.NameManager():
        tnet = build_t()
    params_from_jax(tnet, {k: p.data().asnumpy() for k, p in
                           jnet._collect_params_with_prefix().items()})
    return jnet, tnet


def _toys(x):
    return _pair(lambda: jssd.ssd_toy(classes=2),
                 lambda: tssd.ssd_toy(classes=2), x)


def _close(got, want, tol, name="", floor=1e-30):
    """Max error within ``tol`` of max(``floor``, the largest entry)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(np.abs(want).max(), floor)
    assert np.abs(got - want).max() <= tol * scale, \
        (name, np.abs(got - want).max(), scale)


def _functional_state(net, is_jax):
    """{collect_params name: value} of the trained and the auxiliary
    parameters, and the structural -> collect_params name map."""
    by_struct = net._collect_params_with_prefix()
    conv = (lambda v: v) if is_jax else (lambda v: v.detach())
    params = {p.name: conv(p.data()._data) for p in by_struct.values()
              if p.grad_req != "null"}
    aux = {p.name: conv(p.data()._data) for p in by_struct.values()
           if p.grad_req == "null"}
    return params, aux, {k: p.name for k, p in by_struct.items()}


def _j_value_and_grad(net):
    """bench.py's loss (bench.py:307-342) in float32 as one jitted
    value-and-gradient of (params, aux, x, y), with the head outputs and
    the targets beside the loss."""
    def pure_loss(p, aux, x, y):
        merged = dict(p)
        merged.update(aux)
        cls_p, box_p, anchors = jdp.functional_call(
            net, merged, x, training=True, rng_key=jax.random.PRNGKey(0))
        bt, bm, ct = jdet.multibox_target(
            anchors, y, jnp.transpose(cls_p, (0, 2, 1)),
            negative_mining_ratio=3.0, negative_mining_thresh=0.5)
        bt, bm, ct = map(jax.lax.stop_gradient, (bt, bm, ct))
        logp = cls_p - jax.nn.logsumexp(cls_p, axis=-1, keepdims=True)
        picked = jnp.take_along_axis(
            logp, jnp.maximum(ct, 0).astype(jnp.int32)[..., None],
            axis=-1)[..., 0]
        keep = (ct >= 0).astype(jnp.float32)
        n_valid = jnp.maximum(jnp.sum(keep, axis=1), 1.0)
        cls_loss = -jnp.sum(picked * keep, axis=1) / n_valid
        diff = jnp.abs((box_p - bt) * bm)
        sl1 = jnp.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
        loss = jnp.mean(cls_loss + jnp.sum(sl1, axis=1) / n_valid)
        return loss, (cls_p, box_p, anchors, bt, bm, ct)

    return jax.jit(jax.value_and_grad(pure_loss, has_aux=True))


@pytest.fixture(scope="module")
def toy():
    """ssd_toy(classes=2) in both packages with the same weights, a batch
    of two 48 x 48 scenes, and the jitted JAX loss and gradient."""
    imgs, labels = _synth_batch(np.random.RandomState(1), 2)
    with jax.default_matmul_precision("highest"), tmx.cpu():
        jnet, tnet = _toys(imgs)
    return dict(imgs=imgs, labels=labels, jnet=jnet, tnet=tnet,
                jgrad=_j_value_and_grad(jnet),
                jstate=_functional_state(jnet, True),
                tstate=_functional_state(tnet, False))


def _j_loss_and_grads(toy, params):
    jp, ja, _ = toy["jstate"]
    (loss, outs), grads = toy["jgrad"](
        jp if params is None else params, ja, jnp.asarray(toy["imgs"]),
        jnp.asarray(toy["labels"]))
    return float(loss), [np.asarray(o) for o in outs], grads


def test_ssd_toy_forward_targets_loss_and_gradients(toy):
    """The port's imperative route (record, SSD.targets, SSDMultiBoxLoss,
    backward) against the reference's loss and gradient."""
    tnet = toy["tnet"]
    x, y = tmx.nd.array(toy["imgs"]), tmx.nd.array(toy["labels"])
    with tmx.autograd.record():
        cls_preds, box_preds, anchors = tnet(x)
        bt, bm, ct = tnet.targets(anchors, y, cls_preds)
        loss = tssd.SSDMultiBoxLoss()(cls_preds, box_preds, ct, bt,
                                      bm).mean()
    loss.backward()
    grads = {p.name: p.grad().asnumpy() for p in
             tnet.collect_params().values() if p.grad_req != "null"}
    assert str(anchors.dtype) == "float32"
    jl, jo, jg = _j_loss_and_grads(toy, None)
    to = [t.asnumpy() for t in (cls_preds, box_preds, anchors, bt, bm, ct)]
    _close(to[0], jo[0], 1e-5, "cls")
    _close(to[1], jo[1], 1e-5, "box")
    np.testing.assert_array_equal(to[2], jo[2])
    np.testing.assert_allclose(to[3], jo[3], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(to[4], jo[4])
    np.testing.assert_array_equal(to[5], jo[5])
    assert (to[5] > 0).any() and (to[5] == 0).any() and (to[5] == -1).any()
    tl = float(loss.asnumpy())
    assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    # against the net's largest gradient entry: the biases of the
    # convolutions that feed a batch norm have gradients that are zero up
    # to rounding
    _, _, jnames = toy["jstate"]
    _, _, tnames = toy["tstate"]
    scale = max(np.abs(np.asarray(g)).max() for g in jg.values())
    for struct, jname in jnames.items():
        if jname in jg:
            err = np.abs(grads[tnames[struct]] - np.asarray(jg[jname])).max()
            assert err <= 1e-4 * scale, struct


def _t_sgd_step(net, params, aux, opt, x, y, lr):
    """bench.py's step built from the port's functional_call, its target
    op (the matcher's twin on the CPU), torch.autograd.grad and the
    functional SGD."""
    leaves = {n: v.detach().clone().requires_grad_(True)
              for n, v in params.items()}
    with torch.enable_grad():
        merged = dict(leaves)
        merged.update(aux)
        cls_p, box_p, anchors = tdp.functional_call(net, merged, x,
                                                    training=True)
        bt, bm, ct = tdet.multibox_target(
            anchors, y, cls_p.transpose(1, 2), negative_mining_ratio=3.0,
            negative_mining_thresh=0.5)
        loss = tssd.multibox_loss(cls_p, box_p, ct, bt, bm).mean()
        grads = torch.autograd.grad(loss, list(leaves.values()))
    params, opt = tdp._sgd_update(params, dict(zip(leaves, grads)), opt, lr,
                                  0.0, 0.9)
    return params, opt, float(loss.detach())


def test_three_functional_sgd_steps_match_jax(toy):
    """Three of bench.py's SGD steps (momentum 0.9) in both packages."""
    jp, ja, jnames = toy["jstate"]
    tp, ta, tnames = toy["tstate"]
    assert sorted(jnames) == sorted(tnames)
    jo, to = jdp._sgd_init(jp, 0.9), tdp._sgd_init(tp, 0.9)
    tx = torch.from_numpy(toy["imgs"])
    ty = torch.from_numpy(toy["labels"])
    lr = 0.05
    for _ in range(3):
        jl, _, jg = _j_loss_and_grads(toy, jp)
        jp, jo = jdp._sgd_update(jp, jg, jo, jnp.asarray(lr, jnp.float32),
                                 0.0, 0.9)
        tp, to, tl = _t_sgd_step(toy["tnet"], tp, ta, to, tx, ty, lr)
        assert np.isfinite(tl) and abs(tl - jl) <= 1e-4 * abs(jl), (tl, jl)
    for struct, jname in jnames.items():
        if jname in jp:
            _close(tp[tnames[struct]].numpy(), np.asarray(jp[jname]), 1e-4,
                   struct, floor=1.0)


def test_trainer_record_step_and_detect_match_jax(toy):
    """One Trainer + record() step (SGD lr 0.1: w - lr * grad / batch)
    against the reference's gradient, then detect on the new weights."""
    with tmx.name.NameManager():
        tnet = tssd.ssd_toy(classes=2)
    params_from_jax(tnet, {k: np.asarray(p.data()._data) for k, p in
                           toy["jnet"]._collect_params_with_prefix().items()})
    imgs, labels = toy["imgs"], toy["labels"]
    trainer = tmx.gluon.Trainer(tnet.collect_params(), "sgd",
                                {"learning_rate": 0.1})
    x, y = tmx.nd.array(imgs), tmx.nd.array(labels)
    with tmx.autograd.record():
        cls_preds, box_preds, anchors = tnet(x)
        bt, bm, ct = tnet.targets(anchors, y, cls_preds)
        loss = tssd.SSDMultiBoxLoss()(cls_preds, box_preds, ct, bt,
                                      bm).mean()
    loss.backward()
    trainer.step(2)
    jl, _, jg = _j_loss_and_grads(toy, None)
    assert abs(float(loss.asnumpy()) - jl) <= 1e-5 * abs(jl)
    jp, _, jnames = toy["jstate"]
    tw = tnet._collect_params_with_prefix()
    for struct, jname in jnames.items():
        if jname in jp:
            want = np.asarray(jp[jname]) - 0.1 * np.asarray(jg[jname]) / 2
            _close(tw[struct].data().asnumpy(), want, 1e-5, struct,
                   floor=1.0)
    # detect = forward, softmax, MultiBoxDetection at the net's NMS
    # settings. The two frameworks' softmax can split a score tie by an
    # ulp, which reorders rows, so the reference decodes the port's own
    # class probabilities.
    td = tnet.detect(x).asnumpy()
    cls_preds, box_preds, anchors = tnet(x)
    prob = tmx.nd.softmax(cls_preds, axis=-1).transpose((0, 2, 1))
    jd = np.asarray(jdet.multibox_detection(
        jnp.asarray(prob.asnumpy()), jnp.asarray(box_preds.asnumpy()),
        jnp.asarray(anchors.asnumpy()), nms_threshold=0.45, nms_topk=400,
        threshold=0.01))
    assert td.shape == jd.shape and td.shape[2] == 6
    np.testing.assert_array_equal(td[..., 0], jd[..., 0])
    np.testing.assert_allclose(td[..., 1:], jd[..., 1:], rtol=1e-6,
                               atol=1e-6)
    assert (td[..., 0] >= 0).any()


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_ssd_512_resnet50_forward_matches_jax(layout):
    x = np.random.RandomState(0).rand(1, 3, 64, 64).astype(np.float32)
    jnet, tnet = _pair(
        lambda: jssd.ssd_512_resnet50_v1(classes=3, layout=layout),
        lambda: tssd.ssd_512_resnet50_v1(classes=3, layout=layout), x)
    jo = [t.asnumpy() for t in jnet(jmx.nd.array(x))]
    to = [t.asnumpy() for t in tnet(tmx.nd.array(x))]
    assert [t.shape for t in to] == [t.shape for t in jo]
    # 64 x 64 in: stage 3 at 4 x 4, stage 4 at 2 x 2, four 1 x 1 extras
    assert to[2].shape == (1, 4 ** 2 * 4 + 2 ** 2 * 4 + 4 * 6, 4)
    _close(to[0], jo[0], 1e-5, "cls")
    _close(to[1], jo[1], 1e-5, "box")
    np.testing.assert_array_equal(to[2], jo[2])


def test_ssd_512_taps_and_anchor_count_at_full_size():
    """The taps are stage 3 and stage 4 of ResNet-50's feature stack, and
    at 512 x 512 the six scales give SSD-512's 5630 anchors."""
    with tmx.name.NameManager():
        net = tssd.ssd_512_resnet50_v1(classes=20)
    kids = list(net.backbone._children.values())
    assert net.feature_taps == [6, 7]
    assert [k.prefix for k in kids[4:8]] == [
        f"stage{i}_" for i in range(1, 5)] or len(kids) == 9
    per_scale = [(len(s) + len(r) - 1) * (512 // st) ** 2 for s, r, st in
                 zip(net.sizes, net.ratios, (16, 32, 64, 128, 256, 512))]
    assert sum(per_scale) == 5630


def test_vgg16_forward_matches_jax_and_ssd_300_runs():
    from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
    x = np.random.RandomState(4).rand(1, 3, 32, 32).astype(np.float32)
    jnet, tnet = _pair(lambda: jvision.vgg11(classes=10),
                       lambda: tmx.gluon.model_zoo.get_model(
                           "vgg11", classes=10), x)
    _close(tnet(tmx.nd.array(x)).asnumpy(),
           jnet(jmx.nd.array(x)).asnumpy(), 1e-5, "vgg11")
    for name in ("vgg16", "vgg13_bn", "vgg19"):
        with tmx.name.NameManager():
            net = tmx.gluon.model_zoo.get_model(name)
        assert type(net).__name__ == "VGG"
    # the JAX package taps the Flatten and fails; the port taps the pool
    with jmx.name.NameManager():
        jssd300 = jssd.ssd_300_vgg16_atrous(classes=3)
    jssd300.initialize()
    with pytest.raises(TypeError):
        jssd300(jmx.nd.array(np.zeros((1, 3, 64, 64), np.float32)))
    with tmx.name.NameManager():
        net = tssd.ssd_300_vgg16_atrous(classes=3)
    net.initialize(tmx.init.Xavier())
    cls_preds, box_preds, anchors = net(tmx.nd.array(
        np.zeros((1, 3, 64, 64), np.float32)))
    assert cls_preds.shape == (1, anchors.shape[1], 4)
    assert box_preds.shape == (1, anchors.shape[1] * 4)


def test_ssd_trains_loss_decreases():
    """The port's twin of the reference's tier-1 convergence test: 10 SGD
    steps at lr 0.15 on 48px scenes, the multibox loss falls and detect()
    stays runnable."""
    rng = np.random.RandomState(0)
    tmx.random.seed(0)
    with tmx.name.NameManager():
        net = tssd.ssd_toy(classes=2)
    net.initialize(tmx.init.Xavier())
    net.hybridize()
    loss_fn = tssd.SSDMultiBoxLoss()
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.15})
    losses = []
    for _ in range(10):
        imgs, labels = _synth_batch(rng, 4)
        x, y = tmx.nd.array(imgs), tmx.nd.array(labels[:, :1])
        with tmx.autograd.record():
            cls_preds, box_preds, anchors = net(x)
            bt, bm, ct = net.targets(anchors, y, cls_preds)
            loss = loss_fn(cls_preds, box_preds, ct, bt, bm).mean()
        loss.backward()
        trainer.step(4)
        losses.append(float(loss.asnumpy()))
    assert np.all(np.isfinite(losses)), losses
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) * 0.8, losses
    det = net.detect(tmx.nd.array(imgs[:1])).asnumpy()
    assert det.shape[0] == 1 and det.shape[2] == 6
    assert np.all(np.isfinite(det))


def test_targets_carry_no_gradient_under_record():
    imgs, labels = _synth_batch(np.random.RandomState(5), 2)
    _, tnet = _toys(imgs)
    with tmx.autograd.record():
        cls_preds, _, anchors = tnet(tmx.nd.array(imgs))
        outs = tnet.targets(anchors, tmx.nd.array(labels), cls_preds)
    assert cls_preds.tensor.requires_grad
    assert not any(t.tensor.requires_grad for t in outs)
