"""``hybridize()`` as a compiled forward (``gluon/block.py``), on the CPU.

On the card a hybridized block called outside ``autograd.record()`` runs
one CUDA graph a (input tree, shapes and types, training) key over static
inputs and static copies of its parameters; on the CPU the same forward
runs eagerly on the same buffers. These tests hold that path against a
twin net that is never hybridized (the same parameters, copied in), after
the parameters were rebound (``Trainer.step``, ``load_parameters``) or
written in place, and count its entries. Values are equal bit for bit:
the same forward runs on the same values.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as tmx

nn = tmx.gluon.nn


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _net(dropout=0.0):
    with tmx.name.NameManager():
        net = nn.HybridSequential()
        net.add(nn.Dense(16), nn.BatchNorm(), nn.Activation("relu"))
        if dropout:
            net.add(nn.Dropout(dropout))
        net.add(nn.Dense(4))
    return net


def _pair(dropout=0.0, x=None):
    """A hybridized net and its never-hybridized twin, same parameters."""
    tmx.random.seed(1)
    hyb, twin = _net(dropout), _net(dropout)
    for net in (hyb, twin):
        net.initialize(tmx.init.Xavier())
        net(x if x is not None else tmx.nd.ones((2, 6)))
    _sync(hyb, twin)
    hyb.hybridize()
    return hyb, twin


def _sync(src, dst):
    for a, b in zip(src.collect_params().values(),
                    dst.collect_params().values()):
        b.set_data(a.data().copy())


def _x(*shape, seed=0):
    return tmx.nd.array(np.random.RandomState(seed).rand(*shape)
                        .astype(np.float32))


def _same(a, b):
    assert torch.equal(a._data, b._data)


def test_one_entry_per_tree_shapes_and_training_key():
    hyb, _ = _pair()
    x = _x(4, 6)
    hyb(x)
    hyb(_x(4, 6, seed=1))
    assert len(hyb._static.entries) == 1
    hyb(_x(3, 6))
    assert len(hyb._static.entries) == 2
    with tmx.autograd.train_mode():
        hyb(x)
        hyb(x)
    assert len(hyb._static.entries) == 3
    # the children run inside their parent's forward, eagerly
    assert all(getattr(c, "_static", None) is None
               for c in hyb._children.values())


def test_an_argument_tree_is_part_of_the_key():
    class Two(tmx.gluon.HybridBlock):
        def hybrid_forward(self, F, a, pair):
            return a + pair[0] * pair[1]
    with tmx.name.NameManager():
        blk = Two()
    blk.hybridize()
    a, b = _x(2, 3), _x(2, 3, seed=1)
    out = blk(a, [b, b])
    np.testing.assert_array_equal(out.asnumpy(),
                                  a.asnumpy() + b.asnumpy() ** 2)
    blk(a, (b, b))
    assert len(blk._static.entries) == 2
    # a python value in the call is not baked in: that call stays eager
    blk(a, [b, 2.0])
    assert len(blk._static.entries) == 2


def test_outputs_follow_a_trainer_step_and_load_parameters(tmp_path):
    hyb, twin = _pair()
    x = _x(4, 6)
    _same(hyb(x), twin(x))
    trainer = tmx.gluon.Trainer(hyb.collect_params(), "sgd",
                                {"learning_rate": 0.5})
    for _ in range(2):
        with tmx.autograd.record():
            loss = (hyb(x) ** 2).mean()
        loss.backward()
        trainer.step(4)
        _sync(hyb, twin)
        _same(hyb(x), twin(x))
    path = str(tmp_path / "w.params")
    other, _ = _pair()
    for p in other.collect_params().values():
        if p.grad_req != "null":
            p.set_data(p.data() * 3)
    other.save_parameters(path)
    hyb.load_parameters(path)
    twin.load_parameters(path)
    _same(hyb(x), twin(x))
    assert len(hyb._static.entries) == 1


def test_outputs_follow_an_in_place_write():
    hyb, twin = _pair()
    x = _x(4, 6)
    hyb(x)
    w = list(hyb.collect_params().values())[0].data()
    w[:] = w * 0.5                     # same tensor object or a rebind
    _sync(hyb, twin)
    _same(hyb(x), twin(x))


def test_a_recording_call_stays_on_the_tape():
    hyb, twin = _pair()
    x = _x(4, 6)
    grads = []
    for net in (hyb, twin):
        with tmx.autograd.record():
            out = net(x)
            loss = (out ** 2).mean()
        assert out._data.requires_grad
        loss.backward()
        grads.append([p.grad().asnumpy()
                      for p in net.collect_params().values()
                      if p.grad_req != "null"])
    assert hyb._static is None
    for a, b in zip(*grads):
        np.testing.assert_array_equal(a, b)


def test_a_training_forward_writes_the_running_statistics_once():
    hyb, twin = _pair()
    x = _x(4, 6)
    for _ in range(2):
        with tmx.autograd.train_mode():
            _same(hyb(x), twin(x))
    stats = [n for n in hyb.collect_params() if "running" in n]
    assert stats
    for a, b in zip(hyb.collect_params().values(),
                    twin.collect_params().values()):
        assert torch.equal(a.data()._data, b.data()._data), a.name
    # an inference call reads them and writes nothing
    before = [hyb.collect_params()[n].data()._data for n in stats]
    _same(hyb(x), twin(x))
    for n, t in zip(stats, before):
        assert hyb.collect_params()[n].data()._data is t


def test_outputs_are_new_arrays_at_every_call():
    hyb, _ = _pair()
    a = hyb(_x(4, 6))
    keep = a.asnumpy().copy()
    hyb(_x(4, 6, seed=3))
    np.testing.assert_array_equal(a.asnumpy(), keep)


def test_dropout_draws_as_the_eager_net_does():
    hyb, twin = _pair(dropout=0.5)
    x = _x(4, 6)
    outs = []
    for net in (hyb, twin):
        tmx.random.seed(3)
        with tmx.autograd.train_mode():
            outs.append([net(x), net(x)])
    _same(outs[0][0], outs[1][0])
    _same(outs[0][1], outs[1][1])
    assert not torch.equal(outs[0][0]._data, outs[0][1]._data)


def test_deferred_shapes_resolve_before_the_compiled_forward():
    with tmx.name.NameManager():
        net = nn.HybridSequential()
        net.add(nn.Dense(5), nn.Dense(3))
    net.initialize()
    net.hybridize()
    out = net(_x(2, 7))
    assert out.shape == (2, 3) and len(net._static.entries) == 1
    assert net[0].weight.shape == (5, 7)


def test_generators_share_one_entry_and_advance_as_eager():
    """The entry draws from its own generator, which takes the device
    generator's state (a ``use_generator`` scope's too) before the call
    and hands it back after: two scopes share one entry, and each is
    advanced as the eager net advances it."""
    hyb, twin = _pair(dropout=0.5)
    x = _x(4, 6)
    got = {}
    for name, net in (("hyb", hyb), ("twin", twin)):
        gens = [torch.Generator().manual_seed(s) for s in (5, 6)]
        outs = []
        with tmx.autograd.train_mode():
            for g in gens:
                with tmx.random.use_generator(g):
                    outs.append(net(x))
        got[name] = (outs, [g.get_state() for g in gens])
    assert len(hyb._static.entries) == 1
    for a, b in zip(got["hyb"][0], got["twin"][0]):
        _same(a, b)
    for a, b in zip(got["hyb"][1], got["twin"][1]):
        assert torch.equal(a, b)


def test_forward_constants_are_made_on_the_device(monkeypatch):
    """The ops a hybridized forward reaches build their constants by fills
    on the device, never as ``torch.tensor`` of host values (a copy from
    host memory, which a CUDA graph capture refuses): the SSD's anchors,
    ``div_sqrt_dim``, ``ravel_multi_index`` and the flash attention's
    scaled query give the same values with ``torch.tensor`` barred."""
    from incubator_mxnet_tpu_torch.ops import detection as det
    from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa
    x = _x(2, 3, 4)
    idx = tmx.nd.array(np.array([[0, 2, 1], [3, 0, 2]], np.int32))
    want = (det.multibox_prior(4, 5, (0.3, 0.6), (1.0, 2.0, 0.5)),
            tmx.nd.contrib.div_sqrt_dim(x)._data,
            fa._scaled_query(x._data, 0.125),
            tmx.nd.ravel_multi_index(idx, shape=(3, 4))._data)
    real = torch.tensor

    def barred(*a, **k):
        raise AssertionError("torch.tensor on a forward path")
    monkeypatch.setattr(torch, "tensor", barred)
    got = (det.multibox_prior(4, 5, (0.3, 0.6), (1.0, 2.0, 0.5)),
           tmx.nd.contrib.div_sqrt_dim(x)._data,
           fa._scaled_query(x._data, 0.125),
           tmx.nd.ravel_multi_index(idx, shape=(3, 4))._data)
    monkeypatch.setattr(torch, "tensor", real)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
