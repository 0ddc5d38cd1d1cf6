"""Custom operators (``operator.py``, ``nd.Custom``) of the PyTorch port
against the JAX package, on the CPU.

The same ops, written once over a package's ``nd`` (``_register_ops``),
go through both packages' ``nd.Custom`` on the same seeded inputs: the
reference test's ``scale_by_3``, MXNet's custom_softmax_rtc.py softmax
with its label and ``need_top_grad=False`` (through the port also with
``chip_smoke.py``'s twin-bodied op, the one the card's rtc run is held
to), a two-output op with an aux state, a variable with
``grad_req="add"``, and the fast path (``jax_forward`` against
``torch_forward``). Forward outputs and the gradients under ``record()``
agree within rtol 1e-6 (atol 1e-7) in float32. Then
``examples/train_mnist.py``'s MLP with the custom softmax as its head:
the same weights, batch 64, three SGD momentum-0.9 steps at lr 0.1
through ``gluon.Trainer``; losses and weights within rtol 1e-5. The JAX
side runs under ``jax.default_matmul_precision("highest")``.
"""
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

RTOL, ATOL = 1e-6, 1e-7
KWARGS_SEEN = []


def _register_ops(mx):
    """The test ops, over ``mx``'s nd, registered with ``mx.operator``."""
    op = mx.operator
    nd = mx.nd

    class ScaleOp(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * 3.0)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * 3.0)

    @op.register("scale_by_3")
    class ScaleProp(op.CustomOpProp):
        def list_arguments(self):
            return ["data"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return ScaleOp()

    class SoftmaxOp(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0]
            e = nd.exp(x - nd.max(x, axis=1, keepdims=True))
            self.assign(out_data[0], req[0],
                        e / nd.sum(e, axis=1, keepdims=True))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            self.assign(in_grad[0], req[0],
                        y - nd.one_hot(in_data[1], y.shape[1]))

    @op.register("nd_softmax")
    class SoftmaxProp(op.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], [in_shape[0][0]]], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return SoftmaxOp()

    class TwoOutOp(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            a, b = in_data
            self.assign(out_data[0], req[0], a + b)
            self.assign(out_data[1], req[1], a * b)
            self.assign(aux[0], "write", a * 2.0)     # read by backward

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            g_sum, g_prod = out_grad
            a = aux[0] / 2.0
            self.assign(in_grad[0], req[0], g_sum + g_prod * in_data[1])
            self.assign(in_grad[1], req[1], g_sum + g_prod * a)

    @op.register("two_out_aux")
    class TwoOutProp(op.CustomOpProp):
        def list_arguments(self):
            return ["a", "b"]

        def list_outputs(self):
            return ["sum", "prod"]

        def list_auxiliary_states(self):
            return ["saved"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]], [in_shape[0]]

        def create_operator(self, ctx, shapes, dtypes):
            return TwoOutOp()

    @op.register("kw_scale")
    class KwProp(op.CustomOpProp):
        def __init__(self, scale, tag="none"):
            super().__init__()
            KWARGS_SEEN.append((scale, tag))
            self.scale = scale

        def create_operator(self, ctx, shapes, dtypes):
            scale = self.scale

            class KwOp(op.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0] * scale)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0], out_grad[0] * scale)
            return KwOp()


_register_ops(jmx)
_register_ops(tmx)
chip_smoke.register_softmax_ops(tmx)


@jmx.operator.register("fast_square")
class _JaxFast(jmx.operator.CustomOpProp):
    def jax_forward(self, a):
        import jax.numpy as jnp
        return a * a + jnp.sin(a)


@tmx.operator.register("fast_square")
class _TorchFast(tmx.operator.CustomOpProp):
    def torch_forward(self, a):
        return a * a + torch.sin(a)


@tmx.operator.register("jax_only")
class _JaxOnly(tmx.operator.CustomOpProp):
    def jax_forward(self, a):
        return a


@tmx.operator.register("fast_pair")
class _TorchPair(tmx.operator.CustomOpProp):
    def list_outputs(self):
        return ["sum", "diff"]

    def torch_forward(self, a, b):
        return a + b, a - b


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _run(mx, op_type, inputs, heads_w, grad_req="write", rounds=1,
         **kwargs):
    """Forward under record() and backward of sum(w_i * out_i): (outputs,
    input gradients) as numpy."""
    xs = [mx.nd.array(a) for a in inputs]
    for x in xs:
        x.attach_grad(grad_req=grad_req)
    with jax.default_matmul_precision("highest"):
        for _ in range(rounds):
            with mx.autograd.record():
                outs = mx.nd.Custom(*xs, op_type=op_type, **kwargs)
                outs = list(outs) if isinstance(outs, (list, tuple)) \
                    else [outs]
                if heads_w is None:
                    head = outs[0]
                else:
                    head = sum((o * mx.nd.array(w)).sum()
                               for o, w in zip(outs, heads_w))
            head.backward()
    return ([o.asnumpy() for o in outs], [x.grad.asnumpy() for x in xs])


def _close(a, b):
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL)


def test_scale_by_3_matches_reference():
    x = _rand(3, 5)
    w = [_rand(3, 5, seed=1)]
    j = _run(jmx, "scale_by_3", [x], w)
    t = _run(tmx, "scale_by_3", [x], w)
    _close(j[0], t[0])
    _close(j[1], t[1])
    np.testing.assert_allclose(t[0][0], 3 * x, rtol=RTOL)
    np.testing.assert_allclose(t[1][0], 3 * w[0], rtol=RTOL)


def test_scale_by_3_unrecorded_as_in_the_reference_test():
    out = tmx.nd.Custom(tmx.nd.ones((2, 2)), op_type="scale_by_3")
    np.testing.assert_allclose(out.asnumpy(), 3.0)
    assert not out._data.requires_grad


@pytest.mark.parametrize("op_type", ["nd_softmax", "twin_softmax",
                                     "rtc_softmax"])
def test_softmax_with_label_no_top_grad(op_type):
    """MXNet's custom_softmax_rtc.py op: the head gradient is ignored
    (need_top_grad=False) and the data gradient is prob - onehot(label).
    On CPU arrays the rtc-bodied op runs its twins."""
    x = _rand(64, 10, seed=2)
    label = np.random.default_rng(3).integers(0, 10, 64).astype(np.float32)
    j = _run(jmx, "nd_softmax", [x, label], None)
    t = _run(tmx, op_type, [x, label], None)
    _close(j[0], t[0])
    _close(j[1][:1], t[1][:1])
    np.testing.assert_array_equal(t[1][1], np.zeros(64, np.float32))
    np.testing.assert_allclose(
        t[1][0], t[0][0] - np.eye(10, dtype=np.float32)[label.astype(int)],
        rtol=RTOL, atol=ATOL)


def test_two_outputs_with_an_aux_state():
    a, b = _rand(4, 6, seed=4), _rand(4, 6, seed=5)
    w = [_rand(4, 6, seed=6), _rand(4, 6, seed=7)]
    j = _run(jmx, "two_out_aux", [a, b], w)
    t = _run(tmx, "two_out_aux", [a, b], w)
    _close(j[0], t[0])
    _close(j[1], t[1])
    np.testing.assert_allclose(t[1][0], w[0] + w[1] * b, rtol=RTOL)
    np.testing.assert_allclose(t[1][1], w[0] + w[1] * a, rtol=RTOL)


def test_only_one_output_reaches_the_loss():
    """The other output's gradient arrives as zeros, in both packages."""
    a, b = _rand(4, 6, seed=8), _rand(4, 6, seed=9)
    w = [_rand(4, 6, seed=10), np.zeros((4, 6), np.float32)]
    for mx in (jmx, tmx):
        xs = [mx.nd.array(v) for v in (a, b)]
        for x in xs:
            x.attach_grad()
        with mx.autograd.record():
            s, _ = mx.nd.Custom(*xs, op_type="two_out_aux")
            head = (s * mx.nd.array(w[0])).sum()
        head.backward()
        for x in xs:
            np.testing.assert_allclose(x.grad.asnumpy(), w[0], rtol=RTOL)


def test_grad_req_add_accumulates():
    x = _rand(3, 4, seed=11)
    w = [_rand(3, 4, seed=12)]
    j = _run(jmx, "scale_by_3", [x], w, grad_req="add", rounds=2)
    t = _run(tmx, "scale_by_3", [x], w, grad_req="add", rounds=2)
    _close(j[1], t[1])
    np.testing.assert_allclose(t[1][0], 6 * w[0], rtol=RTOL)


@pytest.mark.parametrize("req", ["write", "inplace", "add", "null"])
def test_assign_by_req(req):
    dst0, src = _rand(2, 3, seed=13), _rand(2, 3, seed=14)
    got = []
    for mx in (jmx, tmx):
        dst = mx.nd.array(dst0)
        mx.operator.CustomOp().assign(dst, req, mx.nd.array(src))
        got.append(dst.asnumpy())
    np.testing.assert_allclose(got[1], got[0], rtol=RTOL)
    want = {"write": src, "inplace": src, "add": dst0 + src,
            "null": dst0}[req]
    np.testing.assert_allclose(got[1], want, rtol=RTOL)


def test_assign_rejects_an_unknown_req():
    with pytest.raises(ValueError, match="unknown req"):
        tmx.operator.CustomOp().assign(tmx.nd.zeros((2,)), "sum",
                                       tmx.nd.ones((2,)))


def test_fast_path_torch_forward_matches_jax_forward():
    x = _rand(3, 4, seed=15)
    w = [_rand(3, 4, seed=16)]
    j = _run(jmx, "fast_square", [x], w)
    t = _run(tmx, "fast_square", [x], w)
    _close(j[0], t[0])
    _close(j[1], t[1])
    np.testing.assert_allclose(t[1][0], w[0] * (2 * x + np.cos(x)),
                               rtol=1e-5)


def test_fast_path_with_two_outputs():
    a, b = _rand(2, 3, seed=17), _rand(2, 3, seed=18)
    s, d = tmx.nd.Custom(tmx.nd.array(a), tmx.nd.array(b),
                         op_type="fast_pair")
    np.testing.assert_allclose(s.asnumpy(), a + b, rtol=RTOL)
    np.testing.assert_allclose(d.asnumpy(), a - b, rtol=RTOL)


def test_a_jax_forward_alone_raises_naming_torch_forward():
    with pytest.raises(NotImplementedError, match="torch_forward"):
        tmx.nd.Custom(tmx.nd.ones((2,)), op_type="jax_only")


def test_kwargs_reach_the_prop_as_raw_values():
    """Both packages hand the prop the caller's values (MXNet would pass
    the strings "2.5" and "x"; ROADMAP.md section C)."""
    x = _rand(2, 3, seed=19)
    KWARGS_SEEN.clear()
    outs = [mx.nd.Custom(mx.nd.array(x), op_type="kw_scale", scale=2.5,
                         tag="x").asnumpy() for mx in (jmx, tmx)]
    assert KWARGS_SEEN == [(2.5, "x"), (2.5, "x")]
    assert all(type(s) is float for s, _ in KWARGS_SEEN)
    np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL)
    np.testing.assert_allclose(outs[1], 2.5 * x, rtol=RTOL)


def test_output_type_follows_infer_type_as_in_mxnet():
    """The port sizes the outputs by the prop's infer_type, as MXNet does
    (float16 in, float16 out); the JAX package makes every output float32
    (ROADMAP.md section C)."""
    x = _rand(2, 3, seed=20).astype(np.float16)
    outs = [mx.nd.Custom(mx.nd.array(x, dtype="float16"),
                         op_type="scale_by_3") for mx in (jmx, tmx)]
    assert [str(o.dtype) for o in outs] == ["float32", "float16"]
    np.testing.assert_allclose(outs[1].asnumpy(), outs[0].asnumpy(),
                               rtol=1e-3)


def test_unknown_or_missing_op_type_raises():
    with pytest.raises(KeyError):
        tmx.nd.Custom(tmx.nd.ones((2,)), op_type="no_such_op")
    with pytest.raises(ValueError, match="op_type"):
        tmx.nd.Custom(tmx.nd.ones((2,)))
    assert tmx.operator.get("scale_by_3").__name__ == "ScaleProp"
    assert tmx.CustomOp is tmx.operator.CustomOp
    assert tmx.register_op is tmx.operator.register


def test_backward_makes_its_buffers_on_the_inputs_device():
    """On the card PyTorch runs the backward on a thread of its own, where
    the caller's ``with mx.cpu()`` and recording state do not hold. Here
    the backward runs on a fresh thread, whose current context is the
    default card: without one, any array made on it raises, so this fails
    if the op's buffers are not placed on the inputs' device."""
    x = tmx.nd.array(_rand(4, 3, seed=21))
    label = tmx.nd.array(np.array([0, 1, 2, 0], np.float32))
    a, b = tmx.nd.array(_rand(4, 3, seed=22)), tmx.nd.array(_rand(4, 3))
    for v in (x, a, b):
        v.attach_grad()
    with tmx.autograd.record():
        p = tmx.nd.Custom(x, label, op_type="twin_softmax")
        s, q = tmx.nd.Custom(a, b, op_type="two_out_aux")
        head = s.sum() + q.sum()
    assert p._data.requires_grad and s._data.requires_grad
    errors = []

    def backward():
        try:
            assert tmx.current_context() == tmx.gpu(0)
            p.backward()
            head.backward()
        except Exception as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    worker = threading.Thread(target=backward)
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive() and not errors, errors
    assert x.grad.context == tmx.cpu() and a.grad.context == tmx.cpu()
    np.testing.assert_allclose(a.grad.asnumpy(), 1 + b.asnumpy(), rtol=RTOL)
    np.testing.assert_allclose(
        x.grad.asnumpy(), p.asnumpy() - np.eye(3, dtype=np.float32)[
            [0, 1, 2, 0]], rtol=RTOL, atol=ATOL)


# ------------------------------------------------- the MNIST MLP, 3 steps
def test_mnist_mlp_three_sgd_steps_match_reference():
    """examples/train_mnist.py's MLP (784-128-64-10) with the custom
    softmax as its head: the same weights crossed as numpy, three SGD
    momentum-0.9 steps at lr 0.1 through gluon.Trainer, batch 64; the
    port runs chip_smoke.py's twin-bodied op, the reference its nd body."""
    batches = chip_smoke.mnist_batches(0, 3)
    jmx.random.seed(0)
    jnet = chip_smoke.mnist_mlp(jmx)
    jnet.initialize(jmx.init.Xavier())
    tnet = chip_smoke.mnist_mlp(tmx)
    tnet.initialize(ctx=tmx.cpu())
    for pj, pt in zip(jnet.collect_params().values(),
                      tnet.collect_params().values()):
        pt.set_data(tmx.nd.array(pj.data().asnumpy()))
    with jax.default_matmul_precision("highest"):
        jl, jg = chip_smoke.mlp_train(jmx, jnet, "nd_softmax", batches,
                                      jmx.cpu())
    tl, tg = chip_smoke.mlp_train(tmx, tnet, "twin_softmax", batches,
                                  tmx.cpu())
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    # first-step gradients: within 1e-5 of each leaf's largest entry
    for a, b in zip(tg, jg):
        assert np.max(np.abs(a - b)) <= 1e-5 * np.max(np.abs(b))
    for pj, pt in zip(jnet.collect_params().values(),
                      tnet.collect_params().values()):
        np.testing.assert_allclose(pt.data().asnumpy(), pj.data().asnumpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=pj.name)
