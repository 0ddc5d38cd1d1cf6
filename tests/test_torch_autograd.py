"""The port's ``autograd`` (built on PyTorch's autograd) against the JAX
package's ``autograd`` (its own tape of ``jax.vjp`` closures), on the CPU.

Each scenario runs the same ``nd`` + ``autograd`` calls through both
packages and compares gradients (1e-5) and the recording / training flags.
Second-order gradients (``grad(..., create_graph=True)``) are held to the
analytic values and to ``jax.grad`` of ``jax.grad``: the reference's tape
does not record its own backward, so differentiating its gradients again
gives zeros (``ROADMAP.md`` section C).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

X = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)
W = np.random.default_rng(1).standard_normal((4, 2)).astype(np.float32)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _both(fn):
    """fn(mx) for the JAX package and the port; numpy results."""
    with jax.default_matmul_precision("highest"):
        j = fn(jmx)
    return j, fn(tmx)


def _close(a, b, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=0, atol=atol)


def test_flags_and_scopes():
    def run(mx):
        ag = mx.autograd
        seen = [(ag.is_recording(), ag.is_training())]
        with ag.record():
            seen.append((ag.is_recording(), ag.is_training()))
            with ag.pause():
                seen.append((ag.is_recording(), ag.is_training()))
                with ag.train_mode():
                    seen.append((ag.is_recording(), ag.is_training()))
            with ag.predict_mode():
                seen.append((ag.is_recording(), ag.is_training()))
        with ag.record(train_mode=False):
            seen.append((ag.is_recording(), ag.is_training()))
        seen.append((ag.is_recording(), ag.is_training()))
        prev = ag.set_recording(True)
        seen.append((prev, ag.is_recording()))
        ag.set_recording(False)
        return seen
    j, t = _both(run)
    assert j == t


def _chain(mx, req="write", heads_leaf=False):
    x = mx.nd.array(X)
    w = mx.nd.array(W)
    x.attach_grad(req)
    w.attach_grad(req)
    for _ in range(2):
        with mx.autograd.record():
            h = mx.nd.dot(x, w)
            y = (mx.nd.tanh(h) * mx.nd.sigmoid(h)).sum() + (x * x).mean()
        y.backward()
    return x.grad.asnumpy(), w.grad.asnumpy()


@pytest.mark.parametrize("req", ["write", "add"])
def test_grad_req_write_replaces_and_add_accumulates(req):
    (jx, jw), (tx, tw) = _both(lambda mx: _chain(mx, req))
    _close(tx, jx)
    _close(tw, jw)
    one_x, _ = _chain(tmx, "write")
    _close(tx, one_x * (2 if req == "add" else 1))


def test_only_recorded_ops_are_differentiated():
    def run(mx):
        x = mx.nd.array(X)
        x.attach_grad()
        y_out = (x * 3).sum()               # outside record: not on the tape
        with mx.autograd.record():
            a = x * 2
            with mx.autograd.pause():
                b = a * 5                   # paused: a constant
            z = (a * b).sum() + (x.exp() * 0 + a).sum()
        z.backward()
        g1 = x.grad.asnumpy().copy()
        y_out.backward()                    # nothing recorded: no effect
        return g1, x.grad.asnumpy()
    (jg, jg2), (tg, tg2) = _both(run)
    _close(tg, jg)
    _close(tg2, jg2)
    _close(tg, tg2)


def test_head_that_is_a_marked_leaf_gets_its_gradient():
    def run(mx):
        x = mx.nd.array(X)
        x.attach_grad()
        with mx.autograd.record():
            pass
        x.backward(mx.nd.array(np.full((3, 4), 2.0, np.float32)))
        return x.grad.asnumpy()
    j, t = _both(run)
    _close(t, j)
    _close(t, np.full((3, 4), 2.0))


def test_head_gradients_and_several_heads():
    def run(mx):
        x = mx.nd.array(X)
        x.attach_grad()
        with mx.autograd.record():
            a = x * x
            b = mx.nd.sin(x)
        mx.autograd.backward([a, b], [mx.nd.array(np.ones((3, 4),
                                                          np.float32) * 3),
                                      mx.nd.array(X)])
        return x.grad.asnumpy()
    j, t = _both(run)
    _close(t, j)


def test_retain_graph():
    def run(mx):
        x = mx.nd.array(X)
        x.attach_grad("add")
        with mx.autograd.record():
            y = (x ** 3).sum()
        y.backward(retain_graph=True)
        y.backward()
        return x.grad.asnumpy()
    j, t = _both(run)
    _close(t, j, 1e-4)
    _close(t, 6 * X ** 2, 1e-4)
    x = tmx.nd.array(X)
    x.attach_grad()
    with tmx.autograd.record():
        y = (x ** 3).sum()
    y.backward()
    with pytest.raises(RuntimeError):       # the graph was freed
        y.backward()


def test_grad_returns_instead_of_writing():
    def run(mx):
        x = mx.nd.array(X)
        w = mx.nd.array(W)
        x.attach_grad()
        w.attach_grad()
        unused = mx.nd.array(W)
        unused.attach_grad()
        with mx.autograd.record():
            y = mx.nd.dot(x, w).sum() * 2
        gx, gw, gu = mx.autograd.grad(y, [x, w, unused])
        return (gx.asnumpy(), gw.asnumpy(), gu.asnumpy(),
                x.grad.asnumpy())
    j, t = _both(run)
    for a, b in zip(t, j):
        _close(a, b)
    assert not t[3].any()                     # .grad was not written


def test_second_order_gradient():
    """grad(create_graph=True) gives gradients on the graph: d/dx of
    sum(d/dx sum(x^3)) = 6x, as jax.grad of jax.grad gives."""
    x = tmx.nd.array(X)
    x.attach_grad()
    with tmx.autograd.record():
        y = (x ** 3 * tmx.nd.sin(x)).sum()
        g = tmx.autograd.grad(y, x, create_graph=True)
        z = (g * g).sum()
    z.backward()

    def f(v):
        return jnp.sum(v ** 3 * jnp.sin(v))

    def h(v):
        gv = jax.grad(f)(v)
        return jnp.sum(gv * gv)
    _close(g.asnumpy(), np.asarray(jax.grad(f)(jnp.asarray(X))), 1e-5)
    _close(x.grad.asnumpy(), np.asarray(jax.grad(h)(jnp.asarray(X))), 1e-4)
    # the reference's tape gives zeros here (ROADMAP.md section C)
    jx = jmx.nd.array(X)
    jx.attach_grad()
    with jmx.autograd.record():
        jg = jmx.autograd.grad((jx ** 3).sum(), jx, create_graph=True)
        jz = jg.sum()
    jz.backward()
    assert not jx.grad.asnumpy().any()


def test_attach_grad_on_a_tape_output_makes_a_fresh_leaf():
    """The gradient stops at the new leaf. (The reference's tape keeps the
    node that produced it, so its x.grad fills in: ROADMAP.md section
    C.)"""
    def run(mx):
        x = mx.nd.array(X)
        x.attach_grad()
        with mx.autograd.record():
            h = x * 2
        h.attach_grad()
        with mx.autograd.record():
            y = (h * h).sum()
        y.backward()
        return h.grad.asnumpy(), x.grad.asnumpy()
    (jh, jx), (th, tx) = _both(run)
    _close(th, jh)
    _close(th, 4 * X)
    assert not tx.any()
    _close(jx, 8 * X)


def test_mark_variables_and_null_requests():
    def run(mx):
        a, b = mx.nd.array(X), mx.nd.array(X * 2)
        ga, gb = mx.nd.zeros((3, 4)), mx.nd.zeros((3, 4))
        mx.autograd.mark_variables([a, b], [ga, gb], ["write", "null"])
        with mx.autograd.record():
            y = (a * b).sum()
        y.backward()
        return ga.asnumpy(), gb.asnumpy()
    (ja, jb), (ta, tb) = _both(run)
    _close(ta, ja)
    _close(tb, jb)
    _close(ta, X * 2)
    assert not tb.any()


class _Sigmoid:
    """A custom Function written for either package."""

    @staticmethod
    def make(mx):
        class Sigmoid(mx.autograd.Function):
            def forward(self, x):
                y = 1 / (1 + mx.nd.exp(-x))
                self.save_for_backward(y)
                return y

            def backward(self, dy):
                (y,) = self.saved_tensors
                return dy * y * (1 - y) * 2     # deliberately scaled
        return Sigmoid()


def test_custom_function():
    def run(mx):
        x = mx.nd.array(X)
        x.attach_grad()
        f = _Sigmoid.make(mx)
        with mx.autograd.record():
            y = f(x)
            z = (y * mx.nd.array(X)).sum()
        z.backward()
        return y.asnumpy(), x.grad.asnumpy()
    (jy, jg), (ty, tg) = _both(run)
    _close(ty, jy)
    _close(tg, jg)
    s = 1 / (1 + np.exp(-X))
    _close(tg, X * s * (1 - s) * 2)
    out = _Sigmoid.make(tmx)(tmx.nd.array(X))     # outside record: forward
    _close(out.asnumpy(), s)


def test_custom_function_with_two_outputs():
    def run(mx):
        class Split(mx.autograd.Function):
            def forward(self, x):
                return x * 2, x * x

            def backward(self, da, db):
                return da * 2 + db * 10
        x = mx.nd.array(X)
        x.attach_grad()
        with mx.autograd.record():
            a, b = Split()(x)
            z = (a + b).sum()
        z.backward()
        return x.grad.asnumpy()
    j, t = _both(run)
    _close(t, j)
    _close(t, np.full((3, 4), 12.0))


def test_train_mode_drives_dropout():
    x = tmx.nd.ones((200, 50))
    with tmx.autograd.record(train_mode=False):
        y = tmx.nd.Dropout(x, p=0.5)
    np.testing.assert_array_equal(y.asnumpy(), 1.0)
    with tmx.autograd.train_mode():
        y = tmx.nd.Dropout(x, p=0.5).asnumpy()
    assert set(np.unique(y)) <= {0.0, 2.0}
    assert abs((y == 0).mean() - 0.5) < 0.05


def test_grads_flow_through_the_row_kernels_ops():
    """``nd.LayerNorm`` and ``nd.softmax`` (B5/B6 on the card, their twins
    here) differentiate like the reference's."""
    g = np.random.default_rng(2).standard_normal(4).astype(np.float32)
    b = np.random.default_rng(3).standard_normal(4).astype(np.float32)

    def run(mx):
        xs = [mx.nd.array(a) for a in (np.tile(X, (4, 1)), g, b)]
        for v in xs:
            v.attach_grad()
        with mx.autograd.record():
            y = mx.nd.LayerNorm(*xs)
            p = mx.nd.softmax(y * 3)
            z = (p * mx.nd.array(np.tile(X, (4, 1)))).sum()
        z.backward()
        return [v.grad.asnumpy() for v in xs]
    j, t = _both(run)
    for a, c in zip(t, j):
        _close(a, c, 1e-5)
