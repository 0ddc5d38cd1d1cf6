"""The port's ``nd.linalg`` (``incubator_mxnet_tpu_torch/ndarray/linalg.py``)
on the CPU against the JAX package's, on the same numpy inputs at batched
shapes (..., m, n) within 1e-5 (the reference under
``jax.default_matmul_precision("highest")``): the ten ops, and the
gradients of ``potrf``, ``trsm``, ``syrk`` and ``sumlogdiag`` through each
package's autograd tape. ``syevd``'s eigenvectors are compared up to the
sign of each row (LAPACK and PyTorch may pick either)."""
import jax
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import nd

TOL = dict(rtol=1e-5, atol=1e-5)
BATCH = (2, 3)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu(), jax.default_matmul_precision("highest"):
        yield


def _rand(seed, *shape):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _spd(seed, n):
    a = _rand(seed, *BATCH, n, n)
    return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n)).astype(np.float32)


def _lower(seed, n):
    return (np.tril(_rand(seed, *BATCH, n, n))
            + 2 * np.eye(n)).astype(np.float32)


def _both(fn, *args, **kw):
    """fn's result from each package: (port, reference) numpy lists."""
    out = []
    for mx in (tmx, jmx):
        res = getattr(mx.nd.linalg, fn)(*[mx.nd.array(a) for a in args],
                                        **kw)
        res = res if isinstance(res, (tuple, list)) else (res,)
        out.append([r.asnumpy() for r in res])
    return out


@pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_gemm_and_gemm2(ta, tb):
    a = _rand(0, *BATCH, 4, 5) if not ta else _rand(0, *BATCH, 5, 4)
    b = _rand(1, *BATCH, 5, 3) if not tb else _rand(1, *BATCH, 3, 5)
    c = _rand(2, *BATCH, 4, 3)
    t, j = _both("gemm", a, b, c, transpose_a=ta, transpose_b=tb, alpha=0.7,
                 beta=-1.3)
    np.testing.assert_allclose(t[0], j[0], **TOL)
    t, j = _both("gemm2", a, b, transpose_a=ta, transpose_b=tb, alpha=1.5)
    np.testing.assert_allclose(t[0], j[0], **TOL)


def test_potrf_and_potri():
    a = _spd(3, 5)
    t, j = _both("potrf", a)
    np.testing.assert_allclose(t[0], j[0], **TOL)
    lo = t[0]
    t, j = _both("potri", lo)
    np.testing.assert_allclose(t[0], j[0], **TOL)
    np.testing.assert_allclose(t[0], np.linalg.inv(a), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("rightside", [False, True])
@pytest.mark.parametrize("lower", [False, True])
def test_trsm_and_trmm(transpose, rightside, lower):
    a = _lower(4, 4)
    if not lower:
        a = np.swapaxes(a, -1, -2).copy()
    b = _rand(5, *BATCH, 3, 4) if rightside else _rand(5, *BATCH, 4, 3)
    kw = dict(transpose=transpose, rightside=rightside, lower=lower,
              alpha=0.5)
    for fn in ("trsm", "trmm"):
        t, j = _both(fn, a, b, **kw)
        np.testing.assert_allclose(t[0], j[0], **TOL)


@pytest.mark.parametrize("transpose", [False, True])
def test_syrk(transpose):
    t, j = _both("syrk", _rand(6, *BATCH, 3, 5), transpose=transpose,
                 alpha=2.0)
    np.testing.assert_allclose(t[0], j[0], **TOL)


def test_gelqf():
    a = _rand(7, *BATCH, 3, 5)
    (tq, tl), (jq, jl) = _both("gelqf", a)
    np.testing.assert_allclose(tq, jq, **TOL)
    np.testing.assert_allclose(tl, jl, **TOL)
    np.testing.assert_allclose(tl @ tq, a, **TOL)
    assert (np.diagonal(tl, axis1=-2, axis2=-1) >= 0).all()


def test_syevd():
    a = _spd(8, 4)
    (tu, tw), (ju, jw) = _both("syevd", a)
    np.testing.assert_allclose(tw, jw, **TOL)
    sign = np.sign(np.sum(tu * ju, axis=-1, keepdims=True))
    np.testing.assert_allclose(tu * sign, ju, **TOL)
    recon = np.swapaxes(tu, -1, -2) @ (tw[..., None] * tu)
    np.testing.assert_allclose(recon, a, rtol=1e-4, atol=1e-4)


def test_sumlogdiag():
    t, j = _both("sumlogdiag", _spd(9, 4))
    np.testing.assert_allclose(t[0], j[0], **TOL)
    assert t[0].shape == BATCH


def _grads(fn, args, head, **kw):
    """d(sum(head * fn(args)))/d args from each package."""
    out = []
    for mx in (tmx, jmx):
        xs = [mx.nd.array(a) for a in args]
        for x in xs:
            x.attach_grad()
        with mx.autograd.record():
            y = getattr(mx.nd.linalg, fn)(*xs, **kw)
            loss = (y * mx.nd.array(head)).sum()
        loss.backward()
        out.append([x.grad.asnumpy() for x in xs])
    return out


def test_gradients_of_potrf_trsm_syrk_sumlogdiag():
    a = _spd(10, 4)
    t, j = _grads("potrf", [a], np.tril(_rand(11, *BATCH, 4, 4)))
    # the Cholesky gradient is defined up to symmetrisation: compare the
    # symmetric parts
    sym = lambda g: (g + np.swapaxes(g, -1, -2)) / 2     # noqa: E731
    np.testing.assert_allclose(sym(t[0]), sym(j[0]), **TOL)
    lo, b = _lower(12, 4), _rand(13, *BATCH, 4, 3)
    t, j = _grads("trsm", [lo, b], _rand(14, *BATCH, 4, 3), alpha=0.5)
    np.testing.assert_allclose(np.tril(t[0]), np.tril(j[0]), **TOL)
    np.testing.assert_allclose(t[1], j[1], **TOL)
    t, j = _grads("syrk", [_rand(15, *BATCH, 3, 5)],
                  _rand(16, *BATCH, 3, 3))
    np.testing.assert_allclose(t[0], j[0], **TOL)
    t, j = _grads("sumlogdiag", [a], _rand(17, *BATCH))
    np.testing.assert_allclose(t[0], j[0], **TOL)


def test_linalg_is_nd_linalg():
    assert nd.linalg is tmx.ndarray.linalg
    assert set(nd.linalg.__all__) == set(jmx.nd.linalg.__all__)
