"""The port's ``nd.contrib`` against the JAX package's, on the CPU.

One case per op: the same numpy inputs (from a seed) go through both
packages' ``nd.contrib`` op, and every output must agree in value (1e-5,
relative above 1; the JAX side runs under
``jax.default_matmul_precision("highest")`` with its Pallas detection
kernels in interpret mode) and in dtype. Differentiable cases also compare
the inputs' gradients of sum(out * w) under ``autograd.record()`` (1e-4).
Beside the sweep: the namespace covers the reference's, and the pieces the
port has not got (int8 quantization, CSR storage) raise naming their
ROADMAP items. The vision ops' cases (ROI align and pooling, resizing,
deformable convolution, RPN proposals) are in
``test_torch_contrib_vision.py``, with this file's harness.
"""
import numpy as np
import pytest

import jax

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "multibox_target,nms")
    with jax.default_matmul_precision("highest"), tmx.cpu():
        yield


def _f(*shape, seed=0, lo=None, hi=None):
    g = np.random.default_rng(seed)
    if lo is None:
        return g.standard_normal(shape).astype(np.float32)
    return g.uniform(lo, hi, shape).astype(np.float32)


def _boxes(n, seed):
    g = np.random.default_rng(seed)
    xy = g.uniform(0, 0.6, (n, 2))
    wh = g.uniform(0.1, 0.4, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _foreach(nd, x, s):
    def body(d, st):
        return d * 2 + st, st + d
    outs, st = nd.contrib.foreach(body, x, s)
    return [outs, st]


def _foreach_lists(nd, x, y, s):
    def body(ds, sts):
        a, b = ds
        return [a * b, a + sts[0]], [sts[0] * 0.5 + b]
    outs, sts = nd.contrib.foreach(body, [x, y], [s])
    return list(outs) + list(sts)


def _while(nd, i, acc):
    outs, (i2, acc2) = nd.contrib.while_loop(
        lambda i, a: i < 3, lambda i, a: (a * i, (i + 1, a * 1.5 + i)),
        (i, acc), max_iterations=10)
    return [outs, i2, acc2]


def _cond(nd, x):
    a = nd.contrib.cond(x.sum() > 0, lambda: x * 2, lambda: x - 1)
    b = nd.contrib.cond(x.sum() < 0, lambda: x * 2, lambda: x - 1)
    return [a, b]


PRIOR_X = np.zeros((1, 3, 4, 5), np.float32)
ANCH = _boxes(30, 1)[None]
LAB = np.full((2, 3, 5), -1.0, np.float32)
LAB[0, :2, 1:] = _boxes(2, 2)
LAB[0, :2, 0] = [0, 2]
LAB[1, 0, 1:] = _boxes(1, 3)[0]
LAB[1, 0, 0] = 1
CLS = _f(2, 4, 30, seed=4)
PROB = np.exp(CLS) / np.exp(CLS).sum(1, keepdims=True)
LOC = _f(2, 120, seed=5) * 0.1
NMS_DATA = np.concatenate([
    np.random.default_rng(6).integers(0, 3, (2, 20, 1)).astype(np.float32),
    _f(2, 20, 1, seed=7, lo=0, hi=1),
    _boxes(40, 8).reshape(2, 20, 4)], -1)

# name -> (inputs, fn(nd, *arrays), differentiable)
CASES = {
    "foreach": ([_f(4, 3), _f(3, seed=1)], _foreach, True),
    "foreach_lists": ([_f(4, 3), _f(4, 3, seed=2), _f(3, seed=3)],
                      _foreach_lists, True),
    "while_loop": ([np.array([0.0], np.float32), _f(2, seed=4)], _while,
                   True),
    "cond": ([_f(3, 2)], _cond, True),
    "isinf": ([np.array([1.0, np.inf, -np.inf, np.nan], np.float32)],
              lambda nd, x: nd.contrib.isinf(x), False),
    "isnan": ([np.array([1.0, np.inf, np.nan], np.float32)],
              lambda nd, x: nd.contrib.isnan(x), False),
    "isfinite": ([np.array([1.0, np.inf, np.nan], np.float32)],
                 lambda nd, x: nd.contrib.isfinite(x), False),
    "MultiBoxPrior": ([PRIOR_X], lambda nd, x: nd.contrib.MultiBoxPrior(
        x, sizes=[0.5, 0.25], ratios=[1, 2, 0.5], clip=True), False),
    "MultiBoxTarget": ([ANCH, LAB, CLS], lambda nd, a, l, c:
                       nd.contrib.MultiBoxTarget(
                           a, l, c, negative_mining_ratio=2.0,
                           overlap_threshold=0.3), False),
    "MultiBoxDetection": ([PROB, LOC, ANCH], lambda nd, p, l, a:
                          nd.contrib.MultiBoxDetection(
                              p, l, a, nms_topk=12, threshold=0.2), False),
    "box_iou": ([_boxes(4, 13), _boxes(5, 14)],
                lambda nd, a, b: nd.contrib.box_iou(a, b), True),
    "box_iou_center": ([_boxes(4, 13), _boxes(5, 14)],
                       lambda nd, a, b: nd.contrib.box_iou(
                           a, b, format="center"), True),
    "box_nms": ([NMS_DATA], lambda nd, d: nd.contrib.box_nms(
        d, overlap_thresh=0.4, valid_thresh=0.2, topk=12, id_index=0),
        False),
    "boolean_mask": ([_f(5, 3), np.array([1, 0, 2, 0, 1], np.float32)],
                     lambda nd, d, m: nd.contrib.boolean_mask(d, m),
                     False),
    "index_copy": ([_f(5, 3), np.array([4, 1], np.int32), _f(2, 3, seed=2)],
                   lambda nd, o, i, n: nd.contrib.index_copy(o, i, n),
                   True),
    "quadratic": ([_f(3, 4)], lambda nd, x: nd.contrib.quadratic(
        x, a=0.5, b=-2.0, c=1.5), True),
    "div_sqrt_dim": ([_f(3, 8)], lambda nd, x: nd.contrib.div_sqrt_dim(x),
                     True),
    "fft": ([_f(3, 8)], lambda nd, x: nd.contrib.fft(x), True),
    "ifft": ([_f(3, 16)], lambda nd, x: nd.contrib.ifft(x), True),
    "count_sketch": ([_f(3, 6), np.array([[0, 2, 1, 2, 3, 0]], np.float32),
                      np.array([[1, -1, 1, 1, -1, 1]], np.float32)],
                     lambda nd, x, h, s: nd.contrib.count_sketch(x, h, s, 4),
                     False),
    "arange_like": ([_f(2, 3)], lambda nd, x: nd.contrib.arange_like(
        x, start=1.0, step=0.5, repeat=2), False),
    "arange_like_axis": ([_f(2, 5)], lambda nd, x: nd.contrib.arange_like(
        x, axis=1), False),
    "krprod": ([_f(3, 2), _f(4, 2, seed=1), _f(2, 2, seed=2)],
               lambda nd, *m: nd.contrib.krprod(*m), True),
    "getnnz": ([np.array([[0, 1.5, 0], [2, 0, 3]], np.float32)],
               lambda nd, x: [nd.contrib.getnnz(x),
                              nd.contrib.getnnz(x, axis=0),
                              nd.contrib.getnnz(x, axis=1)], False),
    "bipartite_matching": ([_f(2, 4, 3, lo=0, hi=1)],
                           lambda nd, x: nd.contrib.bipartite_matching(
                               x, threshold=0.2), False),
    "bipartite_matching_ascend": ([_f(2, 4, 3, lo=0, hi=1)],
                                  lambda nd, x:
                                  nd.contrib.bipartite_matching(
                                      x, threshold=0.8, is_ascend=True,
                                      topk=2), False),
    "SparseEmbedding": ([np.array([[0, 3], [2, 2]], np.float32),
                         _f(5, 4)],
                        lambda nd, i, w: nd.contrib.SparseEmbedding(
                            i, w, input_dim=5, output_dim=4), True),
}


def _flat(o):
    if isinstance(o, (list, tuple)):
        return [x for item in o for x in _flat(item)]
    return [o]


def _run(mx, inputs, fn, grad, w_seed=100):
    arrs = [mx.nd.array(a) for a in inputs]
    floats = [a for a in arrs if np.dtype(a.dtype).kind == "f"]
    if grad:
        for a in floats:
            a.attach_grad()
        with mx.autograd.record():
            outs = _flat(fn(mx.nd, *arrs))
            loss = None
            for i, o in enumerate(outs):
                w = mx.nd.array(np.random.default_rng(w_seed + i)
                                .standard_normal(o.shape).astype(np.float32))
                t = (o * w).sum()
                loss = t if loss is None else loss + t
        loss.backward()
        grads = [a.grad.asnumpy() for a in floats]
    else:
        outs = _flat(fn(mx.nd, *arrs))
        grads = []
    return [(o.asnumpy(), str(np.dtype(o.dtype))) for o in outs], grads


def _assert_close(got, want, atol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    lim = atol * np.maximum(1.0, np.abs(want))
    bad = ~(np.abs(got - want) <= lim) & ~(np.isnan(got) & np.isnan(want))
    bad &= ~(np.isinf(got) & np.isinf(want) & (np.sign(got) == np.sign(want)))
    assert not bad.any(), (got[bad][:5], want[bad][:5])


@pytest.mark.parametrize("name", sorted(CASES))
def test_contrib_op_matches_jax(name):
    inputs, fn, grad = CASES[name]
    jouts, jgrads = _run(jmx, inputs, fn, grad)
    touts, tgrads = _run(tmx, inputs, fn, grad)
    assert len(touts) == len(jouts)
    for (t, tdt), (j, jdt) in zip(touts, jouts):
        assert tdt == jdt, (tdt, jdt)
        _assert_close(t, j, 1e-5)
    assert len(tgrads) == len(jgrads)
    for t, j in zip(tgrads, jgrads):
        _assert_close(t, j, 1e-4)


def test_empty_loops_match_jax():
    for mx in (jmx, tmx):
        x = mx.nd.array(np.zeros((0, 3), np.float32))
        s = mx.nd.array(np.ones(3, np.float32))
        outs, st = mx.nd.contrib.foreach(lambda d, st: (d, st), x, s)
        assert outs == [] and st.asnumpy().tolist() == [1, 1, 1]
        outs, v = mx.nd.contrib.while_loop(
            lambda v: v < 0, lambda v: (v, v + 1),
            mx.nd.array(np.ones(1, np.float32)))
        assert outs == [] and v.asnumpy().tolist() == [1]


def test_namespace_covers_the_reference():
    from incubator_mxnet_tpu.ndarray import contrib as jc
    want = {n for n, v in vars(jc).items()
            if not n.startswith("_") and callable(v)
            and getattr(v, "__module__", "").startswith(
                "incubator_mxnet_tpu.")}
    missing = sorted(n for n in want if not hasattr(tmx.nd.contrib, n))
    assert missing == []


def test_unported_pieces_name_their_roadmap_item():
    x = tmx.nd.array(_f(2, 3))
    # int8 quantization (A9) is ported now: the op returns NDArray codes
    q, mn, mx_ = tmx.nd.contrib.quantize(x, x.min(), x.max())
    assert q.dtype == np.int8 and q.shape == (2, 3)
    # CSR storage is ported: edge_id takes a CSR adjacency and refuses a
    # dense one
    with pytest.raises(TypeError, match="CSR"):
        tmx.nd.contrib.edge_id(x, x, x)
