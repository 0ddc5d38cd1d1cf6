"""The port's sparse storage (``incubator_mxnet_tpu_torch/ndarray/sparse.py``)
and its consumers on the CPU, held against the JAX package on the same
numpy inputs within 1e-6: the constructors, ``cast_storage`` both ways,
``dot`` (csr x dense, its transpose_a and its gradient, dense x
row_sparse), ``retain`` / ``sparse_retain``, ``sparse_add``,
``square_sum``, ``zeros``; ``NDArray.tostype``, ``Parameter.
row_sparse_grad`` through ``Embedding(sparse_grad=True)``,
``nd.contrib.edge_id`` and ``getnnz``, ``LibSVMIter`` over a file the test
writes, ``test_utils.rand_sparse_ndarray``."""
import jax
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.ndarray import sparse as jsp
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import autograd, gluon, nd
from incubator_mxnet_tpu_torch.ndarray import sparse as tsp

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu(), jax.default_matmul_precision("highest"):
        yield


def _dense(rng, shape, density=0.3):
    a = rng.uniform(-1, 1, shape).astype(np.float32)
    return a * (rng.rand(*shape) < density)


def _np(x):
    return np.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x)


@pytest.mark.parametrize("stype", ["csr", "row_sparse"])
def test_cast_storage_round_trip_matches_the_reference(stype):
    a = _dense(np.random.RandomState(0), (7, 5))
    a[2] = 0                                    # an empty row
    t = tsp.cast_storage(nd.array(a), stype)
    j = jsp.cast_storage(jmx.nd.array(a), stype)
    assert t.stype == j.stype == stype and t.shape == j.shape
    np.testing.assert_array_equal(_np(t.data), _np(j.data))
    np.testing.assert_array_equal(_np(t.indices), _np(j.indices))
    if stype == "csr":
        np.testing.assert_array_equal(_np(t.indptr), _np(j.indptr))
        assert t.nnz == j.nnz
    np.testing.assert_array_equal(t.asnumpy(), a)
    np.testing.assert_array_equal(tsp.cast_storage(t, "default").asnumpy(),
                                  a)
    other = "row_sparse" if stype == "csr" else "csr"
    np.testing.assert_array_equal(t.tostype(other).asnumpy(), a)
    np.testing.assert_array_equal(nd.array(a).tostype(stype).asnumpy(), a)
    assert nd.array(a).tostype("default").stype == "default"


def test_constructors_from_components():
    data = np.array([1.0, 2.0, 3.0], np.float32)
    indices = np.array([0, 2, 1])
    indptr = np.array([0, 2, 2, 3])
    t = tsp.csr_matrix((data, indices, indptr), shape=(3, 4))
    j = jsp.csr_matrix((data, indices, indptr), shape=(3, 4))
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    rows = np.array([1, 3])
    vals = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = tsp.row_sparse_array((vals, rows), shape=(5, 3))
    j = jsp.row_sparse_array((vals, rows), shape=(5, 3))
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    assert t.nnz == 2 and t.dtype == np.float32
    for stype in ("csr", "row_sparse"):
        z = tsp.zeros(stype, (4, 3))
        assert z.stype == stype and z.nnz == 0
        np.testing.assert_array_equal(z.asnumpy(),
                                      jsp.zeros(stype, (4, 3)).asnumpy())


@pytest.mark.parametrize("transpose_a", [False, True])
@pytest.mark.parametrize("vector", [False, True])
def test_csr_dot_dense_and_its_gradient(transpose_a, vector):
    rng = np.random.RandomState(1)
    a = _dense(rng, (6, 4), 0.5)
    k = 6 if transpose_a else 4
    r = rng.uniform(-1, 1, (k,) if vector else (k, 3)).astype(np.float32)
    tr = nd.array(r)
    tr.attach_grad()
    with autograd.record():
        out = tsp.dot(tsp.csr_matrix(nd.array(a)), tr,
                      transpose_a=transpose_a)
        loss = (out * out).sum()
    loss.backward()
    jr = jmx.nd.array(r)
    jr.attach_grad()
    with jmx.autograd.record():
        jout = jsp.dot(jsp.csr_matrix(jmx.nd.array(a)), jr,
                       transpose_a=transpose_a)
        jloss = (jout * jout).sum()
    jloss.backward()
    np.testing.assert_allclose(out.asnumpy(), jout.asnumpy(), **TOL)
    np.testing.assert_allclose(tr.grad.asnumpy(), jr.grad.asnumpy(), **TOL)


def test_dense_dot_row_sparse():
    rng = np.random.RandomState(2)
    lhs = rng.uniform(-1, 1, (3, 5)).astype(np.float32)
    rhs = _dense(rng, (5, 4), 0.4)
    t = tsp.dot(nd.array(lhs), tsp.cast_storage(nd.array(rhs), "row_sparse"))
    j = jsp.dot(jmx.nd.array(lhs),
                jsp.cast_storage(jmx.nd.array(rhs), "row_sparse"))
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **TOL)
    with pytest.raises(TypeError):
        tsp.dot(tsp.zeros("row_sparse", (2, 2)), tsp.zeros("csr", (2, 2)))


def test_retain_and_sparse_add():
    rng = np.random.RandomState(3)
    a, b = _dense(rng, (8, 3), 0.5), _dense(rng, (8, 3), 0.5)
    ta, tb = (tsp.cast_storage(nd.array(x), "row_sparse") for x in (a, b))
    ja, jb = (jsp.cast_storage(jmx.nd.array(x), "row_sparse")
              for x in (a, b))
    keep = np.array([0, 3, 5, 7])
    for t, j in ((tsp.retain(ta, keep), jsp.retain(ja, keep)),
                 (tsp.sparse_retain(ta, nd.array(keep)),
                  jsp.sparse_retain(ja, keep)),
                 (ta.retain(keep), ja.retain(keep))):
        np.testing.assert_array_equal(_np(t.indices), _np(j.indices))
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    t, j = ta + tb, ja + jb
    assert isinstance(t, tsp.RowSparseNDArray)
    np.testing.assert_array_equal(_np(t.indices), _np(j.indices))
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **TOL)
    dense = tsp.sparse_add(ta, nd.array(b))
    np.testing.assert_allclose(dense.asnumpy(), a + b, **TOL)


@pytest.mark.parametrize("axis,keepdims", [(None, False), (None, True),
                                           (1, False), (1, True), (0, False),
                                           ((0, 1), False), (-1, True)])
def test_square_sum(axis, keepdims):
    a = _dense(np.random.RandomState(4), (6, 5), 0.4)
    t = tsp.square_sum(tsp.cast_storage(nd.array(a), "row_sparse"),
                       axis=axis, keepdims=keepdims)
    j = jsp.square_sum(jsp.cast_storage(jmx.nd.array(a), "row_sparse"),
                       axis=axis, keepdims=keepdims)
    assert t.shape == j.shape
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **TOL)
    d = tsp.square_sum(nd.array(a), axis=axis, keepdims=keepdims)
    np.testing.assert_allclose(d.asnumpy(), j.asnumpy(), **TOL)


def test_embedding_sparse_grad_is_row_sparse():
    """``Embedding(sparse_grad=True)``: the gradient's active rows are the
    looked-up ids, its values the dense gradient's, as the reference's."""
    ids = np.array([[1, 4, 4], [7, 1, 0]], np.float32)
    w = np.random.RandomState(5).uniform(-1, 1, (10, 3)).astype(np.float32)
    out = {}
    for tag, mx, g in (("port", tmx, gluon), ("ref", jmx, jmx.gluon)):
        emb = g.nn.Embedding(10, 3, sparse_grad=True)
        emb.initialize()
        emb.weight.set_data(mx.nd.array(w))
        with mx.autograd.record():
            loss = (emb(mx.nd.array(ids)) * 2.0).sum()
        loss.backward()
        out[tag] = emb.weight.row_sparse_grad()
        assert emb.weight.grad().stype == "default"
    t, j = out["port"], out["ref"]
    assert isinstance(t, tsp.RowSparseNDArray)
    np.testing.assert_array_equal(_np(t.indices), [0, 1, 4, 7])
    np.testing.assert_array_equal(_np(t.indices), _np(j.indices))
    np.testing.assert_allclose(_np(t.data), _np(j.data), **TOL)


def test_edge_id_and_getnnz():
    adj = np.array([[0, 1, 0], [2, 0, 3], [0, 0, 4]], np.float32)
    u = np.array([0, 1, 1, 2, 2], np.float32)
    v = np.array([1, 0, 1, 2, 0], np.float32)
    t = nd.contrib.edge_id(tsp.csr_matrix(nd.array(adj)), nd.array(u),
                           nd.array(v))
    j = jmx.nd.contrib.edge_id(jsp.csr_matrix(jmx.nd.array(adj)),
                               jmx.nd.array(u), jmx.nd.array(v))
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    np.testing.assert_array_equal(t.asnumpy(), [1, 2, -1, 4, -1])
    with pytest.raises(TypeError):
        nd.contrib.edge_id(nd.array(adj), nd.array(u), nd.array(v))
    for axis in (None, 0, 1):
        np.testing.assert_array_equal(
            nd.contrib.getnnz(tsp.csr_matrix(nd.array(adj)),
                              axis=axis).asnumpy(),
            jmx.nd.contrib.getnnz(jsp.csr_matrix(jmx.nd.array(adj)),
                                  axis=axis).asnumpy())


def test_libsvm_iter_reads_a_file(tmp_path):
    path = tmp_path / "data.libsvm"
    path.write_text("1 0:0.5 3:1.5\n0 1:2.0\n1 2:-1.0 4:3.0\n0\n"
                    "1 0:1.0 1:1.0 2:1.0\n")
    batches = {}
    for tag, mx in (("port", tmx), ("ref", jmx)):
        it = mx.io.LibSVMIter(str(path), data_shape=(5,), batch_size=2)
        got = []
        for _ in range(2):
            it.reset()
            got.append([(b.data[0].stype, b.data[0].asnumpy(),
                         b.label[0].asnumpy()) for b in it])
        assert it.provide_data[0].shape == (2, 5)
        batches[tag] = got
    assert len(batches["port"][0]) == 2          # 5 rows, the last dropped
    for epoch_t, epoch_j in zip(batches["port"], batches["ref"]):
        for (st, dt, lt), (sj, dj, lj) in zip(epoch_t, epoch_j):
            assert st == sj == "csr"
            np.testing.assert_array_equal(dt, dj)
            np.testing.assert_array_equal(lt, lj)
    np.testing.assert_array_equal(batches["port"][0][0][1],
                                  [[0.5, 0, 0, 1.5, 0], [0, 2.0, 0, 0, 0]])
    with pytest.raises(NotImplementedError):
        tmx.io.NDArrayIter(tsp.zeros("csr", (4, 2)), batch_size=2)


def test_libsvm_iter_skips_blank_lines(tmp_path):
    """A blank line is no row. The reference numbers the rows by line, so
    a blank line before the last row puts that row out of range
    (ROADMAP.md C); the port numbers them by label."""
    path = tmp_path / "gaps.libsvm"
    path.write_text("1 0:0.5\n\n0 1:2.0\n")
    it = tmx.io.LibSVMIter(str(path), data_shape=(3,), batch_size=2)
    batch = next(iter(it))
    np.testing.assert_array_equal(batch.data[0].asnumpy(),
                                  [[0.5, 0, 0], [0, 2.0, 0]])
    np.testing.assert_array_equal(batch.label[0].asnumpy(), [1, 0])
    with pytest.raises(IndexError):
        jmx.io.LibSVMIter(str(path), data_shape=(3,), batch_size=2)


def test_rand_sparse_ndarray_matches_the_reference():
    from incubator_mxnet_tpu import test_utils as jtu
    from incubator_mxnet_tpu_torch import test_utils as ttu
    for stype in ("csr", "row_sparse"):
        np.random.seed(7)
        t, tparts = ttu.rand_sparse_ndarray((6, 4), stype, density=0.4)
        np.random.seed(7)
        j, jparts = jtu.rand_sparse_ndarray((6, 4), stype, density=0.4)
        assert t.stype == stype and len(tparts) == len(jparts)
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
        for a, b in zip(tparts, jparts):
            np.testing.assert_array_equal(_np(a), _np(b))
        np.random.seed(7)
        r = ttu.rand_ndarray((6, 4), stype, density=0.4)
        np.testing.assert_array_equal(r.asnumpy(), t.asnumpy())


def test_csr_slice_is_rows():
    a = _dense(np.random.RandomState(8), (7, 4), 0.5)
    t = tsp.csr_matrix(nd.array(a))
    np.testing.assert_array_equal(t.slice((2,), (5,)).asnumpy(), a[2:5])
    np.testing.assert_array_equal(t[1:3].asnumpy(), a[1:3])
    assert t.as_in_context(tmx.cpu()) is t
