"""``test_utils`` and ``registry`` of the PyTorch port against the JAX
package, on the CPU: the dtype-aware tolerances and comparisons for every
type pair, ``check_numeric_gradient`` on a custom softmax op (and its
failure on an op whose backward ignores the head gradient),
``check_consistency`` on the CPU, ``numeric_grad``, the random helpers
under one numpy seed, ``copy_params``, ``quant_chain_net``'s forward with
the reference's weights crossed (rtol 1e-5; the JAX side under
``jax.default_matmul_precision("highest")``), the three helpers that
raise naming their ``ROADMAP.md`` items, and the class registries.
"""
import itertools

import jax
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

TYPES = ["float16", "float32", "float64", "bfloat16", "int32", "uint8"]


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _register_softmaxes(mx):
    """A softmax custom op with the true VJP, and MXNet's softmax output
    op whose backward ignores the head gradient (need_top_grad False)."""
    op, nd = mx.operator, mx.nd

    def softmax(x):
        e = nd.exp(x - nd.max(x, axis=1, keepdims=True))
        return e / nd.sum(e, axis=1, keepdims=True)

    class VjpOp(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], softmax(in_data[0]))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y, g = out_data[0], out_grad[0]
            self.assign(in_grad[0], req[0],
                        y * (g - nd.sum(g * y, axis=1, keepdims=True)))

    @op.register("vjp_softmax")
    class VjpProp(op.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return VjpOp()

    class HeadOp(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], softmax(in_data[0]))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            self.assign(in_grad[0], req[0], y - nd.one_hot(
                nd.zeros((y.shape[0],)), y.shape[1]))

    @op.register("head_softmax")
    class HeadProp(op.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def create_operator(self, ctx, shapes, dtypes):
            return HeadOp()


_register_softmaxes(jmx)
_register_softmaxes(tmx)


def _typed(mx, dt):
    if dt == "bfloat16":
        return mx.nd.array(np.arange(1, 5, dtype=np.float32)).astype(dt)
    return np.arange(1, 5).astype(dt)


# ------------------------------------------------------------ tolerances
@pytest.mark.parametrize("a,b", list(itertools.product(TYPES, TYPES)))
def test_get_tolerance_matches_reference(a, b):
    want = jmx.test_utils.get_tolerance(_typed(jmx, a), _typed(jmx, b))
    got = tmx.test_utils.get_tolerance(_typed(tmx, a), _typed(tmx, b))
    assert got == want
    assert tmx.test_utils.get_tolerance(_typed(tmx, a), _typed(tmx, b),
                                        rtol=0.5, atol=0.25) == (0.5, 0.25)


@pytest.mark.parametrize("dt", ["float16", "float32", "float64", "bfloat16"])
def test_assert_almost_equal_agrees_with_reference(dt):
    """Inside and just outside each type's default tolerance, for numpy
    and NDArray operands: both packages pass or raise together."""
    base = np.linspace(0.5, 2.0, 16)
    rtol, _ = tmx.test_utils.get_tolerance(_typed(tmx, dt), _typed(tmx, dt))
    for factor, ok in ((0.25, True), (4.0, False)):
        other = base * (1 + factor * rtol)
        outcomes = []
        for mx in (jmx, tmx):
            if dt == "bfloat16":
                a = mx.nd.array(base.astype(np.float32)).astype(dt)
                b = mx.nd.array(other.astype(np.float32)).astype(dt)
                a = a.astype("float32").astype(dt)
            else:
                a, b = base.astype(dt), other.astype(dt)
            try:
                mx.test_utils.assert_almost_equal(a, b)
                outcomes.append(True)
            except AssertionError:
                outcomes.append(False)
            assert mx.test_utils.almost_equal(a, b) == outcomes[-1]
        assert outcomes[0] == outcomes[1], (dt, factor, outcomes)
        if dt != "bfloat16":        # bf16 rounding moves the operands
            assert outcomes[1] == ok


def test_same_and_ndarray_operands():
    x = np.arange(1, 7, dtype=np.float32).reshape(2, 3)
    for mx in (jmx, tmx):
        assert mx.test_utils.same(mx.nd.array(x), x)
        assert not mx.test_utils.same(mx.nd.array(x) + 1, x)
        mx.test_utils.assert_almost_equal(mx.nd.array(x), x + 1e-7)
        with pytest.raises(AssertionError, match="not equal"):
            mx.test_utils.assert_almost_equal(mx.nd.array(x), x + 1e-3,
                                              names=("got", "want"))


# -------------------------------------------------------------- gradients
def test_check_numeric_gradient_on_the_custom_softmax():
    x = (np.random.default_rng(0).standard_normal((3, 5))).astype(
        np.float32)
    w = np.random.default_rng(1).standard_normal((3, 5)).astype(np.float32)
    for mx in (jmx, tmx):
        wt = mx.nd.array(w)
        with jax.default_matmul_precision("highest"):
            mx.test_utils.check_numeric_gradient(
                lambda a: mx.nd.Custom(a, op_type="vjp_softmax") * wt, [x],
                eps=1e-2)


def test_check_numeric_gradient_catches_a_head_ignoring_backward():
    """MXNet's softmax output op ignores the head gradient: its gradient is
    not that of sum(output), and the check says so in both packages."""
    x = (np.random.default_rng(2).standard_normal((3, 5))).astype(
        np.float32)
    for mx in (jmx, tmx):
        with pytest.raises(AssertionError, match="numeric gradient check "
                           "failed for input 0"):
            mx.test_utils.check_numeric_gradient(
                lambda a: mx.nd.Custom(a, op_type="head_softmax"), [x],
                eps=1e-2)


def test_numeric_grad_matches_reference():
    x = np.random.default_rng(3).standard_normal((2, 3))
    y = np.random.default_rng(4).standard_normal(3)

    def f(mx):      # elementwise: numeric_grad sums it with numpy
        return lambda a, b: mx.nd.array(a) * mx.nd.array(b) * mx.nd.array(a)

    want = jmx.test_utils.numeric_grad(f(jmx), [x.copy(), y.copy()], 1e-3)
    got = tmx.test_utils.numeric_grad(f(tmx), [x.copy(), y.copy()], 1e-3)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[0], 2 * x * y, rtol=1e-2, atol=1e-2)


def test_check_consistency_on_the_cpu():
    x = np.random.default_rng(5).standard_normal((4, 6)).astype(np.float32)
    res = {}
    for mx in (jmx, tmx):
        res[mx] = mx.test_utils.check_consistency(
            lambda a: mx.nd.Custom(a, op_type="vjp_softmax"), inputs=[x])
    assert sorted(res[tmx]) == sorted(res[jmx]) == [
        ("cpu(0)", "float16"), ("cpu(0)", "float32")]
    np.testing.assert_allclose(res[tmx][("cpu(0)", "float32")],
                               res[jmx][("cpu(0)", "float32")], rtol=1e-6)
    np.testing.assert_allclose(res[tmx][("cpu(0)", "float16")],
                               res[jmx][("cpu(0)", "float16")], rtol=1e-3)
    assert res[tmx][("cpu(0)", "float16")].dtype == np.float16


def test_check_consistency_catches_a_disagreement():
    x = np.linspace(0.1, 1.0, 8).astype(np.float32)
    for mx in (jmx, tmx):
        def fn(a):
            return a * 2.0 if str(a.dtype) == "float16" else a
        with pytest.raises(AssertionError, match="not equal"):
            mx.test_utils.check_consistency(fn, ctx_list=[mx.cpu()],
                                            inputs=[x])


def test_check_consistency_keeps_integer_inputs():
    x = np.ones((2, 3), np.float32)
    idx = np.array([0, 2], np.int32)
    seen = []

    def fn(a, i):
        seen.append((str(a.dtype), str(i.dtype)))
        return a.sum(axis=1) + i.astype(str(a.dtype))

    tmx.test_utils.check_consistency(fn, ctx_list=[tmx.cpu()],
                                     inputs=[x, idx])
    assert seen == [("float32", "int32"), ("float16", "int32")]


# ---------------------------------------------------- random and context
def test_random_helpers_match_reference_under_one_seed():
    out = {}
    for mx in (jmx, tmx):
        np.random.seed(11)
        tu = mx.test_utils
        out[mx] = (tu.rand_shape_2d(), tu.rand_shape_3d(4, 5, 6),
                   tu.rand_shape_nd(4, 3),
                   tu.rand_ndarray((3, 4)).asnumpy(),
                   tu.rand_ndarray((2,), dtype=np.float16).asnumpy())
    for a, b in zip(out[tmx], out[jmx]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert out[tmx][4].dtype == np.float16


def test_default_context_and_dtype():
    assert tmx.test_utils.default_context() == tmx.cpu()
    assert tmx.test_utils.default_dtype() is np.float32
    assert tmx.test_utils.rand_ndarray((2,)).context == tmx.cpu()


@pytest.mark.parametrize("name,args,item", [
    ("rand_sparse_ndarray", ((3, 3), "csr"), "A4"),
    ("simple_forward", (None,), "A11"),
    ("assert_no_retrace", (), "A4")])
def test_unported_helpers_raise_naming_their_item(name, args, item):
    """``simple_forward`` (the symbolic API) raises naming A11; the helpers
    that waited for A4 (sparse storage, the fused step's plan counters)
    are ported and work."""
    fn = getattr(tmx.test_utils, name)
    if item != "A4":
        with pytest.raises(NotImplementedError, match=item):
            fn(*args)
        return
    out = fn(*args)
    if name == "rand_sparse_ndarray":
        assert out[0].stype == "csr" and out[0].shape == (3, 3)
        assert len(out[1]) == 3
    else:
        with out:
            tmx.nd.ones((2,)) + 1


def test_rand_ndarray_of_sparse_storage_raises():
    """Sparse storage is ported: a sparse ``stype`` gives a sparse array
    (the name is kept from when it raised)."""
    arr = tmx.test_utils.rand_ndarray((3, 3), stype="row_sparse")
    assert arr.stype == "row_sparse" and arr.shape == (3, 3)
    with tmx.test_utils.assert_no_retrace():
        pass


# ---------------------------------------------------------- gluon helpers
def test_copy_params_between_twins():
    nets = []
    for seed in (1, 2):
        tmx.random.seed(seed)
        net = tmx.gluon.nn.Sequential()
        net.add(tmx.gluon.nn.Dense(5, in_units=3, activation="relu"),
                tmx.gluon.nn.Dense(2, in_units=5))
        net.initialize(tmx.init.Xavier())
        nets.append(net)
    src, dst = nets
    tmx.test_utils.copy_params(src, dst)
    for a, b in zip(src.collect_params().values(),
                    dst.collect_params().values()):
        np.testing.assert_array_equal(a.data().asnumpy(),
                                      b.data().asnumpy())
    x = tmx.nd.array(np.ones((4, 3), np.float32))
    np.testing.assert_array_equal(src(x).asnumpy(), dst(x).asnumpy())


def test_quant_chain_net_matches_reference_with_crossed_weights():
    with jax.default_matmul_precision("highest"):
        jnet, jx = jmx.test_utils.quant_chain_net(seed=3, in_hw=8)
        tnet, tx = tmx.test_utils.quant_chain_net(seed=3, in_hw=8)
        np.testing.assert_array_equal(tx.asnumpy(), jx.asnumpy())
        jp, tp = (list(n.collect_params().values()) for n in (jnet, tnet))
        assert [p.shape for p in tp] == [p.shape for p in jp]
        for a, b in zip(jp, tp):
            b.set_data(tmx.nd.array(a.data().asnumpy()))
        want = jnet(jx).asnumpy()
    got = tnet(tx).asnumpy()
    assert got.shape == (4, 10)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------- registry
@pytest.mark.parametrize("mx", [jmx, tmx], ids=["jax", "torch"])
def test_registry_register_alias_create(mx):
    reg = mx.registry

    class Base:
        def __init__(self, k=0):
            self.k = k

    register = reg.get_register_func(Base, "thing")
    alias = reg.get_alias_func(Base, "thing")
    create = reg.get_create_func(Base, "thing")

    @alias("first", "uno")
    class First(Base):
        pass

    register(First)

    class Second(Base):
        pass

    register(Second, "Two")
    assert sorted(reg.get_registry(Base)) == ["first", "two", "uno"]
    reg.get_registry(Base)["x"] = Second          # a copy
    assert "x" not in reg.get_registry(Base)
    assert isinstance(create("UNO"), First)
    assert create("two", k=3).k == 3
    assert create(thing="first", k=4).k == 4
    made = create('["two", {"k": 5}]')
    assert isinstance(made, Second) and made.k == 5
    inst = First(7)
    assert create(inst) is inst
    with pytest.raises(AssertionError):
        create(inst, k=1)
    with pytest.raises(KeyError, match="Cannot find thing 'nope'"):
        create("nope")
    with pytest.raises(AssertionError):
        create(3)

    class Other:
        pass

    with pytest.raises(AssertionError, match="subclass of Base"):
        register(Other)
