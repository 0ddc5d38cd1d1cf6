"""Testing utilities.

Counterpart of ``incubator_mxnet_tpu/test_utils.py`` (ref:
python/mxnet/test_utils.py): dtype-aware ``assert_almost_equal``,
``check_numeric_gradient`` (finite differences against autograd),
``check_consistency`` (the same computation on every context and type),
``default_context``, random shapes and arrays, ``copy_params`` and the
``quant_chain_net`` fixture, ``rand_sparse_ndarray`` and
``assert_no_retrace`` (the fused step's plan builds and captured CUDA
graphs). Arrays are made on the current context, so a CPU test runs these
inside ``with mx.cpu():``. Not ported yet: ``simple_forward`` (the
symbolic API, ROADMAP.md A11), which raises, naming its item.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as _np

from . import autograd
from .context import Context, cpu, current_context, gpu, num_gpus
from .ndarray.ndarray import NDArray, array as nd_array

__all__ = ["default_context", "default_dtype", "get_tolerance",
           "assert_almost_equal", "almost_equal", "same", "rand_ndarray",
           "rand_shape_2d", "rand_shape_3d", "rand_shape_nd",
           "check_numeric_gradient", "check_consistency", "numeric_grad",
           "rand_sparse_ndarray", "assert_no_retrace", "simple_forward",
           "copy_params", "quant_chain_net"]


def copy_params(src, dst) -> None:
    """Copy every parameter value from one initialized block to a
    same-architecture twin (positional zip over collect_params)."""
    for pa, pb in zip(src.collect_params().values(),
                      dst.collect_params().values()):
        pb.set_data(pa.data())


def quant_chain_net(seed: int = 0, in_hw: int = 16):
    """The reference's requantize-fusion chain — Conv→Pool→Conv→Flatten→
    Dense→Dense, initialized and shape-resolved on the current context.
    Returns (net, x)."""
    from .gluon import nn as _gnn
    from .initializer import Xavier
    rng = _np.random.default_rng(seed)
    net = _gnn.HybridSequential()
    net.add(_gnn.Conv2D(8, kernel_size=3, padding=1, activation="relu"))
    net.add(_gnn.MaxPool2D(2))
    net.add(_gnn.Conv2D(16, kernel_size=3, padding=1, activation="relu"))
    net.add(_gnn.Flatten())
    net.add(_gnn.Dense(32, activation="relu"))
    net.add(_gnn.Dense(10))
    net.initialize(Xavier())
    x = nd_array(rng.standard_normal((4, 3, in_hw, in_hw))
                 .astype(_np.float32))
    net(x)
    return net, x


def default_context() -> Context:
    """(ref: test_utils.py default_context)"""
    return current_context()


def default_dtype():
    return _np.float32


# dtype-aware default tolerances (ref: test_utils.py:493 default_rtols /
# default_atols): comparing two types uses the looser type's
_DTYPE_RTOL = {_np.dtype(_np.float64): 1e-12, _np.dtype(_np.float32): 1e-5,
               _np.dtype(_np.float16): 1e-2}
_DTYPE_ATOL = {_np.dtype(_np.float64): 1e-20, _np.dtype(_np.float32): 1e-20,
               _np.dtype(_np.float16): 1e-3}
_BF16_RTOL, _BF16_ATOL = 2e-2, 1e-3


def _tol_for(dt, table, bf16_val, default):
    if "bfloat16" in getattr(dt, "name", str(dt)):
        return bf16_val
    return table.get(_np.dtype(dt), default)


def get_tolerance(a, b, rtol=None, atol=None):
    """Effective (rtol, atol) for comparing a and b: explicit values win;
    otherwise the looser of the two types' defaults."""
    dts = []
    for x in (a, b):
        dt = getattr(x, "dtype", None)
        dts.append(dt if dt is not None else _np.dtype(_np.float32))
    if rtol is None:
        rtol = max(_tol_for(dt, _DTYPE_RTOL, _BF16_RTOL, 1e-5) for dt in dts)
    if atol is None:
        atol = max(_tol_for(dt, _DTYPE_ATOL, _BF16_ATOL, 1e-20) for dt in dts)
    return rtol, atol


def _as_np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    return _np.asarray(x)


def same(a, b) -> bool:
    return _np.array_equal(_as_np(a), _as_np(b))


def _comparable(x):
    """numpy array in a type np.allclose understands (ints -> float64)."""
    x = _as_np(x)
    if x.dtype.kind not in "fc":
        x = x.astype(_np.float64)
    return x


def almost_equal(a, b, rtol=None, atol=None, equal_nan=False) -> bool:
    rtol, atol = get_tolerance(a, b, rtol, atol)
    return _np.allclose(_comparable(a), _comparable(b), rtol=rtol,
                        atol=atol, equal_nan=equal_nan)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b"),
                        equal_nan=False):
    """(ref: test_utils.py assert_almost_equal). With rtol/atol omitted,
    tolerances derive from the types being compared (get_tolerance)."""
    rtol, atol = get_tolerance(a, b, rtol, atol)
    a, b = _comparable(a), _comparable(b)
    if not _np.allclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan):
        err = _np.max(_np.abs(a - b) / (_np.abs(b) + atol))
        raise AssertionError(
            f"Items are not equal (rtol={rtol}, atol={atol}); "
            f"max rel err {err}\n{names[0]}: {a}\n{names[1]}: {b}")


class assert_no_retrace:
    """Context manager asserting that nothing is rebuilt inside the block
    (ref: test_utils.py assert_no_retrace): the fused step's plan builds
    (``fused_step_compiles`` and ``per_param_compiles`` of
    ``optimizer.fused.stats()``) and, for each ``cuda_graph.CapturedStep``
    passed, its graph (a capture made inside the block is a rebuild).
    Stepping a learning-rate scheduler, ``set_learning_rate`` and the
    guard's rescale ladder change launch data only::

        with assert_no_retrace():
            for _ in range(10):
                trainer.step(batch)

    Raises AssertionError naming what moved."""

    def __init__(self, *captured):
        self._captured = captured

    def __enter__(self):
        from .optimizer import fused
        self._before = fused.stats()
        self._graphs = [step.graph for step in self._captured]
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is not None:
            return False
        from .optimizer import fused
        after = fused.stats()
        for key in ("fused_step_compiles", "per_param_compiles"):
            assert after[key] == self._before[key], (
                f"retrace detected: {key} went {self._before[key]} -> "
                f"{after[key]} inside an assert_no_retrace block")
        for step, graph in zip(self._captured, self._graphs):
            assert step.graph is graph, (
                f"retrace detected: {step} was captured again inside an "
                "assert_no_retrace block")
        return False


def rand_shape_2d(dim0=10, dim1=10):
    return (_np.random.randint(1, dim0 + 1), _np.random.randint(1, dim1 + 1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return (_np.random.randint(1, dim0 + 1), _np.random.randint(1, dim1 + 1),
            _np.random.randint(1, dim2 + 1))


def rand_shape_nd(num_dim, dim=10):
    return tuple(_np.random.randint(1, dim + 1, size=num_dim))


def rand_ndarray(shape, stype="default", density=None, dtype=None,
                 ctx=None, **kwargs):
    """Uniform(-1, 1) values from numpy's global generator (ref:
    test_utils.py rand_ndarray); a sparse ``stype`` through
    :func:`rand_sparse_ndarray`."""
    if stype != "default":
        return rand_sparse_ndarray(shape, stype, density=density,
                                   dtype=dtype)[0]
    arr = _np.random.uniform(-1, 1, size=shape).astype(dtype or _np.float32)
    return nd_array(arr, ctx=ctx)


def rand_sparse_ndarray(shape, stype, density=None, dtype=None, **kwargs):
    """A random CSR or row-sparse array and its components (ref:
    test_utils.py rand_sparse_ndarray): Uniform(-1, 1) values kept with
    probability ``density`` (0.3), from numpy's global generator. Returns
    (array, (data, indices)) for row_sparse, (array, (data, indices,
    indptr)) for csr."""
    from .ndarray import sparse as _sp
    density = 0.3 if density is None else density
    arr = _np.random.uniform(-1, 1, size=shape).astype(dtype or _np.float32)
    mask = _np.random.rand(*shape) < density
    sp = _sp.cast_storage(nd_array(arr * mask), stype)
    return sp, (sp.data, sp.indices) if stype == "row_sparse" else \
        (sp.data, sp.indices, sp.indptr)


def numeric_grad(f: Callable, inputs: List[_np.ndarray], eps=1e-4):
    """Central finite differences of sum(f) (ref: test_utils.py
    numeric_grad); ``inputs`` are numpy arrays, perturbed in place."""
    grads = []
    for x in inputs:
        g = _np.zeros_like(x, dtype=_np.float64)
        flat = x.reshape(-1)
        gf = g.reshape(-1)
        for j in range(flat.size):
            orig = flat[j]
            flat[j] = orig + eps
            fp = float(_np.sum(_as_np(f(*inputs))))
            flat[j] = orig - eps
            fm = float(_np.sum(_as_np(f(*inputs))))
            flat[j] = orig
            gf[j] = (fp - fm) / (2 * eps)
        grads.append(g.astype(x.dtype))
    return grads


def check_numeric_gradient(f: Callable, inputs: List[_np.ndarray], rtol=1e-2,
                           atol=1e-3, eps=1e-4):
    """Compare autograd gradients of sum(f) with finite differences (ref:
    test_utils.py check_numeric_gradient)."""
    nds = [nd_array(x.astype(_np.float32)) for x in inputs]
    for x in nds:
        x.attach_grad()
    with autograd.record():
        out = f(*nds)
        loss = out.sum()
    loss.backward()
    analytic = [x.grad.asnumpy() for x in nds]
    numeric = numeric_grad(lambda *xs: f(*[nd_array(x) for x in xs]),
                           [x.astype(_np.float64) for x in inputs], eps)
    for i, (a, n) in enumerate(zip(analytic, numeric)):
        if not _np.allclose(a, n, rtol=rtol, atol=atol):
            err = _np.max(_np.abs(a - n))
            raise AssertionError(
                f"numeric gradient check failed for input {i}: "
                f"max abs err {err}\nanalytic: {a}\nnumeric: {n}")


def check_consistency(fn: Callable, ctx_list: Optional[List] = None,
                      inputs: Optional[List[_np.ndarray]] = None,
                      dtypes: Optional[List] = None,
                      rtol=None, atol=None):
    """The same computation must agree across every (context, dtype)
    combination (ref: test_utils.py:1450 check_consistency). The contexts
    default to ``cpu`` plus ``gpu(0)`` when a card is present, the types to
    [float32, float16]; every entry is compared with the first, with
    tolerances from the looser of the two swept types (and at least 1e-3 /
    1e-4 across contexts) unless given. Only floating-point inputs are
    cast to the swept type. ``fn(*nd_inputs)`` returns an NDArray or an
    array-like. Returns {(ctx name, dtype name): numpy result}."""
    if ctx_list is None:
        ctx_list = [cpu()] + ([gpu(0)] if num_gpus() > 0 else [])
    if dtypes is None:
        dtypes = [_np.float32, _np.float16]
    inputs = inputs or []
    results: Dict = {}
    baseline = None   # (key, out, swept dtype, ctx)
    for dt in dtypes:
        for ctx in ctx_list:
            with ctx:
                nds = [nd_array(_np.asarray(x).astype(dt)
                                if _np.issubdtype(_np.asarray(x).dtype,
                                                  _np.floating)
                                else _np.asarray(x)) for x in inputs]
                out = _as_np(fn(*nds))
            key = (str(ctx), _np.dtype(dt).name)
            results[key] = out
            if baseline is None:
                baseline = (key, out, dt, ctx)
                continue
            cross = str(ctx) != str(baseline[3])
            r, a = rtol, atol
            if r is None:
                r = max(_tol_for(_np.dtype(d), _DTYPE_RTOL, _BF16_RTOL,
                                 1e-5) for d in (dt, baseline[2]))
                if cross:
                    r = max(r, 1e-3)
            if a is None:
                a = max(_tol_for(_np.dtype(d), _DTYPE_ATOL, _BF16_ATOL,
                                 1e-20) for d in (dt, baseline[2]))
                if cross:
                    a = max(a, 1e-4)
            assert_almost_equal(
                _comparable(baseline[1]), _comparable(out),
                rtol=r, atol=a, names=(str(baseline[0]), str(key)))
    return results


def simple_forward(sym, ctx=None, is_train=False, **inputs):
    raise NotImplementedError(
        "simple_forward binds a Symbol: the symbolic API is ROADMAP.md A11")
