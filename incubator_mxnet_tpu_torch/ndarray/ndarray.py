"""Eager NDArray over a ``torch.Tensor``: the framework's imperative tensor.

Counterpart of ``incubator_mxnet_tpu/ndarray/ndarray.py``. An NDArray wraps
a tensor in ``_data``; every op goes through :func:`invoke`, which runs a
plain torch function on the unwrapped tensors, under ``torch.enable_grad``
inside ``autograd.record()`` and under ``torch.no_grad`` everywhere else.

Rules the port keeps from the reference:

* **No aliasing writes.** The reference's arrays are immutable JAX buffers,
  so a write (``a[:] = x``, ``a += b``, ``out=``, the update ops) rebinds
  ``_data``. PyTorch's ``reshape``, slicing and ``.T`` return views, so the
  port never writes in place into a tensor another NDArray may share: every
  write builds a new tensor and rebinds. ``b = a.reshape(...)`` followed by
  ``a[:] = 0`` leaves ``b`` as it was. A write is not recorded by autograd.
* **The reference's types.** The JAX package runs with 64-bit types off:
  new arrays default to float32, Python ints become int32, and float64 /
  int64 / uint64 / complex128 input becomes float32 / int32 / uint32 /
  complex64. Reductions that PyTorch widens to int64 are narrowed back.
* **Placement by context.** Arrays are made on ``ctx`` or the current
  context (the card by default; without one, making an array raises);
  ``context`` reports ``gpu(i)`` or ``cpu(0)`` from the tensor's device.
"""
from __future__ import annotations

import builtins as _builtins
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as _np
import torch

from .. import autograd
from ..base import device_sync, env
from ..context import Context, current_context
from ..ops.nn import one_hot as _nn_one_hot

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "eye", "linspace", "concat", "concatenate", "stack", "split",
           "dot", "batch_dot", "save", "load", "waitall", "invoke",
           "from_torch", "moveaxis", "imperative_invoke"]

# 64-bit types the reference never hands out (x64 off) -> their 32-bit kin
_CANONICAL = {torch.float64: torch.float32, torch.int64: torch.int32,
              torch.uint64: torch.uint32, torch.complex128: torch.complex64}
_TORCH_TO_NP = {torch.float16: _np.float16, torch.float32: _np.float32,
                torch.float64: _np.float64, torch.int8: _np.int8,
                torch.int16: _np.int16, torch.int32: _np.int32,
                torch.int64: _np.int64, torch.uint8: _np.uint8,
                torch.uint16: _np.uint16, torch.uint32: _np.uint32,
                torch.uint64: _np.uint64, torch.bool: _np.bool_,
                torch.complex64: _np.complex64,
                torch.complex128: _np.complex128}
_NP_TO_TORCH = {_np.dtype(v): k for k, v in _TORCH_TO_NP.items()}


def canonical_dtype(dt: torch.dtype) -> torch.dtype:
    """``dt`` with the 64-bit types mapped as the reference maps them."""
    return _CANONICAL.get(dt, dt)


def to_torch_dtype(dtype) -> Optional[torch.dtype]:
    """A torch dtype from anything the reference accepts as one: a name,
    a numpy type, a Python type or a torch dtype (None stays None);
    canonicalised by :func:`canonical_dtype`."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return None if dtype is None else canonical_dtype(dtype)
    if str(dtype) == "bfloat16" or getattr(dtype, "__name__", "") == \
            "bfloat16":
        return torch.bfloat16
    return canonical_dtype(_NP_TO_TORCH[_np.dtype(dtype)])


_DEFAULT_DTYPE = to_torch_dtype(env.get("DEFAULT_DTYPE", "float32"))


def _naive_mode() -> bool:
    return env.get("ENGINE_TYPE") == "naive"


def _wrap(data: torch.Tensor) -> "NDArray":
    if _naive_mode():
        device_sync(data)
    return NDArray(data, _direct=True)


def invoke(fn: Callable, inputs: Sequence, name: str = "", n_out: int = 1):
    """Run a torch function over NDArray inputs: the eager execution path
    (ref analog: Imperative::Invoke). Inside ``autograd.record()`` the
    call is differentiable (torch records it when an input requires a
    gradient); outside, it runs under ``torch.no_grad``. ``name`` is kept
    for the reference's signature."""
    vals = [x._data if isinstance(x, NDArray) else x for x in inputs]
    with autograd._op_grad_mode():
        out = fn(*vals)
    if n_out == 1:
        return _wrap(out)
    return tuple(_wrap(o) for o in out)


imperative_invoke = invoke


def _promote(a: torch.Tensor, b: torch.Tensor):
    """Both tensors in the promotion of their types, whatever their ranks
    (PyTorch lets a 0-d tensor's type lose; JAX does not)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _cmp(op):
    return lambda x, y: op(x, y).to(x.dtype)


class NDArray:
    """Multi-dimensional, device-placed array over a ``torch.Tensor``
    (ref: python/mxnet/ndarray/ndarray.py:NDArray)."""

    __slots__ = ("_data", "_ag_marked", "_ag_grad", "_ag_grad_req",
                 "__weakref__")
    __array_priority__ = 100.0

    def __init__(self, data, ctx: Optional[Context] = None,
                 _direct: bool = False):
        if not _direct:
            data = _tensor_from(data, None, ctx)
        self._data = data
        self._ag_marked = False
        self._ag_grad: Optional["NDArray"] = None
        self._ag_grad_req = "null"

    # ------------------------------------------------------------------ meta
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """A numpy dtype; ``torch.bfloat16`` for bfloat16 (numpy has no
        such type of its own)."""
        np_t = _TORCH_TO_NP.get(self._data.dtype)
        return _np.dtype(np_t) if np_t is not None else self._data.dtype

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def context(self) -> Context:
        return Context.from_torch(self._data.device)

    ctx = context

    @property
    def stype(self) -> str:
        return "default"

    @property
    def T(self) -> "NDArray":
        return self.transpose()

    @property
    def grad(self) -> Optional["NDArray"]:
        return self._ag_grad

    @property
    def tensor(self) -> torch.Tensor:
        """The underlying ``torch.Tensor`` (the port's escape hatch)."""
        return self._data

    # ------------------------------------------------------------- lifecycle
    def asnumpy(self) -> _np.ndarray:
        """A numpy copy; bfloat16 comes back as float32."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def wait_to_read(self) -> None:
        """Block until this array's value is computed."""
        device_sync(self._data)

    wait_to_write = wait_to_read

    def copy(self) -> "NDArray":
        """A real copy in new memory (not recorded, as in the reference)."""
        return _wrap(self._data.detach().clone())

    def copyto(self, other: Union["NDArray", Context]) -> "NDArray":
        if isinstance(other, Context):
            return _wrap(self._data.detach().to(other.torch_device,
                                                copy=True))
        other._rebind(self._data.detach().to(other._data.device, copy=True))
        return other

    def as_in_context(self, context: Context) -> "NDArray":
        if context == self.context:
            return self
        dev = context.torch_device
        return invoke(lambda x: x.to(dev), [self], "as_in_context")

    as_in_ctx = as_in_context

    def astype(self, dtype, copy: bool = True) -> "NDArray":
        dt = to_torch_dtype(dtype)
        if not copy and dt == self._data.dtype:
            return self
        return invoke(lambda x: x.to(dt), [self], "astype")

    def detach(self) -> "NDArray":
        return _wrap(self._data.detach())

    def tolist(self):
        return self.asnumpy().tolist()

    # ------------------------------------------------------------- autograd
    def attach_grad(self, grad_req: str = "write", stype=None) -> None:
        """Allocate a zero gradient buffer and mark this array as a
        variable (a fresh leaf, even if it came off the tape)."""
        self._ag_grad = _wrap(torch.zeros_like(self._data.detach()))
        autograd.mark_variables([self], [self._ag_grad], grad_req)

    def backward(self, out_grad=None, retain_graph: bool = False,
                 train_mode: bool = True) -> None:
        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph, train_mode)

    # ------------------------------------------------------------- mutation
    def _rebind(self, new: torch.Tensor) -> None:
        """Point this array at ``new`` (never written in place). A marked
        variable stays a leaf that requires its gradient."""
        new = new.detach()
        if self._ag_marked and new.is_floating_point():
            new.requires_grad_(True)
        self._data = new
        if _naive_mode():
            device_sync(new)

    def _set_data(self, new: torch.Tensor) -> None:
        """Rebind to ``new`` of the same shape, cast to this array's type
        and moved to its device (the reference's CopyFromTo semantics)."""
        if tuple(new.shape) != self.shape:
            raise ValueError(f"shape mismatch in in-place assign: "
                             f"{tuple(new.shape)} vs {self.shape}")
        self._rebind(new.to(device=self._data.device, dtype=self._data.dtype))

    def __setitem__(self, key, value) -> None:
        cur = self._data.detach()
        if isinstance(value, NDArray):
            value = value._data.detach()
        if isinstance(value, (bool, float)) or (
                isinstance(value, int) and abs(value) < 2 ** 31):
            # a fill on the device, not a copy from host memory (which a
            # captured forward cannot run)
            dt = canonical_dtype(torch.as_tensor(value).dtype)
            value = torch.full((), value, dtype=dt, device=cur.device)
        value = torch.as_tensor(_host_value(value), device=cur.device)
        if key is None or (isinstance(key, _builtins.slice)
                           and key == _builtins.slice(None)):
            new = torch.broadcast_to(value.to(cur.dtype), cur.shape).clone()
        elif _steps_back(key):
            # write through the flat positions the key selects
            pos = _index(torch.arange(cur.numel(), device=cur.device)
                         .reshape(cur.shape), _canonical_index(key))
            new = cur.clone().reshape(-1)
            new[pos.reshape(-1)] = torch.broadcast_to(
                value.to(cur.dtype), pos.shape).reshape(-1)
            new = new.reshape(cur.shape)
        else:
            new = cur.clone()
            new[_canonical_index(key)] = value.to(cur.dtype)
        self._set_data(new)

    def __getitem__(self, key) -> "NDArray":
        key = _canonical_index(key)
        return invoke(lambda x: _index(x, key), [self], "getitem")

    def slice(self, begin, end, step=None) -> "NDArray":
        idx = tuple(_builtins.slice(b, e, s) for b, e, s in zip(
            begin, end, step or [None] * len(begin)))
        return self[idx]

    def slice_axis(self, axis: int, begin: int,
                   end: Optional[int]) -> "NDArray":
        idx = [_builtins.slice(None)] * self.ndim
        idx[axis] = _builtins.slice(begin, end)
        return self[tuple(idx)]

    def take(self, indices, axis=0, mode="clip") -> "NDArray":
        return invoke(lambda x, i: _take(x, i, axis, mode),
                      [self, _as_nd(indices, self)], "take")

    # ------------------------------------------------------------ reshaping
    def reshape(self, *shape, **kwargs) -> "NDArray":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = _infer_reshape(self.shape, shape)
        return invoke(lambda x: torch.reshape(x, shape), [self], "reshape")

    def reshape_like(self, other: "NDArray") -> "NDArray":
        return self.reshape(other.shape)

    def flatten(self) -> "NDArray":
        """Collapse all but the first axis (ref semantics of mx.nd flatten)."""
        return self.reshape((self.shape[0], -1) if self.ndim > 1 else (-1,))

    def ravel(self) -> "NDArray":
        return self.reshape((-1,))

    def transpose(self, axes: Optional[Sequence[int]] = None) -> "NDArray":
        perm = (tuple(range(self.ndim))[::-1] if axes is None
                else tuple(axes))
        return invoke(lambda x: x.permute(perm), [self], "transpose")

    def swapaxes(self, dim1: int, dim2: int) -> "NDArray":
        return invoke(lambda x: torch.swapaxes(x, dim1, dim2), [self],
                      "swapaxes")

    def expand_dims(self, axis: int) -> "NDArray":
        return invoke(lambda x: torch.unsqueeze(x, axis), [self],
                      "expand_dims")

    def squeeze(self, axis=None) -> "NDArray":
        def f(x):
            if axis is None:
                return torch.squeeze(x)
            axes = (axis,) if isinstance(axis, int) else tuple(axis)
            for a in axes:
                if x.shape[a] != 1:
                    raise ValueError(f"cannot squeeze axis {a} of size "
                                     f"{x.shape[a]}")
            return torch.squeeze(x, tuple(a % x.dim() for a in axes))
        return invoke(f, [self], "squeeze")

    def broadcast_to(self, shape) -> "NDArray":
        return invoke(lambda x: torch.broadcast_to(x, tuple(shape)), [self],
                      "broadcast_to")

    def broadcast_like(self, other: "NDArray") -> "NDArray":
        return self.broadcast_to(other.shape)

    def repeat(self, repeats: int, axis: Optional[int] = None) -> "NDArray":
        return invoke(lambda x: torch.repeat_interleave(x, repeats, dim=axis),
                      [self], "repeat")

    def tile(self, reps) -> "NDArray":
        reps = (reps,) if isinstance(reps, int) else tuple(reps)
        return invoke(lambda x: torch.tile(x, reps), [self], "tile")

    def pad(self, pad_width, mode="constant", constant_value=0) -> "NDArray":
        return invoke(lambda x: _pad(x, pad_width, mode, constant_value),
                      [self], "pad")

    def clip(self, a_min=None, a_max=None) -> "NDArray":
        return invoke(lambda x: x if a_min is None and a_max is None
                      else torch.clamp(x, a_min, a_max), [self], "clip")

    # ----------------------------------------------------------- reductions
    def _reduce(self, fname: str, fn, axis=None, keepdims=False):
        return invoke(lambda x: reduce_op(fname, x, axis, keepdims), [self],
                      fname)

    def sum(self, axis=None, keepdims=False, **kw):
        return self._reduce("sum", None, axis, keepdims)

    def mean(self, axis=None, keepdims=False, **kw):
        return self._reduce("mean", None, axis, keepdims)

    def max(self, axis=None, keepdims=False, **kw):
        return self._reduce("max", None, axis, keepdims)

    def min(self, axis=None, keepdims=False, **kw):
        return self._reduce("min", None, axis, keepdims)

    def prod(self, axis=None, keepdims=False, **kw):
        return self._reduce("prod", None, axis, keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        def f(x):
            if axis is None and x.dim() > 2:
                x = x.reshape(-1)
            dim = tuple(axis) if isinstance(axis, list) else axis
            return torch.linalg.norm(x, ord=ord, dim=dim, keepdim=keepdims)
        return invoke(f, [self], "norm")

    def _arg_reduce(self, which, axis, keepdims):
        # int64 indices: no int32 overflow to work around past 2^31
        ax = int(axis) if axis is not None else None
        fn = torch.argmax if which == "max" else torch.argmin

        def f(x):
            r = fn(x, dim=ax, keepdim=keepdims and ax is not None)
            if keepdims and ax is None:
                r = r.reshape([1] * x.dim())
            return r.to(torch.float32)
        return invoke(f, [self], "arg" + which)

    def argmax(self, axis=None, keepdims=False):
        return self._arg_reduce("max", axis, keepdims)

    def argmin(self, axis=None, keepdims=False):
        return self._arg_reduce("min", axis, keepdims)

    def argsort(self, axis=-1, is_ascend=True):
        """Stable; ``axis=None`` sorts the flattened array."""
        def f(x):
            dim = 0 if axis is None else axis
            if axis is None:
                x = x.reshape(-1)
            return torch.argsort(x if is_ascend else -x, dim=dim,
                                 stable=True).to(torch.float32)
        return invoke(f, [self], "argsort")

    # ------------------------------------------------------------ arithmetic
    def _binop(self, other, fn, name, reverse=False):
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            return invoke(lambda x, y: fn(*_promote(x, y)), [a, b], name)
        const = other
        if reverse:
            return invoke(lambda x: fn(const, x), [self], name)
        return invoke(lambda x: fn(x, const), [self], name)

    def __add__(self, o): return self._binop(o, _ADD, "add")
    def __radd__(self, o): return self._binop(o, _ADD, "add", True)
    def __sub__(self, o): return self._binop(o, _SUB, "sub")
    def __rsub__(self, o): return self._binop(o, _SUB, "sub", True)
    def __mul__(self, o): return self._binop(o, _MUL, "mul")
    def __rmul__(self, o): return self._binop(o, _MUL, "mul", True)
    def __truediv__(self, o): return self._binop(o, _DIV, "div")
    def __rtruediv__(self, o): return self._binop(o, _DIV, "div", True)
    def __mod__(self, o): return self._binop(o, _MOD, "mod")
    def __rmod__(self, o): return self._binop(o, _MOD, "mod", True)
    def __pow__(self, o): return self._binop(o, _POW, "pow")
    def __rpow__(self, o): return self._binop(o, _POW, "pow", True)
    def __matmul__(self, o): return dot(self, o)
    def __neg__(self): return invoke(torch.neg, [self], "neg")
    def __abs__(self): return invoke(torch.abs, [self], "abs")

    def __eq__(self, o): return self._binop(o, _cmp(torch.eq), "eq")
    def __ne__(self, o): return self._binop(o, _cmp(torch.ne), "ne")
    def __lt__(self, o): return self._binop(o, _cmp(torch.lt), "lt")
    def __le__(self, o): return self._binop(o, _cmp(torch.le), "le")
    def __gt__(self, o): return self._binop(o, _cmp(torch.gt), "gt")
    def __ge__(self, o): return self._binop(o, _cmp(torch.ge), "ge")

    def __hash__(self):
        return id(self)

    def __iadd__(self, o):
        self._set_data((self + o)._data)
        return self

    def __isub__(self, o):
        self._set_data((self - o)._data)
        return self

    def __imul__(self, o):
        self._set_data((self * o)._data)
        return self

    def __itruediv__(self, o):
        self._set_data((self / o)._data)
        return self

    def __len__(self) -> int:
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __bool__(self) -> bool:
        if self.size != 1:
            raise ValueError("The truth value of an NDArray with multiple "
                             "elements is ambiguous.")
        return bool(self.asscalar())

    def __float__(self) -> float:
        return float(self.asscalar())

    def __int__(self) -> int:
        return int(self.asscalar())

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self) -> str:
        return (f"\n{self.asnumpy()}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self.context}>")

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    # elementwise math methods (the reference's method surface)
    def abs(self): return invoke(torch.abs, [self], "abs")
    def exp(self): return invoke(torch.exp, [self], "exp")
    def log(self): return invoke(torch.log, [self], "log")
    def sqrt(self): return invoke(torch.sqrt, [self], "sqrt")
    def square(self): return invoke(torch.square, [self], "square")
    def sign(self): return invoke(torch.sign, [self], "sign")
    def round(self): return invoke(torch.round, [self], "round")
    def floor(self): return invoke(torch.floor, [self], "floor")
    def ceil(self): return invoke(torch.ceil, [self], "ceil")
    def sigmoid(self): return invoke(torch.sigmoid, [self], "sigmoid")
    def relu(self): return invoke(torch.relu, [self], "relu")
    def tanh(self): return invoke(torch.tanh, [self], "tanh")

    def softmax(self, axis=-1):
        return invoke(lambda x: torch.softmax(x, dim=axis), [self],
                      "softmax")

    def log_softmax(self, axis=-1):
        return invoke(lambda x: torch.log_softmax(x, dim=axis), [self],
                      "log_softmax")

    def one_hot(self, depth, on_value=1.0, off_value=0.0):
        return invoke(lambda x: _nn_one_hot(x, depth, on_value, off_value),
                      [self], "one_hot")

    def dot(self, other): return dot(self, other)

    def zeros_like(self):
        return invoke(torch.zeros_like, [self], "zeros_like")

    def ones_like(self):
        return invoke(torch.ones_like, [self], "ones_like")

    def tostype(self, stype: str):
        if stype == "default":
            return self
        raise NotImplementedError(
            f"tostype({stype!r}): sparse storage is ROADMAP.md A4 "
            "(ndarray/sparse.py, not ported yet)")


def _ADD(a, b): return a + b
def _SUB(a, b): return a - b
def _MUL(a, b): return a * b
def _DIV(a, b): return a / b
def _MOD(a, b): return a % b
def _POW(a, b): return a ** b


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _host_value(x):
    """A value for ``torch.as_tensor``: NDArrays and tensors pass, numpy
    input is narrowed to the reference's 32-bit types."""
    if isinstance(x, torch.Tensor):
        return x
    a = _np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(_np.int16).copy()).view(torch.bfloat16)
    t = torch.from_numpy(_np.array(a, copy=True))
    return t.to(canonical_dtype(t.dtype))


def _tensor_from(source, dtype, ctx) -> torch.Tensor:
    """A tensor for ``source`` (NDArray, tensor, numpy array, nested list
    or scalar) with the reference's types, on ``ctx`` or the current
    context."""
    c = ctx if ctx is not None else current_context()
    if isinstance(source, NDArray):
        t = source._data.detach()
    else:
        t = _host_value(source).detach()
    dt = to_torch_dtype(dtype) if dtype is not None \
        else canonical_dtype(t.dtype)
    return t.to(device=c.torch_device, dtype=dt)


def _as_nd(x, like: Optional[NDArray] = None) -> NDArray:
    """``x`` as an NDArray; a scalar or host array lands on ``like``'s
    device when one is given (so a scalar operand follows the array it
    meets), else on the current context."""
    if isinstance(x, NDArray):
        return x
    return NDArray(_tensor_from(x, None,
                                like.context if like is not None else None),
                   _direct=True)


def _canonical_index(key):
    if isinstance(key, NDArray):
        k = key._data
        return k.long() if not k.dtype == torch.bool else k
    if isinstance(key, torch.Tensor):
        return key.long() if key.dtype != torch.bool else key
    if isinstance(key, tuple):
        return tuple(_canonical_index(k) for k in key)
    return key


def _steps_back(key) -> bool:
    """Does the key hold a slice with a negative step?"""
    keys = key if isinstance(key, tuple) else (key,)
    return any(isinstance(k, _builtins.slice) and k.step is not None
               and k.step < 0 for k in keys)


def _dims_taken(k) -> int:
    if k is None:
        return 0
    if isinstance(k, torch.Tensor) and k.dtype == torch.bool:
        return k.dim()
    return 1


def _index(x: torch.Tensor, key):
    """``x[key]`` with numpy's meaning of a negative slice step, which torch
    refuses: each such slice first becomes the ascending slice over the same
    elements, those dims are flipped, and the rest of the key applies."""
    if not _steps_back(key):
        return x[key]
    keys = key if isinstance(key, tuple) else (key,)
    rest_dims = x.dim() - sum(_dims_taken(k) for k in keys
                              if k is not Ellipsis)
    pre = [_builtins.slice(None)] * x.dim()
    flips, rest, d = [], [], 0
    for k in keys:
        if k is Ellipsis:
            rest.append(k)
            d += rest_dims
            continue
        if isinstance(k, _builtins.slice) and k.step is not None \
                and k.step < 0:
            start, _, step = k.indices(x.shape[d])
            n = len(range(*k.indices(x.shape[d])))
            last = start + (n - 1) * step
            pre[d] = (_builtins.slice(last, start + 1, -step) if n
                      else _builtins.slice(0, 0))
            flips.append(d)
            k = _builtins.slice(None)
        rest.append(k)
        d += _dims_taken(k)
    return torch.flip(x[tuple(pre)], flips)[tuple(rest)]


def _infer_reshape(cur_shape, shape):
    """The reference's reshape code 0 (copy this dim); -1 passes through."""
    return tuple(cur_shape[i] if s == 0 else int(s)
                 for i, s in enumerate(shape))


def _dims(axis, ndim: int):
    """Reduction dims as a tuple (None = all)."""
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(a % ndim for a in axis)
    return (axis % ndim,)


def reduce_op(name: str, x: torch.Tensor, axis=None, keepdims=False):
    """The reference's reductions (``jnp.sum`` and kin) in torch: several
    axes at once, integer sums and products kept 32-bit, integer means in
    float32."""
    dims = _dims(axis, x.dim())
    if x.dim() == 0 or (not dims and axis is not None):
        return x
    if name == "mean":
        if not (x.is_floating_point() or x.is_complex()):
            x = x.to(torch.float32)
        return torch.mean(x, dim=dims, keepdim=keepdims)
    if name in ("sum", "nansum"):
        fn = torch.sum if name == "sum" else torch.nansum
        out = fn(x, dim=dims, keepdim=keepdims)
    elif name in ("max", "min"):
        fn = torch.amax if name == "max" else torch.amin
        out = fn(x, dim=dims, keepdim=keepdims)
    elif name in ("prod", "nanprod"):
        if name == "nanprod":
            x = torch.where(torch.isnan(x), torch.ones_like(x), x)
        out = x
        for d in sorted(dims, reverse=True):
            out = torch.prod(out, dim=d, keepdim=keepdims)
    else:
        raise ValueError(f"unknown reduction {name!r}")
    if name not in ("max", "min") and not (x.is_floating_point()
                                           or x.is_complex()):
        out = out.to(torch.int32)     # torch widens integer sums to int64
    return out


def _take(x, i, axis, mode):
    n = x.shape[axis]
    idx = i.to(torch.int64)
    if mode == "wrap":
        idx = torch.remainder(idx, n)
    else:                                   # 'clip', the reference default
        idx = idx.clamp(0, n - 1)
    ax = axis % x.dim()
    out = torch.index_select(x, ax, idx.reshape(-1))
    return out.reshape(x.shape[:ax] + idx.shape + x.shape[ax + 1:])


def _pad(x, pad_width, mode="constant", constant_value=0):
    """``jnp.pad`` with (before, after) pairs per axis: constant, edge and
    reflect."""
    pw = [tuple(p) for p in pad_width]
    if mode == "constant":
        flat = []
        for before, after in reversed(pw):
            flat += [int(before), int(after)]
        return torch.nn.functional.pad(x, flat, value=constant_value)
    if mode not in ("edge", "reflect"):
        raise ValueError(f"pad mode {mode!r} not supported")
    for ax, (before, after) in enumerate(pw):
        if not before and not after:
            continue
        n = x.shape[ax]
        pos = torch.arange(-int(before), n + int(after), device=x.device)
        if mode == "edge":
            idx = pos.clamp(0, n - 1)
        else:                                   # reflect about the edges
            period = 2 * (n - 1) if n > 1 else 1
            idx = torch.remainder(pos, period)
            idx = torch.where(idx >= n, period - idx, idx)
        x = torch.index_select(x, ax, idx)
    return x


# ---------------------------------------------------------------------------
# creation routines (ref: python/mxnet/ndarray/utils.py + ndarray.py)
# ---------------------------------------------------------------------------

def _device(ctx: Optional[Context]) -> torch.device:
    return (ctx if ctx is not None else current_context()).torch_device


def _as_shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def array(source_array, ctx: Optional[Context] = None,
          dtype=None) -> NDArray:
    """An array from an NDArray, tensor, numpy array, nested list or
    scalar (float64 -> float32, Python ints -> int32)."""
    return _wrap(_tensor_from(source_array, dtype, ctx))


def from_torch(t: torch.Tensor) -> NDArray:
    """Wrap a tensor as it is (its device and type)."""
    return _wrap(t)


def _filled(shape, ctx, dtype, fill) -> NDArray:
    dt = to_torch_dtype(dtype) or _DEFAULT_DTYPE
    return _wrap(torch.full(_as_shape(shape), fill, dtype=dt,
                            device=_device(ctx)))


def zeros(shape, ctx=None, dtype=None, **kw) -> NDArray:
    return _filled(shape, ctx, dtype, 0)


def ones(shape, ctx=None, dtype=None, **kw) -> NDArray:
    return _filled(shape, ctx, dtype, 1)


def full(shape, val, ctx=None, dtype=None, **kw) -> NDArray:
    return _filled(shape, ctx, dtype, val)


def empty(shape, ctx=None, dtype=None) -> NDArray:
    return zeros(shape, ctx, dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype=None) -> NDArray:
    if stop is None:
        start, stop = 0, start
    dt = to_torch_dtype(dtype) or _DEFAULT_DTYPE
    v = torch.arange(start, stop, step, dtype=torch.float64).to(dt)
    if repeat > 1:
        v = torch.repeat_interleave(v, repeat)
    return _wrap(v.to(_device(ctx)))


def eye(N, M=0, k=0, ctx=None, dtype=None) -> NDArray:
    M = M or N
    dev = _device(ctx)
    v = (torch.arange(M, device=dev)[None, :]
         - torch.arange(N, device=dev)[:, None]) == k
    return _wrap(v.to(to_torch_dtype(dtype) or _DEFAULT_DTYPE))


def linspace(start, stop, num, endpoint=True, ctx=None,
             dtype=None) -> NDArray:
    dt = to_torch_dtype(dtype) or _DEFAULT_DTYPE
    if endpoint:
        v = torch.linspace(start, stop, num, dtype=torch.float64)
    else:
        v = torch.linspace(start, stop, num + 1, dtype=torch.float64)[:-1]
    return _wrap(v.to(dt).to(_device(ctx)))


# ---------------------------------------------------------------------------
# joining / linalg free functions
# ---------------------------------------------------------------------------

def _promote_all(xs):
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


def concat(*arrays, dim: int = 1) -> NDArray:
    if len(arrays) == 1 and isinstance(arrays[0], (list, tuple)):
        arrays = tuple(arrays[0])
    return invoke(lambda *xs: torch.cat(_promote_all(xs), dim=dim),
                  list(arrays), "concat")


def concatenate(arrays, axis: int = 0, always_copy: bool = True) -> NDArray:
    return concat(*arrays, dim=axis)


def stack(*arrays, axis: int = 0) -> NDArray:
    if len(arrays) == 1 and isinstance(arrays[0], (list, tuple)):
        arrays = tuple(arrays[0])
    return invoke(lambda *xs: torch.stack(_promote_all(xs), dim=axis),
                  list(arrays), "stack")


def split(ary: NDArray, num_outputs: int, axis: int = 1,
          squeeze_axis: bool = False):
    def f(x):
        if x.shape[axis] % num_outputs:
            raise ValueError(f"array split does not result in an equal "
                             f"division: {x.shape[axis]} by {num_outputs}")
        parts = torch.tensor_split(x, num_outputs, dim=axis)
        if squeeze_axis:
            parts = [torch.squeeze(p, axis) for p in parts]
        return parts[0] if num_outputs == 1 else tuple(parts)
    if num_outputs == 1:
        return invoke(f, [ary], "split")
    return list(invoke(f, [ary], "split", n_out=num_outputs))


def _dot(a, b):
    """``jnp.dot``: a's last axis against b's second-to-last (its only axis
    when 1-D); a product when either is 0-d."""
    a, b = _promote(a, b)
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    if a.dim() <= 2 and b.dim() <= 2:
        return torch.matmul(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [max(b.dim() - 2, 0)]))


def dot(lhs, rhs, transpose_a: bool = False,
        transpose_b: bool = False) -> NDArray:
    """Dense dot product (ref: src/operator/tensor/dot-inl.h)."""
    def f(a, b):
        if transpose_a:
            a = a.T if a.dim() == 2 else torch.movedim(a, 0, -1)
        if transpose_b:
            b = b.T if b.dim() == 2 else torch.movedim(b, -1, 0)
        return _dot(a, b)
    lhs = _as_nd(lhs, rhs if isinstance(rhs, NDArray) else None)
    return invoke(f, [lhs, _as_nd(rhs, lhs)], "dot")


def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False) -> NDArray:
    def f(a, b):
        if transpose_a:
            a = torch.swapaxes(a, -1, -2)
        if transpose_b:
            b = torch.swapaxes(b, -1, -2)
        return torch.matmul(*_promote(a, b))
    lhs = _as_nd(lhs, rhs if isinstance(rhs, NDArray) else None)
    return invoke(f, [lhs, _as_nd(rhs, lhs)], "batch_dot")


def moveaxis(a: NDArray, source, destination) -> NDArray:
    return invoke(lambda x: torch.movedim(x, source, destination), [a],
                  "moveaxis")


# ---------------------------------------------------------------------------
# serialization (ref: mx.nd.save/load); the format is the JAX package's:
# one .npz, keys "__single__", "__list__<i>" or the dict's own
# ---------------------------------------------------------------------------

def save(fname: str, data) -> None:
    """Save NDArray(s) to one file: an NDArray, a list, or a str->NDArray
    dict (bfloat16 is stored as float32)."""
    if isinstance(data, NDArray):
        payload = {"__single__": data.asnumpy()}
    elif isinstance(data, (list, tuple)):
        payload = {f"__list__{i}": d.asnumpy() for i, d in enumerate(data)}
    elif isinstance(data, dict):
        payload = {k: v.asnumpy() for k, v in data.items()}
    else:
        raise TypeError("save expects NDArray, list, or dict")
    with open(fname, "wb") as fh:  # the exact filename, no .npz appended
        _np.savez(fh, **payload)


def load(fname: str, ctx: Optional[Context] = None):
    """Load what :func:`save` (here or in the JAX package) wrote, onto
    ``ctx`` or the current context."""
    with _np.load(fname, allow_pickle=False) as f:
        keys = list(f.keys())
        if keys == ["__single__"]:
            return array(f["__single__"], ctx)
        if keys and all(k.startswith("__list__") for k in keys):
            return [array(f[f"__list__{i}"], ctx) for i in range(len(keys))]
        return {k: array(f[k], ctx) for k in keys}


def waitall() -> None:
    """Block until all queued device work is done (ref: mx.nd.waitall)."""
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

