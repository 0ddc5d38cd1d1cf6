"""Gluon Parameter and ParameterDict.

Counterpart of ``incubator_mxnet_tpu/gluon/parameter.py`` (ref:
python/mxnet/gluon/parameter.py — Parameter with deferred init, grad_req,
lr_mult/wd_mult; ParameterDict; Constant). A Parameter holds ONE NDArray on
one explicit device (the current context when ``initialize`` is given
none: the card by default, the CPU inside ``with mx.cpu():``) and its
gradient buffer, marked as an autograd variable. ``parameter_substitution``
redirects ``data()`` to stand-in arrays, which is how
``parallel.dp.functional_call`` runs a block as a function of its
parameters.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional

from .. import autograd
from .. import initializer as _init
from ..base import MXTPUError
from ..context import current_context
from ..ndarray.ndarray import NDArray, array as nd_array, zeros as nd_zeros

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict", "parameter_substitution", "tensor_types"]

tensor_types = (NDArray,)

_trace_state = threading.local()


def _substitution_map():
    return getattr(_trace_state, "sub", None)


class parameter_substitution:
    """Context manager mapping id(Parameter) -> stand-in NDArray: inside it,
    ``Parameter.data()`` returns the stand-in."""

    def __init__(self, mapping: Dict[int, NDArray]):
        self._mapping = mapping

    def __enter__(self):
        self._prev = getattr(_trace_state, "sub", None)
        _trace_state.sub = self._mapping
        return self

    def __exit__(self, *exc):
        _trace_state.sub = self._prev


class DeferredInitializationError(MXTPUError):
    """Parameter accessed before its shape is known (ref: parameter.py:39)."""


class Parameter:
    """A Block parameter (ref: gluon/parameter.py:43)."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None, allow_deferred_init=False,
                 differentiable=True, stype="default", grad_stype="default"):
        self._data: Optional[NDArray] = None
        self._grad: Optional[NDArray] = None
        self._deferred_init = ()
        self.name = name
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.grad_req = grad_req if differentiable else "null"
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        if stype not in ("default", "row_sparse", "csr"):
            raise ValueError(f"invalid stype {stype}")
        self._stype = stype
        self._grad_stype = grad_stype

    def __repr__(self):
        return f"Parameter {self.name} (shape={self.shape}, dtype={self.dtype})"

    # ------------------------------------------------------------------ shape
    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        if self._shape is None:
            self._shape = tuple(new_shape)
            return
        assert len(self._shape) == len(new_shape) and \
            all(j in (0, i) or i == j for i, j in zip(new_shape, self._shape)), \
            f"Expected shape {new_shape} is incompatible with given shape {self._shape}."
        self._shape = tuple(new_shape)

    @property
    def stype(self):
        return self._stype

    # ------------------------------------------------------------------- init
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """(ref: parameter.py initialize) Deferred while the shape is
        unknown. ``ctx`` (or the first of a list) is the device; None means
        the current context."""
        if default_init is None:
            default_init = _init.Uniform()
        if self._data is not None and not force_reinit:
            return
        if ctx is None:
            ctx = current_context()
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0]
        init = init if init is not None else (self.init if self.init is not None
                                              else default_init)
        if self._shape is None or 0 in self._shape:
            if self.allow_deferred_init:
                self._deferred_init = (init, ctx, default_init)
                return
            raise ValueError(
                f"Cannot initialize Parameter '{self.name}' because it has "
                "invalid shape: %s." % str(self._shape))
        self._finish_deferred_init(init, ctx)

    def _finish_deferred_init(self, init=None, ctx=None):
        if init is None:
            if not self._deferred_init:
                raise DeferredInitializationError(
                    f"Parameter '{self.name}' has not been initialized")
            init, ctx, _ = self._deferred_init
        self._deferred_init = ()
        with autograd.pause():
            data = nd_zeros(self._shape, ctx, self.dtype)
            initf = _init.create(init) if isinstance(init, str) else init
            initf(_init.InitDesc(self.name), data)
        self._init_impl(data, ctx)

    def _init_impl(self, data, ctx):
        self._data = data
        if self.grad_req == "null":
            self._grad = None
        else:
            self._grad = nd_zeros(data.shape, data.context, data.dtype)
            autograd.mark_variables([self._data], [self._grad], self.grad_req)

    def _check_initialized(self):
        if self._data is not None:
            return
        if self._deferred_init:
            raise DeferredInitializationError(
                f"Parameter '{self.name}' has not been initialized yet because "
                "initialization was deferred. Actual initialization happens "
                "during the first forward pass.")
        raise RuntimeError(
            f"Parameter '{self.name}' has not been initialized. You should "
            "initialize parameters with Block.initialize() before use.")

    def _load_init(self, data: NDArray, ctx=None, cast_dtype=False):
        """Load a value from a checkpoint (ref: parameter.py _load_init)."""
        if self._shape is not None and 0 not in self._shape:
            if tuple(self._shape) != tuple(data.shape):
                raise ValueError(
                    f"Failed loading Parameter '{self.name}' from saved params: "
                    f"shape incompatible expected {self._shape} vs saved {data.shape}")
        self._shape = tuple(data.shape)
        if cast_dtype:
            data = data.astype(self.dtype)
        if self._data is None:
            self._deferred_init = ()
            self._init_impl(data.copy(), ctx)
        else:
            self.set_data(data)

    # ------------------------------------------------------------------- data
    def data(self, ctx=None) -> NDArray:
        """The parameter value; the stand-in under
        :class:`parameter_substitution`."""
        sub = _substitution_map()
        if sub is not None and id(self) in sub:
            return sub[id(self)]
        self._check_initialized()
        return self._data

    def list_data(self) -> List[NDArray]:
        self._check_initialized()
        return [self._data]

    def row_sparse_data(self, row_id) -> NDArray:
        """The dense value (the port has no row-sparse storage)."""
        self._check_initialized()
        return self._data

    def list_row_sparse_data(self, row_id):
        return [self.row_sparse_data(row_id)]

    def set_data(self, data) -> None:
        self.shape = tuple(data.shape)
        if self._data is None:
            assert self._deferred_init, \
                f"Parameter '{self.name}' has not been initialized"
            init, ctx, _ = self._deferred_init
            self._deferred_init = ()
            self._init_impl(data.copy() if isinstance(data, NDArray)
                            else nd_array(data, ctx), ctx)
            return
        self._data._set_data(data._data if isinstance(data, NDArray)
                             else nd_array(data, self._data.context)._data)

    def grad(self, ctx=None) -> NDArray:
        self._check_initialized()
        if self._grad is None:
            raise RuntimeError(
                f"Cannot get gradient array for Parameter '{self.name}' "
                "because grad_req='null'")
        return self._grad

    def list_grad(self) -> List[NDArray]:
        return [self.grad()]

    def row_sparse_grad(self):
        raise NotImplementedError(
            "row_sparse_grad: row-sparse storage is ROADMAP.md A4 "
            "(ndarray/sparse.py, not ported yet)")

    def zero_grad(self) -> None:
        if self._grad is not None:
            self._grad[:] = 0

    def reset_ctx(self, ctx) -> None:
        if self._data is not None:
            if isinstance(ctx, (list, tuple)):
                ctx = ctx[0]
            with autograd.pause():
                self._data = self._data.as_in_context(ctx)
                if self._grad is not None:
                    self._grad = self._grad.as_in_context(ctx)
                    autograd.mark_variables([self._data], [self._grad],
                                            self.grad_req)

    def list_ctx(self):
        self._check_initialized()
        return [self._data.context]

    def cast(self, dtype) -> None:
        self.dtype = dtype
        if self._data is not None:
            with autograd.pause():
                self._data = self._data.astype(dtype)
                if self._grad is not None:
                    self._grad = self._grad.astype(dtype)
                    autograd.mark_variables([self._data], [self._grad],
                                            self.grad_req)

    def var(self):
        raise NotImplementedError(
            "Parameter.var: the symbolic API is ROADMAP.md A11 (not ported)")


class Constant(Parameter):
    """Non-trainable constant parameter (ref: parameter.py:Constant)."""

    def __init__(self, name, value):
        if not isinstance(value, NDArray):
            value = nd_array(value)
        self.value = value

        class _ConstInit(_init.Initializer):
            def _init_weight(self, _, arr):
                arr._set_data(value._data)

        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, init=_ConstInit(),
                         differentiable=False)


def _strip_checkpoint_prefixes(loaded):
    """Module checkpoints key params as "arg:name"/"aux:name"; gluon loads
    them transparently. List-format files pass through."""
    if isinstance(loaded, dict) and any(
            k.startswith(("arg:", "aux:")) for k in loaded):
        return {k.split(":", 1)[1] if k.startswith(("arg:", "aux:")) else k: v
                for k, v in loaded.items()}
    return loaded


class ParameterDict:
    """Ordered dict of parameters with prefix + shared-dict lookup
    (ref: gluon/parameter.py:ParameterDict)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params: "OrderedDict[str, Parameter]" = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self):
        return iter(self._params)

    def __getitem__(self, key) -> Parameter:
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def __len__(self):
        return len(self._params)

    def __repr__(self):
        s = "\n".join(f"  {v}" for v in self._params.values())
        return f"ParameterDict '{self._prefix}' (\n{s}\n)"

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name, **kwargs) -> Parameter:
        """Get or create (ref: ParameterDict.get)."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
        else:
            for k, v in kwargs.items():
                if hasattr(param, k) and getattr(param, k) is not None:
                    existing = getattr(param, k)
                    if k == "shape" and v is not None and existing is not None:
                        if len(v) == len(existing):
                            param.shape = tuple(a if a != 0 else b
                                                for a, b in zip(v, existing))
                            continue
                    if k == "init" and v is None:
                        continue
                else:
                    setattr(param, k, v)
        return param

    def get_constant(self, name, value=None) -> Constant:
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise KeyError(f"No constant named '{name}'.")
            param = Constant(name, value)
            self._params[name] = param
        return param

    def update(self, other) -> None:
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError(f"Cannot update self with other because they "
                                 f"have different Parameters with the same name '{k}'")
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False) -> None:
        if init is None:
            init = _init.Uniform()
        for _, v in self.items():
            v.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self) -> None:
        for v in self.values():
            v.zero_grad()

    def reset_ctx(self, ctx) -> None:
        for v in self.values():
            v.reset_ctx(ctx)

    def setattr(self, name, value) -> None:
        for v in self.values():
            setattr(v, name, value)

    def save(self, filename, strip_prefix="") -> None:
        """(ref: ParameterDict.save)"""
        from ..ndarray.ndarray import save as nd_save
        arg_dict = {}
        for param in self.values():
            name = param.name
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            arg_dict[name] = param.data()
        nd_save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix="", cast_dtype=False) -> None:
        from ..ndarray.ndarray import load as nd_load
        arg_dict = _strip_checkpoint_prefixes(nd_load(filename, ctx))
        if restore_prefix:
            arg_dict = {restore_prefix + k: v for k, v in arg_dict.items()}
        if not allow_missing:
            for name in self.keys():
                assert name in arg_dict, \
                    f"Parameter '{name}' is missing in file '{filename}'"
        for name, val in arg_dict.items():
            if name not in self._params:
                if not ignore_extra:
                    raise ValueError(
                        f"Parameter '{name}' loaded from file '{filename}' is "
                        "not present in ParameterDict")
                continue
            self._params[name]._load_init(val, ctx, cast_dtype=cast_dtype)
