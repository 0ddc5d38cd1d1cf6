"""Custom operators: MXNet's frontend extension point.

Counterpart of ``incubator_mxnet_tpu/operator.py`` (ref:
python/mxnet/operator.py CustomOp :426, CustomOpProp :472, register :692).
A user registers a ``CustomOpProp`` under a name and runs it with
``nd.Custom(*inputs, op_type=name, **kwargs)``:

* The host pair — ``CustomOp.forward`` / ``backward`` over NDArrays,
  writing through ``assign`` — becomes one ``torch.autograd.Function``.
  The forward runs unrecorded on zeroed buffers of the shapes and types
  the prop's ``infer_shape`` / ``infer_type`` give (MXNet's rule;
  ``assign`` casts to the buffer's type). Inside ``autograd.record()``
  the outputs are on PyTorch's graph, and ``backward()`` reaches the op's
  ``backward`` with ``out_grad``, ``in_data``, ``out_data``, the same
  ``aux`` and zeroed ``in_grad`` buffers, each ``req`` ``"write"`` (a
  variable's ``grad_req="add"`` accumulates in ``autograd.backward``).
  Aux states are zeroed buffers made anew for every call, as in the JAX
  package.
* A prop that defines ``torch_forward(*tensors)`` takes the fast path
  instead: a plain PyTorch function run through ``invoke``, whose
  gradient is PyTorch's autograd (the JAX package's ``jax_forward``).
* Keyword arguments reach the prop's constructor as the caller passed
  them (MXNet passes them as strings).

PyTorch runs the backward of CUDA tensors on a thread of its own, where
the caller's ``with ctx:`` scope and recording state do not hold: every
buffer is made on the inputs' device explicitly.
"""
from __future__ import annotations

from typing import List

import torch

from . import autograd
from .base import registry_get
from .ndarray.ndarray import NDArray, _wrap, invoke, to_torch_dtype

__all__ = ["CustomOp", "CustomOpProp", "register", "get", "invoke_custom"]

_REG = registry_get("custom_op")


class CustomOp:
    """Base class for operator implementations (ref: operator.py:426)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst: NDArray, req: str, src) -> None:
        """Write ``src`` into ``dst`` by ``req``: ``"write"``/``"inplace"``
        replace it, ``"add"`` adds to it, ``"null"`` leaves it (ref:
        operator.py CustomOp.assign)."""
        if req == "null":
            return
        val = src._data if isinstance(src, NDArray) else torch.as_tensor(
            src, device=dst._data.device)
        if req in ("write", "inplace", None):
            dst._set_data(torch.broadcast_to(val, dst.shape))
        elif req == "add":
            dst._set_data(dst._data + val.to(dst._data.dtype))
        else:
            raise ValueError(f"unknown req {req!r} (write, inplace, add, "
                             "null)")


class CustomOpProp:
    """Describes a custom op (ref: operator.py:472)."""

    def __init__(self, need_top_grad: bool = True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), \
            [in_type[0]] * len(self.list_auxiliary_states())

    def list_outputs(self) -> List[str]:
        return ["output"]

    def list_arguments(self) -> List[str]:
        return ["data"]

    def list_auxiliary_states(self) -> List[str]:
        return []

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes) -> CustomOp:
        raise NotImplementedError


def register(reg_name: str):
    """Register a CustomOpProp subclass (ref: operator.py:692)."""
    def do_register(prop_cls):
        _REG.register(prop_cls, reg_name)
        return prop_cls
    return do_register


def get(name: str):
    return _REG.get(name)


def _buffers(shapes, types, device) -> List[NDArray]:
    return [_wrap(torch.zeros(tuple(s), dtype=to_torch_dtype(t),
                              device=device)) for s, t in zip(shapes, types)]


class _CustomRun:
    """One call of a host custom op: the operator, its buffers' shapes and
    types, its aux states and the device, shared by forward and backward."""

    def __init__(self, op, is_train, out_shapes, out_types, aux, device):
        self.op, self.is_train = op, is_train
        self.out_shapes, self.out_types = out_shapes, out_types
        self.aux, self.device = aux, device


class _CustomFunction(torch.autograd.Function):
    """A host CustomOp as one node of PyTorch's graph."""

    @staticmethod
    def forward(ctx, run, *tensors):
        in_data = [_wrap(t.detach()) for t in tensors]
        out_data = _buffers(run.out_shapes, run.out_types, run.device)
        with autograd.pause():
            run.op.forward(run.is_train, ["write"] * len(out_data), in_data,
                           out_data, run.aux)
        ctx.run = run
        ctx.in_data = in_data
        # detached handles: the returned tensors become the node's outputs
        ctx.out_data = [_wrap(o._data.detach()) for o in out_data]
        return tuple(o._data for o in out_data)

    @staticmethod
    def backward(ctx, *grads):
        run = ctx.run
        in_grad = [_wrap(torch.zeros_like(x._data)) for x in ctx.in_data]
        with autograd.pause():
            run.op.backward(["write"] * len(in_grad),
                            [_wrap(g) for g in grads], ctx.in_data,
                            ctx.out_data, in_grad, run.aux)
        return (None,) + tuple(
            g._data if x._data.is_floating_point() else None
            for g, x in zip(in_grad, ctx.in_data))


def invoke_custom(op_type: str, *inputs: NDArray, **kwargs):
    """Run the custom op registered as ``op_type`` on ``inputs`` (the path
    ``nd.Custom(..., op_type=...)`` takes; ref:
    src/operator/custom/custom.cc): one output as an NDArray, several as
    a list."""
    prop = _REG.get(op_type)(**kwargs)
    n_out = len(prop.list_outputs())
    if hasattr(prop, "torch_forward"):
        return invoke(prop.torch_forward, list(inputs), f"custom_{op_type}",
                      n_out=n_out)
    if hasattr(prop, "jax_forward"):
        raise NotImplementedError(
            f"custom op {op_type!r}: its prop defines jax_forward, a JAX "
            "function; the port's fast path is torch_forward(*tensors), a "
            "plain PyTorch function")
    if not inputs:
        raise ValueError(f"custom op {op_type!r} needs at least one input")
    in_shapes = [list(x.shape) for x in inputs]
    in_shapes, out_shapes, aux_shapes = prop.infer_shape(in_shapes)
    in_types, out_types, aux_types = prop.infer_type(
        [x.dtype for x in inputs])
    device = inputs[0]._data.device
    op = prop.create_operator(inputs[0].context, in_shapes, in_types)
    run = _CustomRun(op, autograd.is_training(), out_shapes, out_types,
                     _buffers(aux_shapes, aux_types, device), device)
    with autograd._op_grad_mode():
        outs = _CustomFunction.apply(run, *[x._data for x in inputs])
    outs = [_wrap(o) for o in outs]
    return outs[0] if n_out == 1 else outs
