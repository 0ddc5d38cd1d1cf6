"""Tensor (Megatron) parallelism over the ``tensor`` mesh axis.

Counterpart of ``incubator_mxnet_tpu/parallel/tp.py``. The reference
annotates shardings and lets XLA place the all-reduce; here the layers
hold their own shard of the weight and the collectives are explicit, as
Megatron-LM's pair of region operators (each the other's dual):

* :func:`copy_to_tensor_region` - identity forward, psum backward: the
  input of a column-parallel layer, used whole by every rank, collects
  every rank's partial input gradient;
* :func:`reduce_from_tensor_region` - psum forward, identity backward:
  the partial outputs of a row-parallel layer summed, the whole
  gradient handed to every rank.

With them a replicated value carries its whole gradient on every rank of
the axis (the loss is computed once a rank, and a replicated weight's
gradient needs no sum over the axis). :class:`ColumnParallelDense`
holds ``units / n`` output rows of the weight and leaves its output split
on the last dim; :class:`RowParallelDense` takes that split input, holds
``in_units / n`` input columns and returns the whole output: one
all-reduce an MLP block. :func:`with_sharding` has nothing to annotate in
a per-rank program and returns its input.
"""
from __future__ import annotations

import torch

from ..gluon import nn
from ..ndarray.ndarray import invoke
from . import collectives as C
from .mesh import get_mesh

__all__ = ["ColumnParallelDense", "RowParallelDense", "with_sharding",
           "megatron_mlp_specs", "copy_to_tensor_region",
           "reduce_from_tensor_region"]


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.args = (axis, mesh)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        axis, mesh = ctx.args
        return C.raw_all_reduce(g, axis, "sum", mesh), None, None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        return C.raw_all_reduce(x, axis, "sum", mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to_tensor_region(x, axis: str = "tensor", mesh=None):
    """Identity forward, psum over ``axis`` backward."""
    return _CopyToRegion.apply(x, axis, mesh or get_mesh())


def reduce_from_tensor_region(x, axis: str = "tensor", mesh=None):
    """psum over ``axis`` forward, identity backward."""
    return _ReduceFromRegion.apply(x, axis, mesh or get_mesh())


def with_sharding(x, spec):
    """The reference's sharding hint; a per-rank program places every
    tensor itself, so the value passes through unchanged."""
    return x


def _split(n: int, axis: str) -> int:
    mesh = get_mesh()
    size = mesh.axis_size(axis) if mesh is not None else 1
    if n % size:
        raise ValueError(f"{n} does not split over the '{axis}' axis "
                         f"({size})")
    return n // size


class ColumnParallelDense(nn.Dense):
    """Dense whose weight rows (output units) split over ``axis``: this
    rank holds ``units / n`` of them and returns its slice of the output
    (the gather is left to the :class:`RowParallelDense` that follows).
    Built on the current mesh."""

    def __init__(self, units, axis: str = "tensor", **kwargs):
        super().__init__(_split(units, axis), **kwargs)
        self._tp_axis = axis
        self._mesh = get_mesh()

    def hybrid_forward(self, F, x, weight, bias=None):
        x = invoke(lambda v: copy_to_tensor_region(v, self._tp_axis,
                                                   self._mesh), [x])
        return super().hybrid_forward(F, x, weight, bias)


class RowParallelDense(nn.Dense):
    """Dense whose weight columns (input units) split over ``axis``: it
    takes this rank's slice of the input, and the partial products are
    summed over the axis before the bias. ``in_units`` is the whole
    input width. Built on the current mesh."""

    def __init__(self, units, axis: str = "tensor", in_units: int = 0,
                 **kwargs):
        act = kwargs.pop("activation", None)
        super().__init__(units, in_units=_split(in_units, axis)
                         if in_units else 0, **kwargs)
        self._tp_axis = axis
        self._mesh = get_mesh()
        self._row_act = act

    def hybrid_forward(self, F, x, weight, bias=None):
        out = super().hybrid_forward(F, x, weight, None)
        out = invoke(lambda v: reduce_from_tensor_region(
            v, self._tp_axis, self._mesh), [out])
        if bias is not None:
            out = out + bias
        if self._row_act is not None:
            out = F.Activation(out, act_type=self._row_act)
        return out


def megatron_mlp_specs(param_names):
    """Parameter name -> spec for a column + row parallel MLP: the first
    weight split on its output dim, the second on its input dim."""
    from .mesh import P
    specs = {}
    for name in param_names:
        if "ffn1" in name or "column" in name:
            specs[name] = P("tensor", None)
        elif "ffn2" in name or "row" in name:
            specs[name] = P(None, "tensor")
        else:
            specs[name] = P()
    return specs
