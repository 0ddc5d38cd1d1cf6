"""Collectives over mesh axes, on ``torch.distributed``.

Counterpart of ``incubator_mxnet_tpu/parallel/collectives.py``. Each
function acts on this rank's line of ranks along ``axis_name`` (a name or
a tuple of names, the first the major) of the current mesh (or
``mesh=``); an axis of size 1 makes it the identity. Every collective is
explicit: the caller's program is the per-rank body the reference runs
inside ``shard_map``.

The differentiable ones are ``torch.autograd.Function``s whose backward
is the transpose JAX uses under ``shard_map(check_vma=False)``:

  psum -> psum            pmean -> pmean
  all_gather -> reduce_scatter   reduce_scatter -> all_gather
  ppermute(perm) -> ppermute(inverse perm)
  all_to_all(split, concat) -> all_to_all(concat, split)

So a value replicated over an axis carries, on each rank, a share of its
cotangent, and the shares sum to the whole (``mesh.shard_map`` divides an
output's cotangent and sums an input's accordingly). ``pmax`` and
``pmin`` are not differentiable, as in JAX.

On a gloo mesh whose ranks compute on a card (``Mesh.staged``) each
collective copies its CUDA operands to pinned host buffers, runs there,
and copies the result back: gloo's CUDA support does not cover every
collective (point-to-point in particular). NCCL meshes run on the card.
Every call adds its seconds to :data:`COMM_SECONDS` when
:func:`timing` is on, so a step can report the share of its wall spent
in collectives.
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import Mesh, _as_axes, _need_mesh, spec_axes

__all__ = ["psum", "pmean", "pmax", "pmin", "all_gather", "reduce_scatter",
           "ppermute", "all_to_all", "axis_index", "axis_size",
           "barrier_sum", "raw_all_reduce", "raw_all_gather",
           "raw_reduce_scatter", "raw_ppermute", "raw_all_to_all",
           "all_gather_spec", "sum_replicas", "synced_moments", "timing",
           "COMM_SECONDS"]

# [seconds spent in collectives, calls] while :func:`timing` is on
COMM_SECONDS = [0.0, 0]
_TIMING = [False]


@contextlib.contextmanager
def timing():
    """Count the wall seconds of every collective of this process into
    :data:`COMM_SECONDS` (reset on entry). A collective of a card's
    tensors waits for the card's queued work first, so its seconds are
    the rank's wait for its own queued device work (and, on a shared
    card, the other ranks' work before it) and for its peers, plus the
    transfer."""
    COMM_SECONDS[0], COMM_SECONDS[1] = 0.0, 0
    _TIMING[0] = True
    try:
        yield COMM_SECONDS
    finally:
        _TIMING[0] = False


@contextlib.contextmanager
def _timed():
    if not _TIMING[0]:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        COMM_SECONDS[0] += time.perf_counter() - t0
        COMM_SECONDS[1] += 1


def _stage(x, mesh: Mesh):
    """The tensor a collective runs on: a pinned host copy on a staged
    mesh, else ``x`` itself (contiguous)."""
    x = x.contiguous()
    if mesh.staged and x.is_cuda:
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x)
        return h
    return x


def _unstage(h, like):
    return h.to(like.device) if h.device != like.device else h


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


# ------------------------------------------------ raw (no autograd) forms
def raw_all_reduce(x, axis_name, op: str = "sum",
                   mesh: Optional[Mesh] = None):
    mesh = _need_mesh(mesh)
    group, ranks = mesh.group(axis_name)
    if group is None:
        return x
    with _timed():
        h = _stage(x, mesh)
        if h is x:
            h = x.clone()
        dist.all_reduce(h, op=_OPS[op], group=group)
        return _unstage(h, x)


def raw_all_gather(x, axis_name, axis: int = 0, mesh: Optional[Mesh] = None,
                   tiled: bool = True):
    mesh = _need_mesh(mesh)
    group, ranks = mesh.group(axis_name)
    if group is None:
        return x if tiled else x.unsqueeze(axis)
    with _timed():
        h = _stage(x, mesh)
        parts = [torch.empty_like(h) for _ in ranks]
        dist.all_gather(parts, h, group=group)
        out = (torch.cat(parts, dim=axis) if tiled
               else torch.stack(parts, dim=axis))
        return _unstage(out, x)


def raw_reduce_scatter(x, axis_name, axis: int = 0,
                       mesh: Optional[Mesh] = None):
    """psum, then this rank's block along ``axis`` (tiled)."""
    mesh = _need_mesh(mesh)
    n = mesh.axis_size(axis_name)
    if n == 1:
        return x
    if x.shape[axis] % n:
        raise ValueError(f"reduce_scatter: dim {axis} of {tuple(x.shape)} "
                         f"does not split over {n}")
    s = raw_all_reduce(x, axis_name, "sum", mesh)
    step = x.shape[axis] // n
    return s.narrow(axis, mesh.axis_index(axis_name) * step,
                    step).contiguous()


def raw_ppermute(x, axis_name, perm: Sequence[Tuple[int, int]],
                 mesh: Optional[Mesh] = None):
    """Send ``x`` to the axis index ``dst`` of every (me, dst) pair and
    receive from the ``src`` of the (src, me) pair; zeros where no pair
    names this rank as a destination (as ``lax.ppermute``)."""
    mesh = _need_mesh(mesh)
    group, ranks = mesh.group(axis_name)
    me = mesh.axis_index(axis_name)
    dsts = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    if len(srcs) > 1 or len(dsts) > 1:
        raise ValueError(f"ppermute: {perm} is not a permutation")
    if group is None:
        return x.clone() if srcs else torch.zeros_like(x)
    with _timed():
        h = _stage(x, mesh)
        recv = torch.zeros_like(h)
        ops = []
        if dsts and dsts[0] == me:
            recv.copy_(h)
        else:
            if dsts:
                ops.append(dist.P2POp(dist.isend, h, ranks[dsts[0]],
                                      group=group))
            if srcs:
                ops.append(dist.P2POp(dist.irecv, recv, ranks[srcs[0]],
                                      group=group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return _unstage(recv, x)


def raw_all_to_all(x, axis_name, split_axis: int, concat_axis: int,
                   mesh: Optional[Mesh] = None):
    """Tiled all-to-all: block j of ``x`` along ``split_axis`` goes to
    axis index j; the blocks received are joined along ``concat_axis`` in
    axis-index order."""
    mesh = _need_mesh(mesh)
    group, ranks = mesh.group(axis_name)
    if group is None:
        return x
    n = len(ranks)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} "
                         f"does not split over {n}")
    with _timed():
        blocks = torch.stack(x.chunk(n, dim=split_axis), dim=0)
        h = _stage(blocks, mesh)
        out = torch.empty_like(h)
        dist.all_to_all_single(out, h, group=group)
        out = _unstage(out, x)
        return torch.cat(out.unbind(0), dim=concat_axis)


# ------------------------------------------------------- differentiable
class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, mean, mesh):
        ctx.args = (axis_name, mean, mesh)
        return _reduce(x, axis_name, mean, mesh)

    @staticmethod
    def backward(ctx, g):
        axis_name, mean, mesh = ctx.args
        return _reduce(g, axis_name, mean, mesh), None, None, None


def _reduce(x, axis_name, mean, mesh):
    y = raw_all_reduce(x, axis_name, "sum", mesh)
    return y / mesh.axis_size(axis_name) if mean else y


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, axis, tiled, mesh):
        ctx.args = (axis_name, axis, tiled, mesh)
        return raw_all_gather(x, axis_name, axis, mesh, tiled)

    @staticmethod
    def backward(ctx, g):
        axis_name, axis, tiled, mesh = ctx.args
        if not tiled:
            s = raw_all_reduce(g, axis_name, "sum", mesh)
            return (s.select(axis, mesh.axis_index(axis_name)).contiguous(),
                    None, None, None, None)
        return (raw_reduce_scatter(g.contiguous(), axis_name, axis, mesh),
                None, None, None, None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, axis, mesh):
        ctx.args = (axis_name, axis, mesh)
        return raw_reduce_scatter(x, axis_name, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        axis_name, axis, mesh = ctx.args
        return (raw_all_gather(g.contiguous(), axis_name, axis, mesh),
                None, None, None)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, perm, mesh):
        ctx.args = (axis_name, perm, mesh)
        return raw_ppermute(x, axis_name, perm, mesh)

    @staticmethod
    def backward(ctx, g):
        axis_name, perm, mesh = ctx.args
        inv = [(d, s) for s, d in perm]
        return raw_ppermute(g, axis_name, inv, mesh), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, split_axis, concat_axis, mesh):
        ctx.args = (axis_name, split_axis, concat_axis, mesh)
        return raw_all_to_all(x, axis_name, split_axis, concat_axis, mesh)

    @staticmethod
    def backward(ctx, g):
        axis_name, split_axis, concat_axis, mesh = ctx.args
        return (raw_all_to_all(g, axis_name, concat_axis, split_axis, mesh),
                None, None, None, None)


def psum(x, axis_name, mesh: Optional[Mesh] = None):
    """All-reduce sum (ref analog: KVStore push+pull aggregate)."""
    return _PSum.apply(x, _as_axes(axis_name), False, _need_mesh(mesh))


def pmean(x, axis_name, mesh: Optional[Mesh] = None):
    return _PSum.apply(x, _as_axes(axis_name), True, _need_mesh(mesh))


def pmax(x, axis_name, mesh: Optional[Mesh] = None):
    """All-reduce max; not differentiable."""
    return raw_all_reduce(x.detach(), _as_axes(axis_name), "max", mesh)


def pmin(x, axis_name, mesh: Optional[Mesh] = None):
    """All-reduce min; not differentiable."""
    return raw_all_reduce(x.detach(), _as_axes(axis_name), "min", mesh)


def all_gather(x, axis_name, axis: int = 0, tiled: bool = True,
               mesh: Optional[Mesh] = None):
    """Join every rank's ``x`` along ``axis`` (``tiled``) or on a new axis
    there."""
    return _AllGather.apply(x, _as_axes(axis_name), axis, tiled,
                            _need_mesh(mesh))


def reduce_scatter(x, axis_name, scatter_dimension: int = 0,
                   mesh: Optional[Mesh] = None):
    """psum, keeping this rank's block along ``scatter_dimension``."""
    return _ReduceScatter.apply(x, _as_axes(axis_name), scatter_dimension,
                                _need_mesh(mesh))


def ppermute(x, axis_name, perm: Sequence[Tuple[int, int]],
             mesh: Optional[Mesh] = None):
    """Neighbour exchange by (source, destination) axis-index pairs: the
    ring primitive of ring attention and the pipeline. One
    ``batch_isend_irecv`` a call."""
    return _PPermute.apply(x, _as_axes(axis_name),
                           tuple(tuple(p) for p in perm), _need_mesh(mesh))


def all_to_all(x, axis_name, split_axis: int, concat_axis: int,
               mesh: Optional[Mesh] = None):
    """Tiled all-to-all (MoE dispatch, Ulysses' seq <-> heads)."""
    return _AllToAll.apply(x, _as_axes(axis_name), split_axis, concat_axis,
                           _need_mesh(mesh))


def axis_index(axis_name, mesh: Optional[Mesh] = None) -> int:
    return _need_mesh(mesh).axis_index(axis_name)


def axis_size(axis_name, mesh: Optional[Mesh] = None) -> int:
    return _need_mesh(mesh).axis_size(axis_name)


def barrier_sum(axis_name, mesh: Optional[Mesh] = None):
    """psum of a scalar one: a synchronisation that returns the axis size
    (ref: ps::Postoffice::Barrier)."""
    mesh = _need_mesh(mesh)
    return raw_all_reduce(torch.ones((), device=mesh.device), axis_name,
                          "sum", mesh)


# ------------------------------------------------- parameters by spec
class _GatherRows(torch.autograd.Function):
    """Several tensors split on dim 0 over ``axes``, whole, in one
    all-gather; backward: one all-reduce of their cotangents, each rank
    keeping its rows (the reduce-scatter of ZeRO-3)."""

    @staticmethod
    def forward(ctx, axes, mesh, *xs):
        ctx.args = (axes, mesh, [x.shape for x in xs])
        flat = torch.cat([x.reshape(-1) for x in xs])
        rows = raw_all_gather(flat, axes, 0, mesh, tiled=False)
        outs, at = [], 0
        for x in xs:
            part = rows[:, at:at + x.numel()]
            outs.append(part.reshape((-1,) + tuple(x.shape[1:])))
            at += x.numel()
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        axes, mesh, shapes = ctx.args
        n = mesh.axis_size(axes)
        gs = [torch.zeros((n * shp[0],) + tuple(shp[1:]), device=mesh.device)
              if g is None else g for g, shp in zip(gs, shapes)]
        flat = torch.cat([g.reshape(n, -1) for g in gs], dim=1)
        mine = raw_all_reduce(flat, axes, "sum", mesh)[
            mesh.axis_index(axes)]
        out, at = [], 0
        for shp in shapes:
            k = int(torch.Size(shp).numel())
            out.append(mine[at:at + k].view(shp))
            at += k
        return (None, None) + tuple(out)


def all_gather_spec(tensors, spec, mesh: Optional[Mesh] = None):
    """Whole tensors from this rank's blocks under ``spec`` (one spec for
    all), differentiable with the reduce-scatter backward. A spec that
    splits dim 0 alone takes one collective for all the tensors."""
    mesh = _need_mesh(mesh)
    tensors = list(tensors)
    if mesh.axis_size(spec_axes(spec)) == 1:
        return tensors
    if len(spec) >= 1 and spec[0] is not None and all(
            e is None for e in spec[1:]):
        axes = _as_axes(spec[0])
        by_type = {}
        for i, t in enumerate(tensors):
            by_type.setdefault(t.dtype, []).append(i)
        out = list(tensors)
        for idx in by_type.values():
            for i, g in zip(idx, _GatherRows.apply(
                    axes, mesh, *(tensors[i] for i in idx))):
                out[i] = g
        return out
    out = []
    for t in tensors:
        for dim, entry in enumerate(spec):
            if entry is not None:
                for a in reversed(_as_axes(entry)):
                    t = all_gather(t, a, dim, mesh=mesh)
        out.append(t)
    return out


def sum_replicas(grads, specs, mesh: Optional[Mesh] = None):
    """Each gradient summed over the mesh axes its parameter is replicated
    on (those its spec does not name): one all-reduce of a flat float32
    buffer for each set of axes. Under the transposes above a replicated
    parameter's gradient arrives as per-rank shares; this makes it
    whole."""
    mesh = _need_mesh(mesh)
    out = list(grads)
    buckets = {}
    for i, s in enumerate(specs):
        named = set(spec_axes(s))
        axes = tuple(a for a in mesh.axis_names
                     if a not in named and mesh.shape[a] > 1)
        if axes:
            buckets.setdefault(axes, []).append(i)
    for axes, idx in buckets.items():
        flat = torch.cat([grads[i].float().reshape(-1) for i in idx])
        flat = raw_all_reduce(flat, axes, "sum", mesh)
        for i, part in zip(idx, flat.split([grads[i].numel()
                                            for i in idx])):
            out[i] = part.view(grads[i].shape).to(grads[i].dtype)
    return out


def synced_moments(x, red, axis_name, mesh: Optional[Mesh]):
    """(mean, mean square) of ``x`` over its dims ``red``, each averaged
    over the ranks of ``axis_name`` (:func:`pmean`, whose transpose makes
    the gradients those of the whole split batch): a synchronised
    BatchNorm's batch statistics. With ``mesh=None``, this rank's own."""
    stats = torch.stack([x.mean(dim=red), torch.square(x).mean(dim=red)])
    if mesh is not None:
        stats = pmean(stats, axis_name, mesh)
    return stats[0], stats[1]
