"""The sharded embedding engine: the recommender path, as a per-rank program.

Counterpart of ``incubator_mxnet_tpu/parallel/embedding.py`` (the
reference's row-sparse KVStore capability, ref: include/mxnet/kvstore.h:209
PullRowSparse; the sparse updaters of src/operator/optimizer_op.cc):

  * tables row-sharded over one mesh axis (``MXTPU_EMBED_AXIS``, default
    ``data``): each rank of the axis holds only its own ``rows / n_shards``
    rows (``init_table`` makes them there, from a seed);
  * a step deduplicates its feature ids BEFORE any communication
    (``mxtpu_embed_dedup_ratio``), sends only the unique row requests to
    their home ranks in one all-to-all (``collectives.raw_all_to_all``),
    each rank serves its resident rows in a second one, and the rows go
    back to batch positions through the inverse map;
  * the backward is a sum by unique row (``index_add_``), sent home in a
    third all-to-all, summed again where two ranks asked for one row, and
    applied by the lazy row update of ``ops/cuda/multi_tensor.py``
    (``update_rows``: the ``row_sparse_update`` kernel on the card, its
    twin on the CPU): no (rows, dim) gradient ever exists
    (``mxtpu_embed_dense_densify_total`` stays 0), and the hypers come
    from ``Optimizer.fused_hypers`` every step, so a learning-rate schedule
    takes effect with nothing rebuilt;
  * tables checkpoint shard by shard through ``fault.CheckpointManager``
    (``table_writer``: every rank writes its own rows into the same staged
    directory; rank 0 writes the manifest and publishes) and restore onto
    any number of ranks (``load_table``: re-padded, re-sharded).

Shapes are static and nothing syncs the host on the step's path: dedup is
a values-only sort with capacity n (the id count) and -1 in the unused
slots; the request matrix has n slots a peer, exact under any skew.
PyTorch's scatters do not drop out-of-range indices as JAX's
``mode="drop"`` does (a CUDA device assert instead), so every scatter that
may see an id past the table writes into one extra dump row or slot that is
cut off afterwards, and every gather is clamped and masked.

Sums by segment use ``index_add_``, whose CUDA order of additions is the
atomics' (run to run, sums of values that are not exactly representable
may differ in the last bit); the tests use the reference's grid values,
under which every order is exact.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as _np
import torch

from . import collectives as _coll
from .mesh import P, _block, get_mesh

__all__ = ["embed_axis", "dedup_enabled", "hoist_enabled", "dedup_ids",
           "dedup_take", "pad_rows", "init_table", "table_sharding",
           "rows_override", "make_sharded_train_step", "ShardedTrainState",
           "table_writer", "note_dedup", "note_dedup_stats", "load_table",
           "reshard_table", "DEDUP_RATIO_GAUGE", "DENSIFY_COUNTER",
           "SORTS_COUNTER", "SORTS_GAUGE", "ROUTE_RECOMPUTE_COUNTER"]

DEDUP_RATIO_GAUGE = "mxtpu_embed_dedup_ratio"
DENSIFY_COUNTER = "mxtpu_embed_dense_densify_total"
# route-plan sort accounting: the dedup sort (and, without dedup, the
# home-shard bucketing argsort) is the O(n log n) cost of a step; the
# counter and gauge pin that the update phase re-derives none of them
# when the plan is hoisted
SORTS_COUNTER = "mxtpu_embed_sorts_total"
SORTS_GAUGE = "mxtpu_embed_sorts_per_step"
ROUTE_RECOMPUTE_COUNTER = "mxtpu_embed_route_recomputes_total"

#: rows a generator chunk of ``init_table`` (a table's values do not
#: depend on how many ranks make it)
INIT_CHUNK_ROWS = 1 << 20


# ----------------------------------------------------------------- knobs
def embed_axis() -> str:
    """Mesh axis the tables shard over (``MXTPU_EMBED_AXIS``, default
    ``data``: the DLRM layout, each rank serving rows to the batch shard
    it also computes)."""
    return os.environ.get("MXTPU_EMBED_AXIS", "data")


def dedup_enabled() -> bool:
    """Dedup before the all-to-all is the default; ``MXTPU_EMBED_DEDUP=0``
    makes every id its own request (the traffic without dedup, kept for
    A/B measurement)."""
    return os.environ.get("MXTPU_EMBED_DEDUP", "1") not in ("0", "off")


def hoist_enabled() -> bool:
    """The gather phase's route plan (unique slots, inverse map, home
    buckets, received requests) is handed to the update phase by default;
    ``MXTPU_EMBED_HOIST=0`` re-derives it from the same ids there (one
    more sort and one more request all-to-all a table a step)."""
    return os.environ.get("MXTPU_EMBED_HOIST", "1") not in ("0", "off")


# ----------------------------------------------------------- accounting
# The sorts a step runs, noted as they run into the tally a step opens.
_TALLY = threading.local()


@contextlib.contextmanager
def _tally_scope(tally: Dict[str, int]):
    prev = getattr(_TALLY, "d", None)
    _TALLY.d = tally
    try:
        yield tally
    finally:
        _TALLY.d = prev


def _tally_note(key: str, n: int = 1) -> None:
    d = getattr(_TALLY, "d", None)
    if d is not None:
        d[key] = d.get(key, 0) + n


def note_dedup(total: int, unique: int) -> None:
    """Publish the dedup-ratio gauge (the engine, ``kvstore``'s
    ``row_sparse_pull`` and the chip phase share it)."""
    from .. import telemetry as _telemetry
    _telemetry.gauge(
        DEDUP_RATIO_GAUGE,
        "ids per unique row in the last embedding gather (>=1; higher "
        "means dedup saved more gather/collective traffic).").set(
            float(total) / max(1.0, float(unique)))


# ------------------------------------------------------------ dedup core
def _dedup_core(flat, note: bool = True):
    """Static-shape unique by a values-only sort: ``(uniq, inv, count)``,
    ``uniq`` the ascending unique ids then -1 up to n, ``inv`` each
    input's slot (found by a binary search of the sorted values), ``count``
    a 0-d device tensor. int64 throughout (the row kernel's id type)."""
    flat = flat.reshape(-1).long()
    n = flat.shape[0]
    if note:
        _tally_note("sorts")
    if n == 0:
        return flat, flat, torch.zeros((), dtype=torch.int64,
                                       device=flat.device)
    s = torch.sort(flat).values
    first = torch.ones(n, dtype=torch.bool, device=flat.device)
    first[1:] = s[1:] != s[:-1]
    slot = torch.cumsum(first, 0) - 1
    count = slot[-1] + 1
    uniq = torch.full((n,), -1, dtype=torch.int64, device=flat.device)
    uniq.scatter_(0, slot, s)          # duplicates write the same value
    inv = slot[torch.searchsorted(s, flat)]
    return uniq, inv, count


def dedup_ids(flat):
    """``(uniq, inv, count)`` of the ids ``flat`` (any shape): ``uniq``
    has capacity n with -1 past ``count``; ``uniq_rows[inv]`` gives back
    the per-position rows."""
    return _dedup_core(flat)


def _trivial_plan(flat):
    """Dedup off: every position is its own slot."""
    flat = flat.reshape(-1).long()
    n = flat.shape[0]
    return (flat, torch.arange(n, device=flat.device),
            torch.tensor(n, device=flat.device))


def _plan(flat, dedup: bool):
    return dedup_ids(flat) if dedup else _trivial_plan(flat)


def _masked_rows(table, ids):
    """``table[ids]`` with ids outside [0, rows) read as zero rows."""
    rows = table.shape[0]
    ok = (ids >= 0) & (ids < rows)
    got = table.index_select(0, ids.clamp(0, max(rows - 1, 0)))
    return torch.where(ok.view((-1,) + (1,) * (table.dim() - 1)), got,
                       torch.zeros((), dtype=table.dtype,
                                   device=table.device))


def dedup_take(table, ids, dedup: bool = True, with_plan: bool = False):
    """One-shard dedup gather: the rows of ``table`` (R, D) for ``ids``
    (any shape), each unique row read once. Returns (out ids.shape + (D,),
    count), and the (uniq, inv) plan with ``with_plan``. Ids outside the
    table (negative sentinels, overflow) give zero rows."""
    ids = torch.as_tensor(ids, device=table.device)
    uniq, inv, count = _plan(ids.reshape(-1), dedup)
    out = _masked_rows(table, uniq).index_select(0, inv).reshape(
        tuple(ids.shape) + tuple(table.shape[1:]))
    if with_plan:
        return out, count, (uniq, inv)
    return out, count


def _take_from_plan(table, plan, ids_shape):
    """Local gather from a hoisted (uniq, inv) plan; ``dedup_take``'s drop
    contract."""
    uniq, inv = plan
    return _masked_rows(table, uniq).index_select(0, inv).reshape(
        tuple(ids_shape) + tuple(table.shape[1:]))


# ------------------------------------------------- sharded gather/update
def _route(flat, rps: int, n_shards: int, dedup: bool,
           recompute: bool = False):
    """The request plan shared by the sharded gather and its update:
    dedup, then bucket the unique ids by home rank into the (S, n) request
    matrix (-1 in unused slots). Ids outside the table become one past it
    first (home S, never sent, zero rows, gradients dropped), which keeps
    the sorted uniques' homes non-decreasing."""
    if recompute:
        _tally_note("route_recomputes")
    total = rps * n_shards
    flat = flat.reshape(-1).long()
    flat = torch.where((flat < 0) | (flat >= total),
                       torch.full_like(flat, total), flat)
    uniq, inv, count = _plan(flat, dedup)
    n = uniq.shape[0]
    home = torch.where(uniq >= 0, torch.div(uniq, rps, rounding_mode="floor"),
                       torch.full_like(uniq, n_shards)).clamp(max=n_shards)
    if dedup:
        # ascending uniques with the -1 pads at home S: already bucketed
        order = torch.arange(n, device=flat.device)
        sh, su = home, uniq
    else:
        _tally_note("sorts")
        order = torch.sort(home, stable=True).indices
        sh, su = home[order], uniq[order]
    start = torch.searchsorted(sh, sh)
    off = torch.arange(n, device=flat.device) - start
    # row S of the buffer is the dump for requests never sent
    req = torch.full((n_shards + 1, n), -1, dtype=torch.int64,
                     device=flat.device)
    req[sh, off] = su
    return dict(uniq=uniq, inv=inv, count=count, order=order, sh=sh,
                off=off, req=req[:n_shards], n=n)


def _serve(table_l, recv, my0: int):
    """This rank's rows for the received requests (S, n): zero rows for -1
    slots and ids homed elsewhere."""
    rps = table_l.shape[0]
    loc = recv.reshape(-1) - my0
    loc = torch.where(recv.reshape(-1) >= 0, loc, torch.full_like(loc, -1))
    return _masked_rows(table_l, loc).reshape(
        tuple(recv.shape) + tuple(table_l.shape[1:]))


def _rows_back(back, sh, off, order, inv, ids_shape, n_shards):
    """The rows of the unique slots from the rows each peer sent back, at
    batch positions."""
    tail = tuple(back.shape[2:])
    rows_sorted = back[sh.clamp(max=n_shards - 1), off]
    rows_sorted = torch.where(
        (sh < n_shards).view((-1,) + (1,) * len(tail)), rows_sorted,
        torch.zeros((), dtype=back.dtype, device=back.device))
    uniq_rows = torch.zeros_like(rows_sorted).index_copy_(0, order,
                                                          rows_sorted)
    return uniq_rows.index_select(0, inv).reshape(tuple(ids_shape) + tail)


def _shard_gather(table_l, ids_l, axis: str, n_shards: int, dedup: bool,
                  mesh=None, with_plan: bool = False):
    """This rank's gather: dedup its local ids, request the unique rows
    from their home ranks (one all-to-all of ids), serve its own resident
    rows (one all-to-all of rows), and put the returned rows at batch
    positions. Returns (rows of the local batch, [n_ids], [n_unique]) and,
    with ``with_plan``, the plan the update phase consumes (inv, order,
    sh, off, the received requests)."""
    mesh = mesh or get_mesh()
    rps = table_l.shape[0]
    ids_l = torch.as_tensor(ids_l, device=table_l.device)
    pl = _route(ids_l, rps, n_shards, dedup)
    recv = _coll.raw_all_to_all(pl["req"], axis, 0, 0, mesh)
    my0 = _coll.axis_index(axis, mesh) * rps
    back = _coll.raw_all_to_all(_serve(table_l, recv, my0), axis, 0, 0,
                                mesh)
    out = _rows_back(back, pl["sh"], pl["off"], pl["order"], pl["inv"],
                     ids_l.shape, n_shards)
    base = (out, torch.tensor([ids_l.numel()], device=table_l.device),
            pl["count"].reshape(1))
    if not with_plan:
        return base
    return base + (pl["inv"], pl["order"], pl["sh"], pl["off"], recv)


def _shard_gather_from_plan(table_l, ids_shape, inv, order, sh, off, recv,
                            axis: str, n_shards: int, mesh=None):
    """A second table fed by the same ids (an FM's linear and factor
    tables) served from the hoisted plan: no sort, no request round trip,
    just the rows' all-to-all."""
    mesh = mesh or get_mesh()
    my0 = _coll.axis_index(axis, mesh) * table_l.shape[0]
    back = _coll.raw_all_to_all(_serve(table_l, recv, my0), axis, 0, 0,
                                mesh)
    return _rows_back(back, sh, off, order, inv, ids_shape, n_shards)


def _segment_sum(values, seg, num: int):
    """``values`` (k, ...) summed by segment id ``seg`` into ``num`` rows."""
    out = torch.zeros((num,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, seg, values)


def _reverse_route(gout_l, recv, inv, order, sh, off, table_l, state_l,
                   update, axis: str, n_shards: int, mesh=None):
    """The update phase from the plan alone: the batch cotangent summed by
    unique slot, sent home (one all-to-all), summed again where two ranks
    asked for the same row, then the lazy row update of this rank's rows.
    The (rows, dim) gradient never exists."""
    mesh = mesh or get_mesh()
    rps = table_l.shape[0]
    tail = tuple(table_l.shape[1:])
    my0 = _coll.axis_index(axis, mesh) * rps
    n = inv.shape[0]
    d_uniq = _segment_sum(gout_l.reshape((-1,) + tail), inv, n)
    send = torch.zeros((n_shards + 1, n) + tail, dtype=gout_l.dtype,
                       device=gout_l.device)
    send[sh, off] = d_uniq.index_select(0, order)
    got = _coll.raw_all_to_all(send[:n_shards].contiguous(), axis, 0, 0,
                               mesh)
    flat_ids = recv.reshape(-1)
    loc = flat_ids - my0
    ok = (flat_ids >= 0) & (loc >= 0) & (loc < rps)
    tgt = torch.where(ok, loc, torch.full_like(loc, rps))
    # receiver-side aggregation (not route planning: not counted as a
    # route sort)
    uniq2, inv2, _ = _dedup_core(tgt, note=False)
    g_rows = _segment_sum(got.reshape((-1,) + tail), inv2, tgt.shape[0])
    row_ids = torch.where(uniq2 >= 0, uniq2, torch.full_like(uniq2, rps))
    return update(table_l, state_l, row_ids, g_rows)


def _shard_update(table_l, state_l, ids_l, gout_l, update, axis: str,
                  n_shards: int, dedup: bool, mesh=None):
    """The update phase without the hoisted plan (``MXTPU_EMBED_HOIST=0``):
    the route re-derived from the gather's ids (one more sort and one more
    request all-to-all, counted in ``mxtpu_embed_route_recomputes_total``)."""
    mesh = mesh or get_mesh()
    ids_l = torch.as_tensor(ids_l, device=table_l.device)
    pl = _route(ids_l, table_l.shape[0], n_shards, dedup, recompute=True)
    recv = _coll.raw_all_to_all(pl["req"], axis, 0, 0, mesh)
    return _reverse_route(gout_l, recv, pl["inv"], pl["order"], pl["sh"],
                          pl["off"], table_l, state_l, update, axis,
                          n_shards, mesh)


def _shard_update_hoisted(table_l, state_l, gout_l, update, inv, order, sh,
                          off, recv, axis: str, n_shards: int, mesh=None):
    """The update phase on the gather's plan: no ids, no sort, no request
    round trip."""
    return _reverse_route(gout_l, recv, inv, order, sh, off, table_l,
                          state_l, update, axis, n_shards, mesh)


def _local_update(table, state, gout, update, dedup: bool, ids=None,
                  plan=None):
    """One-shard update: ``plan`` = (uniq, inv) from the gather, or (with
    ``MXTPU_EMBED_HOIST=0``) re-derived from ``ids``."""
    if plan is not None:
        uniq, inv = plan
    else:
        _tally_note("route_recomputes")
        uniq, inv, _ = _plan(ids.reshape(-1), dedup)
    tail = tuple(table.shape[1:])
    d_uniq = _segment_sum(gout.reshape((-1,) + tail), inv, uniq.shape[0])
    if not dedup:
        # the trivial plan's slots are not unique rows: aggregate first
        uniq, inv2, _ = dedup_ids(uniq)
        d_uniq = _segment_sum(d_uniq, inv2, uniq.shape[0])
    rows = table.shape[0]
    row_ids = torch.where((uniq >= 0) & (uniq < rows), uniq,
                          torch.full_like(uniq, rows))
    return update(table, state, row_ids, d_uniq)


# ----------------------------------------------------------- table setup
def pad_rows(rows: int, n_shards: int) -> int:
    """Logical rows padded up so every shard holds equally many."""
    return int(math.ceil(rows / max(1, n_shards)) * max(1, n_shards))


def table_sharding(mesh=None, axis: Optional[str] = None):
    """``P(axis)`` (dim 0 on the embedding axis), or None when no mesh is
    current, the axis is absent or has one rank."""
    mesh = mesh if mesh is not None else get_mesh()
    axis = axis or embed_axis()
    if mesh is None or axis not in mesh.axis_names or mesh.shape[axis] <= 1:
        return None
    return P(axis)


def _layout(mesh=None, axis: Optional[str] = None):
    """(mesh or None, axis, shards, this rank's shard index)."""
    mesh = mesh if mesh is not None else get_mesh()
    axis = axis or embed_axis()
    if table_sharding(mesh, axis) is None:
        return None, axis, 1, 0
    return mesh, axis, mesh.shape[axis], mesh.axis_index(axis)


def _device_for(mesh, device):
    if device is not None:
        return torch.device(device)
    if mesh is not None:
        return mesh.device
    from ..context import current_context
    return current_context().torch_device


def init_table(rows: int, dim: int, mesh=None, axis: Optional[str] = None,
               dtype=torch.float32, key=0, scale: Optional[float] = None,
               device=None):
    """This rank's rows of a (padded_rows, dim) table, made on its device
    (a 100M-row table is born sharded: no process holds the whole).
    Values are normal * ``scale`` (default 1 / sqrt(dim)) from generators
    seeded by ``key`` (an int) and the index of each
    :data:`INIT_CHUNK_ROWS`-row chunk, so a row's value does not depend on
    the number of ranks. Padding rows are zero."""
    mesh, axis, n_shards, idx = _layout(mesh, axis)
    dev = _device_for(mesh, device)
    padded = pad_rows(rows, n_shards)
    rps = padded // n_shards
    lo, hi = idx * rps, (idx + 1) * rps
    scale = scale if scale is not None else 1.0 / math.sqrt(dim)
    out = torch.zeros((rps, dim), dtype=dtype, device=dev)
    gen = torch.Generator(device=dev)
    for c in range(lo // INIT_CHUNK_ROWS,
                   -(-min(hi, rows) // INIT_CHUNK_ROWS)):
        c0 = c * INIT_CHUNK_ROWS
        c1 = min(rows, c0 + INIT_CHUNK_ROWS)
        gen.manual_seed(int(key) * 1_000_003 + c)
        vals = torch.randn((c1 - c0, dim), generator=gen, device=dev,
                           dtype=torch.float32)
        a, b = max(lo, c0), min(hi, c1)
        if a < b:
            out[a - lo:b - lo] = (vals[a - c0:b - c0] * scale).to(dtype)
    return out


# --------------------------------------------------- forward-rows bridge
_OVERRIDE = threading.local()


class rows_override:
    """Context mapping a table parameter's name to the rows of the batch
    gathered outside the differentiated loss: each ``ShardedEmbedding``
    under it returns these instead of looking up its table."""

    def __init__(self, mapping: Dict[str, Any]):
        self._mapping = mapping

    def __enter__(self):
        self._prev = getattr(_OVERRIDE, "rows", None)
        _OVERRIDE.rows = self._mapping
        return self

    def __exit__(self, *exc):
        _OVERRIDE.rows = self._prev


def override_rows_for(name: str):
    m = getattr(_OVERRIDE, "rows", None)
    return None if m is None else m.get(name)


# ------------------------------------------------------------- the step
class ShardedTrainState:
    """The step's state: dense parameters and their optimizer state
    (replicated), this rank's table shards and their state, the aux values.
    The step updates the tensors in place. ``tables[name]`` holds this
    rank's rows; ``table(name)`` is the logical table (gathered from every
    rank of the axis on a mesh: a collective every rank calls)."""

    def __init__(self, dense, dense_states, tables, table_states,
                 logical_rows, aux, mesh=None, axis=None):
        self.dense = dense
        self.dense_states = dense_states
        self.tables = tables
        self.table_states = table_states
        self.logical_rows = logical_rows
        self.aux = aux
        self.mesh = mesh
        self.axis = axis

    def table(self, name: str):
        t = self.tables[name]
        if self.mesh is not None:
            t = _coll.raw_all_gather(t, self.axis, 0, self.mesh)
        return t[:self.logical_rows[name]]


def _zeros_state(struct, like):
    if struct is None:
        return None
    if isinstance(struct, torch.Tensor):
        return torch.zeros_like(like)
    return tuple(_zeros_state(s, like) for s in struct)


def _table_block(arr, logical: int, n_shards: int, idx: int, dev):
    """This rank's rows of a table parameter that holds the whole table
    (logical or padded), padded for ``n_shards``."""
    padded = pad_rows(logical, n_shards)
    rps = padded // n_shards
    lo = idx * rps
    out = torch.zeros((rps,) + tuple(arr.shape[1:]), dtype=arr.dtype,
                      device=dev)
    hi = min(lo + rps, min(logical, arr.shape[0]))
    if hi > lo:
        out[:hi - lo] = arr[lo:hi].to(dev)
    return out


def make_sharded_train_step(net, loss_fn, optimizer="sgd",
                            optimizer_params: Optional[Dict] = None,
                            mesh=None, axis: Optional[str] = None,
                            batch_axis: Optional[str] = None,
                            donate: bool = True,
                            dedup: Optional[bool] = None):
    """Build the train step of a net holding ``gluon.nn.ShardedEmbedding``
    blocks.

    The net implements ``sparse_ids(*inputs) -> {table parameter name:
    ids}`` (``models.sparse_recommenders.DLRM``). A step, on each rank:
    the dedup gather outside autograd (with a mesh axis of several ranks,
    the two all-to-alls of ``_shard_gather``); the forward and backward
    over (dense parameters, gathered rows) with the rows handed in through
    ``rows_override`` as leaf tensors; the dense updates in one
    ``multi_tensor_update`` launch on the card (``update_tensors``, its
    plan built once for the tower's fixed layout) for the rules the fused
    step's kernel takes, else by the optimizer's ``tensor_step`` (counted
    by route in ``step.dense_routes``); the lazy row updates
    (``update_rows``: one ``row_sparse_update`` launch a table on the card
    for the kernel's rules, SGD, Adam and AdamW; any other rule takes
    ``tensor_step`` on the rows, counted by route in ``step.routes``).
    Hypers come from ``Optimizer.fused_hypers`` every step.

    On a mesh, inputs are the global batch (the same on every rank); each
    rank takes its block over ``batch_axis`` (which must be the table's
    axis), the loss is the global batch's mean (each rank's mean over its
    block, averaged over the axis), and the dense gradients are summed
    over the axis. ``donate`` is the reference's flag: the port always
    updates in place.

    Returns ``(step, state)``; ``step(state, *inputs, y, key=None) ->
    (state, loss, dedup_stats)`` with ``key`` a ``torch.Generator`` (or
    None) for the forward's random draws and ``dedup_stats`` {table: (ids,
    unique ids)} this rank's device scalars. Each ShardedEmbedding must be
    looked up once a forward with the ids ``sparse_ids`` reports.
    """
    from .. import telemetry as _telemetry
    from ..ndarray.ndarray import NDArray, _wrap
    from ..ops.cuda import multi_tensor as _mt
    from ..optimizer import optimizer as _om
    from ..optimizer.fused import kernel_route

    opt = optimizer if isinstance(optimizer, _om.Optimizer) \
        else _om.create(optimizer, **(optimizer_params or {}))
    if not opt.supports_fused():
        raise ValueError(f"{type(opt).__name__} has no pure tensor_step; "
                         "the sharded step needs one")
    if not hasattr(net, "sparse_ids"):
        raise TypeError(
            "make_sharded_train_step needs net.sparse_ids(*inputs) -> "
            "{table_param_name: ids} (see models.sparse_recommenders.DLRM)")
    mesh, axis, n_shards, shard_idx = _layout(mesh, axis)
    batch_axis = batch_axis or axis
    if mesh is not None and batch_axis != axis:
        raise ValueError(f"the batch axis {batch_axis!r} must be the table "
                         f"axis {axis!r}")
    dedup = dedup_enabled() if dedup is None else bool(dedup)

    all_params = net.collect_params()
    table_params = {n: p for n, p in all_params.items()
                    if getattr(p, "_embed_shard", None) is not None}
    dense_params = {n: p for n, p in all_params.items()
                    if n not in table_params and p.grad_req != "null"}
    aux_params = {n: p for n, p in all_params.items()
                  if n not in table_params and p.grad_req == "null"}
    if not table_params:
        raise ValueError("the net holds no ShardedEmbedding")

    tables0, logical, tstate0 = {}, {}, {}
    dev = None
    for n, p in table_params.items():
        arr = p.data()._data
        logical[n] = int(p._embed_shard["input_dim"])
        born = p._embed_shard.get("shards")
        dev = _device_for(mesh, None) if mesh is not None else arr.device
        if born is not None and born == (n_shards, shard_idx):
            t = arr.to(dev)                # already this rank's rows
        else:
            t = _table_block(arr, logical[n], n_shards, shard_idx, dev)
        tables0[n] = t.contiguous()
        probe = opt.create_state(n, _wrap(torch.zeros(
            (1,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)))
        tstate0[n] = _zeros_state(_om._state_tensors(probe), t)

    def _dense_value(p):
        v = p.data()._data
        return v.to(dev) if dev is not None else v

    dense0 = {n: _dense_value(p).clone() for n, p in dense_params.items()}
    aux0 = {n: _dense_value(p).clone() for n, p in aux_params.items()}
    dstate0 = {n: _om._state_tensors(opt.create_state(n, _wrap(w)))
               for n, w in dense0.items()}
    table_names = sorted(tables0)
    dense_names = list(dense0)
    state = ShardedTrainState(dense0, dstate0, tables0, tstate0, logical,
                              aux0, mesh, axis if mesh is not None else None)
    hoist = hoist_enabled()
    row_kernel = kernel_route(opt) and \
        opt.multi_tensor_kind() in _mt.ROW_KINDS
    routes = {"kernel": 0, "twin": 0, "tensor_step": 0}
    dense_routes = dict(routes)
    dense_kernel = bool(dense_names) and kernel_route(opt)
    dense_plan = None
    if dense_kernel and dense0[dense_names[0]].is_cuda:
        # the tower's layout is fixed: one table layout for every step
        dense_plan = _mt.Plan(
            [dense0[n].numel() for n in dense_names],
            [_mt.storage_code(dense0[n], dense0[n], [
                t for t in _mt._leaves(dstate0[n]) if t is not None])
             for n in dense_names])
    _telemetry.gauge("sharded_step_compiles").inc()

    def _update_for(h):
        def update(table, st, row_ids, g_rows):
            if row_kernel:
                r = _mt.update_rows(opt.multi_tensor_kind(), opt.tensor_step,
                                    table, st, row_ids, g_rows, h,
                                    opt.multi_tensor_hypers(h))
            else:
                _mt.row_sparse_update_reference(opt.tensor_step, table, st,
                                                row_ids, g_rows, h)
                r = "tensor_step"
            routes[r] += 1
            return table, st
        return update

    def _local_inputs(x):
        x = x._data if isinstance(x, NDArray) else torch.as_tensor(x)
        if mesh is not None:
            x = _block(x, P(batch_axis), mesh)
        return x.to(dev) if dev is not None else x

    tally: Dict[str, int] = {}

    def step(st: ShardedTrainState, *inputs_and_y, key=None):
        *inputs, y = inputs_and_y
        inputs = [_local_inputs(x) for x in inputs]
        y = _local_inputs(y)
        tally.clear()
        with _tally_scope(tally), torch.no_grad():
            hypers = {}
            for n in dense_names + table_names:
                opt._update_count(n)
                hypers[n] = opt.fused_hypers(n)
            ids_map = {n: (v._data if isinstance(v, NDArray) else v)
                       for n, v in net.sparse_ids(
                           *[_wrap(x) for x in inputs]).items()}
            missing = set(table_names) - set(ids_map)
            if missing:
                raise ValueError(f"sparse_ids did not cover tables {missing}")

            # phase 1: the dedup gather, outside the differentiated loss;
            # tables fed by one id tensor share one plan
            rows_map, stats, plans, cache = {}, {}, {}, {}
            for n in table_names:
                ids = ids_map[n]
                pkey = id(ids)
                if mesh is not None:
                    cached = cache.get(pkey) if hoist else None
                    if cached is None:
                        res = _shard_gather(st.tables[n], ids, axis,
                                            n_shards, dedup, mesh,
                                            with_plan=hoist)
                        out, tot, cnt = res[:3]
                        if hoist:
                            plans[n] = res[3:]
                            cache[pkey] = (plans[n], tot, cnt)
                    else:
                        plans[n], tot, cnt = cached
                        out = _shard_gather_from_plan(
                            st.tables[n], ids.shape, *plans[n], axis,
                            n_shards, mesh)
                    stats[n] = (tot.sum(), cnt.sum())
                else:
                    cached = cache.get(pkey) if hoist else None
                    if cached is None:
                        out, cnt, plan = dedup_take(st.tables[n], ids, dedup,
                                                    with_plan=True)
                        if hoist:
                            plans[n] = plan
                            cache[pkey] = (plan, cnt)
                    else:
                        plans[n], cnt = cached
                        out = _take_from_plan(st.tables[n], plans[n],
                                              ids.shape)
                    stats[n] = (torch.tensor(ids.numel(), device=out.device),
                                cnt)
                rows_map[n] = out

        # phase 2: loss and gradients w.r.t. (dense parameters, rows)
        leaves = {n: st.dense[n].detach().requires_grad_(True)
                  for n in dense_names}
        row_leaves = {n: r.requires_grad_(True) for n, r in rows_map.items()}
        with torch.enable_grad():
            merged = dict(leaves)
            merged.update(st.aux)
            with rows_override(row_leaves):
                loss = _forward_loss(net, loss_fn, merged, inputs, y, key)
            # a replicated loss seeds 1 / shards: the global batch's mean
            grads = torch.autograd.grad(
                loss / n_shards,
                [leaves[n] for n in dense_names]
                + [row_leaves[n] for n in table_names], allow_unused=True)
        dgrads = [torch.zeros_like(st.dense[n]) if g is None else g
                  for n, g in zip(dense_names, grads[:len(dense_names)])]
        rgrads = {n: (torch.zeros_like(rows_map[n]) if g is None else g)
                  for n, g in zip(table_names, grads[len(dense_names):])}

        with _tally_scope(tally), torch.no_grad():
            if mesh is not None:
                if dgrads:
                    dgrads = _coll.sum_replicas(dgrads,
                                                [P()] * len(dgrads), mesh)
                loss = _coll.raw_all_reduce(loss.detach(), axis, "sum",
                                            mesh) / n_shards
            # phase 3a: the dense updates, in place
            if dense_names:
                ws = [st.dense[n] for n in dense_names]
                sts = [st.dense_states[n] for n in dense_names]
                hs = [hypers[n] for n in dense_names]
                if dense_kernel:
                    r = _mt.update_tensors(
                        opt.multi_tensor_kind(), opt.tensor_step,
                        dense_plan, ws, dgrads, sts, hs,
                        [opt.multi_tensor_hypers(h) for h in hs])
                else:
                    _mt.multi_tensor_update_reference(opt.tensor_step, ws,
                                                      dgrads, sts, hs)
                    r = "tensor_step"
                dense_routes[r] += 1
            # phase 3b: the lazy row updates (zero route recomputes when
            # the plan is hoisted)
            for n in table_names:
                update = _update_for(hypers[n])
                if mesh is not None:
                    if hoist:
                        _shard_update_hoisted(
                            st.tables[n], st.table_states[n], rgrads[n],
                            update, *plans[n], axis, n_shards, mesh)
                    else:
                        _shard_update(st.tables[n], st.table_states[n],
                                      ids_map[n], rgrads[n], update, axis,
                                      n_shards, dedup, mesh)
                else:
                    _local_update(st.tables[n], st.table_states[n],
                                  rgrads[n], update, dedup,
                                  ids=None if hoist else ids_map[n],
                                  plan=plans.get(n))
        per_step = tally.get("sorts", 0)
        _telemetry.counter(
            SORTS_COUNTER,
            "route-plan sorts (id-dedup + home-shard bucketing argsorts) "
            "executed per sharded-embedding train step; hoisting halves "
            "this vs the recompute path").inc(per_step)
        _telemetry.gauge(
            SORTS_GAUGE,
            "route-plan sorts in one sharded train step").set(per_step)
        _telemetry.counter(
            ROUTE_RECOMPUTE_COUNTER,
            "update-phase route-plan recomputations per step (0 when "
            "hoisting threads the gather-phase residuals)").inc(
                tally.get("route_recomputes", 0))
        return st, loss.detach(), stats

    step.optimizer = opt
    step.routes = routes
    step.dense_routes = dense_routes
    step.plan_sorts_per_step = lambda: tally.get("sorts", 0)
    return step, state


def _forward_loss(net, loss_fn, merged, inputs, y, key):
    """The float32 mean loss of ``functional_call`` without the tables in
    the substitution map (they are read through ``rows_override``)."""
    from ..autograd import _functional_trace
    from ..ndarray.ndarray import NDArray, _wrap
    from .dp import functional_call
    out = functional_call(net, merged, *inputs, training=True, rng_key=key)
    if isinstance(out, tuple):
        out = out[0]
    with _functional_trace():
        loss = loss_fn(_wrap(out), _wrap(y))
    if isinstance(loss, NDArray):
        loss = loss._data
    return loss.float().mean()


def note_dedup_stats(stats: Dict[str, Tuple]) -> float:
    """Fetch a step's dedup stats (a host sync), publish the gauge, and
    return the ratio over every table (1.0 when nothing was gathered)."""
    tot = sum(int(t) for t, _ in stats.values())
    unq = sum(int(u) for _, u in stats.values())
    note_dedup(tot, max(1, unq))
    return float(tot) / max(1.0, float(unq))


# ------------------------------------------------------- checkpointing
def table_writer(name: str, table, state=None, logical_rows=None,
                 shard_rows: int = 1 << 22, mesh=None,
                 axis: Optional[str] = None):
    """A ``writers=`` callback of ``fault.CheckpointManager.save``: the
    table (this rank's rows when it is sharded over ``axis`` of ``mesh``
    or the current mesh) and its optimizer state leaves are copied on the
    device now, then written ``shard_rows`` rows a file when the manager
    calls it with its staged directory. On a mesh every rank writes its
    own files (``{name}.table.{rank}.{j}.npy``) into the same directory
    and rank 0 writes ``{name}.table.json``; the manager sees
    ``write.collective`` and saves collectively."""
    mesh, axis, n_shards, idx = _layout(mesh, axis)
    snap = table.detach().clone()
    leaves = []
    if state is not None:
        from ..ops.cuda.multi_tensor import _leaves
        leaves = [s.detach().clone() for s in _leaves(state)
                  if s is not None]
    rps = int(snap.shape[0])
    logical = int(logical_rows if logical_rows is not None
                  else rps * n_shards)
    n_files = max(1, math.ceil(rps / shard_rows))
    # ranks that replicate this shard over other axes leave it to the one
    # at index 0 of each of them
    writes = mesh is None or all(c == 0 for a, c in mesh.coords.items()
                                 if a != axis)

    def write(tmp):
        if idx == 0 and writes:
            meta = {"name": name, "rows": rps * n_shards,
                    "logical_rows": logical,
                    "dim": list(snap.shape[1:]),
                    "dtype": str(snap.dtype).replace("torch.", ""),
                    "ranks": n_shards, "rows_per_rank": rps,
                    "files_per_rank": n_files,
                    "state_leaves": len(leaves)}
            with open(os.path.join(tmp, f"{name}.table.json"), "w") as f:
                json.dump(meta, f)
        if not writes:
            return
        for j in range(n_files):
            lo, hi = j * shard_rows, min(rps, (j + 1) * shard_rows)
            _np.save(os.path.join(tmp, f"{name}.table.{idx}.{j}.npy"),
                     snap[lo:hi].cpu().numpy())
            for li, leaf in enumerate(leaves):
                _np.save(os.path.join(tmp, f"{name}.state{li}.{idx}.{j}.npy"),
                         leaf[lo:hi].cpu().numpy())
    write.collective = (mesh, axis) if mesh is not None else None
    return write


def _read_rows(step_dir: str, prefix: str, meta) -> _np.ndarray:
    parts = [_np.load(os.path.join(step_dir, f"{prefix}.{r}.{j}.npy"))
             for r in range(meta["ranks"])
             for j in range(meta["files_per_rank"])]
    return _np.concatenate(parts)[:meta["logical_rows"]]


def load_table(step_dir: str, name: str, mesh=None,
               axis: Optional[str] = None, state_struct=None, device=None,
               shard: Optional[Tuple[int, int]] = None):
    """Restore a table saved by ``table_writer`` onto the current mesh (or
    ``mesh``), whatever the number of ranks that wrote it: the logical rows
    are re-padded for this mesh's shard count and this rank's rows
    returned (the whole table without a mesh). ``shard`` = (shards, index)
    names the rows to return without a mesh. ``state_struct`` (a state
    tree of the optimizer) restores the state leaves too. Returns (table,
    state or None)."""
    with open(os.path.join(step_dir, f"{name}.table.json")) as f:
        meta = json.load(f)

    def place(full):
        return _repad_and_place(full, meta["logical_rows"], mesh, axis,
                                device, shard)
    table = place(_read_rows(step_dir, f"{name}.table", meta))
    state = None
    if meta.get("state_leaves") and state_struct is not None:
        leaves = iter([place(_read_rows(step_dir, f"{name}.state{li}", meta))
                       for li in range(meta["state_leaves"])])

        def rebuild(s):
            if s is None:
                return None
            if isinstance(s, torch.Tensor):
                return next(leaves)
            return tuple(rebuild(x) for x in s)
        state = rebuild(state_struct)
    return table, state


def _repad_and_place(full, logical_rows: int, mesh=None,
                     axis: Optional[str] = None, device=None,
                     shard: Optional[Tuple[int, int]] = None):
    """This rank's rows of the logical table ``full`` (numpy or a tensor),
    padded for the (new) mesh's shard count, or for ``shard`` = (shards,
    index) without a mesh."""
    if shard is None:
        mesh, axis, n_shards, idx = _layout(mesh, axis)
        dev = _device_for(mesh, device)
    else:
        (n_shards, idx), dev = shard, _device_for(None, device)
    t = torch.as_tensor(_np.ascontiguousarray(full)) \
        if isinstance(full, _np.ndarray) else full
    return _table_block(t, int(logical_rows), n_shards, idx, dev)


def reshard_table(table, logical_rows: int, mesh=None,
                  axis: Optional[str] = None, device=None,
                  shard: Optional[Tuple[int, int]] = None):
    """Re-shard a live table without a checkpoint: ``table`` is the whole
    table (``ShardedTrainState.table`` gathers it from a mesh), the result
    this rank's rows under ``mesh`` (or ``shard``). The checkpoint route
    (``table_writer`` -> ``load_table``) is the primary one."""
    return _repad_and_place(table[:int(logical_rows)], logical_rows, mesh,
                            axis, device, shard)
