"""KVStore: key-value parameter synchronisation.

Counterpart of ``incubator_mxnet_tpu/kvstore.py`` (ref:
include/mxnet/kvstore.h:59-411; factory src/kvstore/kvstore.cc:40-72;
local aggregation src/kvstore/kvstore_local.h; the parameter-server
worker and server src/kvstore/kvstore_dist.h / kvstore_dist_server.h;
2-bit compression src/kvstore/gradient_compression.h).

A key maps to one logical value. ``push`` aggregates gradients (a sum over
a list's entries, then, for the ``dist`` types, over the processes), and the
optimizer (``set_updater`` on the worker, or ``set_optimizer``, the
reference's server-side path) runs on the sum. ``dist_sync`` /
``dist_device_sync`` / ``dist`` sum over ``torch.distributed``: the world
of ``parallel.mesh.init_world``, which a store joins from the launcher's
environment (``MXTPU_NUM_WORKERS``, ``MXTPU_WORKER_RANK``,
``MXTPU_COORDINATOR``, as ``tools/launch.py`` sets them) when the process
has not joined one. On a gloo world a CUDA value is summed through a
pinned host copy (gloo's TCP transport cannot take CUDA tensors); on an
NCCL world a CPU value through a copy on the card. ``dist_async`` is the
socket parameter server of ``_ps.py``: rank 0 owns the state, each push is
applied when it arrives, and pulls may be stale (ref:
kvstore_dist_server.h:325-358). Row-sparse push and pull and 2-bit
compression with error feedback are kept.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as _np
import torch
import torch.distributed as dist

from . import telemetry as _telemetry
from .ndarray import sparse as _sp
from .ndarray.ndarray import NDArray, _wrap
from .parallel.collectives import world_all_reduce

__all__ = ["KVStore", "create"]

_TYPES = ("local", "local_allreduce_cpu", "local_allreduce_device",
          "device", "nccl", "dist_sync", "dist_device_sync", "dist_async",
          "dist")


class _GradientCompression:
    """2-bit quantization with an error-feedback residual (ref:
    src/kvstore/gradient_compression.h:37-132): each value becomes +t, -t
    or 0, and what it loses is carried into the key's next push."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = float(threshold)
        self._residual: Dict[Any, torch.Tensor] = {}

    def compress(self, key, grad):
        g = grad._data if isinstance(grad, NDArray) else grad
        r = self._residual.get(key)
        acc = g + r if r is not None else g.clone()
        t = self.threshold
        q = torch.where(acc >= t, torch.full_like(acc, t),
                        torch.where(acc <= -t, torch.full_like(acc, -t),
                                    torch.zeros_like(acc)))
        self._residual[key] = acc - q
        return _wrap(q)

    def decompress(self, key, q):
        return q


def _maybe_init_distributed() -> None:
    """Join the world from the launcher's environment (the analog of
    ps-lite reading ``DMLC_*``): no-op for one worker or when the process
    has joined a world already. The world's backend is gloo."""
    if dist.is_initialized():
        return
    n = int(os.environ.get("MXTPU_NUM_WORKERS")
            or os.environ.get("WORLD_SIZE") or "1")
    if n <= 1:
        return
    coord = os.environ.get("MXTPU_COORDINATOR", "127.0.0.1:49875")
    host, port = coord.rsplit(":", 1)
    os.environ.setdefault("MASTER_ADDR", host)
    os.environ.setdefault("MASTER_PORT", port)
    rank = int(os.environ.get("MXTPU_WORKER_RANK")
               or os.environ.get("RANK") or "0")
    from .parallel.mesh import init_world
    init_world("gloo", rank=rank, world_size=n)


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _assign(target: NDArray, value: torch.Tensor) -> None:
    """``value`` into ``target``: in place when the shapes agree (a
    parameter keeps its tensor), else rebound to a copy."""
    v = value
    if tuple(target._data.shape) == tuple(v.shape):
        with torch.no_grad():
            target._data.copy_(v)
    else:
        target._set_data(v.to(target._data.device).clone())


class KVStore:
    """One implementation behind the reference's store types (ref:
    kvstore.py:97 Python wrapper; the C++ KVStore)."""

    def __init__(self, kv_type: str = "local"):
        self.type = kv_type
        self._store: Dict[Any, Union[NDArray, _sp.RowSparseNDArray]] = {}
        self._updater: Optional[Callable] = None
        self._optimizer = None
        self._compression: Optional[_GradientCompression] = None
        self._is_dist = kv_type.startswith("dist")
        self._is_async = kv_type == "dist_async"
        self._barrier_count = 0
        self._ps_client = None
        self._ps_server = None
        if self._is_async:
            self._init_async_ps()
        elif self._is_dist:
            _maybe_init_distributed()

    def _init_async_ps(self):
        """Start (rank 0) and connect (every rank) the async PS. The async
        type joins no world: its point is no lockstep between workers."""
        from . import _ps
        self._env_rank = int(os.environ.get("MXTPU_WORKER_RANK", "0"))
        self._env_nworkers = int(os.environ.get("MXTPU_NUM_WORKERS", "1"))
        if self._env_nworkers <= 1:
            # one process: a private server on an ephemeral port
            server = _ps.AsyncPSServer("127.0.0.1:0", 1)
            port = server._sock.getsockname()[1]
            self._ps_server = server
            self._ps_client = _ps.AsyncPSClient(f"127.0.0.1:{port}", rank=0)
            return
        addr = _ps.ps_address()
        if self._env_rank == 0:
            self._ps_server = _ps.AsyncPSServer(addr, self._env_nworkers)
        self._ps_client = _ps.AsyncPSClient(addr, rank=self._env_rank)

    # ----------------------------------------------------------------- info
    @property
    def rank(self) -> int:
        """(ref: kvstore.h get_rank)"""
        if self._is_async:
            return self._env_rank
        return dist.get_rank() if dist.is_initialized() else 0

    @property
    def num_workers(self) -> int:
        """(ref: kvstore.h get_group_size)"""
        if self._is_async:
            return self._env_nworkers
        return _world_size()

    @property
    def num_dead_node(self) -> int:
        """(ref: kvstore.h:353 get_num_dead_node). ``dist_async`` backs it
        with heartbeats to the rank-0 server (silence past
        ``MXTPU_PS_DEAD_TIMEOUT`` is death until a rejoin); a sync world
        fails the job on a death, so a live one reports 0."""
        if self._is_async and self._ps_client is not None:
            return self._ps_client.num_dead_node()
        return 0

    def dead_nodes(self) -> List[int]:
        """The dead ranks themselves (``dist_async``; empty otherwise)."""
        if self._is_async and self._ps_client is not None:
            return self._ps_client.dead_nodes()
        return []

    def group_view(self):
        """(epoch, live ranks): ``dist_async`` asks the PS membership
        authority; a sync world's membership is fixed at launch (epoch
        0)."""
        if self._is_async and self._ps_client is not None:
            return self._ps_client.group_view()
        return 0, tuple(range(self.num_workers))

    def view_barrier(self, ranks=None) -> None:
        """Rendezvous over ``ranks``, or the whole current group view
        (``dist_async``; other types run the plain ``barrier``). Raises
        TimeoutError naming the target ranks that never arrived."""
        if self._is_async and self._ps_client is not None:
            if self.num_workers > 1 or len(self.group_view()[1]) > 1:
                self._ps_client.view_barrier(ranks=ranks)
            return
        self.barrier()

    # ----------------------------------------------------------------- init
    def init(self, key, value) -> None:
        """(ref: kvstore.py init) Single keys and values or lists."""
        keys, values = _key_value(key, value)
        for k, v in zip(keys, values):
            if k in self._store:
                continue
            self._store[k] = v if isinstance(v, _sp.BaseSparseNDArray) \
                else v.copy()
            if self._ps_client is not None:
                # sparse keys live densified on the PS; row_sparse_pull
                # re-sparsifies on the worker
                dense = v.todense() if isinstance(
                    v, _sp.BaseSparseNDArray) else v
                self._ps_client.init(k, dense._data.detach().cpu().numpy())

    # ----------------------------------------------------------------- push
    def push(self, key, value, priority: int = 0) -> None:
        """Aggregate gradients into the store (ref: kvstore.py push): a
        list for one key is summed (ref: comm.h:451 CommDevice reduce),
        then, for the ``dist`` types, over the processes."""
        keys, values = _key_value(key, value)
        _telemetry.counter("kvstore_pushes_total",
                           "KVStore push operations (per key).").inc(
                               len(keys), type=self.type)
        for k, v in zip(keys, values):
            grads = v if isinstance(v, (list, tuple)) else [v]
            agg = self._reduce(grads)
            if self._compression is not None and not isinstance(
                    agg, _sp.BaseSparseNDArray):
                agg = self._compression.compress(k, agg)
            if self._is_async:
                # applied on push on the rank-0 server; no barrier, no
                # collective: other workers see it when they pull
                if isinstance(agg, _sp.BaseSparseNDArray):
                    agg = agg.todense()
                self._ps_client.push(k, agg._data.detach().cpu().numpy())
                continue
            if self._is_dist and self.num_workers > 1:
                agg = self._cross_process_sum(agg)
            if self._updater is not None:
                self._updater(k, agg, self._store[k])
            elif isinstance(agg, _sp.BaseSparseNDArray):
                self._store[k] = agg
            else:
                # the stored value becomes the pushed sum
                self._store[k]._set_data(agg._data.clone())

    def _reduce(self, grads):
        if isinstance(grads[0], _sp.RowSparseNDArray):
            agg = grads[0]
            for g in grads[1:]:
                agg = _sp.sparse_add(agg, g)
            return agg
        if len(grads) == 1:
            return grads[0]
        total = grads[0]._data
        for g in grads[1:]:
            total = total + g._data.to(total.device)
        return _wrap(total)

    def _cross_process_sum(self, agg):
        """The sum over the world's processes (replaces ps-lite ZPush;
        ref: kvstore_dist.h). A row-sparse value is summed dense."""
        if isinstance(agg, _sp.BaseSparseNDArray):
            agg = agg.todense()
        return _wrap(world_all_reduce(agg._data))

    def allreduce_tree(self, tree):
        """The sum over the processes of a list of tensors in ONE
        collective (the fused trainer step's gradient reduction, instead of
        a push and pull a key): a flat float32 buffer. No-op for the local
        and async types and a world of one."""
        if not self._is_dist or self._is_async or self.num_workers <= 1:
            return tree
        tensors = list(tree)
        if not tensors:
            return tensors
        with _telemetry.span("allreduce", tensors=len(tensors)):
            dev = tensors[0].device
            flat = torch.cat([t.detach().float().reshape(-1).to(dev)
                              for t in tensors])
            flat = world_all_reduce(flat)
            return [part.view(t.shape).to(t.dtype)
                    for t, part in zip(tensors, flat.split(
                        [t.numel() for t in tensors]))]

    # ----------------------------------------------------------------- pull
    def _refresh_async(self, k) -> None:
        cur = self._ps_client.pull(k)
        if cur is not None:
            self._store[k] = _wrap(torch.from_numpy(_np.array(cur)))

    def pull(self, key, out=None, priority: int = 0,
             ignore_sparse=True) -> None:
        """(ref: kvstore.py pull)"""
        keys, outs = _key_value(key, out)
        _telemetry.counter("kvstore_pulls_total",
                           "KVStore pull operations (per key).").inc(
                               len(keys), type=self.type)
        for k, o in zip(keys, outs):
            if self._is_async:
                self._refresh_async(k)
            val = self._store[k]
            if isinstance(val, _sp.BaseSparseNDArray):
                if ignore_sparse:
                    raise ValueError(
                        "pull with ignore_sparse=True on a sparse key; "
                        "use row_sparse_pull (ref: kvstore.py pull)")
                val = val.todense()
            for t in (o if isinstance(o, (list, tuple)) else [o]):
                _assign(t, val._data)

    def row_sparse_pull(self, key, out=None, priority: int = 0,
                        row_ids=None) -> None:
        """Pull only the listed rows (ref: kvstore.h:209 PullRowSparse).

        Duplicate ``row_ids`` are deduplicated before the gather: each
        unique row is read once (``kvstore_rowsparse_rows_gathered_total``
        counts the rows read, ``mxtpu_embed_dedup_ratio`` the ratio). Ids
        outside the table are misses, and so are rows of a row-sparse
        value that it does not store (its indices in any order): absent
        from the result, never a clamped read (``retain`` semantics)."""
        assert row_ids is not None, "row_ids is required for row_sparse_pull"
        keys, outs = _key_value(key, out)
        rids = row_ids if isinstance(row_ids, (list, tuple)) else [row_ids]
        from .parallel.embedding import note_dedup
        for k, o, rid in zip(keys, outs, rids * len(keys)):
            if self._is_async:
                self._refresh_async(k)
            val = self._store[k]
            rid_np = _np.asarray(
                rid.asnumpy() if isinstance(rid, NDArray) else rid
            ).reshape(-1).astype(_np.int64)
            uniq = _np.unique(rid_np)
            valid = (uniq >= 0) & (uniq < val.shape[0])
            note_dedup(rid_np.size, uniq.size)
            _telemetry.counter(
                "kvstore_rowsparse_rows_gathered_total",
                "Rows actually fetched by row_sparse_pull (after "
                "dedup).").inc(int(valid.sum()))
            if isinstance(val, NDArray):
                src = val._data
                rows = src.index_select(0, torch.as_tensor(
                    _np.where(valid, uniq, 0), device=src.device))
                hit = valid
            else:
                src = val.data
                idx_np = val.indices.cpu().numpy()
                order = _np.argsort(idx_np)
                sorted_idx = idx_np[order]
                if val.nnz:
                    pos = _np.clip(_np.searchsorted(sorted_idx, uniq), 0,
                                   val.nnz - 1)
                    hit = (sorted_idx[pos] == uniq) & valid
                    rows = src.index_select(0, torch.as_tensor(
                        order[pos], device=src.device))
                else:
                    hit = _np.zeros(uniq.shape, bool)
                    rows = torch.zeros((uniq.size,) + tuple(val.shape[1:]),
                                       dtype=src.dtype, device=src.device)
            mask = torch.as_tensor(hit, device=rows.device).view(
                (-1,) + (1,) * (rows.dim() - 1))
            rows = torch.where(mask, rows, torch.zeros((), dtype=rows.dtype,
                                                       device=rows.device))
            # retain(): only rows that are non-zero appear in the result
            nz = (rows.reshape(rows.shape[0], -1) != 0).any(1).cpu().numpy()
            keep = _np.nonzero(nz)[0]
            res = _sp.RowSparseNDArray(
                rows.index_select(0, torch.as_tensor(keep,
                                                     device=rows.device)),
                torch.as_tensor(uniq[keep]), tuple(val.shape))
            for t in (o if isinstance(o, (list, tuple)) else [o]):
                if isinstance(t, _sp.RowSparseNDArray):
                    t.data = res.data.to(t._device)
                    t.indices = res.indices.to(t._device)
                else:
                    _assign(t, res.todense()._data)

    def pushpull(self, key, value, out=None, priority: int = 0) -> None:
        """Push, then pull (ref: kvstore.py pushpull)."""
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out, priority, ignore_sparse=False)

    # ------------------------------------------------------------ optimizer
    def set_updater(self, updater: Callable) -> None:
        """A worker-side updater (ref: kvstore.py _set_updater)."""
        self._updater = updater

    def set_optimizer(self, optimizer) -> None:
        """(ref: kvstore.py set_optimizer -> SendCommandToServers). For
        ``dist_async`` the pickled optimizer goes to the rank-0 server and
        every push is applied there; the worker keeps no updater. Other
        types apply it on the store here."""
        from .optimizer import get_updater
        self._optimizer = optimizer
        if self._is_async:
            # the parameters are the workers'; the server keys by index
            pd, optimizer.param_dict = optimizer.param_dict, {}
            try:
                blob = pickle.dumps(optimizer)
            finally:
                optimizer.param_dict = pd
            self._ps_client.set_optimizer(blob)
            return
        self._updater = get_updater(optimizer)

    @property
    def updater(self):
        return self._updater

    def set_gradient_compression(self,
                                 compression_params: Dict[str, Any]) -> None:
        """(ref: kvstore.py set_gradient_compression)"""
        ctype = compression_params.get("type", "2bit")
        if ctype != "2bit":
            raise ValueError(f"Unsupported compression type {ctype}")
        self._compression = _GradientCompression(
            compression_params.get("threshold", 0.5))

    # ----------------------------------------------------------- lifecycle
    def barrier(self) -> None:
        """Global barrier (ref: kvstore.h Barrier ->
        ps::Postoffice::Barrier); the only sync point of ``dist_async``."""
        if self._is_async:
            if self.num_workers > 1:
                self._ps_client.barrier()
        elif self.num_workers > 1:
            dist.barrier()
        self._barrier_count += 1

    def telemetry_allgather(self) -> List[Dict[str, Any]]:
        """Every rank's ``telemetry.snapshot()``, in rank order (one
        ``all_gather_object``); ``[local snapshot]`` for the local and
        async types and a world of one."""
        snap = _telemetry.snapshot()
        if not self._is_dist or self._is_async or self.num_workers <= 1:
            return [snap]
        out: List[Any] = [None] * self.num_workers
        dist.all_gather_object(out, snap)
        return out

    def send_command_to_servers(self, head: int, body: str) -> None:
        """(ref: kvstore.h SendCommandToServers). ``dist_async`` routes the
        command to the rank-0 server, whose profiler commands (heads 0..3)
        need ``profiler.py`` (ROADMAP.md A11) and answer with an error that
        raises here. Types without a server role have nothing to do."""
        if self._is_async and self._ps_client is not None:
            self._ps_client.command(head, body)

    def save_optimizer_states(self, fname: str, dump_optimizer=False) -> None:
        assert self._updater is not None, \
            "Cannot save states for distributed training"
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname: str) -> None:
        assert self._updater is not None, \
            "Cannot load states for distributed training"
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    def close(self) -> None:
        """Release the async PS's sockets and threads (no-op for other
        types)."""
        if self._ps_client is not None:
            self._ps_client.close()
            self._ps_client = None
        if self._ps_server is not None:
            self._ps_server.close()
            self._ps_server = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _key_value(key, value):
    if isinstance(key, (list, tuple)):
        return list(key), list(value)
    return [key], [value]


def create(name: str = "local") -> KVStore:
    """(ref: src/kvstore/kvstore.cc:40-72 Create; kvstore.py:635) Types:
    local, local_allreduce_cpu, local_allreduce_device, device, nccl,
    dist_sync, dist_device_sync, dist_async, dist."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name.lower() not in _TYPES:
        raise ValueError(f"unknown KVStore type {name!r}; valid: "
                         f"{sorted(_TYPES)}")
    return KVStore(name.lower())
