"""The device mesh as a per-rank program on ``torch.distributed``.

Counterpart of ``incubator_mxnet_tpu/parallel/mesh.py``. The reference
lays its devices out as a ``jax.sharding.Mesh`` and lets GSPMD place the
collectives. Here every rank is a process of one ``torch.distributed``
world, and a :class:`Mesh` arranges the world's ranks in the reference's
axes (row-major, as ``np.arange(world).reshape(shape)``):

  data   - data parallelism (batch sharding; gradient psum)
  fsdp   - parameter sharding (ZeRO-3: all-gather / reduce-scatter)
  tensor - Megatron tensor parallelism
  pipe   - pipeline stages
  expert - MoE expert parallelism
  seq    - sequence parallelism (ring or Ulysses attention)

Each axis of size > 1 is a set of ``torch.distributed`` subgroups, one for
each line of ranks along it; groups over several axes are made when first
asked for (every rank asks in the same order, as an SPMD program does).

The backend is the caller's: ``create_mesh(..., backend=)``, NCCL by
default for CUDA devices, gloo for the CPU. A gloo world whose ranks
compute on a card (several ranks sharing one card, where NCCL refuses)
stages CUDA tensors through pinned host buffers for every collective
(``Mesh.staged``). A failed NCCL initialisation raises; nothing turns it
into gloo.

Ranks meet through a ``FileStore`` (``init_world(store_path=...)``, what
the tests use) or the ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` /
``WORLD_SIZE`` environment (``tools/launch.py`` sets it).

``shard`` / ``replicate`` / ``data_sharding`` / ``remesh`` take a
:class:`P` spec and act rank-locally: ``shard`` returns this rank's block
of a global tensor. :func:`shard_map` runs a per-rank body on blocks of
global tensors with the transposes of JAX's ``shard_map(check_vma=False)``.
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["FULL_AXES", "P", "MeshConfig", "Mesh", "init_world",
           "create_mesh", "get_mesh", "set_mesh", "local_device_count",
           "shard", "replicate", "data_sharding", "remesh", "shard_map",
           "spec_axes"]

FULL_AXES = ("data", "fsdp", "tensor", "pipe", "expert", "seq")

_CURRENT: Optional["Mesh"] = None


class P(tuple):
    """A partition spec, as ``jax.sharding.PartitionSpec``: one entry a
    dimension, each None (not split), an axis name, or a tuple of axis
    names (split over their product, the first the major)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def __reduce__(self):
        return (P, tuple(self))


def _dim_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec) -> Tuple[str, ...]:
    """Every axis a spec names, in order."""
    return tuple(a for e in spec for a in _dim_axes(e))


@dataclass
class MeshConfig:
    """Logical axis sizes; -1 means 'absorb the remaining devices'."""
    data: int = -1
    tensor: int = 1
    pipe: int = 1
    expert: int = 1
    seq: int = 1

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = {"data": self.data, "tensor": self.tensor, "pipe": self.pipe,
                 "expert": self.expert, "seq": self.seq}
        fixed, free = 1, None
        for k, v in sizes.items():
            if v == -1:
                if free is not None:
                    raise ValueError("only one axis may be -1")
                free = k
            else:
                fixed *= v
        if free is not None:
            if n_devices % fixed:
                raise ValueError(f"{n_devices} devices not divisible by "
                                 f"fixed axes {fixed}")
            sizes[free] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(f"axis product {fixed} != device count "
                             f"{n_devices}")
        return sizes


def _env_int(*names) -> Optional[int]:
    for n in names:
        if os.environ.get(n):
            return int(os.environ[n])
    return None


def init_world(backend: Optional[str] = None, *, rank: Optional[int] = None,
               world_size: Optional[int] = None,
               store_path: Optional[str] = None, device=None,
               timeout_s: float = 300.0) -> None:
    """Join this process to the world (no-op when it has joined).

    ``rank`` / ``world_size`` default to ``RANK`` / ``WORLD_SIZE`` (or the
    launcher's ``MXTPU_WORKER_RANK`` / ``MXTPU_NUM_WORKERS``). With
    ``store_path`` the ranks meet through a ``FileStore`` there; else
    through ``MASTER_ADDR`` / ``MASTER_PORT`` (``env://``). ``backend``
    defaults to NCCL for a CUDA ``device`` and gloo otherwise."""
    if dist.is_initialized():
        return
    dev = torch.device(device) if device is not None else None
    if backend is None:
        backend = "nccl" if dev is not None and dev.type == "cuda" else "gloo"
    rank = rank if rank is not None else _env_int("RANK", "MXTPU_WORKER_RANK")
    world_size = (world_size if world_size is not None
                  else _env_int("WORLD_SIZE", "MXTPU_NUM_WORKERS"))
    if rank is None or world_size is None:
        raise RuntimeError("init_world: no rank / world size (pass them or "
                           "set RANK and WORLD_SIZE)")
    kw = dict(backend=backend, rank=rank, world_size=world_size,
              timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "nccl":
        if dev is None or dev.type != "cuda":
            raise ValueError("init_world: the NCCL backend needs a CUDA "
                             "device")
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    if store_path is not None:
        kw["store"] = dist.FileStore(store_path, world_size)
    else:
        kw["init_method"] = "env://"
    dist.init_process_group(**kw)


class Mesh:
    """The world's ranks laid out on named axes, seen from this rank.

    ``devices`` is the array of global ranks in the mesh's shape;
    ``shape`` maps each axis name to its size; ``device`` is the
    ``torch.device`` this rank computes on; ``backend`` the collectives'
    backend."""

    def __init__(self, devices, axis_names: Sequence[str], backend: str,
                 device) -> None:
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} for axes "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.backend = backend
        self.device = torch.device(device)
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self.rank = dist.get_rank()
        where = np.argwhere(self.devices == self.rank)
        if len(where) != 1:
            raise ValueError(f"rank {self.rank} is not once in the mesh")
        self.coords = dict(zip(self.axis_names, (int(c) for c in where[0])))
        self._groups: Dict[Tuple[str, ...], Tuple[object, list]] = {}
        for name in self.axis_names:
            self.group((name,))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_size(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in _as_axes(axes)]))

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes`` (several: the first major)."""
        idx = 0
        for a in _as_axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes):
        """(process group, its global ranks in axis-index order) of this
        rank's line along ``axes``; (None, [rank]) for a line of one."""
        axes = _as_axes(axes)
        if axes in self._groups:
            return self._groups[axes]
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"mesh has no axis {a!r} "
                                 f"({self.axis_names})")
        if self.axis_size(axes) == 1:
            self._groups[axes] = (None, [self.rank])
            return self._groups[axes]
        pos = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in pos]
        lines = np.transpose(self.devices, rest + pos).reshape(
            -1, self.axis_size(axes))
        mine = None
        # every rank makes every line's group, in the same order
        for line in lines:
            ranks = [int(r) for r in line]
            g = dist.new_group(ranks=ranks, backend=self.backend)
            if self.rank in ranks:
                mine = (g, ranks)
        self._groups[axes] = mine
        return mine

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} at {self.coords}, "
                f"{self.backend} on {self.device})")


def _as_axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _default_device(backend: Optional[str]):
    from ..context import local_devices
    if backend == "gloo" and not torch.cuda.is_available():
        return torch.device("cpu")
    return local_devices()[0]


def create_mesh(config: Optional[MeshConfig] = None, devices=None,
                axis_names: Optional[Sequence[str]] = None, *,
                shape: Optional[Sequence[int]] = None,
                backend: Optional[str] = None, device=None,
                store_path: Optional[str] = None) -> Mesh:
    """Build the mesh over the world's ranks (``devices``: the global
    ranks, default all of them) and make it current.

    ``shape`` with ``axis_names`` (default the six axes) lays the ranks
    out directly, as the reference's ``Mesh(devices.reshape(shape),
    names)``; else ``config`` resolves the sizes and ``fsdp`` is 1, as in
    the reference; ``axis_names`` alone puts every rank on its first axis.
    ``device`` is where this rank computes (default: this process's card,
    see ``context.local_devices``, or the CPU for a gloo world without a
    card); ``backend`` defaults to NCCL on a card and gloo on the CPU.
    Joins the world first when this process has not (``init_world``)."""
    dev = torch.device(device) if device is not None else None
    if backend is None:
        if dev is None:
            dev = _default_device(None)
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev is None:
        dev = _default_device(backend)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r} (nccl or gloo)")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs CUDA devices")
    init_world(backend, store_path=store_path, device=dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    world = dist.get_world_size()
    ranks = np.asarray(list(devices) if devices is not None
                       else range(world))
    if shape is not None:
        names = tuple(axis_names) if axis_names is not None else FULL_AXES
        arr = ranks.reshape(tuple(shape))
    elif axis_names is not None:
        names = tuple(axis_names)
        arr = ranks.reshape([-1] + [1] * (len(names) - 1))
    else:
        sizes = (config or MeshConfig()).resolve(ranks.size)
        names = FULL_AXES
        arr = ranks.reshape((sizes["data"], 1, sizes["tensor"],
                             sizes["pipe"], sizes["expert"], sizes["seq"]))
    mesh = Mesh(arr, names, backend, dev)
    set_mesh(mesh)
    return mesh


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _CURRENT
    _CURRENT = mesh


def get_mesh() -> Optional[Mesh]:
    return _CURRENT


def _need_mesh(mesh: Optional[Mesh]) -> Mesh:
    mesh = mesh or get_mesh()
    if mesh is None:
        raise RuntimeError("create_mesh first")
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    return mesh


def local_device_count() -> int:
    """The devices this process computes on (``context.local_devices``)."""
    from ..context import local_devices
    return len(local_devices())


# -------------------------------------------------------------- placement
def _block(x, spec, mesh: Mesh):
    """This rank's block of the global tensor ``x`` under ``spec``."""
    for dim, entry in enumerate(spec):
        axes = _dim_axes(entry)
        if not axes:
            continue
        n = mesh.axis_size(axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {axes} ({n})")
        step = x.shape[dim] // n
        x = x.narrow(dim, mesh.axis_index(axes) * step, step)
    return x


def shard(x, spec, mesh: Optional[Mesh] = None):
    """This rank's block of ``x`` (a tensor or NDArray holding the global
    value) under ``spec``, on the mesh's device."""
    from ..ndarray.ndarray import NDArray, _wrap
    mesh = _need_mesh(mesh)
    if isinstance(x, NDArray):
        return _wrap(shard(x._data, spec, mesh))
    return _block(torch.as_tensor(x), spec, mesh).to(mesh.device).contiguous()


def replicate(x, mesh: Optional[Mesh] = None):
    return shard(x, P(), mesh)


def remesh(devices, like: Optional[Mesh] = None) -> Mesh:
    """Rebuild the current mesh over the global ranks ``devices`` with the
    axes of ``like`` (default the current mesh): every axis but ``data``
    keeps its size and ``data`` absorbs the new count; with no template a
    one-axis ``('data',)`` mesh. Every rank of the world calls it and
    must be in ``devices`` (a world that loses ranks is the elastic
    controller's, ROADMAP.md A10b); it installs and returns the new
    mesh."""
    like = like if like is not None else get_mesh()
    arr = np.asarray(list(devices))
    if arr.size == 0:
        raise ValueError("remesh needs at least one device")
    if like is None:
        mesh = Mesh(arr, ("data",), _default_backend(), _default_device(
            _default_backend()))
    else:
        other = int(np.prod([like.shape[n] for n in like.axis_names
                             if n != "data"]))
        if "data" not in like.axis_names and arr.size != other:
            raise ValueError(
                f"remesh: template mesh axes {like.axis_names} have no "
                f"'data' axis to absorb a device-count change ({other} -> "
                f"{arr.size} devices)")
        if arr.size % other:
            raise ValueError(f"{arr.size} devices not divisible by the "
                             f"non-data axis product {other}")
        shape = tuple(arr.size // other if n == "data" else like.shape[n]
                      for n in like.axis_names)
        mesh = Mesh(arr.reshape(shape), like.axis_names, like.backend,
                    like.device)
    set_mesh(mesh)
    return mesh


def _default_backend() -> str:
    return dist.get_backend() if dist.is_initialized() else "gloo"


def data_sharding(batch_size: Optional[int] = None,
                  mesh: Optional[Mesh] = None):
    """``P("data")``, the spec that splits axis 0 over the data axis, or
    None when no mesh is current, the data axis has size 1 or
    ``batch_size`` does not split evenly (the reference's rule)."""
    mesh = mesh or get_mesh()
    if mesh is None or "data" not in mesh.axis_names:
        return None
    n = mesh.shape["data"]
    if n <= 1 or (batch_size is not None and batch_size % n):
        return None
    return P("data")


# --------------------------------------------------------------- shard_map
def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _broadcast_spec(spec, tree):
    """A single P for a whole tree becomes a tree of that P."""
    if isinstance(spec, P):
        return _tree_map(lambda _: spec, tree)
    return spec


def _unmentioned(spec, mesh: Mesh) -> Tuple[str, ...]:
    named = set(spec_axes(spec))
    return tuple(a for a in mesh.axis_names
                 if a not in named and mesh.shape[a] > 1)


def _gather_blocks(x, spec, mesh: Mesh):
    """The global tensor from every rank's block (the inverse of
    :func:`_block`), without autograd."""
    from . import collectives as C
    for dim, entry in enumerate(spec):
        for a in reversed(_dim_axes(entry)):   # minor axis first
            x = C.raw_all_gather(x, a, dim, mesh)
    return x


class _ShardIn(torch.autograd.Function):
    """Global (replicated) tensor -> this rank's block. Backward: the
    block's cotangent summed over the axes the spec leaves out (JAX's
    in-cotangent psum), then gathered into the global cotangent."""

    @staticmethod
    def forward(ctx, x, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return _block(x, spec, mesh).contiguous()

    @staticmethod
    def backward(ctx, g):
        from . import collectives as C
        spec, mesh = ctx.spec, ctx.mesh
        rest = _unmentioned(spec, mesh)
        if rest:
            g = C.raw_all_reduce(g, rest, "sum", mesh)
        return _gather_blocks(g.contiguous(), spec, mesh), None, None


class _ShardOut(torch.autograd.Function):
    """This rank's block -> the global tensor on every rank. Backward:
    this rank's block of the cotangent, divided by the size of the axes
    the spec leaves out (JAX's out-cotangent division)."""

    @staticmethod
    def forward(ctx, y, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return _gather_blocks(y.contiguous(), spec, mesh)

    @staticmethod
    def backward(ctx, g):
        spec, mesh = ctx.spec, ctx.mesh
        n = mesh.axis_size(_unmentioned(spec, mesh))
        g = _block(g, spec, mesh).contiguous()
        return (g / n if n != 1 else g), None, None


def shard_map(fn, mesh: Optional[Mesh] = None, in_specs=(), out_specs=P(),
              check_vma: bool = False):
    """The per-rank counterpart of JAX's ``shard_map``: the returned
    function takes global tensors (the same on every rank), hands ``fn``
    this rank's blocks under ``in_specs`` (a spec a positional argument;
    a single spec applies to a whole dict/list argument), and returns the
    global outputs under ``out_specs`` on every rank. Gradients are those
    of ``check_vma=False`` (the only mode; the flag is kept for the
    reference's signature)."""
    if check_vma:
        raise ValueError("shard_map: only check_vma=False is supported")

    def run(*args):
        m = _need_mesh(mesh)
        specs = in_specs if isinstance(in_specs, (list, tuple)) and not \
            isinstance(in_specs, P) else (in_specs,) * len(args)
        local = [_tree_map(lambda t, s: _ShardIn.apply(t, s, m),
                           a, _broadcast_spec(s, a))
                 for a, s in zip(args, specs)]
        outs = fn(*local)
        return _tree_map(lambda t, s: _ShardOut.apply(t, s, m), outs,
                         _broadcast_spec(out_specs, outs))

    return run

