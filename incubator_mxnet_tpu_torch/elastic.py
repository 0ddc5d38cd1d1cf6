"""Elastic group membership: the group view and the batch partition.

Counterpart of the first part of ``incubator_mxnet_tpu/elastic.py``:
``ElasticError``, ``GroupView`` (one epoch of the live rank set) and
``shard_batch`` (the deterministic partition of a global batch over a
view's ranks), which ``input_service.InputService`` slices its deliveries
by. The membership authorities, the quiesce/reshard controller and its
policy (``ElasticPolicy``, ``SimulatedMembership``, ``PSMembership``,
``ElasticController``) are ROADMAP.md A10b (distributed), not ported yet;
their names raise.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

__all__ = ["ElasticError", "GroupView", "shard_batch"]

_NOT_PORTED = ("ElasticPolicy", "SimulatedMembership", "PSMembership",
               "ElasticController")


class ElasticError(RuntimeError):
    """An elastic resize could not complete (and no guard ladder was
    bound to degrade down)."""


class GroupView(NamedTuple):
    """One epoch of group membership: the live rank set as published by
    the membership authority. Epochs are strictly increasing; any
    membership change bumps the epoch."""
    epoch: int
    ranks: Tuple[int, ...]

    @property
    def world(self) -> int:
        return len(self.ranks)


def shard_batch(n: int, view: GroupView, rank: int) -> Tuple[int, int]:
    """Deterministic global-batch partition for a view: live ranks (in
    sorted order) take contiguous row ranges of ``[0, n)``; position
    ``k`` of ``R`` gets ``[k*n//R, (k+1)*n//R)``. Pure arithmetic on
    (n, view, rank): every rank computes every rank's slice identically
    with no communication, and the union is exactly the global batch (no
    row dropped or duplicated at any world size)."""
    if rank not in view.ranks:
        raise ValueError(f"rank {rank} is not in view {view.ranks}")
    k = view.ranks.index(rank)
    r = view.world
    return k * n // r, (k + 1) * n // r


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"elastic.{name}: elastic membership and resharding are "
            "ROADMAP.md A10b (distributed), not ported yet")
    raise AttributeError(f"module 'elastic' has no attribute {name!r}")
