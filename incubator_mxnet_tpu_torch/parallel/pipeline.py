"""Pipeline parallelism (GPipe) over the ``pipe`` mesh axis.

Counterpart of ``incubator_mxnet_tpu/parallel/pipeline.py``: every rank
along ``pipe`` is one stage holding its own weights; microbatches stream
through ``n_micro + n_stages - 1`` ticks, and after each tick the
activations hop to the next stage (``collectives.ppermute``), so the
gradients flow back through the inverse permutation. A stage selects
(``torch.where``) where the reference does, never branches on its index:
every rank's autograd graph is the same, so the backward issues the same
collectives in the same order on every rank.
"""
from __future__ import annotations

from typing import Callable

import torch

from . import collectives as C
from .mesh import P, _need_mesh, _tree_map, shard_map

__all__ = ["pipeline_forward", "gpipe"]


def pipeline_forward(stage_fn: Callable, stage_params, x_microbatches,
                     axis_name: str = "pipe", mesh=None):
    """Per-rank body: this rank is stage ``axis_index(axis_name)`` and
    applies ``stage_fn(stage_params, a)`` to whatever activation it holds
    each tick; stage 0 feeds ``x_microbatches`` (n_micro, mb, ...).
    Returns (n_micro, mb, ...) outputs: valid on the last stage and all
    zeros on every other one (``gpipe``'s psum relies on that)."""
    mesh = _need_mesh(mesh)
    n_stages = mesh.axis_size(axis_name)
    stage = mesh.axis_index(axis_name)
    n_micro = x_microbatches.shape[0]
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    dev = x_microbatches.device
    first = torch.tensor(stage == 0, device=dev)
    last = torch.tensor(stage == n_stages - 1, device=dev)
    state = torch.zeros_like(x_microbatches[0])
    outs = [torch.zeros_like(x_microbatches[0]) for _ in range(n_micro)]
    # every stage builds the same graph (selects, not branches), so the
    # backward runs every rank's collectives in the same order
    for t in range(n_micro + n_stages - 1):
        injected = torch.where(first, x_microbatches[min(t, n_micro - 1)],
                               state)
        y = stage_fn(stage_params, injected)
        if t >= n_stages - 1:
            i = t - (n_stages - 1)
            outs[i] = torch.where(last, y.to(x_microbatches.dtype), outs[i])
        state = C.ppermute(y, axis_name, perm, mesh)
    return torch.stack(outs)


def gpipe(stage_fn: Callable, stacked_params, x, n_micro: int, mesh=None,
          axis_name: str = "pipe"):
    """Split the global batch ``x`` into ``n_micro`` microbatches, give
    stage i the i-th slice of every leaf of ``stacked_params`` (leading
    dim = number of stages), run the pipeline and return the last stage's
    output on every rank. Every stage maps same-shaped activations."""
    mesh = _need_mesh(mesh)
    b = x.shape[0]
    if b % n_micro:
        raise ValueError("batch must divide into microbatches")
    x_mb = x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))

    def run(params_local, xm):
        params_local = _tree_map(lambda p: p[0], params_local)
        out = pipeline_forward(stage_fn, params_local, xm, axis_name, mesh)
        # non-final stages hold zeros: psum broadcasts the last stage's
        return C.psum(out, axis_name, mesh)

    out = shard_map(run, mesh, (P(axis_name), P()), P())(stacked_params,
                                                          x_mb)
    return out.reshape((b,) + tuple(out.shape[2:]))
