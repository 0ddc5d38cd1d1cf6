"""Ulysses sequence parallelism: all-to-all between sequence and heads.

Counterpart of ``incubator_mxnet_tpu/parallel/ulysses.py`` (DeepSpeed-
Ulysses). With the sequence split over the ``seq`` axis, one all-to-all
turns each of q, k and v from (B, T/n, H, D) into (B, T, H/n, D): every
rank holds the whole sequence for H/n heads and runs ordinary attention
on them, the flash kernels where the sequence tiles
(``flash_kernel_viable``; their plain twins for CPU tensors) and plain
attention otherwise. A last all-to-all restores the sequence split. The
head count must divide by the axis size.
"""
from __future__ import annotations

from typing import Optional

from . import collectives as C
from .mesh import P, _need_mesh, shard_map
from .ring_attention import attention_reference

__all__ = ["ulysses_attention", "ulysses_attention_sharded"]


def ulysses_attention(q, k, v, axis_name: str = "seq", causal: bool = False,
                      scale: Optional[float] = None, mesh=None):
    """Ulysses body: this rank's (B, T_local, H, D) blocks, H divisible by
    the axis size. Returns (B, T_local, H, D)."""
    from ..ops.cuda.flash_attention import (flash_attention_packed,
                                            flash_kernel_viable)
    mesh = _need_mesh(mesh)
    n = mesh.axis_size(axis_name)
    h = q.shape[2]
    if h % n:
        raise ValueError(
            f"Ulysses needs head count {h} divisible by the '{axis_name}' "
            f"axis size {n}; use ring attention for indivisible configs")
    # (B, T/n, H, D) -> (B, T, H/n, D): gather the sequence, split heads
    qf, kf, vf = (C.all_to_all(x, axis_name, 2, 1, mesh) for x in (q, k, v))
    b, t, hl, d = qf.shape
    if flash_kernel_viable(t, t, d):
        out = flash_attention_packed(
            qf.reshape(b, t, hl * d), kf.reshape(b, t, hl * d),
            vf.reshape(b, t, hl * d), hl, causal=causal,
            scale=scale).view(b, t, hl, d)
    else:
        out = attention_reference(qf, kf, vf, causal=causal, scale=scale)
    return C.all_to_all(out, axis_name, 1, 2, mesh)


def ulysses_attention_sharded(q, k, v, mesh=None, axis_name: str = "seq",
                              causal: bool = False,
                              scale: Optional[float] = None):
    """Global (B, T, H, D) tensors split on T over ``axis_name``, run by
    :func:`ulysses_attention`; the global output on every rank."""
    mesh = _need_mesh(mesh)
    spec = P(None, axis_name, None, None)
    return shard_map(
        lambda ql, kl, vl: ulysses_attention(ql, kl, vl, axis_name, causal,
                                             scale, mesh),
        mesh, (spec, spec, spec), spec)(q, k, v)
