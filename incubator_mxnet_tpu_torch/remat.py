"""Rematerialisation: the reference's ``remat`` policies on
``torch.utils.checkpoint``.

Counterpart of ``REMAT_POLICIES`` and ``_resolve_remat_policy`` in
``incubator_mxnet_tpu/parallel/dp.py`` (used by its ``make_train_step``
and ``gluon/block.py``'s ``hybridize``). A policy says which aten ops'
outputs the backward keeps; every other op of the forward runs again in
the backward (``create_selective_checkpoint_contexts``). Random draws are
always kept, so a recompute sees the forward's values, as the reference's
explicit keys give them. The port's hand-written kernels run inside
``torch.autograd.Function``s, which no aten policy sees: under any policy
their forward runs again in the backward.

PyTorch's checkpoint recomputes the whole of a checkpointed call before
the first backward op that needs one of its tensors, so one checkpoint
around a whole forward keeps as much memory live as none. The forward is
therefore cut into segments (:func:`segments`): each child of the
outermost sequential container the forward runs (``Sequential``,
``HybridSequential``, and the feature stages of the ResNets, fused or
not) is checkpointed on its own, and nothing inside a segment is cut
again. A forward that runs no such container is one segment
(:func:`checkpointed`). The values are those of the forward without a
policy.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import autograd
from .ops.nn import bn_impl_override

__all__ = ["REMAT_POLICIES", "resolve", "checkpointed", "segments",
           "segment", "has_segments"]

_aten = torch.ops.aten
_DOTS = (_aten.mm, _aten.addmm, _aten.bmm, _aten.convolution)
_REDUCES = (_aten.sum, _aten.mean, _aten.var, _aten.amax, _aten.amin,
            _aten.argmax)


def _saving(*packets):
    """A policy that keeps the outputs of the aten ops ``packets``."""
    ops = frozenset(packets)

    def policy(ctx, op, *args, **kwargs):
        return op.overloadpacket in ops
    return policy


#: the named policies: "dots" keeps the matmul and convolution results,
#: "dots_reduces" those and the reductions (BatchNorm and loss
#: statistics), "dots_no_batch" the dots but batched matmuls, "nothing"
#: none (recompute from the segment's inputs: the least memory, the most
#: extra work), "everything" all.
REMAT_POLICIES = {
    "dots": _saving(*_DOTS),
    "dots_reduces": _saving(*_DOTS, *_REDUCES),
    "dots_no_batch": _saving(_aten.mm, _aten.addmm, _aten.convolution),
    "nothing": _saving(),
    "everything": lambda ctx, op, *args, **kwargs: True,
}


def resolve(remat):
    """None | a name of :data:`REMAT_POLICIES` | a callable -> the policy
    (``policy(ctx, op, *args, **kwargs)`` -> bool or ``CheckpointPolicy``,
    ``torch.utils.checkpoint``'s selective-checkpoint form) or None; an
    unknown name raises ``ValueError``."""
    if remat is None or remat is False:
        return None
    if callable(remat):
        return remat
    policy = REMAT_POLICIES.get(str(remat))
    if policy is None:
        raise ValueError(
            f"unknown remat policy {remat!r}; one of {sorted(REMAT_POLICIES)}"
            " or a selective-checkpoint policy callable")
    return policy


def checkpointed(policy, fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` with ``policy``."""
    def sac(ctx, op, *a, **kw):
        if torch.Tag.nondeterministic_seeded in op.tags:
            return CheckpointPolicy.MUST_SAVE
        got = policy(ctx, op, *a, **kw)
        if isinstance(got, CheckpointPolicy):
            return got
        return (CheckpointPolicy.MUST_SAVE if got
                else CheckpointPolicy.PREFER_RECOMPUTE)
    # the draws are kept, so no generator state is stashed and restored
    # (which a CUDA graph's capture would refuse)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts, sac))


_SEG = threading.local()


@contextlib.contextmanager
def segments(policy):
    """Inside, :func:`segment` checkpoints under ``policy``."""
    prev = getattr(_SEG, "policy", None)
    _SEG.policy = policy
    try:
        yield
    finally:
        _SEG.policy = prev


def segment(fn, *args):
    """``fn(*args)``; inside :func:`segments` and outside any segment, as
    one checkpointed segment. The recompute runs on the autograd engine's
    thread, so the segment takes the caller's per-thread state with it:
    the parameter substitution, the functional trace and the recording and
    training flags. BatchNorm runs its plain composition in a segment, as
    under every policy."""
    policy = getattr(_SEG, "policy", None)
    if policy is None:
        return fn(*args)
    from .autograd import _IN_TRACE, _functional_trace
    from .gluon.parameter import _substitution_map, parameter_substitution
    sub = _substitution_map()
    trace = getattr(_IN_TRACE, "active", False)
    flags = (autograd.is_recording(), autograd.is_training())

    def run(*a):
        with segments(None), bn_impl_override("plain"), \
                parameter_substitution(sub), \
                (_functional_trace() if trace else contextlib.nullcontext()), \
                autograd._RecordingStateScope(*flags):
            return fn(*a)
    return checkpointed(policy, run, *args)


def has_segments(block) -> bool:
    """Whether ``block``'s forward runs a sequential container, whose
    children :func:`segment` cuts."""
    from .gluon.nn.basic_layers import HybridSequential, Sequential
    if isinstance(block, (Sequential, HybridSequential)):
        return True
    return any(has_segments(c) for c in block._children.values())
