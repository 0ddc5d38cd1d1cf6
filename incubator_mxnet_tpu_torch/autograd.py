"""Eager-mode automatic differentiation on PyTorch's autograd.

Counterpart of ``incubator_mxnet_tpu/autograd.py`` (record / pause /
train_mode / predict_mode / backward / grad / Function). The reference
keeps its own tape of ``jax.vjp`` closures; the port lets PyTorch's autograd
be the tape:

* Only ops inside ``record()`` are differentiated: ``nd`` ops run under
  ``torch.enable_grad`` while recording and under ``torch.no_grad``
  otherwise, so an op is on the graph only when recording and when an input
  is a marked variable or came off the graph (the reference's rule).
* A marked variable (``attach_grad`` / ``mark_variables``) is a leaf tensor
  that requires its gradient; marking an array that came off the graph
  makes it a fresh leaf.
* ``backward`` asks ``torch.autograd.grad`` for the gradients of every
  live marked variable and writes them by ``grad_req``: ``"write"``
  replaces ``.grad``, ``"add"`` accumulates (PyTorch would always
  accumulate). A head that is itself a marked leaf gets its gradient. The
  graph is freed unless ``retain_graph`` is set.
* ``grad(..., create_graph=True)`` returns gradients on the graph, which
  can be differentiated again. (The reference's tape does not record its
  own backward, so there a second differentiation gives zeros.)
* ``Function`` runs the user's ``forward`` and ``backward`` eagerly under
  ``pause()``, wrapped in a ``torch.autograd.Function``.

The recording and training flags are per thread, as in the reference.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Any

import torch

__all__ = [
    "record", "pause", "train_mode", "predict_mode",
    "is_recording", "is_training", "set_recording", "set_training",
    "mark_variables", "backward", "grad", "get_symbol", "Function",
]


class _AGState(threading.local):
    def __init__(self) -> None:
        self.recording = False
        self.training = False


_STATE = _AGState()
# marked variables by id; an entry goes when its array is collected
_MARKED: "weakref.WeakValueDictionary[int, Any]" = \
    weakref.WeakValueDictionary()
_MARKED_LOCK = threading.Lock()


def _op_grad_mode():
    """The grad mode an ``nd`` op runs in: enabled only while recording."""
    return torch.enable_grad() if _STATE.recording else torch.no_grad()


# ---------------------------------------------------------------------------
# scope managers (ref: autograd.py:122-216)
# ---------------------------------------------------------------------------

class _RecordingStateScope:
    def __init__(self, is_record, train_mode) -> None:
        self._enter_is_record = is_record
        self._enter_train_mode = train_mode
        self._prev_is_record = None
        self._prev_train_mode = None

    def __enter__(self) -> None:
        if self._enter_is_record is not None:
            self._prev_is_record = set_recording(self._enter_is_record)
        if self._enter_train_mode is not None:
            self._prev_train_mode = set_training(self._enter_train_mode)

    def __exit__(self, *exc) -> None:
        if self._enter_is_record is not None \
                and self._prev_is_record != self._enter_is_record:
            set_recording(self._prev_is_record)
        if self._enter_train_mode is not None \
                and self._prev_train_mode != self._enter_train_mode:
            set_training(self._prev_train_mode)


def record(train_mode: bool = True) -> _RecordingStateScope:
    """Scope that records ops for gradient computation."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode: bool = False) -> _RecordingStateScope:
    """Scope that suspends recording."""
    return _RecordingStateScope(False, train_mode)


def train_mode() -> _RecordingStateScope:
    return _RecordingStateScope(None, True)


def predict_mode() -> _RecordingStateScope:
    return _RecordingStateScope(None, False)


def is_recording() -> bool:
    return _STATE.recording


def is_training() -> bool:
    return _STATE.training


def set_recording(is_record: bool) -> bool:
    prev, _STATE.recording = _STATE.recording, bool(is_record)
    return prev


def set_training(train: bool) -> bool:
    prev, _STATE.training = _STATE.training, bool(train)
    return prev


# ---------------------------------------------------------------------------
# variables and backward
# ---------------------------------------------------------------------------

def _differentiable(t: torch.Tensor) -> bool:
    return t.is_floating_point() or t.is_complex()


def mark_variables(variables, gradients, grad_reqs: Any = "write") -> None:
    """Mark NDArrays as autograd leaves with their gradient buffers
    (ref: autograd.py mark_variables). ``grad_req`` is ``"write"``,
    ``"add"`` or ``"null"`` (not a variable)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, gradient, req in zip(variables, gradients, grad_reqs):
        var._ag_marked = req != "null"
        var._ag_grad = gradient
        var._ag_grad_req = req
        leaf = var._data.detach()
        with _MARKED_LOCK:
            if var._ag_marked and _differentiable(leaf):
                leaf.requires_grad_(True)
                _MARKED[id(var)] = var
            else:
                _MARKED.pop(id(var), None)
        var._data = leaf


def _heads(heads, head_grads):
    """(head tensors on the graph, their head gradients)."""
    from .ndarray.ndarray import NDArray
    if isinstance(heads, NDArray):
        heads = [heads]
        if isinstance(head_grads, NDArray):
            head_grads = [head_grads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    hs, hgs = [], []
    for h, hg in zip(heads, head_grads):
        if not h._data.requires_grad:
            continue           # off the graph: nothing flows from it
        hs.append(h._data)
        hgs.append(torch.ones_like(h._data) if hg is None
                   else hg._data.to(h._data.dtype))
    return hs, hgs


def backward(heads, head_grads=None, retain_graph: bool = False,
             train_mode: bool = True) -> None:
    """Gradients of ``heads`` into the ``.grad`` of every marked variable
    they reach, by its ``grad_req`` (ref: autograd.py backward)."""
    hs, hgs = _heads(heads, head_grads)
    with _MARKED_LOCK:
        marked = [v for v in _MARKED.values()
                  if v._ag_marked and v._data.requires_grad]
    if not hs or not marked:
        return
    grads = torch.autograd.grad(hs, [v._data for v in marked], hgs,
                                retain_graph=retain_graph, allow_unused=True)
    for v, g in zip(marked, grads):
        if g is None or v._ag_grad is None:
            continue
        buf = v._ag_grad
        if v._ag_grad_req == "add":
            buf._data = buf._data + g.to(buf._data.dtype)
        else:
            buf._data = g.to(v._data.dtype)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph: bool = False, train_mode: bool = True):
    """Gradients of ``heads`` with respect to ``variables``, returned
    instead of written to ``.grad`` (ref: autograd.py grad). With
    ``create_graph`` they are on the graph and can be differentiated
    again. A variable the heads do not reach gets zeros."""
    from .ndarray.ndarray import NDArray, _wrap
    single = isinstance(variables, NDArray)
    if single:
        variables = [variables]
    if retain_graph is None:
        retain_graph = create_graph
    hs, hgs = _heads(heads, head_grads)
    live = [v for v in variables if v._data.requires_grad]
    found = {}
    if hs and live:
        mode = torch.enable_grad() if create_graph else contextlib.nullcontext()
        with mode:
            gs = torch.autograd.grad(hs, [v._data for v in live], hgs,
                                     retain_graph=retain_graph,
                                     create_graph=create_graph,
                                     allow_unused=True)
        found = {id(v): g for v, g in zip(live, gs) if g is not None}
    result = [_wrap(found[id(v)] if id(v) in found
                    else torch.zeros_like(v._data.detach()))
              for v in variables]
    return result[0] if single else result


def get_symbol(x):  # pragma: no cover - reference-compat stub
    raise NotImplementedError(
        "get_symbol: graph export is the symbolic slice (ROADMAP.md A11)")


# ---------------------------------------------------------------------------
# custom Function (ref: autograd.py:385 Function)
# ---------------------------------------------------------------------------

class _FunctionBridge(torch.autograd.Function):
    """Runs a user :class:`Function` as one node of PyTorch's graph."""

    @staticmethod
    def forward(ctx, fn, *tensors):
        from .ndarray.ndarray import NDArray, _wrap
        ctx.fn = fn
        with pause():
            outs = fn.forward(*[_wrap(t.detach()) for t in tensors])
        fn._single_output = isinstance(outs, NDArray)
        outs = [outs] if fn._single_output else list(outs)
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray.ndarray import NDArray, _wrap
        with pause():
            gs = ctx.fn.backward(*[_wrap(g) for g in grads])
        if isinstance(gs, NDArray):
            gs = (gs,)
        return (None,) + tuple(g._data if g is not None else None
                               for g in gs)


class Function:
    """User-defined differentiable function with explicit forward and
    backward over NDArrays (ref: python/mxnet/autograd.py:385-511).
    Subclass and implement ``forward(self, *inputs)`` and
    ``backward(self, *output_grads)``; both run eagerly, unrecorded."""

    def __init__(self) -> None:
        self._saved: tuple = ()

    def save_for_backward(self, *arrays) -> None:
        self._saved = arrays

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray, _wrap
        if not is_recording():
            with pause():
                return self.forward(*inputs)
        with torch.enable_grad():
            outs = _FunctionBridge.apply(self, *[x._data for x in inputs])
        wrapped = tuple(_wrap(o) for o in outs)
        return wrapped[0] if self._single_output else wrapped
