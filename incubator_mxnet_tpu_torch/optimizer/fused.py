"""The fused whole-step trainer update: one update launch a step over the
parameter/grad/state tree.

Counterpart of ``incubator_mxnet_tpu/optimizer/fused.py``. The reference's
headline lever is bulk execution (``MXNET_EXEC_BULK_EXEC_TRAIN``,
``Engine::set_bulk_size``); its TPU form is one donated XLA program over
the whole step. Here it is a hand-written multi-tensor kernel
(``ops/cuda/multi_tensor.py``): instead of a chain of elementwise ATen
launches per tensor, a chunk of the step is ONE ``multi_tensor_update``
launch over a table of tensors, in place, for SGD (momentum 0 or more),
NAG, Adam and AdamW. Every other fused-eligible optimizer has nothing to
fuse: under a census it runs its ``tensor_step`` tensor by tensor on the
device inside the executor, gated by the census; without one its dense
tensors take the per-parameter update. The optimizer's class decides the
route, never a build or a launch (which raise).

Semantics knobs (the reference's):

  * ``MXTPU_FUSED_STEP=0`` (or the reference-named
    ``MXTPU_EXEC_BULK_EXEC_TRAIN=0``: one setting, ``base.env``)
                                      — per-parameter path
  * ``engine.set_bulk_size(0)``       — fusion off; ``set_bulk_size(N)``
    chunks the step into ceil(T/N) launches; unset is one launch.

The census (``census=True``): ONE all-finite launch
(``multi_tensor_all_finite``) over every fused gradient, dense and
row-sparse, leaves a one-byte flag on the device that every chunk's and
every sparse update's launch reads: a NaN anywhere skips the whole step on
the device, and nothing syncs the host. ``guard.TrainingGuard`` reads the
flag one step later (``note_device_census``).

Where the reference donates weight and state buffers to XLA, the port
updates them in place (PyTorch cannot donate a buffer):
``fused_step_donated_bytes`` counts the weight and state bytes rewritten
in place. A step whose rows share a weight or state buffer (tied
weights), or hold one that is not contiguous, takes the per-parameter
path, as the reference's does for aliased buffers.

Counters (``stats()``, each a ``telemetry`` gauge of the same name):
  fused_step_compiles      — plans built (a plan is a chunk's layout of
                             tensors, or the census's; hypers are launch
                             data, so a learning-rate change builds none;
                             the CPU counts the builds the card makes)
  fused_step_dispatches    — fused chunks run (one launch each on the
                             card for the kernel's rules)
  fused_step_donated_bytes — weight and state bytes updated in place
  fused_step_updates       — tensors updated on the dense fused path
  fused_step_sparse_updates — tensors updated by the lazy row-sparse branch
  per_param_compiles       — the reference's per-tensor traces (the port's
                             per-parameter path compiles nothing: 0)
  fused_step_kernel_updates — tensors a kernel updated (dense or sparse)
  fused_step_tensor_step_updates — tensors updated by ``tensor_step`` on
                             the device or on the CPU
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from .. import telemetry as _telemetry
from ..base import env
from ..ndarray import sparse as _sp
from ..ndarray.ndarray import NDArray, _wrap
from ..ops.cuda import multi_tensor as _mt
from .optimizer import (NAG, SGD, Adam, AdamW, Optimizer,
                        _sparse_to_dense_grad, _state_tensors)

__all__ = ["fused_enabled", "FusedStepExecutor", "row_slice_step",
           "stats", "reset_stats"]

_COUNTERS = ("fused_step_compiles", "fused_step_dispatches",
             "fused_step_donated_bytes", "fused_step_updates",
             "fused_step_sparse_updates", "per_param_compiles",
             "fused_step_kernel_updates", "fused_step_tensor_step_updates")

#: the optimizer classes whose rule ``multi_tensor_update`` runs (exactly
#: these classes: a subclass may change the rule)
KERNEL_CLASSES = (SGD, NAG, Adam, AdamW)

row_slice_step = _mt.row_sparse_update_reference


def _gauge(name):
    return _telemetry.gauge(name)


def _count(name: str, v: float = 1) -> None:
    _gauge(name).inc(v)


def stats() -> Dict[str, int]:
    """Current counter values (testing/bench hook)."""
    return {k: int(_gauge(k).value()) for k in _COUNTERS}


def reset_stats() -> None:
    for k in _COUNTERS:
        _gauge(k).set(0)


def fused_enabled() -> bool:
    """Fused whole-step updates are the default for dense gradients;
    ``MXTPU_FUSED_STEP=0``, ``MXTPU_EXEC_BULK_EXEC_TRAIN=0`` or
    ``engine.set_bulk_size(0)`` fall back to the per-parameter path."""
    if not env.get("FUSED_STEP", True):
        return False
    from .. import engine
    bs = engine.bulk_size()
    return bs is None or bs != 0


def _chunk_size(n: int) -> int:
    from .. import engine
    bs = engine.bulk_size()
    return n if bs is None or bs <= 0 else max(1, int(bs))


def kernel_route(opt: Optimizer) -> bool:
    """Does ``opt``'s class take ``multi_tensor_update``?"""
    return type(opt) in KERNEL_CLASSES


def _leaves(state) -> List[torch.Tensor]:
    return [t for t in _mt._leaves(state) if t is not None]


class FusedStepExecutor:
    """The fused step of one (Updater, optimizer) pair. Plans (a chunk's
    layout: its tensors' sizes, types and states) are built once and
    kept; pointers, gradients and hypers are written into the plan's table
    every step."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self._plans: Dict[Any, Optional[_mt.Plan]] = {}

    def _plan(self, key, make) -> Optional[_mt.Plan]:
        plan = self._plans.get(key, False)
        if plan is False:
            _count("fused_step_compiles")
            if len(self._plans) >= 64:
                self._plans.clear()
            plan = self._plans[key] = make()
        return plan

    # ------------------------------------------------------------ the step
    def step(self, indices: Sequence[Any], weights: Sequence[NDArray],
             grads: Sequence[Any], states: Sequence[Any],
             census: bool = False) -> Optional[NDArray]:
        """Apply one optimizer step to every (index, weight, grad, state).

        Dense tensors run one launch a chunk (``engine.set_bulk_size``);
        row-sparse gradients of a lazy optimizer update their active rows
        only; other sparse gradients fall back to the per-key path.
        Returns the device-side all-finite census (a 0-d bool NDArray) when
        ``census`` is set and a tensor fused, else None."""
        opt = self.optimizer
        mp_on = bool(getattr(opt, "multi_precision", False))
        lazy_opt = (getattr(opt, "lazy_update", False)
                    and not getattr(opt, "momentum", 0.0)
                    and opt.supports_fused())
        # a rule the kernel does not take, with no census to gate on: its
        # dense tensors take the per-parameter update (the results rebound,
        # no copy back)
        dense_per_param = not census and not kernel_route(opt)
        fused_rows: List[int] = []
        sparse_rows: List[int] = []
        skip_rows: List[int] = []
        seen = set()
        aliased = False
        for row, (w, g) in enumerate(zip(weights, grads)):
            sparse = isinstance(g, _sp.BaseSparseNDArray)
            row_sparse = isinstance(g, _sp.RowSparseNDArray)
            mp = mp_on and w._data.dtype == torch.float16
            lazy = row_sparse and lazy_opt and not mp
            if lazy and not g.nnz:
                # lazy semantics for zero active rows: no update at all
                skip_rows.append(row)
                continue
            if (sparse and not lazy) or (dense_per_param and not sparse):
                continue
            # every buffer a row rewrites in place must be its own and
            # contiguous (tied weights, aliased or strided state)
            bufs = [w._data] + _leaves(_state_tensors(states[row]))
            ptrs = {b.data_ptr() for b in bufs if b.numel()}
            if ptrs & seen or len(ptrs) < sum(1 for b in bufs if b.numel()) \
                    or not all(b.is_contiguous() for b in bufs):
                aliased = True
                continue
            seen |= ptrs
            (sparse_rows if sparse else fused_rows).append(row)
        if aliased:
            fused_rows, sparse_rows = [], []

        for r in skip_rows:
            opt._update_count(indices[r])
        done = set(fused_rows) | set(sparse_rows) | set(skip_rows)
        for r in range(len(weights)):
            if r not in done:
                opt.update_multi_precision(indices[r], weights[r], grads[r],
                                           states[r])
        if not fused_rows and not sparse_rows:
            return None
        with torch.no_grad():
            ok = self._census(weights, grads, fused_rows, sparse_rows) \
                if census else None
            for r in sparse_rows:
                self._sparse_update(indices[r], weights[r], grads[r],
                                    states[r], ok)
            csize = max(1, _chunk_size(len(fused_rows)))
            for start in range(0, len(fused_rows), csize):
                self._chunk([(indices[r], weights[r], grads[r], states[r])
                             for r in fused_rows[start:start + csize]],
                            mp_on, ok)
        return None if ok is None else _wrap(ok)

    # ------------------------------------------------------------- census
    def _census(self, weights, grads, fused_rows, sparse_rows):
        """ONE all-finite census over every fused gradient (dense tensors
        and sparse row values): the flag every launch of the step reads."""
        gs = [(grads[r].data if r in sparse_rows else
               _sparse_to_dense_grad(grads[r])._data)
              for r in fused_rows + sparse_rows]
        gs = [g for g in gs if g.numel()]
        if not gs:
            dev = weights[(fused_rows + sparse_rows)[0]]._data.device
            return torch.ones((), dtype=torch.bool, device=dev)
        plan = self._plan(
            ("census", tuple((g.numel(), g.dtype) for g in gs)),
            lambda: _mt.Plan(*_mt.census_layout(gs)) if gs[0].is_cuda
            else None)
        return _mt.all_finite(plan, gs)

    # ---------------------------------------------------------- row-sparse
    def _sparse_update(self, index, weight, grad, state, ok):
        """The lazy row-sparse branch: the active rows of the weight and
        its states, in place; the (rows, ...) gradient never densifies."""
        opt = self.optimizer
        opt._update_count(index)
        h = opt.fused_hypers(index)
        w, st = weight._data, _state_tensors(state)
        if kernel_route(opt):
            route = _mt.update_rows(opt.multi_tensor_kind(), opt.tensor_step,
                                    w, st, grad.indices, grad.data, h,
                                    opt.multi_tensor_hypers(h), ok)
        else:
            _mt.row_sparse_update_reference(opt.tensor_step, w, st,
                                            grad.indices, grad.data, h, ok)
            route = "tensor_step"
        _count("fused_step_sparse_updates")
        _count("fused_step_kernel_updates" if route == "kernel"
               else "fused_step_tensor_step_updates")

    # --------------------------------------------------------------- chunk
    def _chunk(self, rows, mp_on, ok) -> None:
        """One fused chunk: ``(index, weight, grad, state)`` rows updated in
        place, in one ``multi_tensor_update`` launch where the class takes
        the kernel and the tensors lie on the card, else (under a census)
        by ``tensor_step`` tensor by tensor (empty tensors have nothing to
        update and are left out). A plan is kept a layout on either
        device: on the CPU, which keeps no table, it counts the builds the
        card makes, so the no-retrace tests hold there too."""
        opt = self.optimizer
        ws, gs, sts, hs, masters = [], [], [], [], []
        for idx, weight, grad, state in rows:
            opt._update_count(idx)
            h = opt.fused_hypers(idx)
            w = weight._data
            if not w.numel():
                continue
            st = _state_tensors(state)
            master = None
            if mp_on and w.dtype == torch.float16:
                master, st = st
            ws.append(w)
            gs.append(_sparse_to_dense_grad(grad)._data)
            sts.append(st)
            hs.append(h)
            masters.append(master)
        nbytes = sum(t.numel() * t.element_size()
                     for w, st, m in zip(ws, sts, masters)
                     for t in [w] + _leaves(st) + ([m] if m is not None
                                                   else []))
        route = "tensor_step"
        if ws and kernel_route(opt):
            kind = opt.multi_tensor_kind()

            def make():
                if not ws[0].is_cuda:
                    return None
                return _mt.Plan([w.numel() for w in ws], [
                    _mt.storage_code(w, g, _leaves(st), m)
                    for w, g, st, m in zip(ws, gs, sts, masters)])
            plan = self._plan(("update", kind, self._layout(
                ws, gs, sts, masters)), make)
            route = _mt.update_tensors(
                kind, opt.tensor_step, plan, ws, gs, sts, hs,
                [opt.multi_tensor_hypers(h) for h in hs], masters, ok)
        elif ws:
            _mt.multi_tensor_update_reference(opt.tensor_step, ws, gs, sts,
                                              hs, masters, ok)
        _count("fused_step_donated_bytes", nbytes)
        _count("fused_step_dispatches")
        _count("fused_step_updates", len(rows))
        _count("fused_step_kernel_updates" if route == "kernel"
               else "fused_step_tensor_step_updates", len(ws))

    @staticmethod
    def _layout(ws, gs, sts, masters):
        """What a plan's table holds but the step's data: each tensor's
        size and the types of its weight, gradient, master and states."""
        return tuple((w.numel(), w.dtype, g.dtype, m is not None,
                      tuple(t.dtype for t in _leaves(st)))
                     for w, g, st, m in zip(ws, gs, sts, masters))
