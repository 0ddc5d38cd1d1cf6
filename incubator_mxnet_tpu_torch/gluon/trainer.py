"""Gluon Trainer.

Counterpart of ``incubator_mxnet_tpu/gluon/trainer.py`` (ref:
python/mxnet/gluon/trainer.py:27 — step:258, allreduce_grads, update,
save/load_states) for one card: the kvstore is None, ``"local"`` or
``"device"``, and on one process each of them leaves the gradients as they
are. Dense gradients take the FUSED step by default (the reference's
``step``, trainer.py:140-215): one ``multi_tensor_update`` launch a step
over every parameter (``optimizer/fused.py``), in a ``fused_dispatch``
telemetry span, and with ``guard=`` an all-finite census on the device
that the guard reads one step later instead of a host sync a step.
``MXTPU_FUSED_STEP=0`` or ``engine.set_bulk_size(0)`` restore the
per-parameter path, which row-sparse parameters always take; there a
guarded step whose gradients trip the NaN sentinel is dropped before any
state is touched. The distributed stores (``dist_*``,
``update_on_kvstore``, gradient compression) are ROADMAP.md A10b and
raise.
"""
from __future__ import annotations

from typing import Dict, List

from .. import optimizer as _optimizer
from .. import telemetry as _telemetry
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]

_LOCAL_STORES = (None, "local", "device")


class Trainer:
    """Applies an Optimizer to a set of Parameters (ref: gluon/trainer.py:27)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, guard=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError(
                "First argument must be a list or dict of Parameters, "
                f"got {type(params)}.")
        if kvstore not in _LOCAL_STORES or update_on_kvstore \
                or compression_params:
            raise NotImplementedError(
                f"Trainer(kvstore={kvstore!r}, update_on_kvstore="
                f"{update_on_kvstore!r}, compression_params=...): "
                "distributed and on-store updates are ROADMAP.md A10b (one "
                "card: kvstore None, 'local' or 'device')")
        self._params: List[Parameter] = []
        self._param2idx: Dict[str, int] = {}
        for i, param in enumerate(params):
            if not isinstance(param, Parameter):
                raise ValueError(
                    "First argument must be a list or dict of Parameters, "
                    f"got list of {type(param)}.")
            self._param2idx[param.name] = i
            self._params.append(param)
        optimizer_params = optimizer_params if optimizer_params else {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._contains_sparse_weight = any(p._stype != "default"
                                           for p in self._params)
        self._contains_sparse_grad = any(p._grad_stype != "default"
                                         for p in self._params)
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore = None
        self._update_on_kvstore = False
        # opt-in step-level guardrails (guard.py): the sentinel checks each
        # step's gradients and may skip, rescale or roll back
        self._guard = None
        if guard is not None:
            from ..guard import GuardPolicy, TrainingGuard
            if not isinstance(guard, (GuardPolicy, TrainingGuard)):
                raise TypeError(f"Trainer(guard=...) takes a GuardPolicy or "
                                f"a TrainingGuard, got {type(guard)}")
            self._guard = guard if isinstance(guard, TrainingGuard) \
                else TrainingGuard(guard)
            self._guard.bind(trainer=self)

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: param for i, param in enumerate(self._params)}
        if isinstance(optimizer, _optimizer.Optimizer):
            assert not optimizer_params, \
                "optimizer_params must be None if optimizer is an Optimizer " \
                "instance"
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = _optimizer.create(
                optimizer, param_dict=param_dict, **optimizer_params)
        self._updaters = [_optimizer.get_updater(self._optimizer)]

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def guard(self):
        """The bound ``guard.TrainingGuard`` (None when unguarded)."""
        return self._guard

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale by 1 / batch_size, reduce, update (ref: trainer.py:258).

        Dense gradients take the fused step (one launch over every
        parameter, ``optimizer/fused.py``); with a ``guard`` bound, its
        device census skips a non-finite step on the device and trips the
        ladder when the guard reads it, at the next step. On the
        per-parameter path a step whose gradients trip the NaN sentinel
        is dropped (skipped, rescaled or rolled back by the ladder) before
        any state is touched."""
        if self._fused_step_eligible():
            guard = self._guard
            if guard is not None and not guard.fused_grads_ok(self):
                return
            self._optimizer.rescale_grad = self._scale / batch_size
            # the fused step is a telemetry span of its own, with plan
            # builds and in-place bytes attributed (gauge reads: no device
            # sync)
            compiles = _telemetry.gauge("fused_step_compiles")
            donated = _telemetry.gauge("fused_step_donated_bytes")
            c0, d0 = compiles.value(), donated.value()
            with _telemetry.span("fused_dispatch") as sp:
                ok = self._fused_apply(census=guard is not None)
                sp.set(retrace=compiles.value() > c0,
                       donated_bytes=donated.value() - d0)
            if guard is not None and ok is not None:
                guard.note_device_census(ok)
            return
        if self._guard is not None and not self._guard.grads_ok(self):
            return
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def _fused_step_eligible(self) -> bool:
        """The fused step takes the dense local-update case: weights
        updated here (not on a kvstore) and no row-sparse weight or
        gradient (ref: trainer.py _fused_step_eligible)."""
        from ..optimizer.fused import fused_enabled
        if not fused_enabled() or not self._optimizer.supports_fused():
            return False
        if self._update_on_kvstore:
            return False
        return not (self._contains_sparse_weight
                    or self._contains_sparse_grad)

    def _fused_apply(self, census=False):
        """One fused optimizer step over every updatable parameter.
        Returns the device-side all-finite census when ``census`` is on."""
        indices, weights, grads = [], [], []
        for i, param in enumerate(self._params):
            if param.grad_req == "null" or param._data is None:
                continue
            indices.append(i)
            weights.append(param._data)
            grads.append(param._grad)
        return self._updaters[0].update_batch(indices, grads, weights,
                                              census=census)

    def allreduce_grads(self):
        """(ref: trainer.py allreduce_grads) One card: nothing to reduce."""
        self._allreduce_grads()

    def _allreduce_grads(self):
        """A local store on one process leaves every gradient as it is."""

    def _update(self, ignore_stale_grad=False):
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            if not ignore_stale_grad and param._data is None:
                continue
            for upd, arr, grad in zip(self._updaters, param.list_data(),
                                      param.list_grad()):
                upd(i, grad, arr)

    def update(self, batch_size, ignore_stale_grad=False):
        """Apply updates only; gradients must already be reduced
        (ref: trainer.py update)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def save_states(self, fname):
        """(ref: trainer.py save_states)"""
        with open(fname, "wb") as fout:
            fout.write(self._updaters[0].get_states(dump_optimizer=True))

    def snapshot_states(self):
        raise NotImplementedError(
            "Trainer.snapshot_states: async checkpointing (fault.py) is "
            "ROADMAP.md A10b")

    def load_states(self, fname):
        """(ref: trainer.py load_states)"""
        with open(fname, "rb") as f:
            states = f.read()
        for updater in self._updaters:
            updater.set_states(states)
            updater.optimizer = self._updaters[0].optimizer
        self._optimizer = self._updaters[0].optimizer
        self._optimizer.param_dict = {i: param for i, param in
                                      enumerate(self._params)}
