"""Gluon Trainer.

Counterpart of ``incubator_mxnet_tpu/gluon/trainer.py`` (ref:
python/mxnet/gluon/trainer.py:27 — step:258, allreduce_grads, update,
save/load_states) for one card: the kvstore is None, ``"local"`` or
``"device"``, and on one process each of them leaves the gradients as they
are, so ``step`` is rescale + one optimizer update per parameter. With
``guard=`` (a ``guard.GuardPolicy`` or ``guard.TrainingGuard``) a step
whose gradients trip the guard's NaN sentinel is dropped before any state
is touched, as in the reference's per-parameter path; its fused path
(``optimizer/fused.py``, with the guard's device census) is ROADMAP.md A5.
The distributed stores (``dist_*``, ``update_on_kvstore``, gradient
compression) are ROADMAP.md A10 and raise.
"""
from __future__ import annotations

from typing import Dict, List

from .. import optimizer as _optimizer
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
                "distributed and on-store updates are ROADMAP.md A10 (one "
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
        With a ``guard`` bound, a step whose gradients trip the NaN
        sentinel is dropped (skipped, rescaled or rolled back by the
        ladder) before any state is touched."""
        if self._guard is not None and not self._guard.grads_ok(self):
            return
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._update(ignore_stale_grad)

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
            "ROADMAP.md A10")

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
