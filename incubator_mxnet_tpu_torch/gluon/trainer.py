"""Gluon Trainer.

Counterpart of ``incubator_mxnet_tpu/gluon/trainer.py`` (ref:
python/mxnet/gluon/trainer.py:27 — the store decision table of
_init_kvstore:158-218, step:258, _allreduce_grads:315, _update:358,
update_on_kvstore, save/load_states). Dense gradients take the FUSED step
by default (the reference's ``step``, trainer.py:140-215): one
``multi_tensor_update`` launch a step over every parameter
(``optimizer/fused.py``), in a ``fused_dispatch`` telemetry span, and with
``guard=`` an all-finite census on the device that the guard reads one step
later instead of a host sync a step; on a ``dist_sync`` store of several
processes the gradients are summed first in one collective
(``KVStore.allreduce_tree``). ``MXTPU_FUSED_STEP=0`` or
``engine.set_bulk_size(0)`` restore the per-parameter path, which
row-sparse parameters, ``update_on_kvstore``, ``dist_async`` and gradient
compression always take: a push and a pull a parameter through the store
(``kvstore.py``); there a guarded step whose gradients trip the NaN
sentinel is dropped before any state is touched.

The store is made at the first step, by the reference's table: None,
``"local"`` and ``"device"`` keep the local step (no store: one process
has nothing to reduce) unless ``update_on_kvstore`` or
``compression_params`` ask for one; any other type (or a ``KVStore``) makes
its store, and ``update_on_kvstore`` then defaults to True for the ``dist``
types and for row-sparse parameters.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from .. import kvstore as _kvstore
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
        self._params: List[Parameter] = []
        self._param2idx: Dict[str, int] = {}
        for i, param in enumerate(params):
            if not isinstance(param, Parameter):
                raise ValueError(
                    "First argument must be a list or dict of Parameters, "
                    f"got list of {type(param)}.")
            self._param2idx[param.name] = i
            self._params.append(param)
        self._compression_params = compression_params
        optimizer_params = optimizer_params if optimizer_params else {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._contains_sparse_weight = any(p._stype != "default"
                                           for p in self._params)
        self._contains_sparse_grad = any(p._grad_stype != "default"
                                         for p in self._params)
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore_params = {"kvstore": kvstore,
                                "update_on_kvstore": update_on_kvstore}
        self._kv_initialized = False
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

    def _init_kvstore(self):
        """The store and ``update_on_kvstore`` (ref: trainer.py:158-218;
        the module's note on the local types)."""
        config = self._kvstore_params
        kvstore = config["kvstore"]
        update_on_kvstore = config["update_on_kvstore"]
        kv = None
        if not (kvstore in _LOCAL_STORES and not update_on_kvstore
                and not self._compression_params):
            kv = kvstore if isinstance(kvstore, _kvstore.KVStore) \
                else _kvstore.create(kvstore or "local")
        if kv is not None:
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            if update_on_kvstore is None:
                # sparse weights update on the store (ref: trainer.py:173)
                update_on_kvstore = (self._contains_sparse_weight
                                     or self._contains_sparse_grad
                                     or kv.type.startswith("dist"))
            if update_on_kvstore:
                kv.set_optimizer(self._optimizer)
            for i, param in enumerate(self._params):
                if param.grad_req != "null":
                    kv.init(i, param.data())
        self._kvstore = kv
        self._update_on_kvstore = bool(update_on_kvstore) if kv else False
        self._kv_initialized = True

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

    def _row_sparse_pull(self, parameter, out, row_id, full_idx=False):
        """(ref: trainer.py _row_sparse_pull)"""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._kvstore is not None:
            self._kvstore.row_sparse_pull(self._param2idx[parameter.name],
                                          out=out, row_ids=row_id)

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale by 1 / batch_size, reduce, update (ref: trainer.py:258).

        Dense gradients take the fused step (one launch over every
        parameter, ``optimizer/fused.py``; on a ``dist_sync`` store of
        several processes one collective sums them first); with a
        ``guard`` bound, its device census skips a non-finite step on the
        device and trips the ladder when the guard reads it, at the next
        step. On the per-parameter path a step whose gradients trip the
        NaN sentinel is dropped (skipped, rescaled or rolled back by the
        ladder) before any state is touched."""
        if not self._kv_initialized:
            # an optimizer sent to the async server carries the rescale of
            # the first step's batch size (MXNet's rule: it does not follow
            # a later change of batch size)
            self._optimizer.rescale_grad = self._scale / batch_size
            self._init_kvstore()
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
                self._fused_allreduce()
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
        updated here (not on a store), dense gradients, no compression
        residuals and no async pushes (ref: trainer.py
        _fused_step_eligible)."""
        from ..optimizer.fused import fused_enabled
        if not fused_enabled() or not self._optimizer.supports_fused():
            return False
        if self._update_on_kvstore:
            return False
        if self._contains_sparse_weight or self._contains_sparse_grad:
            return False
        kv = self._kvstore
        return kv is None or not (kv._is_async or kv._compression is not None)

    def _fused_allreduce(self):
        """The gradients summed over the store's processes in ONE
        collective (``KVStore.allreduce_tree``), in place; nothing to do
        without a ``dist`` store of several processes."""
        kv = self._kvstore
        if kv is None or not (kv._is_dist and kv.num_workers > 1):
            return
        grads = [param._grad for param in self._params
                 if param.grad_req != "null" and param._data is not None]
        reduced = kv.allreduce_tree([g._data for g in grads])
        with torch.no_grad():
            for g, r in zip(grads, reduced):
                g._data.copy_(r)

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
        """(ref: trainer.py allreduce_grads) For a step split into the
        reduction and ``update`` (gradient accumulation)."""
        if not self._kv_initialized:
            self._init_kvstore()
        assert not (self._kvstore and self._update_on_kvstore), \
            "allreduce_grads() when parameters are updated on kvstore " \
            "is not supported. Try setting `update_on_kvstore` to False " \
            "when creating trainer."
        self._allreduce_grads()

    def _allreduce_grads(self):
        """A push a parameter; without ``update_on_kvstore`` the reduced
        gradient is pulled back into the gradient buffer. No store: nothing
        to reduce."""
        if self._kvstore is None:
            return
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            # a row-sparse gradient crosses the store row-sparse; grad()
            # stays the dense buffer the pull below writes into
            sparse_push = param._grad_stype == "row_sparse"
            grads = ([param.row_sparse_grad()] if sparse_push
                     else param.list_grad())
            self._kvstore.push(i, grads)
            if not self._update_on_kvstore:
                self._kvstore.pull(i, param.list_grad(), ignore_sparse=False)

    def _update(self, ignore_stale_grad=False):
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            if not ignore_stale_grad and param._data is None:
                continue
            if self._update_on_kvstore and self._kvstore is not None:
                # the store applied the update: copy the weight back
                self._kvstore.pull(i, param.list_data(), ignore_sparse=False)
                continue
            for upd, arr, grad in zip(self._updaters, param.list_data(),
                                      param.list_grad()):
                upd(i, grad, arr)

    def update(self, batch_size, ignore_stale_grad=False):
        """Apply updates only; gradients must already be reduced
        (ref: trainer.py update)."""
        if not self._kv_initialized:
            self._init_kvstore()
        assert not (self._kvstore and self._update_on_kvstore), \
            "update() when parameters are updated on kvstore " \
            "is not supported. Try setting `update_on_kvstore` to False " \
            "when creating trainer."
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def save_states(self, fname):
        """(ref: trainer.py save_states)"""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=True)
            return
        with open(fname, "wb") as fout:
            fout.write(self._updaters[0].get_states(dump_optimizer=True))

    def snapshot_states(self):
        """The optimizer state for an async checkpoint
        (``fault.CheckpointManager.save_async``): the state tensors copied
        on their device now (the fused step then updates the live ones in
        place), the optimizer pickled now, and a closure that writes
        ``save_states``'s bytes from any thread. None when the state lives
        on the store (``update_on_kvstore``): the caller saves
        synchronously."""
        import pickle
        from ..optimizer.optimizer import _states_to_numpy
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            return None
        upd = self._updaters[0]
        states_dev = {k: _copy_state(v) for k, v in upd.states.items()}
        # the parameters are reattached from the live ones on load
        pd, self._optimizer.param_dict = self._optimizer.param_dict, {}
        try:
            opt_blob = pickle.dumps(self._optimizer)
        finally:
            self._optimizer.param_dict = pd

        def serialize() -> bytes:
            st = {k: _states_to_numpy(v) for k, v in states_dev.items()}
            return pickle.dumps((st, pickle.loads(opt_blob)))
        return serialize

    def load_states(self, fname):
        """(ref: trainer.py load_states)"""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            self._optimizer = self._kvstore.updater.optimizer
        else:
            with open(fname, "rb") as f:
                states = f.read()
            for updater in self._updaters:
                updater.set_states(states)
                updater.optimizer = self._updaters[0].optimizer
            self._optimizer = self._updaters[0].optimizer
        self._optimizer.param_dict = {i: param for i, param in
                                      enumerate(self._params)}


def _copy_state(state):
    """A state tree's NDArrays copied on their device."""
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_copy_state(s) for s in state)
    return state.copy() if hasattr(state, "copy") else state
