"""The functional training step of a gluon net, on one card.

Counterpart of ``incubator_mxnet_tpu/parallel/dp.py`` with ``mesh=None``:

* :func:`functional_call` runs a Block's forward as a function of
  (parameter values, inputs): parameters are substituted by name, MXNet
  recording is off (as in the reference's trace), and the caller's PyTorch
  grad mode stays in force, so ``torch.autograd.grad`` differentiates the
  call. That is the state the reference's ``jax.grad`` sees: the fused
  ResNet stages (which run only when training and not recording) take part
  through their ``torch.autograd.Function``.
* :func:`make_train_step` builds ``step(params, aux, opt_state, x, y, key,
  lr) -> (params, aux, opt_state, loss)``: SGD (with momentum) or Adam on
  float32 masters, ``compute_dtype`` (e.g. bfloat16) for the forward and
  backward, the loss and the masters in float32, and the forward's
  BatchNorm running-stat writes returned as the new aux values.
  ``unroll_steps`` > 1 runs that many updates per call in a Python loop
  (x and y carry a leading axis) and returns their mean loss; the
  reference's ``lax.scan`` amortises TPU dispatch and has no counterpart
  here.

A mesh, ``param_spec`` and the multi-card trainer are ROADMAP.md A10;
rematerialisation (``remat`` / ``MXTPU_REMAT``) is A3; the exported train
step (``export_train_step``) is A11. They raise.
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Dict, Tuple

import torch

from .. import autograd
from .. import random as _random
from ..autograd import _IN_TRACE
from ..gluon.block import Block
from ..gluon.parameter import parameter_substitution
from ..ndarray.ndarray import NDArray, _wrap

__all__ = ["functional_call", "DataParallelTrainer", "make_train_step",
           "export_train_step"]


@contextlib.contextmanager
def _functional_trace():
    prev = getattr(_IN_TRACE, "active", False)
    _IN_TRACE.active = True
    try:
        yield
    finally:
        _IN_TRACE.active = prev


def _no_mesh(what: str, mesh=None, param_spec=None) -> None:
    if mesh is not None or param_spec is not None:
        raise NotImplementedError(
            f"{what}: a device mesh / param_spec is the multi-card slice "
            "(ROADMAP.md A10); pass mesh=None")


def functional_call(net: Block, param_values: Dict[str, Any], *inputs,
                    training: bool = True, rng_key=None,
                    capture_updates=None):
    """Run ``net.forward`` as a pure function of (params, inputs).

    ``param_values`` maps parameter names (``collect_params()`` keys) to
    tensors; ``inputs`` are tensors or NDArrays; ``rng_key``, a
    ``torch.Generator``, feeds the call's random draws on its device.
    ``capture_updates``: names whose forward-side writes (BatchNorm running
    stats) are returned, as ``(out, {name: value})``.
    """
    params = net.collect_params()
    mapping, by_name = {}, {}
    for name, p in params.items():
        if name in param_values:
            w = NDArray(param_values[name], _direct=True)
            mapping[id(p)] = w
            by_name[name] = w
    wrapped = [x if isinstance(x, NDArray) else NDArray(x, _direct=True)
               for x in inputs]
    rng = (_random.use_generator(rng_key) if rng_key is not None
           else contextlib.nullcontext())
    with _functional_trace(), rng, parameter_substitution(mapping):
        with autograd.pause(train_mode=training):
            out = net.forward(*wrapped)
    if isinstance(out, NDArray):
        out = out._data
    elif isinstance(out, (list, tuple)):
        out = type(out)(o._data if isinstance(o, NDArray) else o
                        for o in out)
    if capture_updates is None:
        return out
    return out, {n: by_name[n]._data for n in capture_updates
                 if n in by_name}


# ---------------------------------------------------------------------------
# functional optimizers on {name: tensor} dicts
# ---------------------------------------------------------------------------

def _sgd_init(params, momentum):
    if momentum == 0.0:
        return {}
    return {"mom": {n: torch.zeros_like(v) for n, v in params.items()}}


def _sgd_update(params, grads, state, lr, wd, momentum):
    new_p, new_m = {}, {}
    for n, w in params.items():
        g = grads[n] + wd * w
        if momentum != 0.0:
            m = momentum * state["mom"][n] - lr * g
            new_p[n], new_m[n] = w + m, m
        else:
            new_p[n] = w - lr * g
    return new_p, ({"mom": new_m} if momentum != 0.0 else state)


def _adam_init(params):
    return {"m": {n: torch.zeros_like(v) for n, v in params.items()},
            "v": {n: torch.zeros_like(v) for n, v in params.items()},
            "t": torch.zeros((), dtype=torch.float32,
                             device=next(iter(params.values())).device)}


def _adam_update(params, grads, state, lr, wd, b1=0.9, b2=0.999, eps=1e-8):
    t = state["t"] + 1
    m = {n: b1 * state["m"][n] + (1 - b1) * g for n, g in grads.items()}
    v = {n: b2 * state["v"][n] + (1 - b2) * g * g for n, g in grads.items()}
    lr_t = lr * torch.sqrt(1 - b2 ** t) / (1 - b1 ** t)
    new_p = {n: w - lr_t * m[n] / (torch.sqrt(v[n]) + eps) - lr * wd * w
             for n, w in params.items()}
    return new_p, {"m": m, "v": v, "t": t}


def _forward_loss(net: Block, loss_fn: Callable, merged_params, x, y, key,
                  capture_updates=None):
    """The functional forward, the first output when the net returns a
    tuple, ``loss_fn``, and the float32 mean; with ``capture_updates``
    also the forward's aux writes."""
    out = functional_call(net, merged_params, x, training=True, rng_key=key,
                          capture_updates=capture_updates)
    new_aux = None
    if capture_updates is not None:
        out, new_aux = out
    if isinstance(out, tuple):
        out = out[0]
    with _functional_trace():
        loss = loss_fn(_wrap(out), _wrap(y))
    if isinstance(loss, NDArray):
        loss = loss._data
    loss = loss.float().mean()
    return loss if capture_updates is None else (loss, new_aux)


def make_train_step(net: Block, loss_fn: Callable, optimizer: str = "sgd",
                    learning_rate: float = 0.01, momentum: float = 0.0,
                    wd: float = 0.0, mesh=None,
                    data_axes: Tuple[str, ...] = ("data",),
                    param_spec=None, donate: bool = True,
                    compute_dtype=None, unroll_steps: int = 1,
                    remat=None):
    """Build (step_fn, params, aux_params, opt_state) on the net's device.

    ``step(params, aux_params, opt_state, x, y, key=None, lr=None) ->
    (params, aux_params, opt_state, loss)``; ``lr`` None means
    ``learning_rate``. Parameters, optimizer state and the loss are float32
    whatever ``compute_dtype`` (a torch dtype, e.g. ``torch.bfloat16``) the
    forward and backward run in; the returned aux values carry the
    forward's BatchNorm running-stat updates in their own type. ``donate``
    is accepted for the reference's signature: the step returns new
    tensors and never writes its inputs."""
    _no_mesh("make_train_step", mesh, param_spec)
    if remat is None and os.environ.get("MXTPU_REMAT"):
        remat = os.environ["MXTPU_REMAT"]
    if remat not in (None, False):
        raise NotImplementedError(
            "make_train_step(remat=...): rematerialisation policies are "
            "ROADMAP.md A3, not ported")
    all_params = net.collect_params()
    trainable = {n: p for n, p in all_params.items() if p.grad_req != "null"}
    aux = {n: p for n, p in all_params.items() if p.grad_req == "null"}
    params0 = {n: p.data()._data.detach().clone()
               for n, p in trainable.items()}
    aux0 = {n: p.data()._data.detach().clone() for n, p in aux.items()}

    if optimizer == "sgd":
        opt_state0 = _sgd_init(params0, momentum)

        def opt_update(p, g, s, lr):
            return _sgd_update(p, g, s, lr, wd, momentum)
    elif optimizer in ("adam", "adamw"):
        opt_state0 = _adam_init(params0)

        def opt_update(p, g, s, lr):
            return _adam_update(p, g, s, lr, wd)
    else:
        raise ValueError(f"functional optimizer {optimizer!r} not supported; "
                         "use 'sgd' or 'adam'")

    def _to_compute(v):
        if compute_dtype is not None and torch.is_tensor(v) \
                and v.is_floating_point():
            return v.to(compute_dtype)
        return v

    def one_step(params, aux_params, opt_state, x, y, key, lr):
        names = list(params)
        leaves = {n: params[n].detach().requires_grad_(True) for n in names}
        with torch.enable_grad():
            merged = {n: _to_compute(v) for n, v in leaves.items()}
            merged.update({n: _to_compute(v) for n, v in aux_params.items()})
            loss, new_aux = _forward_loss(
                net, loss_fn, merged, _to_compute(x), y, key,
                capture_updates=list(aux_params))
            grads = torch.autograd.grad(loss, [leaves[n] for n in names],
                                        allow_unused=True)
        grads = {n: (g if g is not None else torch.zeros_like(params[n]))
                 for n, g in zip(names, grads)}
        with torch.no_grad():
            new_params, new_state = opt_update(params, grads, opt_state, lr)
        aux_out = dict(aux_params)
        aux_out.update({n: v.detach().to(aux_params[n].dtype)
                        for n, v in new_aux.items()})
        return new_params, aux_out, new_state, loss.detach()

    def step(params, aux_params, opt_state, x, y, key=None, lr=None):
        lr = learning_rate if lr is None else float(lr)
        if unroll_steps == 1:
            return one_step(params, aux_params, opt_state, x, y, key, lr)
        losses = []
        for i in range(unroll_steps):
            params, aux_params, opt_state, loss = one_step(
                params, aux_params, opt_state, x[i], y[i], key, lr)
            losses.append(loss)
        return params, aux_params, opt_state, torch.stack(losses).mean()

    return step, params0, aux0, opt_state0


class DataParallelTrainer:
    """The functional step behind a stateful API (ref analog: Gluon Trainer
    with kvstore 'device'), on one card."""

    def __init__(self, net: Block, loss_fn, optimizer="sgd",
                 optimizer_params=None, mesh=None, param_spec=None,
                 unroll_steps: int = 1):
        _no_mesh("DataParallelTrainer", mesh, param_spec)
        optimizer_params = optimizer_params or {}
        self._net = net
        self._lr = float(optimizer_params.get("learning_rate", 0.01))
        self._unroll = max(1, int(unroll_steps))
        self._step_fn, self._params, self._aux, self._opt_state = \
            make_train_step(
                net, loss_fn, optimizer, learning_rate=self._lr,
                momentum=float(optimizer_params.get("momentum", 0.0)),
                wd=float(optimizer_params.get("wd", 0.0)),
                unroll_steps=self._unroll)
        self._loss = None

    @property
    def learning_rate(self):
        return self._lr

    def set_learning_rate(self, lr):
        self._lr = float(lr)

    def step(self, x, y):
        """One update (``unroll_steps`` updates when x and y carry a
        leading axis of that length); returns the loss as an NDArray."""
        xv = x._data if isinstance(x, NDArray) else x
        yv = y._data if isinstance(y, NDArray) else y
        self._params, self._aux, self._opt_state, loss = self._step_fn(
            self._params, self._aux, self._opt_state, xv, yv, None,
            self._lr)
        self._loss = loss
        return _wrap(loss)

    def sync_to_net(self):
        """Write the step's parameters and aux values back into the net."""
        with autograd.pause():
            for n, p in self._net.collect_params().items():
                if n in self._params:
                    p.data()._set_data(self._params[n])
                elif n in self._aux:
                    p.data()._set_data(self._aux[n])


def export_train_step(net: Block, loss_fn: Callable, prefix: str,
                      example_x, example_y, learning_rate: float = 0.1):
    raise NotImplementedError(
        "export_train_step: exported deployment artifacts are ROADMAP.md A11")
