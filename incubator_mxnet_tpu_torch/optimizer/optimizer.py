"""Optimizers.

Counterpart of ``incubator_mxnet_tpu/optimizer/optimizer.py`` (ref:
python/mxnet/optimizer/optimizer.py — the Optimizer base and registry, SGD
with momentum and multi-precision, NAG, Signum, SGLD, Adam, AdamW, AdaGrad,
RMSProp, AdaDelta, Ftrl, Adamax, Nadam, FTML, DCASGD, LBSGD, LAMB, Test;
``Updater`` / ``get_updater``).

Each update goes through the port's ``nd`` update ops
(``ndarray/optimizer_ops.py``) where one computes the reference's rule:
SGD, NAG, Signum with momentum, Adam (bias correction folded into the
learning rate, as the reference's fused op takes it), AdaGrad, RMSProp
(plain and centered), Ftrl and FTML. The others keep the reference's pure
``tensor_step(w, g, state, h)`` rule, in PyTorch, applied under
``torch.no_grad``. Weights and states are rebound, never written in place.
The reference's fused whole-step executor (``optimizer/fused.py``, one
donated XLA program per step) is not ported (ROADMAP.md A5): every update
is per parameter.
"""
from __future__ import annotations

import math
import pickle
from typing import Any, Dict

import numpy as _np
import torch

from ..base import registry_get
from ..ndarray import optimizer_ops as _ops
from ..ndarray.ndarray import NDArray, array as nd_array, zeros as nd_zeros

__all__ = ["Optimizer", "SGD", "NAG", "Signum", "SGLD", "Adam", "AdaGrad",
           "RMSProp", "AdaDelta", "Ftrl", "Adamax", "Nadam", "FTML", "DCASGD",
           "LBSGD", "LAMB", "AdamW", "Test", "Updater", "get_updater",
           "register", "create"]

_REG = registry_get("optimizer")


def register(klass):
    _REG.register(klass)
    return klass


def create(name, **kwargs):
    return _REG.create(name, **kwargs)


def _rescale_clip(g, h):
    """rescale, then clip (a clip of 0 is off)."""
    g = g * h["rescale"]
    clip = h["clip"]
    return torch.clamp(g, -clip, clip) if clip > 0 else g


def _clip_arg(h):
    """The clip threshold as the nd update ops take it (-1 is off)."""
    return h["clip"] if h["clip"] > 0 else -1.0


def _state_tensors(state):
    if state is None:
        return None
    if isinstance(state, NDArray):
        return state._data
    return tuple(_state_tensors(s) for s in state)


def _state_rebind(state, new):
    if state is None:
        return
    if isinstance(state, NDArray):
        state._set_data(new)
        return
    for s, n in zip(state, new):
        _state_rebind(s, n)


class Optimizer:
    """Base optimizer (ref: optimizer.py:41 Optimizer): per-index update
    counts, lr/wd multipliers, gradient rescale and clipping."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count: Dict[int, int] = {}
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict or {}
        self.lr_mult: Dict[str, float] = {}
        self.wd_mult: Dict[str, float] = {}

    # ---------------------------------------------------------------- config
    def set_learning_rate(self, lr: float) -> None:
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already been "
                              "defined. Note that set_learning_rate can mutate "
                              "the value of the learning rate of the optimizer "
                              "only when the LRScheduler of the optimizer is "
                              "undefined.")
        self.lr = lr

    @property
    def learning_rate(self) -> float:
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_lr_mult(self, args_lr_mult: Dict[str, float]) -> None:
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult: Dict[str, float]) -> None:
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index) -> None:
        if not isinstance(index, (list, tuple)):
            index = [index]
        for idx in index:
            self._index_update_count.setdefault(idx, self.begin_num_update)
            self._index_update_count[idx] += 1
            self.num_update = max(self._index_update_count[idx],
                                  self.num_update)

    def _mult(self, index, attr: str, table: Dict[str, float]) -> float:
        name = self.idx2name.get(index,
                                 index if isinstance(index, str) else None)
        if name is not None and name in self.param_dict:
            return getattr(self.param_dict[name], attr, 1.0)
        if index in self.param_dict:
            return getattr(self.param_dict[index], attr, 1.0)
        if name is not None:
            return table.get(name, 1.0)
        return 1.0

    def _get_lr(self, index) -> float:
        return self.learning_rate * self._mult(index, "lr_mult", self.lr_mult)

    def _get_wd(self, index) -> float:
        return self.wd * self._mult(index, "wd_mult", self.wd_mult)

    # ----------------------------------------------------------------- hooks
    def create_state(self, index, weight: NDArray):
        return None

    def create_state_multi_precision(self, index, weight: NDArray):
        """float16 weights keep a float32 master copy (ref: optimizer.py
        create_state_multi_precision)."""
        if self.multi_precision and weight.dtype == _np.float16:
            master = weight.astype("float32")
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    def fused_hypers(self, index) -> Dict[str, Any]:
        """The per-tensor scalars of one update (``_update_count`` has run
        for ``index``)."""
        clip = self.clip_gradient
        return {"lr": self._get_lr(index), "wd": self._get_wd(index),
                "rescale": self.rescale_grad,
                "clip": float(clip) if clip else 0.0}

    def tensor_step(self, w, g, state, h):
        """The pure update rule ``(w, g, state, h) -> (w', state')`` on
        tensors, for optimizers that no nd update op computes."""
        raise NotImplementedError

    def _step(self, weight: NDArray, grad: NDArray, state, h) -> None:
        """Apply one update, rebinding ``weight`` and the state arrays."""
        with torch.no_grad():
            new_w, new_state = self.tensor_step(
                weight._data, grad._data, _state_tensors(state), h)
        weight._set_data(new_w)
        _state_rebind(state, new_state)

    def update(self, index, weight: NDArray, grad: NDArray, state) -> None:
        self._update_count(index)
        self._step(weight, grad, state, self.fused_hypers(index))

    def update_multi_precision(self, index, weight: NDArray, grad,
                               state) -> None:
        if self.multi_precision and weight.dtype == _np.float16:
            master, sub = state
            self.update(index, master, grad.astype("float32"), sub)
            weight._set_data(master._data.to(torch.float16))
        else:
            self.update(index, weight, grad, state)

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.lr})"


def _zeros_like(weight):
    return nd_zeros(weight.shape, weight.context, weight.dtype)


@register
class SGD(Optimizer):
    """SGD with momentum and weight decay (ref: optimizer.py:452), through
    ``nd.sgd_update`` / ``nd.sgd_mom_update``."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return _zeros_like(weight) if self.momentum != 0.0 else None

    def fused_hypers(self, index):
        h = super().fused_hypers(index)
        h["mom"] = self.momentum
        return h

    def tensor_step(self, w, g, state, h):
        g = _rescale_clip(g, h) + h["wd"] * w
        if state is None:
            return w - h["lr"] * g, None
        mom = h["mom"] * state - h["lr"] * g
        return w + mom, mom

    def _step(self, weight, grad, state, h):
        kw = dict(lr=h["lr"], wd=h["wd"], rescale_grad=h["rescale"],
                  clip_gradient=_clip_arg(h))
        if state is None:
            _ops.sgd_update(weight, grad, **kw)
        else:
            _ops.sgd_mom_update(weight, grad, state, momentum=h["mom"], **kw)


@register
class NAG(SGD):
    """Nesterov accelerated SGD (ref: optimizer.py:NAG), through
    ``nd.nag_mom_update``."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(momentum=momentum, **kwargs)

    def tensor_step(self, w, g, state, h):
        if state is None:
            return SGD.tensor_step(self, w, g, state, h)
        g = _rescale_clip(g, h) + h["wd"] * w
        mom = h["mom"] * state + g
        return w - h["lr"] * (g + h["mom"] * mom), mom

    def _step(self, weight, grad, state, h):
        if state is None:
            return SGD._step(self, weight, grad, state, h)
        _ops.nag_mom_update(weight, grad, state, lr=h["lr"],
                            momentum=h["mom"], wd=h["wd"],
                            rescale_grad=h["rescale"],
                            clip_gradient=_clip_arg(h))


@register
class Signum(Optimizer):
    """signSGD with momentum (ref: optimizer.py:Signum); with momentum
    through ``nd.signum_update``."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return _zeros_like(weight) if self.momentum != 0.0 else None

    def fused_hypers(self, index):
        h = super().fused_hypers(index)
        h["mom"] = self.momentum
        h["wd_lh"] = self.wd_lh
        return h

    def tensor_step(self, w, g, state, h):
        # the reference's momentum-free rule: the sign of g + wd w, with
        # the decoupled wd_lh decay (no nd op computes it)
        g = _rescale_clip(g, h)
        return ((1 - h["lr"] * h["wd_lh"]) * w
                - h["lr"] * torch.sign(g + h["wd"] * w), None)

    def _step(self, weight, grad, state, h):
        if state is None:
            return Optimizer._step(self, weight, grad, state, h)
        _ops.signum_update(weight, grad, state, lr=h["lr"], momentum=h["mom"],
                           wd=h["wd"], rescale_grad=h["rescale"],
                           clip_gradient=_clip_arg(h), wd_lh=h["wd_lh"])


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (ref: optimizer.py:SGLD); the
    noise comes from the weight's device generator."""

    def update(self, index, weight, grad, state):
        from .. import random as _random
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight._data
        with torch.no_grad():
            g = grad._data * self.rescale_grad
            if self.clip_gradient is not None:
                g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
            noise = torch.randn(w.shape, generator=_random.generator(
                w.device), device=w.device, dtype=torch.float32).to(w.dtype)
            new = w - lr / 2 * (g + wd * w) + math.sqrt(lr) * noise
        weight._set_data(new)


@register
class Adam(Optimizer):
    """Adam (ref: optimizer.py:1022), through ``nd.adam_update`` with the
    bias correction folded into the learning rate."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def fused_hypers(self, index):
        h = super().fused_hypers(index)
        h.update(t=float(self._index_update_count[index]),
                 beta1=self.beta1, beta2=self.beta2, eps=self.epsilon)
        return h

    def _step(self, weight, grad, state, h):
        t = h["t"]
        lr_t = h["lr"] * math.sqrt(1.0 - h["beta2"] ** t) \
            / (1.0 - h["beta1"] ** t)
        _ops.adam_update(weight, grad, state[0], state[1], lr=lr_t,
                         beta1=h["beta1"], beta2=h["beta2"],
                         epsilon=h["eps"], wd=h["wd"],
                         rescale_grad=h["rescale"],
                         clip_gradient=_clip_arg(h))


@register
class AdamW(Adam):
    """Adam with decoupled weight decay."""

    def tensor_step(self, w, g, state, h):
        m, v = state
        g = _rescale_clip(g, h)
        b1, b2 = h["beta1"], h["beta2"]
        new_m = b1 * m + (1 - b1) * g
        new_v = b2 * v + (1 - b2) * torch.square(g)
        mhat = new_m / (1 - b1 ** h["t"])
        vhat = new_v / (1 - b2 ** h["t"])
        new_w = w - h["lr"] * (mhat / (torch.sqrt(vhat) + h["eps"])
                               + h["wd"] * w)
        return new_w, (new_m, new_v)

    _step = Optimizer._step


@register
class AdaGrad(Optimizer):
    """(ref: optimizer.py:AdaGrad), through ``nd.adagrad_update``."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def fused_hypers(self, index):
        h = super().fused_hypers(index)
        h["eps"] = self.float_stable_eps
        return h

    def _step(self, weight, grad, state, h):
        _ops.adagrad_update(weight, grad, state, lr=h["lr"],
                            epsilon=h["eps"], wd=h["wd"],
                            rescale_grad=h["rescale"],
                            clip_gradient=_clip_arg(h))


@register
class RMSProp(Optimizer):
    """(ref: optimizer.py:RMSProp), through ``nd.rmsprop_update`` or, when
    centered, ``nd.rmspropalex_update``."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.epsilon = epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        n = _zeros_like(weight)
        if self.centered:
            return (n, _zeros_like(weight), _zeros_like(weight))
        return n

    def fused_hypers(self, index):
        h = super().fused_hypers(index)
        h.update(gamma1=self.gamma1, gamma2=self.gamma2, eps=self.epsilon,
                 clip_weights=(float(self.clip_weights)
                               if self.clip_weights else 0.0))
        return h

    def _step(self, weight, grad, state, h):
        kw = dict(lr=h["lr"], gamma1=h["gamma1"], epsilon=h["eps"],
                  wd=h["wd"], rescale_grad=h["rescale"],
                  clip_gradient=_clip_arg(h), clip_weights=h["clip_weights"])
        if self.centered:
            n, g, delta = state
            _ops.rmspropalex_update(weight, grad, n, g, delta,
                                    gamma2=h["gamma2"], **kw)
        else:
            _ops.rmsprop_update(weight, grad, state, **kw)


@register
class AdaDelta(Optimizer):
    """(ref: optimizer.py:AdaDelta)"""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def fused_hypers(self, index):
        h = super().fused_hypers(index)
        h.update(rho=self.rho, eps=self.epsilon)
        return h

    def tensor_step(self, w, g, state, h):
        g = _rescale_clip(g, h) + h["wd"] * w
        acc_g, acc_d = state
        rho = h["rho"]
        new_acc_g = rho * acc_g + (1 - rho) * torch.square(g)
        delta = (torch.sqrt(acc_d + h["eps"])
                 / torch.sqrt(new_acc_g + h["eps"])) * g
        new_acc_d = rho * acc_d + (1 - rho) * torch.square(delta)
        return w - delta, (new_acc_g, new_acc_d)


@register
class Ftrl(Optimizer):
    """(ref: optimizer.py:Ftrl), through ``nd.ftrl_update``."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))       # z, n

    def fused_hypers(self, index):
        h = super().fused_hypers(index)
        h.update(lamda1=self.lamda1, beta=self.beta)
        return h

    def _step(self, weight, grad, state, h):
        _ops.ftrl_update(weight, grad, state[0], state[1], lr=h["lr"],
                         lamda1=h["lamda1"], beta=h["beta"], wd=h["wd"],
                         rescale_grad=h["rescale"],
                         clip_gradient=_clip_arg(h))


@register
class Adamax(Optimizer):
    """(ref: optimizer.py:Adamax)"""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def fused_hypers(self, index):
        h = super().fused_hypers(index)
        h.update(t=float(self._index_update_count[index]),
                 beta1=self.beta1, beta2=self.beta2)
        return h

    def tensor_step(self, w, g, state, h):
        b1 = h["beta1"]
        lr_t = h["lr"] / (1.0 - b1 ** h["t"])
        g = _rescale_clip(g, h) + h["wd"] * w
        m, u = state
        new_m = b1 * m + (1 - b1) * g
        new_u = torch.maximum(h["beta2"] * u, torch.abs(g))
        return w - lr_t * new_m / (new_u + 1e-8), (new_m, new_u)


@register
class Nadam(Optimizer):
    """(ref: optimizer.py:Nadam); the momentum schedule is host state
    advanced once per tensor per step."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def fused_hypers(self, index):
        h = super().fused_hypers(index)
        t = self._index_update_count[index]
        mom_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (t * self.schedule_decay))
        mom_tp1 = self.beta1 * (1.0 - 0.5 * 0.96
                                ** ((t + 1) * self.schedule_decay))
        self.m_schedule *= mom_t
        h.update(t=float(t), beta1=self.beta1, beta2=self.beta2,
                 eps=self.epsilon, mom_t=mom_t, mom_tp1=mom_tp1,
                 m_schedule=self.m_schedule,
                 m_sched_next=self.m_schedule * mom_tp1)
        return h

    def tensor_step(self, w, g, state, h):
        g = _rescale_clip(g, h) + h["wd"] * w
        m, v = state
        b1, b2 = h["beta1"], h["beta2"]
        g_prime = g / (1.0 - h["m_schedule"])
        new_m = b1 * m + (1 - b1) * g
        new_v = b2 * v + (1 - b2) * torch.square(g)
        m_prime = new_m / (1.0 - h["m_sched_next"])
        v_prime = new_v / (1.0 - b2 ** h["t"])
        m_bar = (1.0 - h["mom_t"]) * g_prime + h["mom_tp1"] * m_prime
        return (w - h["lr"] * m_bar / (torch.sqrt(v_prime) + h["eps"]),
                (new_m, new_v))


@register
class FTML(Optimizer):
    """(ref: optimizer.py:FTML), through ``nd.ftml_update``."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return tuple(_zeros_like(weight) for _ in range(3))    # d, v, z

    def fused_hypers(self, index):
        h = super().fused_hypers(index)
        h.update(t=float(self._index_update_count[index]),
                 beta1=self.beta1, beta2=self.beta2, eps=self.epsilon)
        return h

    def _step(self, weight, grad, state, h):
        d, v, z = state
        _ops.ftml_update(weight, grad, d, v, z, lr=h["lr"], beta1=h["beta1"],
                         beta2=h["beta2"], epsilon=h["eps"], t=h["t"],
                         wd=h["wd"], rescale_grad=h["rescale"],
                         clip_grad=_clip_arg(h))


@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD (ref: optimizer.py:DCASGD)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        return ((None if self.momentum == 0.0 else _zeros_like(weight)),
                weight.copy())                      # the previous weight

    def fused_hypers(self, index):
        h = super().fused_hypers(index)
        h.update(mom=self.momentum, lamda=self.lamda)
        return h

    def tensor_step(self, w, g, state, h):
        mom, prev = state
        g = _rescale_clip(g, h)
        comp = g + h["wd"] * w + h["lamda"] * g * g * (w - prev)
        if mom is not None:
            new_m = h["mom"] * mom - h["lr"] * comp
            upd = new_m
        else:
            new_m = None
            upd = -h["lr"] * comp
        return w + upd, (new_m, w)


@register
class LBSGD(SGD):
    """Large-batch SGD with LARS-style layer-wise scaling
    (ref: optimizer.py:LBSGD)."""

    def __init__(self, momentum=0.0, warmup_strategy="linear",
                 warmup_epochs=5, batch_scale=1, updates_per_epoch=32,
                 begin_epoch=0, num_epochs=60, **kwargs):
        super().__init__(momentum=momentum, **kwargs)
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = batch_scale
        self.updates_per_epoch = updates_per_epoch

    def tensor_step(self, w, g, state, h):
        g = _rescale_clip(g, h)
        wd = h["wd"]
        wnorm = torch.linalg.norm(w)
        gnorm = torch.linalg.norm(g)
        one = torch.ones((), dtype=w.dtype, device=w.device)
        ratio = torch.where(gnorm > 0, wnorm / (gnorm + wd * wnorm + 1e-9),
                            one)
        ratio = torch.where(wnorm > 0, ratio, one)
        lr_t = h["lr"] * torch.clamp(ratio, 0.0, 10.0)
        g = g + wd * w
        if state is not None:
            new_m = h["mom"] * state - lr_t * g
            return w + new_m, new_m
        return w - lr_t * g, None

    _step = Optimizer._step


@register
class LAMB(Optimizer):
    """Layer-wise adaptive moments for large batches."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=1e-3, upper_bound=10.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def fused_hypers(self, index):
        h = super().fused_hypers(index)
        h.update(t=float(self._index_update_count[index]),
                 beta1=self.beta1, beta2=self.beta2, eps=self.epsilon,
                 lower=self.lower_bound, upper=self.upper_bound)
        return h

    def tensor_step(self, w, g, state, h):
        g = _rescale_clip(g, h)
        m, v = state
        b1, b2 = h["beta1"], h["beta2"]
        new_m = b1 * m + (1 - b1) * g
        new_v = b2 * v + (1 - b2) * torch.square(g)
        mhat = new_m / (1 - b1 ** h["t"])
        vhat = new_v / (1 - b2 ** h["t"])
        update = mhat / (torch.sqrt(vhat) + h["eps"]) + h["wd"] * w
        wnorm = torch.linalg.norm(w)
        unorm = torch.linalg.norm(update)
        ratio = torch.where((wnorm > 0) & (unorm > 0),
                            torch.clamp(wnorm, h["lower"], h["upper"])
                            / unorm, torch.ones((), device=w.device))
        return w - h["lr"] * ratio * update, (new_m, new_v)


@register
class Test(Optimizer):
    """Trivial optimizer used by tests (ref: optimizer.py:Test)."""

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def tensor_step(self, w, g, state, h):
        return w - h["rescale"] * g, state


_REG.register(SGD, "sgd")
_REG.register(Adam, "adam")


class Updater:
    """Applies an optimizer by key, creating state lazily (ref:
    optimizer.py get_updater / Updater)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}
        self.states_synced: Dict[Any, bool] = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state_multi_precision(
                index, weight)
            self.states_synced[index] = True
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def update_batch(self, indices, grads, weights, census=False):
        """One step over many tensors, one update each (the reference's
        fused whole-step path is ROADMAP.md A5). Returns None."""
        for index, grad, weight in zip(indices, grads, weights):
            self(index, grad, weight)
        return None

    def get_states(self, dump_optimizer=False):
        st = {k: _states_to_numpy(v) for k, v in self.states.items()}
        if not dump_optimizer:
            return pickle.dumps(st)
        # the parameters are reattached from the live ones on load
        pd, self.optimizer.param_dict = self.optimizer.param_dict, {}
        try:
            return pickle.dumps((st, self.optimizer))
        finally:
            self.optimizer.param_dict = pd

    def set_states(self, states):
        obj = pickle.loads(states)
        if isinstance(obj, tuple):
            states, self.optimizer = obj
        else:
            states = obj
        self.states = {k: _states_from_numpy(v) for k, v in states.items()}
        self.states_synced = {k: False for k in self.states}


def _states_to_numpy(state):
    if state is None:
        return None
    if isinstance(state, NDArray):
        return state.asnumpy()
    if isinstance(state, tuple):
        return tuple(_states_to_numpy(s) for s in state)
    return state


def _states_from_numpy(state):
    if state is None:
        return None
    if isinstance(state, _np.ndarray):
        return nd_array(state)
    if isinstance(state, tuple):
        return tuple(_states_from_numpy(s) for s in state)
    return state


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
