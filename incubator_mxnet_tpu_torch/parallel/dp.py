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

The reference jits that step and donates its state. Here the step owns
static buffers for the parameters, aux values, optimizer state, ``lr`` (a
0-d float32 tensor, so a new rate changes no program) and, for each
(x, y shapes and types) key, x, y and a generator: the reference retraces
on a new shape, the port makes a new entry. ``key`` is a value, as the
reference's traced key is: a call copies the state of the generator it
names (the device's when None) into the entry's generator, draws from
that, and copies the advanced state back, so any number of generators
share one entry. A call copies each argument that is not already its
static tensor in, runs the update on the static buffers, and writes the
new values back into them. On the card each key's
step is captured as a CUDA graph (``cuda_graph``): its first call is a
real step run eagerly on the capture stream, the capture that follows
executes nothing, and later calls replay (the first capture on a device
empties the allocator's cache once: ``cuda_graph.capture_stream``).
``unroll_steps`` > 1 puts that many updates into one graph (the
reference's ``lax.scan``; x and y carry a leading axis and the mean loss
is returned). On the CPU the same body runs eagerly on the same buffers
at every call; the device of the parameters decides, never whether a
card is present.

``remat`` (or ``MXTPU_REMAT`` when the caller passes None) names one of
:data:`REMAT_POLICIES` or passes a policy callable; the forward then runs
under ``torch.utils.checkpoint`` with that policy, cut into segments
(``remat``), and BatchNorm runs its plain composition, as in the
reference.

On a mesh (``mesh=``, or the current mesh when None, as in the
reference) the step is a per-rank program over static buffers of this
rank's shards: parameters and optimizer state cut by ``param_spec``
(default replicated, pure data parallelism; ``P("fsdp")`` ZeRO-3),
gathered whole for the forward (their backward a reduce-scatter), the
global x and y cut to this rank's block over ``data_axes``, BatchNorm's
batch statistics taken over the whole split batch
(``collectives.synced_moments`` through ``ops.nn.bn_impl_override``), the
loss averaged over ``data_axes`` and
the gradients summed over the axes each parameter is replicated on. A
mesh step is not captured as a CUDA graph (gloo collectives cannot be
captured); asking for it raises.

The exported train step (``export_train_step``) is ROADMAP.md A11 and
raises.
"""
from __future__ import annotations

import contextlib
import functools
import os
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import autograd
from .. import cuda_graph as _graphs
from .. import random as _random
from .. import remat as _remat
from ..autograd import _functional_trace
from ..gluon.block import Block
from ..gluon.parameter import parameter_substitution
from ..ndarray.ndarray import NDArray, _wrap
from ..ops.nn import bn_impl_override
from ..remat import REMAT_POLICIES, resolve as _resolve_remat_policy
from . import collectives as C
from .mesh import P, _as_axes, _block, _gather_blocks, _need_mesh, get_mesh

__all__ = ["functional_call", "DataParallelTrainer", "make_train_step",
           "export_train_step", "REMAT_POLICIES"]


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
                    remat=None, _capture: Optional[bool] = None):
    """Build (step_fn, params, aux_params, opt_state) on the net's device.

    ``step(params, aux_params, opt_state, x, y, key=None, lr=None) ->
    (params, aux_params, opt_state, loss)``; ``key`` is a
    ``torch.Generator`` of the step's device for the forward's draws
    (None: the device's, see ``random.step_generator``), taken as a value
    and advanced as an eager step advances it; ``lr`` None means
    ``learning_rate``.
    Parameters, optimizer state and the loss are float32 whatever
    ``compute_dtype`` (a torch dtype, e.g. ``torch.bfloat16``) the forward
    and backward run in; the returned aux values carry the forward's
    BatchNorm running-stat updates in their own type.

    The step works on static buffers it owns (the module docstring). With
    ``donate`` (the default, as in the reference) it returns those buffers
    themselves, and so does this function: passing back what the last call
    returned copies nothing, and the next call overwrites it. With
    ``donate=False`` both return detached copies and the caller's tensors
    stay as they were. The loss is a new tensor at every call. ``remat``
    names a rematerialisation policy (:data:`REMAT_POLICIES`; a callable is
    taken as it is; ``MXTPU_REMAT`` when None; an unknown name raises
    ``ValueError``; the ``remat`` module says how the forward is cut).
    ``_capture=False`` keeps the body eager on the card: the yardstick the
    captured step is measured against, not a knob. The first captured step
    on a device empties the allocator's cache once
    (``cuda_graph.capture_stream``). On a mesh (the module's note) the
    returned parameters and state are this rank's shards, x and y stay
    global, and the loss is the global one."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is not None:
        mesh = _need_mesh(mesh)
        if _capture:
            raise ValueError(
                "make_train_step: a mesh step is not captured as a CUDA "
                "graph (gloo collectives cannot be captured; capturing an "
                "NCCL mesh step is later work): leave _capture unset")
        pspec = param_spec if param_spec is not None else P()
        axes = _as_axes(data_axes)
    elif param_spec is not None:
        raise ValueError("make_train_step: param_spec needs a mesh")
    capture = mesh is None if _capture is None else _capture
    if remat is None and os.environ.get("MXTPU_REMAT"):
        remat = os.environ["MXTPU_REMAT"]
    policy = _resolve_remat_policy(remat)
    segmented = policy is not None and _remat.has_segments(net)
    all_params = net.collect_params()
    trainable = {n: p for n, p in all_params.items() if p.grad_req != "null"}
    aux = {n: p for n, p in all_params.items() if p.grad_req == "null"}
    params0 = {n: p.data()._data.detach().clone()
               for n, p in trainable.items()}
    aux0 = {n: p.data()._data.detach().clone() for n, p in aux.items()}
    if mesh is not None:
        params0 = {n: _block(v, pspec, mesh).to(mesh.device).contiguous()
                   for n, v in params0.items()}
        aux0 = {n: v.to(mesh.device) for n, v in aux0.items()}

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

    # on a mesh, training BN takes the statistics of the whole split batch;
    # under remat it runs as a plain composition so the policy sees its
    # statistics (as the reference does, dp.py:275). Both are plain
    # compositions, so a remat policy sees the synced statistics too.
    bn_impl = None
    if mesh is not None and axes:
        bn_impl = functools.partial(C.synced_moments, axis_name=axes,
                                    mesh=mesh)
    elif policy is not None:
        bn_impl = "plain"

    def loss_of(leaves, aux_params, x, y, key):
        merged = {n: _to_compute(v) for n, v in leaves.items()}
        merged.update({n: _to_compute(v) for n, v in aux_params.items()})
        with (bn_impl_override(bn_impl) if bn_impl is not None
              else contextlib.nullcontext()):
            return _forward_loss(net, loss_fn, merged, _to_compute(x), y,
                                 key, capture_updates=list(aux_params))

    def forward_loss(leaves, aux_params, x, y, key):
        if policy is None:
            return loss_of(leaves, aux_params, x, y, key)
        if segmented:
            with _remat.segments(policy):
                return loss_of(leaves, aux_params, x, y, key)
        return _remat.checkpointed(policy, loss_of, leaves, aux_params, x,
                                   y, key)

    def one_step(params, aux_params, opt_state, x, y, key, lr):
        names = list(params)
        leaves = {n: params[n].detach().requires_grad_(True) for n in names}
        seed = None
        with torch.enable_grad():
            if mesh is None:
                loss, new_aux = forward_loss(leaves, aux_params, x, y, key)
            else:
                whole = dict(zip(names, C.all_gather_spec(
                    [leaves[n] for n in names], pspec, mesh)))
                loss, new_aux = forward_loss(
                    whole, aux_params, _block(x, P(axes), mesh),
                    _block(y, P(axes), mesh), key)
                loss = C.pmean(loss, axes, mesh)
                # the loss is replicated on every rank: each seeds a share
                seed = torch.full_like(loss, 1 / mesh.size)
            grads = torch.autograd.grad(loss, [leaves[n] for n in names],
                                        grad_outputs=seed, allow_unused=True)
        grads = [g if g is not None else torch.zeros_like(params[n])
                 for n, g in zip(names, grads)]
        if mesh is not None:
            grads = C.sum_replicas(grads, [pspec] * len(names), mesh)
        grads = dict(zip(names, grads))
        with torch.no_grad():
            new_params, new_state = opt_update(params, grads, opt_state, lr)
        aux_out = dict(aux_params)
        aux_out.update({n: v.detach().to(aux_params[n].dtype)
                        for n, v in new_aux.items()})
        return new_params, aux_out, new_state, loss.detach()

    step = _TrainStep(one_step, params0, aux0, opt_state0, learning_rate,
                      max(1, int(unroll_steps)), donate, capture)
    if donate:
        return step, step.params, step.aux, step.opt_state
    return (step, _clone(step.params), _clone(step.aux),
            _clone(step.opt_state))


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def _pairs(dst, src, out, what):
    """(static tensor, value) pairs of two trees of dicts, by key, where
    the value is not the static tensor itself."""
    if isinstance(dst, (dict, tuple)):
        if type(src) is not type(dst) or len(src) != len(dst) \
                or (isinstance(dst, dict) and src.keys() != dst.keys()):
            raise ValueError(f"the step's {what} do not have the keys it was "
                             "built with")
        for k in (dst if isinstance(dst, dict) else range(len(dst))):
            _pairs(dst[k], src[k], out, what)
    elif src is not dst:
        out.append((dst, src))
    return out


def _copy_pairs(pairs) -> None:
    if pairs:
        with torch.no_grad():
            torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])


class _StepEntry:
    """One key of a :class:`_TrainStep`: the static x and y, the
    generator the forward draws from (its own, which takes the caller's
    state at each call), and the step over them."""

    def __init__(self, x, y, device):
        self.x = torch.empty(x.shape, dtype=x.dtype, device=device)
        self.y = torch.empty(y.shape, dtype=y.dtype, device=device)
        self.gen = torch.Generator(device=device)
        self.step = None


class _TrainStep:
    """The step :func:`make_train_step` returns (its docstring): static
    parameter, aux, optimizer-state and ``lr`` buffers, and one
    :class:`_StepEntry` a key, captured on the card."""

    def __init__(self, one_step, params, aux, opt_state, learning_rate,
                 unroll: int, donate: bool, capture: bool):
        self.params, self.aux, self.opt_state = params, aux, opt_state
        leaf = next(iter({**params, **aux}.values()), None)
        self.device = leaf.device if leaf is not None else torch.device("cpu")
        self._one_step = one_step
        self._unroll = unroll
        self._donate = donate
        self._capture = capture and self.device.type == "cuda"
        self._learning_rate = float(learning_rate)
        self._lr_value = self._learning_rate
        self._lr = torch.full((), self._lr_value, dtype=torch.float32,
                              device=self.device)
        self._entries: Dict[Any, _StepEntry] = {}

    def _cache_size(self) -> int:
        """The number of keys built (the reference's jitted function has
        the same private count)."""
        return len(self._entries)

    def _body(self, entry: _StepEntry):
        def body():
            losses = []
            for i in range(self._unroll):
                x, y = ((entry.x, entry.y) if self._unroll == 1
                        else (entry.x[i], entry.y[i]))
                *new, loss = self._one_step(self.params, self.aux,
                                            self.opt_state, x, y, entry.gen,
                                            self._lr)
                _copy_pairs(_pairs((self.params, self.aux, self.opt_state),
                                   tuple(new), [], "outputs"))
                losses.append(loss)
            return losses[0] if self._unroll == 1 \
                else torch.stack(losses).mean()
        return body

    def _set_lr(self, lr) -> None:
        if torch.is_tensor(lr):
            self._lr.copy_(lr)
            self._lr_value = None
        elif float(lr) != self._lr_value:
            self._lr.fill_(float(lr))
            self._lr_value = float(lr)

    def __call__(self, params, aux_params, opt_state, x, y, key=None,
                 lr=None):
        x = x._data if isinstance(x, NDArray) else x
        y = y._data if isinstance(y, NDArray) else y
        gen = _random.step_generator(key, self.device)
        k = (tuple(x.shape), x.dtype, tuple(y.shape), y.dtype)
        pairs = _pairs((self.params, self.aux, self.opt_state),
                       (params, aux_params, opt_state), [], "arguments")
        entry = self._entries.get(k)
        fresh = entry is None
        if fresh:
            entry = _StepEntry(x, y, self.device)
            entry.step = _graphs.CapturedStep(self._body(entry))
        pairs += _pairs(entry.x, x, [], "x") + _pairs(entry.y, y, [], "y")
        _copy_pairs(pairs)
        self._set_lr(self._learning_rate if lr is None else lr)
        entry.gen.set_state(gen.get_state())
        if fresh and self._capture:
            loss = _graphs.first_call(entry.step, self.device, (entry.gen,),
                                      "make_train_step")
        else:
            loss = entry.step()
            if entry.step.graph is not None:
                loss = loss.clone()
        gen.set_state(entry.gen.get_state())
        self._entries[k] = entry
        if self._donate:
            return self.params, self.aux, self.opt_state, loss
        return (_clone(self.params), _clone(self.aux),
                _clone(self.opt_state), loss)


class DataParallelTrainer:
    """The functional step behind a stateful API (ref analog: Gluon Trainer
    with kvstore 'device'): on one card the captured step of
    :func:`make_train_step`, whose learning rate is a tensor, so
    :meth:`set_learning_rate` captures nothing new; on ``mesh`` (or the
    current mesh) its per-rank step, every rank calling :meth:`step` with
    the global batch."""

    def __init__(self, net: Block, loss_fn, optimizer="sgd",
                 optimizer_params=None, mesh=None, param_spec=None,
                 unroll_steps: int = 1):
        self._mesh = mesh if mesh is not None else get_mesh()
        self._spec = param_spec if param_spec is not None else P()
        optimizer_params = optimizer_params or {}
        self._net = net
        self._lr = float(optimizer_params.get("learning_rate", 0.01))
        self._unroll = max(1, int(unroll_steps))
        self._step_fn, self._params, self._aux, self._opt_state = \
            make_train_step(
                net, loss_fn, optimizer, learning_rate=self._lr,
                momentum=float(optimizer_params.get("momentum", 0.0)),
                wd=float(optimizer_params.get("wd", 0.0)),
                mesh=self._mesh, param_spec=param_spec,
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
        """Write copies of the step's parameters (whole, gathered from the
        ranks on a mesh) and aux values into the net (the step goes on
        updating its own buffers)."""
        with autograd.pause():
            for n, p in self._net.collect_params().items():
                if n in self._params and self._mesh is not None:
                    p.data()._set_data(_gather_blocks(
                        self._params[n], self._spec, self._mesh).to(
                            p.data()._data.device))
                elif n in self._params:
                    p.data()._set_data(self._params[n].clone())
                elif n in self._aux:
                    p.data()._set_data(self._aux[n].clone())


def export_train_step(net: Block, loss_fn: Callable, prefix: str,
                      example_x, example_y, learning_rate: float = 0.1):
    raise NotImplementedError(
        "export_train_step: exported deployment artifacts are ROADMAP.md A11")
