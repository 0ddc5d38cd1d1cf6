"""Random number generation on one explicit ``torch.Generator`` per device.

Counterpart of ``incubator_mxnet_tpu/random.py``. The reference splits one
process-wide JAX key; the port keeps a generator for each device (made on
first use, seeded from the last ``seed()``) and draws every sample on the
device it lands on. The streams are not JAX's threefry streams: the same
seed gives other numbers here, so samples are held to their distributions
(shape, type, moments) and to repeating after a re-seed, never to values.

``generator(ctx)`` hands out the generator of a device: the port's stand-in
for the reference's ``next_key``. ``use_generator(g)`` makes ``g`` the
generator of its device inside a scope, the stand-in for the key the
reference threads through a functional call (``parallel.dp``).

Draws inside a CUDA graph (a captured training step or hybridized forward,
``cuda_graph``) come from a generator of the graph's own, registered with
it. Before each call the step copies into it the state of the generator
the caller names (``step_generator``: a step's ``key``, else the
device's), and after the call copies the advanced state back. So a replay
advances the caller's generator as the eager call would, ``seed()`` or
``set_state()`` after the capture reach the replays, and a generator is a
value, as the reference's key is: any number of them share one graph.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Optional

import torch

__all__ = ["seed", "generator", "use_generator", "step_generator",
           "get_state", "set_state",
           "uniform", "normal", "randn", "randint", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial",
           "multinomial", "shuffle", "bernoulli", "sample_uniform",
           "sample_normal", "sample_gamma", "sample_exponential",
           "sample_poisson", "sample_negative_binomial",
           "sample_generalized_negative_binomial", "sample_multinomial"]

_lock = threading.Lock()
_generators: Dict[str, torch.Generator] = {}
_seed_for_new = 0                      # seeds generators made from now on
_override = threading.local()          # device -> generator, per thread


def _device_of(ctx) -> torch.device:
    from .context import Context, current_context
    if ctx is None:
        return current_context().torch_device
    if isinstance(ctx, Context):
        return ctx.torch_device
    return torch.device(ctx)


def generator(ctx=None) -> torch.Generator:
    """The generator of ``ctx``'s device (a Context, a torch device, or
    None for the current context)."""
    dev = _device_of(ctx)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = str(dev)
    scoped = getattr(_override, "map", None)
    if scoped and key in scoped:
        return scoped[key]
    with _lock:
        g = _generators.get(key)
        if g is None:
            g = torch.Generator(device=dev)
            g.manual_seed(_seed_for_new)
            _generators[key] = g
    return g


@contextlib.contextmanager
def use_generator(g: torch.Generator):
    """Inside the scope, draws on ``g``'s device (in this thread) come from
    ``g``."""
    dev = g.device
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    prev = getattr(_override, "map", None)
    _override.map = {**(prev or {}), str(dev): g}
    try:
        yield g
    finally:
        _override.map = prev


def step_generator(key, device) -> torch.Generator:
    """The generator a step on ``device`` draws from: ``key`` when it is
    one (the reference's explicit key), else the device's
    (:func:`generator`, a ``use_generator`` scope included)."""
    if key is None:
        return generator(device)
    if not isinstance(key, torch.Generator):
        raise TypeError(f"a step's key is a torch.Generator or None, not "
                        f"{type(key).__name__}")
    if key.device.type != torch.device(device).type:
        raise ValueError(f"a step on {device} takes a generator of its "
                         f"device, not one on {key.device}")
    return key


def seed(seed_state: int, ctx=None) -> None:
    """Restart the random streams from ``seed_state``: every device's
    (those made later too) with ``ctx=None``, else only ``ctx``'s."""
    global _seed_for_new
    s = int(seed_state)
    if ctx is not None:
        generator(ctx).manual_seed(s)
        return
    with _lock:
        _seed_for_new = s
        for g in _generators.values():
            g.manual_seed(s)


def get_state(ctx=None):
    """The generator state of ``ctx``'s device, without advancing it."""
    return generator(ctx).get_state()


def set_state(state, ctx=None) -> None:
    """Restore a state taken by :func:`get_state`."""
    generator(ctx).set_state(state)


def _dtype(dtype, default=torch.float32):
    from .ndarray.ndarray import to_torch_dtype
    return to_torch_dtype(dtype) or default


def _shape(shape):
    if shape is None:
        return ()
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _maybe_out(res, out):
    if out is not None:
        out._set_data(res._data)
        return out
    return res


def _standard_gamma(alpha: torch.Tensor, g: torch.Generator):
    """Gamma(alpha, 1) draws of alpha's shape (Marsaglia and Tsang; alpha <
    1 boosted through Gamma(alpha + 1) * U^(1 / alpha)), from ``g``."""
    dev = alpha.device
    boost = alpha < 1
    a = torch.where(boost, alpha + 1, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros_like(alpha)
    todo = torch.ones_like(alpha, dtype=torch.bool)
    while bool(todo.any()):
        x = torch.randn(alpha.shape, generator=g, device=dev)
        v = (1 + c * x) ** 3
        u = torch.rand(alpha.shape, generator=g, device=dev)
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp(v, min=1e-30)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    u = torch.rand(alpha.shape, generator=g, device=dev)
    return torch.where(boost, out * u ** (1.0 / alpha), out)


def _sample(draw, shape, ctx, dtype):
    """``draw(generator, shape, device)`` in float32, cast to ``dtype``."""
    from .ndarray.ndarray import _wrap
    dev = _device_of(ctx)
    val = draw(generator(dev), _shape(shape), dev)
    return _wrap(val.to(_dtype(dtype)))


def uniform(low=0.0, high=1.0, shape=None, dtype=None, ctx=None, out=None,
            **kw):
    res = _sample(lambda g, s, d: low + (high - low) * torch.rand(
        s, generator=g, device=d), shape, ctx, dtype)
    return _maybe_out(res, out)


def normal(loc=0.0, scale=1.0, shape=None, dtype=None, ctx=None, out=None,
           **kw):
    res = _sample(lambda g, s, d: loc + scale * torch.randn(
        s, generator=g, device=d), shape, ctx, dtype)
    return _maybe_out(res, out)


def randn(*shape, loc=0.0, scale=1.0, dtype=None, ctx=None, **kw):
    return normal(loc, scale, shape or (1,), dtype, ctx)


def randint(low, high=None, shape=None, dtype="int32", ctx=None, out=None,
            **kw):
    if high is None:
        low, high = 0, low
    res = _sample(lambda g, s, d: torch.randint(
        int(low), int(high), s, generator=g, device=d), shape, ctx,
        dtype or "int32")
    return _maybe_out(res, out)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype=None, ctx=None, out=None,
          **kw):
    res = _sample(lambda g, s, d: _standard_gamma(
        torch.full(s, float(alpha), device=d), g) * beta, shape, ctx, dtype)
    return _maybe_out(res, out)


def exponential(scale=1.0, shape=None, dtype=None, ctx=None, out=None,
                **kw):
    res = _sample(lambda g, s, d: torch.empty(s, device=d).exponential_(
        1.0, generator=g) * scale, shape, ctx, dtype)
    return _maybe_out(res, out)


def poisson(lam=1.0, shape=None, dtype=None, ctx=None, out=None, **kw):
    res = _sample(lambda g, s, d: torch.poisson(
        torch.full(s, float(lam), device=d), generator=g), shape, ctx, dtype)
    return _maybe_out(res, out)


def negative_binomial(k=1, p=1.0, shape=None, dtype=None, ctx=None, out=None,
                      **kw):
    """NB(k, p) sampled as Poisson(Gamma(k, (1 - p) / p))."""
    def draw(g, s, d):
        lam = _standard_gamma(torch.full(s, float(k), device=d), g) \
            * ((1.0 - p) / p)
        return torch.poisson(lam, generator=g)
    return _maybe_out(_sample(draw, shape, ctx, dtype), out)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None, dtype=None,
                                  ctx=None, out=None, **kw):
    def draw(g, s, d):
        if alpha == 0:
            return torch.poisson(torch.full(s, float(mu), device=d),
                                 generator=g)
        lam = _standard_gamma(torch.full(s, 1.0 / alpha, device=d), g) \
            * (mu * alpha)
        return torch.poisson(lam, generator=g)
    return _maybe_out(_sample(draw, shape, ctx, dtype), out)


def multinomial(data, shape=None, get_prob=False, dtype="int32", **kw):
    """Category indices drawn from probability rows ``data`` (..., K)."""
    from .ndarray.ndarray import NDArray, _wrap, array
    probs = data._data if isinstance(data, NDArray) else array(data)._data
    shape_t = None if shape is None else _shape(shape)
    n = 1 if shape_t is None else math.prod(int(d) for d in shape_t)
    p2 = torch.clamp(probs.float(), min=1e-37).reshape(-1, probs.shape[-1])
    samp = torch.multinomial(p2, n, replacement=True,
                             generator=generator(probs.device))
    lead = tuple(probs.shape[:-1])
    if shape_t is None:
        samp = samp[:, 0].reshape(lead)
    else:
        samp = samp.reshape(lead + shape_t)
    out_nd = _wrap(samp.to(_dtype(dtype, torch.int32)))
    if get_prob:
        logp = torch.log_softmax(torch.log(p2), dim=-1).reshape(
            probs.shape)
        lp = torch.gather(logp, -1, samp.reshape(lead + (-1,)))
        return out_nd, _wrap(lp.reshape(samp.shape))
    return out_nd


def bernoulli(p=0.5, shape=None, dtype=None, ctx=None, **kw):
    return _sample(lambda g, s, d: torch.rand(s, generator=g, device=d) < p,
                   shape, ctx, dtype)


def shuffle(data, **kw):
    """A random permutation along axis 0."""
    from .ndarray.ndarray import NDArray, _wrap, array
    arr = data._data if isinstance(data, NDArray) else array(data)._data
    perm = torch.randperm(arr.shape[0], generator=generator(arr.device),
                          device=arr.device)
    return _wrap(arr[perm])


# -- tensor-parametrized samplers: element i of the parameter tensors
#    parametrizes `shape` draws; the output is params.shape + shape -------

def _multisample(draw, params, shape, dtype, out=None):
    from .ndarray.ndarray import NDArray, _wrap, array
    vals = [(p._data if isinstance(p, NDArray) else array(p)._data).float()
            for p in params]
    base = tuple(vals[0].shape)
    shape = _shape(shape)
    full = base + shape
    expanded = [v.reshape(base + (1,) * len(shape)).expand(full)
                for v in vals]
    drawn = draw(generator(vals[0].device), full, vals[0].device, *expanded)
    res = _wrap(drawn.to(_dtype(dtype)))
    return _maybe_out(res, out)


def sample_uniform(low, high, shape=None, dtype=None, out=None, **kw):
    return _multisample(
        lambda g, s, d, lo, hi: lo + (hi - lo) * torch.rand(
            s, generator=g, device=d), [low, high], shape, dtype, out)


def sample_normal(mu, sigma, shape=None, dtype=None, out=None, **kw):
    return _multisample(
        lambda g, s, d, m, sd: m + sd * torch.randn(s, generator=g, device=d),
        [mu, sigma], shape, dtype, out)


def sample_gamma(alpha, beta, shape=None, dtype=None, out=None, **kw):
    return _multisample(
        lambda g, s, d, a, b: _standard_gamma(a.contiguous(), g) * b,
        [alpha, beta], shape, dtype, out)


def sample_exponential(lam, shape=None, dtype=None, out=None, **kw):
    return _multisample(
        lambda g, s, d, l: torch.empty(s, device=d).exponential_(
            1.0, generator=g) / l, [lam], shape, dtype, out)


def sample_poisson(lam, shape=None, dtype=None, out=None, **kw):
    return _multisample(
        lambda g, s, d, l: torch.poisson(l.contiguous(), generator=g),
        [lam], shape, dtype, out)


def sample_negative_binomial(k, p, shape=None, dtype=None, out=None, **kw):
    def draw(g, s, d, kk, pp):
        lam = _standard_gamma(kk.contiguous(), g) * (1 - pp) / pp
        return torch.poisson(lam, generator=g)
    return _multisample(draw, [k, p], shape, dtype, out)


def sample_generalized_negative_binomial(mu, alpha, shape=None, dtype=None,
                                         out=None, **kw):
    def draw(g, s, d, m, a):
        lam = _standard_gamma((1.0 / a).contiguous(), g) * a * m
        return torch.poisson(lam, generator=g)
    return _multisample(draw, [mu, alpha], shape, dtype, out)


def sample_multinomial(data, shape=None, get_prob=False, dtype="int32",
                       **kw):
    """Per-row categorical draws."""
    return multinomial(data, shape=shape, get_prob=get_prob, dtype=dtype)
