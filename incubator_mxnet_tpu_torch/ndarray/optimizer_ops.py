"""Optimizer update ops at the ``mx.nd.*`` level.

Counterpart of ``incubator_mxnet_tpu/ndarray/optimizer_ops.py`` (ref:
src/operator/optimizer_op.cc): sgd, sgd with momentum, their multi-
precision forms, NAG, FTML, Adam, RMSProp (plain and centered), FTRL,
signSGD, Signum, AdaGrad and group AdaGrad. This is how an ``nd`` user
takes a step without an Optimizer object. Each op computes under
``torch.no_grad`` and, by the reference's ``out=`` convention, rebinds
``weight`` (or ``out``) and the state arrays to the new values; nothing is
written in place. As in the reference's fused op, Adam's bias correction
is folded into ``lr`` by the caller.
"""
from __future__ import annotations

import torch

from .ndarray import _as_nd

__all__ = [
    "sgd_update", "sgd_mom_update", "mp_sgd_update", "mp_sgd_mom_update",
    "nag_mom_update", "mp_nag_mom_update", "ftml_update", "adam_update",
    "rmsprop_update", "rmspropalex_update", "ftrl_update", "signsgd_update",
    "signum_update", "adagrad_update", "group_adagrad_update",
]


def _clip(g, clip_gradient):
    if clip_gradient is not None and clip_gradient >= 0:
        return torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _prep(g, rescale_grad, clip_gradient, wd, w):
    """rescale -> clip -> weight decay."""
    return _clip(g * rescale_grad, clip_gradient) + wd * w


def _apply(fn, inputs, outs):
    """Run ``fn`` on the inputs' tensors under no_grad and rebind each
    NDArray in ``outs`` to its result. Returns the first output."""
    nds = [_as_nd(x) for x in inputs]
    with torch.no_grad():
        res = fn(*[x._data for x in nds])
    res = res if isinstance(res, tuple) else (res,)
    for o, r in zip(outs, res):
        o._set_data(r)
    return outs[0]


# ---------------------------------------------------------------------------
# the update rules on tensors: (w, g, state, hypers) -> (w', state'), no
# NDArray and no rebinding. The ops below and the optimizers' tensor_step
# (optimizer/optimizer.py) both call them, so an nd update op, a
# per-parameter update and the fused step's per-tensor route run the same
# float operations in the same order.
# ---------------------------------------------------------------------------
def sgd_step(w, g, lr, wd, rescale_grad, clip_gradient):
    return w - lr * _prep(g, rescale_grad, clip_gradient, wd, w)


def sgd_mom_step(w, g, m, lr, momentum, wd, rescale_grad, clip_gradient):
    m2 = momentum * m - lr * _prep(g, rescale_grad, clip_gradient, wd, w)
    return w + m2, m2


def nag_mom_step(w, g, m, lr, momentum, wd, rescale_grad, clip_gradient):
    gw = _prep(g, rescale_grad, clip_gradient, wd, w)
    m2 = momentum * m + gw
    return w - lr * (gw + momentum * m2), m2


def adam_step(w, g, state, lr, beta1, beta2, epsilon, wd, rescale_grad,
              clip_gradient):
    m, v = state
    gw = _prep(g, rescale_grad, clip_gradient, wd, w)
    m2 = beta1 * m + (1 - beta1) * gw
    v2 = beta2 * v + (1 - beta2) * gw * gw
    return w - lr * m2 / (torch.sqrt(v2) + epsilon), (m2, v2)


def ftml_step(w, g, state, lr, beta1, beta2, epsilon, t, wd, rescale_grad,
              clip_grad):
    d_, v_, z_ = state
    gw = _prep(g, rescale_grad, clip_grad, wd, w)
    v2 = beta2 * v_ + (1 - beta2) * gw * gw
    d2 = (1 - beta1 ** t) / lr * (
        torch.sqrt(v2 / (1 - beta2 ** t)) + epsilon)
    sigma = d2 - beta1 * d_
    z2 = beta1 * z_ + (1 - beta1) * gw - sigma * w
    return -z2 / d2, (d2, v2, z2)


def rmsprop_step(w, g, n, lr, gamma1, epsilon, wd, rescale_grad,
                 clip_gradient, clip_weights):
    gw = _prep(g, rescale_grad, clip_gradient, wd, w)
    n2 = gamma1 * n + (1 - gamma1) * gw * gw
    w2 = w - lr * gw / torch.sqrt(n2 + epsilon)
    if clip_weights is not None and clip_weights > 0:
        w2 = torch.clamp(w2, -clip_weights, clip_weights)
    return w2, n2


def rmspropalex_step(w, g, state, lr, gamma1, gamma2, epsilon, wd,
                     rescale_grad, clip_gradient, clip_weights):
    n, gm, delta = state
    gw = _prep(g, rescale_grad, clip_gradient, wd, w)
    n2 = gamma1 * n + (1 - gamma1) * gw * gw
    g2 = gamma1 * gm + (1 - gamma1) * gw
    d2 = gamma2 * delta - lr * gw / torch.sqrt(n2 - g2 * g2 + epsilon)
    w2 = w + d2
    if clip_weights is not None and clip_weights > 0:
        w2 = torch.clamp(w2, -clip_weights, clip_weights)
    return w2, (n2, g2, d2)


def ftrl_step(w, g, state, lr, lamda1, beta, wd, rescale_grad,
              clip_gradient):
    z, n = state
    gw = _clip(g * rescale_grad, clip_gradient)
    n2 = n + gw * gw
    sigma = (torch.sqrt(n2) - torch.sqrt(n)) / lr
    z2 = z + gw - sigma * w
    w2 = torch.where(
        torch.abs(z2) <= lamda1, torch.zeros_like(w),
        -(z2 - torch.sign(z2) * lamda1)
        / ((beta + torch.sqrt(n2)) / lr + wd))
    return w2, (z2, n2)


def signum_step(w, g, m, lr, momentum, wd, rescale_grad, clip_gradient,
                wd_lh):
    gw = _clip(g * rescale_grad, clip_gradient)
    m2 = momentum * m - (1 - momentum) * (gw + wd * w)
    return (1 - lr * wd_lh) * w + lr * torch.sign(m2), m2


def adagrad_step(w, g, h, lr, epsilon, wd, rescale_grad, clip_gradient):
    gw = _prep(g, rescale_grad, clip_gradient, wd, w)
    h2 = h + gw * gw
    return w - lr * gw / (torch.sqrt(h2) + epsilon), h2


def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True, out=None, **kw):
    """w -= lr * (rescale * clip(grad) + wd * w)."""
    out = weight if out is None else out
    return _apply(lambda w, g: sgd_step(w, g, lr, wd, rescale_grad,
                                        clip_gradient), [weight, grad], [out])


def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True,
                   out=None, **kw):
    """mom = momentum * mom - lr * grad_w; w += mom."""
    out = weight if out is None else out
    return _apply(lambda w, g, m: sgd_mom_step(
        w, g, m, lr, momentum, wd, rescale_grad, clip_gradient),
        [weight, grad, mom], [out, _as_nd(mom)])


def mp_sgd_update(weight, grad, weight32, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True, out=None, **kw):
    """Multi-precision SGD: float32 master weight, low-precision grad and
    weight."""
    out = weight if out is None else out

    def f(w, g, w32):
        nw32 = w32 - lr * _prep(g.float(), rescale_grad, clip_gradient, wd,
                                w32)
        return nw32.to(w.dtype), nw32
    return _apply(f, [weight, grad, weight32], [out, _as_nd(weight32)])


def mp_sgd_mom_update(weight, grad, mom, weight32, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True,
                      out=None, **kw):
    out = weight if out is None else out

    def f(w, g, m, w32):
        m2 = momentum * m - lr * _prep(g.float(), rescale_grad,
                                       clip_gradient, wd, w32)
        nw32 = w32 + m2
        return nw32.to(w.dtype), m2, nw32
    return _apply(f, [weight, grad, mom, weight32],
                  [out, _as_nd(mom), _as_nd(weight32)])


def nag_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, out=None, **kw):
    """Nesterov momentum."""
    out = weight if out is None else out
    return _apply(lambda w, g, m: nag_mom_step(
        w, g, m, lr, momentum, wd, rescale_grad, clip_gradient),
        [weight, grad, mom], [out, _as_nd(mom)])


def mp_nag_mom_update(weight, grad, mom, weight32, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0, out=None, **kw):
    out = weight if out is None else out

    def f(w, g, m, w32):
        gw = _prep(g.float(), rescale_grad, clip_gradient, wd, w32)
        m2 = momentum * m + gw
        nw32 = w32 - lr * (gw + momentum * m2)
        return nw32.to(w.dtype), m2, nw32
    return _apply(f, [weight, grad, mom, weight32],
                  [out, _as_nd(mom), _as_nd(weight32)])


def ftml_update(weight, grad, d, v, z, lr, beta1=0.6, beta2=0.999,
                epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0, clip_grad=-1.0,
                out=None, **kw):
    """FTML (Zheng & Kwok 2017)."""
    out = weight if out is None else out

    def f(w, g, d_, v_, z_):
        nw, (d2, v2, z2) = ftml_step(w, g, (d_, v_, z_), lr, beta1, beta2,
                                     epsilon, t, wd, rescale_grad, clip_grad)
        return nw, d2, v2, z2
    return _apply(f, [weight, grad, d, v, z],
                  [out, _as_nd(d), _as_nd(v), _as_nd(z)])


def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True, out=None, **kw):
    """Adam; bias correction is folded into ``lr`` by the caller."""
    out = weight if out is None else out

    def f(w, g, m, v):
        nw, (m2, v2) = adam_step(w, g, (m, v), lr, beta1, beta2, epsilon,
                                 wd, rescale_grad, clip_gradient)
        return nw, m2, v2
    return _apply(f, [weight, grad, mean, var],
                  [out, _as_nd(mean), _as_nd(var)])


def rmsprop_update(weight, grad, n, lr, gamma1=0.95, epsilon=1e-8, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0,
                   out=None, **kw):
    """RMSProp, non-centered."""
    out = weight if out is None else out
    return _apply(lambda w, g, n_: rmsprop_step(
        w, g, n_, lr, gamma1, epsilon, wd, rescale_grad, clip_gradient,
        clip_weights), [weight, grad, n], [out, _as_nd(n)])


def rmspropalex_update(weight, grad, n, g, delta, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0, out=None,
                       **kw):
    """Centered RMSProp with momentum (Graves 2013)."""
    out = weight if out is None else out

    def f(w, gr, n_, g_, delta_):
        w2, (n2, g2, d2) = rmspropalex_step(
            w, gr, (n_, g_, delta_), lr, gamma1, gamma2, epsilon, wd,
            rescale_grad, clip_gradient, clip_weights)
        return w2, n2, g2, d2
    return _apply(f, [weight, grad, n, g, delta],
                  [out, _as_nd(n), _as_nd(g), _as_nd(delta)])


def ftrl_update(weight, grad, z, n, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0, out=None, **kw):
    """FTRL-proximal."""
    out = weight if out is None else out

    def f(w, g, z_, n_):
        w2, (z2, n2) = ftrl_step(w, g, (z_, n_), lr, lamda1, beta, wd,
                                 rescale_grad, clip_gradient)
        return w2, z2, n2
    return _apply(f, [weight, grad, z, n], [out, _as_nd(z), _as_nd(n)])


def signsgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, out=None, **kw):
    """w -= lr * sign(grad), with decoupled weight decay."""
    out = weight if out is None else out

    def f(w, g):
        gw = _clip(g * rescale_grad, clip_gradient)
        return (1 - lr * wd) * w - lr * torch.sign(gw)
    return _apply(f, [weight, grad], [out])


def signum_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0,
                  out=None, **kw):
    """Signum: the sign of the momentum."""
    out = weight if out is None else out
    return _apply(lambda w, g, m: signum_step(
        w, g, m, lr, momentum, wd, rescale_grad, clip_gradient, wd_lh),
        [weight, grad, mom], [out, _as_nd(mom)])


def adagrad_update(weight, grad, history, lr, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, out=None, **kw):
    """AdaGrad (dense form)."""
    out = weight if out is None else out
    return _apply(lambda w, g, h: adagrad_step(
        w, g, h, lr, epsilon, wd, rescale_grad, clip_gradient),
        [weight, grad, history], [out, _as_nd(history)])


def group_adagrad_update(weight, grad, history, lr, rescale_grad=1.0,
                         clip_gradient=-1.0, epsilon=1e-5, out=None, **kw):
    """Group AdaGrad: one accumulator per row."""
    out = weight if out is None else out

    def f(w, g, h):
        gw = _clip(g * rescale_grad, clip_gradient)
        upd = (torch.mean(gw * gw, dim=tuple(range(1, gw.dim())))
               if gw.dim() > 1 else gw * gw)
        h2 = h + upd.reshape(h.shape)
        denom = torch.sqrt(h2).reshape(
            (w.shape[0],) + (1,) * (w.dim() - 1)) + epsilon
        return w - lr * gw / denom, h2
    return _apply(f, [weight, grad, history], [out, _as_nd(history)])
