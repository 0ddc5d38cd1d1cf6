"""The transformer LM of ``models/transformer.py`` written as an ``nd`` +
``autograd`` user writes it: ``nd.Embedding``, ``nd.LayerNorm``,
``nd.dot`` / ``nd.FullyConnected``, ``nd.batch_dot`` with a causal mask,
``nd.softmax``, ``nd.log_softmax`` + ``nd.pick``, and ``nd.adam_update``.

It computes the same function as ``transformer_forward`` with plain
attention (``use_flash_attention=False``) and the explicit-logits
cross-entropy: pre-LN blocks, tanh GELU, a weight-tied head, mean token
cross-entropy. So its loss and gradients can be held against
``transformer_loss_and_grads`` (an independent code path), and its Adam
steps against the same loop run through another ``nd`` implementation:
every function takes the framework module ``mx`` (``nd`` and ``autograd``
are all it touches) and defaults to this package.

Parameters come in ``transformer_forward``'s layout as numpy arrays; the
``nd`` copy keeps each MLP weight in ``FullyConnected``'s (out, in)
layout, and :func:`grads_to_tree` maps gradients back.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["params_to_nd", "grads_to_tree", "nd_lm_loss",
           "nd_lm_train_step", "causal_mask"]

_FC_KEYS = ("w1", "w2")      # stored transposed for FullyConnected
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def _default_mx(mx):
    if mx is None:
        import incubator_mxnet_tpu_torch as mx
    return mx


def _leaf_names(tree) -> List[str]:
    names = ["embed", "pos_embed", "final_ln_g", "final_ln_b"]
    for i, lp in enumerate(tree["layers"]):
        names += [f"layers.{i}.{k}" for k in sorted(lp)]
    return names


def _get(tree, name):
    if name.startswith("layers."):
        _, i, k = name.split(".")
        return tree["layers"][int(i)][k]
    return tree[name]


def params_to_nd(tree, mx=None, ctx=None) -> Dict[str, object]:
    """{leaf name: NDArray with a gradient buffer} from a parameter tree of
    numpy arrays (``transformer_forward``'s layout), on ``ctx``."""
    mx = _default_mx(mx)
    out = {}
    for name in _leaf_names(tree):
        a = np.asarray(_get(tree, name))
        if name.rsplit(".", 1)[-1] in _FC_KEYS:
            a = np.ascontiguousarray(a.T)
        arr = mx.nd.array(a, ctx=ctx, dtype=a.dtype)
        arr.attach_grad()
        out[name] = arr
    return out


def grads_to_tree(params) -> Dict[str, np.ndarray]:
    """{leaf name: gradient as numpy} in ``transformer_forward``'s layout
    (MLP weights transposed back)."""
    out = {}
    for name, arr in params.items():
        g = arr.grad.asnumpy()
        out[name] = g.T if name.rsplit(".", 1)[-1] in _FC_KEYS else g
    return out


def causal_mask(T: int, mx=None, ctx=None):
    """(T, T) additive mask: 0 on and below the diagonal, -1e30 above."""
    mx = _default_mx(mx)
    m = np.triu(np.full((T, T), -1e30, dtype=np.float32), k=1)
    return mx.nd.array(m, ctx=ctx)


def _gelu_tanh(nd, x):
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + nd.tanh(c * (x + 0.044715 * x * x * x)))


def nd_lm_loss(params, tokens, labels, n_heads: int, mask, mx=None):
    """Mean token cross-entropy of the LM on ``tokens`` (B, T) against
    ``labels`` (B, T) (int NDArrays), with the (T, T) additive ``mask``.
    Record it under ``autograd.record()`` to differentiate."""
    mx = _default_mx(mx)
    nd = mx.nd
    B, T = tokens.shape
    V, d = params["embed"].shape
    H = n_heads
    D = d // H
    scale = 1.0 / math.sqrt(D)
    n_layers = len({k.split(".")[1] for k in params if k.startswith("layers.")})

    def heads(t):                      # (B, T, d) -> (B * H, T, D)
        return t.reshape((B, T, H, D)).transpose((0, 2, 1, 3)).reshape(
            (B * H, T, D))

    x = nd.Embedding(tokens, params["embed"]) + params["pos_embed"][:T]
    for i in range(n_layers):
        p = {k.split(".")[2]: v for k, v in params.items()
             if k.startswith(f"layers.{i}.")}
        h = nd.LayerNorm(x, p["ln1_g"], p["ln1_b"])
        q, k, v = (heads(nd.dot(h, p[w])) for w in ("wq", "wk", "wv"))
        s = nd.batch_dot(q, k, transpose_b=True) * scale + mask
        a = nd.batch_dot(nd.softmax(s), v)
        a = a.reshape((B, H, T, D)).transpose((0, 2, 1, 3)).reshape((B, T, d))
        x = x + nd.dot(a, p["wo"])
        h = nd.LayerNorm(x, p["ln2_g"], p["ln2_b"])
        m = nd.FullyConnected(h, p["w1"], p["b1"], num_hidden=p["w1"].shape[0],
                              flatten=False)
        m = _gelu_tanh(nd, m)
        x = x + nd.FullyConnected(m, p["w2"], p["b2"], num_hidden=d,
                                  flatten=False)
    x = nd.LayerNorm(x, params["final_ln_g"], params["final_ln_b"])
    logits = nd.dot(x.reshape((B * T, d)), params["embed"], transpose_b=True)
    nll = -nd.pick(nd.log_softmax(logits), labels.reshape((B * T,)))
    return nll.mean()


def nd_lm_train_step(params, states, step: int, tokens, labels,
                     n_heads: int, mask, lr: float = 1e-3,
                     mx=None) -> Tuple[object, Dict[str, tuple]]:
    """One Adam step (b1 0.9, b2 0.999, eps 1e-8) of the LM through
    ``nd.adam_update``, the bias correction folded into the rate as the
    update op expects; ``states`` maps each leaf to its (mean, var)
    NDArrays (made at zero on the first step), ``step`` counts from 1.
    Returns (the loss before the step, states)."""
    mx = _default_mx(mx)
    nd = mx.nd
    with mx.autograd.record():
        loss = nd_lm_loss(params, tokens, labels, n_heads, mask, mx=mx)
    loss.backward()
    lr_t = lr * math.sqrt(1.0 - _B2 ** step) / (1.0 - _B1 ** step)
    for name, w in params.items():
        if name not in states:
            states[name] = (w.zeros_like(), w.zeros_like())
        m, v = states[name]
        nd.adam_update(w, w.grad, m, v, lr=lr_t, beta1=_B1, beta2=_B2,
                       epsilon=_EPS)
    return loss, states
