"""The slice as a whole on the CPU: an ``nd`` + ``autograd`` user loop over
the transformer LM (``models/nd_lm.py``: ``nd.Embedding``,
``nd.LayerNorm``, ``nd.dot`` / ``nd.FullyConnected``, ``nd.batch_dot``
with a causal mask, ``nd.softmax``, ``nd.log_softmax`` + ``nd.pick``,
``nd.adam_update``) at 2 layers, d 64, 4 heads, T 16, vocab 97.

The same loop runs through the JAX package's ``nd`` (the module is handed
in as ``mx``) and the port's, from the same numpy weights: three Adam
steps, losses within rtol 1e-4 and every parameter within 1e-4 of its
largest entry. One case runs the JAX side with ``MXTPU_PALLAS=ln,softmax``
so that its Pallas kernels, in interpret mode, are the reference. A third
check holds the port's nd loss and gradients to its functional
``transformer_loss_and_grads`` (plain attention), the comparison
``chip_smoke.py`` makes at full width on the card.
"""
import numpy as np
import pytest

import jax
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.models import nd_lm
from incubator_mxnet_tpu_torch.models import transformer as tt
from incubator_mxnet_tpu_torch.ops.cuda import common

B, T, V, D, H, FF, L = 2, 16, 97, 64, 4, 256, 2


def _cfg():
    return tt.TransformerConfig(vocab_size=V, d_model=D, n_heads=H, d_ff=FF,
                                n_layers=L, max_len=T, dtype=torch.float32,
                                causal=True, use_flash_attention=False)


def _weights(seed=0):
    """A parameter tree of numpy arrays; norms and biases perturbed so
    their gradients are not trivially shaped."""
    g = torch.Generator().manual_seed(seed)
    tree = tt._tree_map(lambda t: t.numpy().copy(),
                        tt.init_transformer_params(g, _cfg(), device="cpu"))
    rs = np.random.RandomState(seed)
    for lp in tree["layers"]:
        for k in ("ln1_g", "ln2_g", "ln1_b", "ln2_b", "b1", "b2"):
            lp[k] = lp[k] + 0.1 * rs.standard_normal(lp[k].shape).astype(
                np.float32)
    return tree


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, V, (B, T)).astype(np.int32),
            rs.randint(0, V, (B, T)).astype(np.int32))


def _train(mx, tree, tokens, labels, steps=3):
    ctx = mx.cpu()
    params = nd_lm.params_to_nd(tree, mx=mx, ctx=ctx)
    tok, lab = mx.nd.array(tokens, ctx=ctx), mx.nd.array(labels, ctx=ctx)
    mask = nd_lm.causal_mask(T, mx=mx, ctx=ctx)
    states, losses = {}, []
    for step in range(1, steps + 1):
        loss, states = nd_lm.nd_lm_train_step(params, states, step, tok, lab,
                                              H, mask, mx=mx)
        losses.append(float(loss.asscalar()))
    return losses, {k: v.asnumpy() for k, v in params.items()}


@pytest.mark.parametrize("pallas", [None, "ln,softmax"])
def test_three_adam_steps_match_jax(pallas, monkeypatch):
    if pallas is None:
        monkeypatch.delenv("MXTPU_PALLAS", raising=False)
    else:
        monkeypatch.setenv("MXTPU_PALLAS", pallas)
    tree = _weights()
    tokens, labels = _batch()
    with jax.default_matmul_precision("highest"):
        jl, jp = _train(jmx, tree, tokens, labels)
    common.reset_launch_counts()
    with tmx.cpu():
        tl, tp = _train(tmx, tree, tokens, labels)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    assert sorted(tp) == sorted(jp) and len(tp) == 4 + 12 * L
    for k in jp:
        scale = np.abs(jp[k]).max()
        assert np.abs(tp[k] - jp[k]).max() <= 1e-4 * scale, k
    # the CPU ran the twins: no kernel was launched
    assert set(common.launch_counts().values()) == {0}


def test_nd_loss_and_gradients_match_the_functional_model():
    tree = _weights(1)
    tokens, labels = _batch(1)
    params = tt._tree_map(torch.from_numpy, tree)
    loss_f, grads_f = tt.transformer_loss_and_grads(
        params, torch.from_numpy(tokens), torch.from_numpy(labels), _cfg())
    with tmx.cpu():
        p = nd_lm.params_to_nd(tree)
        with tmx.autograd.record():
            loss = nd_lm.nd_lm_loss(p, tmx.nd.array(tokens),
                                    tmx.nd.array(labels), H,
                                    nd_lm.causal_mask(T))
        loss.backward()
    np.testing.assert_allclose(loss.asscalar(), loss_f.item(), rtol=1e-5)
    grads = nd_lm.grads_to_tree(p)
    for name, g in grads.items():
        ref = nd_lm._get(grads_f, name).numpy()
        assert np.abs(g - ref).max() <= 1e-5 * np.abs(ref).max(), name
