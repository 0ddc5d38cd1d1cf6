"""The port's single-device training path (``models/transformer.py``,
``parallel/moe.py``) against the JAX package, on the CPU.

Weights cross from JAX with ``params_from_jax`` / ``opt_state_from_jax``;
tokens and labels are made with numpy from a seed. The JAX side runs
under ``jax.default_matmul_precision("highest")``. On the CPU the port's
attention runs the plain twins of its CUDA kernels; the JAX step takes its
plain attention (Pallas runs only on a TPU by default), and the two agree
because T == T (top-left and bottom-right causal masks coincide).
Tolerances: logits atol 1e-4; the tied head rtol 1e-5; losses rtol 1e-4
(bf16 steps 5e-3); gradients rtol 1e-4 with an atol of 1e-4 of the leaf's
largest entry (a relative bound on entries near zero would only measure
summation order).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from incubator_mxnet_tpu.models import transformer as jt
from incubator_mxnet_tpu.parallel import moe as jmoe
from incubator_mxnet_tpu_torch.models import transformer as tt
from incubator_mxnet_tpu_torch.parallel import moe as tmoe

B, T, V = 2, 16, 97


def _cfgs(d_model=128, n_heads=4, n_layers=2, n_experts=0, dtype="f32",
          **kw):
    shape = dict(vocab_size=V, d_model=d_model, n_heads=n_heads,
                 d_ff=2 * d_model, n_layers=n_layers, max_len=32,
                 n_experts=n_experts, **kw)
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (jt.TransformerConfig(dtype=jd, **shape),
            tt.TransformerConfig(dtype=td, **shape))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, V, (B, T)).astype(np.int32),
            rs.randint(0, V, (B, T)).astype(np.int32))


def _carry(jparams, tcfg):
    return tt.params_from_jax(_np_tree(jparams), tcfg, device="cpu")


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _assert_tree_close(got, want, rtol=1e-4):
    gl, wl = _leaves(got), _leaves(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.float().numpy(), b, rtol=rtol,
                                   atol=rtol * float(np.abs(b).max()))


def test_params_from_jax_bf16_bit_exact():
    """JAX bf16 parameters cross to torch bf16 bit for bit; a state taken
    after a JAX step (f32 params, bf16 moments, f32 t) crosses with every
    leaf's type kept."""
    jcfg, tcfg = _cfgs(d_model=32, n_layers=1, dtype="bf16")
    step, jp, jo = jt.make_transformer_train_step(jcfg)
    tp = _carry(jp, tcfg)
    for a, b in zip(_leaves(jp), _leaves(tp)):
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                      np.asarray(a).view(np.int16))
    tokens, labels = _batch()
    jp, jo, _ = step(jp, jo, jnp.asarray(tokens), jnp.asarray(labels))
    tp = _carry(jp, tcfg)
    to = tt.opt_state_from_jax(_np_tree(jo), tcfg, device="cpu")
    for jtree, ttree in ((jp, tp), (jo, to)):
        for a, b in zip(_leaves(jtree), _leaves(ttree)):
            a = np.asarray(a)
            assert str(b.dtype) == f"torch.{a.dtype.name}"
            if a.dtype.name == "bfloat16":
                np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                              a.view(np.int16))
            else:
                np.testing.assert_array_equal(b.numpy(), a)
    cast = tt.params_from_jax(_np_tree(jp), tcfg, device="cpu",
                              dtype=torch.bfloat16)
    assert {t.dtype for t in _leaves(cast)} == {torch.bfloat16}


@pytest.mark.parametrize("d_model,n_experts,flash", [
    (32, 0, True),      # HD % 128 != 0: head-major flash route
    (128, 0, True),     # packed flash route
    (128, 2, True),     # packed, with an MoE layer
    (32, 0, False),     # attention_reference
])
def test_forward_logits_match_jax(d_model, n_experts, flash):
    jcfg, tcfg = _cfgs(d_model=d_model, n_experts=n_experts,
                       use_flash_attention=flash)
    jp = jt.init_transformer_params(jax.random.PRNGKey(1), jcfg)
    tokens, _ = _batch(1)
    with jax.default_matmul_precision("highest"):
        want, want_aux = jax.jit(
            lambda p, x: jt.transformer_forward(p, x, jcfg))(
                jp, jnp.asarray(tokens))
    got, aux = tt.transformer_forward(_carry(jp, tcfg),
                                      torch.from_numpy(tokens).long(), tcfg)
    assert got.shape == (B, T, V) and aux.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-5)


@pytest.mark.parametrize("vocab,nc", [(127, 3), (96, 1), (200, 2)])
def test_tied_head_xent_matches_jax(vocab, nc):
    rs = np.random.RandomState(3)
    h2 = rs.standard_normal((24, 16)).astype(np.float32)
    emb = rs.standard_normal((vocab, 16)).astype(np.float32)
    labels = rs.randint(0, vocab, 24).astype(np.int32)
    with jax.default_matmul_precision("highest"):
        want, want_g = jax.value_and_grad(
            lambda h, e: jt.tied_head_xent(h, e, jnp.asarray(labels), nc),
            argnums=(0, 1))(jnp.asarray(h2), jnp.asarray(emb))
    th = torch.from_numpy(h2).requires_grad_(True)
    te = torch.from_numpy(emb).requires_grad_(True)
    loss = tt.tied_head_xent(th, te, torch.from_numpy(labels).long(), nc)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    for got, w in ((th.grad, want_g[0]), (te.grad, want_g[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-7)


def test_moe_layer_dense_matches_jax():
    rs = np.random.RandomState(4)
    E, d, h, n = 4, 16, 24, 40
    args = [rs.standard_normal(s).astype(np.float32) * 0.5
            for s in ((n, d), (d, E), (E, d, h), (E, h), (E, h, d), (E, d))]
    with jax.default_matmul_precision("highest"):
        want_y, want_aux = jmoe.moe_layer_dense(*map(jnp.asarray, args),
                                                capacity_factor=1.0)
        jc, jd, _ = jmoe.top1_gating(jnp.asarray(args[0] @ args[1]), 10)
    y, aux = tmoe.moe_layer_dense(*map(torch.from_numpy, args),
                                  capacity_factor=1.0)
    tc, td, _ = tmoe.top1_gating(torch.from_numpy(args[0] @ args[1]), 10)
    assert float(jd.sum()) < n        # some tokens overflow their expert
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-6)


def _jax_loss(jcfg, fused):
    def loss_fn(p, tokens, labels):
        if fused:
            h, aux = jt.transformer_forward(p, tokens, jcfg,
                                            return_hidden=True)
            xent = jt.tied_head_xent(
                h.reshape(-1, h.shape[-1]), p["embed"], labels.reshape(-1),
                jt._head_chunk_count(jcfg.vocab_size))
        else:
            logits, aux = jt.transformer_forward(p, tokens, jcfg)
            xent = jt._softmax_xent(logits, labels)
        return xent + 1e-2 * aux
    return loss_fn


@pytest.mark.parametrize("fused_head", [None, "1"])
def test_first_step_loss_and_grads_match_jax(fused_head, monkeypatch):
    """The step's objective and gradient tree (packed route, one MoE
    layer) with ``MXTPU_FUSED_HEAD`` unset and set to 1; the port's step
    reads the variable as the JAX one does (the fused head is taken only
    when it is 1 at these sizes)."""
    if fused_head is None:
        monkeypatch.delenv("MXTPU_FUSED_HEAD", raising=False)
    else:
        monkeypatch.setenv("MXTPU_FUSED_HEAD", fused_head)
    jcfg, tcfg = _cfgs(n_experts=2)
    jp = jt.init_transformer_params(jax.random.PRNGKey(2), jcfg)
    tokens, labels = _batch(2)
    with jax.default_matmul_precision("highest"):
        want, want_g = jax.jit(jax.value_and_grad(
            _jax_loss(jcfg, fused_head)))(jp, jnp.asarray(tokens),
                                           jnp.asarray(labels))
    tp = _carry(jp, tcfg)
    tokens, labels = torch.from_numpy(tokens), torch.from_numpy(labels)
    loss, grads = tt.transformer_loss_and_grads(
        tp, tokens, labels, tcfg, fused_head=fused_head == "1")
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-4)
    assert jax.tree_util.tree_structure(grads) == \
        jax.tree_util.tree_structure(want_g)
    _assert_tree_close(grads, want_g)

    fused_calls = []
    real = tt.tied_head_xent
    monkeypatch.setattr(tt, "tied_head_xent",
                        lambda *a: fused_calls.append(1) or real(*a))
    step, _, opt_state = tt.make_transformer_train_step(tcfg, device="cpu")
    _, _, step_loss = step(tp, opt_state, tokens, labels)
    assert bool(fused_calls) == (fused_head == "1")
    np.testing.assert_allclose(step_loss.item(), float(want), rtol=1e-4)


def test_three_steps_track_jax():
    """Three Adam steps from the same state: the losses agree."""
    jcfg, tcfg = _cfgs(n_experts=2)
    tokens, labels = _batch(5)
    with jax.default_matmul_precision("highest"):
        jstep, jp, jo = jt.make_transformer_train_step(jcfg, seed=3)
        tp = _carry(jp, tcfg)
        to = tt.opt_state_from_jax(_np_tree(jo), tcfg, device="cpu")
        want = []
        for _ in range(3):
            jp, jo, loss = jstep(jp, jo, jnp.asarray(tokens),
                                 jnp.asarray(labels))
            want.append(float(loss))
    tstep, _, _ = tt.make_transformer_train_step(tcfg, device="cpu")
    got = []
    for _ in range(3):
        tp, to, loss = tstep(tp, to, torch.from_numpy(tokens),
                             torch.from_numpy(labels))
        got.append(loss.item())
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("d_model,n_layers,n_experts", [
    (32, 1, 0),      # dense
    (128, 3, 2),     # the MoE layer's float32 output meets bf16 weights
])
def test_bf16_step_promotes_like_jax(d_model, n_layers, n_experts):
    """The reference's Adam multiplies by a float32 rate: bf16 params come
    out float32 after step 1, the moments after step 2; an MoE layer's
    output is float32 already in step 1. From the same state, the port
    keeps every leaf's type in step with JAX, and its losses agree within
    rtol 5e-3, about bf16's unit roundoff (2**-8): step 1 runs in bf16, and
    its products round in another order than XLA's."""
    jcfg, tcfg = _cfgs(d_model=d_model, n_layers=n_layers,
                       n_experts=n_experts, dtype="bf16")
    tokens, labels = _batch(6)
    jstep, jp, jo = jt.make_transformer_train_step(jcfg)
    tstep, _, _ = tt.make_transformer_train_step(tcfg, device="cpu")
    tp = _carry(jp, tcfg)
    to = tt.opt_state_from_jax(_np_tree(jo), tcfg, device="cpu")

    def dtypes(*trees):
        return [str(np.asarray(x).dtype) if not isinstance(x, torch.Tensor)
                else str(x.dtype)[6:] for t in trees for x in _leaves(t)]

    assert dtypes(tp, to) == dtypes(jp, jo)
    for _ in range(2):
        with jax.default_matmul_precision("highest"):
            jp, jo, jloss = jstep(jp, jo, jnp.asarray(tokens),
                                  jnp.asarray(labels))
        tp, to, tloss = tstep(tp, to, torch.from_numpy(tokens),
                              torch.from_numpy(labels))
        assert dtypes(tp, to, [tloss]) == dtypes(jp, jo, [jloss])
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=5e-3)
    assert dtypes(tp)[0] == "float32" and dtypes(to["m"])[0] == "float32"


def test_step_matches_leaves_by_key_not_position():
    """Parameters and optimizer state whose dicts list their keys in
    another order than the initialiser's train exactly the same."""
    _, tcfg = _cfgs(d_model=32, n_layers=1)
    step, params, opt = tt.make_transformer_train_step(tcfg, device="cpu")
    tokens, labels = map(torch.from_numpy, _batch(7))

    def reorder(tree):
        if isinstance(tree, dict):
            return {k: reorder(tree[k]) for k in reversed(list(tree))}
        if isinstance(tree, list):
            return [reorder(x) for x in tree]
        return tree.clone()

    want_p, _, want_loss = step(params, opt, tokens, labels)
    got_p, _, got_loss = step(reorder(params), reorder(opt), tokens, labels)
    assert got_loss.item() == want_loss.item()
    for k in want_p:
        if k != "layers":
            torch.testing.assert_close(got_p[k], want_p[k], rtol=0, atol=0)
    for a, b in zip(got_p["layers"], want_p["layers"]):
        for k in b:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_mesh_is_refused():
    _, tcfg = _cfgs()
    with pytest.raises(NotImplementedError, match="A10"):
        tt.make_transformer_train_step(tcfg, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="ulysses"):
        tt.TransformerConfig(use_ring_attention=False,
                             sequence_parallel_mode="ulysses")
