"""The port's training attention (``ops/cuda/flash_attention.py``) against
the JAX package's Pallas kernels, on the CPU in float32.

The JAX functions run their Pallas kernels in interpret mode, as the JAX
package's own tests do (``tests/test_pallas.py``); the port runs the plain
twins of its CUDA kernels, which is what a CPU tensor takes. Inputs are
made with numpy from a seed and handed to both. Tolerances: 1e-5 on the
forward (out, lse) and on the backward from a shared lse and delta, 1e-4
on autograd gradients (the two frameworks sum in different orders)."""
import importlib
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as tfa

# the module, not the function of the same name that ops.pallas exports
jfa = importlib.import_module(
    "incubator_mxnet_tpu.ops.pallas.flash_attention")

B, T, H, D = 2, 128, 4, 32
FWD_ATOL = 1e-5
GRAD_ATOL = 1e-4


def _rand(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _packed_inputs(seed=0, n=3):
    return [_rand(B, T, H * D, seed=seed + i) for i in range(n)]


def _hm_inputs(sq=T, sk=T, seed=10, n=3):
    shapes = [(B, H, sq, D), (B, H, sk, D), (B, H, sk, D), (B, H, sq, D)]
    return [_rand(*shapes[i], seed=seed + i) for i in range(n)]


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("causal", [False, True])
def test_packed_forward_and_lse_match_jax(causal):
    q, k, v = _packed_inputs()
    with jax.default_matmul_precision("highest"):
        want = jfa.flash_attention_packed(*map(jnp.asarray, (q, k, v)), H,
                                          causal=causal)
        _, want_lse = jfa._fwd_packed(*map(jnp.asarray, (q, k, v)), H,
                                      1.0 / math.sqrt(D), causal, 64, 64)
    got = tfa.flash_attention_packed(*_t(q, k, v), H, causal=causal)
    _close(got, want, FWD_ATOL)
    out, lse = tfa._flash_forward(*_t(q, k, v), causal, 1.0 / math.sqrt(D),
                                  H)
    assert lse.shape == (B, T, H) and lse.dtype == torch.float32
    _close(out, want, FWD_ATOL)
    _close(lse, want_lse, FWD_ATOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sk", [T, 64])
def test_head_major_forward_and_lse_match_jax(causal, sk):
    q, k, v = _hm_inputs(sk=sk)
    with jax.default_matmul_precision("highest"):
        want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)),
                                   causal=causal)
        want_out, want_lse = jfa.flash_attention_with_lse(
            *map(jnp.asarray, (q, k, v)), causal=causal)
    _close(tfa.flash_attention(*_t(q, k, v), causal=causal), want, FWD_ATOL)
    out, lse = tfa.flash_attention_with_lse(*_t(q, k, v), causal=causal)
    assert lse.shape == (B, H, T)
    _close(out, want_out, FWD_ATOL)
    _close(lse, want_lse, FWD_ATOL)


def test_non_tiling_sequence_takes_the_plain_attention():
    q, k, v = _hm_inputs(sq=5, sk=5)
    with jax.default_matmul_precision("highest"):
        want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True)
    _close(tfa.flash_attention(*_t(q, k, v), causal=True), want, FWD_ATOL)
    assert not tfa.flash_kernel_viable(5, 5, D)
    with pytest.raises(ValueError, match="cannot run"):
        tfa.flash_attention_with_lse(*_t(q, k, v))


@pytest.mark.parametrize("causal", [False, True])
def test_backward_twin_matches_jax_fused_backward(causal):
    q, k, v, g = _packed_inputs(seed=20, n=4)
    scale = 1.0 / math.sqrt(D)
    with jax.default_matmul_precision("highest"):
        jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
        out, lse = jfa._fwd_packed(jq, jk, jv, H, scale, causal, 64, 64)
        delta = (jg * out).reshape(B, T, H, D).sum(-1)
        want = jfa._bwd_fused_packed(jq, jk, jv, jg, lse, delta, H, scale,
                                     causal, 64, 64)
    got = tfa.flash_backward_reference(
        *_t(q, k, v, g, np.asarray(lse), np.asarray(delta)), causal=causal,
        n_heads=H)
    for a, b in zip(got, want):
        _close(a, b, FWD_ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_head_major_backward_twin_matches_jax_two_pass(causal):
    q, k, v, g = _hm_inputs(n=4, seed=30)
    scale = 1.0 / math.sqrt(D)
    with jax.default_matmul_precision("highest"):
        jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
        out, lse = jfa._fwd(jq, jk, jv, scale, causal, 64, 64)
        want = jfa._bwd(jq, jk, jv, out, lse, jg, scale, causal, 64, 64)
        delta = jnp.sum(jg * out, axis=-1)
    got = tfa.flash_backward_reference(
        *_t(q, k, v, g, np.asarray(lse), np.asarray(delta)), causal=causal)
    for a, b in zip(got, want):
        _close(a, b, FWD_ATOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("layout", ["packed", "head_major"])
def test_autograd_grads_match_jax(causal, layout):
    if layout == "packed":
        q, k, v, w = _packed_inputs(seed=40, n=4)

        def jax_fn(q, k, v):
            return jfa.flash_attention_packed(q, k, v, H, causal=causal)

        def port_fn(q, k, v):
            return tfa.flash_attention_packed(q, k, v, H, causal=causal)
    else:
        q, k, v, w = _hm_inputs(n=4, seed=50)

        def jax_fn(q, k, v):
            return jfa.flash_attention(q, k, v, causal=causal)

        def port_fn(q, k, v):
            return tfa.flash_attention(q, k, v, causal=causal)

    with jax.default_matmul_precision("highest"):
        want = jax.grad(
            lambda q, k, v: jnp.sum(jax_fn(q, k, v) * jnp.asarray(w)),
            argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    xs = [t.requires_grad_(True) for t in _t(q, k, v)]
    (port_fn(*xs) * torch.from_numpy(w)).sum().backward()
    for x, b in zip(xs, want):
        _close(x.grad, b, GRAD_ATOL)


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv"])
@pytest.mark.parametrize("n_heads", [None, H])
def test_kernel_wrappers_refuse_cpu_tensors(kernel, n_heads):
    """A training kernel wrapper never runs the plain twin: CPU tensors
    raise ValueError, and nothing is counted as launched."""
    tfa.reset_launch_counts()
    if n_heads is None:
        q, k, v, g = _t(*_hm_inputs(n=4))
        rows = (B, H, T)
    else:
        q, k, v, g = _t(*_packed_inputs(n=4))
        rows = (B, T, H)
    lse = delta = torch.zeros(rows)
    args = (q, k, v) if kernel == "flash_fwd" else (q, k, v, g, lse, delta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(tfa, kernel)(*args, causal=True, n_heads=n_heads)
    tfa.flash_attention_packed(*_t(*_packed_inputs()), H, causal=True)
    assert set(tfa.launch_counts().values()) == {0}


def test_packed_viability_keeps_only_layout_rules():
    assert tfa.flash_attention_packed_viable(512, 768, 12, 32)
    assert tfa.flash_attention_packed_viable(8192, 768, 12, 4096)
    assert not tfa.flash_attention_packed_viable(512, 576, 9)   # HD % 128
    assert not tfa.flash_attention_packed_viable(100, 768, 12)  # T % 8
    assert not tfa.flash_attention_packed_viable(512, 128, 32)  # d % 8
    assert jfa.flash_attention_packed_viable(512, 576, 9) is False
