"""The PyTorch port's decode-step attention against the JAX package: the
port's plain contiguous and paged versions (what its dispatchers run on
CPU tensors) against JAX's plain references and its Pallas kernels run in
interpret mode, at tolerance 1e-5 in float32 (sums are taken in another
order, so bitwise equality is not expected across frameworks). The CUDA
kernels themselves are held against these plain versions on the card by
chip_smoke.py."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from incubator_mxnet_tpu.ops.pallas import (decode_attention_reference,
                                            flash_decode_step,
                                            flash_decode_step_paged,
                                            paged_decode_attention_reference)
from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as tfa

TOL = dict(atol=1e-5, rtol=1e-5)

JAX_CONTIGUOUS = {"reference": decode_attention_reference,
                  "pallas_interpret": flash_decode_step}
JAX_PAGED = {"reference": paged_decode_attention_reference,
             "pallas_interpret": flash_decode_step_paged}


def _contiguous(S=4, H=2, C=64, d=16, seed=0):
    """Lengths 1, a partial page, the full cache, and a short one whose
    dead tail holds large finite garbage that must not leak."""
    rng = np.random.RandomState(seed)
    q = rng.randn(S, H, d).astype(np.float32)
    k = rng.randn(S, H, C, d).astype(np.float32)
    v = rng.randn(S, H, C, d).astype(np.float32)
    lengths = np.array([1, C // 2 + 3, C, 5], np.int32)[:S]
    if S > 3:
        k[3, :, 5:] = 1e4
        v[3, :, 5:] = -1e4
    return q, k, v, lengths


def _paged(S=4, H=2, P=16, n_pages=16, max_pages=4, d=16, seed=0):
    """Shuffled block tables over a pool whose trash page (the last one)
    is filled with finite garbage; the same four kinds of length."""
    rng = np.random.RandomState(seed)
    k = rng.randn(n_pages + 1, H, P, d).astype(np.float32)
    v = rng.randn(n_pages + 1, H, P, d).astype(np.float32)
    k[n_pages] = 1e4 * rng.randn(H, P, d)
    v[n_pages] = -1e4 * rng.randn(H, P, d)
    q = rng.randn(S, H, d).astype(np.float32)
    bt = rng.permutation(n_pages)[:S * max_pages].reshape(
        S, max_pages).astype(np.int32)
    lengths = np.array([1, P * 2 + 5, P * max_pages, 3], np.int32)[:S]
    bt[3, 1:] = n_pages          # dead pages point at the trash page
    bt[1, 3] = n_pages
    return q, k, v, bt, lengths


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("jax_fn", sorted(JAX_CONTIGUOUS))
@pytest.mark.parametrize("block_k", [16, 128])
def test_contiguous_decode_matches_jax(jax_fn, block_k):
    q, k, v, lengths = _contiguous()
    want = JAX_CONTIGUOUS[jax_fn](jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(lengths),
                                  block_k=block_k)
    got = tfa.decode_attention(*_t(q, k, v, lengths), block_k=block_k)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("jax_fn", sorted(JAX_PAGED))
def test_paged_decode_matches_jax(jax_fn):
    q, k, v, bt, lengths = _paged()
    want = JAX_PAGED[jax_fn](jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(bt), jnp.asarray(lengths))
    got = tfa.paged_decode_attention(*_t(q, k, v, bt, lengths))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_paged_matches_contiguous_through_scrambled_table():
    """The same logical K/V laid out contiguously and scattered over pool
    pages give the same attention in the port."""
    q, k, v, lengths = _contiguous(S=2, C=48)
    S, H, C, d = k.shape
    P, n_pool = 16, 8
    perm = np.random.RandomState(3).permutation(n_pool)[:S * C // P]
    bt = perm.reshape(S, C // P).astype(np.int32)
    kp = np.zeros((n_pool + 1, H, P, d), np.float32)
    vp = np.zeros_like(kp)
    for s in range(S):
        for p in range(C // P):
            kp[bt[s, p]] = k[s, :, p * P:(p + 1) * P]
            vp[bt[s, p]] = v[s, :, p * P:(p + 1) * P]
    cont = tfa.decode_attention(*_t(q, k, v, lengths), block_k=P)
    paged = tfa.paged_decode_attention(*_t(q, kp, vp, bt, lengths))
    np.testing.assert_allclose(paged.numpy(), cont.numpy(), **TOL)


def test_plain_versions_keep_bf16_and_zero_length():
    """bf16 in -> bf16 out (f32 accumulation inside); a zero length
    attends to nothing and returns zeros, as the reference does."""
    q, k, v, lengths = _contiguous()
    lengths = lengths.copy()
    lengths[0] = 0
    qt, kt, vt, lt = _t(q, k, v, lengths)
    out = tfa.decode_attention(qt.bfloat16(), kt.bfloat16(), vt.bfloat16(),
                               lt)
    assert out.dtype == torch.bfloat16
    assert torch.count_nonzero(out[0]) == 0
    f32 = tfa.decode_attention(qt, kt, vt, lt)
    np.testing.assert_allclose(out[1:3].float().numpy(),
                               f32[1:3].numpy(), atol=5e-2)


@pytest.mark.parametrize("kernel,args", [
    ("flash_decode_step", lambda q, k, v, bt, n: (q, k, v, n)),
    ("flash_decode_step_paged", lambda q, k, v, bt, n: (q, k, v, bt, n)),
])
def test_kernel_wrappers_refuse_cpu_and_bad_geometry(kernel, args):
    """A kernel wrapper never runs the plain version: CPU tensors raise,
    and so does a head dim the kernel does not take (d % 8 != 0) — and
    neither bumps the launch counter. The dispatchers route CPU tensors
    to the plain versions without launching anything."""
    fn = getattr(tfa, kernel)
    tfa.reset_launch_counts()
    q, k, v, bt, lengths = _t(*_paged())
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(*args(q, k, v, bt, lengths))
    with pytest.raises(ValueError, match="head dim 12"):
        fn(*args(q[..., :12], k[..., :12], v[..., :12], bt, lengths))
    tfa.paged_decode_attention(q, k, v, bt, lengths)
    tfa.decode_attention(*_t(*_contiguous()))
    counts = tfa.launch_counts()
    assert counts["flash_decode_step"] == 0
    assert counts["flash_decode_step_paged"] == 0
    assert set(counts.values()) == {0}
