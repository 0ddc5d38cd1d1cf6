"""The PyTorch port's transformer prefill / decode against the JAX
package, on the CPU at the shapes of the JAX generative-serving tests
(vocab 31, d 32, 2 heads, 2 layers, cache 64, page 16). Weights come from
the JAX initialiser through ``params_from_jax``. The JAX side runs under
``jax.default_matmul_precision("highest")`` (the XLA CPU backend otherwise
runs float32 matmuls at bf16-class precision); logits are compared at
atol 1e-4 — the frameworks sum in different orders, so bitwise equality
is not expected."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from incubator_mxnet_tpu.models import transformer as jt
from incubator_mxnet_tpu_torch.models import transformer as tt

CACHE, PAGE = 64, 16
ATOL = 1e-4


@pytest.fixture(scope="module")
def lm():
    jcfg = jt.TransformerConfig(vocab_size=31, d_model=32, n_heads=2,
                                d_ff=64, n_layers=2, max_len=CACHE,
                                dtype=jnp.float32)
    jparams = jt.init_transformer_params(jax.random.PRNGKey(0), jcfg)
    tcfg = tt.TransformerConfig(vocab_size=31, d_model=32, n_heads=2,
                                d_ff=64, n_layers=2, max_len=CACHE,
                                dtype=torch.float32)
    tparams = tt.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    return jparams, jcfg, tparams, tcfg


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(0, 31, (n,)).astype(np.int32)


def _pad(a, to):
    out = np.zeros((1, to), np.int32)
    out[0, :len(a)] = a
    return out


def test_params_from_jax_round_trips_every_leaf(lm):
    jparams, _, tparams, _ = lm
    jl, jtree = jax.tree_util.tree_flatten(jparams)
    tl, ttree = jax.tree_util.tree_flatten(tparams)
    assert jtree == ttree
    for a, b in zip(jl, tl):
        assert b.dtype == torch.float32 and b.device.type == "cpu"
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_moe_and_extent_checks_kept(lm):
    _, _, tparams, tcfg = lm
    moe = tt.TransformerConfig(vocab_size=31, d_model=32, n_heads=2,
                               d_ff=64, n_layers=2, max_len=CACHE,
                               n_experts=4)
    with pytest.raises(ValueError, match="MoE"):
        tt.init_kv_cache(moe, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="MoE"):
        tt.init_paged_kv_cache(moe, 4, 16, device="cpu")
    with pytest.raises(ValueError, match="exceeds cfg.max_len"):
        tt.init_kv_cache(tcfg, 2, CACHE + 1, device="cpu")
    cache = tt.init_paged_kv_cache(tcfg, 8, PAGE, device="cpu")
    with pytest.raises(ValueError, match="block-table extent"):
        tt.transformer_prefill_paged(
            tparams, torch.zeros((1, 16), dtype=torch.int64), tcfg, cache,
            torch.zeros(5, dtype=torch.int64), 0, 3)
    with pytest.raises(ValueError, match="block-table extent"):
        tt.transformer_decode_step_paged(
            tparams, torch.zeros(2, dtype=torch.int64),
            torch.zeros(2, dtype=torch.int64), cache,
            torch.zeros((2, 5), dtype=torch.int32), tcfg)


def test_contiguous_prefill_and_decode_match_jax(lm):
    """Prefill three prompts into three slots, then five decode steps
    (fed JAX's greedy tokens on both sides): logits and the written cache
    agree with the JAX functions."""
    jparams, jcfg, tparams, tcfg = lm
    prompts = [_prompt(n, s) for n, s in ((5, 1), (12, 2), (1, 3))]
    with jax.default_matmul_precision("highest"):
        jc = jt.init_kv_cache(jcfg, 3, CACHE)
        tc = tt.init_kv_cache(tcfg, 3, CACHE, device="cpu")
        nxt = []
        for slot, p in enumerate(prompts):
            jc, jl = jt.transformer_prefill(jparams,
                                            jnp.asarray(_pad(p, 16)), jcfg,
                                            jc, slot, len(p))
            tc, tl = tt.transformer_prefill(tparams,
                                            torch.from_numpy(_pad(p, 16)),
                                            tcfg, tc, slot, len(p))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=ATOL)
            nxt.append(int(jnp.argmax(jl)))
        pos = np.array([len(p) for p in prompts], np.int32)
        for _ in range(5):
            toks = np.array(nxt, np.int32)
            jc, jl = jt.transformer_decode_step(
                jparams, jnp.asarray(toks), jnp.asarray(pos), jc, jcfg,
                block_k=PAGE)
            tc, tl = tt.transformer_decode_step(
                tparams, torch.from_numpy(toks), torch.from_numpy(pos), tc,
                tcfg, block_k=PAGE)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=ATOL)
            nxt = [int(t) for t in np.asarray(jnp.argmax(jl, axis=1))]
            pos = pos + 1
    for fld in ("k", "v"):
        np.testing.assert_allclose(tc[fld].numpy(), np.asarray(jc[fld]),
                                   atol=ATOL)


def test_paged_prefill_and_decode_match_jax(lm):
    """The same through the page pool: shuffled block-table rows, a
    trash-padded tail, and a dead slot whose row is all trash."""
    jparams, jcfg, tparams, tcfg = lm
    n_pages, max_pages = 12, CACHE // PAGE
    trash = n_pages
    rows = np.random.RandomState(4).permutation(n_pages)[:6]
    bts = np.full((3, max_pages), trash, np.int32)
    bts[0, :3] = rows[:3]
    bts[1, :3] = rows[3:6]        # slot 2 stays dead (all trash)
    prompts = [_prompt(20, 5), _prompt(33, 6)]
    with jax.default_matmul_precision("highest"):
        jc = jt.init_paged_kv_cache(jcfg, n_pages, PAGE)
        tc = tt.init_paged_kv_cache(tcfg, n_pages, PAGE, device="cpu")
        nxt = [0, 0, 0]
        for slot, p in enumerate(prompts):
            jc, jl = jt.transformer_prefill_paged(
                jparams, jnp.asarray(_pad(p, 64)), jcfg, jc,
                jnp.asarray(bts[slot]), jnp.int32(0), jnp.int32(len(p)))
            tc, tl = tt.transformer_prefill_paged(
                tparams, torch.from_numpy(_pad(p, 64)), tcfg, tc,
                torch.from_numpy(bts[slot]), 0, len(p))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=ATOL)
            nxt[slot] = int(jnp.argmax(jl))
        pos = np.array([20, 33, 0], np.int32)
        for _ in range(4):
            toks = np.array(nxt, np.int32)
            jc, jl = jt.transformer_decode_step_paged(
                jparams, jnp.asarray(toks), jnp.asarray(pos), jc,
                jnp.asarray(bts), jcfg)
            tc, tl = tt.transformer_decode_step_paged(
                tparams, torch.from_numpy(toks), torch.from_numpy(pos), tc,
                torch.from_numpy(bts), tcfg)
            np.testing.assert_allclose(tl[:2].numpy(),
                                       np.asarray(jl)[:2], atol=ATOL)
            nxt = [int(t) for t in np.asarray(jnp.argmax(jl, axis=1))]
            pos[:2] += 1
    for fld in ("k", "v"):       # every page but the trash page
        np.testing.assert_allclose(tc[fld][:, :trash].numpy(),
                                   np.asarray(jc[fld])[:, :trash],
                                   atol=ATOL)


@pytest.mark.parametrize("page_len,n,starts", [(16, 45, (0, 16, 32)),
                                                (8, 60, (0, 56))])
def test_chunked_paged_prefill_matches_one_shot(lm, page_len, n, starts):
    """Chunked prefill equals one-shot prefill in logits and page
    contents — page-sized chunks, and a page-aligned tail chunk whose
    padded bucket runs past max_len (positions are clipped per row)."""
    _, _, tparams, tcfg = lm
    prompt = _prompt(n, 53)
    pages = torch.arange(CACHE // page_len)
    one = tt.init_paged_kv_cache(tcfg, CACHE // page_len, page_len,
                                 device="cpu")
    one, want = tt.transformer_prefill_paged(
        tparams, torch.from_numpy(_pad(prompt, 64)), tcfg, one, pages, 0, n)
    chunked = tt.init_paged_kv_cache(tcfg, CACHE // page_len, page_len,
                                     device="cpu")
    for a, b in zip(starts, starts[1:] + (n,)):
        bucket = 16 if b - a <= 16 else 64
        chunked, got = tt.transformer_prefill_paged(
            tparams, torch.from_numpy(_pad(prompt[a:b], bucket)), tcfg,
            chunked, pages, a, b - a)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    for fld in ("k", "v"):
        np.testing.assert_allclose(chunked[fld][:, :-1].numpy(),
                                   one[fld][:, :-1].numpy(), atol=1e-5)


def test_greedy_decode_equals_full_recompute(lm):
    """Greedy prefill + incremental decode emits the same 6 tokens as
    recomputing the whole sequence with the port's plain prefill (full
    causal attention, no cache reuse) at every step."""
    _, _, tparams, tcfg = lm
    prompt = list(_prompt(7, 11))
    cache = tt.init_kv_cache(tcfg, 2, CACHE, device="cpu")
    cache, logits = tt.transformer_prefill(
        tparams, torch.tensor([prompt]), tcfg, cache, 1, len(prompt))
    inc = [int(logits.argmax())]
    pos = len(prompt)
    while len(inc) < 6:
        toks = torch.tensor([0, inc[-1]])
        cache, logits = tt.transformer_decode_step(
            tparams, toks, torch.tensor([0, pos]), cache, tcfg,
            block_k=PAGE)
        inc.append(int(logits[1].argmax()))
        pos += 1
    seq, ref = list(prompt), []
    for _ in range(6):
        scratch = tt.init_kv_cache(tcfg, 1, CACHE, device="cpu")
        _, logits = tt.transformer_prefill(tparams, torch.tensor([seq]),
                                           tcfg, scratch, 0, len(seq))
        ref.append(int(logits.argmax()))
        seq.append(ref[-1])
    assert inc == ref
