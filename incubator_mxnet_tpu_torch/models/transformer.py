"""Transformer LM for generative serving, in PyTorch.

Counterpart of the generation half of
``incubator_mxnet_tpu/models/transformer.py``: the same parameter pytree
(``embed``, ``pos_embed``, ``final_ln_g``/``final_ln_b`` and a ``layers``
list of dicts, dense weights in the ``(d_in, d_out)`` layout so ``h @ w``
reads the same in both packages), the same slotted and paged KV caches, and
the same prefill / decode-step functions.

Difference from the JAX functions: the JAX ones return a new cache; these
update the cache dict's tensors IN PLACE (and return the same dict), which
saves a cache-sized copy per call.

Decode-step attention goes through ``ops.cuda.decode_attention`` /
``paged_decode_attention``: the CUDA kernels for tensors on the card, their
plain versions on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..context import resolve_device
from ..ops.cuda.flash_attention import (decode_attention,
                                        paged_decode_attention)
from ..parallel.ring_attention import attention_reference

__all__ = ["TransformerConfig", "init_transformer_params", "params_from_jax",
           "init_kv_cache", "transformer_prefill", "transformer_decode_step",
           "init_paged_kv_cache", "transformer_prefill_paged",
           "transformer_decode_step_paged"]

_LAYER_KEYS = ("ln1_g", "ln1_b", "wq", "wk", "wv", "wo", "ln2_g", "ln2_b",
               "w1", "b1", "w2", "b2")


@dataclass
class TransformerConfig:
    """Hyperparameters, as in the JAX package, with a torch dtype. Only
    the dense (``n_experts == 0``) model is served."""
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    d_ff: int = 2048
    n_layers: int = 4
    max_len: int = 2048
    n_experts: int = 0
    dtype: Any = torch.float32

    @property
    def head_dim(self):
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} is not a multiple of "
                             f"n_heads {self.n_heads}")
        return self.d_model // self.n_heads


def _check_dense(cfg: TransformerConfig) -> None:
    if cfg.n_experts > 0:
        raise ValueError("generative decode does not support MoE layers")


def init_transformer_params(generator: torch.Generator,
                            cfg: TransformerConfig,
                            device=None) -> Dict[str, Any]:
    """Random parameters in the JAX pytree layout: normal embeddings
    (std 0.02), Xavier-normal dense weights, unit/zero norms and zero
    biases, drawn from ``generator`` (which must live on ``device``).
    The numbers differ from the JAX initialiser's; use
    :func:`params_from_jax` to carry JAX weights across."""
    _check_dense(cfg)
    dev = resolve_device(device)
    dt = cfg.dtype
    D, Fd = cfg.d_model, cfg.d_ff

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32) * std).to(dt)

    def dense(d_in, d_out):
        return normal((d_in, d_out), (2.0 / (d_in + d_out)) ** 0.5)

    p: Dict[str, Any] = {
        "embed": normal((cfg.vocab_size, D), 0.02),
        "pos_embed": normal((cfg.max_len, D), 0.02),
        "final_ln_g": torch.ones(D, dtype=dt, device=dev),
        "final_ln_b": torch.zeros(D, dtype=dt, device=dev),
    }
    p["layers"] = [{
        "ln1_g": torch.ones(D, dtype=dt, device=dev),
        "ln1_b": torch.zeros(D, dtype=dt, device=dev),
        "wq": dense(D, D), "wk": dense(D, D), "wv": dense(D, D),
        "wo": dense(D, D),
        "ln2_g": torch.ones(D, dtype=dt, device=dev),
        "ln2_b": torch.zeros(D, dtype=dt, device=dev),
        "w1": dense(D, Fd), "b1": torch.zeros(Fd, dtype=dt, device=dev),
        "w2": dense(Fd, D), "b2": torch.zeros(D, dtype=dt, device=dev),
    } for _ in range(cfg.n_layers)]
    return p


def params_from_jax(np_tree, cfg: TransformerConfig,
                    device=None) -> Dict[str, Any]:
    """Carry parameters of the JAX package across: ``np_tree`` is its
    parameter pytree with every leaf converted to a numpy array (e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``). Returns the same
    layout as torch tensors of ``cfg.dtype`` on ``device``."""
    _check_dense(cfg)
    dev = resolve_device(device)

    def conv(a):
        return torch.tensor(a).to(device=dev, dtype=cfg.dtype)

    out = {name: conv(np_tree[name])
           for name in ("embed", "pos_embed", "final_ln_g", "final_ln_b")}
    layers = []
    for lp in np_tree["layers"]:
        extra = set(lp) - set(_LAYER_KEYS)
        if extra:
            raise ValueError(f"unsupported layer parameters {sorted(extra)}"
                             " (MoE layers are not served)")
        layers.append({name: conv(lp[name]) for name in _LAYER_KEYS})
    out["layers"] = layers
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers for cfg.n_layers "
                         f"{cfg.n_layers}")
    return out


def _layernorm(x, g, b, eps: float = 1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _mlp(x, lp):
    h = _layernorm(x, lp["ln2_g"], lp["ln2_b"])
    mid = F.gelu(h @ lp["w1"] + lp["b1"], approximate="tanh")
    return x + (mid @ lp["w2"] + lp["b2"])


# ------------------------------------------------------------ slotted cache
def init_kv_cache(cfg: TransformerConfig, slots: int, max_len: int,
                  dtype=None, device=None) -> Dict[str, Any]:
    """Zeroed slotted KV cache: {'k','v'} of shape
    (n_layers, slots, n_heads, max_len, head_dim)."""
    if max_len > cfg.max_len:
        raise ValueError(
            f"cache max_len {max_len} exceeds cfg.max_len {cfg.max_len} "
            "(positional embedding extent)")
    _check_dense(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, slots, cfg.n_heads, max_len, cfg.head_dim)
    dtype = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def transformer_prefill(params, tokens, cfg: TransformerConfig, cache,
                        slot: int, length: int):
    """Prompt pass for ONE request: tokens (1, T) (padded to its bucket;
    real extent ``length``) writes K/V for positions [0, T) into cache slot
    ``slot`` (in place) and returns (cache, logits (vocab,)) — the
    next-token logits at position ``length - 1``. Padded tail positions
    sit beyond the slot's valid length until a decode step overwrites
    them, so they are never attended to."""
    B, T = tokens.shape
    H, D = cfg.n_heads, cfg.head_dim
    x = params["embed"][tokens] + params["pos_embed"][:T][None]
    for i, lp in enumerate(params["layers"]):
        h = _layernorm(x, lp["ln1_g"], lp["ln1_b"])
        q = (h @ lp["wq"]).reshape(B, T, H, D)
        k = (h @ lp["wk"]).reshape(B, T, H, D)
        v = (h @ lp["wv"]).reshape(B, T, H, D)
        kd = cache["k"].dtype
        cache["k"][i, slot, :, :T] = k[0].transpose(0, 1).to(kd)
        cache["v"][i, slot, :, :T] = v[0].transpose(0, 1).to(kd)
        attn = attention_reference(q, k, v, causal=True)
        x = x + attn.reshape(B, T, cfg.d_model) @ lp["wo"]
        x = _mlp(x, lp)
    x = _layernorm(x, params["final_ln_g"], params["final_ln_b"])
    logits = x[0, length - 1] @ params["embed"].T
    return cache, logits


def transformer_decode_step(params, tokens, positions, cache,
                            cfg: TransformerConfig, block_k: int = 128):
    """One generation step for the whole slot batch: tokens (S,), positions
    (S,) — token s is written at cache position ``positions[s]`` (in place)
    and attends over [0, positions[s]]. Returns (cache, logits (S, vocab)).
    Every op is row-wise per slot, so a slot's logits depend only on its
    own cache trajectory."""
    S = tokens.shape[0]
    H, D = cfg.n_heads, cfg.head_dim
    x = params["embed"][tokens] + params["pos_embed"][positions]
    lengths = positions + 1
    idx_s = torch.arange(S, device=tokens.device)[:, None]
    idx_h = torch.arange(H, device=tokens.device)[None, :]
    pos2 = positions[:, None]
    for i, lp in enumerate(params["layers"]):
        h = _layernorm(x, lp["ln1_g"], lp["ln1_b"])
        q = (h @ lp["wq"]).reshape(S, H, D)
        k = (h @ lp["wk"]).reshape(S, H, D)
        v = (h @ lp["wv"]).reshape(S, H, D)
        kd = cache["k"].dtype
        ck, cv = cache["k"][i], cache["v"][i]
        ck[idx_s, idx_h, pos2] = k.to(kd)
        cv[idx_s, idx_h, pos2] = v.to(kd)
        attn = decode_attention(q, ck, cv, lengths, block_k=block_k)
        x = x + attn.reshape(S, cfg.d_model) @ lp["wo"]
        x = _mlp(x, lp)
    x = _layernorm(x, params["final_ln_g"], params["final_ln_b"])
    return cache, x @ params["embed"].T


# -------------------------------------------------------------- paged pool
def init_paged_kv_cache(cfg: TransformerConfig, n_pages: int,
                        page_len: int, dtype=None,
                        device=None) -> Dict[str, Any]:
    """Zeroed paged KV pool: {'k','v'} of shape
    (n_layers, n_pages + 1, n_heads, page_len, head_dim). The +1 page
    (index ``n_pages``) is the shared trash page — write target for padded
    scatter rows, read target for unallocated block-table entries; the
    allocator must never hand it out."""
    _check_dense(cfg)
    if page_len < 1 or n_pages < 1:
        raise ValueError("n_pages and page_len must be >= 1")
    dev = resolve_device(device)
    shape = (cfg.n_layers, n_pages + 1, cfg.n_heads, page_len,
             cfg.head_dim)
    dtype = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def transformer_prefill_paged(params, tokens, cfg: TransformerConfig,
                              cache, pages, start: int, n_valid: int):
    """ONE chunk of one request's prompt pass over the paged pool: tokens
    (1, T) (the chunk, padded to its bucket; real extent ``n_valid``),
    ``pages`` (max_pages,) — the request's block-table row (unallocated
    tail entries = the trash page id), ``start`` — the absolute position
    of tokens[0]. Writes K/V for positions [start, start + n_valid)
    through the block table (in place) and returns (cache, logits
    (vocab,)) at chunk row ``n_valid - 1``. A whole prompt is
    ``start=0, n_valid=n``; chunked prefill calls this per chunk with
    advancing ``start`` (each chunk attends over the same fixed gathered
    span, masked by absolute position)."""
    B, T = tokens.shape
    H, D = cfg.n_heads, cfg.head_dim
    dev = tokens.device
    n_pages_row = pages.shape[0]
    page_len = cache["k"].shape[3]
    trash = cache["k"].shape[1] - 1
    L = n_pages_row * page_len
    if L > cfg.max_len:
        raise ValueError(
            f"block-table extent {L} ({n_pages_row} pages x page_len "
            f"{page_len}) exceeds cfg.max_len {cfg.max_len} "
            "(positional embedding extent)")
    abs_pos = start + torch.arange(T, device=dev)
    valid = torch.arange(T, device=dev) < n_valid
    # positional rows are gathered per row by CLIPPED absolute position: a
    # padded tail chunk can run past max_len, and clipping only ever
    # distorts padded rows, whose K/V lands in the trash page
    x = params["embed"][tokens] + params["pos_embed"][
        abs_pos.clamp(0, cfg.max_len - 1)][None]
    idx_h = torch.arange(H, device=dev)
    # padded rows scatter to the trash page; valid rows to their page
    page_ids = torch.where(
        valid, pages[(abs_pos // page_len).clamp(0, n_pages_row - 1)],
        torch.full_like(abs_pos, trash))
    offs = abs_pos % page_len
    col_pos = torch.arange(L, device=dev)
    mask = abs_pos[:, None] >= col_pos[None, :]
    scale = D ** -0.5
    for i, lp in enumerate(params["layers"]):
        h = _layernorm(x, lp["ln1_g"], lp["ln1_b"])
        q = (h @ lp["wq"]).reshape(B, T, H, D)
        k = (h @ lp["wk"]).reshape(B, T, H, D)
        v = (h @ lp["wv"]).reshape(B, T, H, D)
        kd = cache["k"].dtype
        ck, cv = cache["k"][i], cache["v"][i]
        ck[page_ids[:, None], idx_h[None, :], offs[:, None]] = k[0].to(kd)
        cv[page_ids[:, None], idx_h[None, :], offs[:, None]] = v[0].to(kd)
        # the request's whole page span (fixed L; the dead tail masks to
        # exact softmax zeros, which keeps chunking exact)
        kg = ck[pages].transpose(1, 2).reshape(1, L, H, D)
        vg = cv[pages].transpose(1, 2).reshape(1, L, H, D)
        att = torch.einsum("bqhd,bkhd->bhqk", q, kg) * scale
        att = att.masked_fill(~mask[None, None], float("-inf"))
        probs = torch.softmax(att, dim=-1)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, vg)
        x = x + attn.reshape(B, T, cfg.d_model) @ lp["wo"]
        x = _mlp(x, lp)
    x = _layernorm(x, params["final_ln_g"], params["final_ln_b"])
    logits = x[0, n_valid - 1] @ params["embed"].T
    return cache, logits


def transformer_decode_step_paged(params, tokens, positions, cache,
                                  block_tables, cfg: TransformerConfig):
    """One generation step over the paged pool: tokens (S,), positions
    (S,), block_tables (S, max_pages) int32. Token s is written (in place)
    at page ``block_tables[s, positions[s] // page_len]`` offset
    ``positions[s] % page_len`` and attends over [0, positions[s]] through
    its block-table row. Returns (cache, logits (S, vocab)). Dead slots
    must carry all-trash block-table rows."""
    S = tokens.shape[0]
    H, D = cfg.n_heads, cfg.head_dim
    dev = tokens.device
    page_len = cache["k"].shape[3]
    max_pages = block_tables.shape[1]
    if max_pages * page_len > cfg.max_len:
        raise ValueError(
            f"block-table extent {max_pages * page_len} ({max_pages} "
            f"pages x page_len {page_len}) exceeds cfg.max_len "
            f"{cfg.max_len} (positional embedding extent)")
    x = params["embed"][tokens] + params["pos_embed"][positions]
    lengths = positions + 1
    idx_s = torch.arange(S, device=dev)
    idx_h = torch.arange(H, device=dev)[None, :]
    page_ids = block_tables[
        idx_s, (positions // page_len).clamp(0, max_pages - 1)].long()
    offs = (positions % page_len)[:, None]
    for i, lp in enumerate(params["layers"]):
        h = _layernorm(x, lp["ln1_g"], lp["ln1_b"])
        q = (h @ lp["wq"]).reshape(S, H, D)
        k = (h @ lp["wk"]).reshape(S, H, D)
        v = (h @ lp["wv"]).reshape(S, H, D)
        kd = cache["k"].dtype
        ck, cv = cache["k"][i], cache["v"][i]
        ck[page_ids[:, None], idx_h, offs] = k.to(kd)
        cv[page_ids[:, None], idx_h, offs] = v.to(kd)
        attn = paged_decode_attention(q, ck, cv, block_tables, lengths)
        x = x + attn.reshape(S, cfg.d_model) @ lp["wo"]
        x = _mlp(x, lp)
    x = _layernorm(x, params["final_ln_g"], params["final_ln_b"])
    return cache, x @ params["embed"].T
