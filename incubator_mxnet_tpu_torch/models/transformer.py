"""Transformer LM in PyTorch: training on one device, and generative serving.

Counterpart of ``incubator_mxnet_tpu/models/transformer.py``: the same
parameter pytree (``embed``, ``pos_embed``, ``final_ln_g``/``final_ln_b``
and a ``layers`` list of dicts, dense weights in the ``(d_in, d_out)``
layout so ``h @ w`` reads the same in both packages; with ``n_experts`` > 0
every other layer holds an MoE FFN), the training step with its tied-head
cross-entropy and inline Adam, and the slotted and paged KV caches with
their prefill / decode-step functions.

Attention goes through ``ops.cuda.flash_attention``: the CUDA kernels for
tensors on the card, their plain versions on the CPU. Training takes the
packed route (q/k/v stay (B, T, H*d)) where ``flash_attention_packed_viable``
holds and the head-major route otherwise, as the reference does.

Types follow the reference's promotion: an MoE layer's output is float32
even in a bf16 model, so the activations after it meet bf16 weights; such
a product is taken in the promotion of both types, as ``jnp.matmul``
takes it.

Differences from the JAX functions: the cache functions update the cache
dict's tensors IN PLACE (and return the same dict), which saves a
cache-sized copy per call; a ``mesh`` is not supported yet (the
distributed slice, ``ROADMAP.md`` A10).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..context import resolve_device
from ..ops import matmul_promoted as _mm
from ..ops.cuda.flash_attention import (decode_attention, flash_attention,
                                        flash_attention_packed,
                                        flash_attention_packed_viable,
                                        paged_decode_attention)
from ..parallel.moe import moe_layer_dense
from ..parallel.ring_attention import attention_reference

__all__ = ["TransformerConfig", "init_transformer_params", "params_from_jax",
           "opt_state_from_jax", "transformer_forward", "headmajor_proj",
           "headmajor_out", "tied_head_xent", "transformer_loss_and_grads",
           "make_transformer_train_step", "init_kv_cache",
           "transformer_prefill", "transformer_decode_step",
           "init_paged_kv_cache", "transformer_prefill_paged",
           "transformer_decode_step_paged"]

_ATTN_KEYS = ("ln1_g", "ln1_b", "wq", "wk", "wv", "wo", "ln2_g", "ln2_b")
_LAYER_KEYS = _ATTN_KEYS + ("w1", "b1", "w2", "b2")
_MOE_LAYER_KEYS = _ATTN_KEYS + ("moe_gate", "moe_w1", "moe_b1", "moe_w2",
                                "moe_b2")


@dataclass
class TransformerConfig:
    """Hyperparameters, as in the JAX package, with a torch dtype.
    ``n_experts`` > 0 puts an MoE FFN in every other layer (training
    only: the serving functions take dense models). ``use_ring_attention``
    and ``sequence_parallel_mode`` choose the attention across a mesh; no
    function of the port reads them yet (a mesh raises, ``ROADMAP.md``
    A10), and they are kept, with the reference's checks, so that a JAX
    configuration carries across unchanged."""
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    d_ff: int = 2048
    n_layers: int = 4
    max_len: int = 2048
    n_experts: int = 0
    capacity_factor: float = 1.25
    dtype: Any = torch.float32
    causal: bool = True
    use_ring_attention: bool = True    # sequence-parallel attention on a mesh
    use_flash_attention: bool = True   # the flash kernels on one device
    sequence_parallel_mode: str = "ring"   # 'ring' | 'ulysses'

    def __post_init__(self):
        if self.sequence_parallel_mode not in ("ring", "ulysses"):
            raise ValueError(
                f"sequence_parallel_mode must be 'ring' or 'ulysses', got "
                f"{self.sequence_parallel_mode!r}")
        if (self.sequence_parallel_mode == "ulysses"
                and not self.use_ring_attention):
            raise ValueError(
                "use_ring_attention=False disables sequence-parallel "
                "attention entirely (the flag gates CP, not just the ring "
                "strategy), so sequence_parallel_mode='ulysses' would be "
                "silently ignored — enable it or use mode 'ring'")

    @property
    def head_dim(self):
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} is not a multiple of "
                             f"n_heads {self.n_heads}")
        return self.d_model // self.n_heads


def _check_dense(cfg: TransformerConfig) -> None:
    if cfg.n_experts > 0:
        raise ValueError("generative decode does not support MoE layers")


def _is_moe_layer(cfg: TransformerConfig, i: int) -> bool:
    return cfg.n_experts > 0 and i % 2 == 1


def init_transformer_params(generator: torch.Generator,
                            cfg: TransformerConfig,
                            device=None) -> Dict[str, Any]:
    """Random parameters in the JAX pytree layout: normal embeddings
    (std 0.02), Xavier-normal dense and expert weights, unit/zero norms and
    zero biases, drawn from ``generator`` (which must live on ``device``).
    The numbers differ from the JAX initialiser's; use
    :func:`params_from_jax` to carry JAX weights across."""
    dev = resolve_device(device)
    dt = cfg.dtype
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32) * std).to(dt)

    def dense(d_in, d_out):
        return normal((d_in, d_out), (2.0 / (d_in + d_out)) ** 0.5)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    p: Dict[str, Any] = {
        "embed": normal((cfg.vocab_size, D), 0.02),
        "pos_embed": normal((cfg.max_len, D), 0.02),
        "final_ln_g": ones(D),
        "final_ln_b": zeros(D),
    }
    layers = []
    for i in range(cfg.n_layers):
        lp = {"ln1_g": ones(D), "ln1_b": zeros(D),
              "wq": dense(D, D), "wk": dense(D, D), "wv": dense(D, D),
              "wo": dense(D, D), "ln2_g": ones(D), "ln2_b": zeros(D)}
        if _is_moe_layer(cfg, i):
            std = (2.0 / (D + Fd)) ** 0.5
            lp.update(moe_gate=dense(D, E), moe_w1=normal((E, D, Fd), std),
                      moe_b1=zeros(E, Fd), moe_w2=normal((E, Fd, D), std),
                      moe_b2=zeros(E, D))
        else:
            lp.update(w1=dense(D, Fd), b1=zeros(Fd), w2=dense(Fd, D),
                      b2=zeros(D))
        layers.append(lp)
    p["layers"] = layers
    return p


def _tensor_from_numpy(a, dev, dtype):
    """One numpy leaf as a torch tensor. bfloat16 arrays (numpy has no
    such type of its own; JAX hands out ml_dtypes' bfloat16) cross bit for
    bit through their 16-bit pattern."""
    a = np.array(a)                       # a writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=dev, dtype=dtype or t.dtype)


def params_from_jax(np_tree, cfg: TransformerConfig, device=None,
                    dtype=None) -> Dict[str, Any]:
    """Carry parameters of the JAX package across: ``np_tree`` is its
    parameter pytree with every leaf converted to a numpy array (e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``). Returns the same
    layout as torch tensors on ``device``. With ``dtype=None`` every leaf
    keeps its own type (bfloat16 bit for bit), so a state taken after a JAX
    step, whose leaves may differ in type, crosses exactly; a torch dtype
    casts every leaf to it."""
    dev = resolve_device(device)

    def conv(a):
        return _tensor_from_numpy(a, dev, dtype)

    out = {name: conv(np_tree[name])
           for name in ("embed", "pos_embed", "final_ln_g", "final_ln_b")}
    layers = []
    for i, lp in enumerate(np_tree["layers"]):
        keys = _MOE_LAYER_KEYS if _is_moe_layer(cfg, i) else _LAYER_KEYS
        if set(lp) != set(keys):
            raise ValueError(f"layer {i}: parameters {sorted(lp)} do not "
                             f"match cfg (expected {sorted(keys)})")
        layers.append({name: conv(lp[name]) for name in keys})
    out["layers"] = layers
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers for cfg.n_layers "
                         f"{cfg.n_layers}")
    return out


def opt_state_from_jax(np_opt, cfg: TransformerConfig,
                       device=None) -> Dict[str, Any]:
    """Carry the JAX train step's Adam state ``{"m", "v", "t"}`` across
    (leaves as numpy arrays), every leaf in its own type."""
    dev = resolve_device(device)
    return {"m": params_from_jax(np_opt["m"], cfg, dev),
            "v": params_from_jax(np_opt["v"], cfg, dev),
            "t": _tensor_from_numpy(np_opt["t"], dev, None)}


def _layernorm(x, g, b, eps: float = 1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _mlp(x, lp):
    h = _layernorm(x, lp["ln2_g"], lp["ln2_b"])
    mid = F.gelu(_mm(h, lp["w1"]) + lp["b1"], approximate="tanh")
    return x + (_mm(mid, lp["w2"]) + lp["b2"])


# ------------------------------------------------------------------ training
def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh is not supported yet: the distributed training "
            "path is ROADMAP.md A10; pass mesh=None")


def headmajor_proj(h, w, H: int):
    """(B, T, M) @ (M, H*D) -> (B, H, T, D): QKV projection, head-major."""
    B, T, M = h.shape
    D = w.shape[1] // H
    q = _mm(h.reshape(B * T, M), w)
    return q.reshape(B, T, H, D).permute(0, 2, 1, 3)


def headmajor_out(attn, w):
    """(B, H, T, D) x (H*D, M) -> (B, T, M): attention output projection."""
    B, H, T, D = attn.shape
    a2 = attn.permute(0, 2, 1, 3).reshape(B * T, H * D)
    return _mm(a2, w).reshape(B, T, w.shape[1])


def transformer_forward(params, tokens, cfg: TransformerConfig, mesh=None,
                        return_hidden: bool = False):
    """tokens (B, T) -> (logits (B, T, vocab), aux_loss float32); with
    ``return_hidden`` the final-LN hidden states (B, T, d) come back
    instead of logits (the fused tied-head loss consumes those).

    Attention: the packed flash route where
    ``flash_attention_packed_viable(T, d_model, n_heads, B)`` holds, the
    head-major flash route otherwise, and :func:`attention_reference` with
    ``cfg.use_flash_attention=False``."""
    _no_mesh(mesh)
    B, T = tokens.shape
    H = cfg.n_heads
    x = params["embed"][tokens] + params["pos_embed"][:T][None]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    use_flash = cfg.use_flash_attention
    use_packed = use_flash and flash_attention_packed_viable(
        T, cfg.d_model, H, B)
    for lp in params["layers"]:
        h = _layernorm(x, lp["ln1_g"], lp["ln1_b"])
        if use_packed:
            # q/k/v stay (B, T, H*D), as the projection emits them
            attn = flash_attention_packed(_mm(h, lp["wq"]), _mm(h, lp["wk"]),
                                          _mm(h, lp["wv"]), H,
                                          causal=cfg.causal)
            attn = _mm(attn, lp["wo"])
        elif use_flash:
            attn = flash_attention(headmajor_proj(h, lp["wq"], H),
                                   headmajor_proj(h, lp["wk"], H),
                                   headmajor_proj(h, lp["wv"], H),
                                   causal=cfg.causal)
            attn = headmajor_out(attn, lp["wo"])
        else:
            q, k, v = (_mm(h, lp[w]).reshape(B, T, H, cfg.head_dim)
                       for w in ("wq", "wk", "wv"))
            attn = attention_reference(q, k, v, causal=cfg.causal)
            attn = _mm(attn.reshape(B, T, cfg.d_model), lp["wo"])
        x = x + attn
        if "moe_w1" in lp:
            h = _layernorm(x, lp["ln2_g"], lp["ln2_b"])
            y, aux = moe_layer_dense(
                h.reshape(B * T, cfg.d_model), lp["moe_gate"], lp["moe_w1"],
                lp["moe_b1"], lp["moe_w2"], lp["moe_b2"],
                capacity_factor=cfg.capacity_factor)
            x = x + y.reshape(B, T, cfg.d_model)
            aux_total = aux_total + aux.float()
        else:
            x = _mlp(x, lp)
    x = _layernorm(x, params["final_ln_g"], params["final_ln_b"])
    if return_hidden:
        return x, aux_total
    return _mm(x, params["embed"].T), aux_total   # weight-tied head


def _softmax_xent(logits, labels):
    """Mean token cross-entropy; stable log-softmax."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None])[..., 0]
    return (logz - gold).mean()


# fused tied-head cross-entropy: the (N, V) logits are never materialised;
# V is scanned in chunks of ~_HEAD_CHUNK columns
_HEAD_CHUNK = 8192


def _head_chunk_count(V: int) -> int:
    """ceil(V / _HEAD_CHUNK): the head is zero-padded to equal chunks and
    the padded columns are masked, so any vocab size works."""
    return max(1, -(-V // _HEAD_CHUNK))


def _pad_head(emb, nc: int):
    """(V, d) -> ((nc, C, d) with zero row padding, C = ceil(V / nc))."""
    V, d = emb.shape
    C = -(-V // nc)
    if nc * C != V:
        emb = torch.cat([emb, emb.new_zeros((nc * C - V, d))], dim=0)
    return emb.reshape(nc, C, d), C


class _TiedHeadXent(torch.autograd.Function):
    """mean_i [logsumexp_v(h2 @ emb.T) - (h2 @ emb.T)[i, labels[i]]] by a
    scan over vocab chunks with a running (max, sumexp); the backward
    recomputes each chunk's logits once. Products are float32, as the
    reference's ``preferred_element_type``."""

    @staticmethod
    def forward(ctx, h2, emb, labels1, nc):
        N = h2.shape[0]
        V = emb.shape[0]
        embc, C = _pad_head(emb, nc)
        h2f = h2.float()
        dev = h2.device
        m = torch.full((N,), float("-inf"), dtype=torch.float32, device=dev)
        l = torch.zeros((N,), dtype=torch.float32, device=dev)
        gold = torch.zeros((N,), dtype=torch.float32, device=dev)
        cols = torch.arange(C, device=dev)
        for i in range(nc):
            lg = h2f @ embc[i].float().T
            # padded vocab columns must not contribute to the logsumexp
            lg = torch.where((i * C + cols < V)[None, :], lg,
                             torch.full_like(lg, float("-inf")))
            m_new = torch.maximum(m, lg.amax(dim=1))
            l = l * torch.exp(m - m_new) + torch.exp(torch.where(
                torch.isfinite(lg), lg - m_new[:, None],
                torch.full_like(lg, float("-inf")))).sum(dim=1)
            idx = labels1 - i * C
            in_chunk = (idx >= 0) & (idx < C)
            g = lg.gather(1, idx.clamp(0, C - 1)[:, None])[:, 0]
            gold = torch.where(in_chunk, g, gold)
            m = m_new
        lse = m + torch.log(l)
        ctx.save_for_backward(h2, emb, labels1, lse)
        ctx.nc = nc
        return (lse - gold).mean()

    @staticmethod
    def backward(ctx, gbar):
        h2, emb, labels1, lse = ctx.saved_tensors
        nc = ctx.nc
        N, d = h2.shape
        V = emb.shape[0]
        embc, C = _pad_head(emb, nc)
        scale = gbar / N
        h2f = h2.float()
        cols = torch.arange(C, device=h2.device)
        dh = torch.zeros((N, d), dtype=torch.float32, device=h2.device)
        dembc = []
        for i in range(nc):
            ec = embc[i].float()
            p = torch.exp(h2f @ ec.T - lse[:, None]) * scale
            p = torch.where((i * C + cols < V)[None, :], p,
                            torch.zeros_like(p))
            onehot = cols[None, :] == (labels1 - i * C)[:, None]
            p = torch.where(onehot, p - scale, p)
            pc = p.to(h2.dtype).float()
            dh = dh + pc @ ec
            dembc.append(pc.T @ h2f)
        demb = torch.cat(dembc, dim=0)[:V]
        return dh.to(h2.dtype), demb.to(emb.dtype), None, None


def tied_head_xent(h2, emb, labels1, nc: int):
    """Mean cross-entropy of the tied head h2 (N, d) @ emb (V, d).T against
    labels1 (N,), scanning the vocab in ``nc`` chunks (see
    :func:`_head_chunk_count`); differentiable in h2 and emb."""
    return _TiedHeadXent.apply(h2, emb, labels1, nc)


def transformer_loss_and_grads(params, tokens, labels, cfg: TransformerConfig,
                               aux_weight: float = 1e-2,
                               fused_head: bool = False):
    """The train step's objective, mean cross-entropy of the tied head plus
    ``aux_weight`` times the MoE balancing loss, and its gradient tree.
    ``fused_head`` scans the vocab (:func:`tied_head_xent`) instead of
    forming the logits. Returns (loss, grads) with grads in the layout of
    ``params``."""
    p = _tree_map(lambda t: t.detach().requires_grad_(True), params)
    tokens = tokens.long()
    labels = labels.long()
    with torch.enable_grad():
        if fused_head:
            h, aux = transformer_forward(p, tokens, cfg, return_hidden=True)
            xent = tied_head_xent(h.reshape(-1, h.shape[-1]), p["embed"],
                                  labels.reshape(-1),
                                  _head_chunk_count(cfg.vocab_size))
        else:
            logits, aux = transformer_forward(p, tokens, cfg)
            xent = _softmax_xent(logits, labels)
        loss = xent + aux_weight * aux
        grads = iter(torch.autograd.grad(loss, _tree_leaves(p)))
    return loss.detach(), _tree_map(lambda _: next(grads), p)


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a dict/list tree, with the leaves of
    ``rest`` (trees of the same structure) matched by key and index."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _tree_leaves(tree):
    """The leaves of a dict/list tree, in :func:`_tree_map`'s order."""
    leaves = []
    _tree_map(leaves.append, tree)
    return leaves


def make_transformer_train_step(cfg: TransformerConfig, mesh=None,
                                learning_rate: float = 1e-3,
                                aux_weight: float = 1e-2, seed: int = 0,
                                device=None):
    """Build (step, params, opt_state) for training on one device.

    ``step(params, opt_state, tokens, labels) -> (params, opt_state,
    loss)``, with Adam (b1 0.9, b2 0.999, eps 1e-8) written out as in the
    reference, including its types: the bias-corrected rate is a float32
    tensor, so updated parameters are float32 whatever their type was, and
    the moments take the promotion of their own type and the gradient's
    (bf16 parameters train in float32 from the second step). The step
    returns new trees; its inputs are left as they were. Parameters come
    from a ``torch.Generator`` seeded with ``seed`` (numbers differ from
    the JAX initialiser's). The head is the explicit-logits one unless
    ``MXTPU_FUSED_HEAD=1``, or unless the logits would exceed 8 GB in
    float32 and ``MXTPU_FUSED_HEAD`` is not ``0`` (read when the step is
    built)."""
    _no_mesh(mesh)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_transformer_params(gen, cfg, device=dev)
    opt_state = {"m": _tree_map(torch.zeros_like, params),
                 "v": _tree_map(torch.zeros_like, params),
                 "t": torch.zeros((), dtype=torch.float32, device=dev)}
    force = os.environ.get("MXTPU_FUSED_HEAD")
    V = cfg.vocab_size

    def big_logits(n_tokens):
        return n_tokens * V * 4 > 8 * 1024 ** 3

    def step(params, opt_state, tokens, labels):
        fused = force == "1" or (
            force != "0" and big_logits(tokens.shape[0] * tokens.shape[1]))
        loss, grads = transformer_loss_and_grads(
            params, tokens, labels, cfg, aux_weight=aux_weight,
            fused_head=fused)
        b1, b2, eps = 0.9, 0.999, 1e-8
        with torch.no_grad():
            t = opt_state["t"] + 1
            m = _tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g,
                          opt_state["m"], grads)
            v = _tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g,
                          opt_state["v"], grads)
            lr_t = learning_rate * torch.sqrt(1 - b2 ** t) / (1 - b1 ** t)
            # lr_t is a float32 tensor: the update, and so w, is float32
            new_p = _tree_map(
                lambda w, m_, v_: w.float() - lr_t * (
                    m_ / (torch.sqrt(v_) + eps)).float(), params, m, v)
        return new_p, {"m": m, "v": v, "t": t}, loss

    return step, params, opt_state


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


def _index1(v, dev):
    """A (1,) int64 index on ``dev`` from a Python int or an integer
    tensor of one element (a view when it already is one there)."""
    return torch.as_tensor(v, dtype=torch.int64, device=dev).reshape(1)


def transformer_prefill(params, tokens, cfg: TransformerConfig, cache,
                        slot, length):
    """Prompt pass for ONE request: tokens (1, T) (padded to its bucket;
    real extent ``length``) writes K/V for positions [0, T) into cache slot
    ``slot`` (in place) and returns (cache, logits (vocab,)) — the
    next-token logits at position ``length - 1``. Padded tail positions
    sit beyond the slot's valid length until a decode step overwrites
    them, so they are never attended to. ``slot`` and ``length`` are
    Python ints or one-element integer tensors on the tokens' device (the
    reference's traced ``i32`` scalars): the write is a tensor-indexed
    copy and the logits row an ``index_select``, so a CUDA graph captured
    on tensors serves any slot and length."""
    B, T = tokens.shape
    H, D = cfg.n_heads, cfg.head_dim
    dev = tokens.device
    slot_i = _index1(slot, dev)
    x = params["embed"][tokens] + params["pos_embed"][:T][None]
    for i, lp in enumerate(params["layers"]):
        h = _layernorm(x, lp["ln1_g"], lp["ln1_b"])
        q = (h @ lp["wq"]).reshape(B, T, H, D)
        k = (h @ lp["wk"]).reshape(B, T, H, D)
        v = (h @ lp["wv"]).reshape(B, T, H, D)
        kd = cache["k"].dtype
        cache["k"][i, :, :, :T].index_copy_(
            0, slot_i, k[0].transpose(0, 1).to(kd)[None])
        cache["v"][i, :, :, :T].index_copy_(
            0, slot_i, v[0].transpose(0, 1).to(kd)[None])
        attn = attention_reference(q, k, v, causal=True)
        x = x + attn.reshape(B, T, cfg.d_model) @ lp["wo"]
        x = _mlp(x, lp)
    x = _layernorm(x, params["final_ln_g"], params["final_ln_b"])
    last = x[0].index_select(0, _index1(length, dev) - 1)[0]
    logits = last @ params["embed"].T
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
    # int32 once a step: the kernel wrappers take it as it is, with no cast
    # kernel in each layer's call
    lengths = (positions + 1).to(torch.int32)
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
                              cache, pages, start, n_valid):
    """ONE chunk of one request's prompt pass over the paged pool: tokens
    (1, T) (the chunk, padded to its bucket; real extent ``n_valid``),
    ``pages`` (max_pages,) — the request's block-table row (unallocated
    tail entries = the trash page id), ``start`` — the absolute position
    of tokens[0]. Writes K/V for positions [start, start + n_valid)
    through the block table (in place) and returns (cache, logits
    (vocab,)) at chunk row ``n_valid - 1``. A whole prompt is
    ``start=0, n_valid=n``; chunked prefill calls this per chunk with
    advancing ``start`` (each chunk attends over the same fixed gathered
    span, masked by absolute position). ``start`` and ``n_valid`` are
    Python ints or one-element integer tensors on the tokens' device (the
    reference's traced ``i32`` scalars), so a CUDA graph captured on
    tensors serves any chunk of its bucket."""
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
    rows = torch.arange(T, device=dev)
    abs_pos = torch.as_tensor(start, dtype=torch.int64,
                              device=dev).reshape(()) + rows
    valid = rows < torch.as_tensor(n_valid, dtype=torch.int64,
                                   device=dev).reshape(())
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
    last = x[0].index_select(0, _index1(n_valid, dev) - 1)[0]
    logits = last @ params["embed"].T
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
    # int32 once a step: the kernel wrappers take it as it is, with no cast
    # kernel in each layer's call
    lengths = (positions + 1).to(torch.int32)
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
