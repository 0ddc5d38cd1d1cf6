"""Ring attention: sequence parallelism over the ``seq`` mesh axis.

Counterpart of ``incubator_mxnet_tpu/parallel/ring_attention.py``. Each
rank holds a (B, T_local, H, D) block of q, k and v; K/V blocks travel
the ring (``collectives.ppermute``, rank i -> i + 1) while an online
softmax merges each block's partial attention. A causal ring compares
block offsets: after ``step`` hops a rank holds the block that started on
``(idx - step) % n``, which is its diagonal (step 0), wholly visible (it
started on an earlier rank) or wholly masked.

Two bodies, both per-rank programs (call them on a mesh, with the
sequence split over ``axis_name``):

* :func:`ring_attention`, plain PyTorch, differentiable through the
  collectives' own transposes;
* :func:`make_ring_flash_attention`, each block computed by the flash
  kernels (``ops/cuda/flash_attention.py``: ``flash_fwd`` forward,
  ``flash_bwd_dq`` and ``flash_bwd_dkv`` backward; their plain twins for
  CPU tensors). The forward merges the blocks' (out, lse) pairs by
  logaddexp weights. The backward is one ring from the global lse and
  delta = rowsum(dO * O): K/V rotate, each rank adds its dq of the block
  it holds and that block's dk/dv to accumulators that travel with it,
  and after n hops the accumulators are home. A (B, T, H, D) block is the
  kernels' packed (B, T, H*D) layout with ``n_heads=H``, and its lse is
  (B, T, H); the scale is passed to every block. Skip blocks launch
  nothing, but their K/V and dk/dv still travel. So rank r of a causal
  ring launches r + 1 blocks of each kernel a call.

``*_sharded`` take global (B, T, H, D) tensors and run the body under
``mesh.shard_map`` (every rank holds the global output).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import collectives as C
from .mesh import P, _need_mesh, shard_map

__all__ = ["attention_reference", "ring_attention", "ring_attention_sharded",
           "make_ring_flash_attention", "ring_flash_attention_sharded"]


def attention_reference(q, k, v, causal: bool = False,
                        scale: Optional[float] = None):
    """Plain attention. q, k, v: (B, T, H, D). A causal mask aligns the
    last query with the last key (``tril`` offset ``tk - tq``)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        mask = torch.ones((tq, tk), dtype=torch.bool,
                          device=q.device).tril(tk - tq)
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _ring_perm(n: int):
    return [(i, (i + 1) % n) for i in range(n)]


def _block_attn(q, k, v, q_off: int, k_off: int, scale: float, causal: bool):
    """One q block against one kv block: (unnormalised out, row sum,
    row max with masked rows at 0, raw row max)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        qpos = q_off + torch.arange(q.shape[1], device=q.device)
        kpos = k_off + torch.arange(k.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        logits = logits.masked_fill(~mask[None, None], float("-inf"))
    m = logits.amax(dim=-1)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(logits - m_safe[..., None])
    p = torch.where(torch.isneginf(logits), torch.zeros_like(p), p)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return o, p.sum(dim=-1), m_safe, m


def ring_attention(q, k, v, axis_name: str = "seq", causal: bool = False,
                   scale: Optional[float] = None, mesh=None):
    """Plain ring attention body: q, k, v are this rank's (B, T_local, H,
    D) blocks of a sequence split over ``axis_name``."""
    mesh = _need_mesh(mesh)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    n = mesh.axis_size(axis_name)
    idx = mesh.axis_index(axis_name)
    b, t, h, _ = q.shape
    perm = _ring_perm(n)
    o_acc = torch.zeros_like(q)
    l_acc = torch.zeros((b, h, t), dtype=q.dtype, device=q.device)
    m_acc = torch.full((b, h, t), float("-inf"), dtype=q.dtype,
                       device=q.device)
    k_cur, v_cur = k, v
    for step in range(n):
        src = (idx - step) % n
        o_b, l_b, m_safe, m_raw = _block_attn(q, k_cur, v_cur, idx * t,
                                              src * t, scale, causal)
        m_new = torch.maximum(m_acc, m_raw)
        m_new_safe = torch.where(torch.isneginf(m_new),
                                 torch.zeros_like(m_new), m_new)
        alpha = torch.where(torch.isneginf(m_acc), torch.zeros_like(m_acc),
                            torch.exp(m_acc - m_new_safe))
        beta = torch.where(torch.isneginf(m_raw), torch.zeros_like(m_raw),
                           torch.exp(m_safe - m_new_safe))
        l_acc = l_acc * alpha + l_b * beta
        o_acc = (o_acc * alpha.transpose(1, 2)[..., None]
                 + o_b * beta.transpose(1, 2)[..., None])
        m_acc = m_new
        if step < n - 1:
            kv = C.ppermute(torch.stack([k_cur, v_cur]), axis_name, perm,
                            mesh)
            k_cur, v_cur = kv[0], kv[1]
    denom = torch.where(l_acc == 0, torch.ones_like(l_acc), l_acc)
    return o_acc / denom.transpose(1, 2)[..., None]


def ring_attention_sharded(q, k, v, mesh=None, axis_name: str = "seq",
                           causal: bool = False,
                           scale: Optional[float] = None):
    """Global (B, T, H, D) tensors split on T over ``axis_name``, run by
    :func:`ring_attention`; the global output on every rank."""
    mesh = _need_mesh(mesh)
    spec = P(None, axis_name, None, None)
    return shard_map(
        lambda ql, kl, vl: ring_attention(ql, kl, vl, axis_name, causal,
                                          scale, mesh),
        mesh, (spec, spec, spec), spec)(q, k, v)


# ------------------------------------------------ ring on the flash kernels
def _causal_which(step: int, src: int, idx: int) -> int:
    """0 = diagonal (step 0), 1 = wholly visible (the held block started
    on an earlier rank), 2 = wholly masked."""
    if step == 0:
        return 0
    return 1 if src < idx else 2


def _merge(o1, l1, o2, l2):
    """Merge two normalised partial results by their lse: o (B, T, H, D)
    float32, l (B, T, H) float32."""
    l_new = torch.logaddexp(l1, l2)
    dead = torch.isneginf(l_new)
    w1 = torch.where(dead, torch.zeros_like(l1), torch.exp(l1 - l_new))
    w2 = torch.where(dead, torch.zeros_like(l2), torch.exp(l2 - l_new))
    return o1 * w1[..., None] + o2.float() * w2[..., None], l_new


def _block_fwd(q, k, v, causal: bool, scale: float):
    """(out (B, T, H, D), lse (B, T, H)) of one block on the flash kernel
    (CUDA tensors) or its twin (CPU tensors), packed layout."""
    from ..ops.cuda import flash_attention as fa
    b, t, h, d = q.shape
    impl = fa.flash_fwd if q.is_cuda else fa.flash_forward_reference
    out, lse = impl(q.reshape(b, t, h * d), k.reshape(b, -1, h * d),
                    v.reshape(b, -1, h * d), causal=causal, scale=scale,
                    n_heads=h)
    return out.view(b, t, h, d), lse


def _block_bwd(q, k, v, g, lse, delta, causal: bool, scale: float):
    """(dq, dk, dv) of one block, (B, T, H, D) each, from the global lse
    and delta."""
    from ..ops.cuda import flash_attention as fa
    b, t, h, d = q.shape
    args = (q.reshape(b, t, h * d), k.reshape(b, -1, h * d),
            v.reshape(b, -1, h * d), g.reshape(b, t, h * d), lse, delta)
    kw = dict(causal=causal, scale=scale, n_heads=h)
    if q.is_cuda:
        dq = fa.flash_bwd_dq(*args, **kw)
        dk, dv = fa.flash_bwd_dkv(*args, **kw)
    else:
        dq, dk, dv = fa.flash_backward_reference(*args, **kw)
    return dq.view(q.shape), dk.view(k.shape), dv.view(v.shape)


class _RingFlash(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, axis_name, causal, scale, mesh):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        n = mesh.axis_size(axis_name)
        idx = mesh.axis_index(axis_name)
        perm = _ring_perm(n)
        o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.full(q.shape[:3], float("-inf"), dtype=torch.float32,
                         device=q.device)
        kv = torch.stack([k, v])
        for step in range(n):
            src = (idx - step) % n
            which = _causal_which(step, src, idx) if causal else 1
            if which != 2:
                o_b, l_b = _block_fwd(q, kv[0], kv[1], which == 0, scale)
                o, lse = _merge(o, lse, o_b, l_b)
            if step < n - 1:
                kv = C.raw_ppermute(kv, axis_name, perm, mesh)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (axis_name, causal, scale, mesh)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        axis_name, causal, scale, mesh = ctx.args
        g = g.contiguous().to(q.dtype)
        n = mesh.axis_size(axis_name)
        idx = mesh.axis_index(axis_name)
        perm = _ring_perm(n)
        delta = (g.float() * out.float()).sum(dim=-1)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        # [k, v, dk, dv] of the block held, the accumulators float32
        kv = torch.stack([k, v])
        dkv = torch.zeros((2,) + tuple(k.shape), dtype=torch.float32,
                          device=k.device)
        for step in range(n):
            src = (idx - step) % n
            which = _causal_which(step, src, idx) if causal else 1
            if which != 2:
                dq_b, dk_b, dv_b = _block_bwd(q, kv[0], kv[1], g, lse, delta,
                                              which == 0, scale)
                dq += dq_b.float()
                dkv[0] += dk_b.float()
                dkv[1] += dv_b.float()
            # dk/dv travel every hop (n hops bring them home); K/V n - 1
            dkv = C.raw_ppermute(dkv, axis_name, perm, mesh)
            if step < n - 1:
                kv = C.raw_ppermute(kv, axis_name, perm, mesh)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None)


def make_ring_flash_attention(axis_name: str = "seq", causal: bool = False,
                              scale: Optional[float] = None, mesh=None):
    """The ring-flash body for this rank's (B, T_local, H, D) q, k, v
    blocks, differentiable (see the module's note)."""

    def ring_flash(q, k, v):
        s = scale if scale is not None else q.shape[-1] ** -0.5
        return _RingFlash.apply(q, k, v, axis_name, causal, float(s),
                                _need_mesh(mesh))

    return ring_flash


def ring_flash_attention_sharded(q, k, v, mesh=None, axis_name: str = "seq",
                                 causal: bool = False,
                                 scale: Optional[float] = None):
    """Global (B, T, H, D) tensors -> ring-flash over ``axis_name`` on T.
    Blocks that do not tile (``flash_kernel_viable``) take the plain ring,
    as in the reference."""
    from ..ops.cuda.flash_attention import flash_kernel_viable
    mesh = _need_mesh(mesh)
    t_local = q.shape[1] // mesh.axis_size(axis_name)
    if not flash_kernel_viable(t_local, t_local, q.shape[-1]):
        return ring_attention_sharded(q, k, v, mesh=mesh,
                                      axis_name=axis_name, causal=causal,
                                      scale=scale)
    fn = make_ring_flash_attention(axis_name, causal, scale, mesh)
    spec = P(None, axis_name, None, None)
    return shard_map(fn, mesh, (spec, spec, spec), spec)(q, k, v)
