"""Decode-step attention: plain PyTorch versions and the CUDA kernels.

Counterparts of the decode half of
``incubator_mxnet_tpu/ops/pallas/flash_attention.py``, with the same
signatures and layouts:

* contiguous cache — ``decode_attention_reference`` (plain),
  ``flash_decode_step`` (kernel), ``decode_attention`` (dispatch);
  q (S, H, d), k/v (S, H, C, d), lengths (S,);
* paged pool — ``paged_decode_attention_reference``,
  ``flash_decode_step_paged``, ``paged_decode_attention``;
  q (S, H, d), k/v (n_pages + 1, H, page_len, d), block_tables
  (S, max_pages) int32, lengths (S,).

The dispatchers take the plain version only for tensors on the CPU. For
CUDA tensors they launch the kernel, which raises on geometry it does not
take; nothing falls back. Each kernel wrapper counts its launches in a
plain int attribute (``flash_decode_step.launches``), bumped only where it
launches, so a run can show that its main path went through the kernel.

Both plain versions walk the cache in pages with the same online-softmax
update the kernels (and the TPU kernels) use: the query is scaled in its
own type, scores and the running max/sum/accumulator are float32, and the
softmax weights are cast to the value type before the P.V product.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .common import (NEG_INF, check_launch, current_stream_handle,
                     kernel_library, pick_block)

__all__ = ["decode_attention_reference", "flash_decode_step",
           "decode_attention", "paged_decode_attention_reference",
           "flash_decode_step_paged", "paged_decode_attention",
           "launch_counts", "reset_launch_counts"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BLOCK = 8192       # one page of scores lives in shared memory


# ------------------------------------------------------------ plain versions
def _walk_pages(qs, read_kv, lengths, block_k: int, nb: int):
    """Online-softmax attention of N single query rows over ``nb`` pages.
    ``qs`` (N, d) is the pre-scaled query in the input type;
    ``read_kv(i)`` gives page ``i`` as ((N, block_k, d), (N, block_k, d));
    ``lengths`` (N,) int. A row only takes pages below
    ceil(length / block_k), as the kernels' loop does. Returns (N, d) f32."""
    N, d = qs.shape
    dev = qs.device
    m = torch.full((N, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((N, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((N, d), dtype=torch.float32, device=dev)
    nb_eff = torch.clamp((lengths + block_k - 1) // block_k, max=nb)
    qf = qs.float()
    cols = torch.arange(block_k, device=dev)
    for i in range(nb):
        kb, vb = read_kv(i)
        s = torch.einsum("nd,nkd->nk", qf, kb.float())
        col = i * block_k + cols
        s = torch.where(col[None, :] < lengths[:, None], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=1, keepdim=True)
        acc_new = acc * corr + torch.einsum(
            "nk,nkd->nd", p.to(vb.dtype).float(), vb.float())
        live = (i < nb_eff)[:, None]
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live, acc_new, acc)
    return acc / torch.clamp(l, min=1e-30)


def _scaled_query(q, scale: float):
    # the reference multiplies by the scale cast to the query's type
    return (q * torch.tensor(scale, dtype=q.dtype, device=q.device))


def decode_attention_reference(q, k, v, lengths,
                               scale: Optional[float] = None,
                               block_k: int = 128):
    """Plain decode-step attention over a contiguous cache: q (S, H, d),
    k/v (S, H, C, d), lengths (S,). Returns (S, H, d) in q's type."""
    S, H, d = q.shape
    C = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    bk = pick_block(C, block_k)
    kc = k.reshape(S * H, C, d)
    vc = v.reshape(S * H, C, d)

    def read_kv(i):
        return kc[:, i * bk:(i + 1) * bk], vc[:, i * bk:(i + 1) * bk]

    lens = lengths.to(torch.int64).repeat_interleave(H)
    out = _walk_pages(_scaled_query(q.reshape(S * H, d), scale), read_kv,
                      lens, bk, C // bk)
    return out.reshape(S, H, d).to(q.dtype)


def paged_decode_attention_reference(q, k, v, block_tables, lengths,
                                     scale: Optional[float] = None):
    """Plain paged decode-step attention: q (S, H, d), k/v
    (n_pool, H, page_len, d), block_tables (S, max_pages), lengths (S,).
    Page ``p`` of slot ``s`` is pool page ``block_tables[s, p]`` (clamped
    into the pool, as the reference's dynamic slice does). Returns
    (S, H, d) in q's type."""
    S, H, d = q.shape
    n_pool, _, page_len, _ = k.shape
    max_pages = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    bt = block_tables.to(torch.int64).clamp(0, n_pool - 1)
    bt_cell = bt.repeat_interleave(H, dim=0)                  # (S*H, P)
    heads = torch.arange(H, device=q.device).repeat(S)        # (S*H,)

    def read_kv(i):
        pid = bt_cell[:, i]
        return k[pid, heads], v[pid, heads]

    lens = lengths.to(torch.int64).repeat_interleave(H)
    out = _walk_pages(_scaled_query(q.reshape(S * H, d), scale), read_kv,
                      lens, page_len, max_pages)
    return out.reshape(S, H, d).to(q.dtype)


# ---------------------------------------------------------------- kernels
def _check_operands(name: str, q, k, v, *idx):
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {q.dtype} not supported "
                        "(float32 or bfloat16)")
    d = q.shape[-1]
    if d < 8 or d > 256 or d & (d - 1):
        raise ValueError(f"{name}: head dim {d} not supported (a power of "
                         "two in [8, 256]; d % 8 == 0 is required)")
    if not q.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                         f"{q.device}")
    for t in (k, v) + idx:
        if t.device != q.device:
            raise ValueError(f"{name}: operands on {t.device} and "
                             f"{q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v dtypes differ ({q.dtype}, "
                        f"{k.dtype}, {v.dtype})")
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")


def _i32(t):
    return t.to(torch.int32).contiguous()


def flash_decode_step(q, k, v, lengths, scale: Optional[float] = None,
                      block_k: int = 128):
    """CUDA decode-step attention over a contiguous cache (replaces the
    Pallas ``flash_decode_step``): q (S, H, d), k/v (S, H, C, d) head-major
    per-slot caches, lengths (S,) valid extents. Returns (S, H, d)."""
    _check_operands("flash_decode_step", q, k, v, lengths)
    S, H, d = q.shape
    if k.shape[:2] != (S, H) or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"flash_decode_step: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)} disagree")
    C = k.shape[2]
    bk = pick_block(C, block_k)
    if bk > _MAX_BLOCK:
        raise ValueError(f"flash_decode_step: block {bk} > {_MAX_BLOCK}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    lens = _i32(lengths)
    out = torch.empty_like(q)
    lib = kernel_library()
    code = lib.mxt_flash_decode_step(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lens.data_ptr(), S, H, d, bk, C // bk, _DTYPE_CODE[q.dtype],
        float(scale), current_stream_handle(q))
    check_launch(code, "flash_decode_step")
    flash_decode_step.launches += 1
    return out


flash_decode_step.launches = 0


def flash_decode_step_paged(q, k, v, block_tables, lengths,
                            scale: Optional[float] = None):
    """CUDA paged decode-step attention (replaces the Pallas
    ``flash_decode_step_paged``): q (S, H, d), k/v (n_pool, H, page_len, d)
    page pools, block_tables (S, max_pages) int32 pool page ids, lengths
    (S,). Pages at or past a slot's length are never read. Returns
    (S, H, d)."""
    _check_operands("flash_decode_step_paged", q, k, v, block_tables,
                    lengths)
    S, H, d = q.shape
    n_pool, kh, page_len, kd = k.shape
    if kh != H or kd != d or v.shape != k.shape \
            or block_tables.dim() != 2 or block_tables.shape[0] != S:
        raise ValueError(
            f"flash_decode_step_paged: q {tuple(q.shape)}, k/v "
            f"{tuple(k.shape)}/{tuple(v.shape)} and block tables "
            f"{tuple(block_tables.shape)} disagree")
    if page_len < 1 or page_len > _MAX_BLOCK:
        raise ValueError(f"flash_decode_step_paged: page_len {page_len} "
                         f"outside [1, {_MAX_BLOCK}]")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    bt = _i32(block_tables)
    lens = _i32(lengths)
    out = torch.empty_like(q)
    lib = kernel_library()
    code = lib.mxt_flash_decode_step_paged(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        bt.data_ptr(), lens.data_ptr(), S, H, d, page_len, bt.shape[1],
        n_pool, _DTYPE_CODE[q.dtype], float(scale),
        current_stream_handle(q))
    check_launch(code, "flash_decode_step_paged")
    flash_decode_step_paged.launches += 1
    return out


flash_decode_step_paged.launches = 0


def launch_counts():
    """{kernel wrapper name: launches so far}."""
    return {"flash_decode_step": flash_decode_step.launches,
            "flash_decode_step_paged": flash_decode_step_paged.launches}


def reset_launch_counts() -> None:
    flash_decode_step.launches = 0
    flash_decode_step_paged.launches = 0


# -------------------------------------------------------------- dispatchers
def decode_attention(q, k, v, lengths, scale: Optional[float] = None,
                     block_k: int = 128):
    """Decode-step attention: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. q (S, H, d); k/v (S, H, C, d); lengths (S,).
    Returns (S, H, d)."""
    if q.is_cuda:
        return flash_decode_step(q, k, v, lengths, scale=scale,
                                 block_k=block_k)
    return decode_attention_reference(q, k, v, lengths, scale=scale,
                                      block_k=block_k)


def paged_decode_attention(q, k, v, block_tables, lengths,
                           scale: Optional[float] = None):
    """Paged decode-step attention: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. q (S, H, d); k/v (n_pages + 1, H,
    page_len, d); block_tables (S, max_pages); lengths (S,). Returns
    (S, H, d)."""
    if q.is_cuda:
        return flash_decode_step_paged(q, k, v, block_tables, lengths,
                                       scale=scale)
    return paged_decode_attention_reference(q, k, v, block_tables, lengths,
                                            scale=scale)
