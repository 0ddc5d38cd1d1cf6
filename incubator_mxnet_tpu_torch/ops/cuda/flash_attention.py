"""Flash attention: plain PyTorch versions and the CUDA kernels.

Counterpart of ``incubator_mxnet_tpu/ops/pallas/flash_attention.py``, with
the same signatures and layouts.

Training (forward with its log-sum-exp, and the two-pass backward):

* ``mha_reference`` — plain attention, (B, H, T, d);
* ``flash_forward_reference`` / ``flash_backward_reference`` — plain twins
  of the kernels ``flash_fwd`` / ``flash_bwd_dq`` + ``flash_bwd_dkv``;
* ``flash_attention_packed`` (q/k/v (B, T, H*d), the layout the QKV
  projection emits), ``flash_attention`` (head-major (B, H, T, d)) and
  ``flash_attention_with_lse``: the public ops, differentiable through a
  ``torch.autograd.Function`` whose backward forms delta = sum(g * out) per
  head in PyTorch, as the reference does outside its kernels, and then
  runs dq and dk/dv.

The kernels' route is chosen by type (:func:`flash_train_route`): float32
takes the split-bf16 ``mma.sync`` kernels (every float32 operand of a
product as three exact bf16 pieces, the six piece products float32 needs
per 16-deep stage, a fresh float32 partial each stage); bf16 takes the
Hopper kernels of ``csrc/flash_attention_sm90.cu`` ("wgmma"): the forward
streams K and V by TMA through a ring of stages, S = Q.K^T and O += P.V on
``wgmma``, the softmax in registers (:func:`flash_wgmma_plan`); dq streams
K and V past 128 query rows, dk/dv streams Q and dO past 128 keys, S and
dP on ``wgmma`` from shared memory and dS (and P) as register operands of
the gradient products (:func:`flash_wgmma_bwd_plan`). ``_route="fma"``
(private; the model never passes it) forces float32 onto the old FMA
kernels, and ``_route="wmma"`` bf16 onto the old WMMA kernels, which
``chip_smoke.py`` keeps as the yardsticks; the "mma" and "wgmma" routes'
launches are also counted in ``fn.sm90_launches``, and the "mma" route's
(float32 in three bf16 pieces) in ``fn.x3_launches`` as well.

Every training function takes both layouts: given ``n_heads`` its tensors
are packed (B, T, H*d) with lse/delta (B, T, H); without, head-major
(B, H, T, d) with lse/delta (B, H, T). The layout also picks the
reference's rounding, since its packed and head-major kernels round
differently: packed scales q once in its own type before Q.K^T and dq
once at the end; head-major scales the float32 scores and ds. In both, the
softmax weights are cast to v's type before P.V and ds to q's type before
its products, masking uses NEG_INF with the top-left causal rule
row >= col, and lse = m + log(max(l, 1e-30)).

Decode (one query row per slot and head over a KV cache):

* contiguous cache — ``decode_attention_reference`` (plain),
  ``flash_decode_step`` (kernel), ``decode_attention`` (dispatch);
  q (S, H, d), k/v (S, H, C, d), lengths (S,);
* paged pool — ``paged_decode_attention_reference``,
  ``flash_decode_step_paged``, ``paged_decode_attention``;
  q (S, H, d), k/v (n_pages + 1, H, page_len, d), block_tables
  (S, max_pages) int32, lengths (S,).

Both decode twins walk the cache in pages with the same online-softmax
update the kernels (and the TPU kernels) use: the query is scaled in its
own type, scores and the running max/sum/accumulator are float32, and the
softmax weights are cast to the value type before the P.V product. The
kernels split each (slot, head) over the cache length
(:func:`decode_split_plan`): each split runs that update over its own
tiles, and the live splits are combined in index order in float32, so the
result is the same from run to run. ``_route="simple"`` (private; the
model never passes it) takes the first design instead, one block per
(slot, head), kept as the yardstick. Launches of the split route are also
counted in ``fn.sm90_launches``.

The dispatchers take the plain version only for tensors on the CPU. For
CUDA tensors they launch the kernel, which raises on geometry it does not
take; nothing falls back. Each kernel wrapper counts its launches in a
plain int attribute (``flash_fwd.launches``), bumped only where it
launches, so a run can show that its main path went through the kernel;
``launch_counts`` (from ``common``) reads every kernel's count.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from .common import (NEG_INF, check_launch, counted_kernel,
                     current_stream_handle, kernel_library, launch_counts,
                     pick_block, reset_launch_counts, ticket_buffer)

__all__ = ["mha_reference", "flash_forward_reference",
           "flash_backward_reference", "flash_fwd", "flash_bwd_dq",
           "flash_bwd_dkv", "flash_attention_packed", "flash_attention",
           "flash_attention_with_lse", "flash_attention_packed_viable",
           "flash_kernel_viable", "flash_train_route", "flash_wgmma_plan",
           "flash_wgmma_bwd_plan",
           "decode_attention_reference", "flash_decode_step",
           "decode_attention", "decode_split_plan",
           "paged_decode_attention_reference", "flash_decode_step_paged",
           "paged_decode_attention", "launch_counts", "reset_launch_counts"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BLOCK = 8192       # one page of scores lives in shared memory
_FLASH_HEAD_DIMS = (32, 64, 128)
_FLASH_TILE = 64        # q and k rows per tile in the kernels and twins


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
    return (q * torch.full((), scale, dtype=q.dtype, device=q.device))


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


# The split route's plan constants: decode_attention.cu's kSplit* values.
_SPLIT_THREADS = 128
_SPLIT_TILE_BYTES = 8192      # most bytes of one K (or V) tile
_SPLIT_CHUNK_TILES = 4        # most tiles a split
_SPLIT_TARGET_BLOCKS = 1056   # 132 SMs x 8 blocks
_SPLIT_BAR_BYTES = 128
_SMEM_LIMIT = 232448          # 227 KB a block



@functools.lru_cache(maxsize=256)
def decode_split_plan(cells: int, page_len: int, n_pages: int, d: int,
                      itemsize: int):
    """The split kernels' plan from static shapes alone (the lengths stay
    on the device): a cell's span is ``n_pages`` pages of ``page_len`` rows
    (contiguous: one page of the cache length), cut into tiles of
    ``tile_rows`` rows inside a page, at most ``_SPLIT_TILE_BYTES`` a tile;
    a split takes ``tiles_per_split`` consecutive tiles, as few as give
    about ``_SPLIT_TARGET_BLOCKS`` blocks over the ``cells`` (slot, head)
    cells, at most ``_SPLIT_CHUNK_TILES``. Returns (tile_rows,
    tiles_per_split, n_split, shared-memory bytes of a block)."""
    rows = max(1, min(page_len, _SPLIT_TILE_BYTES // (d * itemsize)))
    n_tiles = n_pages * -(-page_len // rows)
    want = -(-_SPLIT_TARGET_BLOCKS // max(cells, 1))    # splits a cell
    tps = min(_SPLIT_CHUNK_TILES, max(1, -(-n_tiles // want)))
    n_split = -(-n_tiles // tps)
    smem = (_SPLIT_BAR_BYTES + tps * (2 * rows * d * itemsize + rows * 4)
            + (_SPLIT_THREADS // 32) * (d + 1) * 4)
    return rows, tps, n_split, smem


def _decode_split(kern, name: str, q, k, v, lens, bt, page_len: int,
                  n_pages: int, n_pool: int, scale: float):
    """Launch the split route on checked operands; returns the output."""
    S, H, d = q.shape
    cells = S * H
    rows, tps, n_split, _ = decode_split_plan(cells, page_len, n_pages, d,
                                              q.element_size())
    if cells * n_split >= 2 ** 31:
        raise ValueError(f"{name}: {cells} cells x {n_split} splits is "
                         "too many blocks")
    out = torch.empty_like(q)
    ws = (torch.empty(cells * n_split * (d + 2), dtype=torch.float32,
                      device=q.device) if n_split > 1 else None)
    stream = current_stream_handle(q)
    tickets = (ticket_buffer("decode", q, stream, cells)
               if n_split > 1 else None)
    code = kernel_library().mxt_decode_split(
        int(bt is not None), _DTYPE_CODE[q.dtype], q.data_ptr(),
        k.data_ptr(), v.data_ptr(), out.data_ptr(), lens.data_ptr(),
        None if bt is None else bt.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if tickets is None else tickets.data_ptr(), S, H, d, page_len,
        n_pages, n_pool, rows, tps, n_split, float(scale), stream)
    check_launch(code, name)
    kern.launches += 1
    kern.sm90_launches += 1
    return out


def _check_route(name: str, route):
    if route not in (None, "simple"):
        raise ValueError(f"{name}: _route {route!r} (only \"simple\", for "
                         "comparisons)")


@counted_kernel
def flash_decode_step(q, k, v, lengths, scale: Optional[float] = None,
                      block_k: int = 128, _route: Optional[str] = None):
    """CUDA decode-step attention over a contiguous cache (replaces the
    Pallas ``flash_decode_step``): q (S, H, d), k/v (S, H, C, d) head-major
    per-slot caches, lengths (S,) valid extents. Returns (S, H, d).

    The split kernels take the cache in tiles of their own plan
    (:func:`decode_split_plan`), so ``block_k`` only sets the pages of the
    private ``_route="simple"`` (the first design, kept as the yardstick
    and counted in ``launches`` but not in ``sm90_launches``)."""
    _check_route("flash_decode_step", _route)
    _check_operands("flash_decode_step", q, k, v, lengths)
    S, H, d = q.shape
    if k.shape[:2] != (S, H) or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"flash_decode_step: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)} disagree")
    C = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    lens = _i32(lengths)
    if _route != "simple":
        return _decode_split(flash_decode_step, "flash_decode_step", q, k,
                             v, lens, None, C, 1, 1, scale)
    bk = pick_block(C, block_k)
    if bk > _MAX_BLOCK:
        raise ValueError(f"flash_decode_step: block {bk} > {_MAX_BLOCK}")
    out = torch.empty_like(q)
    lib = kernel_library()
    code = lib.mxt_flash_decode_step(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lens.data_ptr(), S, H, d, bk, C // bk, _DTYPE_CODE[q.dtype],
        float(scale), current_stream_handle(q))
    check_launch(code, "flash_decode_step")
    flash_decode_step.launches += 1
    return out


@counted_kernel
def flash_decode_step_paged(q, k, v, block_tables, lengths,
                            scale: Optional[float] = None,
                            _route: Optional[str] = None):
    """CUDA paged decode-step attention (replaces the Pallas
    ``flash_decode_step_paged``): q (S, H, d), k/v (n_pool, H, page_len, d)
    page pools, block_tables (S, max_pages) int32 pool page ids, lengths
    (S,). Pages at or past a slot's length are never read. Returns
    (S, H, d). ``_route`` as in :func:`flash_decode_step`."""
    _check_route("flash_decode_step_paged", _route)
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
    if _route != "simple":
        return _decode_split(flash_decode_step_paged,
                             "flash_decode_step_paged", q, k, v, lens, bt,
                             page_len, bt.shape[1], n_pool, scale)
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


# ------------------------------------------------- training: plain versions
def mha_reference(q, k, v, causal: bool = False,
                  scale: Optional[float] = None):
    """Plain attention over (B, H, T, d): scores in q's type, then
    float32, masked top-left (row >= col) with NEG_INF; the softmax is cast
    to q's type before P.V."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if causal:
        qlen, klen = s.shape[-2], s.shape[-1]
        keep = (torch.arange(qlen, device=q.device)[:, None]
                >= torch.arange(klen, device=q.device)[None, :])
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), v)


def _head_major(t, n_heads: Optional[int]):
    """A packed (B, T, H*d) tensor as a (B, H, T, d) view; head-major
    tensors pass through."""
    if n_heads is None:
        return t
    B, T, HD = t.shape
    return t.view(B, T, n_heads, HD // n_heads).permute(0, 2, 1, 3)


def _packed(t, n_heads: Optional[int]):
    """Inverse of :func:`_head_major` (a new contiguous tensor)."""
    if n_heads is None:
        return t
    B, H, T, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(B, T, H * d)


def _rows_head_major(t, n_heads: Optional[int]):
    """lse/delta: packed (B, T, H) -> (B, H, T)."""
    return t if n_heads is None else t.permute(0, 2, 1)


def _scores(qs, k, causal: bool, s_mul: float, k0: int = 0):
    """float32 scores of the (pre-scaled or not) query against k rows
    [k0, k0 + k.shape[2]), scaled by ``s_mul`` and masked top-left."""
    s = torch.matmul(qs, k.float().transpose(-1, -2))
    if s_mul != 1.0:
        s = s * s_mul
    if causal:
        rows = torch.arange(qs.shape[2], device=qs.device)[:, None]
        cols = k0 + torch.arange(k.shape[2], device=qs.device)[None, :]
        s = torch.where(rows >= cols, s, torch.full_like(s, NEG_INF))
    return s


def _query_and_scale(q, scale: float, prescaled: bool):
    """(query as float32, the factor left for the scores)."""
    if prescaled:
        return _scaled_query(q, scale).float(), 1.0
    return q.float(), scale


def flash_forward_reference(q, k, v, causal: bool = False,
                            scale: Optional[float] = None,
                            n_heads: Optional[int] = None):
    """Plain twin of :func:`flash_fwd`: blockwise online-softmax attention
    over 64-row k tiles in the kernels' roundings. Packed (with
    ``n_heads``) or head-major tensors; returns (out in q's type, lse
    float32)."""
    qh, kh, vh = (_head_major(t, n_heads) for t in (q, k, v))
    if scale is None:
        scale = 1.0 / math.sqrt(qh.shape[-1])
    qs, s_mul = _query_and_scale(qh, scale, n_heads is not None)
    B, H, sq, d = qh.shape
    m = torch.full((B, H, sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, H, sq, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, kh.shape[2], _FLASH_TILE):
        kb = kh[:, :, k0:k0 + _FLASH_TILE]
        vb = vh[:, :, k0:k0 + _FLASH_TILE]
        s = _scores(qs, kb, causal, s_mul, k0)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(vb.dtype).float(), vb.float())
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    out = _packed((acc / l_safe).to(q.dtype), n_heads)
    lse = (m + torch.log(l_safe))[..., 0]
    return out, (lse.permute(0, 2, 1).contiguous() if n_heads is not None
                 else lse)


def flash_backward_reference(q, k, v, dout, lse, delta, causal: bool = False,
                             scale: Optional[float] = None,
                             n_heads: Optional[int] = None):
    """Plain twin of :func:`flash_bwd_dq` and :func:`flash_bwd_dkv`: (dq,
    dk, dv) from the forward's lse and delta = sum(dout * out) per head, in
    the kernels' roundings. Layouts as :func:`flash_forward_reference`."""
    qh, kh, vh, gh = (_head_major(t, n_heads) for t in (q, k, v, dout))
    lse_h = _rows_head_major(lse, n_heads)[..., None]
    delta_h = _rows_head_major(delta, n_heads)[..., None]
    if scale is None:
        scale = 1.0 / math.sqrt(qh.shape[-1])
    prescaled = n_heads is not None
    qs, s_mul = _query_and_scale(qh, scale, prescaled)
    p = torch.exp(_scores(qs, kh, causal, s_mul) - lse_h)
    dp = torch.matmul(gh.float(), vh.float().transpose(-1, -2))
    ds = p * (dp - delta_h)
    if not prescaled:
        ds = ds * scale
    ds = ds.to(q.dtype).float()
    dq = torch.matmul(ds, kh.float())
    if prescaled:
        dq = dq * scale
    dk = torch.matmul(ds.transpose(-1, -2), qs)
    dv = torch.matmul(p.to(dout.dtype).float().transpose(-1, -2),
                      gh.float())
    return (_packed(dq.to(q.dtype), n_heads), _packed(dk.to(k.dtype), n_heads),
            _packed(dv.to(v.dtype), n_heads))


# ------------------------------------------------------ training: kernels
def _flash_geometry(name: str, q, k, v, n_heads: Optional[int], *rest):
    """Checks the operands of a training kernel; returns (layout code, B,
    H, sq, sk, d)."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {q.dtype} not supported "
                        "(float32 or bfloat16)")
    if not q.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                         f"{q.device}")
    if n_heads is not None:
        if q.dim() != 3 or q.shape[2] % n_heads:
            raise ValueError(f"{name}: packed q {tuple(q.shape)} is not "
                             f"(B, T, {n_heads} * d)")
        layout, (B, sq, HD), H = 0, q.shape, n_heads
        d, sk = HD // H, k.shape[1]
        kv_shape = (B, sk, HD)
    else:
        if q.dim() != 4:
            raise ValueError(f"{name}: head-major q {tuple(q.shape)} is not "
                             "(B, H, T, d)")
        layout, (B, H, sq, d), sk = 1, q.shape, k.shape[2]
        kv_shape = (B, H, sk, d)
    if d not in _FLASH_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not supported "
                         f"{_FLASH_HEAD_DIMS}")
    if tuple(k.shape) != kv_shape or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)} disagree")
    for t in (k, v) + rest:
        if t.device != q.device:
            raise ValueError(f"{name}: operands on {t.device} and "
                             f"{q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v dtypes differ ({q.dtype}, "
                        f"{k.dtype}, {v.dtype})")
    for t in (q, k, v) + rest:
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")
    return layout, B, H, sq, sk, d


def _check_rows(name: str, dout, lse, delta, q, layout, B, H, sq):
    rows = (B, sq, H) if layout == 0 else (B, H, sq)
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"{name}: dout {tuple(dout.shape)} {dout.dtype} "
                         f"does not match q")
    for t in (lse, delta):
        if tuple(t.shape) != rows or t.dtype != torch.float32:
            raise ValueError(f"{name}: lse/delta must be float32 {rows}, "
                             f"got {tuple(t.shape)} {t.dtype}")


def flash_train_route(dtype, kernel: str = "flash_fwd") -> str:
    """The route of the training kernel ``kernel`` ("flash_fwd",
    "flash_bwd_dq" or "flash_bwd_dkv") for q/k/v of ``dtype``: "mma" for
    float32 (the split-bf16 ``mma.sync`` kernels), "wgmma" for bf16 (the
    Hopper kernels of ``csrc/flash_attention_sm90.cu``, forward and
    backward alike)."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"flash attention: dtype {dtype} not supported "
                        "(float32 or bfloat16)")
    if kernel not in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        raise ValueError(f"flash attention: no training kernel {kernel!r}")
    return "mma" if dtype == torch.float32 else "wgmma"


# The bf16 forward's plan: flash_attention_sm90.cu's kFRows, kFKeys,
# kFStages and kFThreads, and its shared memory (FlashPlan)
_WGMMA_ROWS, _WGMMA_KEYS, _WGMMA_STAGES = 128, 64, 3
_WGMMA_THREADS = 256


def flash_wgmma_plan(d: int) -> dict:
    """The Hopper bf16 forward's block at head dim ``d``: 128 query rows,
    two warpgroups of 64 (one thread also issues the loads), K and V tiles
    of 64 keys in a ring of three stages, every tile as column blocks of
    128-byte swizzled rows (64-byte ones at d 32); shared memory the Q
    tile, the ring and 1 KB of alignment; two blocks an SM at d 32 and 64,
    one at d 128 (registers)."""
    if d not in _FLASH_HEAD_DIMS:
        raise ValueError(f"flash_wgmma_plan: head dim {d} not supported "
                         f"{_FLASH_HEAD_DIMS}")
    q_bytes = _WGMMA_ROWS * d * 2
    kv_bytes = _WGMMA_KEYS * d * 2
    return {"rows": _WGMMA_ROWS, "keys": _WGMMA_KEYS,
            "stages": _WGMMA_STAGES, "threads": _WGMMA_THREADS,
            "row_bytes": 128 if d >= 64 else 64,
            "smem_bytes": q_bytes + _WGMMA_STAGES * 2 * kv_bytes + 1024,
            "blocks": 2 if d <= 64 else 1}


# The bf16 backward's plan: flash_attention_sm90.cu's FlashBwdPlan
# (kBStages, kDqBlocks, kDqCols, kDkvBlocks, kDkvCols) and its shared
# memory
_WGMMA_BWD_STAGES = 3


def flash_wgmma_bwd_plan(d: int) -> dict:
    """The Hopper bf16 backward's blocks at head dim ``d``: dq, 128 query
    rows (two warpgroups of 64; Q and dO loaded once) against K and V
    tiles of 64 keys; dk/dv, 128 keys (K and V loaded once) against Q and
    dO tiles of 64 queries; both streams in a ring of three stages, tiles
    as the forward's (:func:`flash_wgmma_plan`); shared memory the block's
    own two 128-row tiles, the ring and 1 KB of alignment. Registers set
    the blocks an SM (two up to d 64, one at d 128) and the columns of one
    S (and dP) product, a part of the 64-wide tile where the whole one
    would not fit two blocks: ``dq_cols`` keys (32 at d 64), ``dkv_cols``
    queries (32 at d 32, 16 at d 64)."""
    fwd = flash_wgmma_plan(d)
    return {"rows": _WGMMA_ROWS, "keys": _WGMMA_KEYS,
            "queries": _WGMMA_KEYS, "stages": _WGMMA_BWD_STAGES,
            "threads": _WGMMA_THREADS, "row_bytes": fwd["row_bytes"],
            "smem_bytes": (2 * _WGMMA_ROWS * d * 2 + _WGMMA_BWD_STAGES * 2
                           * _WGMMA_KEYS * d * 2 + 1024),
            "dq_blocks": 2 if d <= 64 else 1,
            "dq_cols": 32 if d == 64 else 64,
            "dkv_blocks": 2 if d <= 64 else 1,
            "dkv_cols": {32: 32, 64: 16}.get(d, 64)}


def _route_of(name: str, q, route) -> str:
    """A training kernel's route: its type's (:func:`flash_train_route`),
    or "fma" (float32) / "wmma" (bf16) when ``route`` forces the old
    kernel."""
    if route is None:
        return flash_train_route(q.dtype, name)
    if (route, q.dtype) not in (("fma", torch.float32),
                                ("wmma", torch.bfloat16)):
        raise ValueError(f"{name}: _route {route!r} (only \"fma\", for "
                         "float32, or \"wmma\", for bf16)")
    return route


def _count(kern, route: str) -> None:
    kern.launches += 1
    if route in ("mma", "wgmma"):
        kern.sm90_launches += 1
    if route == "mma":
        kern.x3_launches += 1


@counted_kernel
def flash_fwd(q, k, v, causal: bool = False, scale: Optional[float] = None,
              n_heads: Optional[int] = None, _route: Optional[str] = None):
    """CUDA flash-attention forward (replaces the Pallas ``_fwd_packed``,
    ``_fwd_resident`` and ``_fwd_streamed``). Packed (B, T, H*d) with
    ``n_heads`` or head-major (B, H, T, d); head dim 32, 64 or 128.
    Returns (out like q, lse float32 (B, T, H) packed / (B, H, T)). The
    route is :func:`flash_train_route`'s; ``_route="fma"`` (float32) and
    ``_route="wmma"`` (bf16) force the old kernels."""
    layout, B, H, sq, sk, d = _flash_geometry("flash_fwd", q, k, v, n_heads)
    route = _route_of("flash_fwd", q, _route)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    lse = torch.empty((B, sq, H) if layout == 0 else (B, H, sq),
                      dtype=torch.float32, device=q.device)
    lib = kernel_library()
    if route == "wgmma":
        code = lib.mxt_flash_fwd_sm90(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, H, sq, sk, d, layout, int(causal),
            float(scale), current_stream_handle(q))
    else:
        code = lib.mxt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, H, sq, sk, d, layout, int(causal),
            _DTYPE_CODE[q.dtype], int(route == "fma"), float(scale),
            current_stream_handle(q))
    check_launch(code, "flash_fwd")
    _count(flash_fwd, route)
    return out, lse


@counted_kernel
def flash_bwd_dq(q, k, v, dout, lse, delta, causal: bool = False,
                 scale: Optional[float] = None,
                 n_heads: Optional[int] = None,
                 _route: Optional[str] = None):
    """CUDA dq of flash attention from the forward's lse and delta
    (replaces the Pallas ``_dq_pass_*`` and the dq half of
    ``_bwd_fused_packed``). Layouts as :func:`flash_fwd`; the route is
    :func:`flash_train_route`'s, ``_route`` as in :func:`flash_fwd`."""
    layout, B, H, sq, sk, d = _flash_geometry("flash_bwd_dq", q, k, v,
                                              n_heads, dout, lse, delta)
    _check_rows("flash_bwd_dq", dout, lse, delta, q, layout, B, H, sq)
    route = _route_of("flash_bwd_dq", q, _route)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    dq = torch.empty_like(q)
    lib = kernel_library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H, sq, sk, d,
            layout, int(causal))
    if route == "wgmma":
        code = lib.mxt_flash_bwd_dq_sm90(*args, float(scale),
                                         current_stream_handle(q))
    else:
        code = lib.mxt_flash_bwd_dq(*args, _DTYPE_CODE[q.dtype],
                                    int(route == "fma"), float(scale),
                                    current_stream_handle(q))
    check_launch(code, "flash_bwd_dq")
    _count(flash_bwd_dq, route)
    return dq


@counted_kernel
def flash_bwd_dkv(q, k, v, dout, lse, delta, causal: bool = False,
                  scale: Optional[float] = None,
                  n_heads: Optional[int] = None,
                  _route: Optional[str] = None):
    """CUDA dk and dv of flash attention from the forward's lse and delta
    (replaces the Pallas ``_dkv_pass_*`` and the dk/dv half of
    ``_bwd_fused_packed``). Layouts as :func:`flash_fwd`; the route is
    :func:`flash_train_route`'s, ``_route`` as in :func:`flash_fwd`.
    Returns (dk, dv)."""
    layout, B, H, sq, sk, d = _flash_geometry("flash_bwd_dkv", q, k, v,
                                              n_heads, dout, lse, delta)
    _check_rows("flash_bwd_dkv", dout, lse, delta, q, layout, B, H, sq)
    route = _route_of("flash_bwd_dkv", q, _route)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = kernel_library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B,
            H, sq, sk, d, layout, int(causal))
    if route == "wgmma":
        code = lib.mxt_flash_bwd_dkv_sm90(*args, float(scale),
                                          current_stream_handle(q))
    else:
        code = lib.mxt_flash_bwd_dkv(*args, _DTYPE_CODE[q.dtype],
                                     int(route == "fma"), float(scale),
                                     current_stream_handle(q))
    check_launch(code, "flash_bwd_dkv")
    _count(flash_bwd_dkv, route)
    return dk, dv


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


# -------------------------------------------------- training: public ops
def _flash_forward(q, k, v, causal, scale, n_heads):
    impl = flash_fwd if q.is_cuda else flash_forward_reference
    return impl(q, k, v, causal=causal, scale=scale, n_heads=n_heads)


class _FlashAttention(torch.autograd.Function):
    """Flash attention with the reference's custom VJP: the forward saves
    (q, k, v, out, lse); the backward forms delta in PyTorch and runs dq
    and dk/dv. CUDA tensors go through the kernels, CPU tensors through
    their plain twins."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, n_heads):
        out, lse = _flash_forward(q, k, v, causal, scale, n_heads)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, n_heads)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, n_heads = ctx.args
        g = g.contiguous()
        prod = g.float() * out.float()
        if n_heads is None:
            delta = prod.sum(dim=-1)
        else:
            B, T, HD = prod.shape
            delta = prod.view(B, T, n_heads, HD // n_heads).sum(dim=-1)
        kw = dict(causal=causal, scale=scale, n_heads=n_heads)
        if q.is_cuda:
            dq = flash_bwd_dq(q, k, v, g, lse, delta, **kw)
            dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, **kw)
        else:
            dq, dk, dv = flash_backward_reference(q, k, v, g, lse, delta,
                                                  **kw)
        return dq, dk, dv, None, None, None


def flash_attention_packed_viable(T: int, HD: int, H: int,
                                  B: int = 32) -> bool:
    """Can the packed path serve this shape? The reference's layout rules:
    a packed row width that is a multiple of 128, a head dim that is a
    multiple of 8, and a sequence that tiles (T % 8 == 0). ``B`` is kept
    for the reference's signature; the TPU's VMEM budget, which it fed,
    has no counterpart here."""
    if HD % 128 or H <= 0 or HD % H or (HD // H) % 8:
        return False
    return T % 8 == 0 and pick_block(T, 512) >= 8


def flash_kernel_viable(sq: int, sk: int, d: int, itemsize: int = 2) -> bool:
    """Do both sequence extents tile (a power-of-two block >= 8 divides
    them)? The reference's shape rule; ``d`` and ``itemsize`` are kept for
    its signature."""
    return pick_block(sq, 512) >= 8 and pick_block(sk, 512) >= 8


def flash_attention_packed(q, k, v, n_heads: int, causal: bool = False,
                           scale: Optional[float] = None):
    """Attention over PACKED (B, T, H*d) tensors, the layout the QKV
    projection emits. Returns (B, T, H*d); differentiable."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1] // n_heads)
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal, scale, n_heads)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None):
    """Blockwise attention over head-major (B, H, T, d) tensors;
    differentiable. Shapes whose sequence does not tile go to
    :func:`mha_reference`, as in the reference."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not flash_kernel_viable(q.shape[2], k.shape[2], q.shape[-1]):
        return mha_reference(q, k, v, causal=causal, scale=scale)
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal, scale, None)


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             scale: Optional[float] = None):
    """(out, lse) over head-major (B, H, T, d) tensors, for merging
    blocks by their lse (ring attention). Raises ValueError when the
    sequence does not tile (check :func:`flash_kernel_viable` first)."""
    if not flash_kernel_viable(q.shape[2], k.shape[2], q.shape[-1]):
        raise ValueError(
            f"flash kernel cannot run sq={q.shape[2]} sk={k.shape[2]} "
            f"d={q.shape[-1]}; use the plain attention")
    return _flash_forward(q.contiguous(), k.contiguous(), v.contiguous(),
                          causal, scale, None)
