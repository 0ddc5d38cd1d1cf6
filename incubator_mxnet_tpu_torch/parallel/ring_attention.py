"""Plain attention, the reference the prefill path and the training
step's ``use_flash_attention=False`` route use.

Only ``attention_reference`` is ported so far; the sequence-parallel ring
variants wait for the distributed slice (``ROADMAP.md`` A10).
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["attention_reference"]


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
