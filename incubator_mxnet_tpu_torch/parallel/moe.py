"""Mixture-of-Experts FFN, on one device and expert-parallel.

Counterpart of the JAX package's ``parallel/moe.py``: Switch-style top-1
routing with a per-expert capacity, dense dispatch/combine tensors and
the load-balancing auxiliary loss (``top1_gating``, ``moe_layer_dense``),
and ``moe_layer_sharded``: tokens and experts split over the ``expert``
mesh axis, each rank routing its tokens to all experts, a tiled
all-to-all carrying every expert's rows to the rank that holds it and
back, and the aux loss averaged over the axis (:func:`moe_layer_local`
is that per-rank body).

Types follow the reference: the dispatch one-hots are float32, so the
expert inputs, the expert FFN and the combined output are computed in the
promotion of the activations' type with float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import matmul_promoted
from . import collectives as C
from .mesh import P, _need_mesh, shard_map

__all__ = ["top1_gating", "moe_layer_dense", "moe_layer_local",
           "moe_layer_sharded"]


def _one_hot(idx, n: int):
    return F.one_hot(idx, n).to(torch.float32)


def top1_gating(logits, capacity: int):
    """Top-1 routing with capacity: logits (tokens, n_experts). Returns
    (combine, dispatch, aux_loss); combine/dispatch are (tokens, experts,
    capacity) and a token past its expert's capacity is dropped."""
    _, n_experts = logits.shape
    probs = torch.softmax(logits, dim=-1)
    expert = probs.argmax(dim=-1)
    gate = probs.gather(1, expert[:, None])[:, 0]
    # position of each token within its expert's queue
    onehot = F.one_hot(expert, n_experts)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(dim=-1) - 1
    keep = pos < capacity
    gate = gate * keep
    disp = (_one_hot(expert, n_experts)[:, :, None]
            * _one_hot(pos.clamp(0, capacity - 1), capacity)[:, None, :])
    disp = disp * keep[:, None, None]
    combine = disp * gate[:, None, None]
    # load-balancing loss (Switch Transformer eq. 4)
    density = _one_hot(expert, n_experts).mean(dim=0)
    density_proxy = probs.mean(dim=0)
    aux_loss = (density * density_proxy).sum() * n_experts
    return combine, disp, aux_loss


def moe_layer_dense(x, gate_w, expert_w1, expert_b1, expert_w2, expert_b2,
                    capacity_factor: float = 1.25):
    """Single-device MoE FFN: x (tokens, d); expert_w1 (E, d, h), b1 (E, h);
    expert_w2 (E, h, d), b2 (E, d). Returns (y (tokens, d), aux_loss)."""
    n_tokens, _ = x.shape
    n_experts = expert_w1.shape[0]
    capacity = max(1, int(capacity_factor * n_tokens / n_experts))
    combine, disp, aux = top1_gating(matmul_promoted(x, gate_w), capacity)
    dt = torch.promote_types(x.dtype, disp.dtype)
    xe = torch.einsum("td,tec->ecd", x.to(dt), disp.to(dt))
    h = torch.relu(torch.einsum("ecd,edh->ech", xe, expert_w1.to(dt))
                   + expert_b1.to(dt)[:, None, :])
    ye = (torch.einsum("ech,ehd->ecd", h, expert_w2.to(dt))
          + expert_b2.to(dt)[:, None, :])
    y = torch.einsum("ecd,tec->td", ye, combine.to(dt))
    return y, aux


def moe_layer_local(x, gate_w, expert_w1, expert_b1, expert_w2, expert_b2,
                    n_experts: int, axis_name: str = "expert",
                    capacity_factor: float = 1.25, mesh=None):
    """Expert-parallel body: x (local tokens, d) and this rank's
    ``n_experts / axis size`` experts; the capacity is that of the local
    tokens over all ``n_experts``. Returns (y (local tokens, d), aux
    averaged over the axis)."""
    mesh = _need_mesh(mesh)
    n_tokens, _ = x.shape
    capacity = max(1, int(capacity_factor * n_tokens / n_experts))
    combine, disp, aux = top1_gating(matmul_promoted(x, gate_w), capacity)
    dt = torch.promote_types(x.dtype, disp.dtype)
    # every expert's rows from the local tokens: (E, capacity, d)
    xe = torch.einsum("td,tec->ecd", x.to(dt), disp.to(dt))
    # (E, cap, d) -> (E_local, n_shards * cap, d): this rank's experts'
    # rows from every rank
    xe = C.all_to_all(xe, axis_name, 0, 1, mesh)
    h = torch.relu(torch.einsum("ecd,edh->ech", xe, expert_w1.to(dt))
                   + expert_b1.to(dt)[:, None, :])
    ye = (torch.einsum("ech,ehd->ecd", h, expert_w2.to(dt))
          + expert_b2.to(dt)[:, None, :])
    ye = C.all_to_all(ye, axis_name, 1, 0, mesh)      # and back
    y = torch.einsum("ecd,tec->td", ye, combine.to(dt))
    return y, C.pmean(aux, axis_name, mesh)


def moe_layer_sharded(x, gate_w, expert_w1, expert_b1, expert_w2, expert_b2,
                      mesh=None, axis_name: str = "expert",
                      capacity_factor: float = 1.25):
    """Expert-parallel MoE on global tensors: the tokens of ``x`` and the
    experts split over ``axis_name`` (``mesh.shard_map``); returns the
    global (y, aux) on every rank."""
    mesh = _need_mesh(mesh)
    n_exp = expert_w1.shape[0]
    t, e = P(axis_name), P(axis_name)

    def body(xl, gw, w1, b1, w2, b2):
        return moe_layer_local(xl, gw, w1, b1, w2, b2, n_exp, axis_name,
                               capacity_factor, mesh)

    return shard_map(body, mesh, (t, P(), e, e, e, e), (t, P()))(
        x, gate_w, expert_w1, expert_b1, expert_w2, expert_b2)
