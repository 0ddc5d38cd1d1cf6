"""Sparse recommender models: factorization machine, wide & deep, DLRM.

Counterpart of ``incubator_mxnet_tpu/models/sparse_recommenders.py`` (ref:
example/sparse/factorization_machine/model.py,
example/sparse/wide_deep/model.py). Batches are (B, K) feature ids with
(B, K) values, the static-shape form of the reference's CSR batches; the
products are dense gathers and matmuls, and gradients of the
``Embedding(sparse_grad=True)`` tables stay row-sparse. ``DLRM`` and
``ShardedFactorizationMachine`` hold ``ShardedEmbedding`` tables and
implement ``sparse_ids``, the protocol of
``parallel.embedding.make_sharded_train_step``. Parameters carry across
from the JAX package by name (``gluon.utils.params_from_jax``).
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..gluon import nn
from ..gluon.block import HybridBlock
from ..ndarray.ndarray import invoke

__all__ = ["FactorizationMachine", "WideDeep", "DLRM",
           "ShardedFactorizationMachine"]


def _fm(vv, ww, w0, xval):
    """w0 + sum_i w_i x_i + 0.5 sum_f [(sum_i v_if x_i)^2
    - sum_i v_if^2 x_i^2] over (B, K) features."""
    linear = torch.sum(ww[..., 0] * xval, dim=1, keepdim=True)
    vx = vv * xval[..., None]                          # (B, K, F)
    inter = 0.5 * torch.sum(torch.square(torch.sum(vx, dim=1))
                            - torch.sum(torch.square(vx), dim=1),
                            dim=1, keepdim=True)
    return w0 + linear + inter


class FactorizationMachine(HybridBlock):
    """The factorization machine with the squared-sum trick (ref:
    example/sparse/factorization_machine/model.py). Inputs: (B, K) int
    feature ids (id 0 reserved for padding) and (B, K) float values."""

    def __init__(self, num_features: int, factor_size: int, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.v = nn.Embedding(num_features, factor_size,
                                  sparse_grad=True, prefix="v_")
            self.w = nn.Embedding(num_features, 1, sparse_grad=True,
                                  prefix="w_")
            self.w0 = self.params.get("w0", shape=(1,), init="zeros")

    def forward(self, ids, vals):
        return invoke(_fm, [self.v(ids), self.w(ids), self.w0.data(), vals],
                      "factorization_machine")


class WideDeep(HybridBlock):
    """Wide (linear over sparse ids) + deep (embeddings and an MLP over
    dense features), summed logits (ref: example/sparse/wide_deep/
    model.py)."""

    def __init__(self, num_linear_features: int,
                 embed_input_dims: Sequence[int], num_cont_features: int,
                 hidden_units: Sequence[int] = (8, 50, 100), classes: int = 2,
                 **kwargs):
        super().__init__(**kwargs)
        self._num_embed = len(embed_input_dims)
        with self.name_scope():
            self.linear = nn.Embedding(num_linear_features, classes,
                                       sparse_grad=True, prefix="linear_")
            self.linear_bias = self.params.get("linear_bias",
                                               shape=(classes,), init="zeros")
            self.embeds = []
            for i, dim in enumerate(embed_input_dims):
                emb = nn.Embedding(dim, hidden_units[0], sparse_grad=True,
                                   prefix=f"embed_{i}_")
                self.embeds.append(emb)
                self.register_child(emb)
            self.deep = nn.HybridSequential(prefix="deep_")
            with self.deep.name_scope():
                self.deep.add(nn.Dense(hidden_units[1], activation="relu"))
                self.deep.add(nn.Dense(hidden_units[2], activation="relu"))
                self.deep.add(nn.Dense(classes))

    def forward(self, wide_ids, wide_vals, dns_data):
        """wide_ids/vals (B, K): active linear feature ids and values;
        dns_data (B, num_embed + num_cont): embedding ids, then the
        continuous features."""
        wide_out = invoke(
            lambda rows, val, b: torch.sum(rows * val[..., None], dim=1) + b,
            [self.linear(wide_ids), wide_vals, self.linear_bias.data()],
            "wide_branch")
        feats = []
        for i, emb in enumerate(self.embeds):
            ids = dns_data[:, i:i + 1].astype("int32").reshape((-1,))
            feats.append(emb(ids))
        feats.append(dns_data[:, self._num_embed:])
        from ..ndarray import ndarray as _nd_mod
        return wide_out + self.deep(_nd_mod.concatenate(feats, axis=1))


def _interact(ev, dv):
    """DLRM's pairwise dot interaction: the bottom MLP's output beside the
    upper triangle of the (K+1, K+1) dot products."""
    z = torch.cat([dv[:, None, :], ev], dim=1)          # (B, K+1, D)
    prod = torch.bmm(z, z.transpose(1, 2))
    k = z.shape[1]
    iu, ju = torch.triu_indices(k, k, offset=1, device=z.device)
    return torch.cat([dv, prod[:, iu, ju]], dim=1)       # (B, D + K(K+1)/2)


class DLRM(HybridBlock):
    """DLRM: a sharded embedding table, a dense bottom MLP, the pairwise
    dot interaction and a top MLP (the 100M-row lane's model).

    Inputs: ``ids`` (B, K) categorical ids into ONE fused table (offsetting
    each feature is the caller's concern), ``dense_x`` (B, num_dense)."""

    def __init__(self, num_features: int, embed_dim: int = 16,
                 num_dense: int = 13, bottom_units: Sequence[int] = (64,),
                 top_units: Sequence[int] = (64, 1), mesh_axis=None,
                 **kwargs):
        super().__init__(**kwargs)
        self._embed_dim = int(embed_dim)
        with self.name_scope():
            self.embed = nn.ShardedEmbedding(num_features, embed_dim,
                                             mesh_axis=mesh_axis,
                                             prefix="embed_")
            self.bottom = nn.HybridSequential(prefix="bottom_")
            with self.bottom.name_scope():
                for u in bottom_units:
                    self.bottom.add(nn.Dense(u, activation="relu"))
                self.bottom.add(nn.Dense(embed_dim))
            self.top = nn.HybridSequential(prefix="top_")
            with self.top.name_scope():
                for u in top_units[:-1]:
                    self.top.add(nn.Dense(u, activation="relu"))
                self.top.add(nn.Dense(top_units[-1]))

    def sparse_ids(self, ids, dense_x):
        return {self.embed.weight.name: ids}

    def forward(self, ids, dense_x):
        feats = invoke(_interact, [self.embed(ids), self.bottom(dense_x)],
                       "dlrm_interact")
        return self.top(feats)


class ShardedFactorizationMachine(HybridBlock):
    """The factorization machine over ``ShardedEmbedding`` tables: the
    dedup gather and lazy row updates instead of dense sweeps of the
    whole table."""

    def __init__(self, num_features: int, factor_size: int, mesh_axis=None,
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.v = nn.ShardedEmbedding(num_features, factor_size,
                                         mesh_axis=mesh_axis, prefix="v_")
            self.w = nn.ShardedEmbedding(num_features, 1,
                                         mesh_axis=mesh_axis, prefix="w_")
            self.w0 = self.params.get("w0", shape=(1,), init="zeros")

    def sparse_ids(self, ids, vals):
        return {self.v.weight.name: ids, self.w.weight.name: ids}

    def forward(self, ids, vals):
        return invoke(_fm, [self.v(ids), self.w(ids), self.w0.data(), vals],
                      "sharded_fm")
