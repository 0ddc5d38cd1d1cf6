"""Contrib basic layers.

Counterpart of ``incubator_mxnet_tpu/gluon/contrib/nn/basic_layers.py``
(ref: python/mxnet/gluon/contrib/nn/basic_layers.py — Concurrent,
HybridConcurrent, Identity, SparseEmbedding, SyncBatchNorm backed by
src/operator/contrib/sync_batch_norm-inl.h, PixelShuffle2D).
``SparseEmbedding``'s gradient is row-sparse (``Parameter.
row_sparse_grad``). ``SyncBatchNorm`` is a BatchNorm with the reference's
statistics (E[x^2] - E[x]^2), averaged over the current mesh's
``axis_name`` ranks when there is one.
"""
from __future__ import annotations

import torch

from ... import block as _block
from ...block import Block, HybridBlock
from ...nn.basic_layers import BatchNorm, HybridSequential, Sequential

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm", "PixelShuffle2D"]


class Concurrent(Sequential):
    """Parallel branches, their outputs concatenated along ``axis`` (ref:
    basic_layers.py Concurrent)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        out = [block(x) for block in self._children.values()]
        return _block._nd_mod_proxy.Concat(*out, dim=self.axis)


class HybridConcurrent(HybridSequential):
    """(ref: basic_layers.py HybridConcurrent)"""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        out = [block(x) for block in self._children.values()]
        return _block._nd_mod_proxy.Concat(*out, dim=self.axis)


class Identity(HybridBlock):
    """(ref: basic_layers.py Identity)"""

    def hybrid_forward(self, F, x):
        return x


class SparseEmbedding(Block):
    """Embedding with a row-sparse gradient (ref: basic_layers.py
    SparseEmbedding; the sparse_grad path of
    src/operator/tensor/indexing_op.h)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype, "sparse_grad": True}
        self.weight = self.params.get("weight", shape=(input_dim, output_dim),
                                      init=weight_initializer, dtype=dtype,
                                      grad_stype="row_sparse")

    def forward(self, x):
        return _block._nd_mod_proxy.Embedding(x, self.weight.data(),
                                              **self._kwargs)

    def __repr__(self):
        return f"SparseEmbedding({self._input_dim} -> {self._output_dim})"


class SyncBatchNorm(BatchNorm):
    """Synchronized BatchNorm (ref: basic_layers.py SyncBatchNorm; kernel
    src/operator/contrib/sync_batch_norm-inl.h) over channel axis 1: the
    batch statistics are mean and E[x^2] - mean^2, each averaged over the
    ranks of the current mesh's ``axis_name`` axis (``collectives.pmean``,
    so the gradients are those of the whole batch), or this rank's own
    with no mesh or no such axis, as the reference degrades outside
    ``shard_map``; the moving statistics are updated as the reference
    updates them. ``num_devices`` is kept for the reference's
    signature."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", axis_name="data",
                 **kwargs):
        super().__init__(axis=1, momentum=momentum, epsilon=epsilon,
                         center=center, scale=scale,
                         use_global_stats=use_global_stats,
                         beta_initializer=beta_initializer,
                         gamma_initializer=gamma_initializer,
                         running_mean_initializer=running_mean_initializer,
                         running_variance_initializer=(
                             running_variance_initializer),
                         in_channels=in_channels, **kwargs)
        self._axis_name = axis_name

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        from .... import autograd as _ag
        from ....ndarray.ndarray import invoke
        from ....parallel import collectives as C
        from ....parallel.mesh import get_mesh
        training = _ag.is_training() and not self._use_global_stats
        eps, mom, ax = self._epsilon, self._momentum, self._axis
        mesh = get_mesh()
        if mesh is not None and mesh.shape.get(self._axis_name, 1) == 1:
            mesh = None

        def f(xv, g, b, mm, mv):
            red = tuple(i for i in range(xv.dim()) if i != ax)
            shape = [1] * xv.dim()
            shape[ax] = xv.shape[ax]
            if training:
                mean, meansq = C.synced_moments(xv, red, self._axis_name,
                                                mesh)
                var = meansq - torch.square(mean)
                nm = mm * mom + mean * (1 - mom)
                nv = mv * mom + var * (1 - mom)
            else:
                mean, var, nm, nv = mm, mv, mm, mv
            inv = torch.rsqrt(var + eps) * g
            y = (xv - mean.reshape(shape)) * inv.reshape(shape) \
                + b.reshape(shape)
            return y, nm, nv
        y, new_mean, new_var = invoke(f, [x, gamma, beta, running_mean,
                                          running_var], "SyncBatchNorm",
                                      n_out=3)
        if training:
            with _ag.pause():
                running_mean._set_data(new_mean._data)
                running_var._set_data(new_var._data)
        return y


class PixelShuffle2D(HybridBlock):
    """Sub-pixel rearrangement (N, C f1 f2, H, W) -> (N, C, H f1, W f2)
    (ref: contrib PixelShuffle2D)."""

    def __init__(self, factor, **kwargs):
        super().__init__(**kwargs)
        self._factor = (factor, factor) if isinstance(factor, int) \
            else tuple(factor)

    def hybrid_forward(self, F, x):
        from ....ndarray.ndarray import invoke
        f1, f2 = self._factor

        def f(v):
            n, c, h, w = v.shape
            v = v.reshape(n, c // (f1 * f2), f1, f2, h, w)
            v = v.permute(0, 1, 4, 2, 5, 3)
            return v.reshape(n, c // (f1 * f2), h * f1, w * f2)
        return invoke(f, [x], "PixelShuffle2D")
