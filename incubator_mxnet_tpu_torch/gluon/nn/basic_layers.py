"""Basic Gluon layers.

Counterpart of ``incubator_mxnet_tpu/gluon/nn/basic_layers.py`` (ref:
python/mxnet/gluon/nn/basic_layers.py — Sequential, HybridSequential, Dense,
Dropout, BatchNorm, InstanceNorm, LayerNorm, Embedding, Flatten, Lambda,
HybridLambda; activations.py — Activation, LeakyReLU, PReLU, ELU, SELU,
Swish, GELU), over the port's ``nd`` ops. ``ShardedEmbedding`` (a table
row-sharded over a mesh) is the multi-card slice and raises.
"""
from __future__ import annotations

import numpy as _np

from ... import initializer as _init
from ... import remat as _remat
from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "InstanceNorm", "LayerNorm", "Embedding", "ShardedEmbedding",
           "Flatten", "Lambda", "HybridLambda", "Activation", "LeakyReLU",
           "PReLU", "ELU", "SELU", "Swish", "GELU"]


class Sequential(Block):
    """Sequentially stacked blocks (ref: basic_layers.py:Sequential)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x, *args):
        for block in self._children.values():
            x = _remat.segment(block, x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers

    def __iter__(self):
        return iter(self._children.values())

    def hybridize(self, active=True, **kwargs):
        super().hybridize(active, **kwargs)


class HybridSequential(HybridBlock):
    """(ref: basic_layers.py:HybridSequential)"""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x, *args):
        for block in self._children.values():
            x = _remat.segment(block, x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers

    def __iter__(self):
        return iter(self._children.values())


class Dense(HybridBlock):
    """Fully-connected layer (ref: basic_layers.py:Dense; op
    src/operator/nn/fully_connected.cc). Weight is (units, in_units) like the
    reference; in_units=0 defers shape to first forward."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self._flatten = flatten
        self._act_type = activation
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), dtype=dtype,
                    init=bias_initializer, allow_deferred_init=True)
            else:
                self.bias = None

    def infer_shape(self, x, *args):
        in_units = (int(_np.prod(x.shape[1:])) if self._flatten
                    else x.shape[-1])
        self.weight.shape = (self._units, in_units)

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               no_bias=bias is None, flatten=self._flatten)
        if self._act_type is not None:
            out = F.Activation(out, act_type=self._act_type)
        return out

    def __repr__(self):
        shape = self.weight.shape
        return (f"Dense({shape[1] if shape and len(shape) > 1 else None} -> "
                f"{self._units}, "
                f"{self._act_type if self._act_type else 'linear'})")


class Dropout(HybridBlock):
    """(ref: basic_layers.py:Dropout)"""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        if self._rate > 0:
            return F.Dropout(x, p=self._rate, axes=self._axes)
        return x

    def __repr__(self):
        return f"Dropout(p = {self._rate}, axes={self._axes})"


class BatchNorm(HybridBlock):
    """(ref: basic_layers.py:BatchNorm; op src/operator/nn/batch_norm.cc).

    Moving stats are grad_req='null' aux params; a hybridized training
    forward writes them into its static copies and onto the parameters
    after the call (see block.py)."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._center = center
        self._scale = scale
        self._use_global_stats = use_global_stats
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=running_variance_initializer, allow_deferred_init=True,
                differentiable=False)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p.shape = (c,)

    def cast(self, dtype):
        try:
            name = _np.dtype(dtype).name
        except TypeError:                   # bfloat16 is no numpy type here
            name = str(dtype)
        if name == "float16":
            dtype = "float32"  # BN statistics stay fp32 (ref: BatchNorm cast)
        super().cast(dtype)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        from ... import autograd as _ag
        from ...ops import nn as _opnn
        from ...ndarray.ndarray import invoke
        training = _ag.is_training() and not self._use_global_stats

        def f(xv, g, b, mm, mv):
            y, nm, nv = _opnn.batch_norm(
                xv, g, b, mm, mv, self._epsilon, self._momentum,
                fix_gamma=False, use_global_stats=self._use_global_stats,
                training=training, axis=self._axis)
            return y, nm, nv
        y, new_mean, new_var = invoke(f, [x, gamma, beta, running_mean,
                                          running_var], "BatchNorm", n_out=3)
        if training:
            with _ag.pause():
                running_mean._set_data(new_mean._data)
                running_var._set_data(new_var._data)
        return y

    def __repr__(self):
        in_channels = self.gamma.shape[0] if self.gamma.shape else None
        return (f"BatchNorm(axis={self._axis}, eps={self._epsilon}, "
                f"momentum={self._momentum}, in_channels={in_channels})")


class InstanceNorm(HybridBlock):
    """(ref: basic_layers.py:InstanceNorm)"""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)


class LayerNorm(HybridBlock):
    """(ref: basic_layers.py:LayerNorm; op src/operator/nn/layer_norm.cc)"""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._epsilon)


class Embedding(HybridBlock):
    """(ref: basic_layers.py:Embedding). sparse_grad selects row_sparse
    gradient currency for the kvstore sparse path."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._sparse_grad = sparse_grad
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer,
                grad_stype="row_sparse" if sparse_grad else "default")

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim,
                           sparse_grad=self._sparse_grad)

    def __repr__(self):
        return f"Embedding({self._input_dim} -> {self._output_dim})"


class ShardedEmbedding(HybridBlock):
    """Embedding whose table is row-sharded across a mesh axis: the
    multi-card slice (ROADMAP.md A10b), not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "ShardedEmbedding: mesh-sharded tables are ROADMAP.md A10b (not "
            "ported)")


class Flatten(HybridBlock):
    """(ref: basic_layers.py:Flatten)"""

    def hybrid_forward(self, F, x):
        return F.flatten(x)

    def __repr__(self):
        return "Flatten"


class Lambda(Block):
    """Wrap a function as a Block (ref: basic_layers.py:Lambda)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd
            assert hasattr(nd, function), \
                f"Function name {function} is not found in ndarray."
            self._func_impl = getattr(nd, function)
            self._func_name = function
        else:
            self._func_impl = function
            self._func_name = function.__name__


    def forward(self, *args):
        return self._func_impl(*args)

    def __repr__(self):
        return f"Lambda({self._func_name})"


class HybridLambda(HybridBlock):
    """(ref: basic_layers.py:HybridLambda)"""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd
            self._func = lambda F, *args: getattr(F, function)(*args)
            self._func_name = function
        else:
            self._func = function
            self._func_name = function.__name__

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)

    def __repr__(self):
        return f"HybridLambda({self._func_name})"


# ---------------------------------------------------------------------------
# activations (ref: python/mxnet/gluon/nn/activations.py)
# ---------------------------------------------------------------------------

class Activation(HybridBlock):
    """(ref: activations.py:Activation)"""

    def __init__(self, activation, prefix=None, params=None):
        self._act_type = activation
        super().__init__(prefix=prefix, params=params)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def __repr__(self):
        return f"Activation({self._act_type})"


class LeakyReLU(HybridBlock):
    """(ref: activations.py:LeakyReLU)"""

    def __init__(self, alpha, prefix=None, params=None):
        assert alpha >= 0, "Slope coefficient for LeakyReLU must be no less than 0."
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)

    def __repr__(self):
        return f"LeakyReLU({self._alpha})"


class PReLU(HybridBlock):
    """(ref: activations.py:PReLU)"""

    def __init__(self, alpha_initializer=_init.Constant(0.25), prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.alpha = self.params.get("alpha", shape=(1,),
                                         init=alpha_initializer)

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, gamma=alpha, act_type="prelu")


class ELU(HybridBlock):
    """(ref: activations.py:ELU)"""

    def __init__(self, alpha=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """(ref: activations.py:SELU)"""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class Swish(HybridBlock):
    """(ref: activations.py:Swish)"""

    def __init__(self, beta=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)


class GELU(HybridBlock):
    """(ref: activations.py:GELU)"""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")
