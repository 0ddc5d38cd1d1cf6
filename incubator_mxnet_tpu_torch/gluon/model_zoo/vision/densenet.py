"""DenseNet 121/161/169/201.

Counterpart of ``incubator_mxnet_tpu/gluon/model_zoo/vision/densenet.py``
(ref: python/mxnet/gluon/model_zoo/vision/densenet.py): the same spec
table; each dense layer's output is concatenated onto its input along
the channels.
"""
from __future__ import annotations

from ....context import cpu
from ...block import HybridBlock
from ... import nn

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201"]


class _DenseBlock(HybridBlock):
    def __init__(self, num_layers, bn_size, growth_rate, dropout, **kwargs):
        super().__init__(**kwargs)
        self._layers = []
        with self.name_scope():
            for i in range(num_layers):
                layer = _make_dense_layer(growth_rate, bn_size, dropout)
                self.register_child(layer, f"denselayer{i}")

    def forward(self, x):
        from ... import block as _b
        F = _b._nd_mod_proxy
        for layer in self._children.values():
            out = layer(x)
            x = F.Concat(x, out, dim=1)
        return x


def _make_dense_layer(growth_rate, bn_size, dropout):
    new_features = nn.HybridSequential(prefix="")
    new_features.add(nn.BatchNorm())
    new_features.add(nn.Activation("relu"))
    new_features.add(nn.Conv2D(bn_size * growth_rate, kernel_size=1,
                               use_bias=False))
    new_features.add(nn.BatchNorm())
    new_features.add(nn.Activation("relu"))
    new_features.add(nn.Conv2D(growth_rate, kernel_size=3, padding=1,
                               use_bias=False))
    if dropout:
        new_features.add(nn.Dropout(dropout))
    return new_features


def _make_transition(num_output_features):
    out = nn.HybridSequential(prefix="")
    out.add(nn.BatchNorm())
    out.add(nn.Activation("relu"))
    out.add(nn.Conv2D(num_output_features, kernel_size=1, use_bias=False))
    out.add(nn.AvgPool2D(pool_size=2, strides=2))
    return out


class DenseNet(HybridBlock):
    """(ref: densenet.py:DenseNet)"""

    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(num_init_features, kernel_size=7,
                                        strides=2, padding=3, use_bias=False))
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2, padding=1))
            num_features = num_init_features
            for i, num_layers in enumerate(block_config):
                self.features.add(_DenseBlock(num_layers, bn_size, growth_rate,
                                              dropout))
                num_features = num_features + num_layers * growth_rate
                if i != len(block_config) - 1:
                    self.features.add(_make_transition(num_features // 2))
                    num_features = num_features // 2
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.AvgPool2D(pool_size=7))
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def forward(self, x):
        x = self.features(x)
        x = self.output(x)
        return x


# (ref: densenet.py densenet_spec)
densenet_spec = {121: (64, 32, [6, 12, 24, 16]),
                 161: (96, 48, [6, 12, 36, 24]),
                 169: (64, 32, [6, 12, 32, 32]),
                 201: (64, 32, [6, 12, 48, 32])}


def get_densenet(num_layers, pretrained=False, ctx=cpu(), root=None, **kwargs):
    num_init_features, growth_rate, block_config = densenet_spec[num_layers]
    net = DenseNet(num_init_features, growth_rate, block_config, **kwargs)
    if pretrained:
        raise RuntimeError("pretrained weights are not available: the port "
                           "fetches nothing")
    return net


def densenet121(**kwargs):
    return get_densenet(121, **kwargs)


def densenet161(**kwargs):
    return get_densenet(161, **kwargs)


def densenet169(**kwargs):
    return get_densenet(169, **kwargs)


def densenet201(**kwargs):
    return get_densenet(201, **kwargs)
