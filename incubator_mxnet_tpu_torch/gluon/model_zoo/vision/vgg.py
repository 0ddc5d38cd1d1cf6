"""VGG model family.

Counterpart of ``incubator_mxnet_tpu/gluon/model_zoo/vision/vgg.py`` (ref:
python/mxnet/gluon/model_zoo/vision/vgg.py — VGG 11/13/16/19 with and
without BatchNorm): the same spec table and child order, so the feature
stack's indices (which ``models.ssd`` taps) are the reference's.
"""
from __future__ import annotations

from ....context import cpu
from .... import initializer as _init
from ...block import HybridBlock
from ... import nn

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn",
           "vgg16_bn", "vgg19_bn", "get_vgg"]


class VGG(HybridBlock):
    """(ref: vgg.py:VGG)"""

    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(filters)
        with self.name_scope():
            self.features = self._make_features(layers, filters, batch_norm)
            self.features.add(nn.Dense(4096, activation="relu",
                                       weight_initializer="normal",
                                       bias_initializer="zeros"))
            self.features.add(nn.Dropout(rate=0.5))
            self.features.add(nn.Dense(4096, activation="relu",
                                       weight_initializer="normal",
                                       bias_initializer="zeros"))
            self.features.add(nn.Dropout(rate=0.5))
            self.output = nn.Dense(classes, weight_initializer="normal",
                                   bias_initializer="zeros")

    def _make_features(self, layers, filters, batch_norm):
        featurizer = nn.HybridSequential(prefix="")
        for i, num in enumerate(layers):
            for _ in range(num):
                featurizer.add(nn.Conv2D(filters[i], kernel_size=3, padding=1,
                                         weight_initializer=_init.Xavier(
                                             rnd_type="gaussian",
                                             factor_type="out", magnitude=2),
                                         bias_initializer="zeros"))
                if batch_norm:
                    featurizer.add(nn.BatchNorm())
                featurizer.add(nn.Activation("relu"))
            featurizer.add(nn.MaxPool2D(strides=2))
        featurizer.add(nn.Flatten())
        return featurizer

    def forward(self, x):
        x = self.features(x)
        x = self.output(x)
        return x


vgg_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
            13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
            16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
            19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


def get_vgg(num_layers, pretrained=False, ctx=cpu(), root=None, **kwargs):
    """(ref: vgg.py:get_vgg)"""
    layers, filters = vgg_spec[num_layers]
    net = VGG(layers, filters, **kwargs)
    if pretrained:
        raise RuntimeError("pretrained weights are not available: the port "
                           "fetches nothing")
    return net


def vgg11(**kwargs):
    return get_vgg(11, **kwargs)


def vgg13(**kwargs):
    return get_vgg(13, **kwargs)


def vgg16(**kwargs):
    return get_vgg(16, **kwargs)


def vgg19(**kwargs):
    return get_vgg(19, **kwargs)


def vgg11_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(11, **kwargs)


def vgg13_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(13, **kwargs)


def vgg16_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(16, **kwargs)


def vgg19_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(19, **kwargs)
