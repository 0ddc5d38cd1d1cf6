"""AlexNet.

Counterpart of ``incubator_mxnet_tpu/gluon/model_zoo/vision/alexnet.py``
(ref: python/mxnet/gluon/model_zoo/vision/alexnet.py): the same layers in
the same child order, so parameter names match the reference's.
"""
from __future__ import annotations

from ....context import cpu
from ...block import HybridBlock
from ... import nn

__all__ = ["AlexNet", "alexnet"]


class AlexNet(HybridBlock):
    """(ref: alexnet.py:AlexNet)"""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            with self.features.name_scope():
                self.features.add(nn.Conv2D(64, kernel_size=11, strides=4,
                                            padding=2, activation="relu"))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
                self.features.add(nn.Conv2D(192, kernel_size=5, padding=2,
                                            activation="relu"))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
                self.features.add(nn.Conv2D(384, kernel_size=3, padding=1,
                                            activation="relu"))
                self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                            activation="relu"))
                self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                            activation="relu"))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
                self.features.add(nn.Flatten())
                self.features.add(nn.Dense(4096, activation="relu"))
                self.features.add(nn.Dropout(0.5))
                self.features.add(nn.Dense(4096, activation="relu"))
                self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def forward(self, x):
        x = self.features(x)
        x = self.output(x)
        return x


def alexnet(pretrained=False, ctx=cpu(), root=None, **kwargs):
    """(ref: alexnet.py:alexnet)"""
    net = AlexNet(**kwargs)
    if pretrained:
        raise RuntimeError("pretrained weights are not available: the port "
                           "fetches nothing")
    return net
