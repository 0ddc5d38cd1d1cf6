"""SqueezeNet 1.0/1.1.

Counterpart of ``incubator_mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``
(ref: python/mxnet/gluon/model_zoo/vision/squeezenet.py). Its
``ceil_mode=True`` max pools take the "full" pooling convention
(``ops.nn.pooling``), whose output length is ceil((L + 2p - k) / s) + 1,
the reference's; the fire modules' expand branches are concatenated
along the channels.
"""
from __future__ import annotations

from ....context import cpu
from ...block import HybridBlock
from ... import nn

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1", "get_squeezenet"]


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels):
    out = nn.HybridSequential(prefix="")
    out.add(_make_fire_conv(squeeze_channels, 1))
    expand = _Concurrent()
    expand.add(_make_fire_conv(expand1x1_channels, 1))
    expand.add(_make_fire_conv(expand3x3_channels, 3, 1))
    out.add(expand)
    return out


def _make_fire_conv(channels, kernel_size, padding=0):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(channels, kernel_size, padding=padding))
    out.add(nn.Activation("relu"))
    return out


class _Concurrent(nn.HybridSequential):
    """channel-concat of parallel branches (ref: gluon/contrib/nn HybridConcurrent)."""

    def forward(self, x):
        from ... import block as _b
        F = _b._nd_mod_proxy
        return F.Concat(*[blk(x) for blk in self._children.values()], dim=1)


class SqueezeNet(HybridBlock):
    """(ref: squeezenet.py:SqueezeNet)"""

    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        assert version in ("1.0", "1.1"), \
            "Unsupported SqueezeNet version {}: 1.0 or 1.1 expected".format(version)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if version == "1.0":
                self.features.add(nn.Conv2D(96, kernel_size=7, strides=2))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(64, 256, 256))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_make_fire(64, 256, 256))
            else:
                self.features.add(nn.Conv2D(64, kernel_size=3, strides=2))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(64, 256, 256))
                self.features.add(_make_fire(64, 256, 256))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.HybridSequential(prefix="")
            self.output.add(nn.Conv2D(classes, kernel_size=1))
            self.output.add(nn.Activation("relu"))
            self.output.add(nn.AvgPool2D(13))
            self.output.add(nn.Flatten())

    def forward(self, x):
        x = self.features(x)
        x = self.output(x)
        return x


def get_squeezenet(version, pretrained=False, ctx=cpu(), root=None, **kwargs):
    net = SqueezeNet(version, **kwargs)
    if pretrained:
        raise RuntimeError("pretrained weights are not available: the port "
                           "fetches nothing")
    return net


def squeezenet1_0(**kwargs):
    return get_squeezenet("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return get_squeezenet("1.1", **kwargs)
