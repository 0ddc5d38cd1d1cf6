"""Inception V3.

Counterpart of ``incubator_mxnet_tpu/gluon/model_zoo/vision/inception.py``
(ref: python/mxnet/gluon/model_zoo/vision/inception.py): the same branch
tables and prefixes; each block's branches are concatenated along the
channels. Its input is 299 x 299.
"""
from __future__ import annotations

from ....context import cpu
from ...block import HybridBlock
from ... import nn

__all__ = ["Inception3", "inception_v3"]


def _make_basic_conv(**kwargs):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(use_bias=False, **kwargs))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


class _Concurrent(nn.HybridSequential):
    def forward(self, x):
        from ... import block as _b
        F = _b._nd_mod_proxy
        return F.Concat(*[blk(x) for blk in self._children.values()], dim=1)


def _make_branch(use_pool, *conv_settings):
    out = nn.HybridSequential(prefix="")
    if use_pool == "avg":
        out.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(nn.MaxPool2D(pool_size=3, strides=2))
    setting_names = ["channels", "kernel_size", "strides", "padding"]
    for setting in conv_settings:
        kwargs = {}
        for i, value in enumerate(setting):
            if value is not None:
                kwargs[setting_names[i]] = value
        out.add(_make_basic_conv(**kwargs))
    return out


def _make_A(pool_features, prefix):
    out = _Concurrent(prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (64, 1, None, None)))
        out.add(_make_branch(None, (48, 1, None, None), (64, 5, None, 2)))
        out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                             (96, 3, None, 1)))
        out.add(_make_branch("avg", (pool_features, 1, None, None)))
    return out


def _make_B(prefix):
    out = _Concurrent(prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (384, 3, 2, None)))
        out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                             (96, 3, 2, None)))
        out.add(_make_branch("max"))
    return out


def _make_C(channels_7x7, prefix):
    out = _Concurrent(prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (192, 1, None, None)))
        out.add(_make_branch(None, (channels_7x7, 1, None, None),
                             (channels_7x7, (1, 7), None, (0, 3)),
                             (192, (7, 1), None, (3, 0))))
        out.add(_make_branch(None, (channels_7x7, 1, None, None),
                             (channels_7x7, (7, 1), None, (3, 0)),
                             (channels_7x7, (1, 7), None, (0, 3)),
                             (channels_7x7, (7, 1), None, (3, 0)),
                             (192, (1, 7), None, (0, 3))))
        out.add(_make_branch("avg", (192, 1, None, None)))
    return out


def _make_D(prefix):
    out = _Concurrent(prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (192, 1, None, None), (320, 3, 2, None)))
        out.add(_make_branch(None, (192, 1, None, None),
                             (192, (1, 7), None, (0, 3)),
                             (192, (7, 1), None, (3, 0)),
                             (192, 3, 2, None)))
        out.add(_make_branch("max"))
    return out


class _SplitConcat(HybridBlock):
    """branch that concats two sub-branches applied to the same input."""

    def __init__(self, stem, b1, b2, **kwargs):
        super().__init__(**kwargs)
        self.stem = stem
        self.b1 = b1
        self.b2 = b2

    def forward(self, x):
        from ... import block as _b
        F = _b._nd_mod_proxy
        y = self.stem(x) if self.stem is not None else x
        return F.Concat(self.b1(y), self.b2(y), dim=1)


def _make_E(prefix):
    out = _Concurrent(prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (320, 1, None, None)))
        out.add(_SplitConcat(
            _make_branch(None, (384, 1, None, None)),
            _make_branch(None, ((384, (1, 3), None, (0, 1)))),
            _make_branch(None, ((384, (3, 1), None, (1, 0))))))
        out.add(_SplitConcat(
            _make_branch(None, (448, 1, None, None), (384, 3, None, 1)),
            _make_branch(None, ((384, (1, 3), None, (0, 1)))),
            _make_branch(None, ((384, (3, 1), None, (1, 0))))))
        out.add(_make_branch("avg", (192, 1, None, None)))
    return out


class Inception3(HybridBlock):
    """(ref: inception.py:Inception3)"""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(_make_basic_conv(channels=32, kernel_size=3,
                                               strides=2))
            self.features.add(_make_basic_conv(channels=32, kernel_size=3))
            self.features.add(_make_basic_conv(channels=64, kernel_size=3,
                                               padding=1))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_basic_conv(channels=80, kernel_size=1))
            self.features.add(_make_basic_conv(channels=192, kernel_size=3))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_A(32, "A1_"))
            self.features.add(_make_A(64, "A2_"))
            self.features.add(_make_A(64, "A3_"))
            self.features.add(_make_B("B_"))
            self.features.add(_make_C(128, "C1_"))
            self.features.add(_make_C(160, "C2_"))
            self.features.add(_make_C(160, "C3_"))
            self.features.add(_make_C(192, "C4_"))
            self.features.add(_make_D("D_"))
            self.features.add(_make_E("E1_"))
            self.features.add(_make_E("E2_"))
            self.features.add(nn.AvgPool2D(pool_size=8))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def forward(self, x):
        x = self.features(x)
        x = self.output(x)
        return x


def inception_v3(pretrained=False, ctx=cpu(), root=None, **kwargs):
    net = Inception3(**kwargs)
    if pretrained:
        raise RuntimeError("pretrained weights are not available: the port "
                           "fetches nothing")
    return net
