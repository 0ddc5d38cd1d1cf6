"""MobileNet v1/v2.

Counterpart of ``incubator_mxnet_tpu/gluon/model_zoo/vision/mobilenet.py``
(ref: python/mxnet/gluon/model_zoo/vision/mobilenet.py): depthwise
convolutions as grouped ``Conv2D`` (``groups`` = channels), ReLU6 as a
clip to [0, 6].
"""
from __future__ import annotations

from ....context import cpu
from ...block import HybridBlock
from ... import nn

__all__ = ["MobileNet", "MobileNetV2", "mobilenet1_0", "mobilenet0_75",
           "mobilenet0_5", "mobilenet0_25", "mobilenet_v2_1_0",
           "mobilenet_v2_0_75", "mobilenet_v2_0_5", "mobilenet_v2_0_25",
           "get_mobilenet", "get_mobilenet_v2"]


def _add_conv(out, channels=1, kernel=1, stride=1, pad=0, num_group=1,
              active=True, relu6=False):
    out.add(nn.Conv2D(channels, kernel, stride, pad, groups=num_group,
                      use_bias=False))
    out.add(nn.BatchNorm())
    if active:
        out.add(RU6() if relu6 else nn.Activation("relu"))


class RU6(HybridBlock):
    """ReLU6 (ref: mobilenet.py RELU6)."""

    def hybrid_forward(self, F, x):
        return F.clip(x, 0, 6)


def _add_conv_dw(out, dw_channels, channels, stride, relu6=False):
    _add_conv(out, dw_channels, kernel=3, stride=stride, pad=1,
              num_group=dw_channels, relu6=relu6)
    _add_conv(out, channels, relu6=relu6)


class LinearBottleneck(HybridBlock):
    """(ref: mobilenet.py:LinearBottleneck)"""

    def __init__(self, in_channels, channels, t, stride, **kwargs):
        super().__init__(**kwargs)
        self.use_shortcut = stride == 1 and in_channels == channels
        with self.name_scope():
            self.out = nn.HybridSequential()
            _add_conv(self.out, in_channels * t, relu6=True)
            _add_conv(self.out, in_channels * t, kernel=3, stride=stride,
                      pad=1, num_group=in_channels * t, relu6=True)
            _add_conv(self.out, channels, active=False, relu6=True)

    def forward(self, x):
        out = self.out(x)
        if self.use_shortcut:
            out = out + x
        return out


class MobileNet(HybridBlock):
    """(ref: mobilenet.py:MobileNet)"""

    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            with self.features.name_scope():
                _add_conv(self.features, int(32 * multiplier), kernel=3,
                          stride=2, pad=1)
                dw_channels = [int(x * multiplier) for x in
                               [32, 64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024]]
                channels = [int(x * multiplier) for x in
                            [64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024] * 2]
                strides = [1, 2, 1, 2, 1, 2] + [1] * 5 + [2, 1]
                for dwc, c, s in zip(dw_channels, channels, strides):
                    _add_conv_dw(self.features, dwc, c, s)
                self.features.add(nn.GlobalAvgPool2D())
                self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def forward(self, x):
        x = self.features(x)
        x = self.output(x)
        return x


class MobileNetV2(HybridBlock):
    """(ref: mobilenet.py:MobileNetV2)"""

    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="features_")
            with self.features.name_scope():
                _add_conv(self.features, int(32 * multiplier), kernel=3,
                          stride=2, pad=1, relu6=True)
                in_channels_group = [int(x * multiplier) for x in
                                     [32] + [16] + [24] * 2 + [32] * 3
                                     + [64] * 4 + [96] * 3 + [160] * 3]
                channels_group = [int(x * multiplier) for x in
                                  [16] + [24] * 2 + [32] * 3 + [64] * 4
                                  + [96] * 3 + [160] * 3 + [320]]
                ts = [1] + [6] * 16
                strides = [1, 2] + [1] * 2 + [2] + [1] * 2 + [2] + [1] * 3 \
                    + [1] * 3 + [2] + [1] * 3
                for in_c, c, t, s in zip(in_channels_group, channels_group,
                                         ts, strides):
                    self.features.add(LinearBottleneck(
                        in_channels=in_c, channels=c, t=t, stride=s))
                last_channels = int(1280 * multiplier) if multiplier > 1.0 else 1280
                _add_conv(self.features, last_channels, relu6=True)
                self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.HybridSequential(prefix="output_")
            with self.output.name_scope():
                self.output.add(nn.Conv2D(classes, 1, use_bias=False,
                                          prefix="pred_"))
                self.output.add(nn.Flatten())

    def forward(self, x):
        x = self.features(x)
        x = self.output(x)
        return x


def get_mobilenet(multiplier, pretrained=False, ctx=cpu(), root=None, **kwargs):
    net = MobileNet(multiplier, **kwargs)
    if pretrained:
        raise RuntimeError("pretrained weights are not available: the port "
                           "fetches nothing")
    return net


def get_mobilenet_v2(multiplier, pretrained=False, ctx=cpu(), root=None,
                     **kwargs):
    net = MobileNetV2(multiplier, **kwargs)
    if pretrained:
        raise RuntimeError("pretrained weights are not available: the port "
                           "fetches nothing")
    return net


def mobilenet1_0(**kwargs):
    return get_mobilenet(1.0, **kwargs)


def mobilenet0_75(**kwargs):
    return get_mobilenet(0.75, **kwargs)


def mobilenet0_5(**kwargs):
    return get_mobilenet(0.5, **kwargs)


def mobilenet0_25(**kwargs):
    return get_mobilenet(0.25, **kwargs)


def mobilenet_v2_1_0(**kwargs):
    return get_mobilenet_v2(1.0, **kwargs)


def mobilenet_v2_0_75(**kwargs):
    return get_mobilenet_v2(0.75, **kwargs)


def mobilenet_v2_0_5(**kwargs):
    return get_mobilenet_v2(0.5, **kwargs)


def mobilenet_v2_0_25(**kwargs):
    return get_mobilenet_v2(0.25, **kwargs)
