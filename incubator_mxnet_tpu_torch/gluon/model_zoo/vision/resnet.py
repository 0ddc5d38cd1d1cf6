"""ResNet v1/v2 model zoo.

Counterpart of ``incubator_mxnet_tpu/gluon/model_zoo/vision/resnet.py``
(ref: python/mxnet/gluon/model_zoo/vision/resnet.py — BasicBlockV1/V2,
BottleneckV1/V2, ResNetV1/V2, resnet18..152_v1/v2, get_resnet): the same
spec table, NCHW or channels-last (``layout="NHWC"``). ``ResNetV1`` sends
bottleneck stages to the fused kernels (``_fused_resnet.fused_stage``)
under the reference's rules: NHWC, training, not recording,
``MXTPU_FUSED_RESNET=1``, mid width at least ``MXTPU_FUSED_MIN_MID`` (128).
"""
from __future__ import annotations

import os

from .... import remat as _remat
from ....context import cpu
from ...block import HybridBlock
from ... import nn

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "resnet18_v1", "resnet34_v1",
           "resnet50_v1", "resnet101_v1", "resnet152_v1", "resnet18_v2",
           "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2",
           "get_resnet"]


def _conv3x3(channels, stride, in_channels, layout="NCHW"):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels, layout=layout)


def _bn_axis(layout):
    return -1 if layout == "NHWC" else 1


def _residual_relu_nd(x, residual):
    """relu(x + residual) via the single-materialization custom VJP
    (ops.nn.residual_relu) — stops XLA duplicating the junction's
    gradient chain into every backward consumer (docs/perf.md)."""
    if os.environ.get("MXTPU_RESIDUAL_BARRIER", "0") != "1":
        from ... import block as _b
        F = _b._nd_mod_proxy
        return F.Activation(x + residual, act_type="relu")
    from ....ndarray.ndarray import invoke
    from ....ops.nn import residual_relu
    return invoke(residual_relu, [x, residual], name="residual_relu")


class BasicBlockV1(HybridBlock):
    """(ref: resnet.py:BasicBlockV1)"""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        ax = _bn_axis(layout)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(_conv3x3(channels, stride, in_channels, layout))
        self.body.add(nn.BatchNorm(axis=ax))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels, layout))
        self.body.add(nn.BatchNorm(axis=ax))
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels,
                                          layout=layout))
            self.downsample.add(nn.BatchNorm(axis=ax))
        else:
            self.downsample = None

    def forward(self, x):
        residual = x
        x = self.body(x)
        if self.downsample:
            residual = self.downsample(residual)
        return _residual_relu_nd(x, residual)


class BottleneckV1(HybridBlock):
    """(ref: resnet.py:BottleneckV1)"""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        ax = _bn_axis(layout)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.Conv2D(channels // 4, kernel_size=1, strides=stride,
                                layout=layout))
        self.body.add(nn.BatchNorm(axis=ax))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels // 4, 1, channels // 4, layout))
        self.body.add(nn.BatchNorm(axis=ax))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1,
                                layout=layout))
        self.body.add(nn.BatchNorm(axis=ax))
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels,
                                          layout=layout))
            self.downsample.add(nn.BatchNorm(axis=ax))
        else:
            self.downsample = None

    def forward(self, x):
        residual = x
        x = self.body(x)
        if self.downsample:
            residual = self.downsample(residual)
        return _residual_relu_nd(x, residual)


class BasicBlockV2(HybridBlock):
    """(ref: resnet.py:BasicBlockV2) pre-activation variant."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        ax = _bn_axis(layout)
        self.bn1 = nn.BatchNorm(axis=ax)
        self.conv1 = _conv3x3(channels, stride, in_channels, layout)
        self.bn2 = nn.BatchNorm(axis=ax)
        self.conv2 = _conv3x3(channels, 1, channels, layout)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels,
                                        layout=layout)
        else:
            self.downsample = None

    def forward(self, x):
        from ... import block as _b
        F = _b._nd_mod_proxy
        residual = x
        x = self.bn1(x)
        x = F.Activation(x, act_type="relu")
        if self.downsample:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.bn2(x)
        x = F.Activation(x, act_type="relu")
        x = self.conv2(x)
        return x + residual


class BottleneckV2(HybridBlock):
    """(ref: resnet.py:BottleneckV2)"""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        ax = _bn_axis(layout)
        self.bn1 = nn.BatchNorm(axis=ax)
        self.conv1 = nn.Conv2D(channels // 4, kernel_size=1, strides=1,
                               use_bias=False, layout=layout)
        self.bn2 = nn.BatchNorm(axis=ax)
        self.conv2 = _conv3x3(channels // 4, stride, channels // 4, layout)
        self.bn3 = nn.BatchNorm(axis=ax)
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1,
                               use_bias=False, layout=layout)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels,
                                        layout=layout)
        else:
            self.downsample = None

    def forward(self, x):
        from ... import block as _b
        F = _b._nd_mod_proxy
        residual = x
        x = self.bn1(x)
        x = F.Activation(x, act_type="relu")
        if self.downsample:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.bn2(x)
        x = F.Activation(x, act_type="relu")
        x = self.conv2(x)
        x = self.bn3(x)
        x = F.Activation(x, act_type="relu")
        x = self.conv3(x)
        return x + residual


class ResNetV1(HybridBlock):
    """(ref: resnet.py:ResNetV1).

    ``layout="NHWC"`` runs the whole net channels-last — the TPU fast path
    (one input transpose at entry; weights/BN live natively channels-last).
    The user-facing input stays NCHW either way.
    """

    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(channels) - 1
        self._layout = layout
        ax = _bn_axis(layout)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0, layout))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False, layout=layout))
                self.features.add(nn.BatchNorm(axis=ax))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1, layout=layout))
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=channels[i], layout=layout))
            self.features.add(nn.GlobalAvgPool2D(layout=layout))
            self.output = nn.Dense(classes, in_units=channels[-1])

    def _make_layer(self, block, layers, channels, stride, stage_index,
                    in_channels=0, layout="NCHW"):
        layer = nn.HybridSequential(prefix=f"stage{stage_index}_")
        with layer.name_scope():
            layer.add(block(channels, stride, channels != in_channels,
                            in_channels=in_channels, layout=layout,
                            prefix=""))
            for _ in range(layers - 1):
                layer.add(block(channels, 1, False, in_channels=channels,
                                layout=layout, prefix=""))
        return layer

    def _run_features(self, x):
        """Run the feature stack, sending bottleneck stages to the fused
        kernels (``_fused_resnet.fused_stage``) where the reference does,
        and every other child through the per-block path: the same math
        either way. The fused stage is an autograd.Function: it runs when
        training and not recording, i.e. inside a functional train step
        (``parallel.dp``), which differentiates it with torch autograd."""
        from .... import autograd as _ag
        from . import _fused_resnet as _fr
        from ....ndarray.ndarray import NDArray
        fuse = (_fr.fused_path_enabled(self._layout, _ag.is_training())
                and not _ag.is_recording())
        min_mid = int(os.environ.get("MXTPU_FUSED_MIN_MID", "128"))
        for child in self.features._children.values():
            blocks = (list(child._children.values())
                      if isinstance(child, nn.HybridSequential) else None)
            xv = x._data if isinstance(x, NDArray) else x
            first = (blocks[0].body[0]
                     if blocks and type(blocks[0]) is BottleneckV1 else None)
            stride = (int(first._kwargs["stride"][0])
                      if isinstance(first, nn.Conv2D) else 1)
            if (fuse and blocks and len(blocks) >= 2
                    and isinstance(first, nn.Conv2D)
                    and all(type(b) is BottleneckV1 for b in blocks)
                    and blocks[0].downsample is not None
                    and all(b.downsample is None for b in blocks[1:])
                    # narrow stages (stage 1: 64-wide mid) stay on the
                    # per-block path, as in the reference
                    and blocks[0].body[0].weight.shape[0] >= min_mid
                    # the fused stage bakes the default BN eps/momentum
                    and _fr.stage_bns_use_default_hparams(blocks)
                    # ::stride slicing computes floor(H/s), a strided
                    # conv ceil(H/s): odd spatial dims take the per-block
                    # path
                    and xv.shape[1] % stride == 0
                    and xv.shape[2] % stride == 0):
                params = _fr.stage_params_from_blocks(blocks)

                def stage(v, stride=stride, params=params):
                    with _ag._op_grad_mode():
                        return _fr.fused_stage(stride, v, params)
                x_out, stats = _remat.segment(stage, xv)
                # the moving-stat update of nn.BatchNorm's training forward
                _fr.write_moving_stats(blocks, stats)
                x = NDArray(x_out, _direct=True)
            else:
                x = _remat.segment(child, x)
        return x

    def forward(self, x):
        if self._layout == "NHWC":
            from ... import block as _b
            F = _b._nd_mod_proxy
            x = F.transpose(x, (0, 2, 3, 1))
        x = self._run_features(x)
        x = self.output(x)
        return x


class ResNetV2(HybridBlock):
    """(ref: resnet.py:ResNetV2). ``layout="NHWC"`` = channels-last fast
    path, as in ResNetV1."""

    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(channels) - 1
        self._layout = layout
        ax = _bn_axis(layout)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.BatchNorm(axis=ax, scale=False,
                                           center=False))
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0, layout))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False, layout=layout))
                self.features.add(nn.BatchNorm(axis=ax))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1, layout=layout))
            in_channels = channels[0]
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=in_channels, layout=layout))
                in_channels = channels[i + 1]
            self.features.add(nn.BatchNorm(axis=ax))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D(layout=layout))
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes, in_units=in_channels)

    def _make_layer(self, block, layers, channels, stride, stage_index,
                    in_channels=0, layout="NCHW"):
        layer = nn.HybridSequential(prefix=f"stage{stage_index}_")
        with layer.name_scope():
            layer.add(block(channels, stride, channels != in_channels,
                            in_channels=in_channels, layout=layout,
                            prefix=""))
            for _ in range(layers - 1):
                layer.add(block(channels, 1, False, in_channels=channels,
                                layout=layout, prefix=""))
        return layer

    def forward(self, x):
        if self._layout == "NHWC":
            from ... import block as _b
            F = _b._nd_mod_proxy
            x = F.transpose(x, (0, 2, 3, 1))
        x = self.features(x)
        x = self.output(x)
        return x


# spec table (ref: resnet.py resnet_spec)
resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def get_resnet(version, num_layers, pretrained=False, ctx=cpu(), root=None,
               **kwargs):
    """(ref: resnet.py:get_resnet)"""
    assert num_layers in resnet_spec, \
        f"Invalid number of layers: {num_layers}. Options are {sorted(resnet_spec)}"
    block_type, layers, channels = resnet_spec[num_layers]
    assert 1 <= version <= 2, f"Invalid resnet version: {version}."
    resnet_class = resnet_net_versions[version - 1]
    block_class = resnet_block_versions[version - 1][block_type]
    net = resnet_class(block_class, layers, channels, **kwargs)
    if pretrained:
        raise RuntimeError("pretrained weights are not available: the port "
                           "fetches nothing")
    return net


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
