"""SSD object detection (Single Shot MultiBox Detector).

Counterpart of ``incubator_mxnet_tpu/models/ssd.py`` (ref: example/ssd/ —
symbol/symbol_builder.py multi-layer feature extraction + MultiBox heads;
ops src/operator/contrib/multibox_{prior,target,detection}.cc): a Gluon
HybridBlock family over the port's ``nd.contrib`` detection ops, whose
target matcher and NMS are the B9 kernels on the card.

Train:  cls_preds, box_preds, anchors = net(x)
        box_t, box_m, cls_t = net.targets(anchors, label, cls_preds)
        loss = SSDMultiBoxLoss()(cls_preds, box_preds, cls_t, box_t, box_m)
Infer:  detections = net.detect(x)   # (B, N, 6) [id, score, x1 y1 x2 y2]

The backbone's children run one by one (:meth:`SSD._scales`), so a ResNet
backbone never takes the fused stages of ``ResNetV1._run_features``, and a
channels-last backbone runs its stem convolution as it is (the reference
with ``MXTPU_S2D_STEM=0``).
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from ..gluon import nn
from ..gluon.block import HybridBlock
from ..gluon.loss import Loss
from ..ndarray import contrib as _contrib
from ..ndarray import ops as _ops
from ..ndarray.ndarray import NDArray, concatenate, invoke

__all__ = ["SSD", "SSDMultiBoxLoss", "multibox_loss", "ssd_512_resnet50_v1",
           "ssd_300_vgg16_atrous", "ssd_toy"]


def _feature_block(channels: int, stride: int = 2) -> nn.HybridSequential:
    """1x1 squeeze + 3x3 stride-2 expand, the standard SSD extra layer
    (ref: example/ssd/symbol/common.py multi_layer_feature)."""
    blk = nn.HybridSequential()
    blk.add(nn.Conv2D(channels // 2, kernel_size=1),
            nn.BatchNorm(),
            nn.Activation("relu"),
            nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1),
            nn.BatchNorm(),
            nn.Activation("relu"))
    return blk


class SSD(HybridBlock):
    """Generic SSD head over a truncated backbone.

    backbone_features: HybridSequential; indices in `feature_taps` mark the
    layers whose outputs become detection scales; `extra_channels` adds
    stride-2 feature blocks after the backbone for coarser scales.
    sizes/ratios: per-scale anchor specs (lists, one entry per scale),
    reference semantics (multibox_prior.cc). ``backbone_layout="NHWC"``
    runs the backbone channels-last: the input transposes once at its
    entry and each tapped feature transposes back for the NCHW heads.
    """

    def __init__(self, backbone_features, feature_taps: Sequence[int],
                 extra_channels: Sequence[int], num_classes: int,
                 sizes: Sequence[Sequence[float]],
                 ratios: Sequence[Sequence[float]],
                 nms_threshold: float = 0.45, nms_topk: int = 400,
                 backbone_layout: str = "NCHW", **kwargs):
        super().__init__(**kwargs)
        if backbone_layout not in ("NCHW", "NHWC"):
            raise ValueError(
                f"backbone_layout must be NCHW or NHWC, got "
                f"{backbone_layout!r}")
        self._backbone_layout = backbone_layout
        n_scales = len(feature_taps) + len(extra_channels)
        assert len(sizes) == len(ratios) == n_scales, \
            f"need sizes/ratios per scale: {n_scales}"
        self.num_classes = num_classes
        self.sizes = [list(s) for s in sizes]
        self.ratios = [list(r) for r in ratios]
        self.feature_taps = list(feature_taps)
        self.nms_threshold = nms_threshold
        self.nms_topk = nms_topk
        with self.name_scope():
            self.backbone = backbone_features
            self.extras = nn.HybridSequential(prefix="extra_")
            for ch in extra_channels:
                self.extras.add(_feature_block(ch))
            self.cls_heads = nn.HybridSequential(prefix="cls_")
            self.box_heads = nn.HybridSequential(prefix="box_")
            for s, r in zip(self.sizes, self.ratios):
                na = len(s) + len(r) - 1
                self.cls_heads.add(nn.Conv2D(na * (num_classes + 1),
                                             kernel_size=3, padding=1))
                self.box_heads.add(nn.Conv2D(na * 4, kernel_size=3,
                                             padding=1))

    def _scales(self, x: NDArray) -> List[NDArray]:
        feats = []
        nhwc = self._backbone_layout == "NHWC"
        out = x.transpose((0, 2, 3, 1)) if nhwc else x
        # truncate the backbone at the deepest tap: classifier-tail layers
        # (global pool / dense) must not feed the extra conv scales
        children = list(self.backbone._children.values())
        for i, layer in enumerate(children[:max(self.feature_taps) + 1]):
            out = layer(out)
            if i in self.feature_taps:
                feats.append(out.transpose((0, 3, 1, 2)) if nhwc else out)
        if nhwc:
            out = out.transpose((0, 3, 1, 2))
        for blk in self.extras._children.values():
            out = blk(out)
            feats.append(out)
        return feats

    def forward(self, x):
        """Returns (cls_preds (B, N, C+1), box_preds (B, N*4),
        anchors (1, N, 4) float32)."""
        cls_outs, box_outs, anchor_outs = [], [], []
        heads = zip(self._scales(x), self.cls_heads._children.values(),
                    self.box_heads._children.values(),
                    self.sizes, self.ratios)
        for feat, cls_head, box_head, s, r in heads:
            cp = cls_head(feat)     # (B, na*(C+1), h, w)
            bp = box_head(feat)     # (B, na*4, h, w)
            B = cp.shape[0]
            cls_outs.append(cp.transpose((0, 2, 3, 1)).reshape(
                (B, -1, self.num_classes + 1)))
            box_outs.append(bp.transpose((0, 2, 3, 1)).reshape((B, -1)))
            anchor_outs.append(_contrib.MultiBoxPrior(
                feat, sizes=s, ratios=r, clip=False))
        return (concatenate(cls_outs, axis=1),
                concatenate(box_outs, axis=1),
                concatenate(anchor_outs, axis=1))

    def targets(self, anchors, label, cls_preds,
                negative_mining_ratio=3.0):
        """Training targets (ref: example/ssd/train/train_net.py flow)."""
        return _contrib.MultiBoxTarget(
            anchors, label, cls_preds.transpose((0, 2, 1)),
            negative_mining_ratio=negative_mining_ratio,
            negative_mining_thresh=0.5)

    def detect(self, x, threshold=0.01):
        """Forward + decode + NMS -> (B, N, 6)."""
        cls_preds, box_preds, anchors = self(x)
        cls_prob = _ops.softmax(cls_preds, axis=-1).transpose((0, 2, 1))
        return _contrib.MultiBoxDetection(
            cls_prob, box_preds, anchors, nms_threshold=self.nms_threshold,
            force_suppress=False, nms_topk=self.nms_topk,
            threshold=threshold)


def multibox_loss(cp, bp, ct, bt, bm, rho: float = 1.0, lambd: float = 1.0):
    """Per-image SSD loss on tensors: softmax cross-entropy over the
    anchors whose target is not -1, plus smooth L1 on the masked box
    offsets, both over the count of those anchors."""
    logp = cp - torch.logsumexp(cp, dim=-1, keepdim=True)
    picked = torch.gather(logp, -1, ct.clamp_min(0).long()[..., None])[..., 0]
    keep = (ct >= 0).to(cp.dtype)
    n_valid = torch.clamp_min(keep.sum(dim=1), 1.0)
    cls_loss = -(picked * keep).sum(dim=1) / n_valid
    diff = torch.abs((bp - bt) * bm)
    sl1 = torch.where(diff < rho, 0.5 * diff * diff / rho, diff - 0.5 * rho)
    return cls_loss + lambd * sl1.sum(dim=1) / n_valid


class SSDMultiBoxLoss(Loss):
    """Softmax cross-entropy (with ignore_label -1) on classes + smooth-L1
    on boxes (ref: example/ssd/symbol/symbol_builder.py training symbol:
    SoftmaxOutput ignore_label + smooth_l1 * MakeLoss)."""

    def __init__(self, rho: float = 1.0, lambd: float = 1.0, weight=None,
                 batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho
        self._lambd = lambd

    def forward(self, cls_preds, box_preds, cls_target, box_target,
                box_mask):
        return invoke(lambda *t: multibox_loss(*t, rho=self._rho,
                                               lambd=self._lambd),
                      [cls_preds, box_preds, cls_target, box_target,
                       box_mask], "ssd_multibox_loss")


def ssd_512_resnet50_v1(classes: int = 20, layout: str = "NCHW",
                        **kwargs) -> SSD:
    """SSD-512 with a ResNet-50 v1 backbone, the reference benchmark config
    (ref: example/ssd/README + BASELINE.json configs); ``layout="NHWC"``
    runs the backbone channels-last, the heads and anchors stay NCHW."""
    from ..gluon.model_zoo.vision import resnet50_v1
    backbone = resnet50_v1(layout=layout).features
    # taps: end of stage 3 (stride 16) and stage 4 (stride 32); the
    # HybridSequential layout is [conv, bn, relu, pool, stage1..4, gap]
    taps = [6, 7]
    sizes = [[0.1, 0.141], [0.2, 0.272], [0.37, 0.447], [0.54, 0.619],
             [0.71, 0.79], [0.88, 0.961]]
    ratios = [[1, 2, 0.5]] * 2 + [[1, 2, 0.5, 3, 1.0 / 3]] * 4
    return SSD(backbone, taps, extra_channels=(512, 512, 256, 256),
               num_classes=classes, sizes=sizes, ratios=ratios,
               backbone_layout=layout, **kwargs)


def ssd_300_vgg16_atrous(classes: int = 20, **kwargs) -> SSD:
    """SSD-300 with a VGG-16 backbone (ref: example/ssd default network,
    symbol/vgg16_reduced.py), tapped at the last pooling layer before the
    classifier tail (Flatten, Dense, Dropout, Dense, Dropout). The JAX
    package taps the Flatten, one child later, so its forward fails."""
    from ..gluon.model_zoo.vision import vgg16
    backbone = vgg16().features
    taps = [len(backbone._children) - 6]
    sizes = [[0.1, 0.141], [0.2, 0.272], [0.37, 0.447], [0.54, 0.619],
             [0.71, 0.79]]
    ratios = [[1, 2, 0.5]] + [[1, 2, 0.5, 3, 1.0 / 3]] * 4
    return SSD(backbone, taps, extra_channels=(512, 256, 256, 256),
               num_classes=classes, sizes=sizes, ratios=ratios, **kwargs)


def ssd_toy(classes: int = 3, **kwargs) -> SSD:
    """Tiny SSD for unit tests: 2 conv stages + 1 extra scale."""
    backbone = nn.HybridSequential()
    backbone.add(nn.Conv2D(8, 3, strides=2, padding=1),
                 nn.Activation("relu"),
                 nn.Conv2D(16, 3, strides=2, padding=1),
                 nn.Activation("relu"))
    return SSD(backbone, feature_taps=[3], extra_channels=(32,),
               num_classes=classes,
               sizes=[[0.2, 0.272], [0.37, 0.447]],
               ratios=[[1, 2, 0.5]] * 2, **kwargs)
