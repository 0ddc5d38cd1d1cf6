"""Image API (ref: python/mxnet/image/).

Counterpart of ``incubator_mxnet_tpu/image/``. Not ported yet (ROADMAP.md
A6): ``detection`` (``ImageDetIter``, ``CreateDetAugmenter``)."""
from .image import *  # noqa: F401,F403
from .device import random_crop_flip  # noqa: F401

_NOT_PORTED = ("detection", "ImageDetIter", "CreateDetAugmenter")


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"image.{name}: the detection input path is ROADMAP.md A6, not "
            "ported yet")
    raise AttributeError(f"module 'image' has no attribute {name!r}")
