"""Image API (ref: python/mxnet/image/).

Counterpart of ``incubator_mxnet_tpu/image/``: decoding, resizing, the
augmenters and ``ImageIter`` (``image``), the detection augmenters and
``ImageDetIter`` (``detection``), and the on-card crop and flip
(``device.random_crop_flip``)."""
from .image import *  # noqa: F401,F403
from .detection import *  # noqa: F401,F403
from .device import random_crop_flip  # noqa: F401
from . import detection  # noqa: F401
