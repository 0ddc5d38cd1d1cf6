"""Vision transforms.

Counterpart of ``incubator_mxnet_tpu/gluon/data/vision/transforms.py``
(ref: python/mxnet/gluon/data/vision/transforms.py — Compose, Cast,
ToTensor, Normalize, Resize, CenterCrop, RandomResizedCrop,
RandomFlipLeftRight, RandomFlipTopBottom, RandomBrightness/Contrast/
Saturation/Hue/ColorJitter/Lighting). The random ones draw from Python's
``random`` and numpy's global generator in the reference's order.
"""
from __future__ import annotations

import random as _pyrandom

import numpy as _np

import torch

from ...block import Block, HybridBlock
from ...nn.basic_layers import Sequential
from ....ndarray.ndarray import array as nd_array, invoke
from .... import image as _image

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomResizedCrop", "RandomFlipLeftRight", "RandomFlipTopBottom",
           "RandomBrightness", "RandomContrast", "RandomSaturation",
           "RandomHue", "RandomColorJitter", "RandomLighting"]


class Compose(Sequential):
    """(ref: transforms.py:Compose)"""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    """(ref: transforms.py:Cast)"""

    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return F.cast(x, self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 [0,255] -> CHW float32 [0,1] (ref: transforms.py:ToTensor)."""

    def hybrid_forward(self, F, x):
        x = F.cast(x, "float32") / 255.0
        if x.ndim == 3:
            return x.transpose((2, 0, 1))
        return x.transpose((0, 3, 1, 2))


class Normalize(HybridBlock):
    """(ref: transforms.py:Normalize) channel-wise on CHW."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = _np.asarray(mean, _np.float32)
        self._std = _np.asarray(std, _np.float32)

    def hybrid_forward(self, F, x):
        c = self._mean.reshape(-1, 1, 1) if self._mean.ndim else self._mean
        s = self._std.reshape(-1, 1, 1) if self._std.ndim else self._std
        return (x - nd_array(c, ctx=x.context)) / nd_array(s, ctx=x.context)


class Resize(Block):
    """(ref: transforms.py:Resize) bilinear resize, HWC."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size, size)

    def forward(self, x):
        return _image.imresize(x, self._size[0], self._size[1])


class CenterCrop(Block):
    """(ref: transforms.py:CenterCrop)"""

    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size, size)

    def forward(self, x):
        h, w = x.shape[0], x.shape[1]
        cw, ch = self._size
        x0 = max((w - cw) // 2, 0)
        y0 = max((h - ch) // 2, 0)
        return _image.fixed_crop(x, x0, y0, cw, ch)


class RandomResizedCrop(Block):
    """(ref: transforms.py:RandomResizedCrop)"""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size, size)
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        h, w = x.shape[0], x.shape[1]
        area = h * w
        for _ in range(10):
            target_area = _pyrandom.uniform(*self._scale) * area
            aspect = _pyrandom.uniform(*self._ratio)
            cw = int(round((target_area * aspect) ** 0.5))
            ch = int(round((target_area / aspect) ** 0.5))
            if cw <= w and ch <= h:
                x0 = _pyrandom.randint(0, w - cw)
                y0 = _pyrandom.randint(0, h - ch)
                crop = _image.fixed_crop(x, x0, y0, cw, ch)
                return _image.imresize(crop, self._size[0], self._size[1])
        return _image.imresize(x, self._size[0], self._size[1])


class RandomFlipLeftRight(HybridBlock):
    """(ref: transforms.py:RandomFlipLeftRight)"""

    def hybrid_forward(self, F, x):
        if _pyrandom.random() < 0.5:
            return F.flip(x, axis=1 if x.ndim == 3 else 2)
        return x


class RandomFlipTopBottom(HybridBlock):
    """(ref: transforms.py:RandomFlipTopBottom)"""

    def hybrid_forward(self, F, x):
        if _pyrandom.random() < 0.5:
            return F.flip(x, axis=0 if x.ndim == 3 else 1)
        return x


class RandomBrightness(Block):
    """(ref: transforms.py:RandomBrightness)"""

    def __init__(self, brightness):
        super().__init__()
        self._args = (max(0, 1 - brightness), 1 + brightness)

    def forward(self, x):
        alpha = _pyrandom.uniform(*self._args)
        return (x.astype("float32") * alpha).clip(0, 255)


class RandomContrast(Block):
    """(ref: transforms.py:RandomContrast)"""

    def __init__(self, contrast):
        super().__init__()
        self._args = (max(0, 1 - contrast), 1 + contrast)

    def forward(self, x):
        alpha = _pyrandom.uniform(*self._args)
        xf = x.astype("float32")
        gray = xf.mean()
        return (xf * alpha + gray * (1 - alpha)).clip(0, 255)


class RandomSaturation(Block):
    """(ref: transforms.py:RandomSaturation)"""

    def __init__(self, saturation):
        super().__init__()
        self._args = (max(0, 1 - saturation), 1 + saturation)

    def forward(self, x):
        alpha = _pyrandom.uniform(*self._args)
        xf = x.astype("float32")
        gray = xf.mean(axis=-1, keepdims=True)
        return (xf * alpha + gray * (1 - alpha)).clip(0, 255)


class RandomHue(Block):
    """(ref: transforms.py:RandomHue) approximate hue jitter via channel mix."""

    def __init__(self, hue):
        super().__init__()
        self._hue = hue

    def forward(self, x):
        alpha = _pyrandom.uniform(-self._hue, self._hue)
        xf = x.astype("float32")
        # rotate channels toward their cyclic neighbour by |alpha|
        rolled = invoke(lambda v: torch.roll(v, 1, dims=-1), [xf],
                        "hue_roll")
        return (xf * (1 - abs(alpha)) + rolled * abs(alpha)).clip(0, 255)


class RandomColorJitter(Block):
    """(ref: transforms.py:RandomColorJitter)"""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._transforms = []
        if brightness:
            self._transforms.append(RandomBrightness(brightness))
        if contrast:
            self._transforms.append(RandomContrast(contrast))
        if saturation:
            self._transforms.append(RandomSaturation(saturation))
        if hue:
            self._transforms.append(RandomHue(hue))

    def forward(self, x):
        ts = list(self._transforms)
        _pyrandom.shuffle(ts)
        for t in ts:
            x = t(x)
        return x


class RandomLighting(Block):
    """AlexNet-style PCA lighting noise (ref: transforms.py:RandomLighting)."""

    _eigval = _np.array([55.46, 4.794, 1.148], _np.float32)
    _eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                         [-0.5808, -0.0045, -0.8140],
                         [-0.5836, -0.6948, 0.4203]], _np.float32)

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        a = _np.random.normal(0, self._alpha, size=(3,)).astype(_np.float32)
        rgb = (self._eigvec * a * self._eigval).sum(axis=1)
        return (x.astype("float32") + nd_array(rgb, ctx=x.context)).clip(
            0, 255)
