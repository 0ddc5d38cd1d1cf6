"""``mx.nd.image``: the image operators.

Counterpart of ``incubator_mxnet_tpu/ndarray/image.py`` (ref:
src/operator/image/image_random.cc — _image_to_tensor, _image_normalize,
the flips, random_brightness/contrast/saturation/hue/color_jitter,
adjust_lighting/random_lighting). HWC or NHWC input, uint8 or float, as
in the reference. The random ops draw their factors from the port's
``random`` generator of the current context (``mx.random.seed`` repeats
them); they are not JAX's streams, so they are held to what they compute,
not to the reference's numbers.
"""
from __future__ import annotations

import math

import torch

from .ndarray import invoke, _as_nd
from .. import random as _random

__all__ = ["to_tensor", "normalize", "flip_left_right", "flip_top_bottom",
           "random_flip_left_right", "random_flip_top_bottom",
           "random_brightness", "random_contrast", "random_saturation",
           "random_hue", "random_color_jitter", "adjust_lighting",
           "random_lighting"]

# ITU-R BT.601 luma weights (image_random-inl.h RGB2GRAY_CONVERT_R/G/B)
_R, _G, _B = 0.299, 0.587, 0.114
_EIGVAL = (55.46, 4.794, 1.148)
_EIGVEC = ((-0.5675, 0.7192, 0.4009),
           (-0.5808, -0.0045, -0.8140),
           (-0.5836, -0.6948, 0.4203))


def _hwc_axes(x):
    """(h, w, c) axes of HWC or NHWC input."""
    if x.ndim == 3:
        return 0, 1, 2
    if x.ndim == 4:
        return 1, 2, 3
    raise ValueError(f"image ops expect HWC or NHWC input, got shape "
                     f"{tuple(x.shape)}")


def to_tensor(data):
    """HWC [0, 255] -> CHW [0, 1] float32 (ref: image_random.cc:41)."""
    def f(x):
        _hwc_axes(x)
        perm = (2, 0, 1) if x.ndim == 3 else (0, 3, 1, 2)
        return (x.to(torch.float32) / 255.0).permute(perm).contiguous()
    return invoke(f, [_as_nd(data)], "to_tensor")


def normalize(data, mean=0.0, std=1.0):
    """Channel-wise (x - mean) / std on CHW or NCHW float input (ref:
    image_random.cc:51)."""
    def f(x):
        m = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
        s = torch.as_tensor(std, dtype=torch.float32, device=x.device)
        if m.ndim:
            m = m.reshape(-1, 1, 1)
        if s.ndim:
            s = s.reshape(-1, 1, 1)
        return (x - m) / s
    return invoke(f, [_as_nd(data)], "normalize")


def flip_left_right(data):
    """(ref: image_random.cc:67)"""
    return invoke(lambda x: torch.flip(x, (_hwc_axes(x)[1],)),
                  [_as_nd(data)], "flip_left_right")


def flip_top_bottom(data):
    """(ref: image_random.cc:75)"""
    return invoke(lambda x: torch.flip(x, (_hwc_axes(x)[0],)),
                  [_as_nd(data)], "flip_top_bottom")


def _draw(lo, hi) -> float:
    return float(_random.uniform(lo, hi, shape=(1,)).asnumpy()[0])


def random_flip_left_right(data):
    return flip_left_right(data) if _draw(0, 1) < 0.5 else _as_nd(data)


def random_flip_top_bottom(data):
    return flip_top_bottom(data) if _draw(0, 1) < 0.5 else _as_nd(data)


def _gray(x):
    return x[..., 0:1] * _R + x[..., 1:2] * _G + x[..., 2:3] * _B


def _brightness(x, alpha):
    return x * alpha


def _contrast(x, alpha):
    h, w, _ = _hwc_axes(x)
    mean = torch.mean(_gray(x), dim=(h, w), keepdim=True)
    return x * alpha + mean * (1.0 - alpha)


def _saturation(x, alpha):
    return x * alpha + _gray(x) * (1.0 - alpha)


def _hue(x, alpha):
    """YIQ rotation by ``alpha`` half-turns (image_random-inl.h RandomHue:
    the tyiq / ityiq matrices)."""
    f32 = dict(dtype=torch.float32, device=x.device)
    u, w = math.cos(alpha * math.pi), math.sin(alpha * math.pi)
    t_yiq = torch.tensor([[0.299, 0.587, 0.114],
                          [0.596, -0.274, -0.321],
                          [0.211, -0.523, 0.311]], **f32)
    t_rgb = torch.tensor([[1.0, 0.956, 0.621],
                          [1.0, -0.272, -0.647],
                          [1.0, -1.107, 1.705]], **f32)
    rot = torch.tensor([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]], **f32)
    return torch.einsum("...c,dc->...d", x, t_rgb @ rot @ t_yiq)


def random_brightness(data, min_factor, max_factor):
    """(ref: image_random.cc:83)"""
    a = _draw(min_factor, max_factor)
    return invoke(lambda x: _brightness(x, a), [_as_nd(data)],
                  "random_brightness")


def random_contrast(data, min_factor, max_factor):
    a = _draw(min_factor, max_factor)
    return invoke(lambda x: _contrast(x, a), [_as_nd(data)],
                  "random_contrast")


def random_saturation(data, min_factor, max_factor):
    a = _draw(min_factor, max_factor)
    return invoke(lambda x: _saturation(x, a), [_as_nd(data)],
                  "random_saturation")


def random_hue(data, min_factor, max_factor):
    a = _draw(min_factor, max_factor)
    return invoke(lambda x: _hue(x, a), [_as_nd(data)], "random_hue")


def random_color_jitter(data, brightness=0.0, contrast=0.0, saturation=0.0,
                        hue=0.0):
    """Brightness, contrast, saturation and hue jitter in a random order
    (ref: image_random.cc:110)."""
    order = _random.uniform(0, 1, shape=(4,)).asnumpy().argsort()
    out = _as_nd(data)
    for i in order:
        if i == 0 and brightness > 0:
            out = random_brightness(out, 1 - brightness, 1 + brightness)
        elif i == 1 and contrast > 0:
            out = random_contrast(out, 1 - contrast, 1 + contrast)
        elif i == 2 and saturation > 0:
            out = random_saturation(out, 1 - saturation, 1 + saturation)
        elif i == 3 and hue > 0:
            out = random_hue(out, -hue, hue)
    return out


def adjust_lighting(data, alpha):
    """AlexNet's PCA lighting shift (ref: image_random.cc:117): ``alpha``
    scales each of the three eigenvalues."""
    a = torch.as_tensor(alpha, dtype=torch.float32).reshape(3)

    def f(x):
        eigval = torch.tensor(_EIGVAL, dtype=torch.float32)
        eigvec = torch.tensor(_EIGVEC, dtype=torch.float32)
        return x + (eigvec @ (a * eigval)).to(x.device)
    return invoke(f, [_as_nd(data)], "adjust_lighting")


def random_lighting(data, alpha_std=0.05):
    """(ref: image_random.cc:124)"""
    return adjust_lighting(
        data, _random.normal(0.0, alpha_std, shape=(3,)).asnumpy())
