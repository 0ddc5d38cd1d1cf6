"""Image processing and augmentation.

Counterpart of ``incubator_mxnet_tpu/image/image.py`` (ref:
python/mxnet/image/image.py — imread/imdecode/imresize, the crops,
resize_short, color_normalize, the Augmenter hierarchy:607+,
ImageIter:1131).

Decoding goes through the native codec (``_native``) and takes PIL only
where the native library is unavailable or lacks the format. ``imresize``
is PyTorch's bilinear resize with ``antialias=True``, which, like the
reference's ``jax.image.resize(..., "linear")``, widens its kernel when it
shrinks an image; ``interp=0`` takes the nearest pixel centre, in the
reference's float32 index arithmetic. The host augmenters draw from
Python's ``random`` and numpy's global generator in the reference's
order, so a seeded run crops and flips as the reference's does. Constants an op
adds are made on its input's device.
"""
from __future__ import annotations

import os
import random as _pyrandom

import numpy as _np
import torch
import torch.nn.functional as F

from ..context import cpu
from ..io import DataBatch, DataDesc, DataIter
from ..ndarray.ndarray import NDArray, _as_nd, array as nd_array, invoke

__all__ = ["imread", "imdecode", "imresize", "resize_short", "fixed_crop",
           "scale_down", "copyMakeBorder", "random_crop", "center_crop",
           "color_normalize", "random_size_crop", "Augmenter",
           "SequentialAug", "RandomOrderAug", "ResizeAug", "ForceResizeAug",
           "RandomCropAug", "RandomSizedCropAug", "CenterCropAug",
           "HorizontalFlipAug", "CastAug", "ColorNormalizeAug",
           "BrightnessJitterAug", "ContrastJitterAug", "SaturationJitterAug",
           "HueJitterAug", "ColorJitterAug", "LightingAug", "RandomGrayAug",
           "CreateAugmenter", "ImageIter"]


def _like(value, src: NDArray) -> NDArray:
    """``value`` as an NDArray on ``src``'s device."""
    return value if isinstance(value, NDArray) else nd_array(
        value, ctx=src.context)


def imdecode(buf, flag: int = 1, to_rgb: bool = True) -> NDArray:
    """HWC uint8 pixels of JPEG/PNG bytes (ref: image.py imdecode): RGB
    with ``flag`` 1, one gray channel with 0 (PIL's luma)."""
    from ..recordio import _decode
    if isinstance(buf, NDArray):
        buf = buf.asnumpy().tobytes()
    arr = _decode(bytes(buf), 0 if flag == 0 else 1)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return nd_array(arr, dtype="uint8")


def imread(filename: str, flag: int = 1, to_rgb: bool = True) -> NDArray:
    """(ref: image.py imread) :func:`imdecode` of the file's bytes."""
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag, to_rgb)


def _nearest_index(m: int, n: int, device) -> torch.Tensor:
    """The source index of each of ``n`` outputs from ``m`` inputs, in the
    reference's float32 arithmetic: floor((i + 0.5) * m / n)."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    return ((i + 0.5) * m / n).floor().long()


def _resize_hwc(x: torch.Tensor, h: int, w: int, interp: int) -> torch.Tensor:
    if interp == 0:
        rows = _nearest_index(x.shape[0], h, x.device)
        cols = _nearest_index(x.shape[1], w, x.device)
        return x[rows][:, cols]
    out = F.interpolate(x.permute(2, 0, 1)[None], size=(h, w),
                        mode="bilinear", align_corners=False, antialias=True)
    return out[0].permute(1, 2, 0)


def imresize(src: NDArray, w: int, h: int, interp: int = 1) -> NDArray:
    """Resize an HWC image to (h, w) (ref: image.py imresize): bilinear,
    antialiased when it shrinks, in float32; uint8 input is rounded and
    clipped back to uint8."""
    src = _as_nd(src)

    def f(x):
        out = _resize_hwc(x.to(torch.float32), h, w, interp)
        if x.dtype == torch.uint8:
            return out.round().clamp(0, 255).to(torch.uint8)
        return out.to(x.dtype).contiguous()
    return invoke(f, [src], "imresize")


def resize_short(src: NDArray, size: int, interp: int = 2) -> NDArray:
    """(ref: image.py resize_short)"""
    h, w = src.shape[0], src.shape[1]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src: NDArray, x0: int, y0: int, w: int, h: int,
               size=None, interp: int = 2) -> NDArray:
    """(ref: image.py fixed_crop)"""
    out = src[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def random_crop(src: NDArray, size, interp: int = 2):
    """(ref: image.py random_crop)"""
    h, w = src.shape[0], src.shape[1]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = _pyrandom.randint(0, w - new_w)
    y0 = _pyrandom.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src: NDArray, size, interp: int = 2):
    """(ref: image.py center_crop)"""
    h, w = src.shape[0], src.shape[1]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src: NDArray, size, area, ratio, interp: int = 2):
    """(ref: image.py random_size_crop)"""
    h, w = src.shape[0], src.shape[1]
    src_area = h * w
    if isinstance(area, (float, int)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = _pyrandom.uniform(*area) * src_area
        log_ratio = (_np.log(ratio[0]), _np.log(ratio[1]))
        new_ratio = _np.exp(_pyrandom.uniform(*log_ratio))
        new_w = int(round(_np.sqrt(target_area * new_ratio)))
        new_h = int(round(_np.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = _pyrandom.randint(0, w - new_w)
            y0 = _pyrandom.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def color_normalize(src: NDArray, mean, std=None) -> NDArray:
    """(ref: image.py color_normalize)"""
    src = src.astype("float32")
    if mean is not None:
        src = src - _like(mean, src)
    if std is not None:
        src = src / _like(std, src)
    return src


# ---------------------------------------------------------------------------
# augmenters (ref: image.py:607+)
# ---------------------------------------------------------------------------

class Augmenter:
    """(ref: image.py:Augmenter)"""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for aug in self.ts:
            src = aug(src)
        return src


class RandomOrderAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        ts = list(self.ts)
        _pyrandom.shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size = size
        self.area = area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            return invoke(lambda x: torch.flip(x, (1,)), [src], "flip")
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = mean
        self.std = std

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.brightness, self.brightness)
        return src * alpha


class ContrastJitterAug(Augmenter):
    coef = _np.array([[[0.299, 0.587, 0.114]]], _np.float32)

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.contrast, self.contrast)
        gray = float((src.asnumpy() * self.coef).sum() /
                     (src.shape[0] * src.shape[1]))
        return src * alpha + gray * (1.0 - alpha)


class SaturationJitterAug(Augmenter):
    coef = _np.array([[[0.299, 0.587, 0.114]]], _np.float32)

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.saturation, self.saturation)
        gray = (src * _like(self.coef, src)).sum(axis=2, keepdims=True)
        return src * alpha + gray * (1.0 - alpha)


class HueJitterAug(Augmenter):
    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue

    def __call__(self, src):
        alpha = _pyrandom.uniform(-self.hue, self.hue)
        rolled = invoke(lambda v: torch.roll(v, 1, dims=-1), [src],
                        "hue_roll")
        return src * (1 - abs(alpha)) + rolled * abs(alpha)


class ColorJitterAug(RandomOrderAug):
    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = _np.asarray(eigval, _np.float32)
        self.eigvec = _np.asarray(eigvec, _np.float32)

    def __call__(self, src):
        alpha = _np.random.normal(0, self.alphastd,
                                  size=(3,)).astype(_np.float32)
        rgb = _np.dot(self.eigvec * alpha, self.eigval)
        return src + _like(rgb, src)


class RandomGrayAug(Augmenter):
    mat = _np.array([[0.21, 0.21, 0.21],
                     [0.72, 0.72, 0.72],
                     [0.07, 0.07, 0.07]], _np.float32)

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        from ..ndarray.ndarray import dot
        if _pyrandom.random() < self.p:
            return dot(src, _like(self.mat, src))
        return src


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """(ref: image.py:1017 CreateAugmenter)"""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = _np.array([55.46, 4.794, 1.148])
        eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    if mean is not None and std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter(DataIter):
    """Python image iterator with augmenters (ref: image.py:1131
    ImageIter) over a record pack or a list of image files. Samples are
    decoded and augmented on the host; a batch lands on the current
    context of the thread that calls ``next()``."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 path_imgidx=None, shuffle=False, part_index=0, num_parts=1,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        assert path_imgrec or path_imglist or imglist is not None
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        self.auglist = aug_list if aug_list is not None \
            else CreateAugmenter(data_shape, **kwargs)
        self.imglist = []
        if path_imgrec:
            from ..recordio import IndexedRecordIO, RecordIO
            if path_imgidx:
                self.imgrec = IndexedRecordIO(path_imgidx, path_imgrec, "r")
                self.imgidx = list(self.imgrec.keys)
            else:
                self.imgrec = RecordIO(path_imgrec, "r")
                self.imgidx = None
        else:
            self.imgrec = None
            if path_imglist:
                with open(path_imglist) as fin:
                    for line in fin:
                        parts = line.strip().split("\t")
                        label = _np.asarray(parts[1:-1], _np.float32)
                        self.imglist.append((label, parts[-1]))
            else:
                for item in imglist:
                    self.imglist.append((_np.asarray(item[:-1], _np.float32),
                                         item[-1]))
            self.path_root = path_root
        if self.imgrec is None:
            self.seq = list(range(part_index, len(self.imglist), num_parts))
        elif self.imgidx is not None:
            self.seq = list(range(part_index, len(self.imgidx), num_parts))
        else:
            self.seq = None
        self.provide_data = [DataDesc(data_name,
                                      (batch_size,) + self.data_shape)]
        self.provide_label = [DataDesc(label_name, (batch_size, label_width)
                                       if label_width > 1 else (batch_size,))]
        self.reset()

    def reset(self):
        if self.seq is not None and self.shuffle:
            _np.random.shuffle(self.seq)
        self.cur = 0
        if self.imgrec is not None and self.seq is None:
            self.imgrec.reset()

    def next_sample(self):
        from ..recordio import unpack_img
        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.imgrec is not None:
                header, img = unpack_img(
                    self.imgrec.read_idx(self.imgidx[idx]))
                return header.label, nd_array(img, dtype="uint8")
            label, fname = self.imglist[idx]
            return label, imread(os.path.join(self.path_root, fname))
        s = self.imgrec.read()
        if s is None:
            raise StopIteration
        header, img = unpack_img(s)
        return header.label, nd_array(img, dtype="uint8")

    def next(self):
        batch_data, batch_label = [], []
        with cpu():
            for _ in range(self.batch_size):
                label, img = self.next_sample()
                for aug in self.auglist:
                    img = aug(img)
                arr = img.asnumpy()
                if arr.ndim == 2:
                    arr = arr[:, :, None]
                batch_data.append(arr.transpose(2, 0, 1).astype(_np.float32))
                lab = _np.asarray(label, _np.float32).reshape(
                    -1)[:self.label_width]
                batch_label.append(lab if self.label_width > 1
                                   else float(lab[0]))
        data = nd_array(_np.stack(batch_data))
        label = nd_array(_np.asarray(batch_label, _np.float32))
        return DataBatch(data=[data], label=[label], pad=0)


def scale_down(src_size, size):
    """Scale ``size`` down to fit within ``src_size``, keeping its aspect
    (ref: image.py scale_down)."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def copyMakeBorder(src, top, bot, left, right, border_type=0, values=0.0):
    """Pad an HWC image with a border (ref: _cvcopyMakeBorder,
    src/io/image_io.cc; cv2 semantics: type 0 a constant ``values``, type
    1 the edge pixel replicated)."""
    src = _as_nd(src)

    def f(x):
        if border_type == 1:
            hs = torch.arange(-top, x.shape[0] + bot, device=x.device)
            ws = torch.arange(-left, x.shape[1] + right, device=x.device)
            return x[hs.clamp(0, x.shape[0] - 1)][:, ws.clamp(
                0, x.shape[1] - 1)]
        pads = (0, 0) * (x.ndim - 2) + (left, right, top, bot)
        return F.pad(x, pads, value=values)
    return invoke(f, [src], "copyMakeBorder")
