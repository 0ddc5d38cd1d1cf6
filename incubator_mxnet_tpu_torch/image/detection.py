"""Detection augmenters and the detection iterator.

Counterpart of ``incubator_mxnet_tpu/image/detection.py`` (ref:
python/mxnet/image/detection.py — DetAugmenter hierarchy :39-481,
CreateDetAugmenter :482, ImageDetIter :602). Labels ride with the pixels
through every geometric transform: each label is (cls, xmin, ymin, xmax,
ymax) normalized to [0, 1], padded with -1 rows to a fixed object count
per image (the static-shape contract SSD training needs).

Augmentation runs on the host, one sample at a time, on numpy HWC float32
images: the ``Det*Aug`` draws come from the ``RandomState`` they are
given (numpy's global generator by default), in the reference's order,
so the same seed gives the same crops, pads and flips in both packages.
A borrowed pixel augmenter (``DetBorrowAug``) runs on a CPU NDArray.
``ImageDetIter`` makes its batch (NCHW float32 data, (B, max_objs, 5)
labels) on the current context of the thread that calls ``next()``, as
``io.ImageRecordIter`` does, so ``io.DevicePrefetcher`` takes it as it
takes that iterator's.
"""
from __future__ import annotations

from typing import List

import numpy as _np

from ..context import cpu
from ..io import DataBatch, DataDesc, DataIter, _resize_np
from ..ndarray.ndarray import NDArray, array as nd_array
from .image import (BrightnessJitterAug, CastAug, ColorNormalizeAug,
                    ContrastJitterAug, ForceResizeAug, SaturationJitterAug)

__all__ = ["DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
           "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
           "CreateDetAugmenter", "ImageDetIter"]


class DetAugmenter:
    """(ref: image/detection.py:39)"""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return [self.__class__.__name__.lower(), self._kwargs]

    def __call__(self, src: _np.ndarray, label: _np.ndarray):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Wrap a pixel-only augmenter; labels pass through
    (ref: image/detection.py:65)."""

    def __init__(self, augmenter):
        super().__init__(augmenter=augmenter.__class__.__name__)
        self.augmenter = augmenter

    def __call__(self, src, label):
        out = self.augmenter(nd_array(src, ctx=cpu()))
        if isinstance(out, NDArray):
            out = out.asnumpy()
        return _np.asarray(out, _np.float32), label


class DetRandomSelectAug(DetAugmenter):
    """Randomly pick one of the given augmenters, or skip
    (ref: image/detection.py:90)."""

    def __init__(self, aug_list, skip_prob=0.0, rng=None):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob
        self._rng = rng or _np.random

    def __call__(self, src, label):
        if self._rng.rand() < self.skip_prob or not self.aug_list:
            return src, label
        aug = self.aug_list[self._rng.randint(len(self.aug_list))]
        return aug(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror pixels and x coordinates together
    (ref: image/detection.py:126)."""

    def __init__(self, p=0.5, rng=None):
        super().__init__(p=p)
        self.p = p
        self._rng = rng or _np.random

    def __call__(self, src, label):
        if self._rng.rand() < self.p:
            src = src[:, ::-1]
            label = label.copy()
            valid = label[:, 0] >= 0
            x1 = label[valid, 1].copy()
            label[valid, 1] = 1.0 - label[valid, 3]
            label[valid, 3] = 1.0 - x1
        return src, label


class DetRandomCropAug(DetAugmenter):
    """Random crop keeping a minimum object overlap; boxes are clipped and
    dropped when their remaining area ratio falls below min_eject_coverage
    (ref: image/detection.py:152)."""

    def __init__(self, min_object_covered=0.5, min_eject_coverage=0.3,
                 aspect_ratio_range=(0.75, 1.33), area_range=(0.3, 1.0),
                 max_attempts=20, rng=None):
        super().__init__(min_object_covered=min_object_covered,
                         area_range=area_range)
        self.min_object_covered = min_object_covered
        self.min_eject_coverage = min_eject_coverage
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self._rng = rng or _np.random

    def __call__(self, src, label):
        h, w = src.shape[:2]
        for _ in range(self.max_attempts):
            area = self._rng.uniform(*self.area_range)
            ar = self._rng.uniform(*self.aspect_ratio_range)
            cw = min(1.0, _np.sqrt(area * ar))
            ch = min(1.0, _np.sqrt(area / ar))
            cx = self._rng.uniform(0, 1 - cw)
            cy = self._rng.uniform(0, 1 - ch)
            new_label = self._crop_labels(label, cx, cy, cw, ch)
            valid_in = label[:, 0] >= 0
            valid_out = new_label[:, 0] >= 0
            # accept only if some object keeps >= min_object_covered of its
            # area inside the crop (ref: detection.py min_object_covered)
            covered_ok = (valid_in.sum() == 0 or
                          self._max_coverage(label, cx, cy, cw, ch)
                          >= self.min_object_covered)
            if covered_ok and (valid_in.sum() == 0 or valid_out.sum() > 0):
                x0, y0 = int(cx * w), int(cy * h)
                x1, y1 = int((cx + cw) * w), int((cy + ch) * h)
                if x1 - x0 < 2 or y1 - y0 < 2:
                    continue
                return src[y0:y1, x0:x1], new_label
        return src, label

    def _max_coverage(self, label, cx, cy, cw, ch):
        best = 0.0
        for row in label:
            if row[0] < 0:
                continue
            bx1, by1, bx2, by2 = row[1:5]
            area = max(bx2 - bx1, 0) * max(by2 - by1, 0)
            ix1, iy1 = max(bx1, cx), max(by1, cy)
            ix2, iy2 = min(bx2, cx + cw), min(by2, cy + ch)
            inter = max(ix2 - ix1, 0) * max(iy2 - iy1, 0)
            if area > 0:
                best = max(best, inter / area)
        return best

    def _crop_labels(self, label, cx, cy, cw, ch):
        out = _np.full_like(label, -1.0)
        n = 0
        for row in label:
            if row[0] < 0:
                continue
            bx1, by1, bx2, by2 = row[1:5]
            area = max(bx2 - bx1, 0) * max(by2 - by1, 0)
            ix1, iy1 = max(bx1, cx), max(by1, cy)
            ix2, iy2 = min(bx2, cx + cw), min(by2, cy + ch)
            inter = max(ix2 - ix1, 0) * max(iy2 - iy1, 0)
            if area <= 0 or inter / area < self.min_eject_coverage:
                continue
            out[n, 0] = row[0]
            out[n, 1] = (ix1 - cx) / cw
            out[n, 2] = (iy1 - cy) / ch
            out[n, 3] = (ix2 - cx) / cw
            out[n, 4] = (iy2 - cy) / ch
            n += 1
        return out


class DetRandomPadAug(DetAugmenter):
    """Pad to a random larger canvas, rescaling labels
    (ref: image/detection.py:323)."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=20,
                 pad_val=(127, 127, 127), rng=None):
        super().__init__(area_range=area_range)
        self.area_range = area_range
        self.aspect_ratio_range = aspect_ratio_range
        self.pad_val = pad_val
        self._rng = rng or _np.random

    def __call__(self, src, label):
        h, w, c = src.shape
        scale = self._rng.uniform(*self.area_range)
        if scale <= 1.0:
            return src, label
        nw, nh = int(w * _np.sqrt(scale)), int(h * _np.sqrt(scale))
        x0 = self._rng.randint(0, nw - w + 1)
        y0 = self._rng.randint(0, nh - h + 1)
        canvas = _np.empty((nh, nw, c), src.dtype)
        canvas[:] = _np.asarray(self.pad_val, src.dtype)[:c]
        canvas[y0:y0 + h, x0:x0 + w] = src
        label = label.copy()
        valid = label[:, 0] >= 0
        label[valid, 1] = (label[valid, 1] * w + x0) / nw
        label[valid, 2] = (label[valid, 2] * h + y0) / nh
        label[valid, 3] = (label[valid, 3] * w + x0) / nw
        label[valid, 4] = (label[valid, 4] * h + y0) / nh
        return canvas, label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0,
                       min_object_covered=0.1, aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.3, 3.0), min_eject_coverage=0.3,
                       max_attempts=20, pad_val=(127, 127, 127), rng=None,
                       **kwargs) -> List[DetAugmenter]:
    """(ref: image/detection.py:482 CreateDetAugmenter)"""
    auglist: List[DetAugmenter] = []
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered, min_eject_coverage,
                                aspect_ratio_range,
                                (area_range[0], min(1.0, area_range[1])),
                                max_attempts, rng=rng)
        auglist.append(DetRandomSelectAug([crop], 1 - rand_crop, rng=rng))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (max(1.0, area_range[0]), area_range[1]),
                              max_attempts, pad_val, rng=rng)
        auglist.append(DetRandomSelectAug([pad], 1 - rand_pad, rng=rng))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5, rng=rng))
    # Borrow ONLY label-safe pixel augmenters: a uniform force-resize keeps
    # normalized labels valid; crops would desync labels and are handled by
    # the Det-specific augs above (ref: detection.py:482 borrows
    # resize/color/cast, never geometric crops).
    shape3 = (data_shape if len(data_shape) == 3
              else (3,) + tuple(data_shape))
    auglist.append(DetBorrowAug(ForceResizeAug((shape3[2], shape3[1]))))
    if brightness:
        auglist.append(DetBorrowAug(BrightnessJitterAug(brightness)))
    if contrast:
        auglist.append(DetBorrowAug(ContrastJitterAug(contrast)))
    if saturation:
        auglist.append(DetBorrowAug(SaturationJitterAug(saturation)))
    auglist.append(DetBorrowAug(CastAug()))
    # MXNet's CreateDetAugmenter reads True as the ImageNet statistics, as
    # CreateAugmenter does in both packages; the reference's
    # CreateDetAugmenter takes True as the number 1
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        mean = _np.zeros(3, _np.float32) if mean is None else _np.asarray(
            mean, _np.float32)
        std = _np.ones(3, _np.float32) if std is None else _np.asarray(
            std, _np.float32)
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(DataIter):
    """Detection iterator over .rec packs or in-memory lists
    (ref: image/detection.py:602 ImageDetIter). Labels are (B, max_objs, 5)
    float32 with -1 padding rows; data is NCHW float32."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 imglist=None, max_objs=16, shuffle=False, aug_list=None,
                 mean=None, std=None, seed=0, **kwargs):
        super().__init__(batch_size)
        self._data_shape = tuple(data_shape)
        self._max_objs = max_objs
        self._shuffle = shuffle
        self._rng = _np.random.RandomState(seed)
        self.auglist = (aug_list if aug_list is not None
                        else CreateDetAugmenter(data_shape, mean=mean,
                                                std=std, rng=self._rng))
        self._samples = []
        if path_imgrec:
            from ..recordio import MXRecordIO, unpack_img
            rec = MXRecordIO(path_imgrec, "r")
            while True:
                raw = rec.read()
                if raw is None:
                    break
                header, img = unpack_img(raw)
                self._samples.append((self._norm_label(header.label), img))
            rec.close()
        elif imglist is not None:
            for label, img in imglist:
                if isinstance(img, NDArray):
                    img = img.asnumpy()
                self._samples.append((self._norm_label(label),
                                      _np.asarray(img, _np.uint8)))
        else:
            raise ValueError("need path_imgrec or imglist")
        self.reset()

    def _norm_label(self, label) -> _np.ndarray:
        """Accepts flat [cls,x1,y1,x2,y2,...] or (N,5); pads to max_objs.
        Also accepts the reference's header format [2, 5, ...boxes] where
        the first two values are header/label widths."""
        lab = _np.asarray(label, _np.float32).reshape(-1)
        if lab.size >= 2 and lab[0] == 2 and lab[1] == 5 and \
                (lab.size - 2) % 5 == 0 and lab.size > 5:
            lab = lab[2:]
        if lab.size % 5:
            raise ValueError("detection label size must be a multiple of 5")
        lab = lab.reshape(-1, 5)[:self._max_objs]
        out = _np.full((self._max_objs, 5), -1.0, _np.float32)
        out[:len(lab)] = lab
        return out

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self._data_shape)]

    @property
    def provide_label(self):
        return [DataDesc("label", (self.batch_size, self._max_objs, 5))]

    def reset(self):
        n = len(self._samples)
        self._order = (self._rng.permutation(n) if self._shuffle
                       else _np.arange(n))
        self._cursor = 0

    def iter_next(self):
        return self._cursor < len(self._order)

    def next(self):
        if not self.iter_next():
            raise StopIteration
        c, h, w = self._data_shape
        n = len(self._order)
        pad = max(0, self._cursor + self.batch_size - n)
        data = _np.empty((self.batch_size, c, h, w), _np.float32)
        labels = _np.empty((self.batch_size, self._max_objs, 5), _np.float32)
        for i in range(self.batch_size):
            lab, img = self._samples[self._order[(self._cursor + i) % n]]
            lab = lab.copy()
            img = img.astype(_np.float32)
            if img.ndim == 2:
                img = img[:, :, None]
            with cpu():
                for aug in self.auglist:
                    img, lab = aug(img, lab)
            if img.shape[0] != h or img.shape[1] != w:
                img = _resize_np(img, w, h)
            data[i] = img.transpose(2, 0, 1)[:c]
            labels[i] = lab
        self._cursor += self.batch_size
        self._last_pad = pad
        return DataBatch(data=[nd_array(data)], label=[nd_array(labels)],
                         pad=pad)

    def getpad(self):
        return getattr(self, "_last_pad", 0)
