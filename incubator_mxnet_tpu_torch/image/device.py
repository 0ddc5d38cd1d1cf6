"""Crop and mirror of a uint8 batch on its device.

Counterpart of ``incubator_mxnet_tpu/image/device.py``. The host decode
pipeline can emit raw uint8 NHWC frames (``ImageRecordIter(dtype=
"uint8")``); the random crop and mirror then run on the card, where the
step runs, instead of on the host's decode workers (ref: the rand_crop /
rand_mirror stages of src/io/image_aug_default.cc, moved to the device).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import random as _random
from ..ndarray.ndarray import NDArray, _wrap

__all__ = ["random_crop_flip"]


def random_crop_flip(x, size: Tuple[int, int], key=None,
                     rand_crop: bool = True, rand_mirror: bool = True):
    """Per-image random crop to ``size`` and horizontal mirror.

    ``x`` is a (B, H, W, C) batch (an NDArray or a tensor, any type); the
    result is (B, size[0], size[1], C) of the same kind, on the same
    device. The offsets (row, then column) and then the flips are drawn
    from ``key``, a ``torch.Generator`` on ``x``'s device (None: the
    device's generator, ``random.generator``). ``rand_crop=False`` takes
    the centre; ``rand_mirror=False`` flips nothing. One index gather, no
    host sync and no host-to-device copy, so the call can be captured in
    a CUDA graph (with ``key`` registered with it)."""
    t = x._data if isinstance(x, NDArray) else x
    B, H, W, C = t.shape
    th, tw = size
    if th > H or tw > W:
        raise ValueError(f"crop {tuple(size)} larger than input {(H, W)}")
    dev = t.device
    g = _random.step_generator(key, dev)
    if rand_crop:
        oh = torch.randint(0, H - th + 1, (B,), generator=g, device=dev)
        ow = torch.randint(0, W - tw + 1, (B,), generator=g, device=dev)
    else:
        oh = torch.full((B,), (H - th) // 2, dtype=torch.int64, device=dev)
        ow = torch.full((B,), (W - tw) // 2, dtype=torch.int64, device=dev)
    cols = ow[:, None] + torch.arange(tw, device=dev)
    if rand_mirror:
        flip = torch.rand((B,), generator=g, device=dev) < 0.5
        cols = torch.where(flip[:, None], cols.flip(1), cols)
    rows = oh[:, None] + torch.arange(th, device=dev)
    batch = torch.arange(B, device=dev)[:, None, None]
    out = t[batch, rows[:, :, None], cols[:, None, :]]
    return _wrap(out) if isinstance(x, NDArray) else out
