"""Vision datasets.

Counterpart of ``incubator_mxnet_tpu/gluon/data/vision/datasets.py`` (ref:
python/mxnet/gluon/data/vision/datasets.py — MNIST, FashionMNIST,
CIFAR10, CIFAR100, ImageRecordDataset, ImageFolderDataset). Nothing
downloads: the loaders read the standard files when they are under
``root``, and otherwise make the reference's seeded synthetic sample (the
same shapes, types and classes; the same pixels). Samples are host arrays
(``cpu()``), so process workers can take them and ``DevicePrefetcher``
copies the batches to the card.
"""
from __future__ import annotations

import gzip
import os
import struct
from typing import Callable, Optional

import numpy as _np

from ..dataset import Dataset
from ....context import cpu
from ....ndarray.ndarray import array as nd_array

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


class _DownloadedDataset(Dataset):
    """(ref: datasets.py:_DownloadedDataset)"""

    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        root = os.path.expanduser(root)
        self._root = root
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


def _synthetic_images(n, shape, num_classes, seed, template_seed=1234):
    # class templates come from a FIXED seed shared by every split so a
    # model trained on the synthetic train split generalizes to the
    # synthetic test split (only sample choice + noise vary per split)
    t_rng = _np.random.RandomState(template_seed)
    base = t_rng.rand(num_classes, *shape).astype(_np.float32) * 255
    rng = _np.random.RandomState(seed)
    label = rng.randint(0, num_classes, size=(n,)).astype(_np.int32)
    noise = rng.rand(n, *shape).astype(_np.float32) * 64
    data = _np.clip(base[label] * 0.75 + noise, 0, 255).astype(_np.uint8)
    return data, label


class MNIST(_DownloadedDataset):
    """MNIST (ref: datasets.py:MNIST; raw format reader matches
    src/io/iter_mnist.cc:80). Falls back to synthetic 28x28x1/10-class data
    when the idx files are absent."""

    _TRAIN = ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz")
    _TEST = ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz")

    def __init__(self, root=os.path.join("~", ".mxtpu", "datasets", "mnist"),
                 train=True, transform=None, synthetic_size=None):
        self._train = train
        self._synthetic_size = synthetic_size
        super().__init__(root, transform)

    def _get_data(self):
        images, labels = (self._TRAIN if self._train else self._TEST)
        img_path = os.path.join(self._root, images)
        lbl_path = os.path.join(self._root, labels)
        if os.path.exists(img_path) and os.path.exists(lbl_path):
            with gzip.open(lbl_path, "rb") as fin:
                struct.unpack(">II", fin.read(8))
                label = _np.frombuffer(fin.read(), dtype=_np.uint8).astype(_np.int32)
            with gzip.open(img_path, "rb") as fin:
                _, n, rows, cols = struct.unpack(">IIII", fin.read(16))
                data = _np.frombuffer(fin.read(), dtype=_np.uint8)
                data = data.reshape(n, rows, cols, 1)
        else:
            n = self._synthetic_size or (60000 if self._train else 10000)
            n = min(n, 8192)  # keep synthetic fallback cheap
            data, label = _synthetic_images(n, (28, 28, 1), 10,
                                            seed=42 if self._train else 43)
        self._data = nd_array(data, ctx=cpu(), dtype="uint8")
        self._label = label

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]


class FashionMNIST(MNIST):
    """(ref: datasets.py:FashionMNIST)"""

    def __init__(self, root=os.path.join("~", ".mxtpu", "datasets",
                                         "fashion-mnist"), train=True,
                 transform=None, synthetic_size=None):
        super().__init__(root, train, transform, synthetic_size)


class CIFAR10(_DownloadedDataset):
    """(ref: datasets.py:CIFAR10) binary-batch reader; synthetic fallback."""

    _NUM_CLASSES = 10

    def __init__(self, root=os.path.join("~", ".mxtpu", "datasets", "cifar10"),
                 train=True, transform=None, synthetic_size=None):
        self._train = train
        self._synthetic_size = synthetic_size
        super().__init__(root, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            raw = _np.frombuffer(fin.read(), dtype=_np.uint8)
        rec = raw.reshape(-1, 3072 + self._label_bytes())
        data = rec[:, self._label_bytes():].reshape(-1, 3, 32, 32)
        label = rec[:, self._label_bytes() - 1].astype(_np.int32)
        return data.transpose(0, 2, 3, 1), label

    def _label_bytes(self):
        return 1

    def _get_data(self):
        if self._train:
            files = [os.path.join(self._root, f"data_batch_{i}.bin")
                     for i in range(1, 6)]
        else:
            files = [os.path.join(self._root, "test_batch.bin")]
        if all(os.path.exists(f) for f in files):
            parts = [self._read_batch(f) for f in files]
            data = _np.concatenate([p[0] for p in parts])
            label = _np.concatenate([p[1] for p in parts])
        else:
            n = self._synthetic_size or (50000 if self._train else 10000)
            n = min(n, 8192)
            data, label = _synthetic_images(n, (32, 32, 3), self._NUM_CLASSES,
                                            seed=44 if self._train else 45)
        self._data = nd_array(data, ctx=cpu(), dtype="uint8")
        self._label = label


class CIFAR100(CIFAR10):
    """(ref: datasets.py:CIFAR100)"""

    _NUM_CLASSES = 100

    def __init__(self, root=os.path.join("~", ".mxtpu", "datasets", "cifar100"),
                 fine_label=False, train=True, transform=None,
                 synthetic_size=None):
        self._fine_label = fine_label
        super().__init__(root, train, transform, synthetic_size)

    def _label_bytes(self):
        return 2


class ImageRecordDataset(Dataset):
    """Images from a RecordIO pack (ref: datasets.py:ImageRecordDataset)."""

    def __init__(self, filename, flag=1, transform=None):
        from ..dataset import RecordFileDataset
        self._record = RecordFileDataset(filename)
        self._flag = flag
        self._transform = transform

    def __len__(self):
        return len(self._record)

    def __getitem__(self, idx):
        from ....recordio import unpack_img
        header, img = unpack_img(self._record[idx], self._flag)
        img = nd_array(img, ctx=cpu())
        if self._transform is not None:
            return self._transform(img, header.label)
        return img, header.label


class ImageFolderDataset(Dataset):
    """class-per-subfolder layout (ref: datasets.py:ImageFolderDataset)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png", ".npy"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                ext = os.path.splitext(filename)[1].lower()
                if ext in self._exts:
                    self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        from ....image import imread
        fname, label = self.items[idx]
        with cpu():
            img = (nd_array(_np.load(fname)) if fname.endswith(".npy")
                   else imread(fname, self._flag))
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
