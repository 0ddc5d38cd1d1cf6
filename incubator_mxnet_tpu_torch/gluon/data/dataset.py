"""Gluon datasets.

Counterpart of ``incubator_mxnet_tpu/gluon/data/dataset.py`` (ref:
python/mxnet/gluon/data/dataset.py — Dataset, SimpleDataset, ArrayDataset,
RecordFileDataset, _LazyTransformDataset).
"""
from __future__ import annotations

import os

from ...ndarray.ndarray import NDArray

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    """(ref: dataset.py:Dataset)"""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        return SimpleDataset([self[i] for i in range(len(self))
                              if fn(self[i])])

    def transform(self, fn, lazy=True):
        """(ref: dataset.py transform)"""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        return self.transform(_TransformFirstClosure(fn), lazy)

    def take(self, count):
        return SimpleDataset([self[i] for i in range(min(count, len(self)))])

    def shard(self, num_shards, index):
        """Every ``num_shards``-th sample from ``index`` (the reference's
        helper for several input pipelines)."""
        assert 0 <= index < num_shards
        return SimpleDataset([self[i]
                              for i in range(index, len(self), num_shards)])


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class SimpleDataset(Dataset):
    """(ref: dataset.py:SimpleDataset)"""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    """(ref: dataset.py:_LazyTransformDataset)"""

    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class ArrayDataset(Dataset):
    """Zip of arrays or lists (ref: dataset.py:ArrayDataset); a 1-D
    NDArray is kept as numpy, as in the reference."""

    def __init__(self, *args):
        assert len(args) > 0, "Needs at least 1 arrays"
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            assert len(data) == self._length, \
                f"All arrays must have the same length; array[0] has length " \
                f"{self._length} while array[{i}] has {len(data)}."
            if isinstance(data, NDArray) and data.ndim == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """The raw records of a RecordIO file, by the index of its ``.idx``
    side file (ref: dataset.py:RecordFileDataset)."""

    def __init__(self, filename):
        from ...recordio import IndexedRecordIO
        self.idx_file = os.path.splitext(filename)[0] + ".idx"
        self.filename = filename
        self._record = IndexedRecordIO(self.idx_file, self.filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)

