"""Contrib data iterators (ref: python/mxnet/contrib/io.py).

Counterpart of ``incubator_mxnet_tpu/contrib/io.py``: ``DataLoaderIter``
hands a ``gluon.data.DataLoader``'s batches out as ``io.DataBatch``es."""
from __future__ import annotations

from ..io import DataIter, DataDesc, DataBatch


class DataLoaderIter(DataIter):
    """Adapts a ``gluon.data.DataLoader`` to the DataIter interface so the
    symbolic Module API can consume it (ref: contrib/io.py:25
    DataLoaderIter)."""

    def __init__(self, loader, data_name="data", label_name="softmax_label",
                 dtype="float32"):
        super().__init__()
        self._loader = loader
        self._dtype = dtype
        self._iter = iter(self._loader)
        self._pending = self._make_batch(next(self._iter))
        data = self._pending.data[0]
        label = self._pending.label[0]
        self.batch_size = data.shape[0]
        self.provide_data = [DataDesc(data_name, tuple(data.shape))]
        self.provide_label = [DataDesc(label_name, tuple(label.shape))]

    def _make_batch(self, pair):
        data, label = pair
        return DataBatch([data.astype(self._dtype)],
                         [label.astype(self._dtype)], pad=0)

    def reset(self):
        self._iter = iter(self._loader)
        self._pending = None

    def next(self):
        if self._pending is not None:
            batch, self._pending = self._pending, None
            return batch
        return self._make_batch(next(self._iter))  # StopIteration at end
