"""Samplers (ref: python/mxnet/gluon/data/sampler.py — Sampler,
SequentialSampler, RandomSampler, BatchSampler).

Counterpart of ``incubator_mxnet_tpu/gluon/data/sampler.py``;
``RandomSampler`` draws from numpy's global generator, as the
reference's does."""
from __future__ import annotations

import numpy as _np

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler"]


class Sampler:
    """(ref: sampler.py:Sampler)"""

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    """(ref: sampler.py:SequentialSampler)"""

    def __init__(self, length):
        self._length = length

    def __iter__(self):
        return iter(range(self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    """(ref: sampler.py:RandomSampler)"""

    def __init__(self, length):
        self._length = length

    def __iter__(self):
        indices = _np.random.permutation(self._length)
        return iter(indices.tolist())

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    """(ref: sampler.py:BatchSampler; last_batch keep/discard/rollover)"""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "discard":
                return
            elif self._last_batch == "rollover":
                self._prev = batch
            else:
                raise ValueError(
                    "last_batch must be one of 'keep', 'discard', or "
                    f"'rollover', but got {self._last_batch}")

    def __len__(self):
        if self._last_batch == "keep":
            return (len(self._sampler) + self._batch_size - 1) // self._batch_size
        if self._last_batch == "discard":
            return len(self._sampler) // self._batch_size
        if self._last_batch == "rollover":
            return (len(self._prev) + len(self._sampler)) // self._batch_size
        raise ValueError(
            "last_batch must be one of 'keep', 'discard', or 'rollover', "
            f"but got {self._last_batch}")
