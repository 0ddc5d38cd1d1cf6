"""Contrib samplers (ref: python/mxnet/gluon/contrib/data/sampler.py).

Counterpart of ``incubator_mxnet_tpu/gluon/contrib/data/sampler.py``."""
from __future__ import annotations

from ...data import sampler


class IntervalSampler(sampler.Sampler):
    """Samples elements at fixed intervals, sweeping each offset in turn
    (ref: contrib/data/sampler.py:25): for length=N, interval=k yields
    0, k, 2k, ..., then 1, k+1, ... With rollover=False only the first
    sweep (offset 0) is produced.
    """

    def __init__(self, length, interval, rollover=True):
        if interval > length:
            raise ValueError(
                f"interval {interval} must be <= length {length}")
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        for i in range(self._interval if self._rollover else 1):
            for j in range(i, self._length, self._interval):
                yield j

    def __len__(self):
        if self._rollover:
            return self._length
        return len(range(0, self._length, self._interval))
