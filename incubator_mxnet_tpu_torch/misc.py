"""Deprecated learning-rate scheduler aliases (ref: python/mxnet/misc.py,
kept there for pre-1.0 compatibility), delegating to ``lr_scheduler``.
Counterpart of ``incubator_mxnet_tpu/misc.py``."""
from __future__ import annotations

from .lr_scheduler import LRScheduler as LearningRateScheduler  # noqa: F401
from .lr_scheduler import FactorScheduler  # noqa: F401

__all__ = ["LearningRateScheduler", "FactorScheduler"]
