"""Learning-rate schedulers.

Counterpart of ``incubator_mxnet_tpu/lr_scheduler.py``: plain Python, the
same schedules (ref: python/mxnet/lr_scheduler.py —
FactorScheduler, MultiFactorScheduler, PolyScheduler, CosineScheduler, all
with linear warmup).
"""
from __future__ import annotations

import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler", "BackoffScheduler"]


class LRScheduler:
    """(ref: lr_scheduler.py:LRScheduler)"""

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode="linear"):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        self.warmup_mode = warmup_mode
        if warmup_mode not in ("linear", "constant"):
            raise ValueError("Supports only linear and constant warmup modes")

    def get_warmup_lr(self, num_update: int) -> float:
        assert num_update < self.warmup_steps
        if self.warmup_mode == "linear":
            inc = ((self.warmup_final_lr - self.warmup_begin_lr)
                   * num_update / self.warmup_steps)
            return self.warmup_begin_lr + inc
        return self.warmup_begin_lr

    def __call__(self, num_update: int) -> float:
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr *= factor every `step` updates (ref: lr_scheduler.py:FactorScheduler)."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8, base_lr=0.01,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if step < 1:
            raise ValueError("Schedule step must be greater or equal than 1")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr reduce")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """lr *= factor at given steps (ref: lr_scheduler.py:MultiFactorScheduler)."""

    def __init__(self, step, factor=1, base_lr=0.01, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        assert isinstance(step, list) and len(step) >= 1
        for i, _step in enumerate(step):
            if i != 0 and step[i] <= step[i - 1]:
                raise ValueError("Schedule step must be an increasing list")
            if _step < 1:
                raise ValueError("Schedule step must be greater or equal than 1")
        self.step = step
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
            else:
                return self.base_lr
        return self.base_lr


class PolyScheduler(LRScheduler):
    """Polynomial decay to final_lr (ref: lr_scheduler.py:PolyScheduler)."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        assert isinstance(max_update, int)
        if max_update < 1:
            raise ValueError("maximum number of updates must be strictly positive")
        self.power = pwr
        self.base_lr_orig = self.base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            self.base_lr = (self.final_lr
                            + (self.base_lr_orig - self.final_lr)
                            * pow(1 - (num_update - self.warmup_steps)
                                  / self.max_steps, self.power))
        return self.base_lr


class BackoffScheduler(LRScheduler):
    """Runtime LR-backoff wrapper for ``guard.TrainingGuard`` rollbacks.

    Wraps any scheduler (or a constant ``base_lr``) and multiplies its
    output by a ``backoff`` multiplier; ``step_back()`` tightens the
    multiplier (guard calls it on every rollback), ``min_lr`` floors the
    result so repeated rollbacks cannot stall training at lr=0.
    """

    def __init__(self, schedule=None, base_lr=0.01, factor=0.5, min_lr=0.0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        if schedule is not None:
            base_lr = schedule.base_lr
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if not (0.0 < factor <= 1.0):
            raise ValueError("backoff factor must be in (0, 1]")
        self.schedule = schedule
        self.factor = factor
        self.min_lr = min_lr
        self.backoff = 1.0

    def step_back(self, factor=None) -> float:
        """Tighten the multiplier by ``factor`` (default: the configured
        one); returns the new multiplier."""
        self.backoff *= self.factor if factor is None else factor
        return self.backoff

    def __call__(self, num_update: int) -> float:
        if self.schedule is not None:
            lr = self.schedule(num_update)
        elif num_update < self.warmup_steps:
            lr = self.get_warmup_lr(num_update)
        else:
            lr = self.base_lr
        return max(self.min_lr, lr * self.backoff)


class CosineScheduler(LRScheduler):
    """Cosine decay (ref: lr_scheduler.py:CosineScheduler)."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        assert isinstance(max_update, int)
        if max_update < 1:
            raise ValueError("maximum number of updates must be strictly positive")
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            self.base_lr = (self.final_lr
                            + (self.base_lr_orig - self.final_lr)
                            * (1 + math.cos(math.pi * (num_update - self.warmup_steps)
                                            / self.max_steps)) / 2)
        return self.base_lr
