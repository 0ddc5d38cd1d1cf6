"""Training callbacks: the guard's event logger.

Counterpart of ``GuardEventLogger`` in ``incubator_mxnet_tpu/callback.py``
(the listener ``guard.TrainingGuard.ensure_logger`` attaches). The
reference module's other callbacks (``Speedometer``, ``ProgressBar``,
``do_checkpoint``, ``module_checkpoint``, ``log_train_metric``,
``LogValidationMetricsCallback``) belong to ``module/`` and ``model.py``,
ROADMAP.md A11, and are not ported yet.
"""
from __future__ import annotations

import logging
import time

__all__ = ["GuardEventLogger"]


class GuardEventLogger:
    """Structured log line per ``guard.GuardEvent`` — one greppable
    ``GUARD ...`` record per sentinel trip so a run is post-mortemable
    from its log alone. Attach via ``TrainingGuard.add_listener`` (the
    ``guard=`` integrations install one by default). Keeps per-(kind,
    action) counts for an end-of-run summary.

    Each record carries wall + monotonic timestamps and the worker rank so
    multi-rank logs interleave unambiguously and a log line can be
    correlated against the telemetry flight-recorder dump (whose guard
    events share the same clocks)."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.counts = {}

    def __call__(self, event):
        from . import telemetry
        key = (event.kind, event.action)
        self.counts[key] = self.counts.get(key, 0) + 1
        self.logger.info(
            "GUARD ts=%.6f mono=%.6f rank=%d step=%s kind=%s action=%s "
            "value=%s detail=%s",
            time.time(), time.monotonic(), telemetry.rank(), event.step,
            event.kind, event.action, event.value, event.detail)

    def summary(self):
        """{'kind/action': count} for every trip seen."""
        return {f"{k}/{a}": n for (k, a), n in sorted(self.counts.items())}
