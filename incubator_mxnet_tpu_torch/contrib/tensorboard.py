"""TensorBoard-style metric logging (ref: python/mxnet/contrib/tensorboard.py).

Counterpart of ``incubator_mxnet_tpu/contrib/tensorboard.py``.
``LogMetricsCallback`` writes each metric as a scalar event, one JSON line
``{"tag", "value", "step", "wall_time"}`` in ``<logging_dir>/
scalars.jsonl``: the reference's writer when no TensorBoard writer is
installed, and the port's always (it needs no package beyond the
standard library).
"""
from __future__ import annotations

import json
import os
import time

__all__ = ["LogMetricsCallback"]


class _JsonlWriter:
    """Scalar events, one JSON line each."""

    def __init__(self, logging_dir):
        os.makedirs(logging_dir, exist_ok=True)
        self._f = open(os.path.join(logging_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag, value, global_step=None):
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": global_step,
                                  "wall_time": time.time()}) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class LogMetricsCallback(object):
    """Batch-end callback logging the metrics as scalars (ref:
    contrib/tensorboard.py:25 LogMetricsCallback)."""

    def __init__(self, logging_dir, prefix=None):
        self.prefix = prefix
        self.step = 0
        self.summary_writer = _JsonlWriter(logging_dir)

    def __call__(self, param):
        """Log one batch's metrics (a ``BatchEndParam``)."""
        self.step += 1
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            if self.prefix is not None:
                name = "%s-%s" % (self.prefix, name)
            self.summary_writer.add_scalar(name, value, self.step)
