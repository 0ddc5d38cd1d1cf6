"""Gluon contrib (ref: python/mxnet/gluon/contrib/).

Counterpart of ``incubator_mxnet_tpu/gluon/contrib/``. The port has
``data`` (``IntervalSampler``, ``WikiText2``, ``WikiText103``);
``contrib.nn`` and ``contrib.rnn`` are ROADMAP.md A item 2, not ported
yet, and raise."""
from . import data  # noqa: F401

_NOT_PORTED = ("nn", "rnn")


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"gluon.contrib.{name} is ROADMAP.md A item 2 (the A4/A5 "
            "remainders), not ported yet")
    raise AttributeError(f"module 'gluon.contrib' has no attribute {name!r}")
