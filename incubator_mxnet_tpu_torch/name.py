"""Automatic naming for blocks (ref: python/mxnet/name.py NameManager,
Prefix). Counterpart of ``incubator_mxnet_tpu/name.py``: a thread-local
manager that uniquifies names, so gluon blocks get the reference's
prefixes (``dense0_``, ``resnetv10_``) and their parameters its names."""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix"]


class NameManager:
    """(ref: name.py:NameManager)"""

    _current = threading.local()

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        if name:
            return name
        if hint not in self._counter:
            self._counter[hint] = 0
        name = f"{hint}{self._counter[hint]}"
        self._counter[hint] += 1
        return name

    def __enter__(self):
        if not hasattr(NameManager._current, "value"):
            NameManager._current.value = NameManager()
        self._old_manager = NameManager._current.value
        NameManager._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        assert self._old_manager
        NameManager._current.value = self._old_manager

    @classmethod
    def current(cls):
        if not hasattr(cls._current, "value"):
            cls._current.value = cls()
        return cls._current.value


class Prefix(NameManager):
    """(ref: name.py:Prefix)"""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        name = super().get(name, hint)
        return self._prefix + name
