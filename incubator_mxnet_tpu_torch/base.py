"""Core utilities: the error type, the typed registry of ``MXTPU_*``
environment variables the port reads, and name -> object registries.

Counterpart of ``incubator_mxnet_tpu/base.py`` (the port keeps its own
copy). ``device_sync`` waits for the array's CUDA device.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Optional, Type

import torch

__all__ = ["MXTPUError", "env", "EnvRegistry", "Registry", "registry_get",
           "classproperty", "device_sync"]


class MXTPUError(RuntimeError):
    """Base error for the framework (ref: dmlc::Error / MXNetError)."""


class EnvRegistry:
    """Typed runtime config from ``MXTPU_*`` environment variables: every
    knob is declared with a type, a default and a line of documentation."""

    def __init__(self, prefix: str = "MXTPU_") -> None:
        self._prefix = prefix
        self._declared: Dict[str, tuple] = {}
        self._aliases: Dict[str, tuple] = {}
        self._lock = threading.Lock()

    def declare(self, name: str, default: Any, typ: Optional[Type] = None,
                doc: str = "", aliases: tuple = ()) -> None:
        """``aliases``: other names of the same setting, read in turn
        where ``name`` is not set."""
        if typ is None:
            typ = type(default)
        with self._lock:
            self._declared[name] = (default, typ, doc)
            self._aliases[name] = tuple(aliases)

    def get(self, name: str, default: Any = None) -> Any:
        if name in self._declared:
            ddefault, typ, _ = self._declared[name]
            if default is None:
                default = ddefault
        else:
            typ = type(default) if default is not None else str
        raw = None
        for key in (name,) + self._aliases.get(name, ()):
            raw = os.environ.get(self._prefix + key)
            if raw is None:
                raw = os.environ.get(key)  # the bare name, as tests set it
            if raw is not None:
                break
        if raw is None:
            return default
        if typ is bool:
            return raw.lower() in ("1", "true", "yes", "on")
        try:
            return typ(raw)
        except (TypeError, ValueError):
            return default

    def documented(self) -> Dict[str, tuple]:
        return dict(self._declared)


env = EnvRegistry()

env.declare("ENGINE_TYPE", "async", str,
            "'async' (PyTorch's asynchronous CUDA stream) or 'naive' "
            "(synchronize the device after every op).")
env.declare("DEFAULT_DTYPE", "float32", str, "Default dtype for new arrays.")
env.declare("FUSED_STEP", True, bool,
            "The fused whole-step trainer update (optimizer/fused.py); 0 "
            "takes the per-parameter path. Also read as "
            "MXTPU_EXEC_BULK_EXEC_TRAIN (ref: MXNET_EXEC_BULK_EXEC_TRAIN).",
            aliases=("EXEC_BULK_EXEC_TRAIN",))


class Registry:
    """Name -> object registry with decorator support and aliases
    (ref analog: python/mxnet/registry.py, the DMLC_REGISTRY macros)."""

    _all: Dict[str, "Registry"] = {}

    def __init__(self, name: str) -> None:
        self.name = name
        self._entries: Dict[str, Any] = {}
        Registry._all[name] = self

    def register(self, obj: Any = None, name: Optional[str] = None,
                 *aliases: str):
        def _do(o, nm):
            key = (nm or getattr(o, "__name__", None) or str(o)).lower()
            self._entries[key] = o
            for a in aliases:
                self._entries[a.lower()] = o
            return o

        if obj is None:
            return lambda o: _do(o, name)
        if isinstance(obj, str):  # used as @reg.register("name", "alias")
            als = (name,) + aliases if name else aliases
            return lambda o: (_do(o, obj) if not als
                              else _do_with_aliases(self, o, obj, als))
        return _do(obj, name)

    def __contains__(self, key: str) -> bool:
        return key.lower() in self._entries

    def get(self, key: str) -> Any:
        k = key.lower()
        if k not in self._entries:
            raise KeyError(f"{self.name} registry has no entry '{key}'. "
                           f"Known: {sorted(self._entries)}")
        return self._entries[k]

    def create(self, key, *args, **kwargs):
        """Create an instance; ``key`` may be an instance already, a class,
        or a registered name."""
        if not isinstance(key, str):
            if isinstance(key, type):
                return key(*args, **kwargs)
            return key
        return self.get(key)(*args, **kwargs)

    def keys(self):
        return sorted(self._entries)


def _do_with_aliases(reg: Registry, obj: Any, name: str, aliases) -> Any:
    reg._entries[name.lower()] = obj
    for a in aliases:
        if a:
            reg._entries[a.lower()] = obj
    return obj


def registry_get(name: str) -> Registry:
    return Registry._all.setdefault(name, Registry(name))


class classproperty:
    def __init__(self, f: Callable) -> None:
        self.f = f

    def __get__(self, obj, owner):
        return self.f(owner)


def device_sync(value=None):
    """Wait until the device work behind ``value`` (a tensor, an NDArray,
    or a list or tuple of them) is done: a CUDA synchronize on each CUDA
    device it lives on. CPU values are ready when returned."""
    if value is None:
        return None
    items = value if isinstance(value, (list, tuple)) else [value]
    for v in items:
        t = getattr(v, "_data", v)
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
    return value
