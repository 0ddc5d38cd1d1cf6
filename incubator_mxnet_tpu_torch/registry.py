"""Generic class registry (ref: python/mxnet/registry.py).

Counterpart of ``incubator_mxnet_tpu/registry.py`` (the port keeps its own
copy; pure Python). Factory helpers that give any base class a
string-keyed registry with register / alias / create functions — the
mechanism behind
``mx.optimizer.create('sgd')``, ``mx.init.create('xavier')``,
``mx.metric.create('acc')`` in the reference.
"""
from __future__ import annotations

import json

_REGISTRY: dict = {}


def get_registry(base_class):
    """A shallow copy of the registry for `base_class`
    (ref: registry.py:32)."""
    if base_class not in _REGISTRY:
        _REGISTRY[base_class] = {}
    return dict(_REGISTRY[base_class])


def get_register_func(base_class, nickname):
    """Build a @register decorator for `base_class` (ref: registry.py:49)."""
    if base_class not in _REGISTRY:
        _REGISTRY[base_class] = {}
    registry = _REGISTRY[base_class]

    def register(klass, name=None):
        if not issubclass(klass, base_class):
            raise AssertionError(
                f"Can only register subclass of {base_class.__name__}")
        if name is None:
            name = klass.__name__
        name = name.lower()
        if name in registry and registry[name] is not klass:
            import logging
            logging.warning(
                "New %s %s.%s registered with name %s is overriding "
                "existing %s %s.%s", nickname, klass.__module__,
                klass.__name__, name, nickname,
                registry[name].__module__, registry[name].__name__)
        registry[name] = klass
        return klass

    register.__doc__ = f"Register {nickname} to the {nickname} factory"
    return register


def get_alias_func(base_class, nickname):
    """Build an @alias('a', 'b') decorator (ref: registry.py:88)."""
    register = get_register_func(base_class, nickname)

    def alias(*aliases):
        def reg(klass):
            for name in aliases:
                register(klass, name)
            return klass
        return reg
    return alias


def get_create_func(base_class, nickname):
    """Build a create(name_or_instance, **kwargs) factory
    (ref: registry.py:115). Accepts an instance (returned as-is), a name,
    or a json string {"name": ..., **kwargs}."""
    if base_class not in _REGISTRY:
        _REGISTRY[base_class] = {}
    registry = _REGISTRY[base_class]

    def create(*args, **kwargs):
        if len(args):
            name = args[0]
            args = args[1:]
        else:
            name = kwargs.pop(nickname)
        if isinstance(name, base_class):
            if args or kwargs:
                raise AssertionError(
                    f"{nickname} is already an instance; additional "
                    "arguments are invalid")
            return name
        if isinstance(name, str) and name.startswith("["):
            if args or kwargs:
                raise AssertionError(f"{nickname} given as JSON takes no "
                                     "other arguments")
            name, kwargs = json.loads(name)
            return create(name, **kwargs)
        if not isinstance(name, str):
            raise AssertionError(f"{nickname} must be a string")
        name = name.lower()
        if name not in registry:
            raise KeyError(
                f"Cannot find {nickname} '{name}'. Valid options: "
                f"{sorted(registry)}")
        return registry[name](*args, **kwargs)

    create.__doc__ = f"Create a {nickname} instance from config"
    return create
