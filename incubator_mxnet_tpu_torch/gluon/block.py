"""Gluon Block / HybridBlock.

Counterpart of ``incubator_mxnet_tpu/gluon/block.py`` (ref:
python/mxnet/gluon/block.py — Block:127, HybridBlock:671). Blocks get the
reference's prefixes and parameter names (``_BlockScope`` over ``name``),
and ``save_parameters`` / ``load_parameters`` use the npz format both
packages' ``nd.save`` / ``nd.load`` share, keyed by structural name, so a
file either package writes loads into the other's net.

``hybridize()`` is accepted and the forward stays eager: PyTorch runs eagerly
and the reference's jit trace has no counterpart the port needs yet (a CUDA
graph capture is ROADMAP.md A3). The aux-state semantics match the
reference's compiled call: BatchNorm writes its running statistics in a
training forward, and nowhere else. ``export``, ``SymbolBlock`` and the
StableHLO re-import are the symbolic slice (ROADMAP.md A11) and raise.
"""
from __future__ import annotations

import itertools
import re
import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional

import numpy as _np

from ..ndarray.ndarray import NDArray
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict, _strip_checkpoint_prefixes)

__all__ = ["Block", "HybridBlock", "SymbolBlock"]

# hook handles stay unique after a detach (MXNet's HookHandle keys by id)
_HOOK_IDS = itertools.count()


class _BlockScope:
    """Name scope for child blocks (ref: block.py:_BlockScope)."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None
        self._name_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                from ..name import NameManager
                prefix = NameManager.current().get(None, hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = f"{hint}{count}_"
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        from ..name import Prefix
        self._name_scope = Prefix(self._block.prefix)
        self._name_scope.__enter__()
        return self

    def __exit__(self, ptype, value, trace):
        if self._block._empty_prefix:
            return
        self._name_scope.__exit__(ptype, value, trace)
        self._name_scope = None
        _BlockScope._current.value = self._old_scope


class Block:
    """Base model-composition class (ref: gluon/block.py:127)."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = (self._prefix[:-1] if self._prefix.endswith("_")
                      else self._prefix)
        self._scope = _BlockScope(self)
        self._children: "OrderedDict[str, Block]" = OrderedDict()
        self._reg_params: Dict[str, Parameter] = {}
        self._forward_hooks: "OrderedDict[int, Callable]" = OrderedDict()
        self._forward_pre_hooks: "OrderedDict[int, Callable]" = OrderedDict()

    def _alias(self):
        return self.__class__.__name__.lower()

    # ------------------------------------------------------------- accessors
    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    @property
    def params(self) -> ParameterDict:
        return self._params

    def name_scope(self):
        return self._scope

    def __repr__(self):
        modstr = "\n".join(
            f"  ({key}): {_indent(repr(block), 2)}"
            for key, block in self._children.items())
        return f"{self.__class__.__name__}(\n{modstr}\n)"

    def __setattr__(self, name, value):
        if hasattr(self, name):
            existing = getattr(self, name)
            if isinstance(existing, (Parameter, Block)) and not isinstance(
                    value, type(existing)):
                raise TypeError(
                    f"Changing attribute type for {name} from "
                    f"{type(existing)} to {type(value)} is not allowed.")
        if isinstance(value, Block):
            self.register_child(value, name)
        elif isinstance(value, Parameter):
            assert name not in self._reg_params or \
                self._reg_params[name] is value, \
                "Overriding Parameter attribute %s is not allowed." % name
            self._reg_params[name] = value
        super().__setattr__(name, value)

    def register_child(self, block: "Block", name: Optional[str] = None):
        if name is None:
            name = str(len(self._children))
        self._children[name] = block

    def register_forward_hook(self, hook):
        handle = next(_HOOK_IDS)
        self._forward_hooks[handle] = hook
        return _HookHandle(self._forward_hooks, handle)

    def register_forward_pre_hook(self, hook):
        handle = next(_HOOK_IDS)
        self._forward_pre_hooks[handle] = hook
        return _HookHandle(self._forward_pre_hooks, handle)

    def apply(self, fn):
        for child in self._children.values():
            child.apply(fn)
        fn(self)
        return self

    # ------------------------------------------------------------ parameters
    def collect_params(self, select: Optional[str] = None) -> ParameterDict:
        """This block's and all children's parameters, optionally
        regex-filtered (ref: block.py collect_params)."""
        ret = ParameterDict(self._params.prefix)
        if not select:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({name: value for name, value in self.params.items()
                        if pattern.match(name)})
        for child in self._children.values():
            ret.update(child.collect_params(select=select))
        return ret

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def save_parameters(self, filename: str, param_filter=None) -> None:
        """(ref: block.py:315 save_parameters) Keys are the structural
        names of :meth:`_collect_params_with_prefix`; ``param_filter(name,
        param) -> bool`` selects which parameters land in the file."""
        params = self._collect_params_with_prefix()
        if param_filter is not None:
            params = {k: v for k, v in params.items() if param_filter(k, v)}
        from ..ndarray.ndarray import save as nd_save
        nd_save(filename, {key: val.data() for key, val in params.items()})

    def load_parameters(self, filename: str, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        param_filter=None) -> None:
        """(ref: block.py:356 load_parameters) The arrays land on ``ctx``
        (the current context when None) for parameters not yet
        initialized, and on each parameter's own device otherwise."""
        from ..ndarray.ndarray import load as nd_load
        loaded = _strip_checkpoint_prefixes(nd_load(filename, ctx))
        params = self._collect_params_with_prefix()
        if param_filter is not None:
            params = {k: v for k, v in params.items() if param_filter(k, v)}
        if not allow_missing:
            for name in params.keys():
                assert name in loaded, \
                    f"Parameter '{name}' is missing in file '{filename}'"
        for name in loaded:
            if name not in params:
                if not ignore_extra:
                    raise ValueError(
                        f"Parameter '{name}' loaded from file '{filename}' is "
                        "not present in this Block")
                continue
            params[name]._load_init(loaded[name], ctx, cast_dtype=cast_dtype)

    save_params = save_parameters
    load_params = load_parameters

    def _collect_params_with_prefix(self, prefix: str = ""
                                    ) -> Dict[str, Parameter]:
        if prefix:
            prefix += "."
        ret = {prefix + key: val for key, val in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def cast(self, dtype):
        for child in self._children.values():
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    # --------------------------------------------------------------- forward
    def __call__(self, *args):
        for hook in self._forward_pre_hooks.values():
            hook(self, args)
        out = self.forward(*args)
        for hook in self._forward_hooks.values():
            hook(self, args, out)
        return out

    def forward(self, *args):
        raise NotImplementedError

    def summary(self, *inputs):
        """Print a per-layer summary (ref: block.py summary)."""
        summary_recs = []

        def _hook(block, inp, out):
            shapes = out.shape if isinstance(out, NDArray) else \
                [o.shape for o in out]
            n_params = sum(int(_np.prod(p.shape))
                           for p in block._reg_params.values()
                           if p.shape and 0 not in p.shape)
            summary_recs.append((type(block).__name__, shapes, n_params))

        handles = []
        self.apply(lambda b: handles.append(b.register_forward_hook(_hook)))
        try:
            self(*inputs)
        finally:
            for h in handles:
                h.detach()
        total = sum(r[2] for r in summary_recs)
        lines = [f"{'Layer':<28}{'Output Shape':<24}{'Params':<12}",
                 "-" * 64]
        lines += [f"{n:<28}{str(s):<24}{p:<12}" for n, s, p in summary_recs]
        lines += ["-" * 64, f"Total params: {total}"]
        print("\n".join(lines))


class _HookHandle:
    def __init__(self, hooks, handle):
        self._hooks = hooks
        self._handle = handle

    def detach(self):
        self._hooks.pop(self._handle, None)


def _indent(s, num_spaces):
    lines = s.split("\n")
    first = lines.pop(0)
    return first + "".join("\n" + " " * num_spaces + line for line in lines)


class HybridBlock(Block):
    """A block whose forward is ``hybrid_forward(F, x, **params)`` with F
    the ``nd`` namespace (ref: gluon/block.py:671)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)
        self._active = False
        self._flags: Dict[str, object] = {}

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  remat=None, **kwargs):
        """(ref: block.py:504/832) Accepted; the forward stays eager (see
        the module docstring). ``remat`` is a TPU memory policy with no
        counterpart yet and raises when set."""
        if remat not in (None, False):
            raise NotImplementedError(
                "hybridize(remat=...): rematerialisation policies are not "
                "ported (ROADMAP.md A3)")
        self._active = active
        self._flags.update(dict(static_alloc=static_alloc,
                                static_shape=static_shape, **kwargs))
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def infer_shape(self, *args):
        """Layer hook that sets this block's parameter shapes from its first
        input (ref: block.py _deferred_infer_shape)."""

    def __call__(self, *args):
        for hook in self._forward_pre_hooks.values():
            hook(self, args)
        try:
            out = self.forward(*args)
        except DeferredInitializationError:
            self._finish_deferred(*args)
            out = self.forward(*args)
        for hook in self._forward_hooks.values():
            hook(self, args, out)
        return out

    def _finish_deferred(self, *args):
        """Infer shapes for THIS block's own params from the inputs, then
        materialise them; children resolve themselves when the forward is
        run again."""
        self.infer_shape(*args)
        for param in self._reg_params.values():
            if param._deferred_init:
                param._finish_deferred_init()

    def forward(self, x, *args):
        """Eager forward: ``hybrid_forward`` with F = nd and this block's
        registered parameters (ref: block.py HybridBlock.forward)."""
        params = {k: v.data() for k, v in self._reg_params.items()}
        return self.hybrid_forward(_nd_mod_proxy, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def export(self, path: str, epoch: int = 0):
        raise NotImplementedError(
            "HybridBlock.export: deployment artifacts are the symbolic slice "
            "(ROADMAP.md A11)")


class _NDProxy:
    """The ``F`` handed to hybrid_forward: ops from the nd namespace."""

    def __getattr__(self, name):
        from .. import ndarray as nd
        return getattr(nd, name)


_nd_mod_proxy = _NDProxy()


class _StableHLOBlock(Block):
    """The reference's re-import of an exported StableHLO artifact."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "_StableHLOBlock: exported artifacts are the symbolic slice "
            "(ROADMAP.md A11)")


class SymbolBlock(HybridBlock):
    """A block built from a symbolic graph (ref: block.py:952)."""

    def __init__(self, outputs, inputs, params=None):
        raise NotImplementedError(
            "SymbolBlock: the symbolic API is ROADMAP.md A11 (not ported)")

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        raise NotImplementedError(
            "SymbolBlock.imports: the symbolic API is ROADMAP.md A11 (not "
            "ported)")
