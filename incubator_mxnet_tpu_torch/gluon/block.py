"""Gluon Block / HybridBlock.

Counterpart of ``incubator_mxnet_tpu/gluon/block.py`` (ref:
python/mxnet/gluon/block.py — Block:127, HybridBlock:671). Blocks get the
reference's prefixes and parameter names (``_BlockScope`` over ``name``),
and ``save_parameters`` / ``load_parameters`` use the npz format both
packages' ``nd.save`` / ``nd.load`` share, keyed by structural name, so a
file either package writes loads into the other's net.

``hybridize()`` compiles the forward as the reference's jit does (its
``_jit_cache``): an active block called with NDArray inputs, all on one
device, while autograd is not recording runs one entry per (input tree,
shapes and types, training) key over static inputs and static copies of
its parameters. A copy is refreshed at a call only when its parameter's
tensor changed, by identity or by version, since ``Trainer.step``,
``set_data`` and ``load_parameters`` rebind a parameter's tensor. On the
card each entry is a CUDA graph (``cuda_graph``): the first call of a key
runs the forward eagerly on the capture stream, the capture follows, and
later calls replay it (the first capture on a device empties the
allocator's cache once: ``cuda_graph.capture_stream``); a training
forward's aux writes (BatchNorm running statistics) go into the static
copies inside the graph and onto the parameters after it, and its draws
come from the entry's own generator, which takes the device generator's
state before the call and hands it back after. On the CPU the same
forward runs eagerly on the same buffers. Outputs are new arrays at every
call. A forward that syncs with the host cannot be captured: on the card
its first hybridized call raises. Those are the forwards that reach
``ROIAlign``, ``ROIPooling`` or ``PSROIPooling`` (each reads a box's batch
index on the host), ``contrib.boolean_mask`` (its shape depends on the
data), ``histogram`` without a ``range``, the predicate of
``contrib.cond`` / ``while_loop``, ``nd.array`` of host data, or an
``nd.Custom`` operator whose code reads its arrays on the host; leave
such a block, or the block around it, not hybridized. Every other op of
the port builds its constants on the device. A recording call stays
eager, on the tape; with ``hybridize(remat=...)`` its forward runs under
that rematerialisation policy (``remat.REMAT_POLICIES``), BatchNorm
as its plain composition, as in the reference. BatchNorm writes its
running statistics in a training forward, and nowhere else. ``export``,
``SymbolBlock`` and the
StableHLO re-import are the symbolic slice (ROADMAP.md A11) and raise.
"""
from __future__ import annotations

import itertools
import re
import threading
import weakref
from collections import OrderedDict
from typing import Callable, Dict, Optional

import numpy as _np
import torch

from .. import autograd
from .. import cuda_graph as _graphs
from .. import random as _random
from .. import remat as _remat
from ..autograd import _IN_TRACE, _functional_trace
from ..ndarray.ndarray import NDArray, _wrap
from ..ops.nn import bn_impl_override
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict, _strip_checkpoint_prefixes,
                        _substitution_map, parameter_substitution)

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
    the ``nd`` namespace (ref: gluon/block.py:671); hybridized, its forward
    is compiled (the module docstring)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)
        self._active = False
        self._flags: Dict[str, object] = {}
        self._remat = None
        self._static: Optional[_StaticForward] = None

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  remat=None, **kwargs):
        """(ref: block.py:504/832) ``static_alloc`` / ``static_shape`` are
        accepted: a compiled forward always runs on static buffers of fixed
        shapes. ``remat`` is the rematerialisation policy of gradients
        taken through this block (None, a name of
        ``remat.REMAT_POLICIES`` or a policy callable; an unknown
        name raises ``ValueError`` at the next call). Which forwards
        cannot be captured, and what the first capture on a device does
        to the allocator's cache: the module docstring."""
        self._active = active
        self._flags.update(dict(static_alloc=static_alloc,
                                static_shape=static_shape, **kwargs))
        self._remat = remat
        self._static = None
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def infer_shape(self, *args):
        """Layer hook that sets this block's parameter shapes from its first
        input (ref: block.py _deferred_infer_shape)."""

    def __call__(self, *args):
        for hook in self._forward_pre_hooks.values():
            hook(self, args)
        out = self._call_impl(*args)
        for hook in self._forward_hooks.values():
            hook(self, args, out)
        return out

    def _call_impl(self, *args):
        if self._active and not getattr(_IN_TRACE, "active", False):
            policy = _remat.resolve(self._remat)
            if autograd.is_recording():
                if policy is not None:
                    return self._remat_forward(policy, *args)
            else:
                leaves = []
                tree = _flatten(list(args), leaves)
                if leaves and _static_ok(tree, leaves):
                    return self._call_static(tree, leaves, args)
        return self._eager(*args)

    def _eager(self, *args):
        try:
            return self.forward(*args)
        except DeferredInitializationError:
            self._finish_deferred(*args)
            return self.forward(*args)

    def _finish_deferred(self, *args):
        """Infer shapes for THIS block's own params from the inputs, then
        materialise them; children resolve themselves when the forward is
        run again."""
        self.infer_shape(*args)
        for param in self._reg_params.values():
            if param._deferred_init:
                param._finish_deferred_init()

    def _resolve_deferred(self, args):
        """One eager inference forward that materialises every deferred
        parameter before the compiled forward reads them (the reference's
        ``_resolve_deferred_eager``)."""
        params = list(self.collect_params().values())
        if all(p._data is not None for p in params):
            return
        with torch.no_grad(), _functional_trace(), autograd.pause():
            self._eager(*args)

    def _call_static(self, tree, leaves, args):
        """The compiled forward (the module docstring)."""
        self._resolve_deferred(args)
        device = leaves[0]._data.device
        state = self._static
        if state is None or not state.refresh():
            params = list(self.collect_params().values())
            if any(p.data()._data.device != device for p in params):
                return self._eager(*args)
            state = self._static = _StaticForward(self, params)
        training = autograd.is_training()
        key = (repr(tree), tuple((l.shape, l._data.dtype) for l in leaves),
               training)
        entry = state.entries.get(key)
        fresh = entry is None
        if fresh:
            entry = _ForwardEntry(state, tree, leaves, training, device)
        with torch.no_grad():
            torch._foreach_copy_(entry.inputs, [l._data for l in leaves])
        gen = _random.generator(device)
        entry.gen.set_state(gen.get_state())
        if fresh and device.type == "cuda":
            outs = _graphs.first_call(entry.step, device, (entry.gen,),
                                      f"hybridized {self.name}")
        else:
            outs = entry.step()
        gen.set_state(entry.gen.get_state())
        state.entries[key] = entry
        state.write_aux(entry.written)
        return _unflatten(entry.out_tree,
                          iter([_wrap(o.clone()) for o in outs]))

    def _remat_forward(self, policy, *args):
        """A recording call under the rematerialisation ``policy``
        (``remat``: its forward checkpointed, cut into segments where it
        runs a sequential container). The aux parameters read the values
        of this call in the forward and in its recompute, and only the
        forward's writes land on them."""
        self._resolve_deferred(args)
        training = autograd.is_training()
        aux = [p for p in list(self.collect_params().values())
               if p.grad_req == "null"]
        before = [p.data()._data for p in aux]
        writes = []

        def run(*a):
            wrappers = [NDArray(t, _direct=True) for t in before]
            mapping = dict(_substitution_map() or {})
            mapping.update({id(p): w for p, w in zip(aux, wrappers)})
            with autograd.record(train_mode=training), \
                    bn_impl_override("plain"), \
                    parameter_substitution(mapping):
                out = self.forward(*a)
            if not writes:
                writes.append({i: w._data for i, w in enumerate(wrappers)
                               if w._data is not before[i]})
            return out
        if _remat.has_segments(self):
            with _remat.segments(policy):
                out = run(*args)
        else:
            out = _remat.checkpointed(policy, run, *args)
        with autograd.pause():
            for i, new in writes[0].items():
                aux[i].data()._set_data(new)
        return out

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


class _Leaf:
    """Where an array sits in a flattened argument or output tree."""

    def __repr__(self):
        return "*"


_LEAF = _Leaf()


def _flatten(tree, leaves):
    """``tree`` (nested lists and tuples) with each NDArray moved into
    ``leaves`` and :data:`_LEAF` in its place."""
    if isinstance(tree, NDArray):
        leaves.append(tree)
        return _LEAF
    if isinstance(tree, (list, tuple)):
        return type(tree)(_flatten(t, leaves) for t in tree)
    return tree


def _unflatten(tree, leaves):
    if tree is _LEAF:
        return next(leaves)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(t, leaves) for t in tree)
    return tree


def _static_ok(tree, leaves) -> bool:
    """Arrays on one device, and no other argument but None: a python
    value would be baked into the compiled forward (the reference runs
    such calls eagerly too)."""
    def plain(t):
        if isinstance(t, (list, tuple)):
            return all(plain(v) for v in t)
        return t is _LEAF or t is None
    device = leaves[0]._data.device
    return plain(tree) and all(l._data.device == device for l in leaves)


class _StaticForward:
    """A hybridized block's compiled forward: static copies of its
    parameters (on ``device`` when given, else each on its parameter's),
    the tensor each was last refreshed from (a weak reference and its
    version), and one :class:`_ForwardEntry` a key."""

    def __init__(self, block, params, device=None):
        self.block, self.params = block, params
        with torch.no_grad():
            self.static = [p.data()._data.detach().to(device, copy=True)
                           for p in params]
        self.seen = [self._mark(p) for p in params]
        self.entries: Dict[object, _ForwardEntry] = {}

    @staticmethod
    def _mark(p):
        t = p.data()._data
        return weakref.ref(t), t._version

    def refresh(self) -> bool:
        """Copy in the parameters whose tensor changed since the last call;
        False (nothing copied) if one changed shape, type or device."""
        pairs = []
        for i, p in enumerate(self.params):
            if p._data is None:
                return False
            t = p.data()._data
            ref, version = self.seen[i]
            if ref() is t and t._version == version:
                continue
            s = self.static[i]
            if t.shape != s.shape or t.dtype != s.dtype \
                    or t.device != s.device:
                return False
            pairs.append((i, t))
        if pairs:
            with torch.no_grad():
                torch._foreach_copy_([self.static[i] for i, _ in pairs],
                                     [t for _, t in pairs])
            for i, _ in pairs:
                self.seen[i] = self._mark(self.params[i])
        return True

    def write_aux(self, written) -> None:
        """After a training forward: the parameters it wrote (BatchNorm's
        running statistics) take copies of their static values."""
        with autograd.pause():
            for i in written:
                self.params[i].data()._set_data(self.static[i].clone())
                self.seen[i] = self._mark(self.params[i])


class _ForwardEntry:
    """One key of a compiled forward: its static inputs, its generator
    (which takes the device generator's state at each call) and the step
    that runs the block's forward over them and the static parameters."""

    def __init__(self, state: _StaticForward, tree, leaves, training,
                 device):
        self.inputs = [torch.empty(l.shape, dtype=l._data.dtype,
                                   device=device) for l in leaves]
        self.out_tree, self.written = None, []
        self.gen = gen = torch.Generator(device=device)
        block, params, static = state.block, state.params, state.static

        def body():
            wrappers = [NDArray(t, _direct=True) for t in static]
            ins = _unflatten(tree, iter([NDArray(t, _direct=True)
                                         for t in self.inputs]))
            with torch.no_grad(), _functional_trace(), \
                    _random.use_generator(gen), \
                    parameter_substitution(
                        {id(p): w for p, w in zip(params, wrappers)}), \
                    autograd.pause(train_mode=training):
                out = block.forward(*ins)
                outs = []
                self.out_tree = _flatten(out, outs)
                self.written = [i for i, w in enumerate(wrappers)
                                if w._data is not static[i]]
                for i in self.written:
                    static[i].copy_(wrappers[i]._data)
            return [o._data for o in outs]
        self.step = _graphs.CapturedStep(body)


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
