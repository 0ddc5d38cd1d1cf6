"""The fused trainer step's kernels: one launch updates a table of tensors,
one takes the all-finite census of their gradients, one updates the rows
of a row-sparse gradient in place; each beside its plain PyTorch twin.

No Pallas kernel stands behind them: the reference's fused step
(``incubator_mxnet_tpu/optimizer/fused.py``) is one XLA program,

* ``multi_tensor_update`` for ``_tree_step`` (:149): for each tensor of a
  chunk the rescale, the clip, the update rule (SGD with momentum 0 or
  more, NAG, Adam, AdamW; float32, float16 or bfloat16 tensors, or
  float16 weights with float32 masters under ``multi_precision``) and
  the census select; its twin, :func:`multi_tensor_update_reference`, is
  the optimizer's ``tensor_step`` tensor by tensor;
* ``multi_tensor_all_finite`` for ``_census`` (:184); its twin is a
  ``torch.isfinite`` reduction (:func:`all_finite_reference`);
* ``row_sparse_update`` for ``row_slice_step`` (:54); its twin,
  :func:`row_sparse_update_reference`, gathers the rows, runs
  ``tensor_step`` on them and scatters them back.

:func:`update_tensors`, :func:`all_finite` and :func:`update_rows` take
the kernel for CUDA tensors and the twin for CPU tensors; the kernel
wrappers refuse CPU tensors, and a CUDA tensor the kernel does not take
(its type, its layout) raises. The table (:data:`ENTRY_DTYPE`, one entry
a tensor) is packed on the host and copied to the device on the stream
before each launch: the hypers are launch data, so a new learning rate
builds nothing. Updates are made in place (PyTorch cannot donate a
buffer as XLA does); PyTorch does not see a kernel's writes, so each
wrapper bumps the version of every tensor it handed the kernel to write
(a hybridized block's compiled forward copies in a parameter whose version
moved, ``gluon.block._StaticForward.refresh``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .common import (check_launch, counted_kernel, current_stream_handle,
                     kernel_library, ticket_buffer)

__all__ = ["KINDS", "ROW_KINDS", "CHUNK", "ENTRY_DTYPE", "Plan",
           "storage_code", "multi_tensor_update", "multi_tensor_all_finite",
           "row_sparse_update", "multi_tensor_update_reference",
           "all_finite_reference", "row_sparse_update_reference",
           "update_tensors", "all_finite", "update_rows", "census_layout"]

#: the update rules of the kernels (multi_tensor.cu ``Kind``)
KINDS = {"sgd": 0, "sgd_mom": 1, "nag": 2, "adam": 3, "adamw": 4}
#: the rules ``row_sparse_update`` takes (the lazy row-sparse branch)
ROW_KINDS = ("sgd", "adam", "adamw")
#: elements a block (multi_tensor.cu ``kChunk``)
CHUNK = 16384
_STATES = {"sgd": 0, "sgd_mom": 1, "nag": 1, "adam": 2, "adamw": 2}

#: one tensor of a launch (multi_tensor.cu ``MTEntry``): pointers,
#: element count, first block, storage code, lr, wd, rescale, clip
#: (negative: off) and up to 8 rule constants
ENTRY_DTYPE = np.dtype({
    "names": ["w", "g", "s0", "s1", "master", "n", "first_block", "code",
              "lr", "wd", "rescale", "clip", "c"],
    "formats": ["<u8", "<u8", "<u8", "<u8", "<u8", "<i8", "<i4", "<i4",
                "<f4", "<f4", "<f4", "<f4", ("<f4", (8,))],
    "offsets": [0, 8, 16, 24, 32, 40, 48, 52, 56, 60, 64, 68, 72],
    "itemsize": 104})

_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_F16_MASTER = 3


def storage_code(w, g, states=(), master=None) -> int:
    """The kernel's storage code for one tensor: 0, 1 or 2 when the weight,
    the gradient and every state share float32, float16 or bfloat16; 3 for
    a float16 weight and gradient with a float32 master and float32
    states. Anything else raises TypeError."""
    if master is not None:
        ok = (w.dtype == g.dtype == torch.float16
              and master.dtype == torch.float32
              and all(s.dtype == torch.float32 for s in states))
        if ok:
            return _F16_MASTER
    elif w.dtype in _CODES and g.dtype == w.dtype \
            and all(s.dtype == w.dtype for s in states):
        return _CODES[w.dtype]
    raise TypeError(
        f"multi_tensor: weight {w.dtype}, gradient {g.dtype}, states "
        f"{[s.dtype for s in states]}, master "
        f"{None if master is None else master.dtype}: the kernel takes one "
        "of float32, float16, bfloat16 throughout, or float16 weights with "
        "float32 masters")


class Plan:
    """The fixed part of one launch's table: for each tensor its element
    count, first block and storage code (``sizes`` and ``codes``, one each
    a tensor, every size above 0). Built once for a layout of tensors;
    :meth:`fill` writes a step's pointers and hypers."""

    def __init__(self, sizes: Sequence[int], codes: Sequence[int]):
        if not sizes or min(sizes) < 1:
            raise ValueError(f"Plan: sizes {list(sizes)} (at least one "
                             "tensor, none empty)")
        blocks = [-(-int(n) // CHUNK) for n in sizes]
        self.table = np.zeros(len(sizes), ENTRY_DTYPE)
        self.table["n"] = sizes
        self.table["code"] = codes
        self.table["first_block"] = np.cumsum([0] + blocks[:-1])
        self.n_blocks = int(sum(blocks))

    def __len__(self):
        return len(self.table)

    def fill(self, weights, grads, s0=None, s1=None, masters=None,
             hypers=None) -> np.ndarray:
        """Write the data pointers (a None tensor is a null pointer) and,
        if given, the hypers ((lr, wd, rescale, clip, constants) a tensor)
        into the table; returns it."""
        t = self.table
        n = len(t)

        def ptrs(ts):
            return [0] * n if ts is None else \
                [0 if x is None else x.data_ptr() for x in ts]
        t["w"], t["g"] = ptrs(weights), ptrs(grads)
        t["s0"], t["s1"], t["master"] = ptrs(s0), ptrs(s1), ptrs(masters)
        if hypers is not None:
            vals = np.zeros((n, 12), np.float64)
            for i, (lr, wd, rescale, clip, consts) in enumerate(hypers):
                vals[i, :4] = (lr, wd, rescale, clip)
                vals[i, 4:4 + len(consts)] = consts
            vals = vals.astype(np.float32)
            t["lr"], t["wd"] = vals[:, 0], vals[:, 1]
            t["rescale"], t["clip"] = vals[:, 2], vals[:, 3]
            t["c"] = vals[:, 4:]
        return t


def _device_table(table: np.ndarray, device) -> torch.Tensor:
    """The table on ``device``: staged in pinned memory (PyTorch's host
    allocator keeps the block until its copy has run) and copied on the
    current stream."""
    host = torch.from_numpy(table.view(np.uint8)).pin_memory()
    return host.to(device, non_blocking=True)


def _check_cuda(tensors, name):
    dev = None
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                             f"{t.device}")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors, "
                             f"got strides {t.stride()}")
    return dev


def _written(tensors) -> None:
    """Tell autograd's version counters that a kernel rewrote ``tensors``
    in place (None entries skipped), as an ATen in-place op would."""
    torch.autograd.graph.increment_version(
        [t for t in tensors if t is not None])


def _check_plan(plan, grads, name):
    """The plan was laid out for these tensors: one entry each, of their
    sizes."""
    if list(plan.table["n"]) != [g.numel() for g in grads]:
        raise ValueError(f"{name}: the plan's sizes "
                         f"{list(plan.table['n'])} are not the tensors' "
                         f"{[g.numel() for g in grads]}")


@counted_kernel
def multi_tensor_update(kind: str, plan: Plan, weights, grads, s0, s1,
                        masters, hypers, flag=None) -> None:
    """One launch updating every tensor of ``plan`` in place: ``weights``,
    ``grads`` and the states ``s0``/``s1`` (None where the rule keeps
    fewer), ``masters`` the float32 master weights (None where a weight has
    none), ``hypers`` one (lr, wd, rescale, clip, constants) a tensor as
    the optimizer packs them. With ``flag`` (a one-byte census on the
    device) nothing is written when it is 0."""
    if kind not in KINDS:
        raise ValueError(f"multi_tensor_update: kind {kind!r}")
    _check_plan(plan, grads, "multi_tensor_update")
    every = [*weights, *grads, *(s0 or ()), *(s1 or ()), *(masters or ())]
    dev = _check_cuda(every + [flag], "multi_tensor_update")
    table = _device_table(plan.fill(weights, grads, s0, s1, masters, hypers),
                          dev)
    code = kernel_library().mxt_multi_tensor_update(
        KINDS[kind], table.data_ptr(), len(plan), plan.n_blocks,
        0 if flag is None else flag.data_ptr(),
        current_stream_handle(weights[0]))
    check_launch(code, "multi_tensor_update")
    _written([*weights, *(s0 or ()), *(s1 or ()), *(masters or ())])
    multi_tensor_update.launches += 1


@counted_kernel
def multi_tensor_all_finite(plan: Plan, grads) -> torch.Tensor:
    """One launch: a 0-d bool tensor on the device, True when every
    element of every gradient of ``plan`` is finite."""
    _check_plan(plan, grads, "multi_tensor_all_finite")
    dev = _check_cuda(list(grads), "multi_tensor_all_finite")
    table = _device_table(plan.fill(None, grads), dev)
    flag = torch.empty((), dtype=torch.bool, device=dev)
    partial = torch.empty(plan.n_blocks, dtype=torch.int32, device=dev)
    stream = current_stream_handle(grads[0])
    ticket = ticket_buffer("multi_tensor_all_finite", grads[0], stream, 1)
    code = kernel_library().mxt_multi_tensor_all_finite(
        table.data_ptr(), len(plan), plan.n_blocks, partial.data_ptr(),
        ticket.data_ptr(), flag.data_ptr(), stream)
    check_launch(code, "multi_tensor_all_finite")
    multi_tensor_all_finite.launches += 1
    return flag


@counted_kernel
def row_sparse_update(kind: str, w, s0, s1, ids, g_rows, hyper,
                      flag=None) -> None:
    """One launch updating in place the rows ``ids`` (int64, unique; an id
    >= ``w.shape[0]`` is padding) of ``w`` (rows, ...) and its states from
    ``g_rows`` (len(ids), ...), a block a row. ``hyper`` is (lr, wd,
    rescale, clip, constants) as the optimizer packs it."""
    if kind not in ROW_KINDS:
        raise ValueError(f"row_sparse_update: kind {kind!r} (one of "
                         f"{ROW_KINDS})")
    dev = _check_cuda([w, s0, s1, ids, g_rows, flag], "row_sparse_update")
    if ids.dtype != torch.int64 or ids.dim() != 1:
        raise ValueError(f"row_sparse_update: ids must be 1-D int64, got "
                         f"{ids.dtype} {tuple(ids.shape)}")
    width = w[0].numel() if w.dim() else 1
    if tuple(g_rows.shape) != (ids.shape[0],) + tuple(w.shape[1:]):
        raise ValueError(f"row_sparse_update: g_rows {tuple(g_rows.shape)} "
                         f"for ids {tuple(ids.shape)} and w "
                         f"{tuple(w.shape)}")
    states = [s for s in (s0, s1) if s is not None]
    if len(states) != _STATES[kind]:
        raise ValueError(f"row_sparse_update: {kind} keeps "
                         f"{_STATES[kind]} states, got {len(states)}")
    entry = np.zeros(1, ENTRY_DTYPE)
    plan_code = storage_code(w, g_rows, states)
    lr, wd, rescale, clip, consts = hyper
    entry["w"], entry["g"] = w.data_ptr(), g_rows.data_ptr()
    entry["s0"] = 0 if s0 is None else s0.data_ptr()
    entry["s1"] = 0 if s1 is None else s1.data_ptr()
    entry["n"], entry["code"] = w.numel(), plan_code
    entry["lr"], entry["wd"], entry["rescale"], entry["clip"] = (
        lr, wd, rescale, clip)
    entry["c"][0, :len(consts)] = consts
    if ids.shape[0] == 0:
        return
    code = kernel_library().mxt_row_sparse_update(
        KINDS[kind], entry.ctypes.data, ids.data_ptr(), ids.shape[0],
        w.shape[0], width, 0 if flag is None else flag.data_ptr(),
        current_stream_handle(w))
    check_launch(code, "row_sparse_update")
    _written([w, s0, s1])
    row_sparse_update.launches += 1


# ------------------------------------------------------------------ twins
def _leaves(tree) -> List[Optional[torch.Tensor]]:
    if tree is None or isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for t in tree for leaf in _leaves(t)]


def _select(ok, new, old):
    if new is None:
        return None
    return new if ok is None else torch.where(ok, new, old)


def _write_back(olds, news) -> None:
    """Each new value into its old tensor, in place (states first: a rule
    may hand back the old weight tensor as a state)."""
    for old, new in zip(olds, news):
        if old is not None and new is not old:
            old.copy_(new)


def _apply_one(tensor_step, w, g, state, h, master, ok):
    """One tensor of the twin: the new values, computed before anything is
    written (old state leaves, new ones, old weights, new ones)."""
    if master is not None:
        nm, nst = tensor_step(master, g.float(), state, h)
        news_w = [_select(ok, nm, master), _select(ok, nm.to(w.dtype), w)]
        olds_w = [master, w]
    else:
        nw, nst = tensor_step(w, g, state, h)
        news_w, olds_w = [_select(ok, nw, w)], [w]
    olds = _leaves(state)
    news = [_select(ok, n, o) for n, o in zip(_leaves(nst), olds)]
    return olds, news, olds_w, news_w


def multi_tensor_update_reference(tensor_step, weights, grads, states,
                                  hypers, masters=None, ok=None) -> None:
    """Plain twin of :func:`multi_tensor_update`, and the fused step's
    route for every rule the kernel does not take: ``tensor_step(w, g,
    state, h)`` tensor by tensor (on the float32 master with a float32
    gradient where ``masters`` has one, the weight then its rounding),
    each result selected by the census ``ok`` (a 0-d bool tensor, None
    for none) and written in place."""
    masters = masters or [None] * len(weights)
    for w, g, st, h, m in zip(weights, grads, states, hypers, masters):
        olds, news, olds_w, news_w = _apply_one(tensor_step, w, g, st, h, m,
                                                ok)
        _write_back(olds, news)
        _write_back(olds_w, news_w)


def all_finite_reference(grads) -> torch.Tensor:
    """Plain twin of :func:`multi_tensor_all_finite`."""
    if not grads:
        return torch.ones((), dtype=torch.bool)
    return torch.stack([torch.isfinite(g).all() for g in grads]).all()


def row_sparse_update_reference(tensor_step, w, state, row_ids, g_rows, h,
                                ok=None):
    """Plain twin of :func:`row_sparse_update` (the reference's
    ``row_slice_step``): gather the weight and state rows ``row_ids``
    names, run ``tensor_step`` on them, select by the census ``ok``, and
    scatter them back in place. Ids >= ``w.shape[0]`` are padding: their
    rows are read clipped and never written. Returns (w, state)."""
    ids = row_ids.long()
    keep = ids < w.shape[0]
    safe = ids.clamp(0, w.shape[0] - 1)
    st_leaves = _leaves(state)
    rows_st = [None if s is None else s[safe] for s in st_leaves]
    it = iter(rows_st)

    def rebuild(tree):
        if tree is None or isinstance(tree, torch.Tensor):
            return next(it)
        return tuple(rebuild(t) for t in tree)
    w_rows = w[safe]
    nw, nst = tensor_step(w_rows, g_rows, rebuild(state), h)
    dest = ids[keep]
    for old, rows, new in zip(st_leaves, rows_st, _leaves(nst)):
        if old is not None:
            old.index_copy_(0, dest, _select(ok, new, rows)[keep])
    w.index_copy_(0, dest, _select(ok, nw, w_rows)[keep])
    return w, state


# ------------------------------------------------------- by device
def update_tensors(kind, tensor_step, plan, weights, grads, states, hypers,
                   packed, masters=None, ok=None) -> str:
    """The kernel for CUDA tensors (``kind`` names its rule, ``packed`` the
    hypers as it takes them, ``plan`` the table's layout), the twin for CPU
    tensors. ``states`` are the rule's states (a master weight's own, with
    the master in ``masters``). Returns the route taken: "kernel" or
    "twin"."""
    if not weights[0].is_cuda:
        multi_tensor_update_reference(tensor_step, weights, grads, states,
                                      hypers, masters, ok)
        return "twin"
    leaves = [_leaves(st) for st in states]
    n_states = _STATES[kind]
    s0 = [ls[0] if n_states > 0 else None for ls in leaves]
    s1 = [ls[1] if n_states > 1 else None for ls in leaves]
    multi_tensor_update(kind, plan, weights,
                        [g.contiguous() for g in grads], s0, s1, masters,
                        packed, ok)
    return "kernel"


def all_finite(plan, grads) -> torch.Tensor:
    """The census of ``grads``: the kernel on the card, the twin on the
    CPU."""
    if not grads[0].is_cuda:
        return all_finite_reference(grads)
    return multi_tensor_all_finite(plan, [g.contiguous() for g in grads])


def update_rows(kind, tensor_step, w, state, ids, g_rows, h, packed,
                ok=None) -> str:
    """The lazy row-sparse update: the kernel for a CUDA weight, the twin
    for a CPU one. Returns the route taken."""
    if not w.is_cuda:
        row_sparse_update_reference(tensor_step, w, state, ids, g_rows, h,
                                    ok)
        return "twin"
    leaves = _leaves(state)
    s0 = leaves[0] if _STATES[kind] > 0 else None
    s1 = leaves[1] if _STATES[kind] > 1 else None
    row_sparse_update(kind, w, s0, s1, ids.long(), g_rows.contiguous(),
                      packed, ok)
    return "kernel"


def census_layout(grads) -> Tuple[List[int], List[int]]:
    """(sizes, codes) of a census plan over ``grads``, each read in its
    own type (float32, float16 or bfloat16)."""
    bad = [g.dtype for g in grads if g.dtype not in _CODES]
    if bad:
        raise TypeError(f"multi_tensor_all_finite: gradient types {bad} "
                        "(float32, float16 or bfloat16)")
    return [g.numel() for g in grads], [_CODES[g.dtype] for g in grads]
