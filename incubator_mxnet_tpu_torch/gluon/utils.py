"""Gluon utilities.

Counterpart of ``incubator_mxnet_tpu/gluon/utils.py`` (ref:
python/mxnet/gluon/utils.py — split_data, split_and_load, clip_global_norm,
check_sha1, download), plus :func:`params_from_jax`, which carries a JAX
net's parameters into the port's net.
"""
from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional

import numpy as _np

from .. import autograd
from ..context import current_context
from ..ndarray.ndarray import NDArray, array as nd_array

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download", "params_from_jax"]


def split_data(data: NDArray, num_slice: int, batch_axis: int = 0,
               even_split: bool = True) -> List[NDArray]:
    """(ref: utils.py:split_data)"""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            f"data with shape {data.shape} cannot be evenly split into "
            f"{num_slice} slices along axis {batch_axis}. Use a batch size "
            f"that's multiple of {num_slice} or set even_split=False.")
    if num_slice == 1:
        return [data]
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        begin = i * step
        end = (i + 1) * step if i < num_slice - 1 else size
        slices.append(data.slice_axis(batch_axis, begin, end))
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Scatter a batch over contexts (ref: utils.py:split_and_load)."""
    if not isinstance(data, NDArray):
        data = nd_array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [i.as_in_context(ctx) for i, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays: List[NDArray], max_norm: float,
                     check_isfinite: bool = True):
    """Scale the arrays so their joint 2-norm is at most ``max_norm``;
    returns the norm before scaling (ref: utils.py:clip_global_norm)."""
    assert len(arrays) > 0
    total_norm = float(sum(float((a._data.detach().float() ** 2).sum())
                           for a in arrays)) ** 0.5
    if check_isfinite and not _np.isfinite(total_norm):
        import warnings
        warnings.warn(UserWarning(
            "nan or inf is detected. Clipping results will be undefined."),
            stacklevel=2)
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        for arr in arrays:
            arr._set_data(arr._data.detach() * scale)
    return total_norm


def check_sha1(filename: str, sha1_hash: str) -> bool:
    """(ref: utils.py:check_sha1)"""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url: str, path: Optional[str] = None, overwrite: bool = False,
             sha1_hash: Optional[str] = None, retries: int = 5,
             verify_ssl: bool = True) -> str:
    """(ref: utils.py:download) The port fetches nothing: it returns the
    file when it is already present (and matches ``sha1_hash``), and raises
    otherwise."""
    fname = url.split("/")[-1] if path is None else (
        os.path.join(path, url.split("/")[-1]) if os.path.isdir(path) else path)
    if os.path.exists(fname) and not overwrite and (
            sha1_hash is None or check_sha1(fname, sha1_hash)):
        return fname
    raise RuntimeError(
        f"download({url}): the port has no network access; place the file "
        f"at {fname}")


def params_from_jax(net, arrays: Dict[str, _np.ndarray], ctx=None) -> None:
    """Load a JAX net's parameters into the port's ``net``. ``arrays`` maps
    each structural name (the keys of ``_collect_params_with_prefix``, as
    ``save_parameters`` writes them) to a numpy array. Every name must be
    there and every known shape must match. Each array keeps its own type
    (bfloat16 bit for bit, through its 16-bit pattern). The values land on
    ``ctx``, else on the parameter's own device, else the current
    context."""
    params = net._collect_params_with_prefix()
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise ValueError(f"params_from_jax: missing {missing[:5]}, not in "
                         f"the net {extra[:5]}")
    for name, p in params.items():
        a = arrays[name]
        if p.shape is not None and 0 not in p.shape \
                and tuple(p.shape) != tuple(a.shape):
            raise ValueError(f"params_from_jax: {name} has shape "
                             f"{tuple(a.shape)}, the net {tuple(p.shape)}")
        where = ctx
        if where is None:
            where = (p._data.context if p._data is not None
                     else p._deferred_init[1] if p._deferred_init
                     else current_context())
        with autograd.pause():
            data = nd_array(a, where)
        p._shape = tuple(a.shape)
        p._deferred_init = ()
        p.dtype = data.dtype
        p._init_impl(data, where)
