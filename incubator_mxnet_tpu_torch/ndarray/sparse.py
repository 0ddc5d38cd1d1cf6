"""Sparse NDArray storage types: CSR and row-sparse.

Counterpart of ``incubator_mxnet_tpu/ndarray/sparse.py`` (ref:
include/mxnet/ndarray.h kCSRStorage / kRowSparseStorage;
python/mxnet/ndarray/sparse.py CSRNDArray / RowSparseNDArray; kernels
src/operator/tensor/cast_storage-inl.h and dot-inl.h's sparse paths). As
in the reference, a sparse array holds dense component tensors (``data``,
``indices``, ``indptr``) on its device, and its compute is plain PyTorch
index, gather and segment-sum operations (the reference lowers them to
XLA's gather, scatter and segment sums; no Pallas kernel stands behind
any of them). Indices are int64, PyTorch's index type (the reference
keeps int32).

Row-sparse is the load-bearing type: it carries an ``Embedding(
sparse_grad=True)`` gradient (``Parameter.row_sparse_grad``) into the
optimizers' lazy row updates (``optimizer/fused.py``,
``ops/cuda/multi_tensor.py``'s ``row_sparse_update``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as _np
import torch

from ..context import Context, current_context
from .ndarray import (NDArray, _as_nd, _wrap, canonical_dtype, invoke,
                      to_torch_dtype)

__all__ = ["BaseSparseNDArray", "CSRNDArray", "RowSparseNDArray",
           "csr_matrix", "row_sparse_array", "cast_storage", "dot",
           "retain", "sparse_add", "zeros", "sparse_retain", "square_sum"]


def _tensor(x, device, dtype=None) -> torch.Tensor:
    """``x`` (an NDArray, a tensor, a numpy array or a list) as a tensor on
    ``device``, of ``dtype`` when given."""
    if isinstance(x, NDArray):
        t = x._data.detach()
    elif isinstance(x, torch.Tensor):
        t = x.detach()
    else:
        t = torch.as_tensor(_np.asarray(x))
    return t.to(device=device, dtype=dtype or canonical_dtype(t.dtype))


def _device_of(ctx, *xs) -> torch.device:
    if ctx is not None:
        return ctx.torch_device
    for x in xs:
        if isinstance(x, NDArray):
            return x._data.device
        if isinstance(x, torch.Tensor):
            return x.device
    return current_context().torch_device


class BaseSparseNDArray:
    """Common behaviour of the sparse arrays (ref: sparse.py
    BaseSparseNDArray)."""

    stype = "undefined"

    def __init__(self, shape: Tuple[int, ...], dtype: torch.dtype,
                 device: torch.device):
        self._shape = tuple(int(s) for s in shape)
        self._tdtype = dtype
        self._device = device

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return _np.dtype(str(self._tdtype).replace("torch.", ""))

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def context(self) -> Context:
        return Context.from_torch(self._device)

    ctx = context

    def asnumpy(self) -> _np.ndarray:
        return self.todense().asnumpy()

    def wait_to_read(self):
        self.todense().wait_to_read()

    def __repr__(self):
        return (f"\n<{type(self).__name__} "
                f"{'x'.join(map(str, self._shape))} @{self.context}>")

    def todense(self) -> NDArray:
        raise NotImplementedError

    def tostype(self, stype: str):
        return cast_storage(self, stype)

    def copyto(self, other):
        if isinstance(other, Context):
            return self.as_in_context(other)
        raise NotImplementedError(
            f"{type(self).__name__}.copyto: only to a Context")

    def as_in_context(self, ctx: Context):
        raise NotImplementedError


class CSRNDArray(BaseSparseNDArray):
    """2-D compressed-sparse-row array (ref: sparse.py CSRNDArray): the
    values ``data`` (nnz,), their columns ``indices`` (nnz,) and the row
    offsets ``indptr`` (rows + 1,)."""

    stype = "csr"

    def __init__(self, data, indices, indptr, shape, dtype=None, ctx=None):
        device = _device_of(ctx, data)
        dt = to_torch_dtype(dtype) if dtype is not None else None
        self.data = _tensor(data, device, dt)
        super().__init__(shape, self.data.dtype, device)
        self.indices = _tensor(indices, device, torch.int64)
        self.indptr = _tensor(indptr, device, torch.int64)

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    def _row_ids(self) -> torch.Tensor:
        """The row of each stored value."""
        return torch.searchsorted(
            self.indptr, torch.arange(self.nnz, device=self._device),
            right=True) - 1

    def todense(self) -> NDArray:
        dense = torch.zeros(self._shape, dtype=self._tdtype,
                            device=self._device)
        dense[self._row_ids(), self.indices] = self.data
        return _wrap(dense)

    def __getitem__(self, key):
        return self.todense()[key]

    def slice(self, begin, end) -> "CSRNDArray":
        """Rows [begin, end) (ref: CSRNDArray slice)."""
        b = begin[0] if isinstance(begin, (tuple, list)) else begin
        e = end[0] if isinstance(end, (tuple, list)) else end
        b = 0 if b is None else int(b)
        e = self._shape[0] if e is None else int(e)
        lo, hi = int(self.indptr[b]), int(self.indptr[e])
        return CSRNDArray(self.data[lo:hi], self.indices[lo:hi],
                          self.indptr[b:e + 1] - lo,
                          (e - b,) + self._shape[1:])

    def as_in_context(self, ctx: Context) -> "CSRNDArray":
        if ctx.torch_device == self._device:
            return self
        return CSRNDArray(self.data, self.indices, self.indptr, self._shape,
                          ctx=ctx)


class RowSparseNDArray(BaseSparseNDArray):
    """First-dimension-sparse array (ref: sparse.py RowSparseNDArray): the
    stored rows ``data`` (k, ...) and their row ids ``indices`` (k,),
    unique. The gradient currency of embeddings."""

    stype = "row_sparse"

    def __init__(self, data, indices, shape, dtype=None, ctx=None):
        device = _device_of(ctx, data)
        dt = to_torch_dtype(dtype) if dtype is not None else None
        self.data = _tensor(data, device, dt)
        super().__init__(shape, self.data.dtype, device)
        self.indices = _tensor(indices, device, torch.int64)

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def todense(self) -> NDArray:
        dense = torch.zeros(self._shape, dtype=self._tdtype,
                            device=self._device)
        if self.nnz:
            dense.index_add_(0, self.indices, self.data)
        return _wrap(dense)

    def retain(self, row_ids) -> "RowSparseNDArray":
        return retain(self, row_ids)

    def __add__(self, other):
        return sparse_add(self, other)

    def as_in_context(self, ctx: Context) -> "RowSparseNDArray":
        if ctx.torch_device == self._device:
            return self
        return RowSparseNDArray(self.data, self.indices, self._shape,
                                ctx=ctx)


# ---------------------------------------------------------------------------
# constructors (ref: sparse.py csr_matrix / row_sparse_array / zeros)
# ---------------------------------------------------------------------------
def csr_matrix(arg1, shape=None, ctx=None, dtype=None) -> CSRNDArray:
    """A CSR array from (data, indices, indptr) and ``shape``, or from a
    dense array."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        return CSRNDArray(data, indices, indptr, shape, dtype, ctx)
    return _dense_to_csr(_dense(arg1, ctx, dtype))


def row_sparse_array(arg1, shape=None, ctx=None,
                     dtype=None) -> RowSparseNDArray:
    """A row-sparse array from (data, indices) and ``shape``, or from a
    dense array."""
    if isinstance(arg1, tuple) and len(arg1) == 2 \
            and not _np.isscalar(arg1[0]):
        data, indices = arg1
        return RowSparseNDArray(data, indices, shape, dtype, ctx)
    return _dense_to_rsp(_dense(arg1, ctx, dtype))


def zeros(stype: str, shape, ctx=None, dtype=None):
    """An all-zero array of storage ``stype`` (ref: sparse.py zeros)."""
    dt = to_torch_dtype(dtype or "float32")
    device = _device_of(ctx)
    shape = tuple(shape)
    if stype == "csr":
        return CSRNDArray(torch.zeros((0,), dtype=dt),
                          torch.zeros((0,), dtype=torch.int64),
                          torch.zeros((shape[0] + 1,), dtype=torch.int64),
                          shape, ctx=Context.from_torch(device))
    if stype == "row_sparse":
        return RowSparseNDArray(torch.zeros((0,) + shape[1:], dtype=dt),
                                torch.zeros((0,), dtype=torch.int64), shape,
                                ctx=Context.from_torch(device))
    from .ndarray import zeros as dense_zeros
    return dense_zeros(shape, ctx, dtype)


def _dense(x, ctx=None, dtype=None) -> torch.Tensor:
    if isinstance(x, BaseSparseNDArray):
        x = x.todense()
    t = _as_nd(x)._data.detach()
    if ctx is not None:
        t = t.to(ctx.torch_device)
    return t.to(to_torch_dtype(dtype)) if dtype is not None else t


def _dense_to_csr(a: torch.Tensor) -> CSRNDArray:
    if a.dim() != 2:
        raise ValueError(f"csr storage is 2-D, got shape {tuple(a.shape)}")
    nz = a != 0
    indptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=a.device),
                        torch.cumsum(nz.sum(dim=1), 0)])
    cols = torch.nonzero(nz)[:, 1]
    return CSRNDArray(a[nz], cols, indptr, a.shape)


def _dense_to_rsp(a: torch.Tensor) -> RowSparseNDArray:
    rows = torch.nonzero(a.reshape(a.shape[0], -1).any(dim=1)).reshape(-1)
    return RowSparseNDArray(a[rows], rows, a.shape)


def cast_storage(arr, stype: str):
    """Dense <-> sparse conversion (ref: src/operator/tensor/
    cast_storage-inl.h)."""
    if isinstance(arr, BaseSparseNDArray):
        if stype == arr.stype:
            return arr
        if stype == "default":
            return arr.todense()
        return cast_storage(arr.todense(), stype)
    if stype == "default":
        return _as_nd(arr)
    if stype == "csr":
        return _dense_to_csr(_dense(arr))
    if stype == "row_sparse":
        return _dense_to_rsp(_dense(arr))
    raise ValueError(f"unknown stype {stype}")


# ---------------------------------------------------------------------------
# compute (ref: src/operator/tensor/dot-inl.h's sparse dispatch)
# ---------------------------------------------------------------------------
def dot(lhs, rhs, transpose_a: bool = False, transpose_b: bool = False):
    """dot with sparse operands: csr x dense (and its transpose_a), dense x
    row_sparse, dense x dense. The CSR operand is data, not a variable:
    the gradient flows to the dense operand (autograd records the call)."""
    from .ndarray import dot as dense_dot
    if isinstance(lhs, CSRNDArray) and isinstance(rhs, NDArray):
        data, indices, rows = lhs.data, lhs.indices, lhs._row_ids()
        n_rows, n_cols = lhs.shape

        def f(r):
            if transpose_b:
                r = r.T
            vec = r.dim() == 1
            if vec:
                r = r[:, None]
            if transpose_a:
                out = torch.zeros((n_cols, r.shape[1]), dtype=r.dtype,
                                  device=r.device)
                out = out.index_add(0, indices, r[rows] * data[:, None])
            else:
                out = torch.zeros((n_rows, r.shape[1]), dtype=r.dtype,
                                  device=r.device)
                out = out.index_add(0, rows, r[indices] * data[:, None])
            return out[:, 0] if vec else out
        return invoke(f, [rhs], "sparse_dot")
    if isinstance(lhs, NDArray) and isinstance(rhs, RowSparseNDArray):
        return dense_dot(lhs, rhs.todense(), transpose_a, transpose_b)
    if isinstance(lhs, NDArray) and isinstance(rhs, NDArray):
        return dense_dot(lhs, rhs, transpose_a, transpose_b)
    raise TypeError(f"unsupported sparse dot: {type(lhs)} x {type(rhs)}")


def retain(rsp: RowSparseNDArray, row_ids) -> RowSparseNDArray:
    """Keep only the listed rows (ref: src/operator/tensor/
    sparse_retain.cc)."""
    want = _tensor(row_ids, rsp._device, torch.int64).reshape(-1)
    keep = torch.isin(rsp.indices, want)
    return RowSparseNDArray(rsp.data[keep], rsp.indices[keep], rsp.shape)


def sparse_retain(data, indices):
    """``retain`` under the reference's registry name
    (``_sparse_retain``)."""
    return retain(data, indices)


def sparse_add(a, b):
    """a + b: row-sparse + row-sparse stays row-sparse (the union of the
    rows, sorted); anything else adds densely."""
    if isinstance(a, RowSparseNDArray) and isinstance(b, RowSparseNDArray):
        idx = torch.cat([a.indices, b.indices.to(a._device)])
        dat = torch.cat([a.data, b.data.to(a._device)])
        uniq, pos = torch.unique(idx, sorted=True, return_inverse=True)
        rows = torch.zeros((uniq.shape[0],) + a.shape[1:],
                           dtype=a.data.dtype, device=a._device)
        rows.index_add_(0, pos, dat)
        return RowSparseNDArray(rows, uniq, a.shape)
    da = a.todense() if isinstance(a, BaseSparseNDArray) else a
    db = b.todense() if isinstance(b, BaseSparseNDArray) else b
    return da + db


def square_sum(data, axis=None, keepdims: bool = False):
    """sum(x ** 2) over ``axis`` (ref: src/operator/tensor/square_sum.cc
    _square_sum), for dense or row-sparse input; row-sparse input reads
    its stored rows only where the reduction allows."""
    rank = len(data.shape)
    ax = tuple(axis) if isinstance(axis, list) else axis
    if ax is not None:
        ax = ax % rank if isinstance(ax, int) else tuple(a % rank
                                                         for a in ax)
    if isinstance(data, RowSparseNDArray):
        n_rows = data.shape[0]
        per_row = ax == 1 or (isinstance(ax, tuple)
                              and set(ax) == set(range(1, rank)))
        if per_row:
            def f(v, i):
                rs = torch.sum(torch.square(v), dim=tuple(range(1, v.dim())))
                out = torch.zeros((n_rows,), dtype=v.dtype,
                                  device=v.device).index_copy(0, i, rs)
                return out.reshape((n_rows,) + (1,) * (rank - 1)) \
                    if keepdims else out
            return invoke(f, [_wrap(data.data), _wrap(data.indices)],
                          "square_sum")
        if ax is None:
            def f(v):
                r = torch.sum(torch.square(v))
                return r.reshape((1,) * rank) if keepdims else r
            return invoke(f, [_wrap(data.data)], "square_sum")
        data = data.todense()
    dims = tuple(range(rank)) if ax is None else ax
    return invoke(lambda x: torch.sum(torch.square(x), dim=dims,
                                      keepdim=keepdims),
                  [_as_nd(data)], "square_sum")
