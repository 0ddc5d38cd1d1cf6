"""Linear-algebra operators (the ``nd.linalg`` namespace).

Counterpart of ``incubator_mxnet_tpu/ndarray/linalg.py`` (ref: the la_op
family of src/operator/tensor/la_op.cc — _linalg_gemm, gemm2, potrf,
potri, trsm, trmm, syrk, gelqf, syevd, sumlogdiag). The reference lowers
them to ``jnp.linalg`` and ``jax.scipy.linalg``, not to Pallas; here they
are ``torch.linalg`` and ``torch.matmul`` calls. Every op takes stacked
batches (..., m, n), and its gradient comes through the port's autograd
tape (``invoke``): PyTorch's derivatives of the decompositions.
"""
from __future__ import annotations

import torch

from .ndarray import invoke

__all__ = ["gemm", "gemm2", "potrf", "potri", "trsm", "trmm", "syrk",
           "gelqf", "syevd", "sumlogdiag"]


def _t(x, transpose):
    return x.transpose(-1, -2) if transpose else x


def gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
         beta=1.0):
    """alpha * op(A) @ op(B) + beta * C (ref: la_op.cc _linalg_gemm)."""
    return invoke(
        lambda a, b, c: alpha * _t(a, transpose_a) @ _t(b, transpose_b)
        + beta * c, [A, B, C], "linalg_gemm")


def gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0):
    """alpha * op(A) @ op(B) (ref: la_op.cc _linalg_gemm2)."""
    return invoke(
        lambda a, b: alpha * _t(a, transpose_a) @ _t(b, transpose_b),
        [A, B], "linalg_gemm2")


def potrf(A):
    """The lower Cholesky factor L of A = L @ L.T (ref: la_op.cc
    _linalg_potrf)."""
    return invoke(torch.linalg.cholesky, [A], "linalg_potrf")


def potri(L):
    """inv(A) from A's Cholesky factor L (ref: la_op.cc _linalg_potri)."""
    def f(lo):
        eye = torch.eye(lo.shape[-1], dtype=lo.dtype,
                        device=lo.device).expand(lo.shape)
        linv = torch.linalg.solve_triangular(lo, eye, upper=False)
        return linv.transpose(-1, -2) @ linv
    return invoke(f, [L], "linalg_potri")


def trsm(A, B, transpose=False, rightside=False, lower=True, alpha=1.0):
    """Solve op(A) X = alpha B (X op(A) = alpha B when ``rightside``) with
    A triangular (ref: la_op.cc _linalg_trsm)."""
    def f(a, b):
        x = torch.linalg.solve_triangular(
            _t(a, transpose), b, upper=lower if transpose else not lower,
            left=not rightside)
        return alpha * x
    return invoke(f, [A, B], "linalg_trsm")


def trmm(A, B, transpose=False, rightside=False, lower=True, alpha=1.0):
    """alpha op(A) @ B (alpha B @ op(A) when ``rightside``) with A
    triangular (ref: la_op.cc _linalg_trmm)."""
    def f(a, b):
        tri = _t(torch.tril(a) if lower else torch.triu(a), transpose)
        return alpha * (b @ tri if rightside else tri @ b)
    return invoke(f, [A, B], "linalg_trmm")


def syrk(A, transpose=False, alpha=1.0):
    """alpha * A @ A.T (alpha * A.T @ A when ``transpose``) (ref: la_op.cc
    _linalg_syrk)."""
    return invoke(lambda a: alpha * (_t(a, transpose) @ _t(a, not transpose)),
                  [A], "linalg_syrk")


def gelqf(A):
    """The LQ factorization A = L @ Q, Q's rows orthonormal; returns (Q, L)
    with L's diagonal non-negative, LAPACK's convention (ref: la_op.cc
    _linalg_gelqf), through the QR factorization of A.T."""
    def f(a):
        q, r = torch.linalg.qr(a.transpose(-1, -2), mode="reduced")
        d = torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))
        d = torch.where(d == 0, torch.ones_like(d), d)
        q = q * d[..., None, :]
        r = r * d[..., :, None]
        return q.transpose(-1, -2), r.transpose(-1, -2)
    return invoke(f, [A], "linalg_gelqf", n_out=2)


def syevd(A):
    """Symmetric eigendecomposition A = U.T @ diag(L) @ U; returns (U, L),
    the eigenvectors as U's rows and the eigenvalues ascending (ref:
    la_op.cc _linalg_syevd)."""
    def f(a):
        w, v = torch.linalg.eigh(a)
        return v.transpose(-1, -2), w
    return invoke(f, [A], "linalg_syevd", n_out=2)


def sumlogdiag(A):
    """sum(log(diag(A))) over the last two axes (ref: la_op.cc
    _linalg_sumlogdiag)."""
    return invoke(lambda a: torch.sum(torch.log(torch.diagonal(
        a, dim1=-2, dim2=-1)), dim=-1), [A], "linalg_sumlogdiag")
