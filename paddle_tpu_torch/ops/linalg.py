"""Linear algebra ops — port of ``paddle_tpu/ops/linalg.py``.

Products go to cuBLAS through ``torch.matmul``; decompositions and
solvers to ``torch.linalg`` (cuSOLVER/MAGMA on the card, LAPACK on the
CPU), as the reference delegates to ``jnp.linalg``.
"""
from __future__ import annotations

import math

import torch

from ._common import LONG, floatify
from ._registry import op

__all__ = [
    "matmul", "bmm", "dot", "inner", "outer", "mv", "addmm", "einsum",
    "norm", "dist", "cross", "cdist", "histogram", "bincount", "cholesky",
    "cholesky_solve", "qr", "svd", "eig", "eigh", "eigvals", "eigvalsh",
    "matrix_rank", "det", "slogdet", "inverse", "pinv", "solve",
    "triangular_solve", "lstsq", "matrix_power", "multi_dot", "lu",
    "corrcoef", "cov",
]


@op
def matmul(x, y, transpose_x=False, transpose_y=False):
    if transpose_x and x.ndim > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.ndim > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


@op
def bmm(x, y):
    return torch.matmul(x, y)


@op
def dot(x, y):
    return torch.sum(x * y, dim=-1)


@op
def inner(x, y):
    return torch.inner(x, y)


@op
def outer(x, y):
    return torch.outer(x.reshape(-1), y.reshape(-1))


@op
def mv(x, vec):
    return torch.matmul(x, vec)


@op
def addmm(input, x, y, beta=1.0, alpha=1.0):
    return beta * input + alpha * torch.matmul(x, y)


@op
def einsum(equation, *operands):
    return torch.einsum(equation, *operands)


def _ord(p):
    if p in ("inf", float("inf")):
        return math.inf
    if p in ("-inf", float("-inf")):
        return -math.inf
    return p


@op
def norm(x, p="fro", axis=None, keepdim=False):
    if isinstance(axis, (list, tuple)) and len(axis) == 1:
        axis = axis[0]
    if p == "fro":
        if axis is None:
            return torch.sqrt(torch.sum(torch.square(x)))
        if isinstance(axis, int):
            return torch.linalg.vector_norm(x, 2, dim=axis, keepdim=keepdim)
        return torch.linalg.matrix_norm(x, "fro", dim=tuple(axis),
                                        keepdim=keepdim)
    ordv = _ord(p)
    if axis is None:
        return torch.linalg.vector_norm(x.reshape(-1), ordv, keepdim=keepdim)
    if isinstance(axis, int):
        return torch.linalg.vector_norm(x, ordv, dim=axis, keepdim=keepdim)
    return torch.linalg.matrix_norm(x, ordv, dim=tuple(axis),
                                    keepdim=keepdim)


@op
def dist(x, y, p=2.0):
    d = x - y
    if p == 0:
        return torch.sum(d != 0).to(x.dtype)
    if p == float("inf"):
        return torch.max(torch.abs(d))
    if p == float("-inf"):
        return torch.min(torch.abs(d))
    return torch.pow(torch.sum(torch.pow(torch.abs(d), p)), 1.0 / p)


@op
def cross(x, y, axis=None):
    return torch.linalg.cross(x, y, dim=-1 if axis is None else int(axis))


@op
def cdist(x, y, p=2.0):
    diff = x[..., :, None, :] - y[..., None, :, :]
    if p == 2.0:
        return torch.sqrt(torch.sum(torch.square(diff), dim=-1) + 0.0)
    return torch.pow(torch.sum(torch.pow(torch.abs(diff), p), dim=-1),
                     1.0 / p)


@op
def histogram(x, bins=100, min=0, max=0):
    xf = x.float()
    if min == 0 and max == 0:
        min, max = float(xf.min()), float(xf.max())
    return torch.histc(xf, bins=int(bins), min=min, max=max).to(LONG)


@op
def bincount(x, weights=None, minlength=0):
    out = torch.bincount(x.long(), weights=weights, minlength=int(minlength))
    return out if weights is None else out.to(weights.dtype)


# -- decompositions / solvers --------------------------------------------------
@op
def cholesky(x, upper=False):
    return torch.linalg.cholesky(floatify(x), upper=upper)


@op
def cholesky_solve(x, y, upper=False):
    return torch.cholesky_solve(floatify(x), floatify(y), upper=upper)


@op
def qr(x, mode="reduced"):
    q, r = torch.linalg.qr(floatify(x), mode=mode)
    return q, r


@op
def svd(x, full_matrices=False):
    u, s, vh = torch.linalg.svd(floatify(x), full_matrices=full_matrices)
    return u, s, vh


@op
def eig(x):
    w, v = torch.linalg.eig(x)
    return w, v


@op
def eigh(x, UPLO="L"):
    w, v = torch.linalg.eigh(floatify(x), UPLO=UPLO)
    return w, v


@op
def eigvals(x):
    return torch.linalg.eigvals(x)


@op
def eigvalsh(x, UPLO="L"):
    return torch.linalg.eigvalsh(floatify(x), UPLO=UPLO)


@op
def matrix_rank(x, tol=None, hermitian=False):
    return torch.linalg.matrix_rank(floatify(x), rtol=tol, hermitian=hermitian).to(LONG)


@op
def det(x):
    return torch.linalg.det(floatify(x))


@op
def slogdet(x):
    sign, logdet = torch.linalg.slogdet(floatify(x))
    return torch.stack([sign, logdet])


@op
def inverse(x):
    return torch.linalg.inv(floatify(x))


@op
def pinv(x, rcond=1e-15, hermitian=False):
    return torch.linalg.pinv(floatify(x), rtol=rcond, hermitian=hermitian)


@op
def solve(x, y):
    return torch.linalg.solve(floatify(x), floatify(y))


@op
def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    x, y = floatify(x), floatify(y)
    if transpose:
        x, upper = x.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(x, y, upper=upper,
                                         unitriangular=unitriangular)


@op
def lstsq(x, y, rcond=None):
    """``(solution, residuals, rank, singular values)``; on the card only
    the QR solver (``gels``) exists, which gives no rank or singular
    values."""
    x, y = floatify(x), floatify(y)
    solver = "gelsd" if x.device.type == "cpu" else "gels"
    sol, res, rank, sv = torch.linalg.lstsq(x, y, rcond=rcond, driver=solver)
    return sol, res, rank, sv


@op
def matrix_power(x, n):
    return torch.linalg.matrix_power(x, int(n))


@op
def multi_dot(xs):
    return torch.linalg.multi_dot(list(xs))


@op
def lu(x, pivot=True):
    lu_, piv = torch.linalg.lu_factor(floatify(x), pivot=pivot)
    return lu_, piv.to(torch.int32)  # 1-based, as Paddle's


@op
def corrcoef(x, rowvar=True):
    return torch.corrcoef(x if rowvar else x.transpose(-1, -2))


@op
def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None):
    return torch.cov(x if rowvar else x.transpose(-1, -2),
                     correction=1 if ddof else 0, fweights=fweights,
                     aweights=aweights)

