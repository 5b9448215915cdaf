"""``paddle.linalg`` — port of ``paddle_tpu/linalg.py``: the linear
algebra ops of :mod:`paddle_tpu_torch.ops.linalg` under Paddle's
namespace."""
from paddle_tpu_torch.ops.linalg import (  # noqa: F401
    bincount, bmm, cdist, cholesky, cholesky_solve, corrcoef, cov, cross,
    det, dist, dot, eig, eigh, eigvals, eigvalsh, histogram, inner, inverse,
    lstsq, lu, matmul, matrix_power, matrix_rank, multi_dot, mv, norm,
    outer, pinv, qr, slogdet, solve, svd, triangular_solve,
)

__all__ = [
    "bincount", "bmm", "cdist", "cholesky", "cholesky_solve", "corrcoef",
    "cov", "cross", "det", "dist", "dot", "eig", "eigh", "eigvals",
    "eigvalsh", "histogram", "inner", "inverse", "lstsq", "lu", "matmul",
    "matrix_power", "matrix_rank", "multi_dot", "mv", "norm", "outer",
    "pinv", "qr", "slogdet", "solve", "svd", "triangular_solve",
]
