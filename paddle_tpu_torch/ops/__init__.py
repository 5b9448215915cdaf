"""The op library — port of ``paddle_tpu/ops/__init__.py``.

Paddle's functional ops (``math``, ``creation``, ``reduction``,
``manipulation``, ``linalg``, ``array``, ``extras``), each one plain
PyTorch function registered in ``OPS`` (``_registry``), plus the
kernel-backed modules of the port: the paged-KV attention read paths
(``paged_attention``), the fused chunked cross-entropy (``fused_ce``)
and the hand-written Hopper kernels (``pallas``).

:func:`monkey_patch_tensor` attaches the reference's list of Tensor
methods to the port's :class:`~paddle_tpu_torch.core.tensor.Tensor`,
and to nothing else: ``torch.Tensor`` keeps its own methods.
"""
from __future__ import annotations

import sys as _sys

from ._registry import OPS, RAW, get_op, op  # noqa: F401
from .math import *  # noqa: F401,F403
from .creation import *  # noqa: F401,F403
from .reduction import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .array import (  # noqa: F401
    TensorArray, array_length, array_read, array_write, create_array,
)
from .extras import *  # noqa: F401,F403
from . import paged_attention  # noqa: F401

from . import (array as _array, creation as _creation, extras as _extras,
               linalg as _linalg, manipulation as _manipulation,
               math as _math, reduction as _reduction)

# every registered op at module scope
_self = _sys.modules[__name__]
for _name, _fn in OPS.items():
    if not hasattr(_self, _name):
        setattr(_self, _name, _fn)

__all__ = sorted(set(OPS) | {
    n for m in (_math, _creation, _reduction, _manipulation, _linalg,
                _array, _extras) for n in m.__all__} | {
    "OPS", "RAW", "get_op", "op", "monkey_patch_tensor"})

#: the reference's list of Tensor methods (reference ops/__init__.py:39)
TENSOR_METHODS = [
    # math
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder",
    "pow", "maximum", "minimum", "abs", "exp", "log", "log2", "log10",
    "log1p", "sqrt", "rsqrt", "square", "reciprocal", "sign", "floor",
    "ceil", "round", "trunc", "sin", "cos", "tan", "tanh", "sigmoid",
    "erf", "clip", "scale", "cumsum", "cumprod", "isnan", "isinf",
    "isfinite", "equal", "not_equal", "less_than", "less_equal",
    "greater_than", "greater_equal", "logical_and", "logical_or",
    "logical_not", "logical_xor", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "allclose", "isclose", "equal_all",
    "lerp", "nan_to_num",
    # reduction
    "sum", "mean", "prod", "max", "min", "amax", "amin", "std", "var",
    "median", "logsumexp", "argmax", "argmin", "all", "any", "topk",
    "kthvalue", "mode", "count_nonzero", "nanmean", "nansum", "quantile",
    # manipulation
    "cast", "reshape", "transpose", "concat", "split", "chunk", "squeeze",
    "unsqueeze", "flatten", "tile", "expand", "broadcast_to", "expand_as",
    "flip", "roll", "gather", "gather_nd", "take_along_axis",
    "put_along_axis", "scatter", "scatter_nd_add", "index_select",
    "index_sample", "index_add", "masked_select", "masked_fill", "where",
    "nonzero", "tril", "triu", "pad", "repeat_interleave", "sort",
    "argsort", "unbind", "unique", "diagonal", "diff", "moveaxis",
    "swapaxes", "one_hot", "slice", "strided_slice", "bucketize",
    "searchsorted",
    # linalg
    "matmul", "bmm", "dot", "mv", "norm", "dist", "cross", "cholesky",
    "qr", "svd", "eig", "eigh", "det", "slogdet", "inverse", "pinv",
    "solve", "matrix_power", "t", "histogram", "bincount", "addmm",
    "outer", "inner",
]


def monkey_patch_tensor():
    """Attach the op surface as methods of the port's ``Tensor`` (as the
    reference patches its Tensor, varbase_patch_methods.py)."""
    from paddle_tpu_torch.core.tensor import Tensor

    for name in TENSOR_METHODS:
        fn = OPS.get(name)
        if fn is not None:
            setattr(Tensor, name, fn)
    Tensor.mm = OPS["matmul"]
    Tensor.mod = OPS["remainder"]
    Tensor.rsub = lambda self, o: OPS["subtract"](o, self)


monkey_patch_tensor()
