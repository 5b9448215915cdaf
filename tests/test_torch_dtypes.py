"""The five dtypes the port took from the reference's table
(``paddle_tpu/core/dtype.py:24-31, 85-92``): ``float8_e4m3fn``,
``float8_e5m2``, ``uint16``, ``uint32`` and ``uint64``. They convert,
compare and round-trip through ``to_tensor``/``astype``/``cast`` as the
reference's do; and the ops of the op table that PyTorch computes on
them give the reference's values, while the ones it refuses are pinned
here (``REFUSED``), a divergence from the reference, which computes
them all. ``uint64`` stays 64-bit where the reference, JAX with x64 off,
truncates it to uint32.
"""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import dtype as D

from test_torch_bridge import one_torch_thread  # noqa: F401
from torch_api_common import on_cpu  # noqa: F401

NEW = ["float8_e4m3fn", "float8_e5m2", "uint16", "uint32", "uint64"]
TORCH = {"float8_e4m3fn": torch.float8_e4m3fn,
         "float8_e5m2": torch.float8_e5m2, "uint16": torch.uint16,
         "uint32": torch.uint32, "uint64": torch.uint64}

# name -> how it is called on a [2, 3] tensor t
OPS = {
    "add": lambda m, t: m.add(t, t), "subtract": lambda m, t: m.subtract(t, t),
    "multiply": lambda m, t: m.multiply(t, t),
    "divide": lambda m, t: m.divide(t, t),
    "floor_divide": lambda m, t: m.floor_divide(t, t),
    "remainder": lambda m, t: m.remainder(t, t),
    "maximum": lambda m, t: m.maximum(t, t),
    "minimum": lambda m, t: m.minimum(t, t),
    "equal": lambda m, t: m.equal(t, t),
    "not_equal": lambda m, t: m.not_equal(t, t),
    "less_than": lambda m, t: m.less_than(t, t),
    "greater_equal": lambda m, t: m.greater_equal(t, t),
    "bitwise_and": lambda m, t: m.bitwise_and(t, t),
    "abs": lambda m, t: m.abs(t), "sum": lambda m, t: m.sum(t),
    "prod": lambda m, t: m.prod(t), "max": lambda m, t: m.max(t),
    "min": lambda m, t: m.min(t), "mean": lambda m, t: m.mean(t),
    "sort": lambda m, t: m.sort(t), "argsort": lambda m, t: m.argsort(t),
    "argmax": lambda m, t: m.argmax(t), "cumsum": lambda m, t: m.cumsum(t),
    "clip": lambda m, t: m.clip(t), "sign": lambda m, t: m.sign(t),
    "square": lambda m, t: m.square(t),
    "concat": lambda m, t: m.concat([t, t]),
    "reshape": lambda m, t: m.reshape(t, [3, 2]),
    "transpose": lambda m, t: m.transpose(t, [1, 0]),
    "cast": lambda m, t: m.cast(t, "float32"),
}
_UNSIGNED_REFUSED = {"add", "subtract", "floor_divide", "remainder",
                     "maximum", "minimum", "less_than", "greater_equal",
                     "abs", "max", "min", "argmax", "cumsum", "sign",
                     "square"}
_FLOAT8_REFUSED = (_UNSIGNED_REFUSED - {"abs"}) | {
    "divide", "bitwise_and", "sum", "prod", "mean", "sort", "argsort"}
#: what PyTorch refuses on the CPU, by dtype (the reference computes all
#: but float8's bitwise_and, which JAX refuses too)
REFUSED = {"uint16": _UNSIGNED_REFUSED, "uint32": _UNSIGNED_REFUSED,
           "uint64": _UNSIGNED_REFUSED, "float8_e4m3fn": _FLOAT8_REFUSED,
           "float8_e5m2": _FLOAT8_REFUSED}


def _vals(out):
    out = out[0] if isinstance(out, (tuple, list)) else out
    if isinstance(out, torch.Tensor):
        t = out.detach()
        return t.float().numpy() if t.dtype in (
            torch.float8_e4m3fn, torch.float8_e5m2) else t.numpy()
    return np.asarray(out.astype("float32").data
                      if "float8" in str(out.dtype) else out.data)


@pytest.mark.parametrize("name", NEW)
def test_dtype_round_trips_as_the_reference(name, on_cpu):  # noqa: F811
    """``convert_dtype``, ``to_dtype`` and the ``DType``'s name and
    equalities; ``to_tensor(..., dtype=)``, ``astype`` and ``cast`` there
    and back to float32 give the reference's values (float8 rounding
    included); numpy data of the unsigned types keeps its dtype."""
    dt = getattr(D, name)
    assert D.convert_dtype(name) is TORCH[name] and dt == name
    assert D.to_dtype(TORCH[name]) is dt and str(dt) == name
    assert dt.itemsize == TORCH[name].itemsize
    data = np.array([[0.0, 1.5, 3.0], [17.0, 200.0, 448.0]], np.float32)
    if name.startswith("uint"):
        data = np.floor(data)
        assert paddle.to_tensor(data.astype(name)).dtype == TORCH[name]
        assert dt.np_dtype == np.dtype(name)
    else:
        with pytest.raises(TypeError, match="numpy has no"):
            dt.np_dtype
    t = paddle.to_tensor(data, dtype=name)
    assert t.dtype == TORCH[name]
    with warnings.catch_warnings():  # uint64 -> uint32 under JAX's x32
        warnings.simplefilter("ignore", UserWarning)
        j = pt.to_tensor(data).astype(name)
    np.testing.assert_array_equal(_vals(t.astype("float32")),
                                  _vals(j.astype("float32")))
    np.testing.assert_array_equal(
        _vals(paddle.to_tensor(data).astype(name).cast("float32")),
        _vals(j.astype("float32")))
    if name == "uint64":
        assert str(j.dtype) == "uint32" and t.dtype == torch.uint64


@pytest.mark.parametrize("name", NEW)
def test_ops_on_the_new_dtypes(name, on_cpu):  # noqa: F811
    """Every op of ``OPS`` either gives the reference's values or is one
    PyTorch refuses (``REFUSED``), raising where the reference computes
    (float8's ``bitwise_and`` the reference refuses too)."""
    data = np.array([[1, 2, 3], [4, 5, 6]], np.float32)
    t = paddle.to_tensor(data, dtype=name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        j = pt.to_tensor(data).astype(name)
    refused = set()
    for op, call in OPS.items():
        try:
            got = call(paddle, t)
        except (RuntimeError, TypeError, NotImplementedError):
            refused.add(op)
            continue
        want = call(pt, j)
        np.testing.assert_allclose(_vals(got).astype(np.float64),
                                   _vals(want).astype(np.float64),
                                   rtol=1e-6, err_msg=op)
    assert refused == REFUSED[name], sorted(refused ^ REFUSED[name])
