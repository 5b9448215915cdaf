"""Dtype names <-> ``torch.dtype`` (port of ``paddle_tpu/core/dtype.py``).

Only the subset the serving path uses: float32, bfloat16, float16 and
int32. Anything else raises, so an unported dtype never slips through
as a silent cast.
"""
from __future__ import annotations

import torch

__all__ = ["convert_dtype", "dtype_name"]

_BY_NAME = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int32": torch.int32,
}
_BY_DTYPE = {v: k for k, v in _BY_NAME.items()}


def convert_dtype(dtype) -> torch.dtype:
    """A dtype name (``"bfloat16"``) or a ``torch.dtype`` of the supported
    subset -> the ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _BY_DTYPE:
            raise TypeError(f"dtype {dtype} is not supported by the port")
        return dtype
    name = str(dtype)
    if name not in _BY_NAME:
        raise TypeError(
            f"dtype {dtype!r} is not supported by the port (want one of "
            f"{sorted(_BY_NAME)})")
    return _BY_NAME[name]


def dtype_name(dtype) -> str:
    """The name of a supported dtype (``torch.bfloat16`` -> ``"bfloat16"``)."""
    return _BY_DTYPE[convert_dtype(dtype)]
