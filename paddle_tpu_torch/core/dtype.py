"""Dtypes of the port (port of ``paddle_tpu/core/dtype.py``).

Two faces of one table. Inside the port a dtype is a ``torch.dtype``:
:func:`convert_dtype` turns a name (``"bfloat16"``), a numpy dtype, a
:class:`DType` or a ``torch.dtype`` into one, and raises for a name it
does not know, so an unknown dtype never slips through as a silent cast.
At the user API a dtype is a :class:`DType` (``paddle.float32``), which
compares equal to its name, to its ``torch.dtype`` and to its numpy
dtype, as the reference's does (:func:`to_dtype`).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "DType", "float32", "float64", "float16", "bfloat16", "int8", "int16",
    "int32", "int64", "uint8", "bool_", "complex64", "complex128",
    "convert_dtype", "dtype_name", "to_dtype", "is_floating_point",
    "is_integer", "finfo", "iinfo", "default_float",
]


class DType:
    """A named dtype over a ``torch.dtype`` (reference ``DType``)."""

    __slots__ = ("name", "torch_dtype")

    def __init__(self, name: str, torch_dtype: torch.dtype):
        self.name = name
        self.torch_dtype = torch_dtype

    @property
    def np_dtype(self):
        if self.torch_dtype is torch.bfloat16:
            raise TypeError("numpy has no bfloat16")
        return np.dtype(self.name)

    @property
    def itemsize(self) -> int:
        return self.torch_dtype.itemsize

    def __eq__(self, other):
        if isinstance(other, DType):
            return self.torch_dtype == other.torch_dtype
        if isinstance(other, torch.dtype):
            return self.torch_dtype == other
        try:
            return self.torch_dtype == convert_dtype(other)
        except (TypeError, ValueError):
            return False

    def __hash__(self):
        return hash(self.torch_dtype)

    def __repr__(self):
        return f"paddle_tpu_torch.{self.name}"

    def __str__(self):
        return self.name


float32 = DType("float32", torch.float32)
float64 = DType("float64", torch.float64)
float16 = DType("float16", torch.float16)
bfloat16 = DType("bfloat16", torch.bfloat16)
int8 = DType("int8", torch.int8)
int16 = DType("int16", torch.int16)
int32 = DType("int32", torch.int32)
int64 = DType("int64", torch.int64)
uint8 = DType("uint8", torch.uint8)
bool_ = DType("bool", torch.bool)
complex64 = DType("complex64", torch.complex64)
complex128 = DType("complex128", torch.complex128)

_ALL = [float32, float64, float16, bfloat16, int8, int16, int32, int64,
        uint8, bool_, complex64, complex128]
_BY_NAME = {d.name: d for d in _ALL}
_BY_NAME.update({"bool_": bool_, "float": float32, "double": float64,
                 "half": float16, "int": int32, "long": int64})
_BY_TORCH = {d.torch_dtype: d for d in _ALL}


def to_dtype(dtype) -> DType:
    """Any dtype spec -> the :class:`DType` (``None`` is float32)."""
    if dtype is None:
        return float32
    if isinstance(dtype, DType):
        return dtype
    return _BY_TORCH[convert_dtype(dtype)]


def convert_dtype(dtype) -> torch.dtype:
    """A dtype name, numpy dtype, :class:`DType` or ``torch.dtype`` -> the
    ``torch.dtype``. Raises ``TypeError`` for a dtype the port has no
    counterpart of."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _BY_TORCH:
            raise TypeError(f"dtype {dtype} is not supported by the port")
        return dtype
    if isinstance(dtype, DType):
        return dtype.torch_dtype
    if isinstance(dtype, str) and dtype in _BY_NAME:
        return _BY_NAME[dtype].torch_dtype
    try:
        name = np.dtype(dtype).name
    except TypeError:
        name = None
    if name not in _BY_NAME:
        raise TypeError(
            f"dtype {dtype!r} is not supported by the port (want one of "
            f"{sorted(d.name for d in _ALL)})")
    return _BY_NAME[name].torch_dtype


def dtype_name(dtype) -> str:
    """The name of a supported dtype (``torch.bfloat16`` -> ``"bfloat16"``)."""
    return _BY_TORCH[convert_dtype(dtype)].name


def default_float() -> torch.dtype:
    """The floating dtype creation ops default to (``FLAGS_default_dtype``)."""
    from .flags import flag
    return convert_dtype(flag("default_dtype"))


def is_floating_point(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return not (d.is_floating_point or d.is_complex or d is torch.bool)


def finfo(dtype):
    return torch.finfo(convert_dtype(dtype))


def iinfo(dtype):
    return torch.iinfo(convert_dtype(dtype))
