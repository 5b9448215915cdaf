"""Dtypes of the port (port of ``paddle_tpu/core/dtype.py``).

Two faces of one table. Inside the port a dtype is a ``torch.dtype``:
:func:`convert_dtype` turns a name (``"bfloat16"``), a numpy dtype, a
:class:`DType` or a ``torch.dtype`` into one, and raises for a name it
does not know, so an unknown dtype never slips through as a silent cast.
At the user API a dtype is a :class:`DType` (``paddle.float32``), which
compares equal to its name, to its ``torch.dtype`` and to its numpy
dtype, as the reference's does (:func:`to_dtype`).

The table is the reference's (:24-31, :85-92), the float8 types and the
wide unsigned ones included. PyTorch computes little on those: a float8
tensor is storage (casts, copies, indexing; ``quantization``'s ``fp8_wo``
stores its weights so), and ``uint16``/``uint32``/``uint64`` take casts,
equality, indexing, ``sum``, ``multiply`` and bitwise ops but not, among
others, ``add``, ``abs``, ``max``/``min`` or ordering comparisons, which
raise where the reference computes (``tests/test_torch_dtypes.py`` pins
which ops of the op table refuse them). numpy has no float8, so
``np_dtype`` raises for them as for bfloat16.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "DType", "float32", "float64", "float16", "bfloat16", "int8", "int16",
    "int32", "int64", "uint8", "uint16", "uint32", "uint64", "bool_",
    "complex64", "complex128", "float8_e4m3fn", "float8_e5m2",
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
        if self.torch_dtype in _NO_NUMPY:
            raise TypeError(f"numpy has no {self.name}")
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
uint16 = DType("uint16", torch.uint16)
uint32 = DType("uint32", torch.uint32)
uint64 = DType("uint64", torch.uint64)
bool_ = DType("bool", torch.bool)
complex64 = DType("complex64", torch.complex64)
complex128 = DType("complex128", torch.complex128)
float8_e4m3fn = DType("float8_e4m3fn", torch.float8_e4m3fn)
float8_e5m2 = DType("float8_e5m2", torch.float8_e5m2)

_ALL = [float32, float64, float16, bfloat16, int8, int16, int32, int64,
        uint8, uint16, uint32, uint64, bool_, complex64, complex128,
        float8_e4m3fn, float8_e5m2]
_NO_NUMPY = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)
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
