"""TensorArray and the array ops — port of ``paddle_tpu/ops/array.py``
(``create_array`` / ``array_write`` / ``array_read`` / ``array_length``).

The dygraph form: a Python list of tensors with the reference's dtype
tag.
"""
from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.core.tensor import to_tensor, wrap

__all__ = ["TensorArray", "create_array", "array_write", "array_read",
           "array_length"]


class TensorArray(list):
    """A list of tensors with the reference's dtype tag."""

    def __init__(self, dtype: str = "float32"):
        super().__init__()
        self.dtype = dtype


def create_array(dtype: str = "float32", initialized_list=None):
    arr = TensorArray(dtype)
    for t in initialized_list or ():
        arr.append(wrap(t) if isinstance(t, torch.Tensor) else to_tensor(t))
    return arr


def _index(i) -> int:
    return int(i.item()) if isinstance(i, torch.Tensor) else int(i)


def array_write(x, i, array: Optional[TensorArray] = None):
    """Write ``x`` at position ``i`` (extends the array if i == len)."""
    if array is None:
        array = create_array()
    idx = _index(i)
    if idx < len(array):
        array[idx] = x
    elif idx == len(array):
        array.append(x)
    else:
        raise IndexError(
            f"array_write index {idx} beyond array length {len(array)}")
    return array


def array_read(array: TensorArray, i):
    return array[_index(i)]


def array_length(array: TensorArray):
    return to_tensor(len(array), dtype="int64")
