"""Shared helpers of the op library (port of ``paddle_tpu/ops/_common.py``)."""
from __future__ import annotations

import numpy as np
import torch

# the reference stores "int64" in 32 bits with x64 off; PyTorch keeps
# int64, so integer results here are int64 (ROADMAP §3)
LONG = torch.int64


def device():
    """The device creation ops place their results on (``set_device``)."""
    from paddle_tpu_torch.device import resolve_device
    return resolve_device(None)


def as_t(x, like=None):
    """A Python scalar, list or numpy array -> a tensor on ``like``'s
    device (0-d for a scalar, so it promotes as a scalar does); a tensor
    as it is."""
    if isinstance(x, torch.Tensor):
        return x
    dev = like.device if isinstance(like, torch.Tensor) else None
    if isinstance(x, np.ndarray) and x.dtype == np.float64:
        x = x.astype(np.float32)
    return torch.as_tensor(x, device=dev)


def pair(x, y):
    """Two operands as tensors on one device."""
    if not isinstance(x, torch.Tensor):
        x = as_t(x, y)
    if not isinstance(y, torch.Tensor):
        y = as_t(y, x)
    return x, y


def dims(axis):
    """Paddle's ``axis`` (None, an int, a list) -> torch's ``dim``."""
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def all_dims(x, axis) -> tuple:
    """``dims(axis)`` as a tuple, with None meaning every dimension."""
    d = dims(axis)
    if d is None:
        return tuple(range(x.ndim))
    return d if isinstance(d, tuple) else (d,)


def floatify(x):
    """Integer and bool tensors in the default float dtype (as jnp's
    mean/var promote them); floating ones as they are."""
    if x.is_floating_point() or x.is_complex():
        return x
    from paddle_tpu_torch.core.dtype import default_float
    return x.to(default_float())
