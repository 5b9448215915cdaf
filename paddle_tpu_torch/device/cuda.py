"""``paddle.device.cuda`` — port of ``paddle_tpu/device/cuda.py``.

Where the reference's build has no CUDA and reports zero devices, the
port runs on CUDA: each function is PyTorch's ``torch.cuda`` counterpart,
and ``Stream``/``Event`` are PyTorch's.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["device_count", "current_stream", "synchronize", "Stream",
           "Event", "stream_guard", "get_device_properties",
           "max_memory_allocated", "max_memory_reserved",
           "memory_allocated", "memory_reserved", "empty_cache"]

Stream = torch.cuda.Stream
Event = torch.cuda.Event


def _index(device):
    """Paddle's ``"gpu:1"``, an index or None (the current card)."""
    if device is None:
        return None
    if isinstance(device, int):
        return device
    from . import _torch_device
    return _torch_device(device).index


def device_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def synchronize(device=None):
    torch.cuda.synchronize(_index(device))


def current_stream(device=None):
    return torch.cuda.current_stream(_index(device))


@contextlib.contextmanager
def stream_guard(stream):
    with torch.cuda.stream(stream):
        yield stream


def get_device_properties(device=None):
    return torch.cuda.get_device_properties(
        _index(device) if device is not None else
        torch.cuda.current_device())


def memory_allocated(device=None) -> int:
    return torch.cuda.memory_allocated(_index(device))


def memory_reserved(device=None) -> int:
    return torch.cuda.memory_reserved(_index(device))


def max_memory_allocated(device=None) -> int:
    return torch.cuda.max_memory_allocated(_index(device))


def max_memory_reserved(device=None) -> int:
    return torch.cuda.max_memory_reserved(_index(device))


def empty_cache():
    torch.cuda.empty_cache()
