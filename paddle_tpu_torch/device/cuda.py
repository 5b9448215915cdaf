"""``paddle.device.cuda`` — port of ``paddle_tpu/device/cuda.py``.

Where the reference's build has no CUDA and reports zero devices (its
``Stream`` and ``Event`` do nothing), the port runs on CUDA: each
function is PyTorch's ``torch.cuda`` counterpart, and ``Stream`` and
``Event`` are ``torch.cuda.Stream``/``Event`` with the reference's names
and signatures (Paddle's stream priority 1 is high, 2 normal). Asking
for a stream or an event without a card raises ``RuntimeError``.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["device_count", "current_stream", "synchronize", "Stream",
           "Event", "stream_guard", "get_device_properties",
           "max_memory_allocated", "max_memory_reserved",
           "memory_allocated", "memory_reserved", "empty_cache"]


def _need_card(what: str):
    if not torch.cuda.is_available():
        raise RuntimeError(f"paddle.device.cuda.{what} needs a CUDA card, "
                           f"and PyTorch sees none here")


class Stream(torch.cuda.Stream):
    """A CUDA stream (reference ``Stream(device=None, priority=2)``)."""

    def __new__(cls, device=None, priority=2, **kwargs):
        _need_card("Stream")
        return super().__new__(cls, device=_index(device),
                               priority=-1 if priority == 1 else 0,
                               **kwargs)

    def record_event(self, event=None):
        """Record ``event`` (a new :class:`Event` if None) on this
        stream and return it."""
        event = event if event is not None else Event()
        event.record(self)
        return event


class Event(torch.cuda.Event):
    """A CUDA event (reference ``Event(enable_timing=False,
    blocking=False, interprocess=False)``)."""

    def __new__(cls, enable_timing=False, blocking=False,
                interprocess=False):
        _need_card("Event")
        return super().__new__(cls, enable_timing=enable_timing,
                               blocking=blocking, interprocess=interprocess)


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
    _need_card("current_stream")
    return torch.cuda.current_stream(_index(device))


@contextlib.contextmanager
def stream_guard(stream):
    """Make ``stream`` current inside the block."""
    _need_card("stream_guard")
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
