"""Quanter/observer base classes — port of
``paddle_tpu/quantization/base.py`` (reference:
``python/paddle/quantization/base_quanter.py``, ``base_observer.py``)."""
from __future__ import annotations

import abc

from paddle_tpu_torch.nn import Layer

__all__ = ["BaseQuanter", "BaseObserver", "bcast_shape", "channel_axis_of"]


def bcast_shape(ndim: int, axis: int) -> list:
    """Broadcast shape for a per-channel scale vector along ``axis`` of an
    ``ndim``-d tensor — the one definition shared by the fake-quant
    simulation, the observers and the int8 execution path."""
    shape = [1] * ndim
    shape[axis % ndim] = -1
    return shape


def channel_axis_of(quanter, what: str = "quanter") -> int:
    """The channel axis of a quanter with 1-D scales; raises when the
    quanter returns a vector but never declared its axis."""
    axis = quanter.quant_axis()
    if axis is None:
        raise ValueError(
            f"{what} returned per-channel (1-D) scales but its "
            "quant_axis() is None — override quant_axis() to name the "
            "channel axis of the weight")
    return int(axis)


class BaseQuanter(Layer, metaclass=abc.ABCMeta):
    """A Layer that simulates quantization in forward; exposes the learned
    scale/zero-point so ``convert`` can bake real quantized weights."""

    @abc.abstractmethod
    def scales(self):
        ...

    def zero_points(self):
        return None

    def quant_axis(self):
        return None

    def bit_length(self):
        return getattr(self, "_quant_bits", 8)


class BaseObserver(BaseQuanter, metaclass=abc.ABCMeta):
    """PTQ observer: watches activations during calibration (forward is
    identity), then reports scales."""
