"""Pooling layers (port of ``paddle_tpu/nn/layer/pooling.py``): the max
and average pools, the adaptive pools and ``MaxUnPool2D``, each one call
of :mod:`paddle_tpu_torch.nn.functional`. They hold no parameters."""
from __future__ import annotations

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer_base import Layer

__all__ = ["MaxUnPool2D",
           "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D"]


def _no_mask(return_mask):
    if return_mask:
        raise NotImplementedError(
            "return_mask=True (argmax indices) is not implemented")


class _PoolNd(Layer):
    _nd = 2
    _mode = "max"
    _default_fmt = "NCHW"

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, data_format=None, return_mask=False,
                 name=None):
        super().__init__()
        _no_mask(return_mask)
        self._kernel_size = kernel_size
        self._stride = stride
        self._padding = padding
        self._ceil_mode = ceil_mode
        self._exclusive = exclusive
        self._data_format = data_format or self._default_fmt

    def forward(self, x):
        return F._pool_nd(x, self._kernel_size, self._stride, self._padding,
                          self._nd, self._mode, self._data_format,
                          self._ceil_mode, self._exclusive)

    def extra_repr(self):
        return (f"kernel_size={self._kernel_size}, stride={self._stride}, "
                f"padding={self._padding}")


class MaxPool1D(_PoolNd):
    _nd, _default_fmt = 1, "NCL"


class MaxPool2D(_PoolNd):
    pass


class MaxPool3D(_PoolNd):
    _nd, _default_fmt = 3, "NCDHW"


class AvgPool1D(_PoolNd):
    _nd, _mode, _default_fmt = 1, "avg", "NCL"


class AvgPool2D(_PoolNd):
    _mode = "avg"


class AvgPool3D(_PoolNd):
    _nd, _mode, _default_fmt = 3, "avg", "NCDHW"


class _AdaptivePoolNd(Layer):
    _nd = 2
    _mode = "avg"
    _default_fmt = "NCHW"

    def __init__(self, output_size, return_mask=False, data_format=None,
                 name=None):
        super().__init__()
        _no_mask(return_mask)
        self._output_size = output_size
        self._data_format = data_format or self._default_fmt

    def forward(self, x):
        return F._adaptive_pool(x, self._output_size, self._nd, self._mode,
                                self._data_format)

    def extra_repr(self):
        return f"output_size={self._output_size}"


class AdaptiveAvgPool1D(_AdaptivePoolNd):
    _nd, _default_fmt = 1, "NCL"


class AdaptiveAvgPool2D(_AdaptivePoolNd):
    pass


class AdaptiveAvgPool3D(_AdaptivePoolNd):
    _nd, _default_fmt = 3, "NCDHW"


class AdaptiveMaxPool1D(_AdaptivePoolNd):
    _nd, _mode, _default_fmt = 1, "max", "NCL"


class AdaptiveMaxPool2D(_AdaptivePoolNd):
    _mode = "max"


class AdaptiveMaxPool3D(_AdaptivePoolNd):
    _nd, _mode, _default_fmt = 3, "max", "NCDHW"


class MaxUnPool2D(Layer):
    """The inverse of ``max_pool2d_with_index``: pooled values back at
    their recorded positions, zeros elsewhere."""

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
        super().__init__()
        self._kernel_size = kernel_size
        self._stride = stride
        self._padding = padding
        self._data_format = data_format
        self._output_size = output_size

    def forward(self, x, indices):
        return F.max_unpool2d(x, indices, self._kernel_size, self._stride,
                              self._padding, self._output_size,
                              self._data_format)
