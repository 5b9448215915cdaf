"""Activation layers (port of ``paddle_tpu/nn/layer/activation.py``).

Thin modules over :mod:`paddle_tpu_torch.nn.functional`, for API parity
and container composition; only ``PReLU`` holds a parameter (and so
takes ``device`` and ``dtype``).
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.dtype import convert_dtype
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.param_attr import create_parameter
from paddle_tpu_torch.nn.layer_base import Layer

__all__ = [
    "CELU", "ELU", "GELU", "GLU", "Hardshrink", "Hardsigmoid", "Hardswish",
    "Hardtanh", "LeakyReLU", "LogSigmoid", "LogSoftmax", "Maxout", "Mish",
    "PReLU", "ReLU", "ReLU6", "RReLU", "SELU", "Sigmoid", "Silu", "Softmax",
    "Softplus", "Softshrink", "Softsign", "Swish", "Tanh", "Tanhshrink",
    "ThresholdedReLU",
]


class ReLU(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class ReLU6(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu6(x)


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self._approximate = approximate

    def forward(self, x):
        return F.gelu(x, approximate=self._approximate)

    def extra_repr(self):
        return f"approximate={self._approximate}"


class Sigmoid(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.sigmoid(x)


class Tanh(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.tanh(x)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.softmax(x, axis=self._axis)

    def extra_repr(self):
        return f"axis={self._axis}"


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.log_softmax(x, axis=self._axis)


class LogSigmoid(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.log_sigmoid(x)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self._negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self._negative_slope)

    def extra_repr(self):
        return f"negative_slope={self._negative_slope}"


class ELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return F.elu(x, self._alpha)


class SELU(Layer):
    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772,
                 name=None):
        super().__init__()
        self._scale = scale
        self._alpha = alpha

    def forward(self, x):
        return F.selu(x, self._scale, self._alpha)


class CELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return F.celu(x, self._alpha)


class GLU(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.glu(x, self._axis)


class Hardshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.hardshrink(x, self._threshold)


class Hardsigmoid(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.hardsigmoid(x)


class Hardswish(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.hardswish(x)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0, name=None):
        super().__init__()
        self._min, self._max = min, max

    def forward(self, x):
        return F.hardtanh(x, self._min, self._max)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self._groups, self._axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self._groups, self._axis)


class Mish(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.mish(x)


class PReLU(Layer):
    """Learnable leaky slope: a parameter of shape ``[num_parameters]``
    (one for all channels, or one per channel of axis 1)."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._data_format = data_format
        self.weight = create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init),
            device=resolve_device(device), dtype=convert_dtype(dtype))

    def forward(self, x):
        return F.prelu(x, self.weight)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8, upper=1.0 / 3, name=None):
        super().__init__()
        self._lower, self._upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self._lower, self._upper, training=self.training)


class Silu(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.silu(x)


class Softplus(Layer):
    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__()
        self._beta, self._threshold = beta, threshold

    def forward(self, x):
        return F.softplus(x, self._beta, self._threshold)


class Softshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.softshrink(x, self._threshold)


class Softsign(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.softsign(x)


class Swish(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.swish(x)


class Tanhshrink(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.tanhshrink(x)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.thresholded_relu(x, self._threshold)
