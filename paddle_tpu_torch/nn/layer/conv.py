"""Convolution layers (port of ``paddle_tpu/nn/layer/conv.py``).

The weight layout is Paddle's ``[out_channels, in_channels/groups,
*kernel]`` (transposed: ``[in_channels, out_channels/groups, *kernel]``),
which is PyTorch's, so no transposes are needed; the functional form
runs ``torch.nn.functional.conv*`` (cuDNN on the card), as the reference
runs ``lax.conv_general_dilated`` outside any Pallas kernel. Layers take
``device`` (``None`` is the card) and ``dtype``.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.dtype import convert_dtype
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.param_attr import ParamAttr, create_parameter
from paddle_tpu_torch.nn.layer_base import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose"]


def _ntuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return (v,) * n


class _ConvNd(Layer):
    _nd = 2
    _transpose = False

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format=None,
                 output_padding=0, *, device=None, dtype=torch.float32):
        super().__init__()
        nd = self._nd
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, nd)
        self._stride = _ntuple(stride, nd)
        self._padding = padding
        self._dilation = _ntuple(dilation, nd)
        self._groups = groups
        self._padding_mode = padding_mode
        self._output_padding = output_padding
        self._data_format = data_format or \
            {1: "NCL", 2: "NCHW", 3: "NCDHW"}[nd]

        if self._transpose:
            w_shape = [in_channels, out_channels // groups,
                       *self._kernel_size]
        else:
            w_shape = [out_channels, in_channels // groups,
                       *self._kernel_size]
        # the reference's default: Normal(0, sqrt(2 / fan_in))
        fan_in = in_channels // groups * int(np.prod(self._kernel_size))
        kw = dict(device=resolve_device(device), dtype=convert_dtype(dtype))
        self.weight = create_parameter(
            w_shape, attr=weight_attr,
            default_initializer=I.Normal(0.0, np.sqrt(2.0 / max(fan_in, 1))),
            **kw)
        self.bias = None if ParamAttr._to_attr(bias_attr) is False else \
            create_parameter([out_channels], attr=bias_attr, is_bias=True,
                             **kw)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}, "
                f"padding={self._padding}")


class Conv1D(_ConvNd):
    _nd = 1

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv2D(_ConvNd):
    _nd = 2

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv3D(_ConvNd):
    _nd = 3

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class _ConvTransposeNd(_ConvNd):
    _transpose = True

    def _pad_pairs(self):
        """Normalize padding to per-dim (lo, hi) pairs for output-size math.
        Handles int, per-dim ints, paddle's flat [lo0, hi0, lo1, hi1, ...]
        and nested pair forms; string modes have no closed-form default."""
        nd = self._nd
        p = self._padding
        if isinstance(p, str):
            raise NotImplementedError(
                f"output_size with padding={p!r} (string mode) is not "
                "supported; pass explicit integer padding")
        if isinstance(p, int):
            return [(p, p)] * nd
        p = list(p)
        if len(p) == nd and all(isinstance(v, int) for v in p):
            return [(v, v) for v in p]
        if len(p) == 2 * nd and all(isinstance(v, int) for v in p):
            return [(p[2 * i], p[2 * i + 1]) for i in range(nd)]
        if len(p) == nd:  # nested [[lo, hi], ...]
            return [tuple(v) for v in p]
        raise ValueError(f"cannot interpret padding {self._padding!r}")

    def _out_padding(self, x, output_size):
        """Derive output_padding from a requested output_size (paddle
        semantics: output_size must lie in [default, default + stride))."""
        if output_size is None:
            return self._output_padding
        nd = self._nd
        if isinstance(output_size, int):
            output_size = [output_size] * nd
        channel_last = self._data_format.endswith("C")
        spatial0 = 1 if channel_last else 2
        pairs = self._pad_pairs()
        out_pad = []
        for i in range(nd):
            in_sz = x.shape[spatial0 + i]
            lo, hi = pairs[i]
            default = (in_sz - 1) * self._stride[i] - (lo + hi) + \
                self._dilation[i] * (self._kernel_size[i] - 1) + 1
            extra = int(output_size[i]) - default
            if not 0 <= extra < self._stride[i]:
                raise ValueError(
                    f"output_size[{i}]={output_size[i]} out of the valid "
                    f"range [{default}, {default + self._stride[i]})")
            out_pad.append(extra)
        return out_pad

    def forward(self, x, output_size=None):
        fn = {1: F.conv1d_transpose, 2: F.conv2d_transpose,
              3: F.conv3d_transpose}[self._nd]
        return fn(x, self.weight, self.bias, self._stride, self._padding,
                  self._out_padding(x, output_size), self._dilation,
                  self._groups, self._data_format)


class Conv1DTranspose(_ConvTransposeNd):
    _nd = 1


class Conv2DTranspose(_ConvTransposeNd):
    _nd = 2


class Conv3DTranspose(_ConvTransposeNd):
    _nd = 3
