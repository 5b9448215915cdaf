"""Real int8 execution — port of ``paddle_tpu/quantization/int8.py``:
quantized compute, not simulation.

``convert_to_int8`` rewrites a converted QAT/PTQ model's quanted layers
into :class:`Int8Linear`/:class:`Int8Conv2D`: the weights are stored as
int8, activations quantize on entry with the calibrated scale, the
products accumulate s8 x s8 exactly in int32, and one f32 rescale
(s_x * s_w / bound^2) finishes the op, as the reference's XLA dot and
convolution with ``preferred_element_type=int32`` do.

On the card :class:`Int8Linear` runs ``torch._int_mm`` (an s8 x s8 ->
s32 product, as the reference's is an XLA dot outside Pallas) where its
shape rules allow it: more than 16 rows, and both the depth and the
width multiples of 8; the weight goes in column-major (cuBLASLt's int8
product takes that "TN" layout for every such shape, and refused a
row-major weight at 40 x 64 x 96 on the H100), a copy
:class:`Int8Linear` makes once per device. Every other shape, and the CPU, takes the exact
branch :func:`int8_matmul_exact`: the product in float64, which holds
every partial sum exactly (|sum| <= K * 127^2 < 2^53), rounded to int32.
:class:`Int8Conv2D` accumulates the same way, a float64 convolution
rounded to int32: a float32 convolution of int8 values would be exact
only while K * 127^2 < 2^24.
"""
from __future__ import annotations

import copy

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.nn import Layer

from .base import bcast_shape, channel_axis_of
from .wrapper import QuantedConv2D, QuantedLinear

__all__ = ["Int8Linear", "Int8Conv2D", "convert_to_int8", "quantize_arr",
           "int8_matmul", "int8_matmul_exact"]


def quantize_arr(x, scale, bits: int = 8, axis=None):
    """f32 tensor -> int8 tensor on the fake-quant grid: q = clip(round(x /
    s * bound), +-bound), dequant step s / bound. The expression
    associates exactly as ``quanters.fake_quant_ste`` (round(x / s *
    bound)): a pre-divided bound / s factor could flip round() by one
    step near .5. ``scale`` may be a per-channel vector along ``axis``."""
    bound = float(2 ** (bits - 1) - 1)
    s = torch.clamp(torch.as_tensor(np.asarray(scale, np.float32),
                                    device=x.device), min=1e-9)
    if axis is not None and s.dim() == 1:
        s = s.reshape(bcast_shape(x.dim(), axis))
    return torch.clamp(torch.round(x / s * bound), -bound,
                       bound).to(torch.int8)


def int8_matmul_exact(a, b):
    """``a @ b`` of two int8 matrices, exact, as int32: the product in
    float64 (every partial sum an integer below 2^53) rounded back."""
    return torch.round(torch.matmul(a.double(), b.double())).to(torch.int32)


def int8_matmul(a, b):
    """``a [M, K] @ b [K, N]`` of int8 matrices into int32: ``torch._int_mm``
    on the card where it takes the shape (M > 16, K and N multiples of
    8), else :func:`int8_matmul_exact`."""
    m, k = a.shape
    n = b.shape[1]
    if a.is_cuda and m > 16 and k % 8 == 0 and n % 8 == 0:
        if not b.t().is_contiguous():
            b = b.t().contiguous().t()  # column-major: the TN layout
        return torch._int_mm(a.contiguous(), b)
    return int8_matmul_exact(a, b)


class _Int8Base(Layer):
    def __init__(self, w_q, w_scale, x_scale: float, bias,
                 x_bits: int = 8, w_bits: int = 8, w_axis=None):
        """``w_scale`` is a scalar (per-tensor) or a 1-D per-output-channel
        vector with ``w_axis`` naming the weight's channel axis;
        activation scales are always per-tensor."""
        super().__init__()
        w_scale = np.asarray(w_scale, np.float32)
        # per-channel: a single zero scale is a pruned (all-zero) channel,
        # clamped like fake_quant_ste does; only a set of scales with no
        # positive one means calibration never ran
        if x_scale <= 0 or not (w_scale > 0).any():
            raise ValueError(
                "int8 conversion needs calibrated positive scales; run "
                "PTQ calibration (or QAT) before convert_to_int8")
        w_scale = np.maximum(w_scale, 1e-9)
        # separate activation/weight bit widths: a 4-bit weight grid still
        # STORES as int8 (values in [-7, 7]) but dequantizes with its own
        # bound, as the fake-quant simulation does
        self.x_bits = int(x_bits)
        self.w_bits = int(w_bits)
        self._x_bound = float(2 ** (x_bits - 1) - 1)
        self._w_bound = float(2 ** (w_bits - 1) - 1)
        self.w_scale = float(w_scale) if w_scale.ndim == 0 else w_scale
        self.w_axis = None if w_axis is None else int(w_axis)
        self.x_scale = float(x_scale)
        # the int8 weights are a BUFFER: a frozen deployment artifact
        self.register_buffer("w_q", w_q.to(torch.int8))
        self.register_buffer(
            "bias", None if bias is None else bias.detach().clone())

    def _quant_in(self, x):
        return quantize_arr(x, self.x_scale, self.x_bits)

    @property
    def _rescale(self):
        """Scalar, or a per-output-channel vector the forward broadcasts
        along the output's channel axis."""
        return (self.x_scale / self._x_bound) * \
            (self.w_scale / self._w_bound)

    def _rescale_on(self, device, shape=None):
        rs = self._rescale
        if np.ndim(rs) == 0:
            return rs
        rs = torch.as_tensor(np.asarray(rs, np.float32), device=device)
        return rs if shape is None else rs.reshape(shape)


class Int8Linear(_Int8Base):
    """y = dequant(s8(x) @ s8(w) -> s32) + bias, one f32 rescale
    (per-channel: the rescale vector broadcasts over the output axis)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.w_axis is not None and self.w_axis not in (1, -1):
            raise ValueError(
                "Int8Linear per-channel scales must be along the OUTPUT "
                f"axis of the [in, out] weight (axis 1), got {self.w_axis}")

    def _weight_for(self, device):
        """``w_q``, column-major on the card (made once per device and
        storage; in a traced program, on each run)."""
        w = self.w_q
        if device.type != "cuda":
            return w
        if is_fake(w):  # a traced program (``jit.save``): one of its ops
            return w.t().contiguous().t()
        key = (w.device, w.data_ptr())
        cached = self.__dict__.get("_w_cm")
        if cached is None or cached[0] != key:
            cached = (key, w.t().contiguous().t())
            self.__dict__["_w_cm"] = cached
        return cached[1]

    def forward(self, x):
        xq = self._quant_in(x)
        acc = int8_matmul(xq.reshape(-1, xq.shape[-1]),
                          self._weight_for(x.device))
        y = acc.reshape(*x.shape[:-1], -1).float() * \
            self._rescale_on(x.device)
        if self.bias is not None:
            y = y + self.bias
        return y.to(x.dtype)


class Int8Conv2D(_Int8Base):
    """int8 convolution with an exact int32 accumulation (module
    docstring); weights stay in Paddle's OIHW layout, the data layout
    follows the source layer."""

    def __init__(self, w_q, w_scale, x_scale, bias, stride, padding,
                 dilation, groups, data_format: str = "NCHW",
                 x_bits: int = 8, w_bits: int = 8, w_axis=None):
        super().__init__(w_q, w_scale, x_scale, bias, x_bits, w_bits,
                         w_axis)
        if self.w_axis is not None and self.w_axis not in (0, -4):
            raise ValueError(
                "Int8Conv2D per-channel scales must be along the OUTPUT "
                f"axis of the OIHW weight (axis 0), got {self.w_axis}")
        if data_format not in ("NCHW", "NHWC"):
            raise ValueError(f"unsupported data_format {data_format!r}")
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = int(groups)
        self.data_format = data_format

    def forward(self, x):
        xq = self._quant_in(x)
        acc = torch.round(F.conv2d(
            xq.double(), self.w_q.double(), None, self.stride, self.padding,
            self.dilation, self.groups, self.data_format)).to(torch.int32)
        shape = (1, -1, 1, 1) if self.data_format == "NCHW" \
            else (1, 1, 1, -1)
        y = acc.float() * self._rescale_on(x.device, shape)
        if self.bias is not None:
            y = y + self.bias.reshape(shape)
        return y.to(x.dtype)


def _scales_of(quanted) -> tuple:
    aq, wq = quanted.activation_quanter, quanted.weight_quanter
    if aq is None or wq is None:
        raise ValueError(
            "convert_to_int8 needs BOTH activation and weight quanters "
            "(calibrated PTQ.convert / QAT.convert output)")
    a_s = aq.scales().detach().cpu().numpy().astype(np.float32)
    if a_s.size != 1:
        raise ValueError(
            "convert_to_int8 supports per-tensor ACTIVATION quanters "
            f"only (got {a_s.size} activation scales); per-channel "
            "quantization applies to weights")
    w_s = wq.scales().detach().cpu().numpy().astype(np.float32)
    w_axis = channel_axis_of(wq, "weight quanter") if w_s.ndim else None
    return (float(a_s.reshape(())), w_s if w_s.ndim else float(w_s),
            aq.bit_length(), wq.bit_length(), w_axis)


def convert_to_int8(model: Layer, inplace: bool = False) -> Layer:
    """Rewrite a converted QAT/PTQ model for real int8 execution: every
    :class:`QuantedLinear`/:class:`QuantedConv2D` becomes
    :class:`Int8Linear`/:class:`Int8Conv2D` with pre-quantized int8
    weights and the calibrated activation scale frozen in."""
    if not inplace:
        model = copy.deepcopy(model)
    _walk(model)
    model.eval()
    return model


@torch.no_grad()
def _walk(model: Layer):
    for name, child in list(model._modules.items()):
        if isinstance(child, QuantedLinear):
            s_x, s_w, x_bits, w_bits, w_axis = _scales_of(child)
            w_q = quantize_arr(child.weight, s_w, w_bits, w_axis)
            model._modules[name] = Int8Linear(
                w_q, s_w, s_x, child.bias, x_bits, w_bits, w_axis)
        elif isinstance(child, QuantedConv2D):
            s_x, s_w, x_bits, w_bits, w_axis = _scales_of(child)
            lyr = child._layer
            w_q = quantize_arr(child.weight, s_w, w_bits, w_axis)
            model._modules[name] = Int8Conv2D(
                w_q, s_w, s_x, child.bias, lyr._stride, lyr._padding,
                lyr._dilation, lyr._groups,
                getattr(lyr, "_data_format", "NCHW"),
                x_bits, w_bits, w_axis)
        else:
            _walk(child)
