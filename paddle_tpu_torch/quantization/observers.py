"""PTQ observers — port of ``paddle_tpu/quantization/observers.py``
(reference: ``python/paddle/quantization/observers/abs_max.py``
AbsmaxObserver — an identity forward that records the running abs-max
for calibration — and the per-channel weight observer)."""
from __future__ import annotations

import torch

from .base import BaseObserver, bcast_shape
from .factory import QuanterFactory

__all__ = ["AbsmaxObserver", "AbsmaxObserverLayer",
           "PerChannelAbsmaxObserver", "PerChannelAbsmaxObserverLayer"]


class AbsmaxObserverLayer(BaseObserver):
    def __init__(self, quant_bits: int = 8):
        super().__init__()
        self._quant_bits = int(quant_bits)
        self.register_buffer("_scale", torch.zeros((), dtype=torch.float32))

    def forward(self, x):
        cur = float(x.detach().abs().max()) if x.numel() else 0.0
        if cur > float(self._scale):
            self._scale.fill_(cur)
        return x

    def scales(self):
        return self._scale

    def bit_length(self):
        return self._quant_bits


AbsmaxObserver = QuanterFactory(AbsmaxObserverLayer)


class PerChannelAbsmaxObserverLayer(BaseObserver):
    """Per-channel weight observer (reference:
    ``python/paddle/quantization/imperative/ptq_quantizer.py:137``
    PerChannelAbsmaxQuantizer, the reference's default PTQ weight
    quantizer): one abs-max scale per output channel.

    The channel axis follows the wrapped layer's weight layout: Conv
    weights are OIHW, so axis 0; Linear weights are [in, out], so the last
    axis. ``quant_axis=...`` overrides. Forward fake-quantizes through the
    per-channel grid with a straight-through gradient, so the class also
    serves as a QAT weight quanter; in eval mode the scales stay frozen."""

    _wants_layer = True

    def __init__(self, quant_bits: int = 8, quant_axis=None, layer=None):
        super().__init__()
        self._quant_bits = int(quant_bits)
        if quant_axis is None:
            from paddle_tpu_torch import nn
            if layer is not None and isinstance(
                    layer, (nn.Conv1D, nn.Conv2D, nn.Conv3D)):
                quant_axis = 0
            else:
                quant_axis = -1
        self._quant_axis = int(quant_axis)
        # a concrete zero buffer when the channel count is known (from the
        # wrapped layer's weight): a None buffer would vanish from
        # state_dict and break checkpoint round trips
        n_ch = 0
        if layer is not None and hasattr(layer, "weight"):
            wshape = tuple(layer.weight.shape)
            n_ch = int(wshape[self._quant_axis % len(wshape)])
        self.register_buffer(
            "_scale", torch.zeros(n_ch, dtype=torch.float32)
            if n_ch else None)

    def forward(self, x):
        from .quanters import fake_quant_ste
        axis = self._quant_axis % x.dim()
        if self.training and x.numel():
            reduce_axes = tuple(i for i in range(x.dim()) if i != axis)
            cur = x.detach().abs()
            cur = cur.amax(dim=reduce_axes) if reduce_axes else cur
            cur = cur.float()
            if self._scale is not None and \
                    self._scale.numel() == cur.numel():
                cur = torch.maximum(cur, self._scale.to(cur.device))
            elif self._scale is not None and self._scale.numel() and \
                    bool(self._scale.any()):
                raise ValueError(
                    f"per-channel observer saw {cur.numel()} channels "
                    f"after calibrating {self._scale.numel()} — the "
                    "observed tensor's channel axis changed")
            # else: the zeros buffer was sized from the layer's WEIGHT;
            # observing an activation instead adopts its channel count
            self._scale = cur
        if self._scale is None or not bool(self._scale.any()):
            return x  # uncalibrated: identity (as the scalar observer)
        bcast = self._scale.reshape(bcast_shape(x.dim(), axis))
        return fake_quant_ste(x, bcast, self._quant_bits)

    def scales(self):
        return self._scale

    def quant_axis(self):
        return self._quant_axis

    def bit_length(self):
        return self._quant_bits


PerChannelAbsmaxObserver = QuanterFactory(PerChannelAbsmaxObserverLayer)
