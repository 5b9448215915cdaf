"""Fake quanters — port of ``paddle_tpu/quantization/quanters.py``
(reference: ``python/paddle/quantization/quanters/abs_max.py``
FakeQuanterWithAbsMaxObserver — moving-average abs-max scale, simulated
int-k round trip with a straight-through gradient). Plain PyTorch: the
reference needs no custom kernel for it, and neither does the port."""
from __future__ import annotations

import torch

from .base import BaseQuanter
from .factory import QuanterFactory

__all__ = ["FakeQuanterWithAbsMaxObserver",
           "FakeQuanterWithAbsMaxObserverLayer", "fake_quant_ste"]


def fake_quant_ste(x, scale, bits):
    """round(clip(x/s)) * s with the straight-through estimator: the
    backward is the identity (``x + (q - x).detach()``, the reference's
    ``x + stop_gradient(q - x)``). ``scale`` is a float or a tensor that
    broadcasts against ``x``."""
    bound = float(2 ** (bits - 1) - 1)
    if isinstance(scale, torch.Tensor):
        s = torch.clamp(scale.to(x.device, torch.float32), min=1e-9)
    else:
        s = max(float(scale), 1e-9)
    q = torch.clamp(torch.round(x / s * bound), -bound, bound) * s / bound
    return x + (q - x).detach()


class FakeQuanterWithAbsMaxObserverLayer(BaseQuanter):
    """QAT activation/weight quanter: tracks a moving-average abs-max and
    fake-quantizes through it. The scale and its state are 0-d f32
    buffers; the moving average is kept on the host, as the reference
    keeps it."""

    def __init__(self, moving_rate: float = 0.9, bit_length: int = 8,
                 dtype: str = "float32", name=None, quant_on_weight=False):
        super().__init__()
        self._moving_rate = float(moving_rate)
        self._quant_bits = int(bit_length)
        self.register_buffer("_scale", torch.zeros((), dtype=torch.float32))
        self.register_buffer("_state", torch.zeros((), dtype=torch.float32))

    def forward(self, x):
        if self.training:
            cur = float(x.detach().abs().max()) if x.numel() else 0.0
            state = float(self._state)
            scale = float(self._scale)
            r = self._moving_rate
            new_state = r * state + 1.0
            new_scale = (r * scale * state + cur) / new_state if state > 0 \
                else cur
            self._state.fill_(new_state)
            self._scale.fill_(new_scale)
        scale = float(self._scale)
        if scale <= 0:
            return x
        return fake_quant_ste(x, scale, self._quant_bits)

    def scales(self):
        return self._scale

    def bit_length(self):
        return self._quant_bits


# the public name is a factory, so config authors write
# FakeQuanterWithAbsMaxObserver(moving_rate=0.9) (the reference's @quanter)
FakeQuanterWithAbsMaxObserver = QuanterFactory(
    FakeQuanterWithAbsMaxObserverLayer)
