"""Weight-decay regularizers — port of ``paddle_tpu/regularizer.py``
(``L2Decay``; ``L1Decay`` is not ported yet)."""
from __future__ import annotations

__all__ = ["L2Decay"]


class WeightDecayRegularizer:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, param, grad):
        raise NotImplementedError


class L2Decay(WeightDecayRegularizer):
    """grad += coeff * param (a new tensor; nothing is updated in place)."""

    def __call__(self, param, grad):
        return grad + self.coeff * param.to(grad.dtype)

    def __repr__(self):
        return f"L2Decay({self.coeff})"
