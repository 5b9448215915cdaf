"""Weight-decay regularizers — port of ``paddle_tpu/regularizer.py``
(``L1Decay``, ``L2Decay``): functions the optimizer folds into the
gradient before its rule runs."""
from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, param, grad):
        raise NotImplementedError


class L1Decay(WeightDecayRegularizer):
    """grad += coeff * sign(param) (a new tensor; nothing is updated in
    place)."""

    def __call__(self, param, grad):
        return grad + self.coeff * torch.sign(param).to(grad.dtype)

    def __repr__(self):
        return f"L1Decay({self.coeff})"


class L2Decay(WeightDecayRegularizer):
    """grad += coeff * param (a new tensor; nothing is updated in place)."""

    def __call__(self, param, grad):
        return grad + self.coeff * param.to(grad.dtype)

    def __repr__(self):
        return f"L2Decay({self.coeff})"
