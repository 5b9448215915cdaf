"""SGD — port of ``paddle_tpu/optimizer/sgd.py``."""
from __future__ import annotations

from .optimizer import Optimizer

__all__ = ["SGD"]


class SGD(Optimizer):
    """param = param - lr * grad."""

    _fusable_update = True  # elementwise: safe over concatenated buffers

    def _update_delta(self, grad, state, lr):
        return lr * grad
