"""Momentum SGD — port of ``paddle_tpu/optimizer/momentum.py``."""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["Momentum"]


class Momentum(Optimizer):
    """velocity = mu * velocity + grad;
    param -= lr * (grad + mu * velocity) if nesterov else lr * velocity.
    """

    _group_opts = ("momentum",)
    _fusable_update = True  # elementwise: safe over concatenated buffers

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = float(momentum)
        self._use_nesterov = use_nesterov

    def _create_state(self, p):
        dt = torch.float32 if self._needs_master(p) else p.dtype
        return {"velocity": torch.zeros(p.shape, dtype=dt, device=p.device)}

    def _update_delta(self, grad, state, lr, momentum=0.9):
        v = state["velocity"].mul_(momentum).add_(grad)
        if self._use_nesterov:
            return lr * (grad + momentum * v)
        return lr * v
