"""Adagrad — port of ``paddle_tpu/optimizer/adagrad.py``."""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["Adagrad"]


class Adagrad(Optimizer):
    """moment += grad^2; param -= lr * grad / (sqrt(moment) + eps)."""

    _group_opts = ("epsilon",)
    _fusable_update = True  # elementwise: safe over concatenated buffers

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._epsilon = float(epsilon)
        self._initial_accumulator_value = float(initial_accumulator_value)

    def _create_state(self, p):
        dt = torch.float32 if self._needs_master(p) else p.dtype
        return {"moment": torch.full(p.shape, self._initial_accumulator_value,
                                     dtype=dt, device=p.device)}

    def _update_delta(self, grad, state, lr, epsilon=1e-6):
        moment = state["moment"].add_(grad * grad)
        return lr * grad / (torch.sqrt(moment) + epsilon)
