"""Adadelta — port of ``paddle_tpu/optimizer/adadelta.py`` (the rule
applies no learning rate, as the original paper and the reference)."""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["Adadelta"]


class Adadelta(Optimizer):
    """asg = rho * asg + (1 - rho) * g^2
    update = -sqrt((asu + eps) / (asg + eps)) * g
    asu = rho * asu + (1 - rho) * update^2
    param += update
    """

    _group_opts = ("rho", "epsilon")
    _fusable_update = True  # elementwise: safe over concatenated buffers

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._rho = float(rho)
        self._epsilon = float(epsilon)

    def _create_state(self, p):
        dt = torch.float32 if self._needs_master(p) else p.dtype
        return {n: torch.zeros(p.shape, dtype=dt, device=p.device)
                for n in ("avg_squared_grad", "avg_squared_update")}

    def _update_delta(self, grad, state, lr, rho=0.95, epsilon=1e-6):
        asg = state["avg_squared_grad"].mul_(rho).add_(
            (1 - rho) * grad * grad)
        asu = state["avg_squared_update"]
        update = -torch.sqrt((asu + epsilon) / (asg + epsilon)) * grad
        asu.mul_(rho).add_((1 - rho) * update * update)
        return -update
