"""RMSProp — port of ``paddle_tpu/optimizer/rmsprop.py``."""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["RMSProp"]


class RMSProp(Optimizer):
    """Uncentered::

        ms = rho * ms + (1 - rho) * g^2
        mom = momentum * mom + lr * g / sqrt(ms + eps)
        param -= mom

    Centered replaces the denominator with ``sqrt(ms - mg^2 + eps)`` where
    ``mg = rho * mg + (1 - rho) * g``.
    """

    _group_opts = ("rho", "epsilon", "momentum")
    _fusable_update = True  # elementwise: safe over concatenated buffers

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._rho = float(rho)
        self._epsilon = float(epsilon)
        self._momentum = float(momentum)
        self._centered = centered

    def _create_state(self, p):
        dt = torch.float32 if self._needs_master(p) else p.dtype
        names = ("mean_square", "momentum_acc") + \
            (("mean_grad",) if self._centered else ())
        return {n: torch.zeros(p.shape, dtype=dt, device=p.device)
                for n in names}

    def _update_delta(self, grad, state, lr, rho=0.95, epsilon=1e-6,
                      momentum=0.0):
        ms = state["mean_square"].mul_(rho).add_((1 - rho) * grad * grad)
        if self._centered:
            mg = state["mean_grad"].mul_(rho).add_((1 - rho) * grad)
            denom = ms - mg * mg + epsilon
        else:
            denom = ms + epsilon
        return state["momentum_acc"].mul_(momentum).add_(
            lr * grad / torch.sqrt(denom))
