"""Adamax — port of ``paddle_tpu/optimizer/adamax.py``."""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["Adamax"]


class Adamax(Optimizer):
    """m = b1*m + (1-b1)*g; u = max(|g|, b2*u + eps);
    param -= lr / (1 - b1^t) * m / u
    """

    _group_opts = ("beta1", "beta2", "epsilon")
    _fusable_update = True  # elementwise: safe over concatenated buffers

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)

    def _create_state(self, p):
        dt = torch.float32 if self._needs_master(p) else p.dtype
        return {"moment": torch.zeros(p.shape, dtype=dt, device=p.device),
                "inf_norm": torch.zeros(p.shape, dtype=dt, device=p.device),
                "beta1_pow": torch.ones((), dtype=torch.float32,
                                        device=p.device)}

    def _update_delta(self, grad, state, lr, beta1=0.9, beta2=0.999,
                      epsilon=1e-8):
        m = state["moment"].mul_(beta1).add_((1 - beta1) * grad)
        u = state["inf_norm"].mul_(beta2).add_(epsilon)
        torch.maximum(torch.abs(grad), u, out=u)
        b1p = state["beta1_pow"].mul_(beta1)
        # lr / (1 - b1p) as a division (a float over a tensor would be
        # PyTorch's reciprocal-then-multiply)
        lr_t = torch.full_like(b1p, lr) / (1 - b1p)
        return lr_t.to(grad.dtype) * m / u
