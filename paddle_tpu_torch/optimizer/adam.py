"""Adam — port of ``paddle_tpu/optimizer/adam.py`` (Paddle's rule, not
``torch.optim.Adam``'s)."""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["Adam"]


class Adam(Optimizer):
    """Paddle's documented rule::

        m = beta1 * m + (1 - beta1) * g
        v = beta2 * v + (1 - beta2) * g*g
        lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t)
        param = param - lr_t * m / (sqrt(v) + eps)

    The moments and the beta powers are updated in place. With moments
    in bf16 or f16 (no ``multi_precision``) every operation rounds to
    their dtype, as PyTorch's per-operation arithmetic does; ``lr_t`` is
    cast to it before it meets ``m``.
    """

    _group_opts = ("beta1", "beta2", "epsilon")
    _fusable_update = True  # elementwise: safe over concatenated buffers

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        if lazy_mode:
            raise NotImplementedError(
                "lazy_mode is not ported to paddle_tpu_torch yet")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)

    def _create_state(self, p):
        dt = torch.float32 if self._needs_master(p) else p.dtype
        one = torch.ones((), dtype=torch.float32, device=p.device)
        return {
            "moment1": torch.zeros(p.shape, dtype=dt, device=p.device),
            "moment2": torch.zeros(p.shape, dtype=dt, device=p.device),
            "beta1_pow": one.clone(),
            "beta2_pow": one.clone(),
        }

    def _update_delta(self, grad, state, lr, beta1=0.9, beta2=0.999,
                      epsilon=1e-8):
        m, v = state["moment1"], state["moment2"]
        m.mul_(beta1).add_((1 - beta1) * grad)
        v.mul_(beta2).add_((1 - beta2) * grad * grad)
        b1p = state["beta1_pow"].mul_(beta1)
        b2p = state["beta2_pow"].mul_(beta2)
        lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
        return lr_t.to(m.dtype) * m / (torch.sqrt(v) + epsilon)
