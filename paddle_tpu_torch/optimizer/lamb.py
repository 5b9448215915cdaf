"""LAMB — port of ``paddle_tpu/optimizer/lamb.py``. Its trust ratio
takes a norm over each parameter, so the rule is not elementwise and a
fused ``TrainStep`` keeps it in the per-parameter loop."""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["Lamb"]


class Lamb(Optimizer):
    """Adam moments + layerwise trust ratio::

        r = m_unbiased / (sqrt(v_unbiased) + eps) + lamb_wd * param
        ratio = ||param|| / ||r||   (1 where either norm is 0)
        param -= lr * ratio * r
    """

    _group_opts = ("beta1", "beta2", "epsilon", "lamb_weight_decay")

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9,
                 beta2=0.999, epsilon=1e-6, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._lamb_weight_decay = float(lamb_weight_decay)
        self._exclude_fn = exclude_from_weight_decay_fn

    def _create_state(self, p):
        dt = torch.float32 if self._needs_master(p) else p.dtype
        one = torch.ones((), dtype=torch.float32, device=p.device)
        return {"moment1": torch.zeros(p.shape, dtype=dt, device=p.device),
                "moment2": torch.zeros(p.shape, dtype=dt, device=p.device),
                "beta1_pow": one.clone(), "beta2_pow": one.clone()}

    def _param_group_kwargs(self, p, group):
        kw = super()._param_group_kwargs(p, group)
        if self._exclude_fn is not None and self._exclude_fn(p):
            kw["lamb_weight_decay"] = 0.0
        return kw

    def _update(self, param, grad, state, lr, weight_decay=0.0, beta1=0.9,
                beta2=0.999, epsilon=1e-6, lamb_weight_decay=0.01):
        g = grad.to(param.dtype)
        m = state["moment1"].mul_(beta1).add_((1 - beta1) * g)
        v = state["moment2"].mul_(beta2).add_((1 - beta2) * g * g)
        b1p = state["beta1_pow"].mul_(beta1)
        b2p = state["beta2_pow"].mul_(beta2)
        m_hat = m / (1 - b1p)
        v_hat = v / (1 - b2p)
        r = m_hat / (torch.sqrt(v_hat) + epsilon) + lamb_weight_decay * param
        p_norm = torch.sqrt(torch.sum(torch.square(param.float())))
        r_norm = torch.sqrt(torch.sum(torch.square(r.float())))
        ratio = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                            torch.ones_like(p_norm))
        param.sub_((lr * ratio).to(param.dtype) * r)
