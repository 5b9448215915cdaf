"""AdamW — port of ``paddle_tpu/optimizer/adamw.py``: Adam with decoupled
weight decay. The decay multiplies the parameter by ``1 - lr * coeff``
before the Adam step and never enters the moments;
``apply_decay_param_fun`` masks it per parameter and ``lr_ratio`` scales
the lr per parameter."""
from __future__ import annotations

from .adam import Adam

__all__ = ["AdamW"]


class AdamW(Adam):

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        wd = weight_decay if weight_decay is not None else 0.01
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         wd, grad_clip, lazy_mode, multi_precision, name)
        self._decoupled_decay = True
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _decay_coeff_for(self, p, decay):
        if decay is None:
            return 0.0
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(getattr(p, "name", "")):
            return 0.0
        return decay.coeff

    def _param_lr(self, p, lr):
        if self._lr_ratio is not None:
            return lr * self._lr_ratio(p)
        return lr
