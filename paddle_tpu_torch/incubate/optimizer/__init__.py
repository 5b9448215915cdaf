"""``paddle.incubate.optimizer``: LookAhead, ModelAverage and the
exponential moving average — port of
``paddle_tpu/incubate/optimizer/__init__.py`` (Paddle's
``incubate/optimizer/lookahead.py``, ``modelaverage.py`` and fluid's
``ExponentialMovingAverage``).

Each is a wrapper in parameter space: it keeps shadow copies of the
parameters and copies them into the live ones, so it composes with any
inner optimizer. The shadow copies live on the parameters' device (the
reference keeps its jax arrays on the host); ``LookAhead``'s
``state_dict`` keeps the reference's keys (``inner``, ``step`` and
``slow`` by parameter index).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from paddle_tpu_torch.core.tensor import unwrap

__all__ = ["LookAhead", "ModelAverage", "ExponentialMovingAverage"]


def _value(p):
    """A detached copy of parameter ``p`` on its device."""
    return unwrap(p).detach().clone()


@torch.no_grad()
def _assign(p, value):
    unwrap(p).copy_(value)


class LookAhead:
    """k steps forward, one step back (reference ``LookAhead``): every
    ``k`` steps of the inner optimizer the slow weights move ``alpha``
    toward the fast ones, and the fast weights are reset to them."""

    def __init__(self, inner_optimizer, alpha: float = 0.5, k: int = 5,
                 name=None):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError("alpha should be in [0, 1]")
        if k < 1:
            raise ValueError("k should be a positive integer")
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k
        self._step = 0
        self._slow: Dict[int, torch.Tensor] = {
            id(p): _value(p) for p in inner_optimizer._parameter_list}

    @property
    def _parameter_list(self):
        return self.inner_optimizer._parameter_list

    def step(self):
        self.inner_optimizer.step()
        self._step += 1
        if self._step % self.k == 0:
            with torch.no_grad():
                for p in self._parameter_list:
                    slow = self._slow[id(p)]
                    slow.add_(unwrap(p) - slow, alpha=self.alpha)
                    _assign(p, slow)

    def clear_grad(self, set_to_zero: bool = True):
        self.inner_optimizer.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in self._parameter_list]

    def state_dict(self):
        return {"inner": self.inner_optimizer.state_dict(),
                "step": self._step,
                "slow": {i: self._slow[id(p)]
                         for i, p in enumerate(self._parameter_list)}}

    def set_state_dict(self, sd):
        self.inner_optimizer.set_state_dict(sd["inner"])
        self._step = sd["step"]
        for i, p in enumerate(self._parameter_list):
            if i in sd["slow"]:
                self._slow[id(p)] = torch.as_tensor(
                    sd["slow"][i], dtype=p.dtype, device=p.device).clone()


class _ShadowAverager:
    """Averaged copies of ``parameters``, swapped in by :meth:`apply` and
    back out by :meth:`restore`."""

    def __init__(self, parameters):
        self._params = list(parameters)
        self._shadow: Dict[int, torch.Tensor] = {
            id(p): _value(p) for p in self._params}
        self._backup: Optional[Dict[int, torch.Tensor]] = None

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore: bool = True):
        """Copy the averaged weights in for the block (the reference's
        dygraph ``apply`` is a context manager); the live ones come back
        after it unless ``need_restore=False``."""
        self._backup = {id(p): _value(p) for p in self._params}
        for p in self._params:
            _assign(p, self._shadow[id(p)])
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    def restore(self, executor=None):
        if self._backup is not None:
            for p in self._params:
                _assign(p, self._backup[id(p)])
            self._backup = None


class ModelAverage(_ShadowAverager):
    """Running mean of the parameters over the last
    ``max_average_window`` calls of :meth:`step` (reference
    ``ModelAverage``, as the reference's streaming mean)."""

    def __init__(self, average_window_rate: float = 0.15, parameters=None,
                 min_average_window: int = 10000,
                 max_average_window: int = 10000, name=None):
        if parameters is None:
            raise ValueError("parameters is required in dygraph mode")
        super().__init__(parameters)
        self.max_average_window = max_average_window
        self._n = 0

    @torch.no_grad()
    def step(self):
        """Fold the current parameter values in (call after the inner
        optimizer's step)."""
        self._n = min(self._n + 1, self.max_average_window)
        inv = 1.0 / self._n
        for p in self._params:
            s = self._shadow[id(p)]
            s.add_((unwrap(p) - s) * inv)


class ExponentialMovingAverage(_ShadowAverager):
    """``shadow = decay * shadow + (1 - decay) * param`` (reference
    ``ExponentialMovingAverage``), with the decay warm-up ``min(decay,
    (1 + t) / (10 + t))`` when ``thres_steps`` is given."""

    def __init__(self, parameters, decay: float = 0.999,
                 thres_steps=None, name=None):
        super().__init__(parameters)
        self.decay = decay
        self.thres_steps = thres_steps
        self._t = 0

    @torch.no_grad()
    def update(self):
        self._t += 1
        d = min(self.decay, (1 + self._t) / (10 + self._t)) \
            if self.thres_steps is not None else self.decay
        for p in self._params:
            s = self._shadow[id(p)]
            s.mul_(d).add_(unwrap(p), alpha=1.0 - d)
