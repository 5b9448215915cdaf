"""Gradient clipping — port of ``paddle_tpu/nn/clip.py``:
``ClipGradByValue``, ``ClipGradByNorm`` and ``ClipGradByGlobalNorm``
(:22-121), and the torch-style in-place ``clip_grad_norm_`` and
``clip_grad_value_`` (:127-167). The three classes work on ``(param,
grad)`` pairs, as the optimizer hands them over, and return new gradient
tensors: the given ones are left as they are. Pairs whose gradient is
None or whose parameter does not require a gradient pass through
unchanged."""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_", "clip_grad_value_"]


def _skipped(p, g) -> bool:
    return g is None or not p.requires_grad


class ClipGradBase:
    def __call__(self, params_grads):
        return self._clip(params_grads)

    def _clip(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Clip every gradient elementwise into ``[min, max]`` (``min``
    defaults to ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip(self, params_grads):
        return [(p, g) if _skipped(p, g)
                else (p, torch.clamp(g, self.min, self.max))
                for p, g in params_grads]

    def __repr__(self):
        return f"ClipGradByValue(min={self.min}, max={self.max})"


class ClipGradByNorm(ClipGradBase):
    """Rescale each gradient on its own so that its L2 norm (taken in
    f32) is at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if _skipped(p, g):
                out.append((p, g))
                continue
            norm = torch.sqrt(torch.sum(torch.square(g.float())))
            scale = torch.where(
                norm > self.clip_norm,
                self.clip_norm / torch.clamp(norm, min=1e-12),
                torch.ones_like(norm))
            out.append((p, g * scale.to(g.dtype)))
        return out

    def __repr__(self):
        return f"ClipGradByNorm(clip_norm={self.clip_norm})"


class ClipGradByGlobalNorm(ClipGradBase):
    """Rescale all gradients jointly so their global L2 norm is at most
    ``clip_norm``: ``scale = clip_norm / max(global_norm, clip_norm)``,
    with the squares summed in f32 whatever the gradients' dtype."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _clip(self, params_grads):
        out, _ = self._clip_with_norm(params_grads)
        return out

    def scale(self, global_norm):
        """The factor every gradient is multiplied by (an f32 0-d
        tensor on the norm's device)."""
        return self.clip_norm / torch.clamp(global_norm, min=self.clip_norm)

    def _clip_with_norm(self, params_grads, reduce_sq=None):
        """``(clipped pairs, global_norm)``; the norm is an f32 0-d
        tensor, or None when no pair has a gradient. ``reduce_sq``, given
        the parameters and their squared norms, returns the global sum
        (``TrainStep`` over a mesh sums split parameters over their
        axes); by default the local sum."""
        kept = [(p, g) for p, g in params_grads if not _skipped(p, g)]
        if not kept:
            return params_grads, None
        sq = [torch.sum(torch.square(g.float())) for _, g in kept]
        global_norm = torch.sqrt(torch.stack(sq).sum() if reduce_sq is None
                                 else reduce_sq([p for p, _ in kept], sq))
        scale = self.scale(global_norm)
        out = [(p, g) if _skipped(p, g) else (p, g * scale.to(g.dtype))
               for p, g in params_grads]
        return out, global_norm

    def __repr__(self):
        return f"ClipGradByGlobalNorm(clip_norm={self.clip_norm})"


def _param_list(parameters):
    return [parameters] if isinstance(parameters, torch.Tensor) \
        else list(parameters)


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the ``.grad`` of ``parameters`` in place by ``min(max_norm /
    max(total, 1e-6), 1)``, ``total`` the ``norm_type`` norm of all the
    gradients together (in f32, the largest magnitude for ``inf``), and
    return ``total`` (0 when no parameter has a gradient). A non-finite
    total raises ``RuntimeError`` under ``error_if_nonfinite``."""
    params = [p for p in _param_list(parameters) if p.grad is not None]
    if not params:
        return torch.tensor(0.0)
    grads = [p.grad for p in params]
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = torch.stack([torch.sum(g.float().abs() ** norm_type)
                             for g in grads]).sum() ** (1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError("the total norm for gradients is non-finite")
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-6), max=1.0)
    with torch.no_grad():
        for g in grads:
            g.mul_(scale.to(g.dtype))
    return total


def clip_grad_value_(parameters, clip_value):
    """Clamp every ``.grad`` of ``parameters`` into ``[-clip_value,
    clip_value]`` in place."""
    if clip_value < 0:
        raise ValueError("clip_value must be non-negative")
    with torch.no_grad():
        for p in _param_list(parameters):
            if p.grad is not None:
                p.grad.clamp_(-clip_value, clip_value)
