"""Gradient clipping — port of ``paddle_tpu/nn/clip.py`` (:22-121):
``ClipGradByValue``, ``ClipGradByNorm`` and ``ClipGradByGlobalNorm``.
Each works on ``(param, grad)`` pairs, as the optimizer hands them over,
and returns new gradient tensors: the given ones are left as they are.
Pairs whose gradient is None or whose parameter does not require a
gradient pass through unchanged."""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]


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

    def _clip_with_norm(self, params_grads):
        """``(clipped pairs, global_norm)``; the norm is an f32 0-d
        tensor, or None when no pair has a gradient."""
        grads = [g for p, g in params_grads if not _skipped(p, g)]
        if not grads:
            return params_grads, None
        sq = torch.stack([torch.sum(torch.square(g.float()))
                          for g in grads])
        global_norm = torch.sqrt(sq.sum())
        scale = self.scale(global_norm)
        out = [(p, g) if _skipped(p, g) else (p, g * scale.to(g.dtype))
               for p, g in params_grads]
        return out, global_norm

    def __repr__(self):
        return f"ClipGradByGlobalNorm(clip_norm={self.clip_norm})"
