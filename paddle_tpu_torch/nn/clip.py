"""Gradient clipping — port of ``ClipGradByGlobalNorm`` from
``paddle_tpu/nn/clip.py`` (:80-121). The other strategies are not ported
yet."""
from __future__ import annotations

import torch

__all__ = ["ClipGradByGlobalNorm"]


class ClipGradByGlobalNorm:
    """Rescale all gradients jointly so their global L2 norm is at most
    ``clip_norm``: ``scale = clip_norm / max(global_norm, clip_norm)``,
    with the squares summed in f32 whatever the gradients' dtype.
    Operates on ``(param, grad)`` pairs, as the optimizer hands them
    over."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def __call__(self, params_grads):
        out, _ = self._clip_with_norm(params_grads)
        return out

    def _clip_with_norm(self, params_grads):
        """``(clipped pairs, global_norm)``; the norm is an f32 0-d
        tensor, or None when no pair has a gradient. The clipped
        gradients are new tensors: the given ones are left as they are."""
        grads = [g for p, g in params_grads
                 if g is not None and p.requires_grad]
        if not grads:
            return params_grads, None
        sq = torch.stack([torch.sum(torch.square(g.float()))
                          for g in grads])
        global_norm = torch.sqrt(sq.sum())
        scale = self.clip_norm / torch.clamp(global_norm,
                                             min=self.clip_norm)
        out = [(p, g) if g is None or not p.requires_grad
               else (p, g * scale.to(g.dtype)) for p, g in params_grads]
        return out, global_norm

    def __repr__(self):
        return f"ClipGradByGlobalNorm(clip_norm={self.clip_norm})"
