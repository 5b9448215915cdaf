"""TrainStep — port of ``paddle_tpu/jit/train_step.py``.

One training iteration: forward and loss, backward, global gradient
clip and the optimizer update, over the parameters the optimizer holds.
The reference compiles the whole step into one XLA program with donated
buffers; here it runs eagerly, and the update is in place. CUDA-graph
capture, the fused multi-tensor update and the lr as a device scalar are
not ported yet, nor are the mesh and bucketed-collective paths.

Usage::

    step = TrainStep(model, loss_fn, optimizer)
    loss = step(x)          # loss_fn(model, x) -> scalar loss tensor
"""
from __future__ import annotations

from typing import Callable

import torch

from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm

__all__ = ["TrainStep"]


class TrainStep:
    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 donate: bool = True, mesh=None, input_spec=None,
                 fused=None, bucketed=None):
        """The update is in place, which is what the reference's default
        ``donate=True`` buys; ``donate=False``, ``mesh``, ``input_spec``
        and ``fused``/``bucketed`` set to True raise: they are not ported
        yet."""
        if mesh is not None or input_spec is not None:
            raise NotImplementedError(
                "SPMD training (mesh/input_spec) is not ported to "
                "paddle_tpu_torch yet")
        if not donate:
            raise NotImplementedError(
                "donate=False is not ported to paddle_tpu_torch: the "
                "update is always in place")
        if fused or bucketed:
            raise NotImplementedError(
                "the fused multi-tensor update and bucketed collectives "
                "are not ported to paddle_tpu_torch yet")
        self._model = model
        self._loss_fn = loss_fn
        self._opt = optimizer
        # only parameters handed to the optimizer train; the model's
        # others stay frozen, as in the reference (:108-115)
        self._group_of = {id(p): g for g in optimizer._param_groups
                          for p in g["params"]}
        #: the global gradient norm of the last step (an f32 0-d tensor
        #: under ClipGradByGlobalNorm, else None)
        self.last_grad_norm = None

    def __call__(self, *args, **kwargs):
        opt = self._opt
        train = [p for p in opt._parameter_list if p.requires_grad]
        loss = self._loss_fn(self._model, *args, **kwargs)
        pairs = list(zip(train, torch.autograd.grad(
            loss, train, allow_unused=True, materialize_grads=True)))
        clip = opt._grad_clip
        gnorm = None
        if isinstance(clip, ClipGradByGlobalNorm):
            # one norm over every trained parameter, all groups together
            pairs, gnorm = clip._clip_with_norm(pairs)
        elif clip is not None:
            pairs = clip(pairs)
        opt._step_count += 1
        for group in opt._param_groups:
            mine = [(p, g) for p, g in pairs
                    if self._group_of[id(p)] is group]
            if mine:
                opt._apply(group, mine)
        self.last_grad_norm = gnorm
        return loss.detach()
