"""TrainStep — port of ``paddle_tpu/jit/train_step.py``.

One training iteration: forward and loss, backward, gradient clip and
the optimizer update, over the parameters the optimizer holds. The
reference compiles the whole step into one XLA program with donated
buffers; here it runs eagerly, and the update is in place.

By default (``fused=None`` follows ``fused_enabled()``, on unless
``PADDLE_TPU_FUSED_OPTIMIZER=0``) the update is the fused multi-tensor
update of ``jit/fused_update.py``: the parameters are planned into flat
buckets once, each bucket's state lives in flat buffers (the optimizer's
per-parameter entries are views of them), and each bucket is clipped and
updated in one pass (``fused_sqnorm`` and ``fused_adam_update`` on the
card). Parameters that cannot fuse keep the per-parameter loop.
``fused=False`` runs the loop for every parameter.

The group learning rates are read on the host at every step, as the
reference's ``_group_lrs`` (:668-683), so a scheduler's tick takes
effect on the next step. The forward and backward, the clip and the
update each run inside one ``torch.profiler.record_function`` range
(``TrainStep.forward_backward``, ``TrainStep.clip``,
``TrainStep.update``). CUDA-graph capture and the lr as a device scalar
are not ported yet, nor are the mesh and bucketed-collective paths.

Usage::

    step = TrainStep(model, loss_fn, optimizer)
    loss = step(x)          # loss_fn(model, x) -> scalar loss tensor
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.profiler import record_function

from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm

from .fused_update import (build_flat_states, build_layout, fused_clip,
                           fused_enabled, fused_update)

__all__ = ["TrainStep"]

RANGE_FORWARD_BACKWARD = "TrainStep.forward_backward"
RANGE_CLIP = "TrainStep.clip"
RANGE_UPDATE = "TrainStep.update"


class TrainStep:
    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 donate: bool = True, mesh=None, input_spec=None,
                 fused=None, bucketed=None):
        """The update is in place, which is what the reference's default
        ``donate=True`` buys; ``donate=False``, ``mesh``, ``input_spec``
        and ``bucketed=True`` raise: they are not ported yet.
        ``fused`` overrides ``fused_enabled()``."""
        if mesh is not None or input_spec is not None:
            raise NotImplementedError(
                "SPMD training (mesh/input_spec) is not ported to "
                "paddle_tpu_torch yet")
        if not donate:
            raise NotImplementedError(
                "donate=False is not ported to paddle_tpu_torch: the "
                "update is always in place")
        if bucketed:
            raise NotImplementedError(
                "bucketed gradient collectives are not ported to "
                "paddle_tpu_torch yet")
        self._model = model
        self._loss_fn = loss_fn
        self._opt = optimizer
        self._fused = fused_enabled() if fused is None else bool(fused)
        # the optimizer's parameters by name: the model's names, else
        # param_<i> by the optimizer's order
        names = {id(p): n for n, p in model.named_parameters()}
        self._params = {names.get(id(p), f"param_{i}"): p
                        for i, p in enumerate(optimizer._parameter_list)}
        self._name_of = {id(p): n for n, p in self._params.items()}
        # only parameters handed to the optimizer train; the model's
        # others stay frozen, as in the reference (:108-115)
        self._group_of = {id(p): g for g in optimizer._param_groups
                          for p in g["params"]}
        #: the fused plan of the current trainable set: (plan key, layout
        #: or None, flat states, {name: (state dict, its flat views)})
        self._plan = None
        #: the layout of the last step (None on the loop path)
        self._layout = None
        #: the global gradient norm of the last step (an f32 0-d tensor
        #: under ClipGradByGlobalNorm, else None)
        self.last_grad_norm = None

    def _group_lrs(self):
        """Effective lr per param group in f32, read on the host at every
        step (a group's lr, float or scheduler, scales the optimizer's)."""
        return [np.float32(self._opt._group_lr(g))
                for g in self._opt._param_groups]

    # -- fused flat-state lifecycle -------------------------------------------
    def _views_current(self, views) -> bool:
        """True while every fused parameter's state entries are still the
        views installed with the flats (``set_state_dict`` replaces
        them)."""
        opt = self._opt
        return all(opt._state.get(id(self._params[n])) is d and
                   all(d.get(k) is t for k, t in entries)
                   for n, (d, entries) in views.items())

    def _fused_plan(self, train_names):
        """The layout and flat states for this trainable set. Planned again
        when the set changes, when the optimizer's state was written
        outside this step (an eager step, ``set_state_dict``), or when the
        views were replaced; the flats are kept if the new layout indexes
        them alike and the views still stand."""
        opt = self._opt
        key = (tuple(train_names), opt._state_epoch)
        old = self._plan
        if old is not None and old[0] == key and self._views_current(old[3]):
            return old[1], old[2]
        self._plan = None
        layout = build_layout(opt, self._params, train_names)
        if layout is None:
            flats = []
        elif old is not None and old[1] is not None and \
                _layout_sig(old[1]) == _layout_sig(layout) and \
                self._views_current(old[3]):
            flats = old[2]  # the state moved in place: the flats are it
        else:
            old = None  # let the old flats go before the new ones exist
            flats = build_flat_states(opt, layout, self._params)
        views = {}
        for b in (layout.buckets if layout is not None else ()):
            for n in b.names:
                d = opt._state[id(self._params[n])]
                views[n] = (d, tuple(d.items()))
        self._plan = (key, layout, flats, views)
        return layout, flats

    # -- the step -------------------------------------------------------------
    def _clip_loop(self, pairs):
        clip = self._opt._grad_clip
        if isinstance(clip, ClipGradByGlobalNorm):
            # one norm over every trained parameter, all groups together
            return clip._clip_with_norm(pairs)
        return (clip(pairs) if clip is not None else pairs), None

    def _update_loop(self, pairs, group_lrs):
        opt = self._opt
        for gi, group in enumerate(opt._param_groups):
            mine = [(p, g) for p, g in pairs
                    if self._group_of[id(p)] is group]
            if mine:
                opt._apply(group, mine, group_lrs[gi])

    def __call__(self, *args, **kwargs):
        opt = self._opt
        train = [p for p in opt._parameter_list if p.requires_grad]
        with record_function(RANGE_FORWARD_BACKWARD):
            loss = self._loss_fn(self._model, *args, **kwargs)
            # the pairs hold the only reference to the gradients, so the
            # loop frees them once its clip has copied them, before the
            # update allocates its temporaries
            pairs = list(zip(train, torch.autograd.grad(
                loss, train, allow_unused=True, materialize_grads=True)))
        group_lrs = self._group_lrs()
        opt._step_count += 1
        layout, flats = self._fused_plan(
            [self._name_of[id(p)] for p in train]) if self._fused \
            else (None, None)
        self._layout = layout
        if layout is None or not layout.buckets:
            with record_function(RANGE_CLIP):
                pairs, gnorm = self._clip_loop(pairs)
            with record_function(RANGE_UPDATE):
                self._update_loop(pairs, group_lrs)
        else:
            by_name = {self._name_of[id(p)]: g for p, g in pairs}
            with record_function(RANGE_CLIP):
                bucket_grads, res_grads, scale, gnorm = fused_clip(
                    opt, layout, self._params, by_name)
            with record_function(RANGE_UPDATE):
                fused_update(opt, layout, self._params, bucket_grads, flats,
                             group_lrs, scale)
                self._update_loop([(self._params[n], g)
                                   for n, g in res_grads.items()], group_lrs)
        self.last_grad_norm = gnorm
        return loss.detach()


def _layout_sig(layout):
    """Structural identity of a layout: two layouts with the same
    signature index identical flat buffers."""
    return tuple((b.names, b.vector_keys, b.scalar_keys, b.master)
                 for b in layout.buckets)
