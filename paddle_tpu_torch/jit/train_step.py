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
``TrainStep.update``); the whole step is one ``profiler.RecordEvent``
span (``TrainStep``) inside ``observability.comm.compute_scope``, as in
the reference (:774-787). The first step's wall, less the kernel builds
and captures stamped inside it, goes to the goodput ledger's ``compile``
bin (``observability/goodput.py`` states the rule).

Numerics (``observability.numerics``): on the steps
``numerics.sample_this_step`` picks, the step is the instrumented twin:
the forward runs under ``numerics.collect()``, and the step computes
each bucket's gradient norm and non-finite count before the clip and
its update and parameter norms after the update (buckets named
``bucket<i>:<first parameter>`` as the reference's, the residue by
parameter group, ``group<g>``); the sample lands in
:attr:`TrainStep.last_numerics` and the observatory. Other steps run
the code of a never-instrumented step. While
``numerics.provenance_enabled()`` each step stashes its batch and
random state for :meth:`TrainStep.numerics_probe_last`.

Over a mesh (``mesh=``, or a ``DataParallel`` model, whose mesh and
``batch_spec`` it takes, as the reference's :101-106): each process runs
its rows of the batch (``input_spec``, default ``P("dp")``), the loss is
one mean over the global batch, the gradients are all-reduced in buckets
as they land (``bucketed``, on by default as in the reference), the
tensor-parallel blocks and ZeRO's shards are trained where they live,
and the global-norm clip sums each split gradient over its axes:
``jit/mesh_step.py`` holds that path. CUDA-graph capture and the lr as
a device scalar are not ported yet.

Usage::

    step = TrainStep(model, loss_fn, optimizer)
    loss = step(x)          # loss_fn(model, x) -> scalar loss tensor
"""
from __future__ import annotations

import time
import warnings
from typing import Callable

import numpy as np
import torch
from torch.profiler import record_function

from paddle_tpu_torch.core import generator
from paddle_tpu_torch.core.tensor import unwrap_args, wrap
from paddle_tpu_torch.distributed.parallel import (DataParallel,
                                                   counting_loss_tokens,
                                                   splitting_batch)
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.observability import goodput, numerics
from paddle_tpu_torch.observability.comm import compute_scope
from paddle_tpu_torch.profiler import RecordEvent

from .fused_update import (build_flat_states, build_layout, fused_clip,
                           fused_enabled, fused_update)
from .mesh_step import MeshPlan

__all__ = ["TrainStep"]

RANGE_FORWARD_BACKWARD = "TrainStep.forward_backward"
RANGE_CLIP = "TrainStep.clip"
RANGE_UPDATE = "TrainStep.update"


class TrainStep:
    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 donate: bool = True, mesh=None, input_spec=None,
                 fused=None, bucketed=None):
        """The update is in place, which is what the reference's default
        ``donate=True`` buys. With ``donate=False`` each step first
        rebinds every trainable parameter to a copy of itself and updates
        the copy, so a tensor the caller took from a parameter before the
        step (``state_dict()``, ``detach()``) keeps its values, as the
        reference's undonated buffers do. ``fused`` overrides
        ``fused_enabled()``. ``mesh``/``input_spec`` run the step over a
        mesh (a ``DataParallel`` model brings its own), with the
        gradients reduced in buckets unless ``bucketed=False``."""
        self._donate = bool(donate)
        if mesh is None and isinstance(model, DataParallel):
            mesh = model._mesh
        if input_spec is not None and mesh is None:
            raise ValueError("input_spec needs a mesh")
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
        #: the last sampled step's numerics (numerics.host_sample's dict)
        self.last_numerics = None
        #: (args, kwargs, random state) of the last step, while
        #: numerics.provenance_enabled()
        self._last_batch = None
        self._stepped = False
        #: the mesh path's plan (None without a mesh)
        self._mesh_plan = None if mesh is None else MeshPlan(
            model, optimizer, mesh, input_spec, bucketed, self._params)

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
            plan = self._mesh_plan
            return clip._clip_with_norm(
                pairs, None if plan is None else plan.clip_reduce)
        return (clip(pairs) if clip is not None else pairs), None

    def _update_loop(self, pairs, group_lrs):
        opt = self._opt
        for gi, group in enumerate(opt._param_groups):
            mine = [(p, g) for p, g in pairs
                    if self._group_of[id(p)] is group]
            if mine:
                opt._apply(group, mine, group_lrs[gi])

    def _bucket_names(self, layout, names):
        """``{stat name: [parameter names]}``: the fused buckets, then the
        rest by parameter group (the reference's :363-401)."""
        out, rest = {}, list(names)
        if layout is not None and layout.buckets:
            for i, b in enumerate(layout.buckets):
                out[f"bucket{i}:{b.names[0]}"] = list(b.names)
            rest = [n for n in names if n in set(layout.residue)]
        groups = {}
        index = {id(g): i for i, g in enumerate(self._opt._param_groups)}
        for n in rest:
            gi = index[id(self._group_of[id(self._params[n])])]
            groups.setdefault(gi, []).append(n)
        for gi in sorted(groups):
            out[f"group{gi}"] = groups[gi]
        return out

    @staticmethod
    @torch.no_grad()
    def _grad_stats(buckets, grads):
        """Per bucket ``(L2 norm, non-finite count)`` of the gradients,
        and the total sum of squares."""
        out, total = {}, None
        for key, names in buckets.items():
            gs = [grads[n] for n in names]
            sq = sum(g.float().square().sum() for g in gs)
            nonf = sum((~torch.isfinite(g)).sum() for g in gs)
            out[key] = (sq.sqrt(), nonf)
            total = sq if total is None else total + sq
        return out, total

    @staticmethod
    @torch.no_grad()
    def _update_stats(buckets, before, params):
        """Per bucket ``(update norm, parameter norm)`` of this step."""
        out = {}
        for key, names in buckets.items():
            us = sum((params[n].detach().float() - before[n].float())
                     .square().sum() for n in names)
            ps = sum(before[n].float().square().sum() for n in names)
            out[key] = (us.sqrt(), ps.sqrt())
        return out

    def __call__(self, *args, **kwargs):
        """One step on the batch ``args``/``kwargs``; the loss, detached.
        Paddle ``Tensor`` arguments reach ``loss_fn`` as they are (it is
        the user's code), and the loss comes back as a ``Tensor`` when
        the batch held one."""
        instrument = numerics.sample_this_step(self._opt._step_count + 1)
        if numerics.provenance_enabled():
            self._last_batch = (args, kwargs, generator.get_rng_state())
        first = not self._stepped
        if first:
            t0, stamped0 = time.perf_counter(), \
                goodput.stamped_compile_seconds()
        with RecordEvent("TrainStep"), compute_scope():
            loss = self._step(args, kwargs, instrument)
        if first:
            self._stepped = True
            if loss.is_cuda:
                torch.cuda.synchronize(loss.device)
            goodput.record_compile(time.perf_counter() - t0 - (
                goodput.stamped_compile_seconds() - stamped0))
        return loss

    def _forward_backward(self, train, names, args, kwargs, instrument):
        """``(loss, gradient pairs, numerics collector, had a Tensor)``;
        over a mesh the loss is the global batch's and the gradients are
        reduced (``mesh_step.MeshPlan``)."""
        plan = self._mesh_plan
        had = unwrap_args(args, kwargs)[2]
        if plan is None:
            with numerics.collect(instrument) as col:
                loss = self._loss_fn(self._model, *args, **kwargs)
            (loss,), _, had_loss = unwrap_args((loss,), None)
            # the pairs hold the only reference to the gradients, so the
            # loop frees them once its clip has copied them, before the
            # update allocates its temporaries
            return loss, list(zip(train, torch.autograd.grad(
                loss, train, allow_unused=True, materialize_grads=True))), \
                col, had or had_loss
        args, kwargs = plan.local_batch(args, kwargs)
        plan.install_full()
        try:
            with numerics.collect(instrument) as col, \
                    counting_loss_tokens() as noted, \
                    splitting_batch(plan.row_axes, plan.batch_axes):
                loss = self._loss_fn(self._model, *args, **kwargs)
            (loss,), _, had_loss = unwrap_args((loss,), None)
            weight, global_loss = plan.weigh(loss, noted)
            plan.begin(names)
            torch.autograd.backward(
                loss if weight is None else loss * weight, inputs=train)
            grads = plan.finish(names)
        finally:
            plan.restore_shards()
        return global_loss, [(p, grads[n]) for p, n in zip(train, names)], \
            col, had or had_loss

    def _step(self, args, kwargs, instrument):
        opt = self._opt
        train = [p for p in opt._parameter_list if p.requires_grad]
        names = [self._name_of[id(p)] for p in train]
        plan = self._mesh_plan
        with record_function(RANGE_FORWARD_BACKWARD):
            loss, pairs, col, had = self._forward_backward(
                train, names, args, kwargs, instrument)
        if not self._donate:
            with torch.no_grad():
                for p in train:
                    p.data = p.data.clone()
        group_lrs = self._group_lrs()
        opt._step_count += 1
        zero = plan is not None and plan.zero_level is not None
        layout, flats = self._fused_plan(names) \
            if self._fused and not zero else (None, None)
        self._layout = layout
        if instrument:
            buckets = self._bucket_names(layout, names)
            gstats, total_sq = self._grad_stats(
                buckets, {self._name_of[id(p)]: g for p, g in pairs})
            before = {n: self._params[n].detach().clone() for n in names}
        if layout is None or not layout.buckets:
            with record_function(RANGE_CLIP):
                pairs, gnorm = self._clip_loop(pairs)
            with record_function(RANGE_UPDATE):
                if zero:
                    plan.zero_update(opt, pairs, group_lrs, self._group_of)
                else:
                    self._update_loop(pairs, group_lrs)
        else:
            by_name = {self._name_of[id(p)]: g for p, g in pairs}
            with record_function(RANGE_CLIP):
                bucket_grads, res_grads, scale, gnorm = fused_clip(
                    opt, layout, self._params, by_name,
                    None if plan is None else plan.reduce_sq)
            with record_function(RANGE_UPDATE):
                fused_update(opt, layout, self._params, bucket_grads, flats,
                             group_lrs, scale)
                self._update_loop([(self._params[n], g)
                                   for n, g in res_grads.items()], group_lrs)
        self.last_grad_norm = gnorm
        loss = loss.detach()
        if instrument:
            nums = {"taps": col.taps, "grads": gstats,
                    "updates": self._update_stats(buckets, before,
                                                  self._params),
                    "grad_norm": gnorm if gnorm is not None
                    else total_sq.sqrt()}
            del before
            try:
                self.last_numerics = numerics.host_sample(nums, loss)
                numerics.get_observatory().record_sample(
                    opt._step_count, self.last_numerics)
            except Exception:
                # telemetry must never fail the step it observes
                warnings.warn("[numerics] sample publication failed",
                              RuntimeWarning, stacklevel=2)
        return wrap(loss) if had else loss

    def numerics_probe_last(self):
        """NaN-provenance replay: the forward and gradients of the last
        stashed batch, with that step's random state and every tap
        collected, against the CURRENT model (the NaN guard restores the
        last commit first). No clip, no update: parameters, optimizer
        state and the random state are left as they were. Returns the
        host sample (taps, gradient buckets, ``grad_norm``, ``loss``),
        or None when no batch was stashed."""
        if self._last_batch is None:
            return None
        args, kwargs, rng = self._last_batch
        saved = generator.get_rng_state()
        train = [p for p in self._opt._parameter_list if p.requires_grad]
        names = [self._name_of[id(p)] for p in train]
        generator.set_rng_state(rng)
        try:
            with numerics.collect() as col:
                loss = self._loss_fn(self._model, *args, **kwargs)
            (loss,), _, _ = unwrap_args((loss,), None)
            grads = torch.autograd.grad(loss, train, allow_unused=True,
                                        materialize_grads=True)
            gstats, total_sq = self._grad_stats(
                self._bucket_names(self._layout, names),
                dict(zip(names, grads)))
            del grads
            nums = {"taps": col.taps, "grads": gstats,
                    "grad_norm": total_sq.sqrt()}
            return numerics.host_sample(nums, loss.detach())
        finally:
            generator.set_rng_state(saved)


def _layout_sig(layout):
    """Structural identity of a layout: two layouts with the same
    signature index identical flat buffers."""
    return tuple((b.names, b.vector_keys, b.scalar_keys, b.master)
                 for b in layout.buckets)
