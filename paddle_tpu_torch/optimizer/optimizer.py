"""Optimizer base class — port of ``paddle_tpu/optimizer/optimizer.py``.

Parameter groups, a float or ``LRScheduler`` learning rate (for the
optimizer and for each group), weight decay (an L1 or L2 regularizer
folded into the gradient, or AdamW's decoupled coefficient), gradient
clipping, f32 master weights for bf16/f16 parameters
(``multi_precision``) and ``state_dict``/``set_state_dict`` with the
reference's per-parameter keys (``param_<i>.moment1``, ...,
``@step_count``, ``LR_Scheduler``).

The reference's update rules are pure functions over immutable arrays;
here each rule updates its parameter, master weight and moments in
place, which keeps one copy of the optimizer state in device memory, in
the reference's order of operations. ``TrainStep``'s fused update
(``jit/fused_update.py``) keeps the state of its buckets in flat
buffers and leaves each parameter's entries here as views of them, so
the reference's flush seam (``_register_state_sync``/``_sync_state``,
:108-126) has no counterpart: every reader sees current values.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from paddle_tpu_torch.regularizer import L2Decay, WeightDecayRegularizer

from . import lr as lr_mod

__all__ = ["Optimizer"]


def decay_factor(lr, coeff) -> float:
    """``1 - lr * coeff`` in f32, as the reference's compiled step
    computes the decoupled decay's factor."""
    return float(np.float32(1.0) - np.float32(lr) * np.float32(coeff))


class Optimizer:
    # per-group hyperparameter names (beyond learning_rate/weight_decay)
    # that the rule receives as keyword arguments
    _group_opts = ()
    # True when the rule is elementwise: over a concatenation of buffers
    # it gives every element the same bits as one parameter at a time, so
    # jit.fused_update may run it once per bucket. Rules with per-tensor
    # reductions (Lamb's trust ratio) leave it False.
    _fusable_update = False

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            import paddle_tpu_torch
            if paddle_tpu_torch.in_dynamic_mode():
                raise ValueError(
                    "parameters is required in dygraph mode: pass "
                    "model.parameters() (static mode collects them from "
                    "the loss graph at minimize())")
            parameters = []  # static mode: filled by minimize()
        if not isinstance(learning_rate, (int, float, lr_mod.LRScheduler)):
            raise TypeError(f"learning_rate must be a float or an "
                            f"LRScheduler, got {type(learning_rate)}")
        self._lr = learning_rate if isinstance(
            learning_rate, lr_mod.LRScheduler) else float(learning_rate)
        self._grad_clip = grad_clip
        self._name = name
        self._multi_precision = multi_precision
        self._decoupled_decay = False  # AdamW overrides
        self.regularization = self._make_decay(weight_decay)
        params = list(parameters)
        if params and isinstance(params[0], dict):
            self._param_groups = []
            for g in params:
                group = dict(g)
                group["params"] = list(group["params"])
                if "weight_decay" in group:
                    group["weight_decay"] = self._make_decay(
                        group["weight_decay"])
                self._param_groups.append(group)
        else:
            self._param_groups = [{"params": params}]
        for g in self._param_groups:
            for p in g["params"]:
                if not isinstance(p, torch.Tensor):
                    raise TypeError(f"optimizer parameters must be "
                                    f"tensors, got {type(p)}")
        # accumulator state: id(param) -> {name: tensor}
        self._state: Dict[int, Dict[str, torch.Tensor]] = {}
        self._step_count = 0
        # bumped by every write to the state outside TrainStep (an eager
        # step, set_state_dict): a fused TrainStep then plans its buckets
        # again, since their scalar state may have moved apart
        self._state_epoch = 0

    # -- decay / lr ----------------------------------------------------------
    @staticmethod
    def _make_decay(weight_decay):
        if weight_decay is None:
            return None
        if isinstance(weight_decay, WeightDecayRegularizer):
            return weight_decay
        return L2Decay(float(weight_decay))

    def get_lr(self) -> float:
        if isinstance(self._lr, lr_mod.LRScheduler):
            return self._lr()
        return self._lr

    def set_lr(self, value: float):
        if isinstance(self._lr, lr_mod.LRScheduler):
            raise RuntimeError(
                "cannot set_lr when the learning rate is an LRScheduler; "
                "call scheduler.step() instead")
        self._lr = float(value)

    def set_lr_scheduler(self, scheduler: lr_mod.LRScheduler):
        if not isinstance(scheduler, lr_mod.LRScheduler):
            raise TypeError(f"expected an LRScheduler, got "
                            f"{type(scheduler)}")
        self._lr = scheduler

    def _group_lr(self, group) -> float:
        """The effective lr of a group, as the eager step computes it: its
        ``learning_rate`` (a float or a scheduler) scales the
        optimizer's."""
        if "learning_rate" not in group:
            return self.get_lr()
        glr = group["learning_rate"]
        if isinstance(glr, lr_mod.LRScheduler):
            glr = glr()
        return glr * self.get_lr()

    # -- accumulators --------------------------------------------------------
    def _needs_master(self, p) -> bool:
        return self._multi_precision and p.dtype in (torch.bfloat16,
                                                     torch.float16)

    def _new_state(self, p) -> Dict[str, torch.Tensor]:
        """A parameter's fresh accumulators, with its f32 master weight
        where it needs one; not installed."""
        s = self._create_state(p)
        if self._needs_master(p):
            s["master_weight"] = p.detach().float().clone()
        return s

    def _ensure_state(self, p) -> Dict[str, torch.Tensor]:
        s = self._state.get(id(p))
        if s is None:
            s = self._state[id(p)] = self._new_state(p)
        return s

    def _create_state(self, p) -> Dict[str, torch.Tensor]:
        """Per-parameter accumulator init (subclass hook)."""
        return {}

    # -- the update ----------------------------------------------------------
    def _update_delta(self, grad, state, lr, **opts):
        """The rule's step ``delta`` (``new = param - delta``), updating
        ``state`` in place. ``grad`` arrives cast to the accumulator
        dtype; ``delta`` is elementwise in ``grad`` and ``state`` only."""
        raise NotImplementedError

    def _update(self, param, grad, state, lr, weight_decay=0.0, **opts):
        """One parameter's update in place: the rule's delta, the
        decoupled decay (AdamW sets ``_decoupled_decay``), the
        subtraction. Rules whose step needs the parameter itself
        (Lamb's trust ratio) override this and stay unfusable."""
        delta = self._update_delta(grad.to(param.dtype), state, lr, **opts)
        if weight_decay:
            param.mul_(decay_factor(lr, weight_decay))
        param.sub_(delta.to(param.dtype))

    def _group_kwargs(self, group) -> dict:
        return {n: group.get(n, getattr(self, "_" + n))
                for n in self._group_opts}

    def _param_group_kwargs(self, p, group) -> dict:
        """The rule's keyword arguments for one (param, group) pair,
        resolved on the host before the rule runs (Lamb's decay
        exclusion hooks in here)."""
        return self._group_kwargs(group)

    @property
    def _parameter_list(self) -> List[torch.Tensor]:
        return [p for g in self._param_groups for p in g["params"]]

    @torch.no_grad()
    def _apply(self, group, params_grads, lr):
        """One update of every ``(param, grad)`` pair of ``group``
        (clipping already done) at the group's effective ``lr``: the rule
        on the f32 master weight where there is one, then the parameter,
        all in place."""
        self._apply_to(group, [(p, p, g) for p, g in params_grads], lr)

    @torch.no_grad()
    def _apply_to(self, group, triples, lr):
        """:meth:`_apply` over ``(param, target, grad)`` triples, where
        ``target`` is the part of ``param`` to update (``param`` itself,
        or, under ZeRO, this rank's rows of it: its state is made from
        ``target`` and holds only those rows)."""
        decay = group.get("weight_decay", self.regularization)
        for p, target, g in triples:
            state = self._state.get(id(p))
            if state is None:
                state = self._state[id(p)] = self._new_state(target)
            master = state.get("master_weight")
            g = g.float() if master is not None else g
            p_arr = target if master is None else master
            if decay is not None and not self._decoupled_decay:
                g = decay(p_arr, g)
            dcoeff = self._decay_coeff_for(p, decay) \
                if self._decoupled_decay else 0.0
            self._update(p_arr, g, state, float(self._param_lr(p, lr)),
                         weight_decay=dcoeff,
                         **self._param_group_kwargs(p, group))
            if master is not None:
                target.copy_(master)

    def _decay_coeff_for(self, p, decay) -> float:
        """Decoupled-decay coefficient of one parameter (AdamW hook)."""
        return decay.coeff if decay is not None else 0.0

    def _param_lr(self, p, lr):
        """Per-parameter lr scaling (AdamW's lr_ratio hook)."""
        return lr

    def step(self):
        """Apply one update to every parameter with a gradient: clip the
        group's gradients, fold in an L1/L2 decay, run the rule (the
        reference's eager ``step``)."""
        self._step_count += 1
        self._state_epoch += 1
        for group in self._param_groups:
            params_grads = [(p, p.grad) for p in group["params"]
                            if p.requires_grad and p.grad is not None]
            if not params_grads:
                continue
            if self._grad_clip is not None:
                params_grads = self._grad_clip(params_grads)
            self._apply(group, params_grads, self._group_lr(group))

    def clear_grad(self, set_to_zero: bool = True):
        """Reset gradients: zero them (Paddle's default), or drop them."""
        for p in self._parameter_list:
            if set_to_zero:
                if p.grad is not None:
                    p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """Dygraph: backward and one step. Static mode: attach this
        optimizer and ``loss`` to the default program, whose
        ``Executor.run`` then takes the gradients of its replayed loss and
        steps (reference :256-288); with no parameters given, the
        trainable ``Parameter`` leaves of the loss's graph are collected.
        Returns ``(None, [(param, grad)])``."""
        import paddle_tpu_torch
        if not paddle_tpu_torch.in_dynamic_mode():
            from paddle_tpu_torch.static.graph import (default_main_program,
                                                       graph_parameters)
            if not self._parameter_list:
                self._param_groups = [{"params": graph_parameters(loss)}]
            prog = default_main_program()
            prog.optimizer = self
            prog.loss = loss
            return None, [(p, None) for p in self._parameter_list]
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in self._parameter_list]

    # -- (de)serialisation ---------------------------------------------------
    def _param_key(self, idx: int, p) -> str:
        return getattr(p, "name", "") or f"param_{idx}"

    def state_dict(self) -> dict:
        """The state by the reference's keys. Tensors are the live state
        (under a fused ``TrainStep`` views of its flat buffers), so they
        always hold current values; copy them to keep a snapshot."""
        sd: dict = {}
        for idx, p in enumerate(self._parameter_list):
            s = self._state.get(id(p))
            if not s:
                continue
            key = self._param_key(idx, p)
            for name, t in s.items():
                sd[f"{key}.{name}"] = t
        sd["@step_count"] = self._step_count
        if isinstance(self._lr, lr_mod.LRScheduler):
            sd["LR_Scheduler"] = self._lr.state_dict()
        return sd

    def set_state_dict(self, state_dict: dict):
        """Load a ``state_dict``: each parameter it names gets new state
        tensors (copies, on the parameter's device), which a fused
        ``TrainStep`` notices and builds its buffers from."""
        sd = dict(state_dict)
        self._step_count = int(sd.pop("@step_count", self._step_count))
        lr_state = sd.pop("LR_Scheduler", None)
        if lr_state is not None and isinstance(self._lr, lr_mod.LRScheduler):
            self._lr.set_state_dict(dict(lr_state))
        by_param: Dict[str, dict] = {}
        for full, v in sd.items():
            key, _, name = full.rpartition(".")
            by_param.setdefault(key, {})[name] = v
        for idx, p in enumerate(self._parameter_list):
            key = self._param_key(idx, p)
            if key in by_param:
                self._state[id(p)] = {
                    n: torch.as_tensor(v).to(p.device).clone()
                    for n, v in by_param[key].items()}
        self._state_epoch += 1

    load_state_dict = set_state_dict

    def __repr__(self):
        return (f"{type(self).__name__}(lr={self.get_lr()}, "
                f"params={len(self._parameter_list)})")
