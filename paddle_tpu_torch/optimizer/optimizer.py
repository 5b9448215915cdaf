"""Optimizer base class — port of ``paddle_tpu/optimizer/optimizer.py``.

Parameter groups, a float learning rate, weight decay (an L2
regularizer, or AdamW's decoupled coefficient), gradient clipping, f32
master weights for bf16/f16 parameters (``multi_precision``) and
``state_dict``/``set_state_dict`` with the reference's per-parameter
keys (``param_<i>.moment1``, ..., ``@step_count``).

The reference's update rules are pure functions over immutable arrays;
here each rule updates its parameter, master weight and moments in
place, which keeps one copy of the optimizer state in device memory, in
the reference's order of operations. Learning-rate schedulers are not
ported yet.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from paddle_tpu_torch.regularizer import L2Decay, WeightDecayRegularizer

__all__ = ["Optimizer"]


class Optimizer:
    # per-group hyperparameter names (beyond learning_rate/weight_decay)
    # that the rule receives as keyword arguments
    _group_opts = ()

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError("parameters is required: pass "
                             "model.parameters()")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "learning-rate schedulers are not ported to "
                "paddle_tpu_torch yet; pass a float")
        self._lr = float(learning_rate)
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

    # -- decay / lr ----------------------------------------------------------
    @staticmethod
    def _make_decay(weight_decay):
        if weight_decay is None:
            return None
        if isinstance(weight_decay, WeightDecayRegularizer):
            return weight_decay
        return L2Decay(float(weight_decay))

    def get_lr(self) -> float:
        return self._lr

    def set_lr(self, value: float):
        self._lr = float(value)

    def set_lr_scheduler(self, scheduler):
        raise NotImplementedError(
            "learning-rate schedulers are not ported to paddle_tpu_torch "
            "yet")

    # -- accumulators --------------------------------------------------------
    def _needs_master(self, p) -> bool:
        return self._multi_precision and p.dtype in (torch.bfloat16,
                                                     torch.float16)

    def _ensure_state(self, p) -> Dict[str, torch.Tensor]:
        s = self._state.get(id(p))
        if s is None:
            s = self._create_state(p)
            if self._needs_master(p):
                s["master_weight"] = p.detach().float().clone()
            self._state[id(p)] = s
        return s

    def _create_state(self, p) -> Dict[str, torch.Tensor]:
        """Per-parameter accumulator init (subclass hook)."""
        return {}

    # -- the update ----------------------------------------------------------
    def _update_delta(self, grad, state, lr, **opts):
        """The rule's step ``delta`` (``new = param - delta``), updating
        ``state`` in place. ``grad`` arrives cast to the accumulator
        dtype."""
        raise NotImplementedError

    def _group_kwargs(self, group) -> dict:
        return {n: group.get(n, getattr(self, "_" + n))
                for n in self._group_opts}

    def _group_lr(self, group) -> float:
        """The effective lr of a group: its ``learning_rate`` scales the
        optimizer's."""
        return group["learning_rate"] * self.get_lr() \
            if "learning_rate" in group else self.get_lr()

    @property
    def _parameter_list(self) -> List[torch.Tensor]:
        return [p for g in self._param_groups for p in g["params"]]

    @torch.no_grad()
    def _apply(self, group, params_grads):
        """One update of every ``(param, grad)`` pair of ``group``
        (clipping already done): the rule on the f32 master weight where
        there is one, then the parameter, all in place."""
        lr = self._group_lr(group)
        decay = group.get("weight_decay", self.regularization)
        kw = self._group_kwargs(group)
        for p, g in params_grads:
            state = self._ensure_state(p)
            master = state.get("master_weight")
            g = g.float() if master is not None else g
            p_arr = p if master is None else master
            if decay is not None and not self._decoupled_decay:
                g = decay(p_arr, g)
            dcoeff = self._decay_coeff_for(p, decay) \
                if self._decoupled_decay else 0.0
            plr = self._param_lr(p, lr)
            delta = self._update_delta(g.to(p_arr.dtype), state, plr, **kw)
            if dcoeff:
                # decoupled decay, in f32 as the reference's compiled step
                # computes 1 - lr * coeff
                p_arr.mul_(float(np.float32(1.0) - np.float32(plr)
                                 * np.float32(dcoeff)))
            p_arr.sub_(delta.to(p_arr.dtype))
            if master is not None:
                p.copy_(master)

    def _decay_coeff_for(self, p, decay) -> float:
        """Decoupled-decay coefficient of one parameter (AdamW hook)."""
        return decay.coeff if decay is not None else 0.0

    def _param_lr(self, p, lr: float) -> float:
        """Per-parameter lr scaling (AdamW's lr_ratio hook)."""
        return lr

    def step(self):
        """Apply one update to every parameter with a gradient: clip the
        group's gradients, fold in an L2 decay, run the rule (the
        reference's eager ``step``)."""
        self._step_count += 1
        for group in self._param_groups:
            params_grads = [(p, p.grad) for p in group["params"]
                            if p.requires_grad and p.grad is not None]
            if not params_grads:
                continue
            if self._grad_clip is not None:
                params_grads = self._grad_clip(params_grads)
            self._apply(group, params_grads)

    def clear_grad(self, set_to_zero: bool = True):
        """Reset gradients: zero them (Paddle's default), or drop them."""
        for p in self._parameter_list:
            if set_to_zero:
                if p.grad is not None:
                    p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    # -- (de)serialisation ---------------------------------------------------
    def _param_key(self, idx: int, p) -> str:
        return getattr(p, "name", "") or f"param_{idx}"

    def state_dict(self) -> dict:
        sd: dict = {}
        for idx, p in enumerate(self._parameter_list):
            s = self._state.get(id(p))
            if not s:
                continue
            key = self._param_key(idx, p)
            for name, t in s.items():
                sd[f"{key}.{name}"] = t
        sd["@step_count"] = self._step_count
        return sd

    def set_state_dict(self, state_dict: dict):
        sd = dict(state_dict)
        self._step_count = int(sd.pop("@step_count", self._step_count))
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

    load_state_dict = set_state_dict

    def __repr__(self):
        return (f"{type(self).__name__}(lr={self.get_lr()}, "
                f"params={len(self._parameter_list)})")
