"""Learning-rate schedulers — port of ``paddle_tpu/optimizer/lr.py``.

The sixteen schedulers of the reference over one ``LRScheduler`` base
with ``step()``/``get_lr()``/``state_dict()``. They are plain host-side
Python float math, kept here as the port's own copy so that every
``lr`` sequence equals the reference's float for float; ``TrainStep``
reads the current value on the host at every step.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

__all__ = [
    "LRScheduler", "NoamDecay", "PiecewiseDecay", "NaturalExpDecay",
    "InverseTimeDecay", "PolynomialDecay", "LinearWarmup", "ExponentialDecay",
    "MultiStepDecay", "StepDecay", "LambdaDecay", "ReduceOnPlateau",
    "CosineAnnealingDecay", "MultiplicativeDecay", "OneCycleLR", "CyclicLR",
    "CosineAnnealingWarmRestarts",
]


class LRScheduler:
    """Base class (reference: ``optimizer/lr.py`` LRScheduler).

    ``last_epoch`` counts calls to ``step()``; ``get_lr()`` is the rule.
    """

    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = self.base_lr
        self.step()  # initialize last_lr at epoch 0 (reference does the same)

    def __call__(self):
        return self.last_lr

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = int(epoch)
        self.last_lr = self.get_lr()
        if self.verbose:
            print(f"Epoch {self.last_epoch}: set learning rate to "
                  f"{self.last_lr}.")

    def get_lr(self) -> float:
        raise NotImplementedError

    def state_dict(self):
        state = {}
        for k, v in self.__dict__.items():
            if k == "verbose" or callable(v):
                continue
            if isinstance(v, (int, float, str, bool, list, tuple, type(None))):
                state[k] = v
        return state

    def set_state_dict(self, state_dict):
        for k, v in state_dict.items():
            if k in self.__dict__:
                self.__dict__[k] = v

    set_dict = set_state_dict


class NoamDecay(LRScheduler):
    """lr = d_model^-0.5 * min(step^-0.5, step * warmup^-1.5) * base_lr."""

    def __init__(self, d_model, warmup_steps, learning_rate=1.0, last_epoch=-1,
                 verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        a = step ** -0.5
        b = step * (self.warmup_steps ** -1.5)
        return self.base_lr * (self.d_model ** -0.5) * min(a, b)


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries: Sequence[int], values: Sequence[float],
                 last_epoch=-1, verbose=False):
        assert len(values) == len(boundaries) + 1
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for i, b in enumerate(self.boundaries):
            if self.last_epoch < b:
                return self.values[i]
        return self.values[-1]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        decay_steps = self.decay_steps
        if self.cycle:
            div = math.ceil(step / float(decay_steps)) if step > 0 else 1
            decay_steps = decay_steps * div
        else:
            step = min(step, decay_steps)
        frac = (1 - step / float(decay_steps)) ** self.power
        return (self.base_lr - self.end_lr) * frac + self.end_lr


class LinearWarmup(LRScheduler):
    """Linear ramp 0→learning_rate over warmup_steps, then the wrapped rate.

    ``learning_rate`` may be a float or another LRScheduler (reference allows
    both; the wrapped scheduler steps once warmup is over).
    """

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr_after = learning_rate  # float or LRScheduler
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        base = learning_rate.base_lr if isinstance(learning_rate, LRScheduler) \
            else float(learning_rate)
        super().__init__(base, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * (
                self.last_epoch / float(self.warmup_steps)) + self.start_lr
        if isinstance(self.lr_after, LRScheduler):
            self.lr_after.step(self.last_epoch - self.warmup_steps)
            return self.lr_after.last_lr
        return float(self.lr_after)

    def state_dict(self):
        state = super().state_dict()
        state.pop("lr_after", None)
        if isinstance(self.lr_after, LRScheduler):
            state["lr_after"] = self.lr_after.state_dict()
        return state

    def set_state_dict(self, state_dict):
        sd = dict(state_dict)  # never mutate the caller's dict
        inner = sd.pop("lr_after", None)
        super().set_state_dict(sd)
        if inner is not None and isinstance(self.lr_after, LRScheduler):
            self.lr_after.set_state_dict(inner)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (self.gamma ** self.last_epoch)


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones: Sequence[int], gamma=0.1,
                 last_epoch=-1, verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if m <= self.last_epoch)
        return self.base_lr * (self.gamma ** n)


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size: int, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (self.gamma ** (self.last_epoch // self.step_size))


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda: Callable[[int], float],
                 last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)


class MultiplicativeDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda: Callable[[int], float],
                 last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        # pure in last_epoch (repeated get_lr() calls and epoch jumps are
        # stable) with an O(1) running product for the sequential-step case
        cached_epoch, cached = getattr(self, "_prod_cache", (0, self.base_lr))
        if self.last_epoch == cached_epoch:
            return cached
        if self.last_epoch > cached_epoch:
            start, cur = cached_epoch, cached
        else:  # backward jump: recompose from scratch
            start, cur = 0, self.base_lr
        for e in range(start + 1, self.last_epoch + 1):
            cur *= self.lr_lambda(e)
        self._prod_cache = (self.last_epoch, cur)
        return cur


class CosineAnnealingDecay(LRScheduler):
    """eta_min + (base - eta_min) * (1 + cos(pi * t / T_max)) / 2."""

    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, learning_rate, T_0, T_mult=1, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_0 = T_0
        self.T_mult = T_mult
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        t = max(self.last_epoch, 0)
        T_i = self.T_0
        while t >= T_i:
            t -= T_i
            T_i *= self.T_mult
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * t / T_i)) / 2


class ReduceOnPlateau(LRScheduler):
    """Reduce LR when a metric stops improving (reference semantics)."""

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        assert mode in ("min", "max")
        assert threshold_mode in ("rel", "abs")
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.epsilon = epsilon
        self.best = None
        self.cooldown_counter = 0
        self.num_bad_epochs = 0
        # ReduceOnPlateau steps on a metric, not a schedule — bypass base init
        self.base_lr = float(learning_rate)
        self.last_lr = float(learning_rate)
        self.last_epoch = 0
        self.verbose = verbose

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            return
        v = float(metrics.item() if hasattr(metrics, "item") else metrics)
        self.last_epoch = self.last_epoch + 1 if epoch is None else epoch
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
        else:
            if self.best is None or self._is_better(v, self.best):
                self.best = v
                self.num_bad_epochs = 0
            else:
                self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                new_lr = max(self.last_lr * self.factor, self.min_lr)
                if self.last_lr - new_lr > self.epsilon:
                    self.last_lr = new_lr
                    if self.verbose:
                        print(f"Epoch {self.last_epoch}: reducing learning "
                              f"rate to {self.last_lr}.")
                self.cooldown_counter = self.cooldown
                self.num_bad_epochs = 0

    def _is_better(self, cur, best):
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return cur < best - best * self.threshold
            return cur < best - self.threshold
        if self.threshold_mode == "rel":
            return cur > best + best * self.threshold
        return cur > best + self.threshold


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3,
                 anneal_strategy="cos", three_phase=False, last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        self.anneal = anneal_strategy
        self.three_phase = three_phase
        super().__init__(self.initial_lr, last_epoch, verbose)

    def _interp(self, start, end, pct):
        if self.anneal == "cos":
            return end + (start - end) * (1 + math.cos(math.pi * pct)) / 2
        return (end - start) * pct + start

    def get_lr(self):
        step = min(self.last_epoch, self.total_steps)
        up = int(self.phase_pct * self.total_steps) - 1
        if self.three_phase:
            down = 2 * up + 1
            if step <= up:
                return self._interp(self.initial_lr, self.max_lr,
                                    step / max(up, 1))
            if step <= down:
                return self._interp(self.max_lr, self.initial_lr,
                                    (step - up) / max(down - up, 1))
            return self._interp(self.initial_lr, self.end_lr,
                                (step - down) / max(
                                    self.total_steps - 1 - down, 1))
        if step <= up:
            return self._interp(self.initial_lr, self.max_lr,
                                step / max(up, 1))
        return self._interp(self.max_lr, self.end_lr,
                            (step - up) / max(self.total_steps - 1 - up, 1))


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate, step_size_up,
                 step_size_down=None, mode="triangular", exp_gamma=1.0,
                 scale_fn=None, scale_mode="cycle", last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.step_up = step_size_up
        self.step_down = step_size_down if step_size_down is not None \
            else step_size_up
        self.mode = mode
        self.exp_gamma = exp_gamma
        self.scale_fn = scale_fn
        self.scale_mode = scale_mode
        super().__init__(base_learning_rate, last_epoch, verbose)

    def _scale(self, x):
        if self.scale_fn is not None:
            return self.scale_fn(x)
        if self.mode == "triangular":
            return 1.0
        if self.mode == "triangular2":
            return 1.0 / (2.0 ** (x - 1))
        return self.exp_gamma ** x

    def get_lr(self):
        total = self.step_up + self.step_down
        cycle = math.floor(1 + self.last_epoch / total)
        pos = self.last_epoch - (cycle - 1) * total
        if pos <= self.step_up:
            pct = pos / self.step_up
        else:
            pct = 1 - (pos - self.step_up) / self.step_down
        amp = (self.max_lr - self.base_lr) * pct
        x = cycle if self.scale_mode == "cycle" else self.last_epoch
        return self.base_lr + amp * self._scale(x)
