"""``GradScaler`` — port of ``paddle_tpu/amp/grad_scaler.py``: dynamic
loss scaling (reference ``grad_scaler.py:581``; the unscale step is the
``check_finite_and_unscale`` op of :806).

Unscaling divides each gradient in place and folds whether any value is
not finite into one flag on the gradients' device; the host reads that
flag once a step, to skip the step or not. A skipped step goes through
``resilience.counters.record_nonfinite("grad_scaler")``, the family that
``NaNGuard``'s trips share.
"""
from __future__ import annotations

import torch

__all__ = ["GradScaler", "AmpScaler"]


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._use_dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._use_dynamic

    def scale(self, var):
        """The loss times the current scale (``var`` itself when
        disabled)."""
        if not self._enable:
            return var
        return var * self._scale

    def unscale_(self, optimizer):
        """Divide every gradient by the scale in place and record whether
        any is not finite (one flag on the card, read once)."""
        if not self._enable or self._unscaled:
            return
        inv = 1.0 / self._scale
        found = None
        with torch.no_grad():
            for p in optimizer._parameter_list:
                g = p.grad
                if g is None:
                    continue
                g.mul_(inv)
                bad = ~torch.isfinite(g).all()
                found = bad if found is None else found | bad
        self._found_inf = bool(found) if found is not None else False
        if self._found_inf:
            from paddle_tpu_torch.resilience.counters import \
                record_nonfinite
            record_nonfinite("grad_scaler")
        self._unscaled = True

    def step(self, optimizer):
        """Unscale, then the optimizer's step unless a gradient was not
        finite."""
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()

    def update(self):
        """Move the scale after a step (the reference's
        ``update_loss_scaling``)."""
        if not self._enable or not self._use_dynamic:
            self._unscaled = False
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n_nan_or_inf:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False
        self._unscaled = False

    def minimize(self, optimizer, scaled_loss):
        """The backward has run on the scaled loss: unscale, step and
        update."""
        self.step(optimizer)
        self.update()

    def get_loss_scaling(self) -> float:
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every_n_steps,
                "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
                "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, sd):
        self._scale = float(sd.get("scale", self._scale))
        self._incr_ratio = float(sd.get("incr_ratio", self._incr_ratio))
        self._decr_ratio = float(sd.get("decr_ratio", self._decr_ratio))
        self._incr_every_n_steps = int(
            sd.get("incr_every_n_steps", self._incr_every_n_steps))
        self._decr_every_n_nan_or_inf = int(
            sd.get("decr_every_n_nan_or_inf", self._decr_every_n_nan_or_inf))
        self._good_steps = int(sd.get("good_steps", 0))
        self._bad_steps = int(sd.get("bad_steps", 0))


AmpScaler = GradScaler  # the legacy fluid name
