"""NaNGuard — port of ``paddle_tpu/resilience/nan_guard.py``.

A fit-loop callback that checks each step's loss (and ``grad_norm`` when
the logs carry it) for finiteness, plus an optional loss-spike window
(loss > ``spike_factor`` x the median of the last ``spike_window``
finite losses). A trip bumps ``resilience_nonfinite_total{kind}`` and
rolls back: in-flight saves are drained, and the last committed
checkpoint is restored, model and optimizer, on the model's device.
Spike detection rests for ``cooldown`` steps after a rollback; more than
``max_rollbacks`` trips raise :class:`NumericError`. Without a committed
checkpoint a trip counts, warns, and fails after ``max_rollbacks``.

After the rollback the guard writes the NaN-provenance file
(``observability.numerics.write_provenance``: the tripped batch replayed
on the restored state, naming the first non-finite tap) while
``numerics.provenance_enabled()``, and moves the discarded steps'
seconds from ``productive`` to ``rollback_discarded`` in the goodput
ledger.
"""
from __future__ import annotations

import math
import warnings
from collections import deque
from typing import Optional

from paddle_tpu_torch.hapi.model import Callback, set_network_state

from .counters import record_nonfinite, rollback_counter

__all__ = ["NaNGuard", "NumericError", "apply_restored_state"]


class NumericError(RuntimeError):
    """Raised when NaNGuard exhausts its rollback budget."""


def apply_restored_state(model, state):
    """Apply a CheckpointManager state tree to a hapi model: the
    ``{"model", "optimizer"}`` pair restores both; a flat dict restores
    model weights only. Shared by the NaN-guard rollback and
    ``FitResilience.restore``."""
    if isinstance(state, dict) and isinstance(state.get("model"), dict):
        set_network_state(model.network, state["model"])
        opt = getattr(model, "_optimizer", None)
        if opt is not None and isinstance(state.get("optimizer"), dict):
            opt.set_state_dict(state["optimizer"])
    elif isinstance(state, dict):
        set_network_state(model.network, state)


class NaNGuard(Callback):
    def __init__(self, manager=None, max_rollbacks: int = 3,
                 spike_window: int = 0, spike_factor: float = 10.0,
                 cooldown: Optional[int] = None, registry=None):
        self.manager = manager
        self.max_rollbacks = int(max_rollbacks)
        self.spike_window = int(spike_window)
        self.spike_factor = float(spike_factor)
        self.cooldown = (self.spike_window if cooldown is None
                         else int(cooldown))
        self.registry = registry
        self.rollbacks = 0
        self.trips: list = []
        self._window: deque = deque(maxlen=max(self.spike_window, 1))
        self._cool = 0

    # -- detection ---------------------------------------------------------
    def _spike(self, loss: float) -> bool:
        if not self.spike_window or self._cool > 0 \
                or len(self._window) < self.spike_window:
            return False
        med = sorted(self._window)[len(self._window) // 2]
        return abs(loss) > self.spike_factor * max(abs(med), 1e-12)

    def check(self, step: int, loss: Optional[float],
              grad_norm: Optional[float] = None) -> Optional[str]:
        """Returns the trip kind (or None); rolls back on a trip."""
        kind = None
        if loss is not None and not math.isfinite(loss):
            kind = "loss_nan"
        elif grad_norm is not None and not math.isfinite(grad_norm):
            kind = "grad_nan"
        elif loss is not None and self._spike(loss):
            kind = "loss_spike"
        if self._cool > 0:
            self._cool -= 1
        if kind is None:
            if loss is not None and math.isfinite(loss):
                self._window.append(loss)
            return None
        record_nonfinite(kind, registry=self.registry)
        self.trips.append({"step": step, "kind": kind, "loss": loss})
        self._rollback(step, kind)
        return kind

    def on_train_batch_end(self, step, logs=None):
        logs = logs or {}
        self.check(step, logs.get("loss"), logs.get("grad_norm"))

    # -- remedy ------------------------------------------------------------
    def _rollback(self, step: int, kind: str):
        self.rollbacks += 1
        if self.rollbacks > self.max_rollbacks:
            raise NumericError(
                f"NaNGuard tripped {self.rollbacks} times (last: {kind} at "
                f"step {step}) — rollback budget ({self.max_rollbacks}) "
                "exhausted; the run is numerically unstable")
        restored = self._restore_last_commit()
        rollback_counter(self.registry).inc()
        provenance = self._write_provenance(step, kind)
        if restored is not None and step > restored:
            # the steps between the restored commit and the trip were
            # thrown away: their productive seconds become badput
            from paddle_tpu_torch.observability import goodput
            goodput.discard_recent_steps(step - restored)
        self._window.clear()
        self._cool = self.cooldown
        warnings.warn(
            f"[nan_guard] {kind} at step {step}: " +
            (f"rolled back to committed step {restored}"
             if restored is not None else
             "no committed checkpoint to roll back to — continuing with "
             "current (possibly poisoned) parameters") +
            f" (rollback {self.rollbacks}/{self.max_rollbacks})" +
            (f"; NaN provenance: {provenance}" if provenance else ""),
            RuntimeWarning, stacklevel=2)

    def _write_provenance(self, step: int, kind: str) -> Optional[str]:
        """The replay of the tripped batch on the restored state
        (``numerics.write_provenance``), while provenance is enabled and
        the model trains through a ``TrainStep``. A failed replay warns:
        provenance is evidence, and must not break the rollback."""
        from paddle_tpu_torch.observability import numerics
        if not numerics.provenance_enabled():
            return None
        train_step = getattr(getattr(self, "model", None),
                             "_train_step", None)
        if train_step is None:
            return None
        try:
            return numerics.write_provenance(train_step, step, kind)
        except Exception as e:  # noqa: BLE001 — reported, not hidden
            warnings.warn(f"[nan_guard] provenance replay failed: {e!r}",
                          RuntimeWarning, stacklevel=2)
            return None

    def _restore_last_commit(self) -> Optional[int]:
        mgr = self.manager
        if mgr is None:
            return None
        # drain in-flight saves first: they were snapshotted at earlier,
        # healthy step boundaries and are the closest rollback points; a
        # failed background save leaves whatever did commit
        mgr.wait_all()
        if mgr.latest_step() is None:
            return None
        model = getattr(self, "model", None)
        device = model._device() if model is not None else None
        state = mgr.restore(device=device)
        if model is not None:
            apply_restored_state(model, state)
        return mgr.last_restored_step
