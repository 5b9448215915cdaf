"""FitResilience — port of ``paddle_tpu/resilience/fit.py``.

One callback that composes the resilience pieces around ``Model.fit``:

* **step checkpoints and resume** — an owned (or given)
  :class:`~paddle_tpu_torch.checkpoint.CheckpointManager`;
  ``save_every_steps`` commits model, optimizer and (with ``pipeline``)
  the data pipeline's state as one step id, asynchronously (the loop
  pays the snapshot). :meth:`restore` resumes from ``latest_step`` on a
  relaunch and keeps the global step numbering going.
* **preemption** — a :class:`~.preemption.PreemptionListener`; when it
  trips, the step in flight finishes, one final blocking save commits,
  and ``fit`` returns with ``exit_code == RESUMABLE_EXIT_CODE``
  (:meth:`exit_if_preempted` exits with it).
* **NaN guard** — loss/grad finiteness and a spike window with rollback
  to the last commit (:class:`~.nan_guard.NaNGuard`). A rollback
  restores weights and optimizer only: the data stream keeps moving.

The state commits under the reference's keys (``"model"``,
``"optimizer"``, ``"data"``; metadata ``global_step``), so a run of
either package resumes from the other's checkpoint.

Not ported yet, raising ``NotImplementedError``: ``step_timeout`` and
``collective_timeout`` (the watchdog), ``elastic=`` (live resharding);
the chaos seams and the numerics calibration state are not ported either.
"""
from __future__ import annotations

import sys
from typing import Optional

from paddle_tpu_torch.hapi.model import Callback

from .nan_guard import NaNGuard, apply_restored_state
from .preemption import RESUMABLE_EXIT_CODE, PreemptionListener

__all__ = ["FitResilience"]


class FitResilience(Callback):
    def __init__(self, checkpoint_dir: Optional[str] = None, manager=None,
                 save_every_steps: Optional[int] = None,
                 keep_last_k: Optional[int] = 3,
                 preemption: bool = True, listener=None,
                 step_timeout: Optional[float] = None,
                 collective_timeout: Optional[float] = None,
                 watchdog_action: str = "dump",
                 nan_guard: bool = False, max_rollbacks: int = 3,
                 spike_window: int = 0, spike_factor: float = 10.0,
                 registry=None, pipeline=None,
                 elastic: bool = False, elastic_listener=None):
        """``pipeline``: a ``DataPipeline`` (or anything with
        ``state_dict``/``load_state_dict``) whose state commits under
        ``"data"`` in every save and is restored by :meth:`restore`."""
        if step_timeout is not None or collective_timeout is not None:
            raise NotImplementedError(
                "step_timeout/collective_timeout (the hang watchdog) are "
                "not ported to paddle_tpu_torch yet")
        if elastic or elastic_listener is not None:
            raise NotImplementedError(
                "elastic resharding is not ported to paddle_tpu_torch yet")
        if manager is None and checkpoint_dir is not None:
            from paddle_tpu_torch.checkpoint import CheckpointManager
            manager = CheckpointManager(checkpoint_dir,
                                        keep_last_k=keep_last_k,
                                        registry=registry)
        self.manager = manager
        self.save_every_steps = save_every_steps
        self._want_preemption = preemption
        self.listener = listener
        self.nan_guard: Optional[NaNGuard] = None
        if nan_guard:
            self.nan_guard = NaNGuard(manager=self.manager,
                                      max_rollbacks=max_rollbacks,
                                      spike_window=spike_window,
                                      spike_factor=spike_factor,
                                      registry=registry)
        self._registry = registry
        self.pipeline = pipeline
        self.preempted = False
        self.final_step: Optional[int] = None
        self._step0 = 0          # global-step offset after a resume
        self._cur_step = 0
        self._installed_listener = False

    # -- resume ------------------------------------------------------------
    def restore(self, model) -> Optional[int]:
        """Resume ``model`` (network and optimizer, on the network's
        device) and the pipeline from the latest committed step; returns
        the step, or None when nothing is committed. Call before
        ``fit``; the global step continues from the restored one."""
        if self.manager is None or self.manager.latest_step() is None:
            return None
        state = self.manager.restore(device=model._device())
        apply_restored_state(model, state)
        if self.pipeline is not None and isinstance(state, dict) and \
                "data" in state:
            self.pipeline.load_state_dict(state["data"])
        restored = self.manager.last_restored_step
        meta = self.manager.metadata(restored)
        self._step0 = int(meta.get("global_step", restored))
        return restored

    @property
    def global_step(self) -> int:
        return self._cur_step

    # -- hooks -------------------------------------------------------------
    def set_model(self, model):
        super().set_model(model)
        if self.nan_guard is not None:
            self.nan_guard.set_model(model)

    def on_train_begin(self, logs=None):
        if self._want_preemption and self.listener is None:
            self.listener = PreemptionListener(registry=self._registry)
        if self.listener is not None and not self._installed_listener:
            self.listener.install()
            self._installed_listener = True

    def on_train_batch_begin(self, step, logs=None):
        self._cur_step = self._step0 + step

    def on_train_batch_end(self, step, logs=None):
        gs = self._cur_step
        if self.nan_guard is not None:
            logs = logs or {}
            self.nan_guard.check(gs, logs.get("loss"),
                                 logs.get("grad_norm"))
        if self.manager is not None and self.save_every_steps and \
                gs % self.save_every_steps == 0:
            self.manager.save(gs, self._state(),
                              metadata={"global_step": gs},
                              overwrite=True)
        if self.listener is not None and not self.preempted and \
                self.listener.should_stop(step=gs):
            self._final_save(gs)

    def on_train_end(self, logs=None):
        if self.manager is not None:
            self.manager.wait_all()
        if self._installed_listener:
            self.listener.uninstall()
            self._installed_listener = False

    # -- the saved state and the preemption stop ---------------------------
    def _state(self) -> dict:
        state = {"model": self.model.network.state_dict()}
        opt = getattr(self.model, "_optimizer", None)
        if opt is not None:
            state["optimizer"] = opt.state_dict()
        if self.pipeline is not None:
            state["data"] = self.pipeline.state_dict()
        return state

    def _final_save(self, gs: int):
        """The preemption commit: blocking (the process is about to
        exit), overwriting a periodic save of the same id."""
        self.preempted = True
        self.final_step = gs
        if self.manager is not None:
            self.manager.save(
                gs, self._state(), async_=False, overwrite=True,
                metadata={"global_step": gs, "preempted": True,
                          "reason": getattr(self.listener, "reason", None)})
        self.model._stop_training = True

    @property
    def exit_code(self) -> int:
        return RESUMABLE_EXIT_CODE if self.preempted else 0

    def exit_if_preempted(self):
        """Trainer-script epilogue: exit with the launcher's resumable
        contract when fit stopped on a preemption."""
        if self.preempted:
            sys.exit(RESUMABLE_EXIT_CODE)
