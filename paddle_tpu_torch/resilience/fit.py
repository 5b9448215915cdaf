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
* **watchdog** — ``step_timeout`` arms a deadline around each train
  step and ``collective_timeout`` one around every traced collective
  (:class:`~.watchdog.Watchdog`); ``watchdog_action`` picks the rung
  (``"log"``, ``"dump"``, ``"kill"``).
* **NaN guard** — loss/grad finiteness and a spike window with rollback
  to the last commit (:class:`~.nan_guard.NaNGuard`), the provenance
  replay and the goodput reclassification. A rollback restores weights
  and optimizer only: the data stream keeps moving.
* **numerics** — while ``observability.numerics.armed()``, every save
  commits the observatory's ``calibration_summary()`` under
  ``"numerics"``, and :meth:`restore` merges it back.
* **chaos** — ``on_train_begin`` re-applies ``resilience.chaos``'s
  configuration (its collective hang hook).

* **elastic** — with ``elastic=True`` (or an ``elastic_listener``), an
  :class:`~.elastic.ElasticResizeListener` is polled after each step;
  at the agreed boundary ``fit`` returns with no checkpoint
  (``resized``, ``resize_target``). :meth:`complete_resize` then runs
  ``elastic.perform_resize`` over the job's store: a departing rank
  exits ``RESIZE_EXIT_CODE`` (83), a survivor takes the exchanged
  model, optimizer and data state, joins the new world's process group
  and returns the new world size, for the caller to rebuild its
  ``TrainStep`` and fit on.

The state commits under the reference's keys (``"model"``,
``"optimizer"``, ``"data"``, ``"numerics"``; metadata
``global_step``), so a run of either package resumes from the other's
checkpoint.
"""
from __future__ import annotations

import sys
from typing import Optional

from paddle_tpu_torch.hapi.model import Callback

from .nan_guard import NaNGuard, apply_restored_state
from .preemption import RESUMABLE_EXIT_CODE, PreemptionListener
from .watchdog import Watchdog

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
        if manager is None and checkpoint_dir is not None:
            from paddle_tpu_torch.checkpoint import CheckpointManager
            manager = CheckpointManager(checkpoint_dir,
                                        keep_last_k=keep_last_k,
                                        registry=registry)
        self.manager = manager
        self.save_every_steps = save_every_steps
        self._want_preemption = preemption
        self.listener = listener
        self.watchdog: Optional[Watchdog] = None
        self._step_timeout = step_timeout
        self._collective_timeout = collective_timeout
        self._watchdog_action = watchdog_action
        self.nan_guard: Optional[NaNGuard] = None
        if nan_guard:
            self.nan_guard = NaNGuard(manager=self.manager,
                                      max_rollbacks=max_rollbacks,
                                      spike_window=spike_window,
                                      spike_factor=spike_factor,
                                      registry=registry)
        self._registry = registry
        self.pipeline = pipeline
        self._want_elastic = elastic
        self.elastic_listener = elastic_listener
        self.preempted = False
        self.resized = False
        self.resize_target: Optional[int] = None
        self.resize_boundary_step: Optional[int] = None
        self.final_step: Optional[int] = None
        self._step0 = 0          # global-step offset after a resume
        self._cur_step = 0
        self._wd_token = None
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
        if isinstance(state, dict) and "numerics" in state:
            # the calibration sketches continue where the previous run
            # left them (sketches merge)
            from paddle_tpu_torch.observability import numerics
            numerics.get_observatory().load_summary(state["numerics"])
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
        from . import chaos
        if chaos.enabled():
            chaos.refresh()
        if self._want_preemption and self.listener is None:
            self.listener = PreemptionListener(registry=self._registry)
        if self._want_elastic and self.elastic_listener is None:
            from .elastic import ElasticResizeListener
            self.elastic_listener = ElasticResizeListener()
        if self.listener is not None and not self._installed_listener:
            self.listener.install()
            self._installed_listener = True
        if self._step_timeout is not None or \
                self._collective_timeout is not None:
            self.watchdog = Watchdog(
                default_timeout=self._step_timeout or 300.0,
                action=self._watchdog_action, registry=self._registry)
            if self._collective_timeout is not None:
                self.watchdog.watch_collectives(self._collective_timeout)

    def on_train_batch_begin(self, step, logs=None):
        self._cur_step = self._step0 + step
        if self.watchdog is not None and self._step_timeout is not None:
            self._wd_token = self.watchdog.arm(
                "train_step", self._step_timeout, step=self._cur_step)

    def on_train_batch_end(self, step, logs=None):
        if self._wd_token is not None:
            self.watchdog.disarm(self._wd_token)
            self._wd_token = None
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
        if self.elastic_listener is not None and not self.preempted and \
                not self.resized and \
                self.elastic_listener.should_resize(step=gs):
            self._resize_stop(gs)

    def on_train_end(self, logs=None):
        if self.manager is not None:
            self.manager.wait_all()
        if self.watchdog is not None:
            self.watchdog.stop()
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
        from paddle_tpu_torch.observability import numerics
        if numerics.armed():
            # the calibration sketches of every sample so far, committed
            # with the weights (apply_restored_state ignores the key)
            summary = numerics.get_observatory().calibration_summary()
            if summary["taps"]:
                state["numerics"] = summary
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

    def _resize_stop(self, gs: int):
        """The elastic boundary: leave ``fit`` with no checkpoint; the
        state stays in memory for :meth:`complete_resize`."""
        self.resized = True
        self.resize_target = self.elastic_listener.target_world
        self.resize_boundary_step = gs
        from paddle_tpu_torch.observability import trace
        trace.mark("elastic", "resize_boundary",
                   args={"step": gs, "target": self.resize_target,
                         "reason": self.elastic_listener.reason})
        self.model._stop_training = True

    def complete_resize(self) -> int:
        """After ``fit`` stopped at a resize boundary: exchange the state
        over the job's store, exit :data:`~.elastic.RESIZE_EXIT_CODE` on
        a departing rank, and on a survivor apply the exchanged model,
        optimizer and data state, re-arm the listener and return the new
        world size (the process group is the new world's, its default
        mesh every rank on ``dp``)."""
        from paddle_tpu_torch.distributed import get_rank, get_world_size
        from paddle_tpu_torch.distributed.tcp_store import job_store
        from .elastic import RESIZE_EXIT_CODE, perform_resize
        if not self.resized:
            raise RuntimeError("complete_resize: fit did not stop at a "
                               "resize boundary")
        state = self._state()
        data = state.pop("data", None)
        new_state, new_data = perform_resize(
            job_store(), state=state, data_state=data,
            world=get_world_size(), rank=get_rank(),
            new_world=self.resize_target,
            generation=self.elastic_listener.generation,
            boundary_step=self.resize_boundary_step,
            device=self.model._device())
        if new_state is None:
            sys.exit(RESIZE_EXIT_CODE)
        apply_restored_state(self.model, new_state)
        if self.pipeline is not None and new_data is not None:
            self.pipeline.load_state_dict(new_data)
        self._step0 = self.resize_boundary_step
        self.elastic_listener.reset()
        self.resized = False
        return int(self.resize_target)

    @property
    def exit_code(self) -> int:
        return RESUMABLE_EXIT_CODE if self.preempted else 0

    def exit_if_preempted(self):
        """Trainer-script epilogue: exit with the launcher's resumable
        contract when fit stopped on a preemption."""
        if self.preempted:
            sys.exit(RESUMABLE_EXIT_CODE)
