"""Preemption-aware training — port of
``paddle_tpu/resilience/preemption.py``.

:class:`PreemptionListener` turns a preemption notice into a graceful
stop: SIGTERM/SIGUSR1 handlers that only set a flag (the fit loop
finishes the step in flight, ``FitResilience`` takes one final blocking
save and ``fit`` returns), and the maintenance-notice seam — the file
named by ``PADDLE_TPU_PREEMPTION_FILE`` existing, or
``PADDLE_TPU_PREEMPTION_NOTICE`` set — polled at each step boundary.
:data:`RESUMABLE_EXIT_CODE` (79) is the contract with the launcher: the
trainer was preempted after committing a resumable checkpoint, and
``distributed.launch`` relaunches it without spending the crash budget.

Across ranks the listener agrees on a *consensus stop step* over the
job's TCPStore (reference :162-265): the first rank to see a notice wins
an atomic claim (``store.add`` on ``__preempt/{epoch}/armed``) and
publishes ``stop = its step + 1`` under :func:`preempt_stop_key`; every
rank keeps stepping until its own step reaches it, so all of them take
the final save at the same step. Every store call happens in
``should_stop``, never in the signal handler. ``use_store=None`` uses
the store when ``init_parallel_env`` joined a launched job
(``distributed.env.launched_job``); the epoch is that job's restart
epoch.

The listener does not chain SIGTERM to a handler installed before it.
"""
from __future__ import annotations

import os
import signal
import sys
import threading
import time
from typing import Optional

__all__ = ["RESUMABLE_EXIT_CODE", "PreemptionListener",
           "preempt_stop_key"]

#: Exit status meaning "preempted, checkpoint committed, restart me from
#: latest_step". 79 sits just past the sysexits.h range (64-78) and far
#: from the signal-death codes (128+n / negative Popen returncodes), so it
#: can never be confused with a crash.
RESUMABLE_EXIT_CODE = 79

#: store key prefix of the consensus, namespaced by the restart epoch
STORE_KEY = "__preempt"

NOTICE_ENV = "PADDLE_TPU_PREEMPTION_NOTICE"
NOTICE_FILE_ENV = "PADDLE_TPU_PREEMPTION_FILE"


def _launched_job():
    """The launched job ``init_parallel_env`` joined (None before it, or
    when ``paddle_tpu_torch.distributed`` was never imported)."""
    env = sys.modules.get("paddle_tpu_torch.distributed.env")
    return env.launched_job() if env is not None else None


def _store_key() -> str:
    job = _launched_job()
    return f"{STORE_KEY}/{job.epoch if job is not None else '0'}"


def preempt_stop_key(epoch) -> str:
    """The consensus verdict's key for ``epoch``, which the launcher
    probes to tell a peer's preemption from a crash."""
    return f"{STORE_KEY}/{epoch}/stop"


class PreemptionListener:
    """Flag-setting preemption observer; poll :meth:`should_stop` at step
    boundaries.

    ``signals``: handled signal numbers (default SIGTERM + SIGUSR1;
    handlers install only on the main thread). ``notice_file``: the path
    whose existence is the maintenance notice (default
    ``$PADDLE_TPU_PREEMPTION_FILE``). ``check_interval``: least seconds
    between notice polls inside ``should_stop`` (0 polls every call;
    the store is read every call). ``use_store``: agree on the stop step
    over the job's TCPStore (default: when a launched job is joined).
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGUSR1),
                 notice_file: Optional[str] = None,
                 use_store: Optional[bool] = None,
                 check_interval: float = 0.0,
                 registry=None):
        self._signals = tuple(signals)
        self._notice_file = notice_file
        self._check_interval = float(check_interval)
        self._registry = registry
        # plain attributes, not an Event: they are written in signal
        # context, where taking a lock can deadlock against the
        # interrupted main thread holding it
        self._flagged = False
        self._note_pending = False
        self.reason: Optional[str] = None
        self._prev_handlers: dict = {}
        self._installed = False
        self._last_poll = 0.0
        self._use_store = use_store
        self._store = None
        self._store_failed = False
        self._broadcast_done = False
        self._stop_decided = False

    # -- lifecycle ---------------------------------------------------------
    def install(self) -> "PreemptionListener":
        """Install the signal handlers (idempotent; main thread only —
        elsewhere only the notice channels are active)."""
        if self._installed:
            return self
        if threading.current_thread() is threading.main_thread():
            for sn in self._signals:
                self._prev_handlers[sn] = signal.signal(sn, self._handler)
        self._installed = True
        return self

    def uninstall(self):
        for sn, prev in self._prev_handlers.items():
            signal.signal(sn, prev)
        self._prev_handlers.clear()
        self._installed = False

    def __enter__(self) -> "PreemptionListener":
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()

    # -- channels ----------------------------------------------------------
    def _handler(self, sn, frame):
        # installed over the flight recorder's handler: its postmortem
        # still gets written (flight_recorder.dump_on_signal)
        from paddle_tpu_torch.observability import flight_recorder
        flight_recorder.dump_on_signal(sn, self._prev_handlers.get(sn))
        # signal context: attribute writes only; the metric is bumped at
        # the next should_stop poll
        if not self._flagged:
            self.reason = signal.Signals(sn).name
            self._note_pending = True
            self._flagged = True

    def request(self, reason: str, broadcast: bool = True):
        """Mark this process preempted (the programmatic seam); the store
        broadcast happens at the next ``should_stop``."""
        if not self._flagged:
            self.reason = reason
            self._note_pending = True
            self._flagged = True
        if not broadcast:
            self._broadcast_done = True
        self._note()

    def _note(self):
        """Count the preemption (ordinary context only)."""
        if not self._note_pending:
            return
        self._note_pending = False
        from .counters import preemption_counter
        preemption_counter(self._registry).inc(reason=self.reason)
        from paddle_tpu_torch.observability import flight_recorder as fr
        t = time.perf_counter_ns()
        fr.record(fr.KIND_USER, f"preempt:{self.reason}", t, t)

    def _job_store(self):
        if self._store is not None or self._store_failed:
            return self._store
        use = self._use_store
        if use is None:
            use = _launched_job() is not None
        if not use:
            self._store_failed = True
            return None
        from paddle_tpu_torch.distributed.tcp_store import job_store
        self._store = job_store()  # use_store=True without a store raises
        return self._store

    def _poll_notice(self):
        if os.environ.get(NOTICE_ENV, "").strip() not in ("", "0"):
            self.request("notice_env")
        path = self._notice_file or os.environ.get(NOTICE_FILE_ENV)
        if path and os.path.exists(path):
            self.request("notice_file")

    # -- the step-boundary query ------------------------------------------
    def should_stop(self, step: Optional[int] = None) -> bool:
        """Poll at a step boundary (``step``: the caller's global step).
        With a job store, True once the cluster's stop step is reached,
        at the same boundary on every rank; without one (or with
        ``step=None``) a notice seen here stops at once."""
        if self._stop_decided:
            return True
        self._note()
        now = time.monotonic()
        if now - self._last_poll >= self._check_interval:
            self._last_poll = now
            self._poll_notice()
        store = self._job_store()
        if store is None:
            self._stop_decided = self._flagged
            return self._stop_decided
        try:
            key = _store_key()
            if self._flagged and not self._broadcast_done:
                # one rank (the atomic claim) publishes the stop step, one
                # past its own, so peers still in this step see it in time
                if int(store.add(key + "/armed", 1)) == 1:
                    stop_at = 0 if step is None else int(step) + 1
                    store.set(key + "/stop",
                              f"{stop_at}:{self.reason or '?'}".encode())
                self._broadcast_done = True
            v = store.get(key + "/stop")
        except (OSError, RuntimeError):
            # a dead control plane must not kill the step: stop on what
            # this rank saw itself
            self._store_failed = True
            self._stop_decided = self._flagged
            return self._stop_decided
        if v is None:
            return False
        stop_s, _, reason = v.decode(errors="replace").partition(":")
        if not self._flagged:
            self.request(f"store:{reason}", broadcast=False)
        stop_at = int(stop_s)
        if step is None or stop_at == 0 or int(step) >= stop_at:
            self._stop_decided = True
        return self._stop_decided

    @property
    def preempted(self) -> bool:
        return self._flagged

    def exit_resumable(self):
        """Terminate with the launcher's resumable contract."""
        sys.exit(RESUMABLE_EXIT_CODE)
