"""Preemption-aware training — port of
``paddle_tpu/resilience/preemption.py``.

:class:`PreemptionListener` turns a preemption notice into a graceful
stop: SIGTERM/SIGUSR1 handlers that only set a flag (the fit loop
finishes the step in flight, ``FitResilience`` takes one final blocking
save and ``fit`` returns), and the maintenance-notice seam — the file
named by ``PADDLE_TPU_PREEMPTION_FILE`` existing, or
``PADDLE_TPU_PREEMPTION_NOTICE`` set — polled at each step boundary.
:data:`RESUMABLE_EXIT_CODE` (79) is the contract with a launcher: the
trainer was preempted after committing a resumable checkpoint.

The listener does not chain SIGTERM to a handler installed before it.

Not ported yet: the job-store consensus stop step across ranks
(``use_store=True``, or ``PADDLE_MASTER`` in the environment, raises
``NotImplementedError``); one process stops at the step boundary where
it sees the notice.
"""
from __future__ import annotations

import os
import signal
import sys
import threading
import time
from typing import Optional

__all__ = ["RESUMABLE_EXIT_CODE", "PreemptionListener"]

#: Exit status meaning "preempted, checkpoint committed, restart me from
#: latest_step". 79 sits just past the sysexits.h range (64-78) and far
#: from the signal-death codes (128+n / negative Popen returncodes), so it
#: can never be confused with a crash.
RESUMABLE_EXIT_CODE = 79

NOTICE_ENV = "PADDLE_TPU_PREEMPTION_NOTICE"
NOTICE_FILE_ENV = "PADDLE_TPU_PREEMPTION_FILE"


class PreemptionListener:
    """Flag-setting preemption observer; poll :meth:`should_stop` at step
    boundaries.

    ``signals``: handled signal numbers (default SIGTERM + SIGUSR1;
    handlers install only on the main thread). ``notice_file``: the path
    whose existence is the maintenance notice (default
    ``$PADDLE_TPU_PREEMPTION_FILE``). ``check_interval``: least seconds
    between notice polls inside ``should_stop`` (0 polls every call).
    ``use_store`` is the reference's cross-rank consensus, not ported.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGUSR1),
                 notice_file: Optional[str] = None,
                 use_store: Optional[bool] = None,
                 check_interval: float = 0.0,
                 registry=None):
        if use_store or (use_store is None and
                         os.environ.get("PADDLE_MASTER")):
            raise NotImplementedError(
                "the job-store preemption consensus (use_store, "
                "PADDLE_MASTER) is not ported to paddle_tpu_torch yet")
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
        # signal context: attribute writes only; the metric is bumped at
        # the next should_stop poll
        if not self._flagged:
            self.reason = signal.Signals(sn).name
            self._note_pending = True
            self._flagged = True

    def request(self, reason: str):
        """Mark this process preempted (the programmatic seam)."""
        if not self._flagged:
            self.reason = reason
            self._note_pending = True
            self._flagged = True
        self._note()

    def _note(self):
        """Count the preemption (ordinary context only)."""
        if not self._note_pending:
            return
        self._note_pending = False
        from .counters import preemption_counter
        preemption_counter(self._registry).inc(reason=self.reason)

    def _poll_notice(self):
        if os.environ.get(NOTICE_ENV, "").strip() not in ("", "0"):
            self.request("notice_env")
        path = self._notice_file or os.environ.get(NOTICE_FILE_ENV)
        if path and os.path.exists(path):
            self.request("notice_file")

    # -- the step-boundary query ------------------------------------------
    def should_stop(self, step: Optional[int] = None) -> bool:
        """Poll at a step boundary: True once a signal or a notice was
        seen (``step`` is the caller's global step, kept for the
        reference's signature)."""
        self._note()
        now = time.monotonic()
        if now - self._last_poll >= self._check_interval:
            self._last_poll = now
            self._poll_notice()
        return self._flagged

    @property
    def preempted(self) -> bool:
        return self._flagged

    def exit_resumable(self):
        """Terminate with the launcher's resumable contract."""
        sys.exit(RESUMABLE_EXIT_CODE)
