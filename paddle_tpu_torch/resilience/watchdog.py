"""Hang watchdog — port of ``paddle_tpu/resilience/watchdog.py``:
monotonic deadlines around steps and collectives.

A hung step (a wedged collective, a stuck copy, a dead peer) stalls a
job silently. The watchdog makes it a bounded, observable event:

* :meth:`Watchdog.arm` / :meth:`~Watchdog.disarm` (or the
  :meth:`~Watchdog.watch` context manager) put a monotonic deadline
  around any region. ``FitResilience(step_timeout=)`` arms one around
  each train step; :meth:`~Watchdog.watch_collectives` hooks every
  traced collective span of ``observability.comm`` with its own.
* On expiry the watchdog escalates along ``action``: ``"log"`` (a
  :class:`WatchdogExpired` warning and the metrics), ``"dump"`` (also a
  postmortem JSON naming the stuck span, the rank, the step, with the
  flight recorder's events and the goodput/numerics appendix) and
  ``"kill"`` (also ``os._exit`` with
  :data:`~.preemption.RESUMABLE_EXIT_CODE`, so a launcher restarts the
  job from its last committed checkpoint).
* Metrics: ``resilience_watchdog_expired_total{span}``,
  ``resilience_watchdog_dumps_total``, ``resilience_watchdog_armed``.

The monitor is a daemon thread that sleeps until the nearest deadline;
arming and disarming is a dict insert/pop under a lock. Dumps go to
``trace_dir`` or ``observability.profile``'s trace directory (the
reference's ``PADDLE_TPU_TRACE_DIR``, which the port does not read).
"""
from __future__ import annotations

import json
import os
import threading
import time
import warnings
from typing import Optional

from .counters import watchdog_metrics
from .preemption import RESUMABLE_EXIT_CODE

__all__ = ["Watchdog", "WatchdogExpired"]

_ACTIONS = ("log", "dump", "kill")


class WatchdogExpired(RuntimeWarning):
    """Category for watchdog expiry warnings (filterable in tests)."""


class Watchdog:
    """``action`` picks the escalation rung (each includes the previous):
    ``"log"``, ``"dump"`` (default), ``"kill"``. ``kill_exit_code``
    defaults to the resumable contract; set 1 to make a hang a plain
    failure. ``on_expire(span_dict)`` is an observer hook (tests, custom
    paging) that runs before the action."""

    def __init__(self, default_timeout: float = 300.0, action: str = "dump",
                 registry=None, kill_exit_code: int = RESUMABLE_EXIT_CODE,
                 trace_dir: Optional[str] = None, on_expire=None):
        if action not in _ACTIONS:
            raise ValueError(f"action must be one of {_ACTIONS}")
        self.default_timeout = float(default_timeout)
        self.action = action
        self.kill_exit_code = int(kill_exit_code)
        self.trace_dir = trace_dir
        self.on_expire = on_expire
        self.collective_timeout: Optional[float] = None
        self._m = watchdog_metrics(registry)
        self._lock = threading.Lock()
        self._spans: dict = {}          # token -> span dict
        self._next_token = 0
        self._wake = threading.Event()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.expired: list = []         # expired span dicts (introspection)
        self.last_dump: Optional[str] = None

    # -- arming ------------------------------------------------------------
    def arm(self, name: str, timeout: Optional[float] = None,
            **context) -> int:
        """Start a deadline for ``name``; returns a token for
        :meth:`disarm`. ``context`` (step, rank, ...) lands in the
        postmortem."""
        timeout = self.default_timeout if timeout is None else float(timeout)
        span = {"name": name, "deadline": time.monotonic() + timeout,
                "timeout_s": timeout, "armed_unix": time.time(),
                "context": context, "fired": False}
        with self._lock:
            token = self._next_token
            self._next_token += 1
            self._spans[token] = span
            self._ensure_thread()
        self._m["armed"].set(len(self._spans))
        self._wake.set()
        return token

    def disarm(self, token: int):
        with self._lock:
            self._spans.pop(token, None)
        self._m["armed"].set(len(self._spans))
        self._wake.set()

    def watch(self, name: str, timeout: Optional[float] = None, **context):
        """``with wd.watch("phase"): ...`` — arm/disarm around a block."""
        return _WatchScope(self, name, timeout, context)

    def watch_collectives(self, timeout: Optional[float] = None):
        """Arm every traced collective span (``observability.comm``) with
        ``timeout`` (default: the watchdog's default). The hook is a
        module-global read in ``comm_scope`` — zero cost for processes
        that never call this."""
        self.collective_timeout = (self.default_timeout if timeout is None
                                   else float(timeout))
        from paddle_tpu_torch.observability import comm
        comm._collective_watchdog = self
        return self

    # -- lifecycle ---------------------------------------------------------
    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop = False
            self._thread = threading.Thread(
                target=self._run, name="pt-watchdog", daemon=True)
            self._thread.start()

    def stop(self):
        """Stop the monitor and detach from the collective hook."""
        self._stop = True
        self._wake.set()
        from paddle_tpu_torch.observability import comm
        if getattr(comm, "_collective_watchdog", None) is self:
            comm._collective_watchdog = None
        t = self._thread
        if t is not None:
            t.join(timeout=2)
            self._thread = None
        with self._lock:
            self._spans.clear()
        self._m["armed"].set(0)

    # -- monitor -----------------------------------------------------------
    def _run(self):
        while not self._stop:
            # clear BEFORE reading the span table: an arm() landing after
            # the read re-sets the event and the wait below returns
            # immediately — clearing after the read could eat that signal
            # and sleep forever past a fresh deadline
            self._wake.clear()
            now = time.monotonic()
            fire = []
            nearest = None
            with self._lock:
                for span in self._spans.values():
                    if span["fired"]:
                        continue
                    if span["deadline"] <= now:
                        span["fired"] = True
                        fire.append(dict(span))
                    elif nearest is None or span["deadline"] < nearest:
                        nearest = span["deadline"]
            for span in fire:
                try:
                    self._expire(span)
                except Exception:
                    pass  # the monitor must survive a failed dump
            timeout = None if nearest is None else max(nearest - now, 0.0)
            self._wake.wait(timeout)

    def _expire(self, span: dict):
        span["elapsed_s"] = round(
            span["timeout_s"] + (time.monotonic() - span["deadline"]), 3)
        self.expired.append(span)
        self._m["expired"].inc(span=span["name"])
        info = self._rank_info()
        where = f"rank {info.get('rank', 0)}"
        step = span["context"].get("step")
        at = f" at step {step}" if step is not None else ""
        warnings.warn(
            f"[watchdog] span {span['name']!r} on {where}{at} blew its "
            f"{span['timeout_s']}s deadline (action={self.action})",
            WatchdogExpired, stacklevel=2)
        if self.on_expire is not None:
            self.on_expire(span)
        if self.action in ("dump", "kill"):
            self.last_dump = self._dump(span, info)
            self._m["dumps"].inc()
        if self.action == "kill":
            # a hung process cannot run cleanup; die hard with the
            # resumable code so the launcher restarts from latest_step
            os._exit(self.kill_exit_code)

    # -- postmortem --------------------------------------------------------
    @staticmethod
    def _rank_info() -> dict:
        from paddle_tpu_torch.observability.flight_recorder import \
            _rank_topology
        return _rank_topology()

    def _dump(self, span: dict, info: dict) -> str:
        from paddle_tpu_torch.observability import flight_recorder, profile
        d = self.trace_dir or profile.trace_dir()
        os.makedirs(d, exist_ok=True)
        path = os.path.join(
            d, f"watchdog_rank{info.get('rank', 0)}_{os.getpid()}.json")
        rec = flight_recorder.active()
        doc = {"reason": "watchdog", "unix_time": time.time(), **info,
               "stuck_span": {k: span[k] for k in
                              ("name", "timeout_s", "elapsed_s",
                               "armed_unix", "context")},
               "action": self.action,
               "events": rec.events() if rec is not None else [],
               # the goodput ledger and the last numerics sample
               **flight_recorder._ledger_appendix()}
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        return path


class _WatchScope:
    def __init__(self, wd, name, timeout, context):
        self._wd, self._name, self._timeout = wd, name, timeout
        self._context = context
        self._token = None

    def __enter__(self):
        self._token = self._wd.arm(self._name, self._timeout,
                                   **self._context)
        return self

    def __exit__(self, *exc):
        self._wd.disarm(self._token)
