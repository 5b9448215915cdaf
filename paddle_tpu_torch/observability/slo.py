"""Declarative serving SLOs with multi-window burn-rate gauges — port of
``paddle_tpu/observability/slo.py``.

Google-SRE-style SLO accounting over the request ledger
(``observability.requests``): each completed request is classified
good/bad against declared targets, and per-SLO **burn rates** are
computed online over a fast and a slow trailing window —
``burn = bad_fraction / error_budget``, so burn 1.0 consumes the budget
exactly at the objective's rate, and the multi-window page rule
("burning 14.4x over BOTH the fast and slow window") becomes a single
``serving_slo_alert`` gauge transition. Computed host-side from ledger
completions only; nothing here touches the serving hot path.

Targets, ``{slo name: (target, objective fraction)}``:

- ``ttft_p99`` — 99% of requests reach their first token within the
  target seconds (bad: ``ttft > target``; a request that failed before
  any token is bad too);
- ``itl_p99`` — 99% of requests keep their own p99 inter-token gap
  under the target seconds (single-token requests are skipped);
- ``success`` — availability objective as a fraction (bad: failed).

The reference arms the monitor from ``PADDLE_TPU_SLO_TTFT_P99_S``,
``_ITL_P99_S``, ``_SUCCESS``, ``_WINDOWS`` and ``_BURN_ALERT``; the port
reads no environment variable: :func:`configure` takes the targets, the
windows (default 300 s and 3600 s) and the page threshold (default
14.4), and :func:`slo_targets` builds the targets from the reference's
three knobs given as arguments.

Families (``serving_slo_*``): targets, per-window burn rates and bad
fractions, the alert gauge, and a good/bad event counter.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional, Tuple

__all__ = ["SloMonitor", "slo_metrics", "slo_targets", "configure",
           "reset", "snapshot", "active"]

#: the armed monitor — ledger completions read this attribute; None =
#: no SLO targets configured
_monitor: Optional["SloMonitor"] = None

DEFAULT_WINDOWS_S = (300.0, 3600.0)
DEFAULT_BURN_ALERT = 14.4

_slo_metrics_cache = None


def slo_metrics(registry=None) -> dict:
    """The ``serving_slo_*`` families (created on first use — mirrors
    ``serving.engine.serving_metrics``)."""
    global _slo_metrics_cache
    if registry is None and _slo_metrics_cache is not None:
        return _slo_metrics_cache
    from .metrics import get_registry
    reg = registry if registry is not None else get_registry()
    d = {
        "target": reg.gauge(
            "serving_slo_target",
            "configured SLO target, by slo (seconds for latency SLOs, "
            "fraction for success)"),
        "burn": reg.gauge(
            "serving_slo_burn_rate",
            "error-budget burn rate by slo and window (fast/slow): "
            "bad_fraction / budget — 1.0 spends the budget exactly at "
            "the objective's rate"),
        "bad_fraction": reg.gauge(
            "serving_slo_bad_fraction",
            "fraction of requests violating the SLO in the window"),
        "alert": reg.gauge(
            "serving_slo_alert",
            "1 while the burn rate exceeds the page threshold over "
            "BOTH windows (the SRE multi-window fast-burn rule)"),
        "events": reg.counter(
            "serving_slo_events_total",
            "ledger completions classified against each SLO, by "
            "verdict (good/bad)"),
    }
    if registry is None:
        _slo_metrics_cache = d
    return d


class SloMonitor:
    """Online multi-window burn-rate accounting over ledger completions.

    ``targets`` maps slo name -> (target value, objective fraction);
    the error budget is ``1 - objective``. Events live in one trailing
    deque per SLO, evicted past the slow window; gauges refresh on
    every observation and on :meth:`snapshot` (so an idle system's burn
    rate decays as its window drains)."""

    def __init__(self, targets: Dict[str, Tuple[float, float]],
                 windows_s: Tuple[float, float] = DEFAULT_WINDOWS_S,
                 alert_threshold: float = DEFAULT_BURN_ALERT):
        if not targets:
            raise ValueError("SloMonitor needs at least one target")
        fast, slow = float(windows_s[0]), float(windows_s[1])
        if fast <= 0 or slow < fast:
            raise ValueError(
                f"windows must satisfy 0 < fast <= slow, got "
                f"{windows_s}")
        self.targets = dict(targets)
        self.windows_s = (fast, slow)
        self.alert_threshold = float(alert_threshold)
        self._lock = threading.Lock()
        self._events: Dict[str, deque] = {n: deque() for n in targets}
        self._m = slo_metrics()
        for name, (target, _obj) in self.targets.items():
            self._m["target"].set(target, slo=name)

    # -- classification ----------------------------------------------------
    def _verdict(self, name: str, rec) -> Optional[bool]:
        """True = bad, False = good, None = not applicable."""
        target, _obj = self.targets[name]
        failed = rec.state == "failed"
        if name == "ttft_p99":
            if rec.ttft_s is None:
                return True if failed else None
            return rec.ttft_s > target
        if name == "itl_p99":
            p99 = rec.itl_percentile(0.99)
            return None if p99 is None else p99 > target
        if name == "success":
            return failed
        return None

    def observe(self, rec, now: Optional[float] = None):
        """Classify one completed :class:`~.requests.RequestRecord`
        against every armed SLO and refresh the gauges."""
        now = time.monotonic() if now is None else now
        with self._lock:
            for name in self.targets:
                bad = self._verdict(name, rec)
                if bad is None:
                    continue
                self._events[name].append((now, bool(bad)))
                self._m["events"].inc(slo=name,
                                      verdict="bad" if bad else "good")
            self._recompute(now)

    # -- burn-rate math ----------------------------------------------------
    def _recompute(self, now: float):
        """Gauge refresh (lock held)."""
        fast, slow = self.windows_s
        for name, (_target, objective) in self.targets.items():
            ev = self._events[name]
            while ev and now - ev[0][0] > slow:
                ev.popleft()
            budget = max(1.0 - objective, 1e-9)
            burns = {}
            for wname, wlen in (("fast", fast), ("slow", slow)):
                in_w = [bad for (t, bad) in ev if now - t <= wlen]
                frac = (sum(in_w) / len(in_w)) if in_w else 0.0
                burns[wname] = frac / budget
                self._m["burn"].set(round(burns[wname], 4),
                                    slo=name, window=wname)
                self._m["bad_fraction"].set(round(frac, 4),
                                            slo=name, window=wname)
            alerting = (burns["fast"] >= self.alert_threshold
                        and burns["slow"] >= self.alert_threshold)
            self._m["alert"].set(1.0 if alerting else 0.0, slo=name)

    def snapshot(self, now: Optional[float] = None) -> dict:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._recompute(now)
            out = {"enabled": True,
                   "windows_s": list(self.windows_s),
                   "alert_threshold": self.alert_threshold,
                   "slos": {}}
            for name, (target, objective) in self.targets.items():
                out["slos"][name] = {
                    "target": target,
                    "objective": objective,
                    "events_in_window": len(self._events[name]),
                    "burn_rate": {
                        "fast": self._m["burn"].value(slo=name,
                                                      window="fast"),
                        "slow": self._m["burn"].value(slo=name,
                                                      window="slow")},
                    "alerting": bool(
                        self._m["alert"].value(slo=name) >= 1.0),
                }
            return out


# ---------------------------------------------------------------------------
# module seam
# ---------------------------------------------------------------------------

def slo_targets(ttft_p99_s: Optional[float] = None,
                itl_p99_s: Optional[float] = None,
                success: Optional[float] = None
                ) -> Dict[str, Tuple[float, float]]:
    """The targets the reference builds from ``PADDLE_TPU_SLO_TTFT_P99_S``,
    ``_ITL_P99_S`` and ``_SUCCESS``: a latency target > 0 at objective
    0.99, an availability objective strictly inside (0, 1); anything
    else leaves that SLO untracked."""
    targets: Dict[str, Tuple[float, float]] = {}
    for name, t in (("ttft_p99", ttft_p99_s), ("itl_p99", itl_p99_s)):
        if t is not None and float(t) > 0:
            targets[name] = (float(t), 0.99)
    if success is not None and 0.0 < float(success) < 1.0:
        targets["success"] = (float(success), float(success))
    return targets


def configure(targets: Dict[str, Tuple[float, float]],
              windows_s: Tuple[float, float] = DEFAULT_WINDOWS_S,
              alert_threshold: float = DEFAULT_BURN_ALERT) -> "SloMonitor":
    """Arm the process monitor that ledger completions feed."""
    global _monitor
    _monitor = SloMonitor(targets, windows_s=windows_s,
                          alert_threshold=alert_threshold)
    return _monitor


def reset():
    """Disarm."""
    global _monitor
    _monitor = None


def active() -> Optional["SloMonitor"]:
    return _monitor


def snapshot() -> dict:
    mon = _monitor
    if mon is None:
        return {"enabled": False}
    return mon.snapshot()
