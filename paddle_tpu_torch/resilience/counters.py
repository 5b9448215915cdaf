"""Shared resilience metric families — port of
``paddle_tpu/resilience/counters.py``.

``resilience_nonfinite_total{kind}`` (nonfinite events by source),
``resilience_rollbacks_total`` (NaN-guard rollbacks) and
``resilience_preemptions_total{reason}`` (preemption requests by
channel) in the port's metrics registry; the watchdog's family is
declared for the watchdog, which is not ported yet.
"""
from __future__ import annotations

__all__ = ["nonfinite_counter", "record_nonfinite", "rollback_counter",
           "preemption_counter", "watchdog_metrics"]


def _registry(registry=None):
    if registry is not None:
        return registry
    from paddle_tpu_torch.observability.metrics import get_registry
    return get_registry()


def nonfinite_counter(registry=None):
    return _registry(registry).counter(
        "resilience_nonfinite_total",
        "nonfinite numeric events by source kind")


def record_nonfinite(kind: str, n: int = 1, registry=None):
    """The one funnel for every nonfinite detection in the framework —
    GradScaler skipped-scale steps and NaNGuard trips land in the same
    ``resilience_nonfinite_total`` family, split by ``kind``."""
    nonfinite_counter(registry).inc(n, kind=kind)


def rollback_counter(registry=None):
    return _registry(registry).counter(
        "resilience_rollbacks_total",
        "checkpoint rollbacks taken by NaNGuard")


def preemption_counter(registry=None):
    return _registry(registry).counter(
        "resilience_preemptions_total",
        "preemption requests observed, by delivery channel")


def watchdog_metrics(registry=None) -> dict:
    reg = _registry(registry)
    return {
        "expired": reg.counter(
            "resilience_watchdog_expired_total",
            "watchdog deadlines blown, by span name"),
        "dumps": reg.counter(
            "resilience_watchdog_dumps_total",
            "watchdog postmortem dumps written"),
        "armed": reg.gauge(
            "resilience_watchdog_armed",
            "spans currently under a watchdog deadline"),
    }
