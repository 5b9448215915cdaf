"""Metrics registry — port of ``paddle_tpu/observability/metrics.py``.

Labeled Counter / Gauge / Histogram families in a
:class:`MetricsRegistry`, with the reference's label-cardinality guard
(``PADDLE_TPU_METRICS_MAX_LABELSETS``), and the process-wide default
registry (:func:`get_registry`) that the loader (``loader_*``), the data
pipeline (``data_*``), the checkpoint writer (``ckpt_*``) and the
resilience layer (``resilience_*``) record into.

Not ported yet: the Prometheus-text and JSON exposition and the HTTP
exporter (``MetricsExporter``, ``start_exporter``); they raise
``NotImplementedError``. Read a family's values with ``value()``,
``total()`` or ``stats()``.
"""
from __future__ import annotations

import os
import threading
import warnings
from typing import Dict, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "start_exporter", "maybe_start_exporter",
           "MetricsExporter"]

_LabelKey = Tuple[Tuple[str, str], ...]

#: where label-set overflow accumulates once a family hits its cap
OVERFLOW_KEY: _LabelKey = (("overflow", "true"),)

#: default cap on distinct label sets per metric family
DEFAULT_MAX_LABEL_SETS = 1000


def _max_label_sets() -> int:
    """``PADDLE_TPU_METRICS_MAX_LABELSETS``; an unparsable or
    non-positive value keeps the default."""
    val = os.environ.get("PADDLE_TPU_METRICS_MAX_LABELSETS")
    try:
        n = int(val) if val else DEFAULT_MAX_LABEL_SETS
    except ValueError:
        return DEFAULT_MAX_LABEL_SETS
    return n if n > 0 else DEFAULT_MAX_LABEL_SETS


def _label_key(labels: Dict[str, object]) -> _LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._samples: Dict[_LabelKey, object] = {}
        self._max_label_sets = _max_label_sets()
        self._overflow_warned = False

    def _admit(self, key: _LabelKey) -> _LabelKey:
        """Cardinality guard, called with ``self._lock`` held: past the
        cap, new label sets fold into one ``{overflow="true"}`` series."""
        if key in self._samples or \
                len(self._samples) < self._max_label_sets:
            return key
        if not self._overflow_warned:
            self._overflow_warned = True
            warnings.warn(
                f"metric family '{self.name}' hit its label-cardinality "
                f"cap ({self._max_label_sets} distinct label sets); new "
                f"label sets now fold into {{overflow=\"true\"}}",
                RuntimeWarning, stacklevel=4)
        return OVERFLOW_KEY

    def clear(self):
        with self._lock:
            self._samples.clear()
            self._overflow_warned = False


class Counter(_Metric):
    """Monotonically increasing value (per label set)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels):
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        key = _label_key(labels)
        with self._lock:
            key = self._admit(key)
            self._samples[key] = self._samples.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._samples.get(_label_key(labels), 0.0))

    def total(self) -> float:
        """Sum over every label set."""
        with self._lock:
            return float(sum(self._samples.values()))


class Gauge(_Metric):
    """Point-in-time value (per label set)."""

    kind = "gauge"

    def set(self, value: float, **labels):
        key = _label_key(labels)
        with self._lock:
            self._samples[self._admit(key)] = float(value)

    def inc(self, amount: float = 1.0, **labels):
        key = _label_key(labels)
        with self._lock:
            key = self._admit(key)
            self._samples[key] = self._samples.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels):
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._samples.get(_label_key(labels), 0.0))


#: step-time oriented default buckets (seconds)
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0)


class Histogram(_Metric):
    """Cumulative-bucket histogram (per label set)."""

    kind = "histogram"

    def __init__(self, name, help="", buckets: Sequence[float] = None):
        super().__init__(name, help)
        self.buckets = tuple(sorted(buckets if buckets is not None
                                    else DEFAULT_BUCKETS))

    def observe(self, value: float, **labels):
        key = _label_key(labels)
        with self._lock:
            key = self._admit(key)
            st = self._samples.get(key)
            if st is None:
                st = {"counts": [0] * len(self.buckets), "sum": 0.0,
                      "count": 0}
                self._samples[key] = st
            for i, b in enumerate(self.buckets):
                if value <= b:
                    st["counts"][i] += 1
            st["sum"] += float(value)
            st["count"] += 1

    def stats(self, **labels) -> Optional[dict]:
        with self._lock:
            st = self._samples.get(_label_key(labels))
            if st is None:
                return None
            return {"sum": st["sum"], "count": st["count"],
                    "mean": st["sum"] / max(st["count"], 1)}


class MetricsRegistry:
    """Named metric collection."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric '{name}' already registered as {m.kind}")
                return m
            m = cls(name, help, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def names(self):
        with self._lock:
            return sorted(self._metrics)

    def reset(self):
        """Zero every metric's samples (registrations are kept)."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.clear()

    def prometheus_text(self) -> str:
        raise NotImplementedError(
            "the Prometheus exposition is not ported to paddle_tpu_torch "
            "yet; read the families through value()/total()/stats()")

    def to_json(self) -> dict:
        raise NotImplementedError(
            "the JSON exposition is not ported to paddle_tpu_torch yet")


_default = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry."""
    return _default


class MetricsExporter:
    def __init__(self, *a, **kw):
        raise NotImplementedError(
            "the metrics HTTP exporter is not ported to paddle_tpu_torch "
            "yet")


def start_exporter(*a, **kw):
    raise NotImplementedError(
        "the metrics HTTP exporter is not ported to paddle_tpu_torch yet")


def maybe_start_exporter():
    """Env-gated start: ``PADDLE_TPU_METRICS_PORT`` asks for the exporter,
    which is not ported, so a set port raises."""
    port = os.environ.get("PADDLE_TPU_METRICS_PORT")
    if port and port.strip() not in ("", "0"):
        start_exporter(port)
    return None
