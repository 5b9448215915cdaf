"""Metrics registry — port of ``paddle_tpu/observability/metrics.py``.

Labeled Counter / Gauge / Histogram families in a
:class:`MetricsRegistry`, with the reference's label-cardinality guard
(``PADDLE_TPU_METRICS_MAX_LABELSETS``), and the process-wide default
registry (:func:`get_registry`) that the loader (``loader_*``), the data
pipeline (``data_*``), the checkpoint writer (``ckpt_*``), the
resilience layer (``resilience_*``) and the serving engine
(``serving_*``) record into.

Two exposition sinks render a registry, byte for byte as the
reference's: Prometheus text (``prometheus_text``) and a JSON document
(``to_json``). :class:`MetricsExporter` serves both over stdlib HTTP
(``/metrics``, ``/metrics.json``) with ``/healthz``, ``/statusz`` and
``/fleetz`` (``observability.fleet.fleetz_snapshot``).
``start_exporter``'s host is an argument (loopback by default): the
reference's ``PADDLE_TPU_METRICS_HOST`` is not read.
"""
from __future__ import annotations

import json
import os
import threading
import warnings
from typing import Dict, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "start_exporter", "maybe_start_exporter",
           "MetricsExporter", "stop_exporter"]

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


def _escape_label(v: str) -> str:
    """Prometheus label-value escaping: backslash, quote, newline."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _render_labels(key: _LabelKey, extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(v)}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


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


def _snapshot(m: _Metric):
    """Sorted ``(labels, value)`` items copied under the metric's lock: a
    histogram's sample dict is live state, so a scrape must not read it
    after the lock is released."""
    with m._lock:
        return sorted(
            (k, dict(v, counts=list(v["counts"])) if isinstance(v, dict)
             else v)
            for k, v in m._samples.items())


class MetricsRegistry:
    """Named metric collection with Prometheus-text and JSON exposition."""

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

    def _metric_snapshot(self):
        """Sorted ``(name, metric)`` pairs under the registry lock, so a
        scrape never iterates the dict while a family is registered."""
        with self._lock:
            return sorted(self._metrics.items())

    # -- exposition -----------------------------------------------------------
    def prometheus_text(self) -> str:
        lines = []
        for name, m in self._metric_snapshot():
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            items = _snapshot(m)
            if isinstance(m, Histogram):
                for key, st in items:
                    # per-bucket counts are already cumulative
                    for b, c in zip(m.buckets, st["counts"]):
                        le = 'le="%s"' % b
                        lines.append(
                            f"{name}_bucket{_render_labels(key, le)} {c}")
                    inf = 'le="+Inf"'
                    lines.append(
                        f"{name}_bucket{_render_labels(key, inf)} "
                        f"{st['count']}")
                    lines.append(
                        f"{name}_sum{_render_labels(key)} {st['sum']}")
                    lines.append(
                        f"{name}_count{_render_labels(key)} {st['count']}")
            else:
                for key, v in items:
                    lines.append(f"{name}{_render_labels(key)} {v}")
        return "\n".join(lines) + "\n"

    def to_json(self) -> dict:
        """Structured exposition: one entry per metric, its samples with
        label dicts."""
        out = {}
        for name, m in self._metric_snapshot():
            samples = []
            for key, v in _snapshot(m):
                entry = {"labels": dict(key)}
                if isinstance(m, Histogram):
                    entry.update({"sum": v["sum"], "count": v["count"],
                                  "buckets": dict(zip(
                                      (str(b) for b in m.buckets),
                                      v["counts"]))})
                else:
                    entry["value"] = v
                samples.append(entry)
            out[name] = {"type": m.kind, "help": m.help, "samples": samples}
        return out


_default = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry."""
    return _default


class MetricsExporter:
    """Background HTTP exposition server (daemon thread): ``/metrics``
    (Prometheus text), ``/metrics.json``, ``/healthz`` (rank, job id and
    the age of the last step), ``/statusz`` (SLO burn rates and the
    request ledger; ``?format=json`` for the raw payload) and
    ``/fleetz`` (the single-process fleet document), on ``port``
    (0 picks an ephemeral port; ``self.port`` holds the bound one)."""

    def __init__(self, port: int, registry: Optional[MetricsRegistry] = None,
                 host: str = "127.0.0.1"):
        import http.server

        registry = registry or get_registry()

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API)
                # lazy imports: metrics is the substrate the other
                # observability modules import
                code = 200
                if self.path.startswith("/metrics.json"):
                    body = json.dumps(registry.to_json()).encode()
                    ctype = "application/json"
                elif self.path.startswith("/metrics"):
                    body = registry.prometheus_text().encode()
                    ctype = "text/plain; version=0.0.4"
                elif self.path.startswith("/fleetz"):
                    from . import fleet
                    body = json.dumps(fleet.fleetz_snapshot()).encode()
                    ctype = "application/json"
                elif self.path.startswith("/healthz"):
                    from . import fleet
                    body = json.dumps(
                        {"status": "ok", **fleet.healthz_fields()}).encode()
                    ctype = "application/json"
                elif self.path.startswith("/statusz"):
                    from . import requests as obs_requests
                    payload = obs_requests.statusz_payload()
                    if "format=json" in self.path:
                        body = json.dumps(payload).encode()
                        ctype = "application/json"
                    else:
                        body = obs_requests.render_statusz_html(
                            payload).encode()
                        ctype = "text/html; charset=utf-8"
                else:
                    self.send_error(404)
                    return
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # keep test output quiet
                pass

        self.registry = registry
        self._server = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="pt-metrics-exporter",
            daemon=True)
        self._thread.start()

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)


_exporter_state = {"exporter": None}


def start_exporter(port: int, registry: Optional[MetricsRegistry] = None,
                   host: str = "127.0.0.1") -> MetricsExporter:
    """Start (or return the already-running) exposition server; a second
    call asking for another port or registry warns and keeps the first."""
    existing = _exporter_state["exporter"]
    if existing is not None:
        if (port and port != existing.port) or \
                (registry is not None and registry is not existing.registry):
            warnings.warn(
                f"metrics exporter already running on port {existing.port} "
                f"with its own registry; ignoring start_exporter(port="
                f"{port}) — stop_exporter() first to rebind",
                RuntimeWarning, stacklevel=2)
        return existing
    _exporter_state["exporter"] = MetricsExporter(port, registry, host=host)
    return _exporter_state["exporter"]


def maybe_start_exporter() -> Optional[MetricsExporter]:
    """Env-gated start: a no-op unless ``PADDLE_TPU_METRICS_PORT`` holds
    a positive port (an unparsable value is off, and a taken port keeps
    whatever runs)."""
    port = os.environ.get("PADDLE_TPU_METRICS_PORT")
    try:
        port_n = int(port) if port else 0
    except ValueError:
        port_n = 0
    if port_n <= 0:
        return _exporter_state["exporter"]
    try:
        return start_exporter(port_n)
    except OSError:
        return _exporter_state["exporter"]


def stop_exporter():
    exp = _exporter_state["exporter"]
    if exp is not None:
        exp.stop()
        _exporter_state["exporter"] = None
