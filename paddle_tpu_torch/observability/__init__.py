"""Observability of the port (``paddle_tpu/observability``'s
counterpart):

- **metrics** — Counter/Gauge/Histogram registry with Prometheus-text
  and JSON exposition and the HTTP exporter;
- **requests** — the per-request serving ledger, W3C ``traceparent``
  helpers, the tail-sampled exemplar log and the ``/statusz`` payload;
- **slo** — declared serving SLO targets with multi-window burn-rate
  gauges (``serving_slo_*``) computed from ledger completions;
- **trace** — per-process span files (serving request chains, router
  hops) and the cross-file merge
  (``python -m paddle_tpu_torch.observability.trace merge``);
- **memory** — the device-memory ledger behind the ``hbm_*`` gauges,
  measured step reports and the out-of-memory postmortem;
- **profile** — bounded on-demand ``torch.profiler`` capture windows;
- **fleet** — the ``/healthz`` liveness fields (the heartbeat bus and
  ``/fleetz`` are not ported yet);
- **numerics** — the tap seam and activation-range sketches.

Importing this package arms nothing: the reference's env gates
(``PADDLE_TPU_TRACE_SPANS``, ``PADDLE_TPU_FLEET``, ...) are not read.
"""
from . import (  # noqa: F401
    fleet, memory, metrics, numerics, profile, requests, slo, trace,
)
from .metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, get_registry,
    maybe_start_exporter, start_exporter,
)

__all__ = ["metrics", "trace", "memory", "profile", "fleet", "numerics",
           "requests", "slo", "MetricsRegistry", "Counter", "Gauge",
           "Histogram", "get_registry", "start_exporter",
           "maybe_start_exporter"]
