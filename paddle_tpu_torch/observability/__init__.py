"""Observability of the port (``paddle_tpu/observability``'s
counterpart):

- **metrics** — Counter/Gauge/Histogram registry with Prometheus-text
  and JSON exposition and the HTTP exporter;
- **step_timer** — per-step data/compute/collective split, samples/s,
  tokens/s and MFU against the card's peak (the hapi ``StepTelemetry``
  callback drives it);
- **comm** — collective spans and the overlapped/exposed accounting
  against ``compute_scope`` intervals;
- **attribution** — the phase table of a train step (data, backbone
  forward and backward, loss head, optimizer, exposed collective) with
  per-phase flops and MFU;
- **flight_recorder** — the bounded ring of recent op / comm / step /
  checkpoint / data events, dumped as a postmortem on a crash or signal;
- **goodput** — the ledger that puts every second of wall-clock in a
  bin (productive, compile, checkpoint, data stall, rollback, ...);
- **requests** — the per-request serving ledger, W3C ``traceparent``
  helpers, the tail-sampled exemplar log and the ``/statusz`` payload;
- **slo** — declared serving SLO targets with multi-window burn-rate
  gauges (``serving_slo_*``) computed from ledger completions;
- **trace** — per-process span files (step phases, serving request
  chains, router hops) and the cross-file merge
  (``python -m paddle_tpu_torch.observability.trace merge``);
- **memory** — the device-memory ledger behind the ``hbm_*`` gauges,
  measured step reports and the out-of-memory postmortem;
- **profile** — bounded on-demand ``torch.profiler`` capture windows
  (``POST /debug/profile``, the fit window);
- **fleet** — the ``/healthz`` liveness fields and the single-process
  ``/fleetz`` document (the heartbeat bus is not ported);
- **numerics** — the tap seam, the sampled twin step's statistics, the
  NaN-provenance replay and the activation-range sketches.

Importing this package arms nothing: the reference's env gates
(``PADDLE_TPU_FLIGHT_RECORDER``, ``PADDLE_TPU_TRACE_SPANS``,
``PADDLE_TPU_FLEET``, ...) are not read.
"""
from . import (  # noqa: F401
    attribution, comm, fleet, flight_recorder, goodput, memory, metrics,
    numerics, profile, requests, slo, step_timer, trace,
)
from .comm import (  # noqa: F401
    comm_scope, comm_totals, compute_scope, payload_bytes,
)
from .metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, get_registry,
    maybe_start_exporter, start_exporter,
)
from .step_timer import StepTimer, peak_flops  # noqa: F401

__all__ = ["metrics", "step_timer", "comm", "flight_recorder", "trace",
           "memory", "profile", "fleet", "goodput", "numerics",
           "requests", "slo", "attribution",
           "MetricsRegistry", "Counter", "Gauge", "Histogram",
           "get_registry", "start_exporter", "maybe_start_exporter",
           "StepTimer", "peak_flops", "comm_scope", "comm_totals",
           "compute_scope", "payload_bytes"]
