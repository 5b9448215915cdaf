"""``data_*`` metric families — port of ``paddle_tpu/data/metrics.py``.

One accessor: every pipeline component records through these families
of the port's metrics registry.
"""
from __future__ import annotations

from paddle_tpu_torch.observability.metrics import get_registry

__all__ = ["data_metrics"]

#: packing efficiency is a ratio in (0, 1] — step-time buckets make no
#: sense for it
_EFFICIENCY_BUCKETS = (0.25, 0.5, 0.6, 0.7, 0.8, 0.85, 0.9, 0.95, 0.98,
                       1.0)


def data_metrics(registry=None) -> dict:
    r = registry if registry is not None else get_registry()
    return {
        "prefetch_buffer": r.gauge(
            "data_prefetch_buffer",
            "device-prefetch buffer occupancy (batches ready ahead)"),
        "packing_efficiency": r.histogram(
            "data_packing_efficiency",
            "real-token fraction of each packed [B, seq] batch",
            buckets=_EFFICIENCY_BUCKETS),
        "skipped_on_resume": r.counter(
            "data_skipped_on_resume_total",
            "samples fast-forwarded past on resume (iterable datasets "
            "cannot seek; map-style resume jumps and never skips)"),
        "batches": r.counter(
            "data_batches_total", "batches delivered by the pipeline"),
        "tokens": r.counter(
            "data_tokens_total",
            "real (non-padding) tokens delivered in packed batches"),
    }
