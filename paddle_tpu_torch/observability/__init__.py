"""Observability of the port (``paddle_tpu/observability``'s
counterpart): so far the metrics registry that the data pipeline, the
loader, the checkpoint writer and the resilience layer record into."""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, get_registry

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry"]
