"""Observability of the port (``paddle_tpu/observability``'s
counterpart): so far the metrics registry that the data pipeline, the
loader, the checkpoint writer, the resilience layer and the serving
engine record into, and the numerics tap seam (``numerics``)."""
from . import numerics  # noqa: F401
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, get_registry

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry"]
