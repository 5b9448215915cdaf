"""Fault tolerance of the port (``paddle_tpu/resilience``'s
counterpart): :class:`FitResilience` — step checkpoints with an exact
resume, the preemption listener with its final save and
:data:`RESUMABLE_EXIT_CODE`, and the NaN guard's rollback. The watchdog,
elastic resharding and the chaos harness are not ported yet."""
from .counters import record_nonfinite  # noqa: F401
from .fit import FitResilience  # noqa: F401
from .nan_guard import NaNGuard, NumericError  # noqa: F401
from .preemption import RESUMABLE_EXIT_CODE, PreemptionListener  # noqa: F401

__all__ = ["RESUMABLE_EXIT_CODE", "PreemptionListener", "NaNGuard",
           "NumericError", "FitResilience", "record_nonfinite"]
