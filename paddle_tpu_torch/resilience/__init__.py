"""Fault tolerance of the port (``paddle_tpu/resilience``'s
counterpart), composed by :class:`FitResilience` for ``Model.fit``:
step checkpoints with an exact resume; the preemption listener with its
final save and :data:`RESUMABLE_EXIT_CODE`; the hang
:class:`Watchdog` (log → dump → kill) around steps and collectives; the
NaN guard's rollback with its provenance replay; and the :mod:`chaos`
harness (kill at a step, poisoned batches, corrupted losses, a hung
collective); and :mod:`elastic`'s live resharding (a consensus resize
boundary, the in-memory state exchange over the job's store, the data
order remap; departing ranks exit :data:`RESIZE_EXIT_CODE`)."""
from .counters import record_nonfinite  # noqa: F401
from .preemption import RESUMABLE_EXIT_CODE, PreemptionListener  # noqa: F401
from .elastic import RESIZE_EXIT_CODE, ElasticResizeListener  # noqa: F401
from .watchdog import Watchdog, WatchdogExpired  # noqa: F401
from .nan_guard import NaNGuard, NumericError  # noqa: F401
from .fit import FitResilience  # noqa: F401
from . import chaos  # noqa: F401

__all__ = ["RESUMABLE_EXIT_CODE", "PreemptionListener",
           "RESIZE_EXIT_CODE", "ElasticResizeListener", "Watchdog",
           "WatchdogExpired", "NaNGuard", "NumericError", "FitResilience",
           "record_nonfinite", "chaos"]
