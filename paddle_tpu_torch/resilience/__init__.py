"""Fault tolerance of the port (``paddle_tpu/resilience``'s
counterpart), composed by :class:`FitResilience` for ``Model.fit``:
step checkpoints with an exact resume; the preemption listener with its
final save and :data:`RESUMABLE_EXIT_CODE`; the hang
:class:`Watchdog` (log → dump → kill) around steps and collectives; the
NaN guard's rollback with its provenance replay; and the :mod:`chaos`
harness (kill at a step, poisoned batches, corrupted losses, a hung
collective). Elastic resharding is not ported yet."""
from .counters import record_nonfinite  # noqa: F401
from .preemption import RESUMABLE_EXIT_CODE, PreemptionListener  # noqa: F401
from .watchdog import Watchdog, WatchdogExpired  # noqa: F401
from .nan_guard import NaNGuard, NumericError  # noqa: F401
from .fit import FitResilience  # noqa: F401
from . import chaos  # noqa: F401

__all__ = ["RESUMABLE_EXIT_CODE", "PreemptionListener", "Watchdog",
           "WatchdogExpired", "NaNGuard", "NumericError", "FitResilience",
           "record_nonfinite", "chaos"]
