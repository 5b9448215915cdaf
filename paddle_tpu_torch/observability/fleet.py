"""Fleet telemetry — port of ``paddle_tpu/observability/fleet.py``, its
single-process part.

Ported: the liveness stamp the serving engine (and a training loop)
writes after every step (:func:`note_step`), its age
(:func:`last_step_age_seconds`), the job identity (:func:`job_id`) and
the ``/healthz`` probe fields built from them (:func:`healthz_fields`).
The reference reads the rank from ``PADDLE_TRAINER_ID`` and the job id
from ``PADDLE_TPU_JOB_ID``/``PADDLE_MASTER``; the port reads no
environment variable: :func:`configure` sets both (rank 0 and
``"local"`` until then).

Not ported yet, and raising ``NotImplementedError``: the cross-rank
heartbeat bus over the job TCPStore (``HeartbeatPublisher``,
``FleetAggregator``, :func:`enable`), which waits for the port's
TCPStore, and :func:`fleetz_snapshot`, which folds in the goodput
ledger (``observability/goodput.py``, not ported). So ``/fleetz``
answers 501 with that error on the serving ``Server`` and the metrics
exporter.
"""
from __future__ import annotations

import time
from typing import Optional

__all__ = ["note_step", "last_step_age_seconds", "job_id", "rank",
           "configure", "healthz_fields", "fleetz_snapshot",
           "HeartbeatPublisher", "FleetAggregator", "enable"]

_last_step_mono: Optional[float] = None
_identity = {"rank": 0, "job_id": "local"}


def configure(rank: Optional[int] = None, job_id: Optional[str] = None):
    """Set this process's rank and job id for ``/healthz`` (the
    reference's ``PADDLE_TRAINER_ID`` and ``PADDLE_TPU_JOB_ID``)."""
    if rank is not None:
        _identity["rank"] = int(rank)
    if job_id is not None:
        _identity["job_id"] = str(job_id)


def rank() -> int:
    return _identity["rank"]


def job_id() -> str:
    """The operator-visible job identity (``"local"`` unless
    :func:`configure` named one)."""
    return _identity["job_id"]


def note_step():
    """Stamp "a step just finished": feeds ``last_step_age_seconds`` on
    ``/healthz``, so a wedged but listening server shows a growing age."""
    global _last_step_mono
    _last_step_mono = time.monotonic()


def last_step_age_seconds() -> Optional[float]:
    return None if _last_step_mono is None \
        else time.monotonic() - _last_step_mono


def healthz_fields() -> dict:
    """The wedged-but-listening probe fields shared by the serving
    ``Server`` and the metrics exporter's ``/healthz``."""
    age = last_step_age_seconds()
    return {"rank": rank(), "job_id": job_id(),
            "last_step_age_seconds":
                None if age is None else round(age, 3)}


_NOT_PORTED = ("the fleet heartbeat bus and /fleetz rollup are not ported "
               "to paddle_tpu_torch yet: they need the port's TCPStore and "
               "its goodput ledger")


def fleetz_snapshot() -> dict:
    raise NotImplementedError(_NOT_PORTED)


class HeartbeatPublisher:
    def __init__(self, *a, **kw):
        raise NotImplementedError(_NOT_PORTED)


class FleetAggregator:
    def __init__(self, *a, **kw):
        raise NotImplementedError(_NOT_PORTED)


def enable(*a, **kw):
    raise NotImplementedError(_NOT_PORTED)
