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

:func:`fleetz_snapshot` is the ``/fleetz`` document in the reference's
single-process form (``paddle_tpu/observability/fleet.py:435-456``): no
aggregator, this rank's last heartbeat if any (none: the bus is not
ported), and ``local_goodput``, the goodput ledger's snapshot. The
serving ``Server`` and the metrics exporter answer ``/fleetz`` with it.
:func:`publish_step` and :func:`recent_heartbeats`, ``StepTimer``'s and
the postmortem's seams, have no bus to talk to: a no-op and ``[]``.

Not ported yet, and raising ``NotImplementedError``: the cross-rank
heartbeat bus over the job TCPStore (``HeartbeatPublisher``,
``FleetAggregator``, :func:`enable`), which waits for the port's
TCPStore.
"""
from __future__ import annotations

import time
from typing import Optional

__all__ = ["note_step", "last_step_age_seconds", "job_id", "rank",
           "world_size", "configure", "healthz_fields", "fleetz_snapshot",
           "publish_step", "recent_heartbeats", "HeartbeatPublisher",
           "FleetAggregator", "enable"]

_last_step_mono: Optional[float] = None
_identity = {"rank": 0, "job_id": "local", "world_size": 1}


def configure(rank: Optional[int] = None, job_id: Optional[str] = None,
              world_size: Optional[int] = None):
    """Set this process's rank, job id and world size (the reference's
    ``PADDLE_TRAINER_ID``, ``PADDLE_TPU_JOB_ID`` and
    ``PADDLE_TRAINERS_NUM``)."""
    if rank is not None:
        _identity["rank"] = int(rank)
    if job_id is not None:
        _identity["job_id"] = str(job_id)
    if world_size is not None:
        _identity["world_size"] = int(world_size)


def rank() -> int:
    return _identity["rank"]


def world_size() -> int:
    return _identity["world_size"]


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


def publish_step(step: int, stats: dict):
    """``StepTimer``'s per-step hook: no heartbeat bus, nothing to do."""


def recent_heartbeats() -> list:
    """The locally published heartbeats (none without the bus)."""
    return []


def fleetz_snapshot() -> dict:
    """The ``/fleetz`` document of a process without an aggregator:
    identity and liveness, this rank's last heartbeat (none), and the
    goodput ledger's snapshot (None before the first step). The restart
    epoch is "0": no launcher relaunches a single process."""
    from . import goodput
    return {"job_id": job_id(), "epoch": "0",
            "rank": rank(), "unix_time": time.time(), **healthz_fields(),
            "aggregator": False, "world": world_size(), "ranks": {},
            "stragglers": [], "goodput": None,
            "local_goodput": goodput.snapshot()}


_NOT_PORTED = ("the fleet heartbeat bus is not ported to paddle_tpu_torch "
               "yet: it needs the port's TCPStore")


class HeartbeatPublisher:
    def __init__(self, *a, **kw):
        raise NotImplementedError(_NOT_PORTED)


class FleetAggregator:
    def __init__(self, *a, **kw):
        raise NotImplementedError(_NOT_PORTED)


def enable(*a, **kw):
    raise NotImplementedError(_NOT_PORTED)
