"""Fleet telemetry — port of ``paddle_tpu/observability/fleet.py``: live
cross-rank heartbeats over the job's TCPStore, and the liveness fields
of ``/healthz``.

- Each rank publishes a compact **heartbeat** per step
  (:class:`HeartbeatPublisher`: step id, step/data/collective/exposed
  seconds, device memory in use, the flight recorder's last event kind,
  the goodput bins) under the epoch-namespaced key
  ``__fleet/{epoch}/hb/{rank}``; ``StepTimer`` calls
  :func:`publish_step` after every step.
- Rank 0 runs a :class:`FleetAggregator` thread that folds the
  heartbeats into a job-wide rollup: liveness (a heartbeat older than
  ``stale_s`` makes the rank ``missing``; a lane retired by
  :func:`depart` at a resize boundary is ``departed``, never
  ``missing``), a rolling-median step time, online straggler detection
  (a rank over ``k`` x the median for ``m`` consecutive new heartbeats
  sets ``fleet_straggler{rank}`` and records a flight-recorder event)
  and the fleet-wide goodput fraction.
- :func:`fleetz_snapshot` is the ``/fleetz`` document (the serving
  ``Server`` and the metrics exporter): the aggregator's rollup where
  one is enabled, else this rank's own view (its last heartbeat and
  ``local_goodput``).

Lanes are keyed by rank, so a relaunched rank replaces its lane. The
reference reads ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_RESTART_EPOCH``, ``PADDLE_TPU_JOB_ID``, ``PADDLE_MASTER``,
``PADDLE_TPU_FLEET`` and ``PADDLE_TPU_FLEET_{INTERVAL,STALE_S,
STRAGGLER_K,STRAGGLER_STEPS}``; the port reads none: :func:`configure`
sets the rank, world size and job id (``distributed.init_parallel_env``
does for a launched job), the epoch is the launched job's, the
aggregator's knobs are its arguments (the reference's defaults), and
:func:`maybe_enable` takes the reference's ``PADDLE_TPU_FLEET`` switch
as its argument (``init_parallel_env`` calls it for a launched job).
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import threading
import time
import warnings
from collections import deque
from typing import Optional

from . import flight_recorder, goodput
from .metrics import MetricsRegistry, get_registry

__all__ = ["HeartbeatPublisher", "FleetAggregator", "fleet_metrics",
           "publish_step", "depart", "note_step", "last_step_age_seconds",
           "job_id", "rank", "world_size", "configure", "healthz_fields",
           "fleetz_snapshot", "recent_heartbeats", "enable", "disable",
           "maybe_enable"]

#: the last N heartbeats kept locally for postmortem appendices
_RECENT = 32

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


def _epoch() -> str:
    """The launched job's restart epoch ("0" outside one)."""
    env = sys.modules.get("paddle_tpu_torch.distributed.env")
    job = env.launched_job() if env is not None else None
    return job.epoch if job is not None else "0"


def _hb_key(r: int) -> str:
    return f"__fleet/{_epoch()}/hb/{r}"


def fleet_metrics(registry: Optional[MetricsRegistry] = None) -> dict:
    """The ``fleet_*`` metric families (created on first use)."""
    r = registry or get_registry()
    return {
        "heartbeats": r.counter(
            "fleet_heartbeats_total", "heartbeat records published"),
        "straggler": r.gauge(
            "fleet_straggler",
            "1 while the rank is flagged as a straggler, by rank"),
        "live": r.gauge("fleet_ranks_live",
                        "ranks with a fresh heartbeat"),
        "missing": r.gauge(
            "fleet_ranks_missing",
            "ranks whose last heartbeat is past the staleness window"),
        "departed": r.gauge(
            "fleet_ranks_departed",
            "ranks retired at a consensus resize boundary (planned "
            "departure, not a failure)"),
        "median": r.gauge("fleet_step_seconds_median",
                          "fleet-wide rolling-median step time"),
    }


def _default_store():
    from paddle_tpu_torch.distributed.tcp_store import job_store
    return job_store()


class HeartbeatPublisher:
    """Per-rank heartbeat emitter. ``store`` is anything with
    ``set(key, value)`` (the job's TCPStore by default, resolved at the
    first publish)."""

    def __init__(self, store=None, rank: Optional[int] = None,
                 registry: Optional[MetricsRegistry] = None):
        self._store = store
        self.rank = _identity["rank"] if rank is None else int(rank)
        self._m = fleet_metrics(registry)
        self.recent: deque = deque(maxlen=_RECENT)
        self._broken = False

    def _resolve_store(self):
        if self._store is None:
            self._store = _default_store()
        return self._store

    def publish(self, step: int, stats: dict):
        """Fold a step's stats (with device memory, the last flight
        recorder event kind and the goodput snapshot) into one record on
        the bus. A dead store warns once and never fails the step."""
        rec = {
            "rank": self.rank, "pid": os.getpid(), "step": int(step),
            "t": time.time(),
            "step_time_s": round(float(stats.get("step_time_s", 0.0)), 6),
            "data_time_s": round(float(stats.get("data_time_s", 0.0)), 6),
            "collective_time_s": round(
                float(stats.get("collective_time_s", 0.0)), 6),
            "exposed_collective_time_s": round(
                float(stats.get("exposed_collective_time_s", 0.0)), 6),
            "hbm_in_use": _hbm_in_use(),
            "last_event": flight_recorder.last_kind(),
        }
        snap = goodput.snapshot()
        if snap is not None:
            rec["goodput"] = {"bins": snap["bins"],
                              "wall_s": snap["wall_s"],
                              "fraction": snap["job_goodput_fraction"]}
        self.recent.append(rec)
        self._set(rec)

    def depart(self, step: int, reason: str = "resize"):
        """Publish the rank's last heartbeat, marked ``departed``: a
        planned exit at a resize boundary, which the aggregator retires
        instead of aging it into ``missing``."""
        rec = {"rank": self.rank, "pid": os.getpid(), "step": int(step),
               "t": time.time(), "departed": True, "reason": str(reason)}
        self.recent.append(rec)
        self._set(rec)

    def _set(self, rec: dict):
        if self._broken:
            return
        try:
            self._resolve_store().set(_hb_key(self.rank), json.dumps(rec))
            self._m["heartbeats"].inc()
        except (OSError, RuntimeError) as e:
            # the bus is telemetry: one warning, then quiet
            self._broken = True
            warnings.warn(f"[fleet] heartbeat publish failed ({e}); bus "
                          "disabled for this process", RuntimeWarning,
                          stacklevel=2)


def _hbm_in_use() -> int:
    """Device memory in use (the allocator's), else the named owners'
    total on the CPU."""
    from . import memory
    snap = memory.snapshot()
    return int(snap.get("bytes_in_use") or snap.get("named_bytes") or 0)


class FleetAggregator:
    """Rank 0's folding thread (usable without starting it, through
    :meth:`poll_once`). Lanes are keyed by rank; a lane whose heartbeat
    is older than ``stale_s`` is ``missing`` (its record kept); straggler
    detection advances only on new heartbeats (the step id moved)."""

    def __init__(self, store=None, world: Optional[int] = None,
                 interval: float = 1.0, stale_s: float = 15.0,
                 k: float = 1.5, m: int = 3,
                 registry: Optional[MetricsRegistry] = None):
        self._store = store
        self.world = _identity["world_size"] if world is None \
            else int(world)
        self.interval = float(interval)
        self.stale_s = float(stale_s)
        self.k = float(k)
        self.m = int(m)
        self._m = fleet_metrics(registry)
        self._lock = threading.Lock()
        self.lanes: dict = {}           # rank -> last parsed record
        self._seen_step: dict = {}      # rank -> last step id counted
        self._slow_streak: dict = {}    # rank -> consecutive slow steps
        self._departed_noted: set = set()
        self.stragglers: set = set()
        self.fleet_goodput: Optional[dict] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _resolve_store(self):
        if self._store is None:
            self._store = _default_store()
        return self._store

    # -- one fold ----------------------------------------------------------
    def poll_once(self, now: Optional[float] = None) -> dict:
        """Read every rank's lane, update liveness, stragglers and goodput
        and the ``fleet_*`` gauges; returns the rollup (what ``/fleetz``
        serves). A store that cannot be read this tick keeps the previous
        lanes (they still age)."""
        now = time.time() if now is None else now
        try:
            store = self._resolve_store()
            for r in range(self.world):
                raw = store.get(_hb_key(r))
                if not raw:
                    continue
                try:
                    rec = json.loads(raw)
                except (ValueError, TypeError):
                    continue  # a torn write: keep the old lane
                with self._lock:
                    self.lanes[r] = rec
        except (OSError, RuntimeError):
            pass
        with self._lock:
            lanes = dict(self.lanes)
        live, missing, departed = [], [], []
        for r, rec in lanes.items():
            if rec.get("departed"):
                # a planned resize exit: never missing, never a straggler
                departed.append(r)
                if r not in self._departed_noted:
                    self._departed_noted.add(r)
                    self.stragglers.discard(r)
                    self._m["straggler"].set(0, rank=r)
                    t = time.time_ns()
                    flight_recorder.record(
                        flight_recorder.KIND_USER,
                        f"fleet_departed_rank{r}", t, t, aux=r,
                        args={"step": rec.get("step"),
                              "reason": rec.get("reason", "resize")})
                continue
            (missing if now - rec.get("t", 0) > self.stale_s
             else live).append(r)
        self._detect_stragglers(lanes, live)
        self._fold_goodput(lanes)
        self._m["live"].set(len(live))
        self._m["departed"].set(len(departed))
        self._m["missing"].set(len(missing) +
                               max(self.world - len(lanes), 0))
        return self.rollup(now=now)

    def _detect_stragglers(self, lanes: dict, live: list):
        times = [lanes[r].get("step_time_s", 0.0) for r in live]
        times = [t for t in times if t > 0]
        if len(times) < 2:
            return
        median = statistics.median(times)
        self._m["median"].set(median)
        for r in live:
            rec = lanes[r]
            step = rec.get("step")
            if step is None or self._seen_step.get(r) == step:
                continue  # no new heartbeat since the last fold
            self._seen_step[r] = step
            slow = rec.get("step_time_s", 0.0) > self.k * median
            streak = self._slow_streak.get(r, 0) + 1 if slow else 0
            self._slow_streak[r] = streak
            if slow and streak >= self.m and r not in self.stragglers:
                self.stragglers.add(r)
                self._m["straggler"].set(1, rank=r)
                t = time.time_ns()
                flight_recorder.record(
                    flight_recorder.KIND_USER, f"fleet_straggler_rank{r}",
                    t, t, aux=r,
                    args={"step_time_s": rec.get("step_time_s"),
                          "median_s": round(median, 6), "step": step})
            elif not slow and r in self.stragglers:
                self.stragglers.discard(r)
                self._m["straggler"].set(0, rank=r)

    def _fold_goodput(self, lanes: dict):
        prod = wall = 0.0
        bins: dict = {}
        for rec in lanes.values():
            g = rec.get("goodput")
            if not g:
                continue
            wall += g.get("wall_s", 0.0)
            for b, v in g.get("bins", {}).items():
                bins[b] = bins.get(b, 0.0) + v
            prod += g.get("bins", {}).get("productive", 0.0)
        if wall > 0:
            frac = prod / wall
            self.fleet_goodput = {
                "bins": {b: round(v, 6) for b, v in bins.items()},
                "wall_s": round(wall, 6),
                "job_goodput_fraction": round(frac, 6)}
            goodput.goodput_metrics()["fraction"].set(frac)

    def rollup(self, now: Optional[float] = None) -> dict:
        now = time.time() if now is None else now
        with self._lock:
            lanes = dict(self.lanes)
        ranks = {}
        for r, rec in sorted(lanes.items()):
            age = now - rec.get("t", now)
            if rec.get("departed"):
                status = "departed"
            elif age > self.stale_s:
                status = "missing"
            else:
                status = "live"
            ranks[str(r)] = {**rec, "age_s": round(age, 3),
                             "status": status,
                             "straggler": r in self.stragglers}
        return {"world": self.world, "ranks": ranks,
                "stragglers": sorted(self.stragglers),
                "goodput": self.fleet_goodput}

    # -- thread lifecycle --------------------------------------------------
    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="pt-fleet-aggregator", daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval):
            self.poll_once()

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)


# -- module seams (StepTimer and the serving engine, every step) ------------
_publisher: Optional[HeartbeatPublisher] = None
_aggregator: Optional[FleetAggregator] = None


def note_step():
    """Stamp "a step just finished": feeds ``last_step_age_seconds`` on
    ``/healthz``, so a wedged but listening server shows a growing age."""
    global _last_step_mono
    _last_step_mono = time.monotonic()


def last_step_age_seconds() -> Optional[float]:
    return None if _last_step_mono is None \
        else time.monotonic() - _last_step_mono


def publish_step(step: int, stats: dict):
    """``StepTimer``'s per-step hook: one attribute read when the bus is
    off."""
    pub = _publisher
    if pub is not None:
        pub.publish(step, stats)


def depart(step: int, reason: str = "resize"):
    """Retire this rank's lane (a planned resize exit); nothing when the
    bus is off."""
    pub = _publisher
    if pub is not None:
        pub.depart(step, reason=reason)


def recent_heartbeats() -> list:
    """The last heartbeats this rank published (postmortem appendix)."""
    pub = _publisher
    return list(pub.recent) if pub is not None else []


def healthz_fields() -> dict:
    """The wedged-but-listening probe fields shared by the serving
    ``Server`` and the metrics exporter's ``/healthz``."""
    age = last_step_age_seconds()
    return {"rank": rank(), "job_id": job_id(),
            "last_step_age_seconds":
                None if age is None else round(age, 3)}


def fleetz_snapshot() -> dict:
    """The ``/fleetz`` document: with an aggregator, the fleet rollup;
    without, this rank's own view (its last heartbeat, no aggregator)
    and, in both, the goodput ledger's snapshot (None before the first
    step)."""
    doc = {"job_id": job_id(), "epoch": _epoch(), "rank": rank(),
           "unix_time": time.time(), **healthz_fields()}
    agg = _aggregator
    if agg is not None:
        agg.poll_once()
        doc.update(aggregator=True, **agg.rollup())
    else:
        pub = _publisher
        doc.update(aggregator=False, world=world_size(), ranks={},
                   stragglers=[], goodput=None)
        if pub is not None and pub.recent:
            doc["ranks"] = {str(pub.rank): pub.recent[-1]}
    doc["local_goodput"] = goodput.snapshot()
    return doc


# -- arming -----------------------------------------------------------------
def enable(store=None, rank: Optional[int] = None,
           world: Optional[int] = None,
           start_aggregator: Optional[bool] = None):
    """Arm the bus: a publisher on every rank, and on rank 0 (or with
    ``start_aggregator=True``) a polling aggregator."""
    global _publisher, _aggregator
    if _publisher is None:
        _publisher = HeartbeatPublisher(store=store, rank=rank)
    if start_aggregator is None:
        start_aggregator = _publisher.rank == 0
    if start_aggregator and _aggregator is None:
        _aggregator = FleetAggregator(store=store, world=world).start()
    return _publisher


def disable():
    global _publisher, _aggregator
    agg, _aggregator = _aggregator, None
    if agg is not None:
        agg.stop()
    _publisher = None


def maybe_enable(flag: Optional[bool] = None):
    """The reference's arming gate with ``PADDLE_TPU_FLEET`` as ``flag``:
    ``None`` arms the bus in a launched job (which has a store), ``True``
    arms it anyway (a store is needed at the first publish), ``False``
    leaves it off."""
    if flag is False:
        return None
    env = sys.modules.get("paddle_tpu_torch.distributed.env")
    if flag is None and (env is None or env.launched_job() is None):
        return None
    return enable()
