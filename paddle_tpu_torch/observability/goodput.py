"""Goodput ledger — port of ``paddle_tpu/observability/goodput.py``:
every second of wall-clock in a named bin.

MFU says how fast a step runs; the goodput fraction says how much of the
job's wall-clock was productive training. :class:`GoodputLedger` is the
per-process accountant:

- **bins** (``goodput_seconds_total{bin=...}``): ``productive``,
  ``compile``, ``checkpoint``, ``data_stall``, ``exposed_collective``,
  ``restart``, ``reshard``, ``rollback_discarded`` and the derived
  remainder ``other_overhead``, so the bins sum to the measured wall by
  construction;
- **feeds**: ``StepTimer`` calls :func:`on_step` with each step's
  decomposition; :func:`record_compile` takes one-time costs; the
  ``ckpt_blocking_seconds`` histogram is diffed per step; ``NaNGuard``
  moves rolled-back steps with :func:`discard_recent_steps`;
- **exposition**: the ``goodput_seconds_total{bin}`` counter, the
  ``job_goodput_fraction`` gauge, ``/fleetz``'s ``local_goodput``, the
  ``StepTelemetry`` logs and, with :func:`configure` ``(snapshot_dir=)``,
  an atomically replaced ``goodput_rank<r>_<pid>.json`` after each step.

**The compile bin.** The port compiles no XLA program; its one-time
costs on a step's path are the kernel builds at first use
(``ops/pallas/_build.py``), the CUDA-graph captures
(``jit/cuda_graph.py``) and a ``TrainStep``'s first step (the fused
update's planning, the caching allocator's first allocations, cuBLAS's
first handles). Each build and capture stamps its wall with
:func:`record_compile`; a ``TrainStep`` stamps its first step's wall
less what those stamped inside it, so nothing is charged twice. The
rule stands where the reference times its first trace
(``jit/train_step.py:781-805``).

The reference reads ``PADDLE_TPU_GOODPUT_DIR``,
``PADDLE_TPU_GOODPUT_DOWN_AT``, ``PADDLE_TPU_GOODPUT_RESIZE_AT`` and
``PADDLE_TRAINER_ID``; the port reads none here: :func:`configure` sets
the snapshot directory, the constructor takes ``down_at``/``resize_at``
(the process ledger takes the launcher's stamps from the launched job
that ``distributed.init_parallel_env`` joined, so a relaunch after a
crash bins its gap as ``restart`` and one after a resize as
``reshard``), and the rank is ``fleet.rank()``. ``clock``/``wall_clock`` are the seams
through which a test injects time.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque
from typing import Callable, Optional

from .metrics import MetricsRegistry, get_registry

__all__ = ["GoodputLedger", "BINS", "get_ledger", "on_step", "snapshot",
           "record_compile", "discard_recent_steps", "goodput_metrics",
           "configure", "stamped_compile_seconds"]

#: the taxonomy — every second of wall-clock lands in exactly one bin
#: (``reshard``: planned elastic resizes — in-place membership changes
#: and the launcher's resize relaunch gap — kept apart from ``restart``
#: so riding a preemption down to a smaller world reads as cheap
#: elasticity, not a crash)
BINS = ("productive", "compile", "checkpoint", "data_stall",
        "exposed_collective", "restart", "reshard", "rollback_discarded",
        "other_overhead")

#: how many per-step productive contributions the ledger remembers for
#: NaN-rollback reclassification (a rollback never spans more than the
#: checkpoint cadence, which is far below this)
_DISCARD_WINDOW = 256

# one-time walls land here before the step that contains them finishes;
# on_step drains this and subtracts it from the step's productive share
_pending_compile_lock = threading.Lock()
_pending_compile_s = 0.0
#: every second ever stamped (a TrainStep's first step subtracts what was
#: stamped inside it from its own wall)
_stamped_compile_s = 0.0

_config = {"snapshot_dir": None}


def configure(snapshot_dir: Optional[str] = None):
    """Where each step's snapshot file goes (None: no file) — the
    reference's ``PADDLE_TPU_GOODPUT_DIR``."""
    _config["snapshot_dir"] = snapshot_dir


def record_compile(seconds: float):
    """Stamp a one-time wall (a kernel build, a CUDA-graph capture, a
    ``TrainStep``'s first step); drained by the next :func:`on_step`."""
    global _pending_compile_s, _stamped_compile_s
    if seconds <= 0:
        return
    with _pending_compile_lock:
        _pending_compile_s += float(seconds)
        _stamped_compile_s += float(seconds)


def stamped_compile_seconds() -> float:
    """Every second :func:`record_compile` has taken so far."""
    return _stamped_compile_s


def _drain_pending_compile() -> float:
    global _pending_compile_s
    with _pending_compile_lock:
        s, _pending_compile_s = _pending_compile_s, 0.0
    return s


def goodput_metrics(registry: Optional[MetricsRegistry] = None) -> dict:
    """The ``goodput_*`` / ``job_*`` metric families (created on first
    use) — the docs-drift gate instantiates this accessor."""
    r = registry or get_registry()
    return {
        "seconds": r.counter(
            "goodput_seconds_total",
            "wall-clock accounted into goodput bins, by bin"),
        "fraction": r.gauge(
            "job_goodput_fraction",
            "productive share of wall-clock since ledger start (0..1)"),
    }


class GoodputLedger:
    """Per-rank wall-clock accountant (see module docstring).

    The ledger starts its wall at construction; ``other_overhead`` is
    derived (wall minus the explicit bins), so the snapshot always sums
    to the measured wall. ``down_at``/``resize_at`` are the unix times
    the previous incarnation died or a planned resize began (the
    launcher's stamps): their gap to this ledger's birth is charged to
    ``restart``/``reshard`` up front.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 down_at: Optional[float] = None,
                 resize_at: Optional[float] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 wall_clock: Callable[[], float] = time.time):
        self.registry = registry or get_registry()
        m = goodput_metrics(self.registry)
        self._c_seconds = m["seconds"]
        self._g_fraction = m["fraction"]
        self._lock = threading.Lock()
        self._bins = {b: 0.0 for b in BINS if b != "other_overhead"}
        self._recent: deque = deque(maxlen=_DISCARD_WINDOW)
        self._ckpt_sum0 = self._ckpt_blocking_sum()
        self._clock = clock
        self.start_unix = wall_clock()
        self._start_mono = clock()
        self.steps = 0
        # the gap from the previous incarnation's death to this ledger's
        # birth is restart badput, charged once, up front
        if down_at is not None:
            gap = self.start_unix - down_at
            if gap > 0:
                self._add("restart", gap)
        # a planned elastic resize stamps its own mark instead — the gap
        # is downtime too, but it bins as `reshard`, not `restart`. It
        # predates this ledger's wall (unlike in-process resize seconds
        # recorded later), so track it for the snapshot's span.
        self._prewall_reshard_s = 0.0
        if resize_at is not None:
            gap = self.start_unix - float(resize_at)
            if gap > 0:
                self._prewall_reshard_s = gap
                self._add("reshard", gap)

    # -- feeds -------------------------------------------------------------
    def _add(self, bin: str, seconds: float):
        if seconds <= 0:
            return
        with self._lock:
            self._bins[bin] += seconds
        self._c_seconds.inc(seconds, bin=bin)

    def _ckpt_blocking_sum(self) -> float:
        """Current sum of the default registry's ``ckpt_blocking_seconds``
        histogram across label sets."""
        h = get_registry().get("ckpt_blocking_seconds")
        if h is None:
            return 0.0
        with h._lock:
            return float(sum(st["sum"] for st in h._samples.values()))

    def on_step(self, stats: dict) -> dict:
        """Classify one finished step from the StepTimer's decomposition.
        Returns ``{"compile_s", "ckpt_s", "goodput_fraction"}`` for the
        step's trace span (``trace merge --goodput`` replays the split)."""
        total = float(stats.get("step_time_s", 0.0))
        data = float(stats.get("data_time_s", 0.0))
        exposed = float(stats.get("exposed_collective_time_s", 0.0))
        compile_s = _drain_pending_compile()
        ckpt_sum = self._ckpt_blocking_sum()
        ckpt_s = max(ckpt_sum - self._ckpt_sum0, 0.0)
        self._ckpt_sum0 = ckpt_sum
        # overhead shares are capped by the step wall they occurred in
        # (an async checkpoint blocking longer than the step cannot
        # charge more than the step paid for it)
        overhead = min(data + exposed + compile_s + ckpt_s, total)
        productive = total - overhead
        self._add("data_stall", data)
        self._add("exposed_collective", exposed)
        self._add("compile", compile_s)
        self._add("checkpoint", ckpt_s)
        self._add("productive", productive)
        with self._lock:
            self.steps += 1
            self._recent.append(productive)
        snap = self.snapshot()
        self._maybe_write(snap)
        return {"compile_s": compile_s, "ckpt_s": ckpt_s,
                "goodput_fraction": snap["job_goodput_fraction"]}

    def discard_recent_steps(self, n: int) -> float:
        """NaN-rollback reclassification: the last ``n`` steps' work was
        just thrown away by a checkpoint restore — move their productive
        seconds into ``rollback_discarded``. Returns the moved wall."""
        moved = 0.0
        with self._lock:
            for _ in range(min(int(n), len(self._recent))):
                moved += self._recent.pop()
            if moved > 0:
                self._bins["productive"] -= moved
                self._bins["rollback_discarded"] += moved
        if moved > 0:
            self._c_seconds.inc(moved, bin="rollback_discarded")
            # counters only go up: productive's counter keeps its total,
            # but the snapshot (the number every consumer reads) moves
        return moved

    def record(self, bin: str, seconds: float):
        """Direct feed for bins without a dedicated seam."""
        if bin not in self._bins:
            raise ValueError(f"unknown goodput bin {bin!r}; one of {BINS}")
        self._add(bin, seconds)

    # -- exposition --------------------------------------------------------
    def snapshot(self) -> dict:
        """Bins + derived ``other_overhead`` + ``job_goodput_fraction``;
        sums to ``wall_s`` by construction."""
        now = self._clock()
        wall = max(now - self._start_mono, 0.0)
        with self._lock:
            bins = dict(self._bins)
        # restart badput (and a resize relaunch gap) predates the
        # ledger's own wall: the accounted span is (down_at .. now), not
        # (start .. now) — in-process reshard seconds are inside the wall
        span = wall + bins.get("restart", 0.0) + self._prewall_reshard_s
        explicit = sum(bins.values())
        bins["other_overhead"] = max(span - explicit, 0.0)
        # clamp: perf_counter vs caller-supplied data_time drift can put
        # the explicit bins a hair over the measured span
        frac = min(bins["productive"] / span, 1.0) if span > 0 else 0.0
        self._g_fraction.set(frac)
        return {"bins": {b: round(bins[b], 6) for b in BINS},
                "wall_s": round(span, 6), "steps": self.steps,
                "start_unix": self.start_unix, "pid": os.getpid(),
                "job_goodput_fraction": round(frac, 6)}

    def _maybe_write(self, snap: dict):
        d = _config["snapshot_dir"]
        if not d:
            return
        try:
            os.makedirs(d, exist_ok=True)
            from .fleet import rank as _rank
            rank = _rank()
            path = os.path.join(d, f"goodput_rank{rank}_{os.getpid()}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(snap, f)
            os.replace(tmp, path)
        except OSError:
            pass  # snapshot files are best-effort; never fail a step


#: the process ledger (a plain module global, read every step)
_ledger: Optional[GoodputLedger] = None


def get_ledger() -> GoodputLedger:
    """The process-wide ledger, created on first use (its wall starts
    then: at the top of the first fit loop, not at import)."""
    global _ledger
    if _ledger is None:
        env = sys.modules.get("paddle_tpu_torch.distributed.env")
        job = env.launched_job() if env is not None else None
        _ledger = GoodputLedger() if job is None else GoodputLedger(
            down_at=job.down_at, resize_at=job.resize_at)
    return _ledger


def reset_ledger():
    """Drop the process ledger (tests)."""
    global _ledger
    _ledger = None


def on_step(stats: dict) -> dict:
    return get_ledger().on_step(stats)


def discard_recent_steps(n: int) -> float:
    led = _ledger
    return led.discard_recent_steps(n) if led is not None else 0.0


def snapshot() -> Optional[dict]:
    """The process ledger's snapshot, or None before the first step —
    postmortem appendices must not *create* a ledger at dump time (its
    wall would be zero and the fraction meaningless)."""
    led = _ledger
    return led.snapshot() if led is not None else None
