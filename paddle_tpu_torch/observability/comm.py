"""Collective-communication tracing and exposure accounting — port of
``paddle_tpu/observability/comm.py``.

A collective runs under :func:`comm_scope`, which (1) emits a profiler
span tagged with its group axes and payload bytes (the "collectives"
lane and counter track of the chrome export), (2) bumps the per-op
registry counters (``comm_bytes_total`` / ``comm_calls_total`` /
``comm_seconds_total``) that :class:`~.step_timer.StepTimer` diffs into
per-step volume, and (3) feeds the flight recorder's ring.

**Exposure accounting**: code that computes wraps itself in
:func:`compute_scope` (``jit.TrainStep`` does); every comm span
classifies its wall time against those intervals: the part concurrent
with compute is *overlapped*, the rest *exposed*
(``comm_exposed_seconds_total`` / ``comm_overlapped_seconds_total``, by
axes, and ``exposed_s`` / ``overlapped_s`` in each span's args).

No path of the port issues a collective yet (the distributed layer is
not ported): the families register at zero, ``TrainStep`` runs under
``compute_scope``, and ``StepTimer``, the attribution and the watchdog
read :func:`comm_totals` as in the reference. Bytes are the local
operand's ``numel * element_size``.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Optional, Sequence

from . import flight_recorder, trace
from .metrics import get_registry

__all__ = ["comm_scope", "comm_event", "payload_bytes", "comm_totals",
           "compute_scope"]


_metrics_cache = None

#: Resilience seams, installed from outside so this hot path never
#: imports the resilience package: a
#: ``resilience.Watchdog`` with ``watch_collectives()`` active arms a
#: deadline around every span; ``resilience.chaos.refresh()`` installs a
#: hang-injection hook. Both are one module-attribute read when unused.
_collective_watchdog = None
_chaos_hook = None


def _metrics():
    """The per-collective counters, resolved once (they live in the
    default registry for the process's lifetime — no reason to take the
    registry lock on every collective)."""
    global _metrics_cache
    if _metrics_cache is None:
        reg = get_registry()
        _metrics_cache = (
            reg.counter("comm_bytes_total",
                        "payload bytes moved by collectives"),
            reg.counter("comm_calls_total", "collective invocations"),
            reg.counter("comm_seconds_total",
                        "host-side seconds inside collectives"),
            reg.counter("comm_exposed_seconds_total",
                        "collective seconds NOT overlapped with compute "
                        "(the step got longer by this much), by axes"),
            reg.counter("comm_overlapped_seconds_total",
                        "collective seconds that ran concurrently with a "
                        "compute_scope, by axes"))
    return _metrics_cache


class _ComputeTracker:
    """Bounded record of recent compute intervals (perf_counter_ns).

    ``compute_scope`` regions push intervals here; a finishing comm span
    asks how much of its own window intersected them. Memory is bounded
    (a deque of the most recent closed intervals) — exposure is a
    per-step quantity, so anything older than the current step's window
    is irrelevant by the time it rotates out.
    """

    def __init__(self, keep: int = 512):
        self._lock = threading.Lock()
        self._open: dict = {}               # token -> start_ns
        self._closed = collections.deque(maxlen=keep)  # (start, end)
        self._tokens = itertools.count()

    def begin(self) -> int:
        token = next(self._tokens)
        with self._lock:
            self._open[token] = time.perf_counter_ns()
        return token

    def end(self, token: int):
        now = time.perf_counter_ns()
        with self._lock:
            start = self._open.pop(token, None)
            if start is not None:
                self._closed.append((start, now))

    def overlap_ns(self, t0: int, t1: int) -> int:
        """Nanoseconds of [t0, t1] covered by the UNION of compute
        intervals. Compute regions can nest/overlap across threads, so
        intervals are merged before measuring — two half-covering
        regions must not add up to "fully overlapped"."""
        if t1 <= t0:
            return 0
        now = time.perf_counter_ns()
        with self._lock:
            # prune intervals that ended before this span started —
            # comm spans arrive in (monotonic) time order, so they can
            # never intersect a later query; without this, a full deque
            # pays a 512-element copy+sort per collective forever.
            # _closed is appended in end-time order, so popleft is safe.
            while self._closed and self._closed[0][1] < t0:
                self._closed.popleft()
            intervals = list(self._closed) + \
                [(s, now) for s in self._open.values()]
        intervals.sort()
        total = 0
        cur_s = cur_e = None
        for s, e in intervals:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += max(0, min(t1, cur_e) - max(t0, cur_s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += max(0, min(t1, cur_e) - max(t0, cur_s))
        return min(total, t1 - t0)


_compute = _ComputeTracker()


@contextlib.contextmanager
def compute_scope():
    """Mark the caller as actively computing: any comm span that runs
    concurrently with this region counts as *overlapped* rather than
    *exposed*. Entered by ``jit.TrainStep`` around each step."""
    token = _compute.begin()
    try:
        yield
    finally:
        _compute.end(token)


def payload_bytes(x) -> int:
    """Payload bytes of a tensor, an array or a list of them; 0 when the
    size cannot be determined (object collectives pass an explicit byte
    count instead)."""
    if x is None:
        return 0
    if isinstance(x, (list, tuple)):
        return sum(payload_bytes(e) for e in x)
    import torch
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is None or dtype is None:
        return 0
    try:
        import numpy as np
        return int(np.prod(shape, dtype=np.int64)) * \
            int(np.dtype(dtype).itemsize)
    except Exception:
        return 0


def _axes_label(axes: Sequence[str]) -> str:
    axes = tuple(axes)
    return "x".join(axes) if axes else "world"


def _emit(op: str, axes_label: str, nbytes: int, t0: int, t1: int,
          extra: Optional[dict] = None):
    b, c, s, exp, ovl = _metrics()
    b.inc(nbytes, op=op, axes=axes_label)
    c.inc(1, op=op, axes=axes_label)
    s.inc((t1 - t0) / 1e9, op=op, axes=axes_label)
    # exposure classification: the part of this span concurrent with a
    # compute_scope is overlapped; the rest lengthened the step (exposed)
    overlapped_ns = _compute.overlap_ns(t0, t1)
    exposed_ns = (t1 - t0) - overlapped_ns
    exp.inc(exposed_ns / 1e9, axes=axes_label)
    ovl.inc(overlapped_ns / 1e9, axes=axes_label)
    args = {"bytes": nbytes, "axes": axes_label,
            "exposed_s": exposed_ns / 1e9,
            "overlapped_s": overlapped_ns / 1e9}
    if extra:
        args.update(extra)
    from paddle_tpu_torch import profiler
    profiler._emit_event(f"comm::{op}", t0, t1,
                         tid=threading.get_ident(), args=args, cat="comm")
    flight_recorder.record(flight_recorder.KIND_COMM, f"{op}@{axes_label}",
                           t0, t1, tid=threading.get_ident(), aux=nbytes,
                           args=args)
    trace.span("comm", f"{op}@{axes_label}", t0, t1,
               tid=threading.get_ident(), args=args)


@contextlib.contextmanager
def comm_scope(op: str, axes: Sequence[str], payload=None,
               nbytes: Optional[int] = None, extra: Optional[dict] = None):
    """Span around one collective. Records even when the body raises — a
    failed collective is exactly what the flight recorder must show. A
    collective-armed watchdog puts its deadline around the whole span
    (chaos-injected hangs included: a wedged collective is precisely the
    event the deadline exists to catch)."""
    nbytes = payload_bytes(payload) if nbytes is None else int(nbytes)
    axes_label = _axes_label(axes)
    wd = _collective_watchdog
    token = None if wd is None else wd.arm(
        f"collective:{op}@{axes_label}", wd.collective_timeout)
    t0 = time.perf_counter_ns()
    try:
        hook = _chaos_hook
        if hook is not None:
            hook(op, axes_label)
        yield
    finally:
        if wd is not None:
            wd.disarm(token)
        _emit(op, axes_label, nbytes, t0, time.perf_counter_ns(), extra)


def comm_event(op: str, axes: Sequence[str], payload=None,
               nbytes: Optional[int] = None, extra: Optional[dict] = None):
    """Instantaneous comm record (for calls that fail fast, e.g. the
    unsupported raw send/recv): counters + flight recorder, zero span."""
    nbytes = payload_bytes(payload) if nbytes is None else int(nbytes)
    t = time.perf_counter_ns()
    _emit(op, _axes_label(axes), nbytes, t, t, extra)


def comm_totals(registry=None) -> dict:
    """(bytes, calls, seconds, exposed, overlapped) summed over every
    label set — the snapshot StepTimer diffs per step."""
    reg = registry or get_registry()
    out = {}
    for name in ("comm_bytes_total", "comm_calls_total",
                 "comm_seconds_total", "comm_exposed_seconds_total",
                 "comm_overlapped_seconds_total"):
        m = reg.get(name)
        out[name] = m.total() if m is not None else 0.0
    return out


# the comm families are core telemetry: register them eagerly so scrapes
# and ``bench.py --emit-metrics`` show them (at zero) even before the
# first collective runs
_metrics()
