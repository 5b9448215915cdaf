"""Crash flight recorder — port of
``paddle_tpu/observability/flight_recorder.py``: an always-on bounded
ring of recent events.

Keeps the last N op / collective / step / checkpoint / data events and
dumps a postmortem JSON (rank, world size, the events, the goodput
ledger, the last numerics sample) on an unhandled exception (main
thread or any other) or on ``SIGTERM``/``SIGUSR1``. The ring is the
lock-free seqlock ring of ``native/host_tracer.cpp`` (``fr_*``), built
with the profiler's library (a failed build raises), or, where the
caller asks for it (``use_native=False``), a Python ring.

The reference arms itself from ``PADDLE_TPU_FLIGHT_RECORDER`` and dumps
under ``PADDLE_TPU_TRACE_DIR``; the port reads no environment variable:
:func:`enable` arms it, dumps go to ``observability.profile``'s trace
directory (``profile.set_trace_dir``), and the rank and world size come
from ``fleet.configure`` (the reference's ``PADDLE_TRAINER_ID`` and
``PADDLE_TRAINERS_NUM``).

Event sources: every profiler span (``profiler.RecordEvent`` /
``record_op``: op dispatch, ``PyLayer``, ``to_static``, ``TrainStep``),
the collective tracer (``observability.comm``), ``StepTimer`` (steps),
checkpoint commits and restores, data-pipeline commits and preemption
notices. Each records ``(kind, name, start_ns, end_ns, tid, aux)``;
``aux`` carries payload bytes for collectives and samples for steps.
The native ring stores only those fields; ``args`` survive on the
Python ring only, and each dump says which ring produced it
(``"native_ring"``).

Signals chain: the recorder's handler dumps, then calls the handler it
replaced (the preemption listener's, say); a listener installed after
the recorder calls :func:`dump_on_signal` before its own work
(``resilience/preemption.py``), so either order keeps both.
"""
from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from typing import Optional

__all__ = ["FlightRecorder", "enable", "disable", "active", "record",
           "last_kind", "dump_on_signal", "KIND_OP", "KIND_COMM",
           "KIND_STEP", "KIND_USER", "KIND_CKPT", "KIND_DATA"]

KIND_OP = 0
KIND_COMM = 1
KIND_STEP = 2
KIND_USER = 3
#: checkpoint lifecycle (commit / restore)
KIND_CKPT = 4
#: data-pipeline state commits (where in the data the run was)
KIND_DATA = 5
_KIND_NAMES = {KIND_OP: "op", KIND_COMM: "comm", KIND_STEP: "step",
               KIND_USER: "user", KIND_CKPT: "ckpt", KIND_DATA: "data"}

DEFAULT_CAPACITY = 1024

#: the active recorder — read on every instrumented op, so a plain
#: module global
_active: Optional["FlightRecorder"] = None


class _PyRing:
    """Wrapping ring without a lock: the slot index comes from an
    ``itertools.count`` (atomic under the GIL), each slot holds one tuple
    assigned atomically, and readers order by the sequence number in the
    tuple, so a signal-time dump never deadlocks against a ``record`` it
    interrupted."""

    def __init__(self, capacity: int):
        import itertools
        self._cap = capacity
        self._slots = [None] * capacity
        self._counter = itertools.count()

    def record(self, kind, name, start_ns, end_ns, tid, aux, args=None):
        i = next(self._counter)
        self._slots[i % self._cap] = (
            i, kind, name, start_ns, end_ns, tid, aux, args)

    def events(self):
        slots = sorted((e for e in list(self._slots) if e is not None),
                       key=lambda e: e[0])
        out = []
        for _, kind, name, s, t, tid, aux, args in slots:
            d = {"kind": _KIND_NAMES.get(kind, str(kind)), "name": name,
                 "start_ns": s, "end_ns": t, "tid": tid, "aux": aux}
            if args:
                d["args"] = args
            out.append(d)
        return out

    def close(self):
        pass


class _NativeRing:
    """ctypes view of the ``fr_*`` seqlock ring in host_tracer.cpp."""

    def __init__(self, lib, capacity: int):
        if lib.fr_start(capacity) != 0:
            raise RuntimeError("the native flight-recorder ring is in use "
                               "or could not be allocated")
        self._lib = lib
        self._cap = capacity

    def record(self, kind, name, start_ns, end_ns, tid, aux, args=None):
        self._lib.fr_record(kind, name.encode()[:63], int(start_ns),
                            int(end_ns), int(tid), int(aux))

    def events(self):
        import ctypes
        lib = self._lib
        n = min(lib.fr_count(), self._cap)
        buf = ctypes.create_string_buffer(64)
        kind = ctypes.c_uint32()
        s, e = ctypes.c_uint64(), ctypes.c_uint64()
        tid, aux = ctypes.c_uint64(), ctypes.c_uint64()
        out = []
        for i in range(n):
            if lib.fr_read(i, ctypes.byref(kind), buf, 64, ctypes.byref(s),
                           ctypes.byref(e), ctypes.byref(tid),
                           ctypes.byref(aux)) == 0:
                out.append({
                    "kind": _KIND_NAMES.get(kind.value, str(kind.value)),
                    "name": buf.value.decode(errors="replace"),
                    "start_ns": s.value, "end_ns": e.value,
                    "tid": tid.value, "aux": aux.value})
        return out

    def close(self):
        self._lib.fr_stop()


def _rank_topology() -> dict:
    """Rank and world size for a postmortem header (``fleet.configure``);
    the port has no device mesh, so no ``topology`` entry."""
    from . import fleet
    return {"pid": os.getpid(), "rank": fleet.rank(),
            "world_size": fleet.world_size()}


def _dump_dir() -> str:
    from . import profile
    return profile.trace_dir()


class FlightRecorder:
    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 use_native: bool = True):
        self.capacity = capacity
        if use_native:
            from paddle_tpu_torch.profiler import _NativeTracer
            self._ring = _NativeRing(_NativeTracer.load(), capacity)
        else:
            self._ring = _PyRing(capacity)
        self.native = use_native
        self._dumped = None

    def record(self, kind, name, start_ns, end_ns, tid=0, aux=0, args=None):
        global _last_kind
        _last_kind = kind
        self._ring.record(kind, name, start_ns, end_ns, tid, aux, args)

    def events(self):
        return self._ring.events()

    def tail(self, n: int = 64) -> list:
        """The last ``n`` events, oldest first."""
        return self.events()[-n:]

    def dump(self, path: Optional[str] = None, reason: str = "manual") -> str:
        """Write the postmortem JSON; returns the path written."""
        info = _rank_topology()
        if path is None:
            d = _dump_dir()
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"flight_recorder_rank{info['rank']}_{os.getpid()}.json")
        doc = {"reason": reason, "unix_time": time.time(), **info,
               "capacity": self.capacity, "native_ring": self.native,
               "events": self.events(), **_ledger_appendix()}
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        self._dumped = path
        return path

    def close(self):
        self._ring.close()


_handlers = {"excepthook": None, "thread_hook": None, "signals": {}}


def _dump_on_crash(reason: str):
    rec = _active
    if rec is not None:
        try:
            path = rec.dump(reason=reason)
            print(f"[paddle_tpu_torch] flight recorder dumped to {path} "
                  f"({reason})", file=sys.stderr)
        except Exception:
            pass


def _signal_handler(sn, frame):
    _dump_on_crash(signal.Signals(sn).name)
    prev = _handlers["signals"].get(sn)
    if callable(prev):
        # the application's handler (a preemption listener's final save)
        # runs after the dump, never replaced by it
        prev(sn, frame)
    elif sn == signal.SIGTERM:
        # dump, then die with the conventional termination status
        signal.signal(sn, signal.SIG_DFL)
        os.kill(os.getpid(), sn)
    # SIGUSR1 with no prior handler is a live snapshot: keep running


def dump_on_signal(sn, prev_handler) -> None:
    """For a signal handler installed over the recorder's (the
    preemption listener's): dump the postmortem the recorder would have
    written for ``sn`` when ``prev_handler`` is the recorder's own."""
    if prev_handler is _signal_handler:
        _dump_on_crash(signal.Signals(sn).name)


def _install_handlers():
    prev_hook = sys.excepthook

    def hook(exc_type, exc, tb):
        _dump_on_crash(f"unhandled {exc_type.__name__}")
        prev_hook(exc_type, exc, tb)

    _handlers["excepthook"] = prev_hook
    sys.excepthook = hook

    # a thread's unhandled exception goes through threading.excepthook
    prev_thread_hook = threading.excepthook

    def thread_hook(args):
        if args.exc_type is not SystemExit:
            _dump_on_crash(
                f"unhandled {args.exc_type.__name__} in thread "
                f"{getattr(args.thread, 'name', '?')}")
        prev_thread_hook(args)

    _handlers["thread_hook"] = prev_thread_hook
    threading.excepthook = thread_hook

    if threading.current_thread() is threading.main_thread():
        for signum in (signal.SIGTERM, signal.SIGUSR1):
            try:
                _handlers["signals"][signum] = signal.signal(
                    signum, _signal_handler)
            except (ValueError, OSError):
                pass


def _uninstall_handlers():
    if _handlers["excepthook"] is not None:
        sys.excepthook = _handlers["excepthook"]
        _handlers["excepthook"] = None
    if _handlers["thread_hook"] is not None:
        threading.excepthook = _handlers["thread_hook"]
        _handlers["thread_hook"] = None
    for signum, old in _handlers["signals"].items():
        try:
            # only undo what is still ours: a handler installed over the
            # recorder's stays
            if signal.getsignal(signum) is _signal_handler:
                signal.signal(signum, old)
        except (ValueError, OSError):
            pass
    _handlers["signals"].clear()


def enable(capacity: int = DEFAULT_CAPACITY,
           use_native: bool = True) -> FlightRecorder:
    """Turn the recorder on (idempotent) and install the crash
    handlers."""
    global _active
    if _active is not None:
        return _active
    _active = FlightRecorder(capacity, use_native=use_native)
    _install_handlers()
    from paddle_tpu_torch import profiler
    profiler._rearm()
    return _active


def disable():
    global _active
    if _active is None:
        return
    _uninstall_handlers()
    rec, _active = _active, None
    from paddle_tpu_torch import profiler
    profiler._rearm()
    rec.close()


#: kind of the most recent event (a plain global: one store per record)
_last_kind = None


def last_kind() -> Optional[str]:
    """Name of the most recently recorded event kind (or None)."""
    return _KIND_NAMES.get(_last_kind)


def _ledger_appendix() -> dict:
    """Postmortem appendix: the goodput ledger's snapshot and the last
    numerics sample (the heartbeat bus is not ported, so no
    heartbeats). An appendix must never lose the ring dump itself."""
    out = {}
    try:
        from . import goodput
        snap = goodput.snapshot()
        if snap is not None:
            out["goodput"] = snap
    except Exception:
        pass
    try:
        from . import numerics
        ns = numerics.last_sample()
        if ns is not None:
            out["numerics"] = ns
    except Exception:
        pass
    return out


def active() -> Optional[FlightRecorder]:
    return _active


def record(kind, name, start_ns, end_ns, tid=0, aux=0, args=None):
    """Record one event iff the recorder is on (a no-op otherwise)."""
    rec = _active
    if rec is not None:
        rec.record(kind, name, start_ns, end_ns, tid, aux, args)
