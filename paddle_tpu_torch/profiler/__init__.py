"""``paddle.profiler`` — port of ``paddle_tpu/profiler/__init__.py``: the
host tracer, the device capture and the chrome-trace export.

Three layers, as in the reference: ``RecordEvent`` spans at every op
dispatch (``ops/_registry.py``), at ``PyLayer``, ``to_static`` and
``TrainStep``; tracers that collect them (the lock-free ring of
``native/host_tracer.cpp``, or a Python list); and the sinks
(:meth:`Profiler.export_chrome_tracing`, :meth:`Profiler.summary`).

* **Host side.** While a :class:`Profiler` records, each span goes to
  the native ring (``ht_*``), compiled from ``native/host_tracer.cpp``
  with ``g++ -O2 -shared`` at first use into this package's ``_build``
  directory (the reference builds into ``native/build``, whose files are
  its own). A failed build raises. Spans with arguments (collectives,
  ``record_shapes=True``) go to a Python list, which ``record_shapes``
  picks for every span, as in the reference. Every span also feeds the
  flight recorder's ring when that is on, profiler active or not.
* **Collectives.** Spans of category ``comm`` (``observability.comm``)
  render on a dedicated "collectives" lane with a cumulative-bytes
  counter track in the chrome export.
* **Device side.** ``ProfilerTarget.GPU`` in ``targets`` opens a
  ``torch.profiler`` capture over CPU and CUDA activity for each record
  window, through ``observability.profile``'s one process-wide slot: a
  second capture (the fit window, ``POST /debug/profile``) gets
  ``CaptureBusy``, and a capture that cannot start raises (the reference
  swallows both, :351 and :367). :meth:`Profiler.export_chrome_tracing`
  writes each window's device trace beside the host trace.
  ``ProfilerTarget.TPU`` raises ``ValueError``.

Disarmed, an instrumented op pays one module-attribute read
(:data:`_armed`, set while a profiler records or the flight recorder is
on).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Callable, List, Optional

__all__ = ["Profiler", "RecordEvent", "ProfilerTarget", "make_scheduler",
           "export_chrome_tracing", "load_profiler_result", "record_op"]

_state = {"active": None}

#: True while a Profiler records or the flight recorder is on: the one
#: attribute the op dispatcher reads when everything is off
_armed = False

#: synthetic chrome-trace lane for collective spans (thread_name metadata
#: names it "collectives" in the viewer)
_COMM_TID = 1 << 20

_flight_mod = None


def _flight():
    """The flight-recorder module (lazy: the observability package
    imports this one)."""
    global _flight_mod
    if _flight_mod is None:
        from paddle_tpu_torch.observability import flight_recorder
        _flight_mod = flight_recorder
    return _flight_mod


def _rearm():
    """Recompute :data:`_armed` (a profiler started or stopped, the
    flight recorder was enabled or disabled)."""
    global _armed
    _armed = _state["active"] is not None or \
        _flight()._active is not None


_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "native",
                       "host_tracer.cpp")
_BUILD_DIR = os.path.join(_HERE, "_build")


class _NativeTracer:
    """ctypes binding to the C++ lock-free event rings of
    ``native/host_tracer.cpp``: the profiler's (``ht_*``) and the flight
    recorder's wrapping seqlock ring (``fr_*``). Built on first use;
    a missing source or a failed compile raises ``RuntimeError``."""

    _lib = None
    _lock = threading.Lock()

    @classmethod
    def library_path(cls) -> str:
        import hashlib
        with open(_SOURCE, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        return os.path.join(_BUILD_DIR, f"libhost_tracer-{digest}.so")

    @classmethod
    def load(cls):
        if cls._lib is not None:
            return cls._lib
        import ctypes
        import fcntl
        import subprocess
        with cls._lock:
            if cls._lib is not None:
                return cls._lib
            if not os.path.exists(_SOURCE):
                raise RuntimeError(
                    f"the host tracer's source {_SOURCE} is missing")
            so = cls.library_path()
            os.makedirs(_BUILD_DIR, exist_ok=True)
            if not os.path.exists(so):
                # one compile across processes (parallel test workers):
                # the second re-checks under the lock
                with open(os.path.join(_BUILD_DIR, "build.lock"), "w") \
                        as lf:
                    fcntl.flock(lf, fcntl.LOCK_EX)
                    try:
                        if not os.path.exists(so):
                            tmp = f"{so}.{os.getpid()}.tmp"
                            proc = subprocess.run(
                                ["g++", "-O2", "-std=c++17", "-shared",
                                 "-fPIC", _SOURCE, "-o", tmp],
                                capture_output=True, text=True)
                            if proc.returncode != 0:
                                raise RuntimeError(
                                    "g++ failed to build the host tracer "
                                    f"(exit {proc.returncode}):\n"
                                    f"{proc.stderr}")
                            os.replace(tmp, so)
                    finally:
                        fcntl.flock(lf, fcntl.LOCK_UN)
            lib = ctypes.CDLL(so)
            u64, u32 = ctypes.c_uint64, ctypes.c_uint32
            lib.ht_start.argtypes = [u64]
            lib.ht_start.restype = ctypes.c_int
            lib.ht_record.argtypes = [ctypes.c_char_p, u64, u64, u64]
            lib.ht_count.restype = u64
            lib.ht_capacity.restype = u64
            lib.ht_read.argtypes = [u64, ctypes.c_char_p, u64,
                                    ctypes.POINTER(u64), ctypes.POINTER(u64),
                                    ctypes.POINTER(u64)]
            lib.ht_read.restype = ctypes.c_int
            lib.fr_start.argtypes = [u64]
            lib.fr_start.restype = ctypes.c_int
            lib.fr_record.argtypes = [u32, ctypes.c_char_p, u64, u64, u64,
                                      u64]
            lib.fr_count.restype = u64
            lib.fr_read.argtypes = [u64, ctypes.POINTER(u32),
                                    ctypes.c_char_p, u64,
                                    ctypes.POINTER(u64), ctypes.POINTER(u64),
                                    ctypes.POINTER(u64), ctypes.POINTER(u64)]
            lib.fr_read.restype = ctypes.c_int
            cls._lib = lib
            return lib

    @classmethod
    def drain(cls, into: list):
        """Copy every recorded event out of the profiler ring and free
        it."""
        import ctypes
        lib = cls._lib
        n = min(lib.ht_count(), lib.ht_capacity())
        buf = ctypes.create_string_buffer(64)
        s, e, t = ctypes.c_uint64(), ctypes.c_uint64(), ctypes.c_uint64()
        for i in range(n):
            if lib.ht_read(i, buf, 64, ctypes.byref(s), ctypes.byref(e),
                           ctypes.byref(t)) == 0:
                into.append(_Event(buf.value.decode(errors="replace"),
                                   s.value, e.value, t.value))
        lib.ht_stop()


class ProfilerTarget:
    CPU = "cpu"
    GPU = "gpu"
    CUSTOM_DEVICE = "custom_device"
    TPU = "tpu"


class _Event:
    __slots__ = ("name", "start", "end", "tid", "args", "cat")

    def __init__(self, name, start, end, tid, args=None, cat="op"):
        self.name = name
        self.start = start
        self.end = end
        self.tid = tid
        self.args = args
        self.cat = cat


def _emit_event(name, start, end, tid=None, args=None, cat="op"):
    """Append one finished span to the active profiler (the comm tracer's
    path: spans with arguments always take the Python list)."""
    prof = _state["active"]
    if prof is None:
        return
    prof._events.append(_Event(
        name, start, end, tid if tid is not None else threading.get_ident(),
        args, cat))


class RecordEvent:
    """RAII host span (``paddle.profiler.RecordEvent``), as a context
    manager or a ``begin()``/``end()`` pair; a no-op while no profiler
    records and the flight recorder is off."""

    __slots__ = ("name", "args", "cat", "_t0")

    def __init__(self, name: str, event_type=None, args=None, cat="op"):
        self.name = name
        self.args = args
        self.cat = cat
        self._t0 = None

    def begin(self):
        if _armed:
            self._t0 = time.perf_counter_ns()

    def end(self):
        if self._t0 is None:
            return
        t0, self._t0 = self._t0, None
        t1 = time.perf_counter_ns()
        tid = threading.get_ident()
        prof = _state["active"]
        if prof is not None:
            if prof._native_lib is not None and self.args is None and \
                    self.cat == "op":
                prof._native_lib.ht_record(self.name.encode(), t0, t1, tid)
            else:
                prof._events.append(_Event(self.name, t0, t1, tid,
                                           self.args, self.cat))
        fr = _flight()._active
        if fr is not None:
            fr.record(_flight_mod.KIND_OP, self.name, t0, t1, tid=tid,
                      args=self.args)

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def record_op(name: str, inputs=None):
    """The op dispatcher's hook: a started :class:`RecordEvent`, or None
    when neither a profiler nor the flight recorder is on. ``inputs``
    (the op's operands) feeds ``record_shapes``: the span's ``args``
    carries each operand's shape."""
    if not _armed:
        return None
    prof = _state["active"]
    args = None
    if prof is not None and prof._record_shapes and inputs is not None:
        args = {"input_shapes": [list(getattr(a, "shape", ()))
                                 for a in inputs]}
    ev = RecordEvent(name, args=args)
    ev.begin()
    return ev


def make_scheduler(closed: int = 0, ready: int = 0, record: int = 1,
                   repeat: int = 0, skip_first: int = 0) -> Callable[[int],
                                                                     str]:
    """The CLOSED/READY/RECORD state machine of Paddle's
    ``profiler.make_scheduler``."""
    if record < 1:
        raise ValueError("record period must be >= 1")
    if min(closed, ready, repeat, skip_first) < 0:
        raise ValueError("scheduler periods must be non-negative")
    period = closed + ready + record

    def schedule(step: int) -> str:
        if step < skip_first:
            return "closed"
        s = step - skip_first
        if repeat and s >= repeat * period:
            return "closed"
        pos = s % period
        if pos < closed:
            return "closed"
        if pos < closed + ready:
            return "ready"
        return "record"
    return schedule


class Profiler:
    """Paddle's ``profiler.Profiler``.

    ``record_shapes`` attaches operand shapes to op spans (the Python
    event list: the native ring stores no arguments). ``timer_only``
    collects no events and keeps only the per-step wall clock of
    :meth:`step_info`. ``ProfilerTarget.GPU`` adds a device capture for
    each record window (see the module docstring)."""

    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, record_shapes=False, profile_memory=False,
                 with_flops=False, emit_nvtx=False):
        self._targets = list(targets or [ProfilerTarget.CPU])
        if ProfilerTarget.TPU in self._targets:
            raise ValueError(
                "ProfilerTarget.TPU: this port runs on a CUDA device; "
                "capture it with ProfilerTarget.GPU")
        self._scheduler = scheduler
        self._on_trace_ready = on_trace_ready
        self._timer_only = timer_only
        self._record_shapes = record_shapes
        self._events: List[_Event] = []
        self._step = 0
        self._recording = False
        self._capture_dir: Optional[str] = None
        #: the finished device captures' directories, one a record window
        self.device_trace_dirs: List[str] = []
        self._native_lib = None
        self._step_marks: List[int] = []

    # -- lifecycle ------------------------------------------------------------
    def start(self):
        self._step = 0
        self._step_marks = [time.perf_counter_ns()]
        self._apply_state()
        return self

    def stop(self):
        self._step_marks.append(time.perf_counter_ns())
        self._stop_recording()
        if self._on_trace_ready is not None:
            self._on_trace_ready(self)
        return self

    def step(self, num_samples=None):
        self._step += 1
        self._step_marks.append(time.perf_counter_ns())
        self._apply_state()

    def step_info(self, unit: str = "ms") -> dict:
        """Per-step wall-clock stats from the ``step()`` marks."""
        scale = {"ms": 1e6, "us": 1e3, "s": 1e9}[unit]
        durs = [(b - a) / scale for a, b in
                zip(self._step_marks, self._step_marks[1:])]
        if not durs:
            return {"steps": 0}
        return {"steps": len(durs),
                f"avg_{unit}": sum(durs) / len(durs),
                f"min_{unit}": min(durs), f"max_{unit}": max(durs)}

    def _apply_state(self):
        state = "record" if self._scheduler is None \
            else self._scheduler(self._step)
        if state == "record" and not self._recording:
            self._start_recording()
        elif state != "record" and self._recording:
            self._stop_recording()

    def _start_recording(self):
        if self._timer_only:
            self._recording = True
            return  # step timing only: no event capture, no native ring
        if _state["active"] is not None and _state["active"] is not self:
            raise RuntimeError("another Profiler is already recording")
        if not self._record_shapes:
            lib = _NativeTracer.load()
            if lib.ht_start(1 << 20) != 0:
                raise RuntimeError("the native host-tracer ring is busy or "
                                   "could not be allocated")
            self._native_lib = lib
        if ProfilerTarget.GPU in self._targets:
            from paddle_tpu_torch.observability import profile
            try:
                self._capture_dir = profile.start_capture("profiler")
            except BaseException:
                if self._native_lib is not None:
                    self._native_lib.ht_stop()
                    self._native_lib = None
                raise
        self._recording = True
        _state["active"] = self
        _rearm()

    def _stop_recording(self):
        if not self._recording:
            return
        self._recording = False
        if _state["active"] is self:
            _state["active"] = None
            _rearm()
        if self._native_lib is not None:
            _NativeTracer.drain(self._events)
            self._native_lib = None
        if self._capture_dir is not None:
            from paddle_tpu_torch.observability import profile
            out, self._capture_dir = self._capture_dir, None
            if profile.capture_active() == out:
                profile.stop_capture()
            self.device_trace_dirs.append(out)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- sinks ----------------------------------------------------------------
    def export_chrome_tracing(self, dir_name: str,
                              worker_name: Optional[str] = None) -> str:
        """Write the host spans as ``<worker>.pb.trace.json`` (chrome
        trace, microseconds) and copy each device capture's trace beside
        it as ``<worker>.device<i>.pt.trace.json``. Returns the host
        trace's path."""
        os.makedirs(dir_name, exist_ok=True)
        worker = worker_name or "host"
        path = os.path.join(dir_name, f"{worker}.pb.trace.json")
        evs = sorted(self._events, key=lambda e: e.start)
        events = []
        if any(e.cat == "comm" for e in evs):
            events.append({"ph": "M", "name": "thread_name", "pid": 0,
                           "tid": _COMM_TID,
                           "args": {"name": "collectives"}})
        comm_cum = 0
        for e in evs:
            d = {"name": e.name, "ph": "X", "cat": e.cat or "op",
                 "ts": e.start / 1000.0, "dur": (e.end - e.start) / 1000.0,
                 "pid": 0, "tid": _COMM_TID if e.cat == "comm" else e.tid}
            if e.args:
                d["args"] = dict(e.args)
            events.append(d)
            if e.cat == "comm":
                comm_cum += int((e.args or {}).get("bytes", 0))
                events.append({"name": "comm_bytes", "ph": "C", "pid": 0,
                               "ts": e.start / 1000.0,
                               "args": {"bytes": comm_cum}})
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        from paddle_tpu_torch.observability.profile import TRACE_FILE
        for i, d in enumerate(self.device_trace_dirs):
            src = os.path.join(d, TRACE_FILE)
            if os.path.exists(src):
                shutil.copyfile(src, os.path.join(
                    dir_name, f"{worker}.device{i}.pt.trace.json"))
        return path

    def summary(self, sorted_by="total", op_detail=True, thread_sep=False,
                time_unit="ms"):
        """Aggregated per-op table (calls, total, max, average); printed,
        and returned as ``[(name, (total_ns, calls, max_ns))]``."""
        agg = {}
        for e in self._events:
            tot, cnt, mx = agg.get(e.name, (0, 0, 0))
            dur = e.end - e.start
            agg[e.name] = (tot + dur, cnt + 1, max(mx, dur))
        rows = sorted(agg.items(), key=lambda kv: -kv[1][0])
        unit = {"ms": 1e6, "us": 1e3, "s": 1e9}[time_unit]
        lines = [f"{'name':<40}{'calls':>8}{'total':>12}{'max':>12}"
                 f"{'avg':>12}  ({time_unit})"]
        for name, (tot, cnt, mx) in rows:
            lines.append(f"{name[:39]:<40}{cnt:>8}{tot / unit:>12.3f}"
                         f"{mx / unit:>12.3f}{tot / cnt / unit:>12.3f}")
        print("\n".join(lines))
        return rows

    @property
    def events(self):
        return list(self._events)


def export_chrome_tracing(dir_name: str, worker_name=None):
    """An ``on_trace_ready`` callback that exports to ``dir_name``."""
    def handler(prof: Profiler):
        prof.export_chrome_tracing(dir_name, worker_name)
    return handler


def load_profiler_result(path: str):
    with open(path) as f:
        return json.load(f)
