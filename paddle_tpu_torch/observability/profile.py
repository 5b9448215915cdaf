"""On-demand device profiler capture — port of
``paddle_tpu/observability/profile.py``: bounded ``torch.profiler``
windows.

Production jobs need a small, bounded device-trace window cut out of a
live run, on demand:

- ``POST /debug/profile?seconds=N`` on the serving HTTP server —
  bounded (at most :data:`MAX_CAPTURE_SECONDS`), one capture at a time
  (``409`` while one is live), stopped by a background timer
  (:func:`start_timed_capture`);
- :func:`capture_for`, a blocking window, and :class:`StepWindow`, a
  window across a range of training steps.

A capture is a ``torch.profiler.profile`` over CPU and CUDA activity,
written as a Chrome trace (``trace.json``) into the capture's directory.
The profiler is entered and left on one holder thread, which the stop
call wakes: the CUDA activity it records is the whole process's (the
engine's run thread included), and exporting the trace never holds the
engine's lock. A capture that cannot start on the card raises: without
a CUDA device :func:`start_capture` raises ``RuntimeError`` (the server
answers 500), it never writes an empty trace. One capture at a time,
process-wide: :class:`CaptureBusy` while a window is open. The start and
stop go through module seams (``_start_trace`` / ``_stop_trace``), so
the arming logic is testable without a device.

The reference writes under ``PADDLE_TPU_TRACE_DIR`` and arms the fit
window from ``PADDLE_TPU_PROFILE_AT_STEP``; the port reads no
environment variable: :func:`set_trace_dir` (the temporary directory's
``paddle_tpu_torch_trace`` by default; the flight recorder's, the
watchdog's and the NaN-provenance files go there too) and
:func:`set_fit_window` carry them. ``Model.fit`` opens a
:class:`StepWindow` over the steps :func:`set_fit_window` names and
closes it in a ``finally``. ``paddle.profiler.Profiler``'s GPU target
takes the same slot: each of these sees :class:`CaptureBusy` while
another holds it.
"""
from __future__ import annotations

import os
import tempfile
import threading
import time
import warnings
from typing import Optional, Tuple

__all__ = ["CaptureBusy", "MAX_CAPTURE_SECONDS", "bound_seconds",
           "capture_active", "start_capture", "stop_capture",
           "capture_for", "start_timed_capture", "StepWindow",
           "set_trace_dir", "trace_dir", "set_fit_window", "fit_window",
           "TRACE_FILE"]

#: hard ceiling on one on-demand capture — device traces are large and
#: the serving endpoint must stay abuse-proof
MAX_CAPTURE_SECONDS = 120.0

#: the Chrome trace's name inside a capture directory
TRACE_FILE = "trace.json"


class CaptureBusy(RuntimeError):
    """A capture window is already open (one at a time, process-wide)."""


class _Holder:
    """The thread that holds one ``torch.profiler.profile`` open: enters
    it, signals, waits for the stop, leaves it and exports the trace."""

    def __init__(self, path: str):
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a device profiler capture needs a CUDA device; PyTorch "
                "sees none")
        self.path = path
        self._started = threading.Event()
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self.export_seconds: Optional[float] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="pt-profile-holder")
        self._thread.start()
        self._started.wait()
        if self._error is not None:
            self._thread.join()
            raise self._error

    def _run(self):
        from torch.profiler import ProfilerActivity, profile
        try:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        except BaseException as e:  # noqa: BLE001 — handed to the caller
            self._error = e
            self._started.set()
            return
        self._started.set()
        self._stop.wait()
        try:
            prof.__exit__(None, None, None)
            t0 = time.perf_counter()
            prof.export_chrome_trace(os.path.join(self.path, TRACE_FILE))
            self.export_seconds = time.perf_counter() - t0
        except BaseException as e:  # noqa: BLE001 — handed to the stop
            self._error = e

    def stop(self):
        self._stop.set()
        self._thread.join()
        if self._error is not None:
            raise self._error


_holder: Optional[_Holder] = None
#: seconds the last capture's ``export_chrome_trace`` took
last_export_seconds: Optional[float] = None


def _start_trace(path: str):  # seam — tests swap this out
    global _holder
    _holder = _Holder(path)


def _stop_trace():  # seam — tests swap this out
    global _holder, last_export_seconds
    h, _holder = _holder, None
    if h is not None:
        h.stop()
        last_export_seconds = h.export_seconds


_lock = threading.Lock()
_active_dir: Optional[str] = None
_trace_dir = {"path": None}


def set_trace_dir(path: Optional[str]):
    """Where captures are written (None = the default)."""
    _trace_dir["path"] = path


def trace_dir() -> str:
    return _trace_dir["path"] or os.path.join(tempfile.gettempdir(),
                                              "paddle_tpu_torch_trace")


def bound_seconds(seconds) -> float:
    """Validate + clamp a requested capture duration. Raises
    ``ValueError`` on garbage; clamps overlong requests to
    :data:`MAX_CAPTURE_SECONDS` (bounded is the contract, not an
    error)."""
    s = float(seconds)
    if not (s > 0):  # rejects 0, negatives AND NaN in one comparison
        raise ValueError(f"capture seconds must be > 0, got {seconds!r}")
    return min(s, MAX_CAPTURE_SECONDS)


def capture_active() -> Optional[str]:
    """The live capture's output directory, or None."""
    return _active_dir


def start_capture(label: str = "ondemand") -> str:
    """Open a device-trace window; returns the capture directory.
    Raises :class:`CaptureBusy` when one is already open, and whatever
    stopped the profiler from starting otherwise."""
    global _active_dir
    with _lock:
        if _active_dir is not None:
            raise CaptureBusy(
                f"device profiler capture already running "
                f"({_active_dir})")
        out = os.path.join(trace_dir(),
                           f"profile_{label}_{int(time.time() * 1e3)}")
        os.makedirs(out, exist_ok=True)
        _start_trace(out)
        _active_dir = out
        return out


def stop_capture() -> Optional[str]:
    """Close the live window; returns its directory (None if none was
    open — stop is idempotent so timer threads and finally-blocks can
    both call it)."""
    global _active_dir
    with _lock:
        if _active_dir is None:
            return None
        out = _active_dir
        try:
            _stop_trace()
        except Exception as e:  # noqa: BLE001
            warnings.warn(f"profiler capture {out} failed to stop: {e!r}",
                          RuntimeWarning, stacklevel=2)
        finally:
            # the slot stays taken until the trace is written, and a
            # failed stop must not wedge it shut
            _active_dir = None
        return out


def capture_for(seconds, label: str = "ondemand") -> str:
    """Blocking bounded capture."""
    s = bound_seconds(seconds)
    out = start_capture(label)
    try:
        time.sleep(s)
    finally:
        stop_capture()
    return out


def start_timed_capture(seconds, label: str = "serving") \
        -> Tuple[str, float]:
    """Non-blocking bounded capture (the HTTP endpoint's path): opens
    the window now, stops it from a daemon timer thread after
    ``seconds``. Returns ``(capture_dir, bounded_seconds)``."""
    s = bound_seconds(seconds)
    out = start_capture(label)

    def _stop_later():
        time.sleep(s)
        # only close OUR window — a capture that was stopped and
        # replaced before the timer fired must not be clipped
        if _active_dir == out:
            stop_capture()

    threading.Thread(target=_stop_later, daemon=True,
                     name="pt-profile-timer").start()
    return out, s


# ---------------------------------------------------------------------------
# step window
# ---------------------------------------------------------------------------

class StepWindow:
    """Start/stop a capture across a step interval (1-based,
    inclusive). Driven per step by a training loop; ``close()`` in the
    loop's finally so a window still open when training ends is
    flushed, not lost."""

    def __init__(self, start: int, stop: int, label: str = "fit"):
        if start < 1 or stop < start:
            raise ValueError(
                f"profile window needs 1 <= start <= stop, got "
                f"{start}:{stop}")
        self.start = int(start)
        self.stop = int(stop)
        self.label = label
        self._dir: Optional[str] = None
        self._done = False

    @property
    def capture_dir(self) -> Optional[str]:
        return self._dir

    def on_step(self, step: int):
        """Called entering each step; opens/closes the window at the
        configured edges. A busy capture slot skips this window with a
        warning instead of killing the loop."""
        if self._done:
            return
        if self._dir is None and self.start <= step <= self.stop:
            try:
                self._dir = start_capture(self.label)
            except CaptureBusy as e:
                warnings.warn(f"profile window skipped: {e}",
                              RuntimeWarning, stacklevel=2)
                self._done = True
                return
        elif self._dir is not None and step > self.stop:
            self.close()

    def close(self):
        if self._dir is not None:
            stop_capture()
        self._done = True


_fit_steps = {"range": None}


def set_fit_window(start: Optional[int] = None,
                   stop: Optional[int] = None):
    """The 1-based, inclusive step range ``Model.fit`` captures (the
    reference's ``PADDLE_TPU_PROFILE_AT_STEP=<start>:<stop>``; a lone
    ``start`` captures that step); ``set_fit_window()`` disarms it."""
    if start is None:
        _fit_steps["range"] = None
        return
    stop = start if stop is None else stop
    StepWindow(start, stop)  # validates
    _fit_steps["range"] = (int(start), int(stop))


def fit_window() -> Optional[StepWindow]:
    """A fresh :class:`StepWindow` over the configured range, or None."""
    r = _fit_steps["range"]
    return None if r is None else StepWindow(*r, label="fit")
