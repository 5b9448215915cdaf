"""Async checkpoint writer with atomic commit — port of
``paddle_tpu/checkpoint/writer.py``.

Save path (``CheckpointManager.save`` drives it):

1. **Snapshot** (the caller's thread): :func:`snapshot` takes an owned
   host copy of every tensor and array of the state and pickles the
   skeleton. A CUDA tensor is copied with ``non_blocking=True`` into
   page-locked memory on the current stream, and an event is recorded
   after the last copy. Stream order is what keeps the copy whole: the
   next step's kernels (``fused_adam_update`` overwrites the parameters
   and moments in place, and ``Optimizer.state_dict()`` returns views of
   them) are queued behind the copies on the same stream. The host
   reads a buffer only after the event has completed
   (:meth:`Snapshot.wait`), and the writer thread touches host memory
   only, never a CUDA tensor.
2. **Write** (one background thread, FIFO, for async saves): shards go
   into ``step_N.tmp/`` as fsynced raw C-order files with their crc32,
   then ``index.json``, the ``COMMITTED`` marker, and the rename to
   ``step_N``, which is the atomic publish.

The port writes from one process: every shard is owned by rank 0.
``ckpt_*`` families (save and blocking seconds, bytes, in-flight,
last committed step, failures) go into the port's metrics registry.

A commit is a ``ckpt`` event of the flight recorder
(``commit:step_<n>``, with its bytes). Not ported yet: saves from more
than one process (``process_count > 1`` raises).
"""
from __future__ import annotations

import os
import queue
import shutil
import threading
import time
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .layout import (AUX_FILE, COMMIT_MARKER, FORMAT_VERSION, TMP_SUFFIX,
                     CheckpointError, crc32_of, dtype_name, dumps_skeleton,
                     flatten_state, iter_shards, plan_grid, step_dir_name,
                     write_index)

__all__ = ["Snapshot", "snapshot", "SaveFuture", "write_step",
           "AsyncCheckpointWriter", "ckpt_metrics"]


def ckpt_metrics(registry=None) -> dict:
    """The ``ckpt_*`` metric families (created on first use)."""
    from paddle_tpu_torch.observability.metrics import get_registry
    r = registry or get_registry()
    return {
        "save_seconds": r.histogram(
            "ckpt_save_seconds",
            "snapshot->commit wall time per save, by mode"),
        "blocking_seconds": r.histogram(
            "ckpt_blocking_seconds",
            "time save() blocked its caller (the step-loop stall), by mode"),
        "restore_seconds": r.histogram(
            "ckpt_restore_seconds", "restore wall time"),
        "bytes": r.counter(
            "ckpt_bytes_total", "checkpoint bytes, by direction"),
        "in_flight": r.gauge(
            "ckpt_in_flight", "async saves snapshotted but not committed"),
        "last_step": r.gauge(
            "ckpt_last_committed_step", "most recently committed step"),
        "failures": r.counter(
            "ckpt_failures_total", "failed saves / integrity errors, by kind"),
        "gc_removed": r.counter(
            "ckpt_gc_removed_total", "step dirs removed by retention GC"),
    }


def _host_copy(value):
    """An owned host copy of one leaf: (copy, whether it waits on the
    snapshot's event)."""
    if isinstance(value, np.ndarray):
        return np.array(value, copy=True), False
    t = value.detach()
    if t.is_cuda:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host, True
    return t.clone(memory_format=torch.contiguous_format), False


class Snapshot:
    """Host-side copy of one state tree, decoupled from device storage.
    ``tensors`` maps ref key -> (host tensor or numpy array, ref); read
    none of them before :meth:`wait`."""

    def __init__(self, skeleton_bytes: bytes, tensors: Dict[str, tuple],
                 nbytes: int, seconds: float, event=None):
        self.skeleton_bytes = skeleton_bytes
        self.tensors = tensors
        self.nbytes = nbytes
        self.seconds = seconds
        self._event = event

    def wait(self):
        """Block until the device-to-host copies have landed."""
        if self._event is not None:
            self._event.synchronize()
            self._event = None


def snapshot(state) -> Snapshot:
    """Owned host copy of ``state`` (module docstring, phase 1). Returns
    once the copies are queued; ``Snapshot.wait`` waits for them."""
    t0 = time.perf_counter()
    skeleton, leaves = flatten_state(state)
    tensors, event = {}, None
    for key, (value, ref) in leaves.items():
        host, on_device = _host_copy(value)
        if on_device and event is None:
            event = torch.cuda.Event()
        tensors[key] = (host, ref)
    if event is not None:
        event.record()  # after every copy, on the current stream
    nbytes = sum(int(a.nbytes) for a, _ in tensors.values())
    skel = dumps_skeleton(skeleton)
    return Snapshot(skel, tensors, nbytes + len(skel),
                    time.perf_counter() - t0, event)


def _raw(arr):
    """(manifest dtype name, C-order raw bytes view) of a host leaf."""
    if isinstance(arr, np.ndarray):
        return str(arr.dtype), np.ascontiguousarray(arr).reshape(-1).view(
            np.uint8)
    return dtype_name(arr.dtype), arr.contiguous().reshape(-1).view(
        torch.uint8).numpy()


class SaveFuture:
    """Handle for one save; ``wait()`` blocks until commit (or re-raises
    the writer's failure)."""

    def __init__(self, step: int):
        self.step = step
        self._ev = threading.Event()
        self._exc: Optional[BaseException] = None
        self._result: Optional[str] = None

    def _finish(self, result: Optional[str], exc=None):
        self._result = result
        self._exc = exc
        self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set()

    def exception(self) -> Optional[BaseException]:
        return self._exc

    def wait(self, timeout: Optional[float] = None) -> str:
        """Block until this save committed; returns the step directory."""
        if not self._ev.wait(timeout):
            raise TimeoutError(
                f"checkpoint save of step {self.step} not finished "
                f"in {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._result


def _fsync_file(path: str, data):
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_step(root: str, step: int, snap: Snapshot, *,
               topology: Optional[dict] = None,
               metadata: Optional[dict] = None,
               process_index: int = 0, process_count: int = 1,
               fault_hook: Optional[Callable[[str], None]] = None,
               overwrite: bool = False,
               registry=None) -> str:
    """Write and atomically commit one step; returns the step dir.

    ``fault_hook(phase)`` is the crash-injection seam: it runs at
    ``"after_shards"`` and ``"before_commit"``, and raising from it
    leaves only the ``.tmp`` directory, as a kill there would."""
    if process_count != 1 or process_index != 0:
        raise NotImplementedError(
            "checkpoint saves from more than one process are not ported "
            "to paddle_tpu_torch yet")
    topology = dict(topology or {})
    nshards = 1
    for v in topology.values():
        nshards *= int(v)

    final_dir = os.path.join(root, step_dir_name(step))
    tmp_dir = final_dir + TMP_SUFFIX
    if os.path.isdir(final_dir) and not overwrite:
        raise CheckpointError(
            f"step {step} already committed at {final_dir!r}")
    if os.path.isdir(tmp_dir):
        shutil.rmtree(tmp_dir)  # residue of a crashed save of this step
    os.makedirs(tmp_dir)
    snap.wait()

    entries: Dict[str, dict] = {}
    written = 0
    for key in sorted(snap.tensors):
        arr, ref = snap.tensors[key]
        shape = list(arr.shape)
        dt, flat = _raw(arr)
        grid = plan_grid(shape, nshards)
        entry = {"shape": shape, "dtype": dt, "grid": grid,
                 "kind": ref.kind, "shards": []}
        for flat_pos, offset, shard_shape, slices in iter_shards(shape,
                                                                 grid):
            fname = f"{key}_s{flat_pos:03d}.bin"
            data = flat if grid == [1] * len(shape) else _raw(
                arr[slices])[1]
            rec = {"file": fname, "offset": offset, "shape": shard_shape,
                   "owner": 0, "crc32": crc32_of(data),
                   "nbytes": int(data.nbytes)}
            _fsync_file(os.path.join(tmp_dir, fname), data)
            written += int(data.nbytes)
            entry["shards"].append(rec)
        entries[key] = entry

    aux_crc = crc32_of(snap.skeleton_bytes)
    _fsync_file(os.path.join(tmp_dir, AUX_FILE), snap.skeleton_bytes)
    written += len(snap.skeleton_bytes)
    _fsync_dir(tmp_dir)
    if fault_hook is not None:
        fault_hook("after_shards")
    m = ckpt_metrics(registry)
    m["bytes"].inc(written, direction="write")

    doc = {"format_version": FORMAT_VERSION, "step": int(step),
           "world_size": 1, "topology": topology, "tensors": entries,
           "aux": {"file": AUX_FILE, "crc32": aux_crc,
                   "nbytes": len(snap.skeleton_bytes)},
           "metadata": dict(metadata or {})}
    write_index(tmp_dir, doc)
    _fsync_dir(tmp_dir)
    if fault_hook is not None:
        fault_hook("before_commit")

    # marker first, then the rename: the rename is the atomic publish
    _fsync_file(os.path.join(tmp_dir, COMMIT_MARKER), b"1\n")
    _fsync_dir(tmp_dir)
    aside = None
    if overwrite and os.path.isdir(final_dir):
        # move the old commit aside first: no instant without a commit
        aside = final_dir + ".old"
        if os.path.isdir(aside):
            shutil.rmtree(aside)
        os.rename(final_dir, aside)
    os.rename(tmp_dir, final_dir)
    if aside is not None:
        shutil.rmtree(aside, ignore_errors=True)
    _fsync_dir(root)
    m["last_step"].set(int(step))
    from paddle_tpu_torch.observability import flight_recorder
    now = time.perf_counter_ns()
    flight_recorder.record(
        flight_recorder.KIND_CKPT, f"commit:step_{int(step)}", now, now,
        aux=int(step), args={"step": int(step), "bytes": written})
    return final_dir


class AsyncCheckpointWriter:
    """One background thread draining a FIFO save queue, so saves commit
    in submission order (reference :314)."""

    def __init__(self, registry=None):
        self._q: "queue.Queue" = queue.Queue()
        self._m = ckpt_metrics(registry)
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    def _ensure_thread(self):
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name="pt-ckpt-writer", daemon=True)
                self._thread.start()

    def submit(self, fn: Callable[[], str], step: int) -> SaveFuture:
        if self._closed:
            raise CheckpointError("writer is closed")
        fut = SaveFuture(step)
        self._m["in_flight"].inc()
        self._q.put((fn, fut))
        self._ensure_thread()
        return fut

    def _run(self):
        while True:
            try:
                fn, fut = self._q.get(timeout=0.2)
            except queue.Empty:
                with self._lock:
                    # exit when drained; under the submit lock, so a
                    # concurrent submit sees this thread alive or starts
                    # another
                    if self._closed or self._q.empty():
                        self._thread = None
                        return
                continue
            try:
                fut._finish(fn())
            except BaseException as e:  # noqa: BLE001 — the future has it
                self._m["failures"].inc(kind="save")
                warnings.warn(
                    f"background checkpoint save of step {fut.step} "
                    f"failed: {type(e).__name__}: {e} (sync callers "
                    f"re-raise from wait())", RuntimeWarning)
                fut._finish(None, e)
            finally:
                self._m["in_flight"].dec()
                self._q.task_done()

    def wait_all(self, timeout: Optional[float] = None):
        """Block until every submitted save finished (committed or failed)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while self._q.unfinished_tasks:
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("checkpoint writer queue not drained")
            time.sleep(0.005)

    def close(self, timeout: Optional[float] = None):
        self.wait_all(timeout)
        self._closed = True
