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
   each process writing the shards it owns (``owner = flat_pos %
   process_count``, reference :149-290); rank 0 writes the skeleton,
   merges every rank's shard records into ``index.json``, writes the
   ``COMMITTED`` marker and renames the directory to ``step_N``, the
   atomic publish.
3. With several processes, every rank publishes its records as
   ``shards.rank<r>.json`` (tmp + rename), and rank 0 commits only after
   every other rank has; the other ranks return once rank 0's fresh commit
   appears (its ``index.json`` differs from any earlier commit of the
   step id). This is a filesystem barrier, no collective: it runs in the
   writer thread while the main thread's collectives go on.
   ``process_index`` and ``process_count`` default to the process
   group's rank and size.

A ``DTensor`` leaf is gathered whole at the snapshot (``full_tensor``,
a collective every rank makes in the same order) and saved as the
reference saves a sharded array: the logical tensor, cut by the shard
grid. ``ckpt_*`` families (save and blocking seconds, bytes, in-flight,
last committed step, failures) go into the port's metrics registry. A
commit is a ``ckpt`` event of the flight recorder (``commit:step_<n>``,
with its bytes).
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .layout import (AUX_FILE, COMMIT_MARKER, FORMAT_VERSION, INDEX_FILE,
                     IO_WORKERS, TMP_SUFFIX, CheckpointError, crc32_of,
                     dtype_name,
                     dumps_skeleton, flatten_state, is_committed,
                     iter_shards, plan_grid, poll_until, step_dir_name,
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
    if hasattr(t, "full_tensor"):  # a DTensor: the logical tensor
        t = t.full_tensor()
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


def _dtype_of(arr) -> str:
    """The manifest's dtype name of a host leaf."""
    return str(arr.dtype) if isinstance(arr, np.ndarray) else \
        dtype_name(arr.dtype)


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


def _process_group() -> tuple:
    """(rank, size) of the process group, (0, 1) without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _rank_shards_file(rank: int) -> str:
    """A rank's records file, named by the job's attempt, so a relaunch
    never reads a killed attempt's residue in a reused ``step_N.tmp``."""
    from paddle_tpu_torch.distributed.env import job_namespace
    ns = job_namespace()
    return f"shards.rank{rank}.json" if ns == "0" else \
        f"shards.rank{rank}.e{ns}.json"


def write_step(root: str, step: int, snap: Snapshot, *,
               topology: Optional[dict] = None,
               metadata: Optional[dict] = None,
               process_index: Optional[int] = None,
               process_count: Optional[int] = None,
               fault_hook: Optional[Callable[[str], None]] = None,
               overwrite: bool = False,
               registry=None) -> str:
    """Write and atomically commit one step; returns the step dir.

    ``fault_hook(phase)`` is the crash-injection seam: it runs at
    ``"after_shards"`` and ``"before_commit"``, and raising from it
    leaves only the ``.tmp`` directory, as a kill there would."""
    if process_index is None or process_count is None:
        process_index, process_count = _process_group()
    topology = dict(topology or {})
    nshards = 1
    for v in topology.values():
        nshards *= int(v)
    nshards = max(nshards, process_count, 1)

    final_dir = os.path.join(root, step_dir_name(step))
    tmp_dir = final_dir + TMP_SUFFIX
    if os.path.isdir(final_dir) and not overwrite:
        raise CheckpointError(
            f"step {step} already committed at {final_dir!r}")
    if process_count == 1 and os.path.isdir(tmp_dir):
        # residue of a crashed save of this step; with several processes
        # no rank may remove a directory the others are writing into
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    snap.wait()

    entries: Dict[str, dict] = {}
    owned = []  # (record, host leaf, slices or None for the whole leaf)
    for key in sorted(snap.tensors):
        arr, ref = snap.tensors[key]
        shape = list(arr.shape)
        grid = plan_grid(shape, nshards)
        entry = {"shape": shape, "dtype": _dtype_of(arr), "grid": grid,
                 "kind": ref.kind, "shards": []}
        for flat_pos, offset, shard_shape, slices in iter_shards(shape,
                                                                 grid):
            owner = flat_pos % process_count
            rec = {"file": f"{key}_s{flat_pos:03d}.bin", "offset": offset,
                   "shape": shard_shape, "owner": owner}
            if owner == process_index:
                owned.append((rec, arr, None if grid == [1] * len(shape)
                              else slices))
            entry["shards"].append(rec)
        entries[key] = entry

    def write_shard(job) -> int:
        rec, arr, slices = job
        data = _raw(arr if slices is None else arr[slices])[1]
        rec["crc32"] = crc32_of(data)
        rec["nbytes"] = int(data.nbytes)
        _fsync_file(os.path.join(tmp_dir, rec["file"]), data)
        return int(data.nbytes)

    with ThreadPoolExecutor(IO_WORKERS) as pool:
        written = sum(pool.map(write_shard, owned))

    if process_index == 0:
        aux_crc = crc32_of(snap.skeleton_bytes)
        _fsync_file(os.path.join(tmp_dir, AUX_FILE), snap.skeleton_bytes)
        written += len(snap.skeleton_bytes)
    _fsync_dir(tmp_dir)
    if fault_hook is not None:
        fault_hook("after_shards")
    m = ckpt_metrics(registry)
    m["bytes"].inc(written, direction="write")

    # the identity of an earlier commit of this step id, taken before
    # this rank publishes its records (so before rank 0 can commit):
    # the barrier below tells that stale commit from rank 0's fresh one
    def commit_token():
        try:
            st = os.stat(os.path.join(final_dir, INDEX_FILE))
            return (st.st_ino, st.st_mtime_ns)
        except OSError:
            return None
    stale_token = commit_token()

    if process_count > 1:
        # every rank publishes its records (rank 0's stays in the step
        # directory, as the reference's does)
        rf = os.path.join(tmp_dir, _rank_shards_file(process_index))
        _fsync_file(rf + ".tmp", json.dumps(entries).encode())
        os.replace(rf + ".tmp", rf)  # published whole, never torn
    if process_index != 0:
        poll_until(lambda: is_committed(final_dir) and
                   commit_token() != stale_token,
                   what=f"rank 0's commit of step {step} "
                        f"(rank {process_index} barrier)")
        return final_dir

    # -- rank 0: merge the ranks' records, write the manifest, commit ------
    for r in range(1, process_count):
        path = os.path.join(tmp_dir, _rank_shards_file(r))
        poll_until(lambda: os.path.exists(path),
                   what=f"rank {r}'s shard records for step {step}")
        with open(path) as f:
            theirs = json.load(f)
        for key, entry in theirs.items():
            mine = entries[key]["shards"]
            for pos, rec in enumerate(entry["shards"]):
                if rec.get("owner") == r:
                    mine[pos] = rec
        os.unlink(path)

    doc = {"format_version": FORMAT_VERSION, "step": int(step),
           "world_size": process_count, "topology": topology,
           "tensors": entries,
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
