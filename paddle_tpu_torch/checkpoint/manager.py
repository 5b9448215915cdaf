"""CheckpointManager — port of ``paddle_tpu/checkpoint/manager.py``.

Owns one checkpoint root full of ``step_N`` directories:

* ``save(step, state)`` — async by default: the caller pays the snapshot
  (queuing the device-to-host copies and pickling the skeleton), and the
  background writer writes the shards and commits atomically. Returns a
  :class:`SaveFuture`.
* ``restore(step=None, device=None)`` — the latest (or given) committed
  step, every shard crc-checked, tensors on ``device`` (``None``: the
  CUDA card). A corrupt step warns loudly, bumps
  ``ckpt_failures_total{kind="integrity"}`` and falls back to the
  previous committed step, unless that step was asked for by number or
  ``strict`` is set.
* ``latest_step()`` / ``all_steps()`` / ``metadata(step)``.
* keep-last-k retention GC by commit recency after every commit, which
  also sweeps ``.tmp`` directories of aborted saves in a single-process
  job (with several, another rank's save in flight looks the same).

``restore(mesh=)`` places every tensor onto the port's process mesh
(``reshard.place_on_mesh``); the writing topology defaults to the
current mesh's (``distributed.get_mesh``), and a save from several
processes writes each rank's shards (``writer.write_step``).
"""
from __future__ import annotations

import os
import shutil
import sys
import time
import warnings
from typing import Callable, List, Optional

from .layout import (INDEX_FILE, STEP_PREFIX, TMP_SUFFIX, CheckpointError,
                     CheckpointIntegrityError, is_committed,
                     list_committed_steps, parse_step_dir, read_index,
                     step_dir_name)
from .reshard import mesh_topology, read_state
from .writer import (AsyncCheckpointWriter, SaveFuture, ckpt_metrics,
                     snapshot, write_step)

__all__ = ["CheckpointManager", "load_state_dir"]


class CheckpointManager:
    """``topology``: axis name -> size recorded in the manifest and used
    to pick shard grids (default: the current mesh's, ``{}`` without
    one). ``fault_hook`` is forwarded to :func:`writer.write_step`."""

    def __init__(self, root: str, keep_last_k: Optional[int] = None,
                 async_: bool = True, topology: Optional[dict] = None,
                 registry=None,
                 fault_hook: Optional[Callable[[str], None]] = None):
        self.root = str(root)
        self.keep_last_k = keep_last_k
        self.async_ = bool(async_)
        self.registry = registry
        self.fault_hook = fault_hook
        self._topology = None if topology is None else dict(topology)
        self._writer = AsyncCheckpointWriter(registry)
        self._m = ckpt_metrics(registry)
        self.last_restored_step: Optional[int] = None
        os.makedirs(self.root, exist_ok=True)

    # -- save ----------------------------------------------------------------
    def topology(self) -> dict:
        if self._topology is not None:
            return dict(self._topology)
        mesh = sys.modules.get("paddle_tpu_torch.distributed.mesh")
        return mesh_topology(mesh.get_mesh()) if mesh is not None else {}

    def save(self, step: int, state, async_: Optional[bool] = None,
             metadata: Optional[dict] = None,
             overwrite: bool = False) -> SaveFuture:
        """Snapshot ``state`` and persist it as ``step``. An async save
        returns after the snapshot; ``fut.wait()`` blocks until the
        commit. A sync save commits before returning. ``overwrite`` lets
        a re-run replace a committed step id (else it raises)."""
        use_async = self.async_ if async_ is None else bool(async_)
        mode = "async" if use_async else "sync"
        t0 = time.perf_counter()
        snap = snapshot(state)
        topo = self.topology()

        def write() -> str:
            t1 = time.perf_counter()
            path = write_step(self.root, step, snap, topology=topo,
                              metadata=metadata, fault_hook=self.fault_hook,
                              overwrite=overwrite, registry=self.registry)
            self._m["save_seconds"].observe(
                snap.seconds + (time.perf_counter() - t1), mode=mode)
            self._gc()
            return path

        # both modes go through the one writer thread: saves and the GC
        # after each commit are strictly serialized
        fut = self._writer.submit(write, step)
        if use_async:
            self._m["blocking_seconds"].observe(
                time.perf_counter() - t0, mode=mode)
            return fut
        try:
            fut.wait()  # re-raises a failed sync save in the caller
        finally:
            self._m["blocking_seconds"].observe(
                time.perf_counter() - t0, mode=mode)
        return fut

    def wait_all(self, timeout: Optional[float] = None):
        """Drain every in-flight async save."""
        self._writer.wait_all(timeout)

    def close(self, timeout: Optional[float] = None):
        self._writer.close(timeout)

    # -- discovery -----------------------------------------------------------
    def all_steps(self) -> List[int]:
        return list_committed_steps(self.root)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def step_dir(self, step: int) -> str:
        return os.path.join(self.root, step_dir_name(step))

    def metadata(self, step: int) -> dict:
        return read_index(self.step_dir(step)).get("metadata", {})

    # -- restore -------------------------------------------------------------
    def restore(self, step: Optional[int] = None, mesh=None,
                verify: bool = True, strict: bool = False, device=None):
        """Load a committed step (default: the latest) back into a state
        tree, tensors on ``device`` (with ``mesh``, each a ``DTensor`` of
        this rank's block); corrupt steps fall back as the module
        docstring says."""
        steps = self.all_steps()
        if step is not None:
            if step not in steps:
                raise FileNotFoundError(
                    f"step {step} has no committed checkpoint in "
                    f"{self.root!r} (committed: {steps})")
            candidates = [step]
        else:
            candidates = list(reversed(steps))
        if not candidates:
            raise FileNotFoundError(
                f"no committed checkpoint under {self.root!r}")
        last_err: Optional[CheckpointError] = None
        for s in candidates:
            try:
                state = read_state(self.step_dir(s), verify=verify,
                                   mesh=mesh, registry=self.registry,
                                   device=device)
                self.last_restored_step = s
                from paddle_tpu_torch.observability import flight_recorder
                now = time.perf_counter_ns()
                flight_recorder.record(
                    flight_recorder.KIND_CKPT, f"restore:step_{s}", now,
                    now, aux=int(s), args={"step": int(s)})
                return state
            except CheckpointIntegrityError as e:
                self._m["failures"].inc(kind="integrity")
                will_fall_back = not (strict or step is not None)
                warnings.warn(
                    f"checkpoint step {s} in {self.root!r} is CORRUPT "
                    f"({e}); " +
                    ("falling back to the previous committed step"
                     if will_fall_back else
                     "raising (explicitly requested step / strict mode)"),
                    RuntimeWarning, stacklevel=2)
                last_err = e
                if not will_fall_back:
                    raise
        raise CheckpointIntegrityError(
            f"every committed step under {self.root!r} failed integrity "
            f"verification") from last_err

    # -- retention -----------------------------------------------------------
    def _gc(self):
        """Keep the newest ``keep_last_k`` committed steps by commit time;
        remove ``.tmp`` dirs older than the newest commit (aborted saves
        of this process's serialized writer; in a single-process job
        only) and superseded ``.old`` swaps."""
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return
        committed = sorted(s for s in (parse_step_dir(n) for n in names)
                           if s is not None
                           if is_committed(os.path.join(
                               self.root, step_dir_name(s))))
        doomed = []
        if self.keep_last_k is not None and self.keep_last_k > 0:
            def commit_time(s):
                try:
                    return (os.path.getmtime(os.path.join(
                        self.root, step_dir_name(s), INDEX_FILE)), s)
                except OSError:
                    return (0.0, s)
            by_recency = sorted(committed, key=commit_time)
            doomed = [os.path.join(self.root, step_dir_name(s))
                      for s in by_recency[:-self.keep_last_k]]
        from .writer import _process_group
        single_process = _process_group()[1] == 1
        for name in names:
            if single_process and name.startswith(STEP_PREFIX) and \
                    name.endswith(TMP_SUFFIX):
                try:
                    s = int(name[len(STEP_PREFIX):-len(TMP_SUFFIX)])
                except ValueError:
                    continue
                if committed and s < committed[-1]:
                    doomed.append(os.path.join(self.root, name))
            elif name.startswith(STEP_PREFIX) and name.endswith(".old"):
                # superseded once the same id is committed again; else the
                # .old is the only copy of that step
                if is_committed(os.path.join(self.root, name[:-4])):
                    doomed.append(os.path.join(self.root, name))
        for path in doomed:
            shutil.rmtree(path, ignore_errors=True)
            if not path.endswith(TMP_SUFFIX):
                self._m["gc_removed"].inc()


def load_state_dir(path: str, step: Optional[int] = None, mesh=None,
                   verify: bool = True, device=None):
    """``paddle.load``'s directory target: ``path`` is a manager root
    (latest committed step, with the corruption fallback) or one
    ``step_N`` directory; tensors on ``device`` (``None``: the card)."""
    if os.path.isfile(os.path.join(path, INDEX_FILE)):
        return read_state(path, verify=verify, mesh=mesh, device=device)
    return CheckpointManager(path).restore(step=step, mesh=mesh,
                                           verify=verify, device=device)
