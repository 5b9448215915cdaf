"""Live elastic resharding — port of ``paddle_tpu/resilience/elastic.py``:
a membership change is a resize, not a restart.

1. **Notice** — a resize arrives through :meth:`ElasticResizeListener.
   request`, a notice file whose content is the target world
   (``notice_file=``), or the job-store key ``{prefix}/target``. The
   reference also reads ``PADDLE_TPU_ELASTIC_RESIZE`` and
   ``PADDLE_TPU_ELASTIC_RESIZE_FILE``; the port reads no environment
   variable, so those are the listener's arguments.
2. **Consensus boundary** — the preemption listener's claim under
   ``__elastic`` keys: the first rank to see the notice wins
   ``store.add`` on ``{prefix}/armed`` and publishes
   ``stop_at:new_world:reason`` at ``{prefix}/stop``, ``stop_at`` one
   past its step; every rank stops at exactly that step.
3. **In-memory exchange** — no filesystem: each old rank snapshots the
   state to the host (``checkpoint.writer.snapshot``) and publishes the
   shards it owns (the writer's ``plan_grid`` and ``owner = flat_pos %
   world``, raw bytes and crc32) on the job's TCPStore; every rank of the
   new world assembles the full tensors through
   ``checkpoint.reshard.assemble_from``, the loop the checkpoint files
   go through, so the result is bit-equal to a checkpoint reshard. The
   store is the reference's transport too (its CPU/test path): it moves
   every byte of the state through one TCP server.
4. **Data remap** — old ranks publish their ``DataPipeline`` states;
   each new rank folds them through ``DataPipeline.reshard_state``.
5. **Continue / depart** — departing ranks (old ranks ``>= new_world``)
   retire their heartbeat lane (``fleet.depart``: ``departed``, never
   ``missing``) and exit :data:`RESIZE_EXIT_CODE` (83), which the
   launcher reads as a planned resize. Survivors keep their rank. A
   process group cannot shrink, so when one exists every old rank
   leaves it together (a barrier, the destroy, a store barrier), and the
   survivors join a new one at the new world, under the rendezvous key
   of the next generation (:func:`rejoin`), and build the default mesh
   again; the caller rebuilds its model wrapper and ``TrainStep``
   on it, as the reference's caller rebuilds its mesh and TrainStep.

Keys are namespaced by the launcher's restart epoch
(``distributed.env.launched_job``, "0" outside one) and by the resize
generation, so neither a relaunch nor a second resize reads a stale
verdict.
"""
from __future__ import annotations

import os
import pickle
import sys
import time
from typing import Dict, List, Optional

from paddle_tpu_torch.checkpoint.layout import (CheckpointIntegrityError,
                                                crc32_of, iter_shards,
                                                loads_skeleton, plan_grid,
                                                unflatten_state)

__all__ = ["RESIZE_EXIT_CODE", "ElasticResizeListener",
           "publish_state", "collect_state", "exchange_reshard",
           "publish_data_state", "collect_data_states", "perform_resize",
           "elastic_prefix", "rejoin"]

#: Exit status meaning "left the job at a consensus resize boundary; the
#: surviving ranks carry the full state": the launcher does not relaunch
#: this rank, it shrinks the world and keeps the survivors running.
RESIZE_EXIT_CODE = 83

STORE_KEY = "__elastic"


def _launched_job():
    env = sys.modules.get("paddle_tpu_torch.distributed.env")
    return env.launched_job() if env is not None else None


def _epoch() -> str:
    job = _launched_job()
    return job.epoch if job is not None else "0"


def elastic_prefix(gen: int, epoch: Optional[str] = None) -> str:
    """Store-key prefix of resize generation ``gen`` in restart epoch
    ``epoch`` (default: this job's)."""
    return f"{STORE_KEY}/{epoch if epoch is not None else _epoch()}/g{gen}"


class ElasticResizeListener:
    """Consensus resize observer: poll :meth:`should_resize` at step
    boundaries; it is True on every rank at the SAME step, and then
    :attr:`target_world` holds the agreed world size.

    ``store``: the job's TCPStore (default: the launched job's, when
    ``init_parallel_env`` joined one; without a store a notice seen here
    resizes at the next boundary). ``notice_file``: a file whose content
    is the target world. ``check_interval``: least seconds between
    notice-file polls (the store is read every call).
    """

    def __init__(self, store=None, notice_file: Optional[str] = None,
                 check_interval: float = 0.0):
        self._store = store
        self._store_failed = False
        self._notice_file = notice_file
        self._check_interval = float(check_interval)
        self._last_poll = 0.0
        self._flagged = False
        self._broadcast_done = False
        self._decided = False
        self.target_world: Optional[int] = None
        self.reason: Optional[str] = None
        self.boundary_step: Optional[int] = None
        self.generation = 0

    # -- channels ----------------------------------------------------------
    def request(self, new_world: int, reason: str = "request"):
        """Programmatic resize notice (drills, operator tooling)."""
        if not self._flagged:
            self._flagged = True
            self.target_world = int(new_world)
            self.reason = reason

    def _poll_notice(self):
        path = self._notice_file
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    self.request(int(f.read().strip()), "notice_file")
            except (OSError, ValueError):
                pass  # a half-written notice: read it at the next poll

    def _job_store(self):
        if self._store is not None or self._store_failed:
            return self._store
        if _launched_job() is None:
            self._store_failed = True
            return None
        from paddle_tpu_torch.distributed.tcp_store import job_store
        self._store = job_store()
        return self._store

    def _gen_key(self) -> str:
        return f"{STORE_KEY}/{_epoch()}/gen"

    def _refresh_generation(self, store) -> str:
        raw = store.get(self._gen_key())
        self.generation = int(raw) if raw else 0
        return elastic_prefix(self.generation)

    # -- the step-boundary query ------------------------------------------
    def should_resize(self, step: Optional[int] = None) -> bool:
        """True once the cluster's resize boundary is reached, at the same
        step on every rank."""
        if self._decided:
            return True
        now = time.monotonic()
        if now - self._last_poll >= self._check_interval:
            self._last_poll = now
            self._poll_notice()
        store = self._job_store()
        if store is None:
            if self._flagged:
                self._decided = True
                self.boundary_step = step
            return self._decided
        try:
            prefix = self._refresh_generation(store)
            if not self._flagged:
                raw = store.get(f"{prefix}/target")
                if raw:
                    t, _, r = raw.decode(errors="replace").partition(":")
                    try:
                        self.request(int(t), f"store:{r or 'target'}")
                    except ValueError:
                        pass  # a malformed target: no notice
            if self._flagged and not self._broadcast_done:
                if int(store.add(f"{prefix}/armed", 1)) == 1:
                    stop_at = 0 if step is None else int(step) + 1
                    store.set(f"{prefix}/stop",
                              f"{stop_at}:{self.target_world}:"
                              f"{self.reason or '?'}".encode())
                self._broadcast_done = True
            v = store.get(f"{prefix}/stop")
        except (OSError, RuntimeError):
            # a dead control plane must not kill the step
            self._store_failed = True
            if self._flagged:
                self._decided = True
                self.boundary_step = step
            return self._decided
        if v is None:
            return False
        stop_s, _, rest = v.decode(errors="replace").partition(":")
        world_s, _, reason = rest.partition(":")
        if not self._flagged:
            self._flagged = True
            self.reason = f"store:{reason}"
        self.target_world = int(world_s)
        stop_at = int(stop_s)
        if step is None or stop_at == 0 or int(step) >= stop_at:
            self._decided = True
            self.boundary_step = stop_at if stop_at else step
        return self._decided

    @property
    def resize_pending(self) -> bool:
        return self._flagged

    def reset(self):
        """Re-arm for the next resize (survivors, after an in-place
        resize; the store generation moved, so the old verdict is never
        read again)."""
        self._flagged = False
        self._broadcast_done = False
        self._decided = False
        self.target_world = None
        self.reason = None
        self.boundary_step = None


# ---------------------------------------------------------------------------
# The in-memory state exchange over the job store.
# ---------------------------------------------------------------------------

def _shard_key(prefix: str, key: str, flat_pos: int) -> str:
    return f"{prefix}/t/{key}/{flat_pos:03d}"


def publish_state(store, prefix: str, state, world: int, rank: int,
                  nshards: Optional[int] = None) -> dict:
    """Snapshot ``state`` to the host and publish the shards this rank
    owns, as ``checkpoint.writer.write_step`` writes them (same grid,
    owners, raw C-order bytes and crc32), onto the store; rank 0 also
    publishes the pickled manifest and the state's skeleton. Returns the
    manifest (every rank computes the same)."""
    from paddle_tpu_torch.checkpoint.writer import _dtype_of, _raw, snapshot

    nshards = max(int(nshards if nshards is not None else world), 1)
    snap = snapshot(state)
    snap.wait()
    tensors: Dict[str, dict] = {}
    for key in sorted(snap.tensors):
        arr, ref = snap.tensors[key]
        shape = list(arr.shape)
        grid = plan_grid(shape, nshards)
        entry = {"shape": shape, "dtype": _dtype_of(arr), "grid": grid,
                 "kind": ref.kind, "shards": []}
        for flat_pos, offset, shard_shape, slices in iter_shards(shape,
                                                                 grid):
            owner = flat_pos % world
            rec = {"offset": offset, "shape": shard_shape, "owner": owner,
                   "store_key": _shard_key(prefix, key, flat_pos)}
            if owner == rank:
                data = _raw(arr[slices])[1].tobytes()
                rec["crc32"] = crc32_of(data)
                rec["nbytes"] = len(data)
                store.set(rec["store_key"], data)
            entry["shards"].append(rec)
        tensors[key] = entry
    manifest = {"tensors": tensors, "world": int(world), "aux_crc": None}
    if rank == 0:
        manifest["aux_crc"] = crc32_of(snap.skeleton_bytes)
        store.set(f"{prefix}/aux", snap.skeleton_bytes)
        store.set(f"{prefix}/manifest", pickle.dumps(manifest, protocol=4))
    store.set(f"{prefix}/published/{rank}", b"1")
    return manifest


def collect_state(store, prefix: str, verify: bool = True, mesh=None,
                  timeout: Optional[float] = None, device=None):
    """Assemble the full state from a :func:`publish_state` round: each
    shard's bytes through ``store.wait``, pasted and crc-checked by
    ``checkpoint.reshard.assemble_from``. Tensors land on ``device``
    (``None``: the CUDA card) or, with ``mesh``, on the mesh
    (``place_on_mesh``: this rank's block)."""
    import torch

    from paddle_tpu_torch.checkpoint.reshard import (assemble_from,
                                                     place_on_mesh)
    from paddle_tpu_torch.device import resolve_device

    device = resolve_device(device)
    # the manifest is this job's own pickle (rank 0 wrote it above)
    manifest = pickle.loads(store.wait(f"{prefix}/manifest", timeout))
    skel_bytes = store.wait(f"{prefix}/aux", timeout)
    if verify and manifest.get("aux_crc") is not None and \
            crc32_of(skel_bytes) != manifest["aux_crc"]:
        raise CheckpointIntegrityError(
            "checksum mismatch on exchanged state skeleton")
    skeleton = loads_skeleton(skel_bytes)

    def fetch(rec):
        return store.wait(rec["store_key"], timeout)

    arrays: Dict[str, object] = {}
    for key, entry in manifest["tensors"].items():
        full = assemble_from(entry, fetch, verify=verify)
        if isinstance(full, torch.Tensor):
            full = full.to(device) if mesh is None else \
                place_on_mesh(full, mesh, device)
        arrays[key] = full
    return unflatten_state(skeleton, arrays)


def exchange_reshard(store, prefix: str, state, world: int, rank: int,
                     new_world: int, verify: bool = True, mesh=None,
                     timeout: Optional[float] = None, device=None):
    """One rank's whole exchange: publish its shards, then (a rank that
    survives into the new world) assemble the full state. A departing
    rank (``rank >= new_world``) returns None once its shards are up."""
    publish_state(store, prefix, state, world, rank)
    if rank >= int(new_world):
        return None
    return collect_state(store, prefix, verify=verify, mesh=mesh,
                         timeout=timeout, device=device)


# ---------------------------------------------------------------------------
# The data-state exchange and remap.
# ---------------------------------------------------------------------------

def publish_data_state(store, prefix: str, data_state: dict, rank: int):
    """Publish one rank's ``DataPipeline.state_dict()`` (pickled: it
    carries numpy pending batches)."""
    store.set(f"{prefix}/data/{rank}", pickle.dumps(data_state, protocol=4))


def collect_data_states(store, prefix: str, world: int,
                        timeout: Optional[float] = None) -> List[dict]:
    """Every old rank's published pipeline state (this job's pickles)."""
    return [pickle.loads(store.wait(f"{prefix}/data/{r}", timeout))
            for r in range(int(world))]


# ---------------------------------------------------------------------------
# Orchestration.
# ---------------------------------------------------------------------------

def _leave_world(store, world: int, generation: int):
    """Every rank of the old world, after the exchange: wait until all of
    them are done with its process group, destroy it, and wait until all
    of them have (rank 0 hosts ``torch.distributed``'s own store, which a
    peer still tearing down may need), so no rank leaves a peer with a
    half-torn group."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.distributed.tcp_store import barrier_via_store
    dist.barrier()
    env._leave_group()
    barrier_via_store(store, f"resize/g{generation}/destroyed", world)


def rejoin(new_world: int, generation: int):
    """A survivor whose old process group is gone joins one at
    ``new_world`` (its rank unchanged), rendezvousing under the
    generation's key, then builds the default mesh (every rank on
    ``dp``). Needs a launched job's store."""
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.distributed.mesh import init_mesh
    from paddle_tpu_torch.observability import fleet
    job = env.launched_job()
    if job is None:
        raise RuntimeError("rejoin needs a job started by "
                           "paddle_tpu_torch.distributed.launch")
    job.world_size, job.generation = int(new_world), int(generation)
    env.rendezvous(job.backend, job.rank, job.world_size,
                   f"{env.RENDEZVOUS_KEY}/{job.epoch}/g{job.generation}")
    fleet.configure(world_size=job.world_size)
    return init_mesh()


def perform_resize(store, *, state, data_state: Optional[dict],
                   world: int, rank: int, new_world: int,
                   generation: Optional[int] = None,
                   mesh=None, verify: bool = True,
                   pad_id: int = 0, ignore_label: int = -100,
                   boundary_step: Optional[int] = None,
                   timeout: Optional[float] = None, device=None):
    """One rank's side of a consensus resize, end to end: publish the
    state's shards and the data state and wait until every old rank has
    published; a survivor assembles the state, remaps the data order and
    opens the next generation (rank 0); when a process group exists and
    the world changes, every old rank leaves it together; a departing
    rank then retires its heartbeat lane and returns ``(None, None)``
    (the caller exits :data:`RESIZE_EXIT_CODE`), and a survivor joins the
    new world's group (:func:`rejoin`), records the wall into the goodput
    ``reshard`` bin and an ``elastic`` trace span, and returns
    ``(state, data_state)`` to continue with. No file is written."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    gen = generation if generation is not None else 0
    prefix = elastic_prefix(gen)
    world, new_world = int(world), int(new_world)

    publish_state(store, prefix, state, world, rank)
    if data_state is not None:
        publish_data_state(store, prefix, data_state, rank)
    # survivors assemble only after every old rank (the departing ones
    # own shards too) has published
    for r in range(world):
        store.wait(f"{prefix}/published/{r}", timeout)

    departing = rank >= new_world
    new_state = new_data = None
    if not departing:
        new_state = collect_state(store, prefix, verify=verify, mesh=mesh,
                                  timeout=timeout, device=device)
        if data_state is not None:
            from paddle_tpu_torch.data.pipeline import DataPipeline
            states = collect_data_states(store, prefix, world, timeout)
            new_data = DataPipeline.reshard_state(
                states, new_world, pad_id=pad_id,
                ignore_label=ignore_label)[rank]
        if rank == 0:
            # the next generation: a later resize never reads this
            # round's verdict or shards
            store.set(f"{STORE_KEY}/{_epoch()}/gen", str(gen + 1).encode())
    regroup = dist.is_initialized() and new_world != world
    if regroup:
        _leave_world(store, world, gen)
    if departing:
        from paddle_tpu_torch.observability import fleet
        fleet.depart(int(boundary_step or 0), reason="resize")
        return None, None
    if regroup:
        rejoin(new_world, gen + 1)

    dt = time.perf_counter() - t0
    from paddle_tpu_torch.observability import goodput, trace
    goodput.get_ledger().record("reshard", dt)
    now = time.perf_counter_ns()
    trace.span("elastic", f"elastic_resize_{world}to{new_world}",
               now - int(dt * 1e9), now,
               args={"world": world, "new_world": new_world,
                     "step": boundary_step, "reshard_s": round(dt, 6)})
    return new_state, new_data
