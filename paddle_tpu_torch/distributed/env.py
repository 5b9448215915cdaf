"""Process bootstrap — port of ``paddle_tpu/distributed/env.py``.

``init_parallel_env`` makes this process one rank of a
``torch.distributed`` process group (the reference's
``jax.distributed.initialize``, :36-111), connects to or starts the
job's TCPStore (``tcp_store.job_store``) and builds the default mesh.
Here each process is one rank on one device, as in Paddle and PyTorch:
:func:`get_rank` and :func:`get_world_size` count processes (the
reference's count devices under one process).

The rendezvous, in order of precedence:

* the arguments (``master="host:port"``, ``rank``, ``world_size``);
* the launcher's protocol (reference :47-89), when
  ``python -m paddle_tpu_torch.distributed.launch`` started this
  process: ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
  ``PADDLE_LOCAL_RANK``, ``PADDLE_MASTER`` and ``PADDLE_STORE_PORT``
  (the launcher's TCPStore, which every rank joins as a client) and
  ``PADDLE_RESTART_EPOCH``. ``torch.distributed``'s own address is
  negotiated through that store under ``__torch_rendezvous/{epoch}``
  (the reference's ``__jax_coordinator/{epoch}``): rank 0 picks a free
  port and publishes it, so a relaunched attempt never reads a dead
  attempt's address. The launcher's goodput stamps
  (``PADDLE_TPU_GOODPUT_DOWN_AT`` / ``_RESIZE_AT``) are read here too;
* PyTorch's ``env://`` variables as ``torchrun`` sets them (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``);
* with none of these, a world of one on a free local port.

This module is the one place that reads the job's environment:
:func:`launched_job` hands what it found to the preemption consensus,
the elastic listener, the goodput ledger and the fleet heartbeat bus.
:func:`job_namespace` is the prefix that keeps one attempt's (and one
in-place resize generation's) store keys apart from another's.

The backend defaults to ``nccl``, on the card; without one, asking for
``nccl`` (or for the default) raises, so a CPU job passes
``backend="gloo"``. Under ``nccl`` the process takes the card
``PADDLE_LOCAL_RANK`` (or ``LOCAL_RANK``, else its rank) modulo the
cards it sees.
"""
from __future__ import annotations

import dataclasses
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import get_mesh, init_mesh, set_mesh

__all__ = ["init_parallel_env", "get_rank", "get_world_size", "ParallelEnv",
           "LaunchedJob", "launched_job", "job_namespace"]

#: store key prefix of ``torch.distributed``'s address, per epoch
RENDEZVOUS_KEY = "__torch_rendezvous"


@dataclasses.dataclass
class LaunchedJob:
    """What the launcher told this process (its environment, read once).
    ``generation`` counts in-place elastic resizes within the attempt;
    ``backend`` is the process group's."""
    rank: int
    world_size: int
    local_rank: int
    node_rank: int
    master: str
    store_port: int
    epoch: str
    down_at: Optional[float] = None
    resize_at: Optional[float] = None
    generation: int = 0
    backend: str = ""


_state = {"job": None}


def _float_or_none(raw: Optional[str]) -> Optional[float]:
    try:
        return float(raw) if raw else None
    except ValueError:
        return None


def _read_launch_env() -> Optional[LaunchedJob]:
    env = os.environ
    if "PADDLE_TRAINER_ID" not in env or "PADDLE_STORE_PORT" not in env \
            or "PADDLE_MASTER" not in env:
        return None
    return LaunchedJob(
        rank=int(env["PADDLE_TRAINER_ID"]),
        world_size=int(env.get("PADDLE_TRAINERS_NUM", "1")),
        local_rank=int(env.get("PADDLE_LOCAL_RANK", "0")),
        node_rank=int(env.get("PADDLE_NODE_RANK", "0")),
        master=env["PADDLE_MASTER"],
        store_port=int(env["PADDLE_STORE_PORT"]),
        epoch=env.get("PADDLE_RESTART_EPOCH", "0"),
        down_at=_float_or_none(env.get("PADDLE_TPU_GOODPUT_DOWN_AT")),
        resize_at=_float_or_none(env.get("PADDLE_TPU_GOODPUT_RESIZE_AT")))


def launched_job() -> Optional[LaunchedJob]:
    """The launcher's job that :func:`init_parallel_env` joined, or None
    (not launched, or before ``init_parallel_env``)."""
    return _state["job"]


def job_namespace() -> str:
    """The key namespace of this attempt of the job: the restart epoch,
    and the resize generation after an in-place resize ("0" outside a
    launched job)."""
    job = _state["job"]
    if job is None:
        return "0"
    return job.epoch if not job.generation else \
        f"{job.epoch}.g{job.generation}"


def _advertised_address(host: str) -> str:
    """``host:port`` for rank 0's rendezvous server: the master's host when
    this machine owns that address, else the address of the interface
    that reaches it (reference :63-84)."""
    from .tcp_store import free_port
    try:
        return f"{host}:{free_port(host)}"
    except OSError:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect((host, 1))  # sends nothing: resolves the route
            adv = s.getsockname()[0]
        except OSError:
            adv = socket.gethostname()
        finally:
            s.close()
        return f"{adv}:{free_port('')}"


def rendezvous(backend: str, rank: int, world_size: int, key: str):
    """Join ``torch.distributed`` at the address rank 0 publishes under
    ``key`` in the launcher's store."""
    from .tcp_store import job_store
    store = job_store()
    if rank == 0:
        host = _state["job"].master.rsplit(":", 1)[0]
        store.set(key, _advertised_address(host).encode())
    addr = store.wait(key).decode()
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            rank=rank, world_size=world_size)


def _join_launched(backend: str, job: LaunchedJob):
    from . import tcp_store
    host = job.master.rsplit(":", 1)[0]
    tcp_store._job["store"] = tcp_store.TCPStore(
        host, job.store_port, world_size=job.world_size)
    job.backend = backend
    _state["job"] = job
    if backend == "nccl":
        torch.cuda.set_device(job.local_rank % torch.cuda.device_count())
    rendezvous(backend, job.rank, job.world_size,
               f"{RENDEZVOUS_KEY}/{job.epoch}")
    from paddle_tpu_torch.observability import fleet
    fleet.configure(rank=job.rank, world_size=job.world_size,
                    job_id=job.master)
    fleet.maybe_enable()  # the heartbeat bus, on by default in a job


def init_parallel_env(mesh_shape: Optional[dict] = None, *, backend=None,
                      rank: Optional[int] = None,
                      world_size: Optional[int] = None,
                      master: Optional[str] = None):
    """Join (or start) the process group and build the default mesh
    (``mesh_shape`` as in ``init_mesh``; every rank on ``dp`` by
    default). A second call only builds the mesh if there is none."""
    if not dist.is_initialized():
        backend = "nccl" if backend is None else backend
        if backend == "nccl" and not torch.cuda.is_available():
            raise RuntimeError(
                "init_parallel_env: the nccl backend needs a CUDA device "
                "and PyTorch sees none; pass backend='gloo' to run the "
                "ranks on the CPU")
        explicit = master is not None or rank is not None or \
            world_size is not None
        job = None if explicit else _read_launch_env()
        if job is not None:
            _join_launched(backend, job)
        else:
            if not explicit and "WORLD_SIZE" in os.environ:
                init = dict(init_method="env://")
                local = int(os.environ.get("LOCAL_RANK",
                                           os.environ.get("RANK", "0")))
            else:
                rank = int(rank or 0)
                world_size = int(world_size or 1)
                if master is None:
                    if world_size > 1:
                        raise ValueError(
                            "init_parallel_env: a world of more than one "
                            "process needs master='host:port' (or the "
                            "launcher's or torchrun's environment)")
                    from .tcp_store import free_port
                    master = f"127.0.0.1:{free_port()}"
                init = dict(init_method=f"tcp://{master}", rank=rank,
                            world_size=world_size)
                local = rank
            if backend == "nccl":
                torch.cuda.set_device(local % torch.cuda.device_count())
            dist.init_process_group(backend, **init)
            if dist.get_world_size() > 1:
                _start_job_store()
    if get_mesh() is None:
        init_mesh(mesh_shape)
    return ParallelEnv()


def _start_job_store():
    """Rank 0 binds the job's TCPStore; its address reaches the others
    through the process group."""
    from . import tcp_store
    addr = [None]
    if dist.get_rank() == 0:
        store = tcp_store.TCPStore("127.0.0.1", 0, is_master=True,
                                   world_size=dist.get_world_size())
        addr = [("127.0.0.1", store.port)]
    dist.broadcast_object_list(addr, src=0)
    if dist.get_rank() != 0:
        store = tcp_store.TCPStore(addr[0][0], addr[0][1],
                                   world_size=dist.get_world_size())
    tcp_store._job["store"] = store


def _leave_group():
    """Forget the mesh and the groups and destroy the process group."""
    from . import collective
    set_mesh(None)
    collective._reset()
    dist.destroy_process_group()


def _shutdown():
    """Tear down what :func:`init_parallel_env` made (the store, the
    mesh, the process group). A launched job's store is the launcher's:
    this rank only closes its client, once every rank has destroyed its
    process group (rank 0 hosts ``torch.distributed``'s own store, which
    a peer still tearing down its group may need)."""
    from . import tcp_store
    store, job = tcp_store._job["store"], _state["job"]
    world = dist.get_world_size()
    if store is not None:
        # every rank is done with the group before any tears it down
        dist.barrier()
    if job is not None:
        from paddle_tpu_torch.observability import fleet
        fleet.disable()  # its aggregator polls the store
    _leave_group()
    if store is not None:
        if job is not None:
            tcp_store.barrier_via_store(store, "destroyed", world)
        store.close()
        tcp_store._job["store"] = None
    _state["job"] = None


def get_rank(group=None) -> int:
    """This process's rank in the world (in ``group``'s ranks with a
    group); 0 before the process group exists."""
    if not dist.is_initialized():
        return 0
    if group is not None:
        from .collective import group_rank
        return group_rank(group)
    return dist.get_rank()


def get_world_size(group=None) -> int:
    """The number of processes in the world (in ``group``); 1 before the
    process group exists."""
    if group is not None and hasattr(group, "nranks"):
        return group.nranks
    return dist.get_world_size() if dist.is_initialized() else 1


class ParallelEnv:
    """Reference: ``python/paddle/fluid/dygraph/parallel.py``
    ``ParallelEnv``."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def device_id(self):
        return torch.cuda.current_device() if dist.is_initialized() and \
            dist.get_backend() == "nccl" else 0

    @property
    def nranks(self):
        return get_world_size()

    @property
    def local_rank(self):
        job = _state["job"]
        if job is not None:
            return job.local_rank
        return int(os.environ.get("LOCAL_RANK", get_rank()))
