"""Process bootstrap — port of ``paddle_tpu/distributed/env.py``.

``init_parallel_env`` makes this process one rank of a
``torch.distributed`` process group (the reference's
``jax.distributed.initialize``, :36-111), starts the job's TCPStore
(``tcp_store.job_store``) when the world holds more than one process, and
builds the default mesh. Here each process is one rank on one device, as
in Paddle and PyTorch: :func:`get_rank` and :func:`get_world_size` count
processes (the reference's count devices under one process).

The rendezvous comes from the arguments (``master="host:port"``,
``rank``, ``world_size``) or else from PyTorch's own ``env://``
variables as ``torchrun`` sets them (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``); with neither, the process is a world
of one on a free local port. The reference's ``PADDLE_TRAINER_ID`` /
``PADDLE_MASTER`` launcher protocol (:47-101) comes with the launcher's
slice and is not read.

The backend defaults to ``nccl``, on the card; without one, asking for
``nccl`` (or for the default) raises, so a CPU job passes
``backend="gloo"``. Under ``nccl`` the process takes the card
``LOCAL_RANK`` (else its rank) modulo the cards it sees.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import get_mesh, init_mesh, set_mesh

__all__ = ["init_parallel_env", "get_rank", "get_world_size", "ParallelEnv"]


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
        if master is None and rank is None and world_size is None and \
                "WORLD_SIZE" in os.environ:
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
                        "process needs master='host:port' (or torchrun's "
                        "environment)")
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


def _shutdown():
    """Tear down what :func:`init_parallel_env` made (the store, the
    mesh, the process group)."""
    from . import collective, tcp_store
    store = tcp_store._job["store"]
    if store is not None:
        # the master's server must outlive every client's last request
        dist.barrier()
        store.close()
        tcp_store._job["store"] = None
    set_mesh(None)
    collective._reset()
    dist.destroy_process_group()


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
        return int(os.environ.get("LOCAL_RANK", get_rank()))
