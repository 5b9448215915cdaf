"""The rest of ``paddle.distributed``'s surface — port of
``paddle_tpu/distributed/compat.py``: process-group queries, ``gather``,
asynchronous point-to-point, the object collectives, ``split`` and
``spawn``.

Where the reference's single controller makes these identities or
refusals (raw p2p has no XLA analog outside a region, :60-75), here they
act across processes: ``isend``/``irecv`` and ``batch_isend_irecv``
run over ``torch.distributed``'s point-to-point and return its work
handles, and the object collectives go through the job's TCPStore.
"""
from __future__ import annotations

import pickle
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from paddle_tpu_torch.core.tensor import unwrap

from . import collective as C
from .env import get_rank

__all__ = ["is_initialized", "destroy_process_group", "get_backend",
           "wait", "gather", "isend", "irecv", "P2POp",
           "batch_isend_irecv", "broadcast_object_list",
           "scatter_object_list", "split", "spawn"]


def is_initialized() -> bool:
    """True once ``init_parallel_env`` joined the process group."""
    return dist.is_initialized()


def destroy_process_group(group=None):
    """Tear down the job's store, the default mesh and the process group
    (every rank calls it); a later ``init_parallel_env`` starts anew.
    Per-group destruction is refused, as in the reference."""
    if group is not None:
        raise NotImplementedError(
            "per-group destruction is not supported; groups are mesh-axis "
            "views — destroy the whole process group (group=None)")
    if dist.is_initialized():
        from .env import _shutdown
        _shutdown()


def get_backend(group=None) -> str:
    """The communication backend: ``NCCL`` or ``GLOO``."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_parallel_env()")
    pg = C._resolve(group)[0] if group is not None else None
    return str(dist.get_backend(pg)).upper()


def wait(tensor, group=None, use_calc_stream: bool = True):
    """Block until the work queued on ``tensor``'s card is done (a task
    from an asynchronous collective is waited on)."""
    if isinstance(tensor, C._Task):
        return tensor.wait()
    t = unwrap(tensor)
    if isinstance(t, torch.Tensor) and t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()
    return tensor


def gather(tensor, gather_list: Optional[list] = None, dst: int = 0,
           group=None, sync_op: bool = True):
    """Every rank's tensor, in group order. Every rank receives them (an
    all-gather), as in the reference (:60-71)."""
    parts: list = []
    C.all_gather(parts, tensor, group=group)
    if gather_list is not None:
        gather_list.clear()
        gather_list.extend(parts)
    return parts


def isend(tensor, dst: int = 0, group=None):
    """Send to group rank ``dst`` asynchronously; returns the task."""
    return C.send(tensor, dst=dst, group=group, sync_op=False)


def irecv(tensor, src: int = 0, group=None):
    """Receive from group rank ``src`` into ``tensor`` asynchronously;
    returns the task."""
    return C.recv(tensor, src=src, group=group, sync_op=False)


@dataclass
class P2POp:
    """One operation of :func:`batch_isend_irecv`."""
    op: Callable
    tensor: object
    peer: int
    group: object = None


def batch_isend_irecv(p2p_op_list: List[P2POp]) -> list:
    """Issue every send and receive of the list; returns their tasks."""
    tasks = []
    for p in p2p_op_list:
        if p.op in (isend, C.send):
            tasks.append(isend(p.tensor, dst=p.peer, group=p.group))
        elif p.op in (irecv, C.recv):
            tasks.append(irecv(p.tensor, src=p.peer, group=p.group))
        else:
            raise ValueError(f"P2POp.op must be isend/irecv, got {p.op}")
    return tasks


def _single_process() -> bool:
    return C._world()[1] <= 1


def broadcast_object_list(object_list: list, src: int = 0, group=None):
    """Replace ``object_list``'s contents by ``src``'s on every member,
    through the job's TCPStore (reference :118-146). Ranks outside a host
    group return with their list untouched."""
    if _single_process():
        return None
    from .tcp_store import job_store
    members, rank, tag = C._group_members(group, "broadcast_object_list")
    if src not in members:
        raise ValueError(
            f"broadcast_object_list src {src} not in group {members}")
    if rank not in members or len(members) <= 1:
        return None
    store = job_store()
    key = C._obj_key("bc", tag)
    if rank == src:
        store.set(key, pickle.dumps(list(object_list)))
    object_list[:] = pickle.loads(store.wait(key))
    C._reaped_barrier(store, key + "/done", len(members))
    if rank == src:
        store.delete_key(key)
    return None


def scatter_object_list(out_object_list: list, in_object_list=None,
                        src: int = 0, group=None):
    """Member i gets ``src``'s ``in_object_list[i]`` (reference
    :149-186)."""
    if _single_process():
        rank = get_rank()
        out_object_list.clear()
        if in_object_list:
            out_object_list.append(in_object_list[rank
                                                  % len(in_object_list)])
        return None
    from .tcp_store import job_store
    members, rank, tag = C._group_members(group, "scatter_object_list")
    if src not in members:
        raise ValueError(
            f"scatter_object_list src {src} not in group {members}")
    if rank not in members:
        return None
    store = job_store()
    key = C._obj_key("sc", tag)
    if rank == src:
        if not in_object_list or len(in_object_list) != len(members):
            raise ValueError(
                f"scatter_object_list needs one object per group rank "
                f"({len(members)}), got "
                f"{0 if not in_object_list else len(in_object_list)}")
        for gi, r in enumerate(members):
            store.set(f"{key}/{r}", pickle.dumps(in_object_list[gi]))
    out_object_list.clear()
    out_object_list.append(pickle.loads(store.wait(f"{key}/{rank}")))
    C._reaped_barrier(store, key + "/done", len(members))
    store.delete_key(f"{key}/{rank}")
    return None


def split(x, size, operation: str = "linear", axis: int = 0,
          num_partitions=1, gather_out: bool = True, weight_attr=None,
          bias_attr=None, name=None):
    """``paddle.distributed.split`` (reference :189-228): build a
    row/column-parallel linear or a vocab-parallel embedding on ``x``'s
    device and apply it. Each call creates the layer (fresh parameters):
    keep ``out._split_layer``."""
    from .fleet import (ColumnParallelLinear, RowParallelLinear,
                        VocabParallelEmbedding)
    device = unwrap(x).device
    if operation == "linear":
        in_f, out_f = size
        if axis == 0:
            layer = RowParallelLinear(in_f, out_f, weight_attr=weight_attr,
                                      has_bias=bias_attr is not False,
                                      device=device)
        else:
            layer = ColumnParallelLinear(in_f, out_f,
                                         weight_attr=weight_attr,
                                         has_bias=bias_attr is not False,
                                         gather_output=gather_out,
                                         device=device)
    elif operation == "embedding":
        vocab, hidden = size
        layer = VocabParallelEmbedding(vocab, hidden,
                                       weight_attr=weight_attr,
                                       device=device)
    else:
        raise ValueError(f"unknown operation '{operation}'")
    out = layer(x)
    out._split_layer = layer  # keep the parameters with the output
    return out


def _spawn_entry(func, rank, nprocs, args):
    # the rank and world size reach the worker as PyTorch's own env://
    # variables, which init_parallel_env() reads
    import os
    os.environ["RANK"] = os.environ["LOCAL_RANK"] = str(rank)
    os.environ["WORLD_SIZE"] = str(nprocs)
    func(*args)


def spawn(func: Callable, args=(), nprocs: int = -1, join: bool = True,
          **options):
    """Start ``nprocs`` processes (``spawn`` start method) running
    ``func(*args)`` (reference :231-253). Each gets its rank and the
    world size as ``RANK``/``LOCAL_RANK``/``WORLD_SIZE`` and a free
    local ``MASTER_ADDR``/``MASTER_PORT``, so ``init_parallel_env()``
    in ``func`` joins them; ``nprocs <= 0`` is one per visible card."""
    import multiprocessing as mp
    import os
    from .tcp_store import free_port
    if nprocs <= 0:
        nprocs = max(torch.cuda.device_count(), 1)
    ctx = mp.get_context("spawn")
    saved = {k: os.environ.get(k) for k in ("MASTER_ADDR", "MASTER_PORT")}
    os.environ["MASTER_ADDR"] = "127.0.0.1"
    os.environ["MASTER_PORT"] = str(free_port())
    procs = []
    try:
        for rank in range(nprocs):
            p = ctx.Process(target=_spawn_entry,
                            args=(func, rank, nprocs, tuple(args)))
            p.start()
            procs.append(p)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if join:
        for p in procs:
            p.join()
        bad = [p.exitcode for p in procs if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"spawned workers failed: exit {bad}")
    return procs
