"""Collective communication — port of ``paddle_tpu/distributed/collective.py``.

Each collective runs over ``torch.distributed`` on the process group of
its :class:`Group`: NCCL on the card, gloo on the CPU. A device group
names mesh axes (``Group("dp")``, ``Group(("dp", "sharding"))``) and
acts across the processes that differ only along them; ``group=None`` is
every rank. A host group (``new_group(ranks=[...])`` with a subset)
serves the store-backed object collectives only, as in the reference.

**The one semantic shift.** In the reference one process drives a mesh
of devices, and per-rank code exists only inside :func:`spmd` /
:func:`shard_map` regions; a collective outside one raises
(reference :160-164). Here each process is one rank, so a collective
called from a rank's code acts across the group's processes wherever it
is called. :func:`spmd` stays the reference's entry point: it slices
this rank's shard of each (global, replicated) input by ``in_specs``,
runs the function, and assembles the outputs by ``out_specs`` (an
all-gather along each sharded dim), so a region returns the global
value on every rank, as the reference's does.

Tensor collectives work in place where the result has the input's shape
(``all_reduce``, ``broadcast``, ``recv``) and return the result; with
``sync_op=False`` they are issued asynchronously and return a task
whose ``wait()`` gives the result. ``reduce`` leaves the reduced value
on every rank, as the reference's does (:343-348). ``ReduceOp.AVG`` is
a sum divided by the group size. Each collective reports through
``observability.comm`` (``comm_scope``: bytes, calls, seconds, exposed
or overlapped).

**Gloo and CUDA tensors.** Gloo carries only ``broadcast`` and
``all_reduce`` for CUDA tensors; handed one, its point-to-point writes
from the device address and fails (``writev ... Bad address`` with an
H100's tensors). So on a gloo group :func:`send`, :func:`recv`,
:func:`p2p_shift`, :func:`all_gather` and :func:`all_to_all` *stage* a
CUDA tensor: it is copied into a pinned host buffer, the host buffer
travels, and what arrives is copied back onto the card. ``comm_scope``
records such a call with ``staged: True`` and its bytes as usual. An
NCCL group never stages. This is what lets two processes share one card
over gloo (``chip_smoke.py`` phases 21(b) and 22).

:func:`ring_hop` is :func:`p2p_shift` as an autograd function whose
backward is the reverse hop (the transpose of a permutation, as the
reference's ``ppermute`` under ``jax.grad``).
"""
from __future__ import annotations

import pickle
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from paddle_tpu_torch.core.tensor import Tensor, unwrap, wrap
from paddle_tpu_torch.observability.comm import comm_scope

from . import mesh as _mesh
from .mesh import get_mesh

__all__ = ["ReduceOp", "Group", "new_group", "get_group", "all_reduce",
           "all_gather", "all_gather_object", "reduce", "reduce_scatter",
           "broadcast", "all_to_all", "scatter", "send", "recv", "barrier",
           "p2p_shift", "spmd", "shard_map", "P"]


class P(tuple):
    """A partition spec (the reference's re-export of
    ``jax.sharding.PartitionSpec``): one entry per tensor dim, the mesh
    axis it is split over (a name or a tuple of names), or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        # pickle rebuilds a tuple subclass from __new__'s arguments
        return tuple(self)

    def __repr__(self):
        return "P(" + ", ".join(repr(e) for e in self) + ")"


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.PROD: dist.ReduceOp.PRODUCT,
             ReduceOp.AVG: dist.ReduceOp.SUM}


class Group:
    """A communicator: **device groups** name mesh axes (a tuple of axis
    names); **host groups** list global ``ranks`` explicitly and serve
    the store-backed object collectives (the reference's two planes,
    :49-96). A host group keeps the user's rank order."""

    _registry = {}
    _next_id = 0

    def __init__(self, axes: Union[str, Sequence[str]], mesh=None,
                 ranks: Optional[Sequence[int]] = None):
        self.axes: Tuple[str, ...] = (axes,) if isinstance(axes, str) \
            else tuple(axes)
        self._mesh = mesh
        if ranks is not None:
            ranks = tuple(int(r) for r in ranks)
            if len(set(ranks)) != len(ranks):
                raise ValueError(f"duplicate ranks in group: {ranks}")
        self.ranks: Optional[Tuple[int, ...]] = ranks

    @property
    def mesh(self):
        return self._mesh or get_mesh()

    @property
    def nranks(self) -> int:
        if self.ranks is not None:
            return len(self.ranks)
        m = self.mesh
        if m is None:
            return 1
        return _mesh.axis_size(m, self.axes)

    @property
    def axis_name(self):
        return self.axes if len(self.axes) > 1 else self.axes[0]

    @property
    def rank(self) -> int:
        """This process's index in the group."""
        return group_rank(self)

    def __repr__(self):
        return f"Group(axes={self.axes}, nranks={self.nranks})"


def new_group(ranks=None, axes=None, mesh=None) -> Group:
    """A communicator: ``axes`` names a device group; an explicit
    ``ranks`` list other than the whole mesh in order is a host group
    (reference :99-122)."""
    g = None
    if axes is None:
        m = mesh or get_mesh()
        full = int(np.prod(m.shape)) if m is not None else None
        if ranks is not None and (
                m is None or list(ranks) != list(range(full))):
            g = Group((), mesh, ranks=ranks)
        else:
            axes = tuple(m.mesh_dim_names) if m is not None else ("dp",)
    if g is None:
        g = Group(axes, mesh)
    gid = Group._next_id
    Group._next_id += 1
    Group._registry[gid] = g
    g.id = gid
    return g


def get_group(gid: int) -> Optional[Group]:
    return Group._registry.get(gid)


def _axes(group) -> Tuple[str, ...]:
    if isinstance(group, Group):
        if group.ranks is not None:
            raise RuntimeError(
                "host-rank groups (new_group(ranks=[...])) serve the "
                "store-backed OBJECT collectives; device collectives need "
                "an axis-aligned group (new_group(axes=('dp',)))")
        return group.axes
    if isinstance(group, str):
        return (group,)
    return tuple(group)


def _resolve(group):
    """``(process group or None, axes, size)`` of a collective's group:
    None (identity) before the process group exists, or for a group of
    one rank there."""
    axes = () if group is None else _axes(group)
    m = group.mesh if isinstance(group, Group) else get_mesh()
    if not dist.is_initialized():
        if group is not None and m is not None and \
                _mesh.axis_size(m, axes) > 1:
            raise RuntimeError("collective over a group of more than one "
                               "rank before init_parallel_env")
        return None, axes, 1
    if m is None:
        return dist.group.WORLD, axes, dist.get_world_size()
    if group is None:
        axes = tuple(m.mesh_dim_names)
    axes = tuple(a for a in m.mesh_dim_names if a in axes)
    if not axes:
        return None, axes, 1
    return _mesh.axes_group(m, axes), axes, _mesh.axis_size(m, axes)


def group_rank(group) -> int:
    """This process's index in ``group`` (its position in a host group's
    list, -1 outside it)."""
    if isinstance(group, Group) and group.ranks is not None:
        r = dist.get_rank() if dist.is_initialized() else 0
        return group.ranks.index(r) if r in group.ranks else -1
    pg, _, _ = _resolve(group)
    return 0 if pg is None else dist.get_rank(pg)


def _like(src, out):
    """``out`` as a Paddle ``Tensor`` when ``src`` was one."""
    return wrap(out) if type(src) is Tensor else out


def _global(pg, group_rank_: int, n: int, what: str) -> int:
    if not 0 <= group_rank_ < n:
        raise ValueError(f"{what} {group_rank_} out of range for group "
                         f"of {n}")
    return dist.get_global_rank(pg, group_rank_)


class _Task:
    """An issued collective: ``wait()`` blocks (on the card: orders the
    current stream after it), runs what completes the result, and
    returns it."""

    def __init__(self, work, result, after=None, keep=None):
        self._work = work
        self._result = result
        self._after = after
        self._keep = keep  # a staged buffer, alive until the wait
        self._pending = True

    def wait(self):
        if self._pending:
            if self._work is not None:
                self._work.wait()
            if self._after is not None:
                out = self._after()
                self._result = self._result if out is None else out
            self._pending = False
            self._work = None
            self._keep = None
        return self._result

    def is_completed(self) -> bool:
        return not self._pending or (self._work is not None and
                                     self._work.is_completed())


def _issue(work, result, sync_op, after=None, keep=None):
    task = _Task(work, result, after, keep)
    return task.wait() if sync_op else task


def staged(pg, x) -> bool:
    """Whether a call on process group ``pg`` stages ``x`` through the
    host: a CUDA tensor on a gloo group."""
    return x.is_cuda and dist.get_backend(pg) == "gloo"


def _to_host(x):
    """A pinned host copy of ``x``, as gloo moves it: 16-bit floats
    travel as their bytes (the staged calls move bytes and reduce
    nothing, and gloo's all-gather and all-to-all take no 16-bit
    integers)."""
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return _as_bytes(h)


def _host_like(x):
    return _as_bytes(torch.empty(x.shape, dtype=x.dtype, pin_memory=True))


def _as_bytes(h):
    if h.dtype in (torch.bfloat16, torch.float16):
        return h.reshape(h.shape or (1,)).view(torch.uint8)
    return h


def _from_bytes(b, like):
    """A staged buffer back in ``like``'s dtype and shape (on the host)."""
    return b.view(like.dtype).reshape(like.shape)


def _extra(pg, x, extra=None):
    out = dict(extra or {})
    if staged(pg, x):
        out["staged"] = True
    return out or None


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce across the group in place; every rank gets the result."""
    pg, axes, n = _resolve(group)
    if pg is None:
        return tensor
    x = unwrap(tensor)
    with comm_scope("all_reduce", axes, payload=x, extra={"reduce_op": op}):
        work = dist.all_reduce(x, _TORCH_OP[op], group=pg,
                               async_op=not sync_op)

    def avg():
        x.div_(n)
    return _issue(work, tensor, sync_op,
                  avg if op == ReduceOp.AVG else None)


def all_gather(tensor_or_list, tensor=None, group=None, sync_op=True,
               axis=0):
    """Every rank's tensor, concatenated along ``axis`` (functional form
    ``out = all_gather(t)``), or appended to a list (Paddle's
    ``all_gather(out_list, t)``)."""
    out_list = None
    if tensor is None:
        t = tensor_or_list
    else:
        out_list, t = tensor_or_list, tensor
    pg, axes, n = _resolve(group)
    x = unwrap(t)
    stage = False
    if pg is None:
        parts = [x]
        work = None
    else:
        stage = staged(pg, x)
        src = _to_host(x) if stage else x.contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        with comm_scope("all_gather", axes, payload=x,
                        extra=_extra(pg, x)):
            work = dist.all_gather(parts, src, group=pg,
                                   async_op=not sync_op)

    def done():
        if stage:
            parts[:] = [_from_bytes(p, x).to(x.device) for p in parts]
        if out_list is not None:
            out_list.extend(_like(t, p) for p in parts)
            return None
        return _like(t, torch.cat(parts, dim=axis) if len(parts) > 1
                     else parts[0])
    return _issue(work, None, sync_op, done)


_obj_seq: dict = {}  # (kind, group tag) -> per-call sequence number


def _world():
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _group_members(group, what: str):
    """(member ranks, my global rank, store tag) of an object
    collective: the world for ``None`` or a group of the world's size, a
    host group's ranks; other device groups raise (reference :228-250)."""
    rank, world = _world()
    if group is None:
        return tuple(range(world)), rank, "w"
    ranks = getattr(group, "ranks", None)
    if ranks is None:
        if getattr(group, "nranks", None) in (None, world):
            return tuple(range(world)), rank, "w"
        raise NotImplementedError(
            f"{what}: device (axis) groups do not scope host-object "
            "collectives; build a host group with new_group(ranks=[...])")
    bad = [r for r in ranks if not 0 <= r < world]
    if bad:
        raise ValueError(f"{what}: ranks {bad} outside world {world}")
    return ranks, rank, "-".join(map(str, ranks))


def _reaped_barrier(store, name: str, world: int):
    """A store barrier whose last leaver deletes its keys."""
    from .env import job_namespace
    from .tcp_store import barrier_via_store
    barrier_via_store(store, name, world)
    key = f"__barrier/{job_namespace()}/{name}"
    if store.add(f"{key}/left", 1) == world:
        store.delete_prefix(key)


def _obj_key(kind: str, tag: str = "w") -> str:
    """A per-call store namespace: members call a group's collectives in
    the same order, so a per-(kind, group) counter agrees across them;
    the attempt's namespace keeps a dead attempt's keys out."""
    from .env import job_namespace
    seq = _obj_seq.get((kind, tag), 0)
    _obj_seq[(kind, tag)] = seq + 1
    return f"__objcol/{job_namespace()}/{tag}/{kind}{seq}"


def all_gather_object(object_list, obj, group=None):
    """Every member's ``obj``, appended to ``object_list`` in rank order,
    through the job's TCPStore (reference :267-298). A rank outside a
    host group passes through with ``object_list`` untouched."""
    members, rank, tag = _group_members(group, "all_gather_object")
    if rank not in members:
        return None
    if len(members) <= 1:
        object_list.append(obj)
        return None
    from .tcp_store import job_store
    store = job_store()
    key = _obj_key("ag", tag)
    blob = pickle.dumps(obj)
    with comm_scope("all_gather_object", (), nbytes=len(blob),
                    extra={"members": len(members)}):
        store.set(f"{key}/{rank}", blob)
        for r in members:
            object_list.append(pickle.loads(store.wait(f"{key}/{r}")))
        _reaped_barrier(store, key, len(members))
        store.delete_key(f"{key}/{rank}")
    return None


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce to ``dst``; the reduced value is left on every rank, as the
    reference's (an all-reduce)."""
    return all_reduce(tensor, op, group, sync_op)


def reduce_scatter(tensor, op=ReduceOp.SUM, group=None, sync_op=True,
                   axis=0):
    """Reduce, then keep this rank's chunk along ``axis``: ``[N, ...]``
    in, ``[N / n, ...]`` out."""
    pg, axes, n = _resolve(group)
    if pg is None:
        return tensor
    x = unwrap(tensor)
    xt = x.movedim(axis, 0).contiguous()
    if xt.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {axis} of size "
                         f"{xt.shape[0]} does not divide by {n}")
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    with comm_scope("reduce_scatter", axes, payload=x,
                    extra={"reduce_op": op}):
        work = dist.reduce_scatter_tensor(out, xt, _TORCH_OP[op], group=pg,
                                          async_op=not sync_op)

    def done():
        if op == ReduceOp.AVG:
            out.div_(n)
        return _like(tensor, out.movedim(0, axis))
    return _issue(work, None, sync_op, done)


def broadcast(tensor, src=0, group=None, sync_op=True):
    """Group rank ``src``'s value on every rank, in place."""
    pg, axes, n = _resolve(group)
    if pg is None:
        if src != 0:
            raise ValueError(f"broadcast src {src} out of range for group "
                             f"of 1")
        return tensor
    x = unwrap(tensor)
    g = _global(pg, src, n, "broadcast src")
    with comm_scope("broadcast", axes, payload=x, extra={"src": src}):
        work = dist.broadcast(x, src=g, group=pg, async_op=not sync_op)
    return _issue(work, tensor, sync_op)


def all_to_all(in_tensor_list, out_tensor_list=None, group=None,
               sync_op=True, split_axis=0, concat_axis=0):
    """All-to-all: a single tensor is split in n chunks along
    ``split_axis``, chunk j goes to rank j, and the chunks received are
    concatenated along ``concat_axis``; a list of n tensors sends the
    j-th to rank j and gives the n received ones."""
    pg, axes, n = _resolve(group)
    single = not isinstance(in_tensor_list, (list, tuple))
    if pg is None:
        return in_tensor_list
    if single:
        x = unwrap(in_tensor_list)
        send = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    else:
        send = torch.stack([unwrap(t) for t in in_tensor_list]).contiguous()
    stage = staged(pg, send)
    src = _to_host(send) if stage else send
    recv_buf = torch.empty_like(src)
    with comm_scope("all_to_all", axes, payload=send,
                    extra=_extra(pg, send)):
        dist.all_to_all_single(recv_buf, src, group=pg)
    if stage:
        recv_buf = _from_bytes(recv_buf, send).to(send.device)
    if single:
        return _like(in_tensor_list,
                     torch.cat(list(recv_buf.unbind(0)), dim=concat_axis))
    outs = list(recv_buf.unbind(0))
    if out_tensor_list is not None:
        out_tensor_list.extend(outs)
        return None
    return outs


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank i gets chunk i (along dim 0) of group rank ``src``'s tensor
    (or the i-th of its ``tensor_list``)."""
    pg, axes, n = _resolve(group)
    if tensor_list is not None:
        tensor = torch.cat([unwrap(t) for t in tensor_list], dim=0)
    if pg is None:
        return tensor
    x = unwrap(tensor)
    g = _global(pg, src, n, "scatter src")
    chunks = [c.contiguous() for c in x.chunk(n, dim=0)]
    out = torch.empty_like(chunks[0])
    with comm_scope("scatter", axes, payload=x, extra={"src": src}):
        dist.scatter(out, chunks if dist.get_rank() == g else None, src=g,
                     group=pg)
    return _like(tensor, out)


def send(tensor, dst=0, group=None, sync_op=True):
    """Send to group rank ``dst`` (pair with :func:`recv` there)."""
    pg, axes, n = _resolve(group)
    x = unwrap(tensor).contiguous()
    g = _global(pg, dst, n, "send dst")
    src = _to_host(x) if staged(pg, x) else x
    with comm_scope("send", axes, payload=x,
                    extra=_extra(pg, x, {"dst": dst})):
        work = dist.isend(src, dst=g, group=pg)
    return _issue(work, None, sync_op, keep=src)


def recv(tensor, src=0, group=None, sync_op=True):
    """Receive from group rank ``src`` into ``tensor``, in place."""
    pg, axes, n = _resolve(group)
    x = unwrap(tensor)
    g = _global(pg, src, n, "recv src")
    buf = _host_like(x) if staged(pg, x) else x
    with comm_scope("recv", axes, payload=x,
                    extra=_extra(pg, x, {"src": src})):
        work = dist.irecv(buf, src=g, group=pg)

    def land():
        if buf is not x:
            x.copy_(_from_bytes(buf, x))
    return _issue(work, tensor, sync_op, land)


def p2p_shift(tensor, group=None, shift: int = 1):
    """Rank i's value goes to rank (i + shift) mod n along the group's
    ring (the reference's ``ppermute``, :505-519)."""
    pg, axes, n = _resolve(group)
    if pg is None or shift % n == 0:
        return tensor
    x = unwrap(tensor).contiguous()
    me = dist.get_rank(pg)
    stage = staged(pg, x)
    src = _to_host(x) if stage else x
    out = torch.empty_like(src)
    with comm_scope("p2p_shift", axes, payload=x,
                    extra=_extra(pg, x, {"shift": shift})):
        reqs = [dist.isend(src, dst=dist.get_global_rank(pg, (me + shift) % n),
                           group=pg),
                dist.irecv(out, src=dist.get_global_rank(pg, (me - shift) % n),
                           group=pg)]
        for r in reqs:
            r.wait()
    if stage:
        out = _from_bytes(out, x).to(x.device)
    return _like(tensor, out)


class _RingHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, shift, *xs):
        ctx.group, ctx.shift = group, shift
        return tuple(unwrap(p2p_shift(x, group, shift)) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None) + tuple(
            unwrap(p2p_shift(g.contiguous(), ctx.group, -ctx.shift))
            for g in gs)


def ring_hop(*tensors, group=None, shift: int = 1):
    """:func:`p2p_shift` of each tensor under autograd, as one node: the
    gradient of each value that arrived goes back the way it came (a hop
    by ``-shift``), in the same order on every rank. Every rank of the
    group must reach the backward alike, as every rank called the
    forward. Returns a tuple."""
    return _RingHop.apply(group, shift, *(unwrap(t) for t in tensors))


def barrier(group=None):
    """Block until every rank of the group arrives."""
    pg, axes, _ = _resolve(group)
    with comm_scope("barrier", axes):
        if pg is not None:
            dist.barrier(group=pg)
    return None


# -- spmd regions --------------------------------------------------------------
def _entry_axes(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _local_shard(a, spec, mesh):
    """This rank's block of the global ``a`` under ``spec``, as a new
    contiguous tensor (a collective in the region may write it)."""
    if not isinstance(a, torch.Tensor) or spec is None:
        return a
    return _like(a, _mesh.local_block(unwrap(a), spec, mesh).clone())


def gather_block(o, spec, mesh):
    """The global tensor of this rank's block ``o`` under ``spec``:
    gathered along each dim the spec splits (the other dims are taken as
    replicated)."""
    if not isinstance(o, torch.Tensor) or spec is None:
        return o
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if axes:
            o = all_gather(o, group=Group(axes, mesh), axis=d)
    return o


def _per_leaf(specs, n):
    if isinstance(specs, P) or specs is None:
        return [specs] * n
    specs = list(specs)
    if len(specs) != n:
        raise ValueError(f"{len(specs)} specs for {n} values")
    return specs


def shard_map(fn, mesh=None, in_specs=None, out_specs=None,
              check_rep=False):
    """``fn`` as a per-rank region over ``mesh``: each input is cut to
    this rank's shard by ``in_specs`` (one spec for every input, or one
    each), and each output gathered by ``out_specs``."""
    def run(*args):
        m = mesh or get_mesh()
        local = [_local_shard(a, s, m)
                 for a, s in zip(args, _per_leaf(in_specs, len(args)))]
        out = fn(*local)
        if isinstance(out, (tuple, list)):
            return type(out)(gather_block(o, s, m) for o, s in
                             zip(out, _per_leaf(out_specs, len(out))))
        return gather_block(out, out_specs, m)
    return run


def spmd(fn=None, mesh=None, in_specs=None, out_specs=None):
    """Decorator form of :func:`shard_map`."""
    def wrap_(f):
        return shard_map(f, mesh, in_specs, out_specs)
    return wrap_(fn) if fn is not None else wrap_


def _reset():
    """Forget the groups and sequence numbers of a torn-down world."""
    _mesh._groups.clear()
    _obj_seq.clear()
