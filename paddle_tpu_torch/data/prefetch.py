"""Device prefetch — port of ``paddle_tpu/data/prefetch.py``.

The last leg of the input pipeline: while the card runs step N, a
producer thread fetches batches N+1..N+depth and starts their copies to
the device, so the training loop's next batch is already there.

On a CUDA device each leaf is staged in page-locked host memory and
copied with ``non_blocking=True`` on a side stream (one per
:func:`prefetch_pairs` call), and an event is recorded after the batch's
copies. The consumer's stream waits on that event when the batch is
delivered, and each delivered tensor is marked used on the consumer's
stream (``record_stream``), so the allocator cannot hand its memory to a
later copy while the step still reads it. A staging buffer is refilled
only after its copy finished: each is a fresh page-locked block, held
until the batch is delivered, and PyTorch's pinned-memory cache takes a
block back only once the copy's event has completed. On the CPU
(``device="cpu"``) the leaves become CPU tensors.

Two entry points, as in the reference: :func:`prefetch_pairs` is the
seam ``DataPipeline(device_prefetch=N)`` uses — it carries each batch's
checkpoint state through the buffer, so the state still commits at
delivery — and :class:`DevicePrefetcher` wraps any iterable of batches
(and refuses a ``DataPipeline``, whose state would then commit at the
prefetcher's pull). Buffer occupancy is the ``data_prefetch_buffer``
gauge. A producer error is raised in the consumer at the failed batch;
a consumer that leaves early stops and joins the producer.

Placement onto a mesh (``sharding=``, reference :53-125): a
``sharding.NamedSharding`` (a spec on the port's process mesh) places
every leaf under its spec, and ``"auto"`` shards leaf dim 0 over the
current mesh's ``dp`` axis (its first axis without one; no mesh, no
placement). Each rank keeps its block of the global batch: the block is
cut on the host and only it is copied, and the leaf becomes a
``DTensor`` over the mesh (as ``distributed.shard_tensor`` returns). A
leaf the sharding cannot divide evenly (or of fewer dims than the spec)
is copied whole, with one warning a run, as the reference falls back to
an unsharded put.
"""
from __future__ import annotations

import queue
import threading
import warnings
from typing import Iterator

import numpy as np
import torch

from paddle_tpu_torch.device import resolve_device

from .metrics import data_metrics

__all__ = ["DevicePrefetcher", "prefetch_pairs", "to_device"]

_SENTINEL = object()


class _ProducerError:
    def __init__(self, exc):
        self.exc = exc


def _resolve_sharding(sharding):
    """``"auto"`` -> dim 0 over the mesh's ``dp`` axis (None without a
    mesh); a ``NamedSharding`` as it is."""
    if sharding is None:
        return None
    from paddle_tpu_torch.distributed.sharding_api import NamedSharding
    if isinstance(sharding, NamedSharding):
        return sharding
    if sharding != "auto":
        raise TypeError(f"sharding= takes 'auto' or a NamedSharding "
                        f"(distributed.named_sharding), not {sharding!r}")
    from paddle_tpu_torch.distributed import get_mesh, named_sharding
    mesh = get_mesh()
    if mesh is None:
        return None
    names = mesh.mesh_dim_names
    return named_sharding(("dp" if "dp" in names else names[0],), mesh)


_unsharded_fallback_warned = False


def _fits(sharding, shape) -> bool:
    """Whether ``shape`` divides evenly under ``sharding`` (the one reason
    to copy a leaf whole)."""
    from paddle_tpu_torch.distributed.mesh import axis_size
    spec = tuple(sharding.spec)
    if len(spec) > len(shape):
        return False
    return all(e is None or shape[d] % axis_size(sharding.mesh, e) == 0
               for d, e in enumerate(spec))


def _block(host: torch.Tensor, sharding):
    """This rank's block of a host leaf, or the leaf itself when the
    sharding cannot divide it (warned once a run)."""
    global _unsharded_fallback_warned
    if _fits(sharding, tuple(host.shape)):
        from paddle_tpu_torch.distributed.mesh import local_block
        return local_block(host, sharding.spec, sharding.mesh).contiguous()
    if not _unsharded_fallback_warned:
        _unsharded_fallback_warned = True
        warnings.warn(
            f"prefetch: leaf of shape {tuple(host.shape)} does not divide "
            f"evenly under {tuple(sharding.spec)}; copying it whole "
            "(reported once per run)", RuntimeWarning, stacklevel=4)
    return None


def _as_dtensor(block, host, sharding):
    from torch.distributed.tensor import DTensor
    if block.device.type != sharding.mesh.device_type:
        raise ValueError(f"a batch on {block.device} cannot be placed on "
                         f"a {sharding.mesh.device_type} mesh")
    out = DTensor.from_local(block, sharding.mesh, sharding.placements,
                             run_check=False, shape=host.shape,
                             stride=host.contiguous().stride())
    out._sharding_spec = sharding.spec
    return out


def _walk(obj, leaf):
    if isinstance(obj, dict):
        return {k: _walk(v, leaf) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_walk(v, leaf) for v in obj)
    return leaf(obj)


def _host_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.from_numpy(np.ascontiguousarray(leaf))


def _stage(batch, device: torch.device, sharding=None):
    """Start the copies of every leaf of ``batch`` to ``device`` (on the
    current stream), each cut to this rank's block under ``sharding``;
    returns (device batch, the staging buffers, which must live until
    the copies are done)."""
    staged = []

    def copy(host):
        if device.type == "cpu":
            return host.cpu()
        if host.is_cuda:
            return host.to(device, non_blocking=True)
        pinned = host if host.is_pinned() else host.pin_memory()
        staged.append(pinned)
        return pinned.to(device, non_blocking=True)

    def put(leaf):
        host = _host_tensor(leaf)
        block = None if sharding is None else _block(host, sharding)
        if block is None:
            return copy(host)
        return _as_dtensor(copy(block), host, sharding)

    return _walk(batch, put), staged


def to_device(batch, device=None, sharding=None):
    """Every array or tensor leaf of ``batch`` (dict/tuple/list nesting
    kept) as a torch tensor on ``device`` (``None``: the CUDA card,
    raising where there is none), or this rank's block of it as a
    ``DTensor`` under ``sharding``. A CUDA copy goes through page-locked
    memory; this call waits for it."""
    device = resolve_device(device)
    out, staged = _stage(batch, device, _resolve_sharding(sharding))
    if staged:
        torch.cuda.current_stream(device).synchronize()
    return out


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _deliver(item, device):
    """Make the consumer's stream wait for a prefetched batch's copies and
    mark its tensors used there."""
    state, batch, event, _ = item
    if event is not None:
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(event)
        _walk(batch, lambda t: _local(t).record_stream(consumer)
              if isinstance(t, torch.Tensor) else t)
    return state, batch


def prefetch_pairs(pairs: Iterator[tuple], depth: int = 2, device=None,
                   sharding=None, registry=None) -> Iterator[tuple]:
    """Run ``(state, batch)`` pairs through a bounded background buffer,
    copying each batch to ``device`` on the producer thread. Yields the
    pairs in order; the caller commits ``state`` when it receives one."""
    if depth < 1:
        raise ValueError("prefetch depth must be >= 1")
    device = resolve_device(device)
    placed = _resolve_sharding(sharding)
    gauge = data_metrics(registry)["prefetch_buffer"]
    side = torch.cuda.Stream(device) if device.type == "cuda" else None
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                gauge.set(q.qsize())
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for state, batch in pairs:
                if side is None:
                    item = (state, _stage(batch, device, placed)[0], None,
                            None)
                else:
                    with torch.cuda.stream(side):
                        dev, staged = _stage(batch, device, placed)
                        event = torch.cuda.Event()
                        event.record(side)
                    # the staging buffers ride along until delivery
                    item = (state, dev, event, staged)
                if not put(item):
                    return
        except BaseException as e:  # re-raised in the consumer
            if not put(_ProducerError(e)):
                return
        finally:
            put(_SENTINEL)

    t = threading.Thread(target=produce, daemon=True,
                         name="pt-data-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            gauge.set(q.qsize())
            if item is _SENTINEL:
                return
            if isinstance(item, _ProducerError):
                raise item.exc
            yield _deliver(item, device)
    finally:
        stop.set()
        # a straggler producer may be inside the pairs generator, moving
        # the pipeline's stream and packer: it must be done before the
        # caller re-anchors the pipeline on an early exit
        t.join()
        close = getattr(pairs, "close", None)
        if close is not None:
            close()


class DevicePrefetcher:
    """``for batch in DevicePrefetcher(loader): …`` yields ``loader``'s
    batches already on ``device`` (``None``: the CUDA card), ``depth``
    ahead. Each ``__iter__`` starts a fresh pass over ``loader``."""

    def __init__(self, loader, depth: int = 2, sharding=None,
                 registry=None, device=None):
        from .pipeline import DataPipeline
        if isinstance(loader, DataPipeline):
            # an external prefetcher would commit the pipeline's state
            # when it pulls a batch, not when the trainer receives it
            raise ValueError(
                "wrap a DataPipeline with DataPipeline(device_prefetch="
                f"{depth}) instead — an external prefetcher would "
                "de-synchronize its checkpoint state from delivery")
        self.loader = loader
        self.depth = int(depth)
        self.sharding = sharding
        self.registry = registry
        self.device = resolve_device(device)

    def __iter__(self):
        pairs = ((None, b) for b in self.loader)
        for _, batch in prefetch_pairs(pairs, depth=self.depth,
                                       device=self.device,
                                       sharding=self.sharding,
                                       registry=self.registry):
            yield batch

    def __len__(self):
        return len(self.loader)
