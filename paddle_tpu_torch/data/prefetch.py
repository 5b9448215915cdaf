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

Not ported yet: ``sharding=`` (placement onto a mesh) raises
``NotImplementedError``.
"""
from __future__ import annotations

import queue
import threading
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


def _refuse_sharding(sharding):
    if sharding is not None:
        raise NotImplementedError(
            "prefetch with sharding= places batches onto a mesh, which is "
            "not ported to paddle_tpu_torch yet")


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


def _stage(batch, device: torch.device):
    """Start the copies of every leaf of ``batch`` to ``device`` (on the
    current stream); returns (device batch, the staging buffers, which
    must live until the copies are done)."""
    staged = []

    def put(leaf):
        host = _host_tensor(leaf)
        if device.type == "cpu":
            return host.cpu()
        if host.is_cuda:
            return host.to(device, non_blocking=True)
        pinned = host if host.is_pinned() else host.pin_memory()
        staged.append(pinned)
        return pinned.to(device, non_blocking=True)

    return _walk(batch, put), staged


def to_device(batch, device=None, sharding=None):
    """Every array or tensor leaf of ``batch`` (dict/tuple/list nesting
    kept) as a torch tensor on ``device`` (``None``: the CUDA card,
    raising where there is none). A CUDA copy goes through page-locked
    memory; this call waits for it."""
    _refuse_sharding(sharding)
    device = resolve_device(device)
    out, staged = _stage(batch, device)
    if staged:
        torch.cuda.current_stream(device).synchronize()
    return out


def _deliver(item, device):
    """Make the consumer's stream wait for a prefetched batch's copies and
    mark its tensors used there."""
    state, batch, event, _ = item
    if event is not None:
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(event)
        _walk(batch, lambda t: t.record_stream(consumer)
              if isinstance(t, torch.Tensor) else t)
    return state, batch


def prefetch_pairs(pairs: Iterator[tuple], depth: int = 2, device=None,
                   sharding=None, registry=None) -> Iterator[tuple]:
    """Run ``(state, batch)`` pairs through a bounded background buffer,
    copying each batch to ``device`` on the producer thread. Yields the
    pairs in order; the caller commits ``state`` when it receives one."""
    _refuse_sharding(sharding)
    if depth < 1:
        raise ValueError("prefetch depth must be >= 1")
    device = resolve_device(device)
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
                    item = (state, _stage(batch, device)[0], None, None)
                else:
                    with torch.cuda.stream(side):
                        dev, staged = _stage(batch, device)
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
        _refuse_sharding(sharding)
        if isinstance(loader, DataPipeline):
            # an external prefetcher would commit the pipeline's state
            # when it pulls a batch, not when the trainer receives it
            raise ValueError(
                "wrap a DataPipeline with DataPipeline(device_prefetch="
                f"{depth}) instead — an external prefetcher would "
                "de-synchronize its checkpoint state from delivery")
        self.loader = loader
        self.depth = int(depth)
        self.registry = registry
        self.device = resolve_device(device)

    def __iter__(self):
        pairs = ((None, b) for b in self.loader)
        for _, batch in prefetch_pairs(pairs, depth=self.depth,
                                       device=self.device,
                                       registry=self.registry):
            yield batch

    def __len__(self):
        return len(self.loader)
