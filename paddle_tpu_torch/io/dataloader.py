"""DataLoader — port of ``paddle_tpu/io/dataloader.py``.

Batched, collated, prefetching input over a map-style or iterable
dataset. ``default_collate_fn`` stacks samples into host torch tensors
(numpy samples become CPU tensors over the stacked array); with
``pin_memory=True`` every batch tensor is copied into page-locked memory,
so the step's host-to-device copy can be ``non_blocking``.

Workers are host threads with a bounded prefetch queue, or, with
``use_process_workers=True``, worker processes (``spawn``: the dataset
and ``collate_fn`` must pickle, and a worker imports their modules
afresh). A bounded retry-then-skip budget (``max_bad_samples``,
``PADDLE_TPU_LOADER_MAX_BAD_SAMPLES``) covers sample fetch and collate
on the in-process paths, counted in ``loader_bad_samples_total``.

Not ported yet: the prefetch queue's entry in the reference's device
memory ledger (``observability.memory``).
"""
from __future__ import annotations

import itertools
import os
import queue
import threading
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler, RandomSampler, SequenceSampler, _chunked

__all__ = ["DataLoader", "default_collate_fn", "loader_metrics"]


def loader_metrics(registry=None) -> dict:
    """The ``loader_*`` metric families (created on first use)."""
    from paddle_tpu_torch.observability.metrics import get_registry
    r = registry if registry is not None else get_registry()
    return {
        "bad_samples": r.counter(
            "loader_bad_samples_total",
            "samples/batches skipped by the bad-sample budget"),
    }


def default_collate_fn(batch):
    """Stack a list of samples into host torch tensors; tuples, lists
    and dicts are collated field by field (reference :41)."""
    sample = batch[0]
    if isinstance(sample, (tuple, list)):
        return tuple(default_collate_fn([b[i] for b in batch])
                     for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch])
                for k in sample}
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    return torch.from_numpy(np.stack([np.asarray(b) for b in batch]))


def pin_batch(batch):
    """``batch`` with every tensor leaf copied into page-locked memory."""
    if isinstance(batch, dict):
        return {k: pin_batch(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(pin_batch(v) for v in batch)
    if isinstance(batch, torch.Tensor):
        return batch.pin_memory()
    return batch


class _WorkerError:
    def __init__(self, exc):
        self.exc = exc


_SKIP = object()  # sentinel: a sample dropped by the bad-sample budget


class _BadSampleBudget:
    """Bounded retry-then-skip policy over sample fetch and collate
    (reference :63): each failing fetch is retried once, then skipped and
    counted; exhausting the budget raises with the last error chained."""

    def __init__(self, limit: int):
        self.limit = int(limit)
        self.used = 0
        self._lock = threading.Lock()  # thread-pool fetches spend here

    def fetch(self, ds, i, stage: str = "fetch"):
        """``stage`` labels the skip in ``loader_bad_samples_total`` (the
        data pipeline spends from this budget as ``stage="stream"``)."""
        try:
            return ds[i]
        except Exception:
            try:
                return ds[i]  # one retry: transient IO heals here
            except Exception as e:
                self._spend(stage, f"dataset[{i!r}]", e)
                return _SKIP

    def collate(self, collate_fn, batch, stage: str = "collate"):
        try:
            return collate_fn(batch)
        except Exception as e:
            self._spend(stage, f"batch of {len(batch)}", e)
            return _SKIP

    def _spend(self, stage: str, what: str, exc: Exception):
        with self._lock:
            self.used += 1
            used = self.used
        loader_metrics()["bad_samples"].inc(stage=stage)
        warnings.warn(
            f"[dataloader] skipping bad {stage} ({what}): {exc!r} "
            f"[{used}/{self.limit} budget used]",
            RuntimeWarning, stacklevel=3)
        if used > self.limit:
            raise RuntimeError(
                f"DataLoader bad-sample budget exhausted: {used} "
                f"failures exceed PADDLE_TPU_LOADER_MAX_BAD_SAMPLES="
                f"{self.limit}; last failure at {stage} of {what}"
            ) from exc


class _Prefetcher:
    """Bounded-queue background producer over an iterator."""

    _SENTINEL = object()

    def __init__(self, make_iter: Callable, depth: int):
        self._make_iter = make_iter
        self._depth = depth

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self._depth)
        stop = threading.Event()

        def put(item) -> bool:
            # a bounded put that notices the consumer leaving
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for item in self._make_iter():
                    if not put(item):
                        return
            except BaseException as e:  # re-raised in the consumer
                if not put(_WorkerError(e)):
                    return
            finally:
                put(self._SENTINEL)

        t = threading.Thread(target=produce, daemon=True,
                             name="pt-loader-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._SENTINEL:
                    return
                if isinstance(item, _WorkerError):
                    raise item.exc
                yield item
        finally:
            stop.set()
            t.join()


def _process_worker(dataset, collate_fn, worker_init_fn, worker_id,
                    index_queue, result_queue):
    """Worker-process loop (reference :171): fetch a batch's samples,
    collate, send the batch back."""
    import traceback
    if worker_init_fn is not None:
        worker_init_fn(worker_id)
    while True:
        job = index_queue.get()
        if job is None:
            return
        bidx, indices = job
        try:
            batch = collate_fn([dataset[i] for i in indices])
            result_queue.put((bidx, batch))
        except Exception:
            result_queue.put((bidx, _WorkerError(
                RuntimeError("DataLoader worker %d failed:\n%s"
                             % (worker_id, traceback.format_exc())))))


class _ProcessPool:
    """Worker processes with round-robin batch assignment and in-order
    delivery (reference :195). Started with ``spawn``: a forked child of
    a process with threads, or with CUDA up, is unsafe."""

    def __init__(self, dataset, collate_fn, num_workers, worker_init_fn,
                 prefetch_factor):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self._nw = num_workers
        self._inflight_cap = max(prefetch_factor, 1) * num_workers
        self._index_queues = [ctx.SimpleQueue() for _ in range(num_workers)]
        # a Queue (not SimpleQueue): its timeout lets the consumer notice
        # a dead worker instead of waiting forever for its batch
        self._result_queue = ctx.Queue()
        self._procs = [
            ctx.Process(target=_process_worker,
                        args=(dataset, collate_fn, worker_init_fn, w,
                              self._index_queues[w], self._result_queue),
                        daemon=True)
            for w in range(num_workers)]
        for p in self._procs:
            p.start()

    def run(self, batch_indices_iter):
        send_idx, next_yield, inflight = 0, 0, 0
        done: dict = {}
        it = iter(batch_indices_iter)
        exhausted = False
        try:
            while True:
                while not exhausted and inflight < self._inflight_cap:
                    try:
                        indices = next(it)
                    except StopIteration:
                        exhausted = True
                        break
                    self._index_queues[send_idx % self._nw].put(
                        (send_idx, list(indices)))
                    send_idx += 1
                    inflight += 1
                if inflight == 0:
                    return
                while next_yield not in done:
                    try:
                        bidx, batch = self._result_queue.get(timeout=5.0)
                    except queue.Empty:
                        dead = [w for w, p in enumerate(self._procs)
                                if not p.is_alive()]
                        if dead:
                            raise RuntimeError(
                                f"DataLoader worker(s) {dead} died "
                                "without delivering their batch (killed "
                                "or crashed in __getitem__)")
                        continue
                    done[bidx] = batch
                batch = done.pop(next_yield)
                next_yield += 1
                inflight -= 1
                if isinstance(batch, _WorkerError):
                    raise batch.exc
                yield batch
        finally:
            self.shutdown()

    def shutdown(self):
        for q in self._index_queues:
            q.put(None)
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)


class DataLoader:
    def __init__(self, dataset: Dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler: Optional[BatchSampler] =
                 None, batch_size=1, shuffle=False, drop_last=False,
                 collate_fn=None, num_workers=0, use_buffer_reader=True,
                 prefetch_factor=2, use_shared_memory=True, timeout=0,
                 worker_init_fn=None, use_process_workers=False,
                 max_bad_samples=None, base_seed=None,
                 pin_memory=False):
        """The reference's arguments (:293), plus ``pin_memory``: copy
        each batch's tensors into page-locked memory. ``base_seed`` makes
        ``shuffle=True`` deterministic and epoch-keyed; ``max_bad_samples``
        (default ``$PADDLE_TPU_LOADER_MAX_BAD_SAMPLES``, 0 = off) turns on
        the bad-sample budget on the in-process paths (the process pool
        keeps fail-fast workers)."""
        self.dataset = dataset
        self.max_bad_samples = max_bad_samples
        self._bad_budget: Optional[_BadSampleBudget] = None
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.use_process_workers = bool(use_process_workers)
        self.worker_init_fn = worker_init_fn
        self.prefetch_factor = prefetch_factor
        self.pin_memory = bool(pin_memory)
        if self.use_process_workers and \
                isinstance(dataset, IterableDataset):
            raise ValueError(
                "use_process_workers supports map-style datasets only "
                "(an IterableDataset cannot be index-sharded to workers)")
        if self.use_process_workers and num_workers < 1:
            raise ValueError(
                "use_process_workers=True needs num_workers >= 1 "
                f"(got {num_workers}) — the subprocess pool IS the "
                "workers")
        self.prefetch_depth = max(prefetch_factor * max(num_workers, 1), 2) \
            if use_buffer_reader else 0
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            if batch_sampler is not None:
                raise ValueError(
                    "batch_sampler is incompatible with IterableDataset")
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            if batch_size is None:
                self.batch_sampler = None  # un-batched mode
                self._unbatched_sampler = \
                    RandomSampler(dataset, base_seed=base_seed) if shuffle \
                    else SequenceSampler(dataset)
            else:
                self.batch_sampler = BatchSampler(
                    dataset, shuffle=shuffle, batch_size=batch_size,
                    drop_last=drop_last, base_seed=base_seed)

    def _budget(self) -> Optional[_BadSampleBudget]:
        # one budget for the loader's lifetime, not per epoch
        if self._bad_budget is None:
            limit = self.max_bad_samples
            if limit is None:
                limit = int(os.environ.get(
                    "PADDLE_TPU_LOADER_MAX_BAD_SAMPLES", "0") or 0)
            if int(limit) > 0:
                self._bad_budget = _BadSampleBudget(limit)
        return self._bad_budget

    def _iter_map_style(self):
        ds, collate = self.dataset, self.collate_fn
        budget = self._budget()
        fetch = ds.__getitem__ if budget is None \
            else (lambda i: budget.fetch(ds, i))

        def finish(samples):
            """Collate one batch under the budget; _SKIP drops it."""
            samples = [s for s in samples if s is not _SKIP]
            if budget is None:
                return collate(samples)
            if not samples:
                return _SKIP
            return budget.collate(collate, samples)

        if self.batch_sampler is None:
            # batch_size=None: samples un-stacked
            for i in self._unbatched_sampler:
                s = fetch(i)
                if s is not _SKIP:
                    yield s
            return
        if self.use_process_workers and self.num_workers >= 1:
            pool = _ProcessPool(ds, collate, self.num_workers,
                                self.worker_init_fn, self.prefetch_factor)
            yield from pool.run(self.batch_sampler)
            return
        if self.num_workers <= 1:
            for batch_idx in self.batch_sampler:
                out = finish([fetch(i) for i in batch_idx])
                if out is not _SKIP:
                    yield out
            return
        # thread pool: a batch's items fetched concurrently, in order
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            batches = iter(self.batch_sampler)
            window = []
            for batch_idx in itertools.islice(batches, 2):
                window.append(pool.map(fetch, batch_idx))
            for batch_idx in batches:
                done = window.pop(0)
                window.append(pool.map(fetch, batch_idx))
                out = finish(list(done))
                if out is not _SKIP:
                    yield out
            for done in window:
                out = finish(list(done))
                if out is not _SKIP:
                    yield out

    def _iter_iterable(self):
        for batch in _chunked(self.dataset, self.batch_size,
                              self.drop_last):
            yield self.collate_fn(batch)

    def _batches(self):
        make = self._iter_iterable if self._iterable_mode \
            else self._iter_map_style
        for batch in make():
            yield pin_batch(batch) if self.pin_memory else batch

    def __iter__(self):
        if self.prefetch_depth:
            return iter(_Prefetcher(self._batches, self.prefetch_depth))
        return self._batches()

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no length")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    def __call__(self):
        return self.__iter__()
