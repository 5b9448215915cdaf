"""Samplers — port of ``paddle_tpu/io/sampler.py``.

The same index order as the reference for every seed and epoch: the
orders come from numpy's ``RandomState`` seeded by :func:`epoch_seed`
(or the generator the caller passes), exactly as the reference draws
them, so a sampler rebuilt in either package replays the other's order.
"""
from __future__ import annotations

import math
from typing import Iterator

import numpy as np

__all__ = ["Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "BatchSampler",
           "DistributedBatchSampler", "SubsetRandomSampler", "epoch_seed"]


def epoch_seed(base_seed: int, epoch: int) -> int:
    """Stable 32-bit seed for ``(base_seed, epoch)`` (splitmix64
    finalizer; reference :16): any sampler or stream seeded this way
    replays the identical shuffle for an epoch."""
    mask = (1 << 64) - 1
    x = ((int(base_seed) & mask) * 0x9E3779B97F4A7C15 + int(epoch) + 1) \
        & mask
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & mask
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & mask
    x ^= x >> 31
    return int(x & 0xFFFFFFFF)


def _rng(generator):
    """A numpy RNG from the caller's generator argument: None (numpy's
    global RNG), a numpy ``Generator``/``RandomState``, or an int seed.
    A ``torch.Generator`` draws one seed from itself, so successive
    epochs differ and stay seed-deterministic."""
    if generator is None:
        return np.random
    if hasattr(generator, "permutation"):
        return generator
    if isinstance(generator, (int, np.integer)):
        return np.random.RandomState(int(generator))
    import torch
    if isinstance(generator, torch.Generator):
        seed = int(torch.randint(0, 2 ** 31, (), generator=generator))
        return np.random.RandomState(seed)
    raise TypeError(f"unsupported generator {type(generator)}")


def _chunked(iterable, batch_size, drop_last):
    """Shared accumulate-and-flush batching loop."""
    batch = []
    for item in iterable:
        batch.append(item)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch and not drop_last:
        yield batch


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self) -> Iterator[int]:
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    """``base_seed`` switches on deterministic epoch-keyed shuffling: each
    ``__iter__`` draws from ``epoch_seed(base_seed, epoch)`` and advances
    the epoch; ``set_epoch`` pins the next one."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None, base_seed=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator
        self.base_seed = base_seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.base_seed is not None and self.generator is None:
            rng = np.random.RandomState(
                epoch_seed(self.base_seed, self.epoch))
            self.epoch += 1
        else:
            rng = _rng(self.generator)
        if self.replacement:
            if hasattr(rng, "integers"):  # np.random.Generator API
                return iter(rng.integers(0, n, self.num_samples).tolist())
            return iter(rng.randint(0, n, self.num_samples).tolist())
        perm = rng.permutation(n)[:self.num_samples]
        return iter(perm.tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices, generator=None):
        super().__init__(None)
        self.indices = list(indices)
        self.generator = generator

    def __iter__(self):
        return iter(_rng(self.generator).permutation(self.indices).tolist())

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        super().__init__(None)
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement
        if not replacement and num_samples > len(self.weights):
            raise ValueError("cannot draw more samples than weights "
                             "without replacement")

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    """Batches of a dataset's indices or of another sampler's."""

    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False, base_seed=None):
        super().__init__(dataset)
        if (dataset is None) == (sampler is None):
            raise ValueError("pass exactly one of dataset / sampler")
        if sampler is not None:
            self.sampler = sampler
        else:
            self.sampler = RandomSampler(dataset, base_seed=base_seed) \
                if shuffle else SequenceSampler(dataset)
        self.batch_size = batch_size
        self.drop_last = drop_last

    def set_epoch(self, epoch: int):
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def __iter__(self):
        yield from _chunked(self.sampler, self.batch_size, self.drop_last)

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def _world():
    """(rank, world size) of ``torch.distributed`` when a process group
    is up, else (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class DistributedBatchSampler(BatchSampler):
    """Rank-sliced batches: each rank takes a contiguous slice of the
    epoch's (optionally shuffled) order. ``num_replicas``/``rank``
    default to the ``torch.distributed`` process group, or one rank."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False, base_seed=0):
        r, w = _world()
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None else w
        self.local_rank = rank if rank is not None else r
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.base_seed = base_seed
        self.epoch = 0
        self.num_samples = int(
            math.ceil(len(dataset) / self.nranks)) if not drop_last else \
            len(dataset) // self.nranks
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.RandomState(
                epoch_seed(self.base_seed, self.epoch)).permutation(
                    n).tolist()
        else:
            indices = list(range(n))
        if not self.drop_last:
            while len(indices) < self.total_size:
                indices += indices[: self.total_size - len(indices)]
        else:
            indices = indices[: self.total_size]
        indices = indices[self.local_rank * self.num_samples:
                          (self.local_rank + 1) * self.num_samples]
        yield from _chunked(indices, self.batch_size, self.drop_last)

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch
