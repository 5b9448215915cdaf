"""Dataset abstractions — port of ``paddle_tpu/io/dataset.py``."""
from __future__ import annotations

import bisect
from typing import Iterable, List, Sequence

import numpy as np
import torch

from .sampler import _rng

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ChainDataset",
           "ComposeDataset", "ConcatDataset", "Subset", "random_split"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError(
            f"{type(self).__name__} must implement __getitem__")

    def __len__(self):
        raise NotImplementedError(
            f"{type(self).__name__} must implement __len__")


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError(
            f"{type(self).__name__} must implement __iter__")

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset is not indexable")

    def __len__(self):
        raise RuntimeError("IterableDataset has no length")


class TensorDataset(Dataset):
    """Equal-first-dim tensors or arrays; item i is the tuple of row i,
    as torch tensors on the device the inputs were on (numpy arrays
    become CPU tensors)."""

    def __init__(self, tensors: Sequence):
        self._tensors = [t if isinstance(t, torch.Tensor)
                         else torch.as_tensor(np.asarray(t))
                         for t in tensors]
        n = self._tensors[0].shape[0]
        for t in self._tensors:
            if t.shape[0] != n:
                raise ValueError("tensors must share dim 0")

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self._tensors)

    def __len__(self):
        return self._tensors[0].shape[0]


class ComposeDataset(Dataset):
    """Zip map-style datasets: item i concatenates every dataset's item i."""

    def __init__(self, datasets: Sequence[Dataset]):
        self._datasets = list(datasets)
        if not self._datasets:
            raise ValueError("datasets must not be empty")
        n = len(self._datasets[0])
        for d in self._datasets:
            if len(d) != n:
                raise ValueError("composed datasets must share length")

    def __len__(self):
        return len(self._datasets[0])

    def __getitem__(self, idx):
        out = []
        for d in self._datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)


class ChainDataset(IterableDataset):
    """Concatenate iterable datasets end to end."""

    def __init__(self, datasets: Sequence[IterableDataset]):
        self._datasets = list(datasets)

    def __iter__(self):
        for d in self._datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets: Iterable[Dataset]):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum(
            [len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        i = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = self.cumulative_sizes[i - 1] if i > 0 else 0
        return self.datasets[i][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset: Dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset: Dataset, lengths: Sequence,
                 generator=None) -> List[Subset]:
    """Split into subsets of the given lengths or fractions (reference
    :122), by one permutation from the generator."""
    n = len(dataset)
    lengths = list(lengths)
    if all(0 < f < 1 for f in lengths if isinstance(f, float)) and \
            any(isinstance(f, float) for f in lengths):
        if abs(sum(lengths) - 1.0) > 1e-6:
            raise ValueError(
                f"split fractions must sum to 1, got {sum(lengths)}")
        sizes = [int(np.floor(n * f)) for f in lengths]
        for i in range(n - sum(sizes)):
            sizes[i % len(sizes)] += 1
        lengths = sizes
    if sum(lengths) != n:
        raise ValueError(
            f"sum of lengths {sum(lengths)} != dataset size {n}")
    perm = _rng(generator).permutation(n)
    out, offset = [], 0
    for ln in lengths:
        out.append(Subset(dataset, perm[offset:offset + ln].tolist()))
        offset += ln
    return out
