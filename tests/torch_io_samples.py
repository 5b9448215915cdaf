"""Datasets shared by the port's data tests and their worker processes.
A worker process (``spawn``) unpickles these by module path, so this
module imports numpy only: no JAX, no torch, no test module."""
import numpy as np


class Squares:
    """Map-style (x, x*x) float32 samples."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        x = np.float32([i])
        return x, x * x


class Docs:
    """Deterministic variable-length token documents (ids in [1, vocab))."""

    def __init__(self, n=64, lo=5, hi=40, vocab=100):
        self.n, self.lo, self.hi, self.vocab = n, lo, hi, vocab

    def __getitem__(self, i):
        rng = np.random.RandomState(900 + i)
        return rng.randint(1, self.vocab,
                           rng.randint(self.lo, self.hi)).astype(np.int32)

    def __len__(self):
        return self.n


class LongDocs:
    """Four 70-token documents: at seq 8 one document flushes several
    packed batches."""

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        return rng.randint(1, 50, 70).astype(np.int32)

    def __len__(self):
        return 4


class Pairs:
    """Deterministic (x, y) samples for fit-shaped pipelines."""

    def __init__(self, n=24):
        self.n = n

    def __getitem__(self, i):
        rng = np.random.RandomState(50 + i)
        return (rng.randn(4).astype(np.float32),
                rng.randn(1).astype(np.float32))

    def __len__(self):
        return self.n
