"""Kernel-configuration autotuning with a hit-counted cache — port of
``paddle_tpu/ops/pallas/autotune.py``.

The reference's analog of Paddle's ``AutoTuneCache`` (a map from an op
and a shape/dtype signature to its winning configuration, with hits and
misses counted) and ``AutoTuneBase::Run`` (measure every candidate once,
serve the cached winner afterwards). The port's tunables are the RPA
kernel's q tile (``ragged_paged_attention.rpa_tile_q``) and the fused
cross entropy's vocab chunk count (``ops.fused_ce._auto_chunks``); the
flash kernels have one tiling per head_dim by design, so the reference's
flash hook has nothing to choose here.

Off by default (``FLAGS_use_autotune``); with it off, callers keep their
defaults. Each candidate runs once as a warm-up and is then timed with
CUDA events on the card. The hooks return their default for CPU tensors
and sweep nothing, as the reference's do in interpret mode.

What differs from the reference: the cache is not persisted through
``PADDLE_AUTOTUNE_CACHE``; a caller that wants the winners across
processes passes a path to :meth:`AutoTuneCache.save` and
:meth:`AutoTuneCache.load`. A candidate that fails raises (the hooks
leave out beforehand what the kernel refuses), where the reference skips
it.
"""
from __future__ import annotations

import json
import statistics
from typing import Callable, Iterable, Optional, Tuple

import torch

__all__ = ["AutoTuneCache", "autotune", "measure_ms"]


class AutoTuneCache:
    """Process-wide ``(op, *signature) -> winner`` store with hit and miss
    counts."""

    _instance: Optional["AutoTuneCache"] = None

    def __init__(self):
        self._store: dict = {}
        self.hits = 0
        self.misses = 0

    @classmethod
    def instance(cls) -> "AutoTuneCache":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def lookup(self, key: Tuple):
        got = self._store.get(key)
        if got is None:
            self.misses += 1
        else:
            self.hits += 1
        return got

    def put(self, key: Tuple, value):
        self._store[key] = value

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {"size": len(self._store), "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0}

    def clear(self):
        self._store.clear()
        self.hits = self.misses = 0

    def save(self, path: str):
        """Write the winners to ``path`` as JSON (the reference's file
        layout: each key a JSON list, each value a number or a list)."""
        with open(path, "w") as f:
            json.dump({json.dumps(list(k)): list(v) if isinstance(
                v, (tuple, list)) else v for k, v in self._store.items()}, f)

    def load(self, path: str):
        """Merge the winners of a file written by :meth:`save` (or by the
        reference) into the cache; an entry already held stays."""
        with open(path) as f:
            raw = json.load(f)
        for k, v in raw.items():
            self._store.setdefault(tuple(json.loads(k)),
                                   tuple(v) if isinstance(v, list) else v)


def measure_ms(fn: Callable[[], object], reps: int = 5) -> float:
    """Milliseconds per call of ``fn`` on the card: one warm-up call,
    then the median of ``reps`` calls, each timed by CUDA events on the
    current stream."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def autotune(op: str, signature: Tuple, candidates: Iterable,
             build: Callable[[object], Callable[[], object]], default):
    """The best candidate for ``(op, signature)``.

    With ``FLAGS_use_autotune`` off: ``default``, and the cache is not
    read. On: a cached winner is served (a hit); on a miss each
    candidate is measured once (``build(cand)`` returns a zero-argument
    callable that runs the kernel at this signature, timed by
    :func:`measure_ms`), the least time wins, ``default`` wins a tie, and
    the winner is cached. A miss inside a CUDA-graph capture returns
    ``default`` uncached: nothing may run outside the graph there."""
    from paddle_tpu_torch.core.flags import flag

    if not flag("use_autotune"):
        return default
    cache = AutoTuneCache.instance()
    key = (op,) + tuple(signature)
    got = cache.lookup(key)
    if got is not None:
        return got
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        return default
    times = {cand: measure_ms(build(cand)) for cand in candidates}
    if not times:
        return default
    best = default if default in times else next(iter(times))
    for cand, t in times.items():
        if t < times[best]:
            best = cand
    cache.put(key, best)
    return best
