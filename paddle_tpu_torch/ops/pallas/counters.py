"""The port's kernel launch counters, in one registry.

Each module that launches a hand-written kernel (and ``nn.layer.rnn``,
for PyTorch's fused recurrence) keeps its counts as module-level
integers, which its wrappers bump where they launch, and registers them
here when it is imported. Code that must see every count, such as
``jit.cuda_graph`` (a capture gives its counts back and a replay adds
them again), reads this registry and names no counter itself.

A counter is ``(module, attribute path)``: ``("...flash_attention",
"launches_fwd")``, or ``("...ragged_paged_attention",
"ragged_paged_attention.launches")`` for a count kept on a function.
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

__all__ = ["register", "registered", "read", "add"]

Counter = Tuple[str, str]

# insertion-ordered set of the registered counters
_REGISTERED: Dict[Counter, None] = {}


def register(module: str, *paths: str) -> None:
    """Register the counters ``paths`` of ``module`` (its ``__name__``)."""
    for path in paths:
        _REGISTERED[(module, path)] = None


def registered() -> Tuple[Counter, ...]:
    """Every registered counter, in the order of registration."""
    return tuple(_REGISTERED)


def _owner(module: str, path: str):
    obj = importlib.import_module(module)
    *head, attr = path.split(".")
    for name in head:
        obj = getattr(obj, name)
    return obj, attr


def read() -> Dict[Counter, int]:
    """The current value of every registered counter."""
    return {c: getattr(*_owner(*c)) for c in _REGISTERED}


def add(deltas: Dict[Counter, int]) -> None:
    """Add ``deltas`` to the counters they name."""
    for c, n in deltas.items():
        obj, attr = _owner(*c)
        setattr(obj, attr, getattr(obj, attr) + n)
