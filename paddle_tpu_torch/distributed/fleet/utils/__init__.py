"""``fleet.utils`` of the port: activation recomputation — ``recompute``
and ``recompute_sequential`` of
``paddle_tpu/distributed/fleet/utils/__init__.py`` (:195-261).

The reference marks the region with ``jax.checkpoint`` and XLA re-emits
its forward inside the backward with the same traced random values. The
port builds on ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``:
the region keeps only its inputs, and the backward runs its forward
again. That re-run must draw the same random numbers as the first run,
or dropout would draw a new mask and the gradients would be wrong.
``checkpoint``'s ``preserve_rng_state`` covers only PyTorch's default
generators; the port's dropout draws from ``core.generator``'s own
``torch.Generator``s, and the flash kernels' dropout seed from its CPU
stream. So :func:`recompute` stashes the state of every stream of
``core.generator.default_generator`` before the first run, sets it back
for the re-run, and restores afterwards what the first run left.

The reference's JAX mesh helpers of the same file (``shard_map_compat``,
``match_vma``, ``pvary_compat``) and its ``fs`` clients wait for the
distributed slice.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch.core import generator as _gen
from paddle_tpu_torch.core.tensor import unwrap_args, wrap

__all__ = ["recompute", "recompute_sequential"]


def _streams():
    """Every ``torch.Generator`` of the default generator and its state."""
    gen = _gen.default_generator
    return {g: g.get_state() for g in gen._gens.values()}


def _set_streams(states, seed):
    """Set the default generator's streams back to ``states``; a stream
    made since (first used after the stash) goes back to its fresh state,
    seeded with ``seed``."""
    for g in _gen.default_generator._gens.values():
        if g in states:
            g.set_state(states[g])
        else:
            g.manual_seed(seed)


def recompute(function, *args, preserve_rng_state: bool = True,
              use_reentrant: bool = True, **kwargs):
    """``function(*args, **kwargs)`` without keeping its activations: the
    backward runs it again. ``function`` may be a layer, a bound method,
    a closure over layers or a plain function of its tensor arguments;
    parameters it reaches get their gradients. With
    ``preserve_rng_state`` (the default) the re-run draws the same random
    numbers as the first run, from ``core.generator`` and from PyTorch's
    default generators. ``use_reentrant`` is accepted as in the
    reference; the non-reentrant form always runs."""
    del use_reentrant
    args, kwargs, had = unwrap_args(args, kwargs)
    seed = _gen.default_generator.seed()
    stash = _streams() if preserve_rng_state else None
    runs = [0]

    def run(*a, **kw):
        runs[0] += 1
        if runs[0] == 1 or stash is None:
            return function(*a, **kw)
        after = _streams()
        _set_streams(stash, seed)
        try:
            return function(*a, **kw)
        finally:
            _set_streams(after, seed)

    out = checkpoint(run, *args, use_reentrant=False,
                     preserve_rng_state=preserve_rng_state, **kwargs)
    return wrap(out) if had else out


def recompute_sequential(ctx: Any, functions, *args):
    """A sequence of layers in ``segments`` chunks (``ctx =
    {"segments": N}``, default one a layer), each chunk under
    :func:`recompute` (reference :231-261)."""
    layers = list(functions)
    segments = int((ctx or {}).get("segments", len(layers))) or 1
    per = max(1, (len(layers) + segments - 1) // segments)
    out = args

    def chunk_fn(chunk):
        def run(*xs):
            for m in chunk:
                xs = m(*xs) if isinstance(xs, tuple) else m(xs)
                if not isinstance(xs, tuple):
                    xs = (xs,)
            return xs if len(xs) > 1 else xs[0]
        return run

    for i in range(0, len(layers), per):
        out = recompute(chunk_fn(layers[i:i + per]),
                        *(out if isinstance(out, tuple) else (out,)))
    return out
