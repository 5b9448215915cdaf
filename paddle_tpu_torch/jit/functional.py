"""Functional execution of layers — port of ``paddle_tpu/jit/functional.py``.

Run a layer's ``forward`` with its parameter and buffer storage swapped
for explicit tensors: :func:`functional_state` splits a layer's state,
:func:`swap_state` swaps it for the length of a ``with`` block, and
:func:`functional_call` calls the layer once on swapped values (over
``torch.func.functional_call``). ``jit.to_static`` builds on the first
two.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch

from paddle_tpu_torch.core.tensor import unwrap

__all__ = ["functional_call", "functional_state", "swap_state"]


def functional_state(layer) -> Tuple[Dict, Dict, Dict]:
    """A layer's state as ``(trainable params, frozen params, buffers)``,
    dicts of its tensors keyed by qualified name."""
    train, frozen, buffers = {}, {}, {}
    for name, p in layer.named_parameters():
        (train if p.requires_grad else frozen)[name] = p
    for name, b in layer.named_buffers():
        if b is not None:
            buffers[name] = b
    return train, frozen, buffers


def _check_names(layer, names):
    """Raise ``KeyError`` for a name that is no parameter or buffer of
    ``layer``, before anything is swapped."""
    targets = {n for n, _ in layer.named_parameters()} | \
        {n for n, b in layer.named_buffers() if b is not None}
    unknown = [n for n in names if n not in targets]
    if unknown:
        raise KeyError(f"no parameter/buffer named {unknown}")


def _slot(layer, name):
    """The dict (``_parameters`` or ``_buffers`` of the owning module) and
    the key that hold ``name``."""
    owner, _, leaf = name.rpartition(".")
    module = layer.get_submodule(owner) if owner else layer
    return (module._parameters if leaf in module._parameters
            else module._buffers), leaf


@contextlib.contextmanager
def swap_state(layer, values: Dict[str, object],
               collect_buffers: bool = True):
    """Replace parameter and buffer storage with ``values`` (name ->
    tensor) for the ``with`` block, then restore it. Yields a dict that,
    after the block ran, holds the buffers as the block left them (running
    statistics written in the block). Every name is checked before any is
    swapped, so a typo raises ``KeyError`` and corrupts nothing."""
    _check_names(layer, values)
    saved = []
    out_buffers = {}
    try:
        for name, val in values.items():
            table, leaf = _slot(layer, name)
            saved.append((table, leaf, table[leaf]))
            table[leaf] = torch.as_tensor(unwrap(val))
        yield out_buffers
        if collect_buffers:
            out_buffers.update((n, b) for n, b in layer.named_buffers()
                               if b is not None)
    finally:
        for table, leaf, val in reversed(saved):
            table[leaf] = val


def functional_call(layer, params_and_buffers: Dict, *args, **kwargs):
    """``layer(*args, **kwargs)`` with its state replaced by
    ``params_and_buffers`` (name -> tensor or array); the layer's own
    storage is untouched afterwards. Unknown names raise ``KeyError``
    before anything runs."""
    _check_names(layer, params_and_buffers)
    device = next(iter(layer.parameters()), torch.empty(0)).device
    vals = {k: torch.as_tensor(unwrap(v), device=device)
            for k, v in params_and_buffers.items()}
    return torch.func.functional_call(layer, vals, args, kwargs)
