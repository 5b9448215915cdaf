"""``to_static`` — port of ``paddle_tpu/jit/api.py``.

The reference traces a layer or function once per input signature and
runs the compiled XLA executable from then on. The port keeps the same
cache (``code_cache``: one entry per ``(treedef, shapes and dtypes,
training)``) and the same semantics:

* a call runs under no-grad;
* a layer's parameters and buffers are runtime inputs, so an optimizer
  step between calls is seen with no retrace;
* buffers written in the call (batch-norm statistics) are written back;
* dropout differs from call to call.

On the card an entry holds one CUDA graph (``jit/cuda_graph.py``): the
first call with a signature copies its tensor arguments into static
buffers, runs the call once on a side stream (that run is the first
call's result) and captures it; later calls copy their arguments in and
replay. The
graph reads a layer's parameters and buffers where they live, so the key
on the card also holds their storage pointers: a ``set_state_dict`` or
``to()`` that installs new tensors captures again instead of replaying
stale addresses. What the graph returns is cloned out of its static
buffers before it is handed back. The draws of ``core.generator``'s
card stream (dropout) are registered with the graph, so each replay
draws a new mask. On the CPU the call runs eagerly under the same cache.
Each call is one profiler span, ``to_static:<name>`` (reference
:120-121).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils import _pytree as pytree

from paddle_tpu_torch.core import generator as _gen
from paddle_tpu_torch.core.tensor import unwrap_args, wrap
from paddle_tpu_torch.nn.layer_base import Layer
from paddle_tpu_torch.profiler import RecordEvent

from .cuda_graph import CapturedGraph

__all__ = ["to_static", "StaticFunction", "ignore_module", "not_to_static"]


def _signature(tree):
    leaves, treedef = pytree.tree_flatten(tree)
    sig = tuple(("T", tuple(x.shape), str(x.dtype), str(x.device))
                if isinstance(x, torch.Tensor) else ("P", repr(x))
                for x in leaves)
    return leaves, treedef, sig


def _device_of(leaves, layer):
    """Where the call runs: its first tensor's device, else its layer's,
    else the default device (the card unless ``set_device`` chose the
    CPU)."""
    for x in leaves:
        if isinstance(x, torch.Tensor):
            return x.device
    if layer is not None:
        for p in layer.parameters():
            return p.device
    from paddle_tpu_torch.device import resolve_device
    return resolve_device(None)


class StaticFunction:
    """A callable with a cache of compiled calls per input signature (the
    reference's ``StaticFunction``)."""

    def __init__(self, fn, input_spec=None, build_strategy=None,
                 backend=None):
        self._layer: Optional[Layer] = None
        if isinstance(fn, torch.nn.Module):
            self._layer = fn
            self._fn = fn.__call__  # through __call__ so forward hooks run
        elif hasattr(fn, "__self__") and isinstance(fn.__self__,
                                                    torch.nn.Module):
            self._layer = fn.__self__
            self._fn = fn.__self__.__call__
        else:
            self._fn = fn
        self._cache = {}
        functools.update_wrapper(self, fn if callable(fn) else self._fn)

    def _state_pointers(self):
        if self._layer is None:
            return ()
        return tuple(t.data_ptr() for t in (
            *self._layer.parameters(), *self._layer.buffers()))

    def _capture(self, leaves, treedef, device):
        """The card's entry for a new key: static buffers for the tensor
        leaves and the call captured over them. Returns ``(static, graph,
        the warm-up run's result)``, which is this call's."""
        static = [x.detach().clone() if isinstance(x, torch.Tensor) else x
                  for x in leaves]

        def call():
            args, kwargs = pytree.tree_unflatten(static, treedef)
            with torch.no_grad():
                return self._fn(*args, **kwargs)
        graph = CapturedGraph(call, device,
                              generators=[_gen.torch_generator(device)])
        return static, graph, graph.capture()

    def __call__(self, *args, **kwargs):
        with RecordEvent(f"to_static:{getattr(self, '__name__', 'fn')}"):
            return self._call(args, kwargs)

    def _call(self, args, kwargs):
        args, kwargs, had = unwrap_args(args, kwargs)
        leaves, treedef, sig = _signature((args, kwargs))
        training = self._layer.training if self._layer is not None \
            else False
        # the treedef is part of the key: the same leaves in another
        # structure must not share an entry
        key = (treedef, sig, training)
        device = _device_of(leaves, self._layer)
        if device.type != "cuda":
            # the CPU's route: eager, under the same cache
            self._cache.setdefault(key, None)
            with torch.no_grad():
                out = self._fn(*args, **kwargs)
            return wrap(out) if had else out
        pointers = self._state_pointers()
        entry = self._cache.get(key)
        if entry is None or entry[0] != pointers:
            static, graph, out = self._capture(leaves, treedef, device)
            self._cache[key] = (pointers, static, graph)
        else:
            _, static, graph = entry
            for buf, x in zip(static, leaves):
                if isinstance(buf, torch.Tensor):
                    buf.copy_(x)
            out = graph.replay()
        out = pytree.tree_map(
            lambda t: t.clone() if isinstance(t, torch.Tensor) else t, out)
        return wrap(out) if had else out

    @property
    def code_cache(self):
        return self._cache

    def clear_cache(self):
        self._cache.clear()


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """Decorator or wrapper: a layer or function as a
    :class:`StaticFunction` (reference ``paddle.jit.to_static``)."""
    def wrap_fn(fn):
        return StaticFunction(fn, input_spec, build_strategy, backend)
    if function is not None:
        return wrap_fn(function)
    return wrap_fn


def not_to_static(fn=None):
    """The identity, as in the reference: capture runs a function's
    helpers inline."""
    return fn if fn is not None else (lambda f: f)


def ignore_module(modules):
    """A no-op, as in the reference: capture needs no module list."""
    return None
