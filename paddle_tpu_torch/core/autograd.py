"""Eager autograd API — port of ``paddle_tpu/core/autograd.py`` (:38-79,
:272, :592).

The reference records its own tape of ``jax.vjp`` closures; the port
keeps PyTorch's autograd, which already is that tape, and gives it
Paddle's surface: ``no_grad``/``enable_grad`` (context managers and
decorators), ``set_grad_enabled``/``is_grad_enabled``, ``backward`` and
``grad``. Paddle's semantics hold: ``stop_gradient`` blocks,
``.grad`` accumulates until ``clear_grad``, a non-scalar ``backward``
needs a gradient tensor, ``retain_graph`` keeps the graph for a second
pass, and ``grad`` touches no ``.grad`` and takes ``allow_unused`` and
``create_graph``.
"""
from __future__ import annotations

import functools

import torch

from .tensor import unwrap, wrap

__all__ = ["no_grad", "enable_grad", "is_grad_enabled", "set_grad_enabled",
           "backward", "grad"]


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(mode: bool):
    """Switch gradient recording on or off for this thread; usable as a
    context manager too."""
    return torch.set_grad_enabled(bool(mode))


class _GradGuard:
    """Context manager *and* decorator, like ``paddle.no_grad``."""

    def __init__(self, mode: bool):
        self._mode = mode
        self._prev = []

    def __enter__(self):
        self._prev.append(torch.is_grad_enabled())
        torch.set_grad_enabled(self._mode)
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._prev.pop())
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            with _GradGuard(self._mode):
                return fn(*a, **k)
        return wrapper


def no_grad(fn=None):
    g = _GradGuard(False)
    return g(fn) if callable(fn) else g


def enable_grad(fn=None):
    g = _GradGuard(True)
    return g(fn) if callable(fn) else g


def _as_list(x):
    if x is None:
        return None
    return list(x) if isinstance(x, (list, tuple)) else [x]


def backward(tensors, grad_tensors=None, retain_graph: bool = False):
    """``paddle.autograd.backward``: accumulate the gradients of
    ``tensors`` into the leaves' ``.grad``. A tensor of more than one
    element needs its gradient in ``grad_tensors``."""
    tensors = _as_list(tensors)
    grads = _as_list(grad_tensors) or [None] * len(tensors)
    outs, seeds = [], []
    for t, g in zip(tensors, grads):
        t = unwrap(t)
        if g is None:
            if t.numel() != 1:
                raise RuntimeError(
                    "grad can be implicitly created only for scalar "
                    "outputs; pass grad_tensors for non-scalar backward()")
            g = torch.ones_like(t)
        else:
            g = unwrap(g) if isinstance(g, torch.Tensor) else \
                torch.as_tensor(g, dtype=t.dtype, device=t.device)
        outs.append(t)
        seeds.append(g)
    torch.autograd.backward(outs, seeds, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph: bool = False, only_inputs: bool = True,
         allow_unused: bool = False, no_grad_vars=None):
    """``paddle.grad``: the gradients of ``outputs`` with respect to
    ``inputs``, as new tensors; no ``.grad`` is touched. An input the
    outputs do not reach raises unless ``allow_unused``, which gives
    ``None`` for it. ``create_graph=True`` makes the result
    differentiable again."""
    if no_grad_vars is not None:
        raise NotImplementedError("grad(no_grad_vars=) is not ported")
    inputs = _as_list(inputs)
    outputs = [unwrap(o) for o in _as_list(outputs)]
    gouts = _as_list(grad_outputs)
    if gouts is not None:
        gouts = [None if g is None else unwrap(g) for g in gouts]
    if retain_graph is None:
        retain_graph = create_graph
    res = torch.autograd.grad(outputs, inputs, grad_outputs=gouts,
                              retain_graph=retain_graph,
                              create_graph=create_graph,
                              allow_unused=allow_unused)
    return [None if g is None else wrap(g) for g in res]
