"""PyLayer — port of ``paddle_tpu/autograd/py_layer.py`` (:19, :31).

A user-defined autograd op: a class with static ``forward(ctx, ...)``
and ``backward(ctx, *grads)``. The reference wires the pair into its
own tape; the port builds one ``torch.autograd.Function`` per
``PyLayer`` subclass, so the pair is an opaque node of PyTorch's graph.
``forward`` runs with gradients off and sees Paddle ``Tensor``s;
``backward`` gets the output gradients as ``Tensor``s and returns one
gradient (or ``None``) per tensor input. Each runs as one profiler span,
``pylayer::<name>`` and ``grad::pylayer::<name>`` (the reference spans
the forward, :67, and every backward node).
"""
from __future__ import annotations

from typing import Any

import torch

from paddle_tpu_torch import profiler
from paddle_tpu_torch.core.tensor import unwrap, wrap

__all__ = ["PyLayer", "PyLayerContext"]


class PyLayerContext:
    """What ``forward`` leaves for ``backward``: ``save_for_backward`` /
    ``saved_tensor`` and any attribute set on it."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *tensors):
        self._saved = tuple(tensors)

    def saved_tensor(self):
        return self._saved


def _function_of(cls):
    fn = cls.__dict__.get("_torch_function")
    if fn is not None:
        return fn

    class _Fn(torch.autograd.Function):
        @staticmethod
        def forward(tctx, kwargs, *args):
            ctx = PyLayerContext()
            tctx.pctx = ctx
            tctx.is_tensor = [isinstance(a, torch.Tensor) for a in args]
            with profiler.RecordEvent(f"pylayer::{cls.__name__}"):
                out = cls.forward(ctx, *[wrap(a) for a in args], **kwargs)
            if isinstance(out, (tuple, list)):
                return tuple(unwrap(o) for o in out)
            return unwrap(out)

        @staticmethod
        def backward(tctx, *grads):
            with profiler.RecordEvent(f"grad::pylayer::{cls.__name__}"):
                gs = cls.backward(tctx.pctx, *[wrap(g) for g in grads])
            if not isinstance(gs, (tuple, list)):
                gs = (gs,)
            it = iter(gs)
            out = [None]  # the kwargs slot
            for is_t in tctx.is_tensor:
                out.append(unwrap(next(it, None)) if is_t else None)
            return tuple(out)

    _Fn.__name__ = cls.__name__
    cls._torch_function = _Fn
    return _Fn


class PyLayer:
    """Subclass and define::

        class Exp(PyLayer):
            @staticmethod
            def forward(ctx, x):
                y = paddle.exp(x)
                ctx.save_for_backward(y)
                return y

            @staticmethod
            def backward(ctx, dy):
                (y,) = ctx.saved_tensor()
                return dy * y
    """

    @staticmethod
    def forward(ctx: PyLayerContext, *args: Any, **kwargs: Any):
        raise NotImplementedError

    @staticmethod
    def backward(ctx: PyLayerContext, *grads: Any):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        """Run ``forward`` as one node of the autograd graph; the outputs
        are ``Tensor``s."""
        out = _function_of(cls).apply(kwargs, *[unwrap(a) for a in args])
        return wrap(out)
