"""Data parallelism — port of ``paddle_tpu/distributed/parallel.py``.

``DataParallel`` wraps a model for training over the mesh's ``dp`` axis:
it makes the parameters equal on every ``dp`` rank (a broadcast from the
axis's first rank, as Paddle's wrapper does at wrap time) and tells
``jit.TrainStep`` to split each batch's dim 0 over ``dp``
(``batch_spec``) and to reduce gradients in buckets of
``comm_buffer_size`` MB (the reference's ``PADDLE_TPU_COMM_BUCKET_MB``
is this argument here, with the same default of 25).

The gradient contract is the reference's (``jit/bucketing.py``:
each rank's loss is a mean over its rows), made exact for a token mean
over uneven ``-100`` labels: a loss that divides by a count of valid
tokens reports it with :func:`note_loss_tokens` (the Llama causal-LM
loss does), and ``TrainStep`` weights each rank's gradient by its share
of the global count, so the step equals one mean over the global batch.

:func:`splitting_batch` is how ``TrainStep`` tells the layers of its
forward how the batch lies on the mesh: an expert-parallel
``MoELayer`` reads :func:`batch_split` to learn whether its tokens are
the global batch (replicated) or this rank's rows of it.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from paddle_tpu_torch.nn.layer_base import Layer

from . import collective as C
from .collective import P
from .mesh import axis_size, get_mesh

__all__ = ["DataParallel", "note_loss_tokens", "splitting_batch",
           "batch_split"]

_tls = threading.local()


def note_loss_tokens(count):
    """Called by a loss that is a mean over ``count`` tokens (a 0-d
    tensor or a number), while ``TrainStep`` counts them; a no-op
    otherwise."""
    noted = getattr(_tls, "noted", None)
    if noted is not None:
        noted.append(count)


@contextlib.contextmanager
def counting_loss_tokens():
    """Collect the counts :func:`note_loss_tokens` reports in the block
    (``TrainStep``'s forward); yields the list."""
    prev = getattr(_tls, "noted", None)
    _tls.noted = []
    try:
        yield _tls.noted
    finally:
        _tls.noted = prev


@contextlib.contextmanager
def splitting_batch(row_axes, batch_axes):
    """The block runs a forward whose batch is split over the mesh:
    ``row_axes`` split its dim 0 (the rows), ``batch_axes`` are every
    axis its input spec splits (``TrainStep(mesh=)`` sets them around
    its forward)."""
    prev = getattr(_tls, "split", None)
    _tls.split = (tuple(row_axes), tuple(batch_axes))
    try:
        yield
    finally:
        _tls.split = prev


def batch_split():
    """``(row axes, batch axes)`` of the forward running now; ``((),
    ())`` outside a ``TrainStep`` over a mesh: the batch is whole on
    every rank."""
    return getattr(_tls, "split", None) or ((), ())


class DataParallel(Layer):
    """Wrap ``layers`` for data-parallel training (reference :27-79).
    Forward delegates; so do the parameters and the state dict, under
    the wrapped model's names."""

    def __init__(self, layers: Layer, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None, mesh=None, batch_axis: str = "dp"):
        super().__init__()
        self._layers = layers
        self._mesh = mesh or get_mesh()
        self._batch_axis = batch_axis
        self.comm_buffer_size = comm_buffer_size
        if self._mesh is not None and \
                axis_size(self._mesh, batch_axis) > 1:
            group = C.Group((batch_axis,), self._mesh)
            with torch.no_grad():
                for p in layers.parameters():
                    C.broadcast(p.detach(), src=0, group=group)

    @property
    def batch_spec(self):
        return P(self._batch_axis)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def named_parameters(self, prefix="", include_sublayers=True,
                         **kwargs):
        return self._layers.named_parameters(prefix, include_sublayers,
                                             **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    def scale_loss(self, loss):
        """Reference API: the identity (``TrainStep`` weights each rank's
        gradient by its share of the batch)."""
        return loss

    @torch.no_grad()
    def apply_collective_grads(self):
        """Average the ``.grad`` of every parameter over the ``dp`` axis:
        after an eager ``loss.backward()`` on each rank's rows, the
        gradient of the mean over the global batch (``TrainStep`` does
        this itself, bucketed)."""
        if self._mesh is None:
            return None
        group = C.Group((self._batch_axis,), self._mesh)
        for p in self._layers.parameters():
            if p.grad is not None:
                C.all_reduce(p.grad, C.ReduceOp.AVG, group=group)
        return None
