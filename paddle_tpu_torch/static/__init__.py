"""``paddle.static`` — port of ``paddle_tpu/static/__init__.py``.

``InputSpec`` describes an input of ``jit.save``; the Program/Executor
workflow lives in :mod:`.graph` (a recorded program replayed per run)
and its layer helpers and control flow in :mod:`.nn`.
``save_inference_model``/``load_inference_model`` raise, as the
reference's do: ``jit.save``/``jit.load`` are the route.
"""
from __future__ import annotations

from typing import Optional, Sequence

from paddle_tpu_torch.core.dtype import to_dtype
from .graph import (  # noqa: F401
    Executor, Program, data, default_main_program,
    default_startup_program, global_scope, program_guard,
)
from . import nn  # noqa: F401

__all__ = ["InputSpec", "save_inference_model", "load_inference_model",
           "Executor", "Program", "data", "default_main_program",
           "default_startup_program", "global_scope", "program_guard",
           "nn"]


class InputSpec:
    """Reference ``InputSpec``: a shape with ``-1`` where a dim is
    dynamic (``None`` is taken for it), a dtype and a name."""

    def __init__(self, shape: Sequence[Optional[int]], dtype="float32",
                 name: Optional[str] = None, stop_gradient: bool = True):
        self.shape = tuple(-1 if s is None else int(s) for s in shape)
        self.dtype = to_dtype(dtype)
        self.name = name
        self.stop_gradient = stop_gradient

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tuple(tensor.shape), to_dtype(tensor.dtype), name)

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, "
                f"dtype={self.dtype.name}, name={self.name})")


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         **kwargs):
    raise NotImplementedError(
        "program-based save_inference_model has no analog; use "
        "paddle_tpu_torch.jit.save(layer, path, input_spec=[...]), which "
        "exports a torch.export program")


def load_inference_model(path_prefix, executor=None, **kwargs):
    raise NotImplementedError(
        "use paddle_tpu_torch.jit.load(path) to load a jit.save program")
