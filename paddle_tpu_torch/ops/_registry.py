"""Op registry — port of ``paddle_tpu/ops/_registry.py``.

Each op of the library is one plain PyTorch function over plain tensors
(``RAW``); :func:`op` registers it with its eager wrapper (``OPS``),
which unwraps Paddle ``Tensor`` arguments (zero-copy), calls it, and
wraps the result as ``Tensor``s. Autograd is PyTorch's. The wrapper also
honours ``FLAGS_check_nan_inf`` (a floating output with a NaN or an Inf
raises ``FloatingPointError``) and ``FLAGS_benchmark`` (wait for the card
after the op), and casts the op's floating inputs by its name under an
active ``amp.auto_cast`` policy (the reference casts in ``apply_op``).
While a ``profiler.Profiler`` records or the flight recorder is on, each
call is one host span named after the op (``record_shapes`` adds its
operands' shapes), as the reference's dispatch emits
(``core/autograd.py:162-166``); disarmed, that costs one attribute read.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch

from paddle_tpu_torch.amp.auto_cast import _open as _amp_open
from paddle_tpu_torch.amp.auto_cast import cast_inputs
from paddle_tpu_torch import profiler as _profiler
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.core.tensor import unwrap_args, wrap

__all__ = ["OPS", "RAW", "op", "get_op", "dispatch"]

OPS: Dict[str, Callable] = {}      # name -> eager wrapper
RAW: Dict[str, Callable] = {}      # name -> plain PyTorch function
_FLAGS = flags._REGISTRY


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)


def _check_nan_inf(name, out):
    for t in _tensors(out):
        if (t.is_floating_point() or t.is_complex()) and \
                not bool(torch.isfinite(t).all()):
            raise FloatingPointError(
                f"NaN/Inf detected in output of op '{name}' "
                f"(FLAGS_check_nan_inf is on)")


def dispatch(name: str, fn: Callable, args, kwargs):
    """Run ``fn`` on unwrapped arguments and wrap what it returns."""
    args, kwargs, _ = unwrap_args(args, kwargs)
    if _amp_open[0]:
        args, kwargs = cast_inputs(name, args, kwargs)
    if _profiler._armed:
        ev = _profiler.record_op(name, args)
        try:
            out = fn(*args, **kwargs)
        finally:
            ev.end()
    else:
        out = fn(*args, **kwargs)
    if _FLAGS["check_nan_inf"].value:
        _check_nan_inf(name, out)
    if _FLAGS["benchmark"].value and torch.cuda.is_available():
        torch.cuda.synchronize()
    return wrap(out)


def op(fn: Optional[Callable] = None, *, name: Optional[str] = None):
    """Register a plain PyTorch function as an op of the library."""

    def deco(f):
        opname = name or f.__name__

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            return dispatch(opname, f, args, kwargs)

        wrapper.__name__ = opname
        OPS[opname] = wrapper
        RAW[opname] = f
        return wrapper

    return deco(fn) if fn is not None else deco


def get_op(name: str) -> Callable:
    return OPS[name]
