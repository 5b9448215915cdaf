"""Tensor creation ops — port of ``paddle_tpu/ops/creation.py``.

Every result lands on the default device (``set_device``; the card
unless the caller chose the CPU), or on the device of the tensor a
``*_like`` op copies. Random ops draw from ``core.generator``'s stream
for that device (a ``seed=`` argument draws from a fresh generator with
that seed); their numbers differ from the JAX key stream by contract
(ROADMAP §3).
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from paddle_tpu_torch.core.dtype import convert_dtype, default_float
from paddle_tpu_torch.core.generator import draw_generator
from paddle_tpu_torch.core.tensor import unwrap, wrap
from ._common import LONG, as_t, device
from ._registry import OPS

__all__ = [
    "zeros", "ones", "full", "empty", "zeros_like", "ones_like", "full_like",
    "empty_like", "arange", "linspace", "logspace", "eye", "diag", "diagflat",
    "tril", "triu", "meshgrid", "rand", "randn", "randint", "randint_like",
    "uniform", "normal", "standard_normal", "randperm", "bernoulli",
    "multinomial", "poisson", "exponential_", "tril_indices", "triu_indices",
    "clone_detached", "complex",
]


def _dt(dtype, default=None):
    if dtype is None:
        return default_float() if default is None else convert_dtype(default)
    return convert_dtype(dtype)


def _scalar(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in unwrap(shape).reshape(-1).tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(s if isinstance(s, torch.SymInt) else int(_scalar(s))
                 for s in shape)


def _new(fn):
    """``fn(device)`` -> a ``Tensor`` on the default device."""
    return wrap(fn(device()))


def zeros(shape, dtype=None):
    return _new(lambda d: torch.zeros(_shape(shape), dtype=_dt(dtype),
                                      device=d))


def ones(shape, dtype=None):
    return _new(lambda d: torch.ones(_shape(shape), dtype=_dt(dtype),
                                     device=d))


def full(shape, fill_value, dtype=None):
    return _new(lambda d: torch.full(_shape(shape), _scalar(fill_value),
                                     dtype=_dt(dtype), device=d))


def empty(shape, dtype=None):
    return zeros(shape, dtype)  # zero-filled, so runs repeat exactly


def _like(x, dtype):
    x = as_t(unwrap(x))
    return x, (x.dtype if dtype is None else convert_dtype(dtype))


def zeros_like(x, dtype=None):
    x, dt = _like(x, dtype)
    return wrap(torch.zeros(x.shape, dtype=dt, device=x.device))


def ones_like(x, dtype=None):
    x, dt = _like(x, dtype)
    return wrap(torch.ones(x.shape, dtype=dt, device=x.device))


def full_like(x, fill_value, dtype=None):
    x, dt = _like(x, dtype)
    return wrap(torch.full(x.shape, _scalar(fill_value), dtype=dt,
                           device=x.device))


def empty_like(x, dtype=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None):
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = ("int64" if builtins.all(isinstance(v, (int, np.integer))
                                         for v in (start, end, step))
                 else None)
    return _new(lambda d: torch.arange(start, end, step, dtype=_dt(dtype),
                                       device=d))


def linspace(start, stop, num, dtype=None):
    return _new(lambda d: torch.linspace(_scalar(start), _scalar(stop),
                                         int(_scalar(num)), dtype=_dt(dtype),
                                         device=d))


def logspace(start, stop, num, base=10.0, dtype=None):
    return _new(lambda d: torch.logspace(_scalar(start), _scalar(stop),
                                         int(_scalar(num)), base=base,
                                         dtype=_dt(dtype), device=d))


def eye(num_rows, num_columns=None, dtype=None):
    n = int(num_rows)
    m = n if num_columns is None else int(num_columns)
    return _new(lambda d: torch.eye(n, m, dtype=_dt(dtype), device=d))


def diag(x, offset=0, padding_value=0):
    d = as_t(unwrap(x))
    out = torch.diag(d, offset)
    if d.ndim == 1 and padding_value != 0:
        out = torch.where(torch.diag(torch.ones_like(d, dtype=torch.bool),
                                     offset), out,
                          torch.full_like(out, padding_value))
    return wrap(out)


def diagflat(x, offset=0):
    return wrap(torch.diagflat(as_t(unwrap(x)), offset))


def tril(x, diagonal=0):
    return OPS["tril"](x, diagonal=diagonal)


def triu(x, diagonal=0):
    return OPS["triu"](x, diagonal=diagonal)


def tril_indices(row, col, offset=0):
    return _new(lambda d: torch.tril_indices(int(row), int(col), int(offset),
                                             device=d))


def triu_indices(row, col=None, offset=0):
    col = row if col is None else col
    return _new(lambda d: torch.triu_indices(int(row), int(col), int(offset),
                                             device=d))


def meshgrid(*args):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    arrs = [as_t(unwrap(a)) for a in args]
    return [wrap(o) for o in torch.meshgrid(*arrs, indexing="ij")]


def complex(real, imag):
    r, i = as_t(unwrap(real)), as_t(unwrap(imag))
    return wrap(torch.complex(r, i.to(r.dtype)))


# -- random --------------------------------------------------------------------
def rand(shape, dtype=None):
    return uniform(shape, dtype=dtype, min=0.0, max=1.0)


def randn(shape, dtype=None):
    return _new(lambda d: torch.randn(_shape(shape), dtype=_dt(dtype),
                                      device=d, generator=draw_generator(d)))


standard_normal = randn


def normal(mean=0.0, std=1.0, shape=None, name=None):
    m, s = unwrap(mean), unwrap(std)
    if isinstance(m, torch.Tensor) or isinstance(s, torch.Tensor):
        ref = m if isinstance(m, torch.Tensor) else s
        out_shape = torch.broadcast_shapes(
            getattr(m, "shape", ()), getattr(s, "shape", ())) \
            if shape is None else _shape(shape)
        g = torch.randn(out_shape, dtype=ref.dtype, device=ref.device,
                        generator=draw_generator(ref.device))
        return wrap(g * s + m)
    shape = [1] if shape is None else shape
    return _new(lambda d: torch.randn(_shape(shape), device=d,
                                      generator=draw_generator(d)) * s + m)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0):
    def draw(d):
        out = torch.empty(_shape(shape), dtype=_dt(dtype), device=d)
        return out.uniform_(min, max, generator=draw_generator(d, seed))
    return _new(draw)


def randint(low=0, high=None, shape=(1,), dtype=None):
    if high is None:
        low, high = 0, low
    return _new(lambda d: torch.randint(int(low), int(high), _shape(shape),
                                        dtype=_dt(dtype, "int64"), device=d,
                                        generator=draw_generator(d)))


def randint_like(x, low=0, high=None, dtype=None):
    x = unwrap(x)
    if high is None:
        low, high = 0, low
    return wrap(torch.randint(int(low), int(high), tuple(x.shape),
                              dtype=x.dtype if dtype is None
                              else convert_dtype(dtype), device=x.device,
                              generator=draw_generator(x.device)))


def randperm(n, dtype="int64"):
    return _new(lambda d: torch.randperm(int(n), device=d,
                                         generator=draw_generator(d)
                                         ).to(_dt(dtype, "int64")))


def bernoulli(x):
    d = unwrap(x)
    return wrap(torch.bernoulli(d, generator=draw_generator(d.device)))


def multinomial(x, num_samples=1, replacement=False):
    d = unwrap(x)
    return wrap(torch.multinomial(d, int(num_samples), replacement,
                                  generator=draw_generator(d.device)).to(LONG))


def poisson(x):
    d = unwrap(x)
    return wrap(torch.poisson(d, generator=draw_generator(d.device)))


def exponential_(x, lam=1.0):
    t = unwrap(x)
    with torch.no_grad():
        t.exponential_(lam, generator=draw_generator(t.device))
    return x


def clone_detached(x):
    return wrap(unwrap(x).detach().clone())
