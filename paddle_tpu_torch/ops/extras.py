"""Long-tail tensor ops — port of ``paddle_tpu/ops/extras.py``.

One PyTorch call (or a short formula) per op, with Paddle's signature.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.generator import draw_generator
from paddle_tpu_torch.core.tensor import unwrap, wrap
from ._common import LONG, as_t, floatify
from ._registry import dispatch, op

__all__ = [
    "kron", "trapezoid", "cumulative_trapezoid", "rad2deg", "deg2rad",
    "polygamma", "igamma", "igammac", "i0", "i1", "renorm", "floor_mod",
    "clip_", "label_smooth", "increment", "nanquantile", "digitize",
    "polar", "matrix_exp", "vander", "householder_product", "pdist",
    "tensordot", "mm", "trace", "clone", "unstack", "index_fill", "rank",
    "vsplit", "hsplit", "dsplit", "tensor_split", "binomial",
]


@op
def kron(x, y):
    return torch.kron(x, y)


@op
def trapezoid(y, x=None, dx=None, axis=-1):
    if x is not None:
        return torch.trapezoid(y, x=x, dim=axis)
    return torch.trapezoid(y, dx=1.0 if dx is None else dx, dim=axis)


@op
def cumulative_trapezoid(y, x=None, dx=None, axis=-1):
    y1 = torch.movedim(y, axis, -1)
    if x is not None:
        if x.ndim > 1:
            xs = torch.movedim(torch.broadcast_to(x, y.shape), axis, -1)
            widths = torch.diff(xs, dim=-1)
        else:
            widths = torch.diff(x)
    else:
        widths = 1.0 if dx is None else dx
    areas = (y1[..., 1:] + y1[..., :-1]) / 2 * widths
    return torch.movedim(torch.cumsum(areas, dim=-1), -1, axis)


@op
def rad2deg(x):
    return torch.rad2deg(x)


@op
def deg2rad(x):
    return torch.deg2rad(x)


@op
def polygamma(x, n=1):
    return torch.polygamma(int(n), x)


@op
def igamma(x, a):
    # Paddle/torch: igamma is the lower regularised P(x, a), igammac Q
    return torch.igamma(floatify(x), floatify(as_t(a, x)))


@op
def igammac(x, a):
    return torch.igammac(floatify(x), floatify(as_t(a, x)))


@op
def i0(x):
    return torch.special.i0(x)


@op
def i1(x):
    return torch.special.i1(x)


@op
def renorm(x, p, axis, max_norm):
    moved = torch.movedim(x, axis, 0)
    flat = moved.reshape(moved.shape[0], -1)
    norms = torch.linalg.vector_norm(flat, p, dim=1)
    scale = torch.where(norms > max_norm,
                        max_norm / torch.clamp(norms, min=1e-12),
                        torch.ones_like(norms))
    out = flat * scale[:, None]
    return torch.movedim(out.reshape(moved.shape), 0, axis)


@op
def label_smooth(label, prior_dist=None, epsilon=0.1):
    k = label.shape[-1]
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / k


@op
def polar(abs, angle):
    abs = floatify(abs)
    return torch.polar(abs, angle.to(abs.dtype))


@op
def matrix_exp(x):
    return torch.linalg.matrix_exp(floatify(x))


@op
def vander(x, n=None, increasing=False):
    # running products (torch.vander's backward fails on its in-place
    # cumprod, and x ** 0 would give NaN gradients at 0)
    n = x.shape[-1] if n is None else int(n)
    cols = [torch.ones_like(x)]
    for _ in range(n - 1):
        cols.append(cols[-1] * x)
    out = torch.stack(cols[:n], dim=-1)
    return out if increasing else torch.flip(out, [-1])


@op
def householder_product(x, tau):
    return torch.linalg.householder_product(x, tau)


@op
def pdist(x, p=2.0):
    return torch.pdist(floatify(x), p)


@op
def tensordot(x, y, axes=2):
    return torch.tensordot(x, y, dims=axes)


@op
def mm(input, mat2):
    return torch.matmul(input, mat2)


@op
def trace(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


@op
def clone(x):
    return x.clone()


@op
def index_fill(x, index, axis, value):
    return torch.index_fill(x, axis, index.long(), value)


def unstack(x, axis=0, num=None):
    """``paddle.unstack``: the slices along ``axis``, as a list."""
    return list(dispatch("unstack", lambda a: torch.unbind(a, axis), (x,),
                         {}))


def rank(x):
    t = unwrap(x)
    return wrap(torch.tensor(t.ndim, dtype=torch.int32, device=t.device))


def nanquantile(x, q, axis=None, keepdim=False):
    from .reduction import _quantile
    return dispatch("nanquantile", lambda a: _quantile(
        a, q, axis, keepdim, fn=torch.nanquantile), (x,), {})


def digitize(x, bins, right=False):
    # increasing bins: right=False counts bins <= x, right=True bins < x
    return dispatch("digitize", lambda a, b: torch.searchsorted(
        b, a, right=not right), (x, bins), {})


def _split_helper(x, indices_or_sections, axis):
    def f(a):
        sec = indices_or_sections
        return tuple(torch.tensor_split(
            a, sec if isinstance(sec, int) else list(sec), dim=axis))
    return list(dispatch("tensor_split", f, (x,), {}))


def tensor_split(x, num_or_indices, axis=0):
    return _split_helper(x, num_or_indices, axis)


def vsplit(x, num_or_indices):
    return _split_helper(x, num_or_indices, 0)


def hsplit(x, num_or_indices):
    return _split_helper(x, num_or_indices, 1)


def dsplit(x, num_or_indices):
    return _split_helper(x, num_or_indices, 2)


def clip_(x, min=None, max=None):
    """In-place clip: ``Tensor.clip_``, keeping dtype and shape."""
    return x.clip_(min, max)


def increment(x, value=1.0):
    """``paddle.increment``: add ``value`` in place."""
    t = unwrap(x)
    with torch.no_grad():
        t.add_(value)
    return x


def floor_mod(x, y):
    from . import math as _m
    return _m.mod(x, y)


def binomial(count, prob):
    """Draws of Binomial(count, prob), elementwise, as int64."""
    c, p = unwrap(count), unwrap(prob)
    c, p = torch.broadcast_tensors(c.to(p.dtype), p)
    out = torch.binomial(c, p, generator=draw_generator(p.device))
    return wrap(out.to(LONG))
