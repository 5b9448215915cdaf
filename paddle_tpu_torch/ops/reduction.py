"""Reduction and search ops — port of ``paddle_tpu/ops/reduction.py``.

Paddle's ``axis`` (None, an int or a list) and ``keepdim``; index
results are int64 (ROADMAP §3). ``median`` and ``quantile`` interpolate
linearly between the two middle values, as numpy's do (not PyTorch's
lower median).
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.dtype import convert_dtype
from ._common import LONG, all_dims, dims, floatify
from ._registry import op

# max, min, all and any are registered under those names (OPS) and
# exported by the package, so they do not shadow builtins here
__all__ = ["sum", "mean", "nanmean", "nansum", "prod", "amax", "amin", "std",
           "var", "median", "quantile", "logsumexp", "argmax", "argmin",
           "count_nonzero", "topk", "kthvalue", "mode"]


def _dt(dtype):
    return None if dtype is None else convert_dtype(dtype)


@op
def sum(x, axis=None, dtype=None, keepdim=False):
    if x.dtype is torch.bool and dtype is None:
        dtype = "int64"
    return torch.sum(x, dim=all_dims(x, axis), keepdim=keepdim,
                     dtype=_dt(dtype))


@op
def mean(x, axis=None, keepdim=False):
    return torch.mean(floatify(x), dim=all_dims(x, axis), keepdim=keepdim)


@op
def nanmean(x, axis=None, keepdim=False):
    return torch.nanmean(floatify(x), dim=all_dims(x, axis), keepdim=keepdim)


@op
def nansum(x, axis=None, dtype=None, keepdim=False):
    return torch.nansum(x, dim=all_dims(x, axis), keepdim=keepdim,
                        dtype=_dt(dtype))


@op
def prod(x, axis=None, keepdim=False, dtype=None):
    out = x if dtype is None else x.to(convert_dtype(dtype))
    for d in sorted((a % max(x.ndim, 1) for a in all_dims(x, axis)),
                    reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdim)
    return out


@op(name="max")
def max_(x, axis=None, keepdim=False):
    return torch.amax(x, dim=all_dims(x, axis), keepdim=keepdim)


@op(name="min")
def min_(x, axis=None, keepdim=False):
    return torch.amin(x, dim=all_dims(x, axis), keepdim=keepdim)


@op
def amax(x, axis=None, keepdim=False):
    return torch.amax(x, dim=all_dims(x, axis), keepdim=keepdim)


@op
def amin(x, axis=None, keepdim=False):
    return torch.amin(x, dim=all_dims(x, axis), keepdim=keepdim)


@op
def std(x, axis=None, unbiased=True, keepdim=False):
    return torch.std(floatify(x), dim=all_dims(x, axis),
                     correction=1 if unbiased else 0, keepdim=keepdim)


@op
def var(x, axis=None, unbiased=True, keepdim=False):
    return torch.var(floatify(x), dim=all_dims(x, axis),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def _quantile(x, q, axis, keepdim, fn=torch.quantile):
    """numpy's linear quantile over one axis or several (moved last and
    flattened)."""
    x = floatify(x)
    ax = [a % max(x.ndim, 1) for a in all_dims(x, axis)]
    rest = [d for d in range(x.ndim) if d not in ax]
    xm = x.permute(rest + ax).reshape([x.shape[d] for d in rest] + [-1])
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    out = fn(xm, qt, dim=-1)
    if keepdim:
        shape = [1 if d in ax else x.shape[d] for d in range(x.ndim)]
        out = out.reshape(tuple(qt.shape) + tuple(shape))
    return out


@op
def median(x, axis=None, keepdim=False):
    return _quantile(x, 0.5, axis, keepdim)


@op
def quantile(x, q, axis=None, keepdim=False):
    return _quantile(x, q, axis, keepdim)


@op
def logsumexp(x, axis=None, keepdim=False):
    return torch.logsumexp(floatify(x), dim=all_dims(x, axis),
                           keepdim=keepdim)


def _arg(fn, x, axis, keepdim, dtype):
    if x.dtype == torch.bool:  # torch refuses bool; jnp orders False < True
        x = x.to(torch.uint8)
    if axis is None:
        out = fn(x.reshape(-1))
        if keepdim:
            out = out.reshape([1] * x.ndim)
    else:
        out = fn(x, dim=int(axis), keepdim=keepdim)
    return out.to(convert_dtype(dtype))


@op
def argmax(x, axis=None, keepdim=False, dtype="int64"):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


@op
def argmin(x, axis=None, keepdim=False, dtype="int64"):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


@op(name="all")
def all_(x, axis=None, keepdim=False):
    return torch.all(x.bool(), dim=all_dims(x, axis), keepdim=keepdim)


@op(name="any")
def any_(x, axis=None, keepdim=False):
    return torch.any(x.bool(), dim=all_dims(x, axis), keepdim=keepdim)


@op
def count_nonzero(x, axis=None, keepdim=False):
    return torch.sum(x != 0, dim=all_dims(x, axis), keepdim=keepdim,
                     dtype=LONG)


@op
def topk(x, k, axis=-1, largest=True, sorted=True):
    vals, idx = torch.topk(x, int(k), dim=int(axis), largest=largest,
                           sorted=sorted)
    return vals, idx.to(LONG)


@op
def kthvalue(x, k, axis=-1, keepdim=False):
    vals, idx = torch.kthvalue(x, int(k), dim=int(axis), keepdim=keepdim)
    return vals, idx.to(LONG)


@op
def mode(x, axis=-1, keepdim=False):
    """The most frequent value along ``axis`` (count ties to the smallest
    value) and the last index holding it, as the reference computes them."""
    ax = dims(axis) % x.ndim
    xm = torch.movedim(x, ax, -1)
    n = xm.shape[-1]
    counts = (xm[..., :, None] == xm[..., None, :]).sum(-1)
    order = torch.argsort(xm, dim=-1, stable=True)
    xs = torch.gather(xm, -1, order)
    cs = torch.gather(counts, -1, order)
    best = torch.argmax(cs, dim=-1, keepdim=True)
    vals = torch.gather(xs, -1, best)
    pos = torch.arange(1, n + 1, device=x.device)
    idx = torch.argmax((xm == vals).long() * pos, dim=-1, keepdim=True)
    vals, idx = torch.movedim(vals, -1, ax), torch.movedim(idx, -1, ax)
    if not keepdim:
        vals, idx = vals.squeeze(ax), idx.squeeze(ax)
    return vals, idx.to(LONG)
