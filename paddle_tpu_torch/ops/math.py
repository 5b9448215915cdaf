"""Elementwise and scalar math ops — port of ``paddle_tpu/ops/math.py``.

Each op is one plain PyTorch function with Paddle's signature,
registered in ``OPS``; Python scalars promote as scalars do (0-d
operands), as the reference's weak types do.
"""
from __future__ import annotations

import torch

from ._common import as_t, floatify, pair
from ._registry import op

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder",
    "mod", "pow", "maximum", "minimum", "fmax", "fmin", "atan2", "hypot",
    "scale", "lerp", "abs", "neg", "exp", "expm1", "log", "log2", "log10",
    "log1p", "sqrt", "rsqrt", "square", "reciprocal", "sign", "floor",
    "ceil", "round", "trunc", "frac", "sin", "cos", "tan", "asin", "acos",
    "atan", "sinh", "cosh", "tanh", "asinh", "acosh", "atanh", "erf",
    "erfinv", "sigmoid", "logit", "clip", "digamma", "lgamma", "angle",
    "conj", "real", "imag", "cumsum", "cumprod", "cummax", "cummin",
    "logcumsumexp", "isnan", "isinf", "isfinite", "isclose", "allclose",
    "equal_all", "equal", "not_equal", "less_than", "less_equal",
    "greater_than", "greater_equal", "logical_and", "logical_or",
    "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "left_shift", "right_shift", "stanh",
    "nan_to_num", "heaviside", "gcd", "lcm", "logaddexp", "multiplex",
]


# -- binary arithmetic ---------------------------------------------------------
@op
def add(x, y):
    return torch.add(*pair(x, y))


@op
def subtract(x, y):
    return torch.subtract(*pair(x, y))


@op
def multiply(x, y):
    return torch.multiply(*pair(x, y))


@op
def divide(x, y):
    return torch.true_divide(*pair(x, y))


@op
def floor_divide(x, y):
    return torch.floor_divide(*pair(x, y))


@op
def remainder(x, y):
    return torch.remainder(*pair(x, y))


mod = remainder


@op
def pow(x, y):
    x, y = pair(x, y)
    return torch.pow(x, y)


@op
def maximum(x, y):
    return torch.maximum(*pair(x, y))


@op
def minimum(x, y):
    return torch.minimum(*pair(x, y))


@op
def fmax(x, y):
    return torch.fmax(*pair(x, y))


@op
def fmin(x, y):
    return torch.fmin(*pair(x, y))


@op
def atan2(x, y):
    return torch.atan2(*pair(x, y))


@op
def hypot(x, y):
    return torch.hypot(*map(floatify, pair(x, y)))


@op
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True):
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


@op
def lerp(x, y, weight):
    return x + weight * (y - x)


# -- unary ---------------------------------------------------------------------
@op
def abs(x):
    return x.clone() if x.dtype == torch.bool else torch.abs(x)


@op
def neg(x):
    return torch.neg(x)


@op
def exp(x):
    return torch.exp(x)


@op
def expm1(x):
    return torch.expm1(x)


@op
def log(x):
    return torch.log(x)


@op
def log2(x):
    return torch.log2(x)


@op
def log10(x):
    return torch.log10(x)


@op
def log1p(x):
    return torch.log1p(x)


@op
def sqrt(x):
    return torch.sqrt(x)


@op
def rsqrt(x):
    return torch.rsqrt(x)


@op
def square(x):
    return torch.square(x)


@op
def reciprocal(x):
    return torch.reciprocal(x)


@op
def sign(x):
    return torch.sign(x)


@op
def floor(x):
    return x.clone() if x.dtype == torch.bool else torch.floor(x)


@op
def ceil(x):
    return x.clone() if x.dtype == torch.bool else torch.ceil(x)


@op
def round(x):
    return torch.round(x)  # half to even, as jnp.round


@op
def trunc(x):
    return x.clone() if x.dtype == torch.bool else torch.trunc(x)


@op
def frac(x):
    return x - torch.trunc(x)


@op
def sin(x):
    return torch.sin(x)


@op
def cos(x):
    return torch.cos(x)


@op
def tan(x):
    return torch.tan(x)


@op
def asin(x):
    return torch.asin(x)


@op
def acos(x):
    return torch.acos(x)


@op
def atan(x):
    return torch.atan(x)


@op
def sinh(x):
    return torch.sinh(x)


@op
def cosh(x):
    return torch.cosh(x)


@op
def tanh(x):
    return torch.tanh(x)


@op
def asinh(x):
    return torch.asinh(x)


@op
def acosh(x):
    return torch.acosh(x)


@op
def atanh(x):
    return torch.atanh(x)


@op
def erf(x):
    return torch.erf(x)


@op
def erfinv(x):
    return torch.erfinv(x)


@op
def sigmoid(x):
    return torch.sigmoid(x)


@op
def logit(x, eps=None):
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


@op
def clip(x, min=None, max=None):
    if min is None and max is None:
        return x
    return torch.clamp(x, min, max)


@op
def digamma(x):
    # the poles: torch gives -inf at 0, jax.scipy (the reference) nan at
    # every non-positive integer; the port keeps torch's -inf at 0
    return torch.digamma(x)


@op
def lgamma(x):
    return torch.lgamma(x)


@op
def angle(x):
    return torch.angle(x)


@op
def conj(x):
    return torch.conj_physical(x)


@op
def real(x):
    return torch.real(x).clone() if x.is_complex() else x


@op
def imag(x):
    return torch.imag(x).clone() if x.is_complex() else torch.zeros_like(x)


# -- scan-style ----------------------------------------------------------------
def _flat_axis(x, axis):
    if axis is None:
        return x.reshape(-1), 0
    return x, int(axis)


def _scan_dtype(x):
    """torch widens integer scans to int64; the reference's jnp scans keep
    the input's integer dtype (and wrap as it does)."""
    return x.dtype if not (x.is_floating_point() or x.is_complex() or
                           x.dtype == torch.bool) else None


@op
def cumsum(x, axis=None):
    x, axis = _flat_axis(x, axis)
    return torch.cumsum(x, axis, dtype=_scan_dtype(x))


@op
def cumprod(x, dim=None):
    x, dim = _flat_axis(x, dim)
    return torch.cumprod(x, dim, dtype=_scan_dtype(x))


@op
def cummax(x, axis=None):
    x, axis = _flat_axis(x, axis)
    return torch.cummax(x, axis).values


@op
def cummin(x, axis=None):
    x, axis = _flat_axis(x, axis)
    return torch.cummin(x, axis).values


@op
def logcumsumexp(x, axis=None):
    x, axis = _flat_axis(x, axis)
    return torch.logcumsumexp(x, axis)


# -- predicates ----------------------------------------------------------------
@op
def isnan(x):
    return torch.isnan(x)


@op
def isinf(x):
    return torch.isinf(x)


@op
def isfinite(x):
    return torch.isfinite(x)


@op
def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    x, y = pair(x, y)
    return torch.isclose(x, y.to(x.dtype), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


@op
def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    x, y = pair(x, y)
    return torch.tensor(torch.allclose(x, y.to(x.dtype), rtol=rtol,
                                       atol=atol, equal_nan=equal_nan),
                        device=x.device)


@op
def equal_all(x, y):
    x, y = pair(x, y)
    same = x.shape == y.shape and bool(torch.equal(x, y.to(x.dtype)))
    return torch.tensor(same, device=x.device)


# -- comparison ----------------------------------------------------------------
@op
def equal(x, y):
    return torch.eq(*pair(x, y))


@op
def not_equal(x, y):
    return torch.ne(*pair(x, y))


@op
def less_than(x, y):
    return torch.lt(*pair(x, y))


@op
def less_equal(x, y):
    return torch.le(*pair(x, y))


@op
def greater_than(x, y):
    return torch.gt(*pair(x, y))


@op
def greater_equal(x, y):
    return torch.ge(*pair(x, y))


# -- logical / bitwise ---------------------------------------------------------
@op
def logical_and(x, y):
    return torch.logical_and(*pair(x, y))


@op
def logical_or(x, y):
    return torch.logical_or(*pair(x, y))


@op
def logical_xor(x, y):
    return torch.logical_xor(*pair(x, y))


@op
def logical_not(x):
    return torch.logical_not(x)


@op
def bitwise_and(x, y):
    return torch.bitwise_and(*pair(x, y))


@op
def bitwise_or(x, y):
    return torch.bitwise_or(*pair(x, y))


@op
def bitwise_xor(x, y):
    return torch.bitwise_xor(*pair(x, y))


@op
def bitwise_not(x):
    return torch.bitwise_not(x)


@op
def left_shift(x, y):
    return torch.bitwise_left_shift(*pair(x, y))


@op
def right_shift(x, y):
    return torch.bitwise_right_shift(*pair(x, y))


# -- misc ----------------------------------------------------------------------
@op
def stanh(x, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * x)


@op
def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


@op
def heaviside(x, y):
    # integer inputs keep their dtype (Paddle's), where the reference
    # promotes to float32 (ROADMAP §3)
    x, y = pair(x, y)
    return torch.heaviside(x, y.to(x.dtype))


@op
def gcd(x, y):
    return torch.gcd(*pair(x, y))


@op
def lcm(x, y):
    return torch.lcm(*pair(x, y))


@op
def logaddexp(x, y):
    return torch.logaddexp(*map(floatify, pair(x, y)))


@op
def multiplex(inputs, index):
    stacked = torch.stack([as_t(t) for t in inputs], 0)
    idx = index.reshape(-1).long()
    return stacked[idx, torch.arange(idx.numel(), device=idx.device)]

