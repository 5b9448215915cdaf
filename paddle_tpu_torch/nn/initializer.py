"""Weight initializers — port of ``paddle_tpu/nn/initializer.py``.

``Constant``, ``Normal``, ``TruncatedNormal``, ``Uniform``,
``XavierNormal``/``XavierUniform``, ``KaimingNormal``/``KaimingUniform``,
``Assign``, ``Orthogonal``, ``Dirac`` and ``calculate_gain``. Each is a
callable ``(shape, dtype, device) -> tensor`` that draws from the
default generator of ``core.generator`` on ``device`` (``None`` is the
card), in float32, then rounds to ``dtype``: the same seed gives the same
values whatever the dtype. Fans follow Paddle's conventions: a 2-D
weight is a Linear's ``[in, out]``; a conv kernel ``[out, in, *k]`` has
``fan_in = in * prod(k)`` and ``fan_out = out * prod(k)``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from paddle_tpu_torch.core import generator as _gen
from paddle_tpu_torch.core.dtype import convert_dtype
from paddle_tpu_torch.device import resolve_device

__all__ = [
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "calculate_gain", "Orthogonal", "Dirac",
]


def calculate_gain(nonlinearity: str, param=None) -> float:
    if nonlinearity in ("sigmoid", "linear", "conv1d", "conv2d", "conv3d"):
        return 1.0
    if nonlinearity == "tanh":
        return 5.0 / 3.0
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a * a))
    if nonlinearity == "selu":
        return 3.0 / 4.0
    raise ValueError(f"unknown nonlinearity {nonlinearity!r}")


def _fans(shape):
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        # Paddle's Linear weight layout is [in, out]
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    def __call__(self, shape, dtype="float32", device=None):
        raise NotImplementedError

    @staticmethod
    def _f32(shape, device):
        """An empty float32 tensor of ``shape`` and the generator to fill
        it from."""
        dev = resolve_device(device)
        return (torch.empty(tuple(int(s) for s in shape), dtype=torch.float32,
                            device=dev), _gen.torch_generator(dev))


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype="float32", device=None):
        return torch.full(tuple(int(s) for s in shape), float(self.value),
                          dtype=convert_dtype(dtype),
                          device=resolve_device(device))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32", device=None):
        t, g = self._f32(shape, device)
        return t.normal_(self.mean, self.std, generator=g).to(
            convert_dtype(dtype))


class TruncatedNormal(Initializer):
    """Normal cut at two standard deviations, by the inverse CDF of a
    uniform draw between the cut's probabilities."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32", device=None):
        t, g = self._f32(shape, device)
        lo, hi = (0.5 * (1 + math.erf(c / math.sqrt(2))) for c in (-2, 2))
        t.uniform_(2 * lo - 1, 2 * hi - 1, generator=g)
        t = torch.erfinv(t).mul_(math.sqrt(2)).clamp_(-2.0, 2.0)
        return (t * self.std + self.mean).to(convert_dtype(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype="float32", device=None):
        t, g = self._f32(shape, device)
        return t.uniform_(self.low, self.high, generator=g).to(
            convert_dtype(dtype))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32", device=None):
        fi, fo = _fans(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)(shape, dtype, device)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def limit(self, shape):
        """The bound of the uniform draw for a weight of ``shape``."""
        fi, fo = _fans(shape)
        return self.gain * math.sqrt(
            6.0 / ((self.fan_in or fi) + (self.fan_out or fo)))

    def __call__(self, shape, dtype="float32", device=None):
        limit = self.limit(shape)
        return Uniform(-limit, limit)(shape, dtype, device)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype="float32", device=None):
        fi, _ = _fans(shape)
        fi = self.fan_in or fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        return Normal(0.0, gain / math.sqrt(fi))(shape, dtype, device)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype="float32", device=None):
        fi, _ = _fans(shape)
        fi = self.fan_in or fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)(shape, dtype, device)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype="float32", device=None):
        v = self.value
        t = v.detach().clone() if isinstance(v, torch.Tensor) else \
            torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
        t = t.to(device=resolve_device(device), dtype=convert_dtype(dtype))
        if tuple(t.shape) != tuple(shape):
            t = t.reshape(tuple(shape))
        return t


class Orthogonal(Initializer):
    """QR of a gaussian, sign-corrected; rows (or columns) orthonormal up
    to ``gain``. A kernel flattens to ``[shape[0], prod(shape[1:])]``
    (reference ``orthogonal.py:95``)."""

    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def __call__(self, shape, dtype="float32", device=None):
        if len(shape) < 2:
            raise ValueError("Orthogonal initializer needs rank >= 2")
        rows = int(shape[0])
        cols = int(np.prod(shape[1:]))
        a = Normal()((max(rows, cols), min(rows, cols)), "float32", device)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))  # the unique decomposition
        if rows < cols:
            q = q.t()
        return (self.gain * q.reshape(tuple(shape))).to(convert_dtype(dtype))


class Dirac(Initializer):
    """Identity-preserving conv initializer: channel i's kernel is a delta
    at the spatial centre, per group."""

    def __init__(self, groups=1, name=None):
        self.groups = groups

    def __call__(self, shape, dtype="float32", device=None):
        if len(shape) < 3:
            raise ValueError("Dirac initializer needs a conv kernel "
                             "(rank >= 3: [out, in, *spatial])")
        out_ch, in_ch = shape[0], shape[1]
        if out_ch % self.groups:
            raise ValueError("out_channels must be divisible by groups")
        arr = np.zeros(tuple(shape), np.float32)
        centers = tuple(s // 2 for s in shape[2:])
        per_group = out_ch // self.groups
        for g in range(self.groups):
            for i in range(min(per_group, in_ch)):
                arr[(g * per_group + i, i) + centers] = 1.0
        return torch.from_numpy(arr).to(device=resolve_device(device),
                                        dtype=convert_dtype(dtype))
