"""``Linear``, ``Embedding``, ``Identity``, ``Dropout`` and ``Flatten``
(port of ``paddle_tpu/nn/layer/common.py``).

``Linear`` keeps Paddle's ``[in_features, out_features]`` weight layout
(the reference stores W untransposed, unlike ``torch.nn.Linear``), so a
state dict moves between the packages under the same names with no
transposes. Parameters start from Paddle's defaults (a Linear weight
Xavier-uniform, a bias zero, an Embedding table standard normal) or from
the initializer in ``weight_attr``/``bias_attr``, drawn from
``core.generator``; ``bias_attr=False`` builds no bias. Every layer
takes ``device`` (``None`` is the card) and ``dtype``.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.dtype import convert_dtype
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.param_attr import ParamAttr, create_parameter

__all__ = ["Linear", "Embedding", "Identity", "Dropout", "Flatten"]


class Identity(torch.nn.Module):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Linear(torch.nn.Module):
    """``y = x @ W + b`` with ``W`` of shape ``[in_features,
    out_features]``; ``bias_attr=False`` leaves out ``b``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=convert_dtype(dtype))
        self.weight = create_parameter([in_features, out_features],
                                       attr=weight_attr, **kw)
        self.bias = None if ParamAttr._to_attr(bias_attr) is False else \
            create_parameter([out_features], attr=bias_attr, is_bias=True,
                             **kw)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.weight.shape[0]}, " \
            f"out_features={self.weight.shape[1]}, " \
            f"bias={self.bias is not None}"


class Embedding(torch.nn.Module):
    """Token lookup over a ``[num_embeddings, embedding_dim]`` table; the
    row of ``padding_idx`` starts at 0 and reads as 0."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        if sparse:
            raise NotImplementedError(
                "sparse embedding gradients are not ported to "
                "paddle_tpu_torch")
        if padding_idx is not None and padding_idx < 0:
            padding_idx += num_embeddings
        self._padding_idx = padding_idx
        self.weight = create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(), device=resolve_device(device),
            dtype=convert_dtype(dtype))
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0

    def forward(self, ids):
        return F.embedding(ids, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self.weight.shape[0]}, {self.weight.shape[1]}"


class Flatten(torch.nn.Module):
    """Merge the axes ``start_axis..stop_axis`` into one."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self._start_axis = start_axis
        self._stop_axis = stop_axis

    def forward(self, x):
        return torch.flatten(x, self._start_axis, self._stop_axis)


class Dropout(torch.nn.Module):
    """``F.dropout`` in training mode, per ``mode`` at inference."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self._p, self._axis, self._mode = p, axis, mode

    def forward(self, x):
        return F.dropout(x, self._p, axis=self._axis, training=self.training,
                         mode=self._mode)

    def extra_repr(self):
        return f"p={self._p}, mode={self._mode}"
