"""``LayerNorm`` and ``RMSNorm`` (port of ``paddle_tpu/nn/layer/norm.py``,
:25 and :51)."""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.dtype import convert_dtype
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.param_attr import ParamAttr, create_parameter

__all__ = ["LayerNorm", "RMSNorm"]


class LayerNorm(torch.nn.Module):
    """LayerNorm over the trailing ``normalized_shape``, with a scale that
    starts at ones and a bias at zeros; ``weight_attr=False`` /
    ``bias_attr=False`` leave either out (DiT's norms have neither)."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        kw = dict(device=resolve_device(device), dtype=convert_dtype(dtype))
        self.weight = None if ParamAttr._to_attr(weight_attr) is False else \
            create_parameter(self._normalized_shape, attr=weight_attr,
                             default_initializer=I.Constant(1.0), **kw)
        self.bias = None if ParamAttr._to_attr(bias_attr) is False else \
            create_parameter(self._normalized_shape, attr=bias_attr,
                             is_bias=True, **kw)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class RMSNorm(torch.nn.Module):
    """Root-mean-square norm with a learned scale that starts at ones."""

    def __init__(self, hidden_size, epsilon=1e-6, *, device,
                 dtype=torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.weight = torch.nn.Parameter(torch.ones(
            hidden_size, device=device, dtype=dtype))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)
