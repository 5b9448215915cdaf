"""Normalization layers (port of ``paddle_tpu/nn/layer/norm.py``):
``LayerNorm``, ``RMSNorm``, the batch norms, ``GroupNorm``, the instance
norms, ``LocalResponseNorm`` and ``SpectralNorm``.

The batch norms keep their running statistics in the buffers ``_mean``
and ``_variance``, the reference's names, which cross the numpy bridge
beside the parameters; like every floating buffer they take the layer's
``dtype``, as the reference's ``Layer.to(dtype)`` casts them (a bfloat16
model keeps bfloat16 running statistics). ``SyncBatchNorm`` computes
plain batch norm on one process: its collective comes with the
distributed slice.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.dtype import convert_dtype
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.param_attr import ParamAttr, create_parameter

__all__ = ["LayerNorm", "RMSNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "SyncBatchNorm", "GroupNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm",
           "SpectralNorm"]


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


def _scale_and_shift(n, weight_attr, bias_attr, kw):
    """A weight of ones and a bias of zeros over ``n`` channels, either
    left out by ``False``."""
    weight = None if ParamAttr._to_attr(weight_attr) is False else \
        create_parameter([n], attr=weight_attr,
                         default_initializer=I.Constant(1.0), **kw)
    bias = None if ParamAttr._to_attr(bias_attr) is False else \
        create_parameter([n], attr=bias_attr, is_bias=True, **kw)
    return weight, bias


class _BatchNormBase(torch.nn.Module):
    """Batch norm over axis 1 (the last axis for a channel-last
    ``data_format``) with Paddle's momentum: in training the running
    buffers move by ``momentum * running + (1 - momentum) * batch``
    (biased variance); ``use_global_stats=True`` normalises with them in
    training too."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        kw = dict(device=resolve_device(device), dtype=convert_dtype(dtype))
        self.weight, self.bias = _scale_and_shift(num_features, weight_attr,
                                                  bias_attr, kw)
        self.register_buffer("_mean", torch.zeros(num_features, **kw))
        self.register_buffer("_variance", torch.ones(num_features, **kw))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}, epsilon={self._epsilon}")


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None, **kw):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name, **kw)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None, **kw):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name, **kw)


class BatchNorm(_BatchNormBase):
    """The rank-agnostic ``paddle.nn.BatchNorm``."""


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica batch norm. On one process it is plain batch norm;
    the all-reduce of the batch statistics comes with the distributed
    slice."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every batch norm in it (itself included) replaced
        by a ``SyncBatchNorm`` holding its parameters and buffers."""
        out = layer
        if isinstance(layer, _BatchNormBase) and \
                not isinstance(layer, SyncBatchNorm):
            ref = layer._mean
            out = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon,
                                data_format=layer._data_format,
                                device=ref.device, dtype=ref.dtype)
            with torch.no_grad():
                if layer.weight is not None:
                    out.weight.copy_(layer.weight)
                if layer.bias is not None:
                    out.bias.copy_(layer.bias)
                out._mean.copy_(layer._mean)
                out._variance.copy_(layer._variance)
        for name, sub in list(layer.named_children()):
            setattr(out, name, cls.convert_sync_batchnorm(sub))
        return out


class GroupNorm(torch.nn.Module):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__()
        self._num_groups = num_groups
        self._num_channels = num_channels
        self._epsilon = epsilon
        self._data_format = data_format
        kw = dict(device=resolve_device(device), dtype=convert_dtype(dtype))
        self.weight, self.bias = _scale_and_shift(num_channels, weight_attr,
                                                  bias_attr, kw)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self.weight, self.bias,
                            self._epsilon, self._data_format)

    def extra_repr(self):
        return (f"num_groups={self._num_groups}, "
                f"num_channels={self._num_channels}")


class _InstanceNormBase(torch.nn.Module):
    """Instance norm; the reference names its weight ``scale``."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__()
        self._epsilon = epsilon
        self._data_format = data_format
        kw = dict(device=resolve_device(device), dtype=convert_dtype(dtype))
        self.scale, self.bias = _scale_and_shift(num_features, weight_attr,
                                                 bias_attr, kw)

    def forward(self, x):
        return F.instance_norm(x, self.scale, self.bias, self._epsilon,
                               self._data_format)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(torch.nn.Module):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self._args = (size, alpha, beta, k)
        self._data_format = data_format

    def forward(self, x):
        size, alpha, beta, k = self._args
        return F.local_response_norm(x, size, alpha, beta, k,
                                     self._data_format)


class SpectralNorm(torch.nn.Module):
    """A weight divided by its largest singular value, estimated by
    ``power_iters`` steps of power iteration from the buffers
    ``weight_u`` and ``weight_v`` (drawn from N(0, 1) on the port's
    generator). Every forward writes the iterates back into the buffers,
    so the estimate sharpens over calls. As in the reference, the
    gradient flows through the iterates into sigma; the buffers hold them
    detached."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 name=None, dtype="float32", *, device=None):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._epsilon = epsilon
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        dev = resolve_device(device)
        normal = I.Normal(0.0, 1.0)
        self.register_buffer("weight_u", normal([h], dtype, dev))
        self.register_buffer("weight_v", normal([w], dtype, dev))

    def forward(self, weight):
        mat = weight.movedim(self._dim, 0)
        mat = mat.reshape(mat.shape[0], -1)
        # the product reads the vectors the buffers held before this call
        u, v = self.weight_u.clone(), self.weight_v.clone()
        for _ in range(self._power_iters):
            v = mat.T @ u
            v = v / (torch.linalg.vector_norm(v) + self._epsilon)
            u = mat @ v
            u = u / (torch.linalg.vector_norm(u) + self._epsilon)
        sigma = u @ mat @ v
        with torch.no_grad():
            self.weight_u.copy_(u)
            self.weight_v.copy_(v)
        return weight / sigma
