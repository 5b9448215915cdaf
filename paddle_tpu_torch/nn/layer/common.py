"""The common layers (port of ``paddle_tpu/nn/layer/common.py``):
``Linear``, ``Embedding``, ``Identity``, ``Flatten``, the dropouts, the
upsampling, padding, distance, fold and shuffle wrappers, ``Bilinear``
and ``LabelSmooth``.

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
from paddle_tpu_torch.nn.layer_base import Layer

__all__ = [
    "Linear", "Embedding", "Identity", "Flatten", "Dropout", "Dropout2D",
    "Dropout3D", "AlphaDropout", "Upsample", "UpsamplingNearest2D",
    "UpsamplingBilinear2D", "Pad1D", "Pad2D", "Pad3D", "ZeroPad2D",
    "Bilinear", "CosineSimilarity", "PairwiseDistance", "Unfold", "Fold",
    "PixelShuffle", "PixelUnshuffle", "ChannelShuffle", "LabelSmooth",
]


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Linear(Layer):
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


class Embedding(Layer):
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


class Flatten(Layer):
    """Merge the axes ``start_axis..stop_axis`` into one."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self._start_axis = start_axis
        self._stop_axis = stop_axis

    def forward(self, x):
        return torch.flatten(x, self._start_axis, self._stop_axis)


class Dropout(Layer):
    """``F.dropout`` in training mode, per ``mode`` at inference."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self._p, self._axis, self._mode = p, axis, mode

    def forward(self, x):
        return F.dropout(x, self._p, axis=self._axis, training=self.training,
                         mode=self._mode)

    def extra_repr(self):
        return f"p={self._p}, mode={self._mode}"


class Dropout2D(Layer):
    """``F.dropout2d``: whole channels dropped in training."""

    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self._p, self._data_format = p, data_format

    def forward(self, x):
        return F.dropout2d(x, self._p, training=self.training,
                           data_format=self._data_format)


class Dropout3D(Layer):
    """``F.dropout3d``: whole channels dropped in training."""

    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self._p, self._data_format = p, data_format

    def forward(self, x):
        return F.dropout3d(x, self._p, training=self.training,
                           data_format=self._data_format)


class AlphaDropout(Layer):
    """``F.alpha_dropout`` in training, the identity otherwise."""

    def __init__(self, p=0.5, name=None):
        super().__init__()
        self._p = p

    def forward(self, x):
        return F.alpha_dropout(x, self._p, training=self.training)


def _half_pixel_only(align_corners, what):
    if align_corners:
        raise NotImplementedError(
            f"{what} with align_corners=True: the reference's interpolate "
            f"never reads align_corners and always samples at half-pixel "
            f"centres")


class Upsample(Layer):
    """``F.interpolate`` with fixed arguments. ``align_mode=1`` raises, as
    in the reference (:143-146); so does ``align_corners=True``, which
    the reference's ``interpolate`` never reads."""

    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        if align_mode not in (0, None):
            raise NotImplementedError(
                "align_mode=1 (src = dst*scale sampling) is not "
                "implemented; only the default half-pixel-center mode "
                "(align_mode=0)")
        _half_pixel_only(align_corners, "Upsample")
        self._size, self._scale_factor = size, scale_factor
        self._mode, self._data_format = mode, data_format

    def forward(self, x):
        return F.interpolate(x, size=self._size,
                             scale_factor=self._scale_factor, mode=self._mode,
                             data_format=self._data_format)


class UpsamplingNearest2D(Upsample):
    """``Upsample`` in ``nearest`` mode."""

    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest",
                         data_format=data_format)


class UpsamplingBilinear2D(Upsample):
    """The reference's is ``bilinear`` with ``align_corners=True``
    (:183), which its ``interpolate`` ignores: it raises at
    construction."""

    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        _half_pixel_only(True, "UpsamplingBilinear2D")


class _PadNd(Layer):
    _nd = 2

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format=None, name=None):
        super().__init__()
        if isinstance(padding, int):
            padding = [padding] * (2 * self._nd)
        self._padding = list(padding)
        self._mode = mode
        self._value = value
        self._data_format = data_format or \
            {1: "NCL", 2: "NCHW", 3: "NCDHW"}[self._nd]

    def forward(self, x):
        return F.pad(x, self._padding, mode=self._mode, value=self._value,
                     data_format=self._data_format)

    def extra_repr(self):
        return f"padding={self._padding}, mode={self._mode}"


class Pad1D(_PadNd):
    """``F.pad`` of the last axis by ``[left, right]``."""
    _nd = 1


class Pad2D(_PadNd):
    """``F.pad`` by ``[left, right, top, bottom]``."""
    _nd = 2


class Pad3D(_PadNd):
    """``F.pad`` by ``[left, right, top, bottom, front, back]``."""
    _nd = 3


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, mode="constant", value=0.0,
                         data_format=data_format)


class Bilinear(Layer):
    """``F.bilinear`` over a ``[out, in1, in2]`` weight (Xavier-uniform by
    default) and a ``[1, out]`` bias (zeros)."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=convert_dtype(dtype))
        self.weight = create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr,
            **kw)
        self.bias = None if ParamAttr._to_attr(bias_attr) is False else \
            create_parameter([1, out_features], attr=bias_attr, is_bias=True,
                             **kw)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self._axis, self._eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self._axis, eps=self._eps)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self._p, self._epsilon, self._keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self._p, self._epsilon,
                                   self._keepdim)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self._args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self._args)


class Fold(Layer):
    """``F.fold``; ``dilations`` other than 1 raise at construction (the
    reference never reads them)."""

    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        if any(d != 1 for d in F._ntuple(dilations, 2)):
            raise NotImplementedError(
                "Fold(dilations != 1): the reference never reads dilations")
        self._args = (output_sizes, kernel_sizes, strides, paddings)

    def forward(self, x):
        return F.fold(x, *self._args)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        F._channels_first(data_format, "PixelShuffle")
        self._factor = upscale_factor

    def forward(self, x):
        return F.pixel_shuffle(x, self._factor)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        F._channels_first(data_format, "PixelUnshuffle")
        self._factor = downscale_factor

    def forward(self, x):
        return F.pixel_unshuffle(x, self._factor)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        F._channels_first(data_format, "ChannelShuffle")
        self._groups = groups

    def forward(self, x):
        return F.channel_shuffle(x, self._groups)


class LabelSmooth(Layer):
    def __init__(self, epsilon=0.1, name=None):
        super().__init__()
        self._epsilon = epsilon

    def forward(self, label):
        return F.label_smooth(label, epsilon=self._epsilon)
