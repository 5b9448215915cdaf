"""Functional ops of the port (port of ``paddle_tpu/nn/functional.py``):
activations, linear and embedding, dropout, the small maps, the resize
and shuffle family, the norms, convolution, pooling, attention and the
losses.

Randomness (dropout, ``rrelu``, the flash kernels' dropout seed) draws
from ``core.generator``'s default generator, never from PyTorch's global
one, so ``paddle_tpu_torch.seed(n)`` makes a run repeat. Convolution
goes to ``torch.nn.functional.conv*``, as the reference leaves it to
``lax.conv_general_dilated`` outside any Pallas kernel, and so do the
batch, instance and group norms, pooling and CTC (the reference computes
them with XLA reductions, ``reduce_window`` and a ``lax.scan``);
attention goes to the flash-attention kernels. Every public function
also takes Paddle ``Tensor``s from user code and gives them back
(``_facade_boundary``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from paddle_tpu_torch.core import generator as _gen
from paddle_tpu_torch.ops.pallas.flash_attention import flash_attention_bshd

__all__ = [
    # activations
    "relu", "relu6", "gelu", "silu", "swish", "sigmoid", "tanh", "softmax",
    "log_softmax", "leaky_relu", "elu", "selu", "celu", "hardswish",
    "hardsigmoid", "hardtanh", "hardshrink", "softshrink", "tanhshrink",
    "softplus", "softsign", "mish", "prelu", "rrelu", "glu", "maxout",
    "log_sigmoid", "thresholded_relu", "swiglu",
    # common
    "linear", "embedding", "dropout", "dropout2d", "dropout3d",
    "alpha_dropout", "one_hot", "label_smooth", "bilinear",
    "cosine_similarity", "pairwise_distance", "sequence_mask",
    "temporal_shift",
    # resize and shuffle
    "interpolate", "upsample", "pixel_shuffle", "pixel_unshuffle",
    "channel_shuffle", "unfold", "fold",
    # norms
    "layer_norm", "rms_norm", "batch_norm", "instance_norm", "group_norm",
    "local_response_norm", "normalize",
    # convolution
    "conv1d", "conv2d", "conv3d", "conv1d_transpose", "conv2d_transpose",
    "conv3d_transpose",
    # pooling
    "max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d", "avg_pool2d",
    "avg_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
    "adaptive_avg_pool3d", "adaptive_max_pool1d", "adaptive_max_pool2d",
    "adaptive_max_pool3d",
    # attention
    "scaled_dot_product_attention", "flash_attention",
    # losses
    "cross_entropy", "softmax_with_cross_entropy", "square_error_cost",
    "mse_loss", "l1_loss", "nll_loss",
    "binary_cross_entropy", "binary_cross_entropy_with_logits",
    "smooth_l1_loss", "kl_div", "ctc_loss", "margin_ranking_loss",
    "hinge_embedding_loss", "cosine_embedding_loss", "triplet_margin_loss",
    "log_loss",
]

_tf = torch.nn.functional


# =========================== activations =====================================
def relu(x):
    return torch.relu(x)


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def gelu(x, approximate=False):
    """Exact (erf) GELU, or the tanh approximation."""
    return _tf.gelu(x, approximate="tanh" if approximate else "none")


def silu(x):
    """``x * sigmoid(x)``."""
    return _tf.silu(x)


swish = silu


def sigmoid(x):
    return torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


def log_sigmoid(x):
    return _tf.logsigmoid(x)


def softsign(x):
    return x / (1 + torch.abs(x))


def mish(x):
    return x * torch.tanh(_tf.softplus(x))


def softmax(x, axis=-1, dtype=None):
    if dtype is not None:
        from paddle_tpu_torch.core.dtype import convert_dtype
        x = x.to(convert_dtype(dtype))
    return torch.softmax(x, dim=int(axis))


def log_softmax(x, axis=-1):
    return torch.log_softmax(x, dim=int(axis))


def leaky_relu(x, negative_slope=0.01):
    return torch.where(x >= 0, x, negative_slope * x)


def elu(x, alpha=1.0):
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0):
    return torch.where(x > 0, x, alpha * torch.expm1(x / alpha))


def hardswish(x):
    return x * torch.clamp(x + 3, 0, 6) / 6


def hardsigmoid(x, slope=1.0 / 6, offset=0.5):
    return torch.clamp(x * slope + offset, 0, 1)


def hardtanh(x, min=-1.0, max=1.0):
    return torch.clamp(x, min, max)


def hardshrink(x, threshold=0.5):
    return torch.where(torch.abs(x) > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def tanhshrink(x):
    return x - torch.tanh(x)


def softplus(x, beta=1.0, threshold=20.0):
    return torch.where(x * beta > threshold, x,
                       torch.log1p(torch.exp(beta * x)) / beta)


def thresholded_relu(x, threshold=1.0):
    return torch.where(x > threshold, x, torch.zeros_like(x))


def prelu(x, weight):
    """Leaky slope from ``weight``: one value, or one per channel (axis
    1)."""
    w = weight
    if w.numel() != 1:
        shape = [1] * x.dim()
        shape[1] = w.numel()
        w = w.reshape(shape)
    return torch.where(x >= 0, x, w * x)


def rrelu(x, lower=1.0 / 8, upper=1.0 / 3, training=True):
    """Randomised leaky slope in ``[lower, upper)`` while training (from
    the default generator), their mean otherwise."""
    if not training:
        return torch.where(x >= 0, x, (lower + upper) / 2 * x)
    a = torch.empty(x.shape, dtype=torch.float32, device=x.device).uniform_(
        lower, upper, generator=_gen.torch_generator(x.device)).to(x.dtype)
    return torch.where(x >= 0, x, a * x)


def glu(x, axis=-1):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def maxout(x, groups, axis=1):
    ax = axis % x.dim()
    c = x.shape[ax]
    new = tuple(x.shape[:ax]) + (c // groups, groups) + tuple(x.shape[ax + 1:])
    return torch.amax(x.reshape(new), dim=ax + 1)


def swiglu(x, y=None):
    """Reference :189: ``silu(x) * y``; with one argument, its last axis
    split in half."""
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return _tf.silu(x) * y


# =========================== common ==========================================
def linear(x, weight, bias=None):
    """``x @ W (+ b)`` with Paddle's ``[in, out]`` weight layout. The
    product goes to ``torch.matmul``, as the JAX package leaves it to
    XLA."""
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def embedding(ids, weight, padding_idx=None):
    """Row lookup ``weight[ids]``; rows of ``padding_idx`` come out 0."""
    out = weight[ids.long()]
    if padding_idx is not None:
        out = torch.where((ids == padding_idx)[..., None],
                          torch.zeros((), dtype=out.dtype, device=out.device),
                          out)
    return out


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train"):
    """Reference :228: in training, zero each element (or each slice
    along ``axis``) with probability ``p`` from the default generator and,
    in ``upscale_in_train`` mode, scale the kept ones by ``1/(1-p)``;
    at inference ``downscale_in_infer`` scales by ``1-p`` and
    ``upscale_in_train`` is the identity."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode {mode!r} (want upscale_in_train or "
                         f"downscale_in_infer)")
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout p must be in [0, 1], got {p}")
    if not training:
        if mode == "downscale_in_infer" and p > 0.0:
            return x * (1.0 - p)
        return x
    if p == 0.0:
        return x
    if p == 1.0:
        return x * 0.0
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        axes = [a % x.dim() for a in axes]
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = torch.rand(shape, dtype=torch.float32, device=x.device,
                      generator=_gen.torch_generator(x.device)) >= p
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros((), dtype=x.dtype,
                                               device=x.device))


def dropout2d(x, p=0.5, training=True, data_format="NCHW"):
    """Reference :251: whole channels dropped, one draw per (sample,
    channel); any format but ``NCHW`` is read as ``NHWC``."""
    ax = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=ax, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW"):
    """Reference :256: :func:`dropout2d` over ``NCDHW`` (else
    ``NDHWC``)."""
    ax = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=ax, training=training)


_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


def alpha_dropout(x, p=0.5, training=True):
    """Reference :261: dropped elements take SELU's negative saturation,
    then an affine map keeps the mean and variance; the draw comes from
    the default generator."""
    if not training or p == 0.0:
        return x
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    keep = torch.rand(x.shape, dtype=torch.float32, device=x.device,
                      generator=_gen.torch_generator(x.device)) >= p
    a = 1.0 / np.sqrt((1 - p) * (1 + p * alpha_p ** 2)) if p < 1 else 0.0
    b = -a * alpha_p * p
    return a * torch.where(keep, x, torch.full((), alpha_p, dtype=x.dtype,
                                               device=x.device)) + b


def one_hot(x, num_classes):
    """Reference :278: float32 one-hot rows over a new last axis."""
    return _tf.one_hot(x.long(), int(num_classes)).to(torch.float32)


def label_smooth(label, prior_dist=None, epsilon=0.1):
    """Reference :282: ``(1 - epsilon) * label`` plus ``epsilon`` times
    ``prior_dist``, or the uniform distribution over the last axis."""
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * torch.as_tensor(
            prior_dist, dtype=label.dtype, device=label.device)
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def bilinear(x1, x2, weight, bias=None):
    """Reference :293: ``out[b, o] = x1[b] @ weight[o] @ x2[b]`` (weight
    ``[out, in1, in2]``), plus ``bias``."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    """Reference :304: the dot product over ``axis`` divided by the
    product of the two norms, that product floored at ``eps``."""
    num = torch.sum(x1 * x2, dim=axis)
    den = torch.linalg.vector_norm(x1, dim=axis) * \
        torch.linalg.vector_norm(x2, dim=axis)
    return num / torch.clamp(den, min=eps)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False):
    """Reference :312: the ``p``-norm of ``x - y + epsilon`` over the last
    axis."""
    return torch.linalg.vector_norm(x - y + epsilon, ord=p, dim=-1,
                                    keepdim=keepdim)


def sequence_mask(lengths, maxlen=None, dtype="int64"):
    """Reference :326: ``mask[..., j] = j < lengths[...]`` over
    ``maxlen`` columns (the largest length when None), in ``dtype``."""
    from paddle_tpu_torch.core.dtype import convert_dtype
    m = int(maxlen) if maxlen is not None else int(lengths.max())
    rng = torch.arange(m, device=lengths.device)
    return (rng < lengths[..., None]).to(convert_dtype(dtype))


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW"):
    """Reference :338: over ``[N, C, H, W]`` read as ``seg_num`` frames of
    ``N / seg_num`` clips, the first ``C * shift_ratio`` channels move one
    frame back and the next as many one frame forward, zeros entering."""
    if data_format != "NCHW":
        raise NotImplementedError(
            f"temporal_shift with data_format={data_format!r}: the "
            f"reference reads NCHW whatever the format")
    n, c, h, w = x.shape
    v = x.reshape(n // seg_num, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    out = torch.zeros_like(v)
    out[:, :-1, :fold] = v[:, 1:, :fold]
    out[:, 1:, fold:2 * fold] = v[:, :-1, fold:2 * fold]
    out[:, :, 2 * fold:] = v[:, :, 2 * fold:]
    return out.reshape(n, c, h, w)


# =========================== norms ===========================================
def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the trailing ``normalized_shape`` axes: (biased)
    mean and variance, ``rsqrt``, then the weight and bias. One fused
    PyTorch operation (the reference's composite is one XLA fusion), which
    keeps its statistics in float32 for a bfloat16 input."""
    ns = [normalized_shape] if isinstance(normalized_shape, int) \
        else list(normalized_shape)
    return _tf.layer_norm(x, ns, weight, bias, epsilon)


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm exactly as the reference orders it: mean of squares in
    float32, ``rsqrt``, cast back to the input dtype, then the multiply by
    the weight in that dtype."""
    x32 = x.float()
    ms = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = (x32 * torch.rsqrt(ms + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out


_CHANNEL_LAST = ("NLC", "NHWC", "NDHWC")


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None):
    """Reference :397. In training (unless ``use_global_stats`` is True)
    normalise with the batch mean and *biased* variance over every axis
    but the channel's, and update the running buffers in place to the
    reference's rule, ``running = momentum * running + (1 - momentum) *
    batch``, with the biased variance. Otherwise normalise with the
    running buffers. Channel-last formats move the channels to axis 1 and
    back.

    ``torch.nn.functional.batch_norm`` updates with the *unbiased*
    variance and the opposite momentum, so it never sees the running
    buffers: it writes the batch statistics (momentum 1) into two fresh
    vectors of the buffers' dtype, from which the update is made."""
    channel_last = data_format in _CHANNEL_LAST and x.dim() > 2
    if channel_last:
        x = x.movedim(-1, 1)
    if not (training and use_global_stats is not True):
        out = _tf.batch_norm(x, running_mean, running_var, weight, bias,
                             False, 0.0, epsilon)
        return out.movedim(1, -1) if channel_last else out
    stats = torch.zeros((2, x.shape[1]), dtype=running_mean.dtype,
                        device=x.device)
    out = _tf.batch_norm(x, stats[0], stats[1], weight, bias, True, 1.0,
                         epsilon)
    n = x.numel() // x.shape[1]
    with torch.no_grad():
        running_mean.mul_(momentum).add_(stats[0], alpha=1.0 - momentum)
        # stats[1] holds the unbiased variance: n-1 over n makes it biased
        running_var.mul_(momentum).add_(
            stats[1], alpha=(1.0 - momentum) * (n - 1) / n)
    return out.movedim(1, -1) if channel_last else out


def _channel_first_only(data_format, what):
    if data_format in _CHANNEL_LAST:
        raise NotImplementedError(
            f"{what} with data_format={data_format!r}: the reference reads "
            f"axis 1 as the channels whatever the format, so the port "
            f"carries channels-first only")


def instance_norm(x, weight=None, bias=None, epsilon=1e-5,
                  data_format="NCHW"):
    """Reference :439: each sample's each channel normalised over its
    spatial axes with the biased variance, then the weight and bias."""
    _channel_first_only(data_format, "instance_norm")
    return _tf.instance_norm(x, weight=weight, bias=bias, eps=epsilon)


def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5,
               data_format="NCHW"):
    """Reference :461: channels split into ``num_groups`` runs, each
    normalised over its channels and the spatial axes (biased variance)."""
    _channel_first_only(data_format, "group_norm")
    return _tf.group_norm(x, num_groups, weight, bias, epsilon)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW"):
    """Reference :488: ``x / (k + alpha * s) ** beta`` with ``s`` the sum
    of squares over ``size`` neighbouring channels (``size // 2`` before,
    the rest after). Unlike ``torch.nn.functional.local_response_norm``,
    ``alpha`` scales the sum, not the mean."""
    _channel_first_only(data_format, "local_response_norm")
    half = size // 2
    sq = x * x
    pad = [0, 0] * (x.dim() - 2) + [half, size - half - 1]
    windows = _tf.pad(sq, pad).unfold(1, size, 1)
    return x / torch.pow(k + alpha * windows.sum(-1), beta)


def normalize(x, p=2, axis=1, epsilon=1e-12):
    """Reference :319: ``x`` over its ``p``-norm along ``axis``, the norm
    floored at ``epsilon``."""
    n = torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=True)
    return x / torch.clamp(n, min=epsilon)


# =========================== convolution =====================================
def _ntuple(v, n):
    if isinstance(v, (int, np.integer)):
        return (int(v),) * n
    return tuple(int(i) for i in v)


def _pad_pairs(padding, nd, spatial, k, stride, dilation, transpose):
    """Paddle's padding forms -> ``[(lo, hi)] * nd``: an int, one int per
    dimension, ``[lo0, hi0, lo1, hi1, ...]``, nested pairs, or "SAME" /
    "VALID" (SAME as ``lax``: output ``ceil(in / stride)``; for a
    transposed convolution, output ``in * stride``)."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0)] * nd
        if mode != "SAME":
            raise ValueError(f"padding {padding!r} (want SAME or VALID)")
        pairs = []
        for i in range(nd):
            eff = dilation[i] * (k[i] - 1) + 1
            if transpose:
                tot = max(eff - stride[i], 0)
            else:
                out = -(-spatial[i] // stride[i])
                tot = max((out - 1) * stride[i] + eff - spatial[i], 0)
            pairs.append((tot // 2, tot - tot // 2))
        return pairs
    if isinstance(padding, (int, np.integer)):
        return [(int(padding), int(padding))] * nd
    p = list(padding)
    if len(p) == nd and all(isinstance(v, (int, np.integer)) for v in p):
        return [(int(v), int(v)) for v in p]
    if len(p) == 2 * nd and all(isinstance(v, (int, np.integer)) for v in p):
        return [(int(p[2 * i]), int(p[2 * i + 1])) for i in range(nd)]
    if len(p) == nd:
        return [tuple(int(a) for a in v) for v in p]
    raise ValueError(f"cannot interpret padding {padding!r}")


_CONV = {1: _tf.conv1d, 2: _tf.conv2d, 3: _tf.conv3d}
_CONV_T = {1: _tf.conv_transpose1d, 2: _tf.conv_transpose2d,
           3: _tf.conv_transpose3d}


def _conv_nd(x, weight, bias, stride, padding, dilation, groups,
             data_format, nd, transpose=False, output_padding=0):
    """Paddle's convolution on ``torch.nn.functional.conv*``. The weight
    layout is Paddle's, which is PyTorch's: ``[out, in/groups, *k]``, or
    ``[in, out/groups, *k]`` when transposed. Channel-last inputs are
    moved to channels-first and back; uneven padding pads the input (or
    crops a transposed output) explicitly."""
    stride = _ntuple(stride, nd)
    dilation = _ntuple(dilation, nd)
    channel_last = data_format in ("NLC", "NHWC", "NDHWC")
    if channel_last:
        x = x.movedim(-1, 1)
    spatial = tuple(x.shape[2:])
    k = tuple(int(s) for s in weight.shape[2:])
    pairs = _pad_pairs(padding, nd, spatial, k, stride, dilation, transpose)
    even = all(lo == hi for lo, hi in pairs)
    if transpose:
        opad = _ntuple(output_padding, nd)
        out = _CONV_T[nd](x, weight, bias, stride,
                          tuple(lo for lo, _ in pairs) if even else 0,
                          opad, groups, dilation)
        if not even:  # crop the p=0 output by (lo, hi) on each side
            idx = [slice(None), slice(None)] + [
                slice(lo, out.shape[2 + i] - hi)
                for i, (lo, hi) in enumerate(pairs)]
            out = out[tuple(idx)]
    else:
        if not even:
            flat = [v for lo, hi in reversed(pairs) for v in (lo, hi)]
            x = _tf.pad(x, flat)
            pairs = [(0, 0)] * nd
        out = _CONV[nd](x, weight, bias, stride,
                        tuple(lo for lo, _ in pairs), dilation, groups)
    return out.movedim(1, -1) if channel_last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    data_format, 1)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    data_format, 2)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    data_format, 3)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCL"):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    data_format, 1, transpose=True,
                    output_padding=output_padding)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCHW"):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    data_format, 2, transpose=True,
                    output_padding=output_padding)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCDHW"):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    data_format, 3, transpose=True,
                    output_padding=output_padding)


# =========================== pooling =========================================
def _pool_nd(x, kernel_size, stride, padding, nd, mode, data_format,
             ceil_mode=False, exclusive=True):
    """Reference ``_pool_nd`` (:634) on ``torch.nn.functional``'s pools.
    ``stride=None`` is the kernel size; ``ceil_mode`` keeps a last partial
    window that starts inside the input or its leading pad (PyTorch's
    rule and the reference's). An exclusive average divides by the
    window's input elements, padding and the ceil overhang excluded; a
    non-exclusive one always by the kernel's size, the overhang included
    (``divisor_override``). Padding of more than half a window, which
    PyTorch's pools refuse, is padded explicitly
    (:func:`_pool_padded`)."""
    ks = _ntuple(kernel_size, nd)
    st = _ntuple(stride if stride is not None else kernel_size, nd)
    pd = _ntuple(padding, nd)
    channel_last = data_format in _CHANNEL_LAST
    if channel_last:
        x = x.movedim(-1, 1)
    if any(p > k // 2 for p, k in zip(pd, ks)):
        out = _pool_padded(x, ks, st, pd, nd, mode, ceil_mode, exclusive)
    elif mode == "max":
        out = _MAX_POOL[nd](x, ks, st, pd, ceil_mode=ceil_mode)
    elif nd == 1:  # avg_pool1d has no divisor_override: pool a 1-high 2-D
        out = _pool_nd(x[:, :, None], (1, ks[0]), (1, st[0]), (0, pd[0]), 2,
                       mode, "NCHW", ceil_mode, exclusive)[:, :, 0]
    else:
        out = _AVG_POOL[nd](x, ks, st, pd, ceil_mode=ceil_mode,
                            count_include_pad=not exclusive,
                            divisor_override=None if exclusive
                            else int(np.prod(ks)))
    return out.movedim(1, -1) if channel_last else out


def _pool_padded(x, ks, st, pd, nd, mode, ceil_mode, exclusive):
    """The reference's ``reduce_window`` over explicit pads (:642-677),
    for a padding PyTorch's pools refuse: each spatial axis padded by
    ``pd`` low and ``pd`` plus the ceil overhang high (-inf for max, 0
    for average), then pooled unpadded. An exclusive average divides by
    the count of input elements in each window (the same pool over
    ones), a non-exclusive one by the kernel's size."""
    pairs = []
    for i in range(nd):
        n = x.shape[2 + i]
        extra = 0
        if ceil_mode:
            out = -(-(n + 2 * pd[i] - ks[i]) // st[i]) + 1
            if (out - 1) * st[i] >= n + pd[i]:
                out -= 1
            extra = max((out - 1) * st[i] + ks[i] - (n + 2 * pd[i]), 0)
        pairs.append((pd[i], pd[i] + extra))
    flat = [v for lo, hi in reversed(pairs) for v in (lo, hi)]
    if mode == "max":
        return _MAX_POOL[nd](_tf.pad(x, flat, value=float("-inf")), ks, st)
    pool = _AVG_POOL[nd]
    out = pool(_tf.pad(x, flat), ks, st)
    if not exclusive:
        return out
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    return out / pool(_tf.pad(ones, flat), ks, st)


_MAX_POOL = {1: _tf.max_pool1d, 2: _tf.max_pool2d, 3: _tf.max_pool3d}
_AVG_POOL = {1: _tf.avg_pool1d, 2: _tf.avg_pool2d, 3: _tf.avg_pool3d}


def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCL"):
    return _pool_nd(x, kernel_size, stride, padding, 1, "max", data_format,
                    ceil_mode)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCHW"):
    return _pool_nd(x, kernel_size, stride, padding, 2, "max", data_format,
                    ceil_mode)


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCDHW"):
    return _pool_nd(x, kernel_size, stride, padding, 3, "max", data_format,
                    ceil_mode)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL"):
    return _pool_nd(x, kernel_size, stride, padding, 1, "avg", data_format,
                    ceil_mode, exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCHW"):
    return _pool_nd(x, kernel_size, stride, padding, 2, "avg", data_format,
                    ceil_mode, exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCDHW"):
    return _pool_nd(x, kernel_size, stride, padding, 3, "avg", data_format,
                    ceil_mode, exclusive)


_ADAPTIVE = {("avg", 1): _tf.adaptive_avg_pool1d,
             ("avg", 2): _tf.adaptive_avg_pool2d,
             ("avg", 3): _tf.adaptive_avg_pool3d,
             ("max", 1): _tf.adaptive_max_pool1d,
             ("max", 2): _tf.adaptive_max_pool2d,
             ("max", 3): _tf.adaptive_max_pool3d}


def _adaptive_pool(x, output_size, nd, mode, data_format, return_mask=False):
    """Reference :717: output bin ``i`` of an axis of length ``n`` pools
    ``[floor(i * n / o), ceil((i + 1) * n / o))``, PyTorch's bins too."""
    if return_mask:
        raise NotImplementedError(
            "return_mask=True (argmax indices) is not implemented; "
            "silently dropping it would corrupt tuple-unpacking callers")
    channel_last = data_format.endswith("C")
    if channel_last:
        x = x.movedim(-1, 1)
    out = _ADAPTIVE[(mode, nd)](x, _ntuple(output_size, nd))
    return out.movedim(1, -1) if channel_last else out


def adaptive_avg_pool1d(x, output_size, data_format="NCL"):
    return _adaptive_pool(x, output_size, 1, "avg", data_format)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    return _adaptive_pool(x, output_size, 2, "avg", data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW"):
    return _adaptive_pool(x, output_size, 3, "avg", data_format)


def adaptive_max_pool1d(x, output_size, return_mask=False, data_format="NCL"):
    return _adaptive_pool(x, output_size, 1, "max", data_format, return_mask)


def adaptive_max_pool2d(x, output_size, return_mask=False, data_format="NCHW"):
    return _adaptive_pool(x, output_size, 2, "max", data_format, return_mask)


def adaptive_max_pool3d(x, output_size, return_mask=False,
                        data_format="NCDHW"):
    return _adaptive_pool(x, output_size, 3, "max", data_format, return_mask)


# =========================== resize / shuffle ================================
_RESIZE = {"nearest": "nearest", "bilinear": "bilinear", "linear": "bilinear",
           "trilinear": "bilinear", "bicubic": "bicubic", "area": "bilinear"}


def _nearest_index(n_in, n_out, device):
    """``floor((j + 0.5) * n_in / n_out)`` in float32, as ``jax.image``'s
    nearest resize writes it, with a true division: the divisor is a
    device tensor, since a host scalar divisor becomes a multiply by its
    reciprocal on CUDA. Where a sample falls on a pixel edge exactly
    (``(2j + 1) n_in = 2k n_out``) the rounded arithmetic picks either
    side: XLA on the CPU, PyTorch's ``nearest-exact`` and this function
    each round some such points apart; elsewhere all three agree while
    ``n_in * n_out < 2**22``."""
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * n_in
    div = torch.full((), n_out, dtype=torch.float32, device=device)
    return torch.floor(pos / div).long()


def _resize_2d(x, h, w, method):
    """PyTorch's antialiased ``bilinear``/``bicubic`` of ``[N, C, H, W]``
    to ``[N, C, h, w]``: half-pixel samples, the kernel widened by the
    inverse scale when shrinking, Keys' a = -0.5, each output's weights
    normalised, which is ``jax.image``'s linear and cubic resize. An axis
    kept at its size gets the identity."""
    return _tf.interpolate(x, size=(h, w), mode=method, antialias=True,
                           align_corners=False)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, data_format="NCHW"):
    """Reference :793-815, which is ``jax.image.resize``: each spatial
    axis whose size changes is resampled, ``nearest`` by the sample
    ``floor((j + 0.5) * n_in / n_out)`` (:func:`_nearest_index`),
    ``linear`` (``bilinear``, ``trilinear`` and, as in the reference,
    ``area``) and ``bicubic`` (Keys' a = -0.5) antialiased when shrinking
    (:func:`_resize_2d`; a 3-D input as a height-1 image, a 5-D one by
    its height and width pass, then its depth pass over the flattened
    plane). ``scale_factor`` gives ``int(n * factor)`` per axis. The
    reference never reads ``align_corners``, so ``True`` raises."""
    if align_corners:
        raise NotImplementedError(
            "interpolate(align_corners=True): the reference never reads "
            "align_corners and always samples at half-pixel centres")
    if mode not in _RESIZE:
        raise ValueError(f"interpolate mode {mode!r} (want one of "
                         f"{sorted(_RESIZE)})")
    channel_last = data_format.endswith("C")
    axes = list(range(1, x.dim() - 1)) if channel_last \
        else list(range(2, x.dim()))
    if size is not None:
        out_sizes = _ntuple(size, len(axes))
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else [scale_factor] * len(axes)
        out_sizes = [int(x.shape[a] * f) for a, f in zip(axes, sf)]
    method = _RESIZE[mode]
    out = x
    if method == "nearest":
        for a, n_out in zip(axes, out_sizes):
            if out.shape[a] != n_out:
                out = torch.index_select(
                    out, a, _nearest_index(out.shape[a], n_out, x.device))
        return out
    if [out.shape[a] for a in axes] == list(out_sizes):
        return out if out.is_floating_point() else out.float()
    out = out.float() if not out.is_floating_point() else out
    if channel_last:
        out = out.movedim(-1, 1)
    if out.dim() == 3:
        out = _resize_2d(out[:, :, None], 1, out_sizes[0], method)[:, :, 0]
    elif out.dim() == 4:
        out = _resize_2d(out, *out_sizes, method)
    else:
        n, c, d, h, w = out.shape
        d2, h2, w2 = out_sizes
        if (h, w) != (h2, w2):
            out = _resize_2d(out.reshape(n, c * d, h, w), h2, w2,
                             method).reshape(n, c, d, h2, w2)
        if d != d2:
            out = _resize_2d(out.reshape(n, c, d, h2 * w2), d2, h2 * w2,
                             method).reshape(n, c, d2, h2, w2)
    return out.movedim(1, -1) if channel_last else out


upsample = interpolate


def _channels_first(data_format, what):
    if data_format != "NCHW":
        raise NotImplementedError(
            f"{what} with data_format={data_format!r}: the reference "
            f"reads NCHW whatever the format")


def pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    """Reference :818: ``[N, C r², H, W] -> [N, C, H r, W r]``."""
    _channels_first(data_format, "pixel_shuffle")
    return _tf.pixel_shuffle(x, upscale_factor)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW"):
    """Reference :829: ``[N, C, H r, W r] -> [N, C r², H, W]``."""
    _channels_first(data_format, "pixel_unshuffle")
    return _tf.pixel_unshuffle(x, downscale_factor)


def channel_shuffle(x, groups, data_format="NCHW"):
    """Reference :840: the channels read as ``[groups, C / groups]`` and
    transposed."""
    _channels_first(data_format, "channel_shuffle")
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2).reshape(
        n, c, h, w)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """Reference :848: ``[N, C, H, W]`` -> ``[N, C kh kw, L]`` sliding
    blocks (im2col), padded by ``paddings[0]``/``[1]`` on both sides of H
    and W."""
    pd = _ntuple(paddings, 2)
    return _tf.unfold(x, _ntuple(kernel_sizes, 2), _ntuple(dilations, 2),
                      (pd[0], pd[1]), _ntuple(strides, 2))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1):
    """Reference :863: the inverse of :func:`unfold`, overlapping blocks
    summed. The reference never reads ``dilations``: other than 1 it
    raises."""
    if any(d != 1 for d in _ntuple(dilations, 2)):
        raise NotImplementedError(
            "fold(dilations != 1): the reference never reads dilations")
    pd = _ntuple(paddings, 2)
    return _tf.fold(x, _ntuple(output_sizes, 2), _ntuple(kernel_sizes, 2),
                    1, (pd[0], pd[1]), _ntuple(strides, 2))


# =========================== attention =======================================
def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, q_segment_ids=None,
                                 kv_segment_ids=None):
    """SDPA in Paddle's ``[batch, seq, heads, head_dim]`` layout
    (reference :894). ``key``/``value`` may carry fewer heads than
    ``query`` (GQA). Every call goes through the flash-attention
    wrapper: CUDA tensors launch its kernels, CPU tensors compute its
    plain version. ``attn_mask`` (float, or bool with True = attend)
    broadcastable to ``[B, H, Sq, Sk]`` is an additive constant, unless
    it is a float mask that requires grad: that one takes the
    differentiable composite (:func:`_sdpa_composite`) and receives a
    gradient, as in the reference. A mask
    from ``Transformer.generate_square_subsequent_mask`` (tagged
    ``_causal_diag``) over equal lengths takes the kernels' causal path
    instead and is never read (reference :938-941). Dropout's hash seed
    is drawn from the default generator of ``core.generator``; the pattern
    is the kernels' position hash, not the reference's."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError(
            "q_segment_ids and kv_segment_ids must be passed together; for "
            "pure key padding use all-ones q_segment_ids")
    if attn_mask is not None and attn_mask.requires_grad:
        # a learned additive bias must receive a gradient: the kernels
        # hold the mask as a constant, so it takes the reference's
        # differentiable composite (:913-936), on every device
        return _sdpa_composite(query, key, value, attn_mask, dropout_p,
                               is_causal, training, q_segment_ids,
                               kv_segment_ids)
    s_q, s_k = query.shape[1], key.shape[1]
    causal_tagged = (
        attn_mask is not None and getattr(attn_mask, "_causal_diag", False)
        and s_q == s_k and tuple(attn_mask.shape)[-2:] == (s_q, s_k))
    drop = float(dropout_p) if training else 0.0
    if drop > 0.0 and query.is_cuda and \
            torch.cuda.is_current_stream_capturing():
        # the seed is a host integer: a CUDA graph would bake one mask
        raise NotImplementedError(
            "flash attention dropout under CUDA-graph capture needs its "
            "seed on the card, which is not ported yet")
    seed = _gen.host_int() if drop > 0.0 else None
    bias = None if attn_mask is None or causal_tagged \
        else _additive_mask(attn_mask)
    return flash_attention_bshd(query, key, value,
                                causal=is_causal or causal_tagged,
                                bias=bias, q_segment_ids=q_segment_ids,
                                kv_segment_ids=kv_segment_ids,
                                dropout_p=drop, dropout_seed=seed)


def _sdpa_composite(query, key, value, attn_mask, dropout_p, is_causal,
                    training, q_segment_ids, kv_segment_ids):
    """The reference's composite (:977-1020) for a trainable float mask,
    differentiable in the mask: logits in the inputs' dtype, masked to
    the dtype's minimum, the mask added, softmax in f32, rows with no
    segment-live key zeroed. Dropout draws a Bernoulli mask from
    ``core.generator`` (a pattern of its own, as in the reference)."""
    q, k, v = (t.transpose(1, 2) for t in (query, key, value))
    if k.shape[1] != q.shape[1]:  # GQA: broadcast the kv heads
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    logits = torch.matmul(q, k.transpose(-1, -2)) / np.sqrt(q.shape[-1])
    low = torch.finfo(logits.dtype).min
    if is_causal:
        sq, sk = logits.shape[-2:]
        causal = torch.ones(sq, sk, dtype=torch.bool,
                            device=logits.device).tril(sk - sq)
        logits = logits.masked_fill(~causal, low)
    seg = None
    if q_segment_ids is not None:
        seg = (q_segment_ids[:, :, None] == kv_segment_ids[:, None, :])
        logits = logits.masked_fill(~seg[:, None], low)
    logits = logits + attn_mask
    w = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    if seg is not None:  # rows with no live key: pure padding, zero
        w = torch.where(seg[:, None].any(-1, keepdim=True), w,
                        torch.zeros((), dtype=w.dtype, device=w.device))
    if dropout_p > 0 and training:
        keep = torch.rand(w.shape, device=w.device,
                          generator=_gen.torch_generator(w.device)) \
            >= dropout_p
        w = torch.where(keep, w / (1 - dropout_p),
                        torch.zeros((), dtype=w.dtype, device=w.device))
    return torch.matmul(w, v).transpose(1, 2)


def _additive_mask(mask):
    """bool (True = attend) -> additive f32; a float mask passes raw."""
    if mask.dtype == torch.bool:
        return torch.where(mask, torch.zeros((), device=mask.device),
                           torch.full((), float(np.finfo(np.float32).min),
                                      device=mask.device))
    return mask


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    training=True, q_segment_ids=None, kv_segment_ids=None):
    """Reference :1041: flash attention in ``[B, S, H, D]`` layout with
    segment ids as the varlen form; GQA head counts pass through."""
    return scaled_dot_product_attention(
        query, key, value, None, dropout, causal, training,
        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids)


# =========================== losses ==========================================
def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"reduction {reduction!r} (want mean|sum|none)")


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Cross entropy over the class ``axis`` (reference :1060-1112).
    ``use_softmax=False`` takes probabilities (``log(max(x, 1e-30))``).
    Soft labels: ``-sum(target * log p)``, ``label_smoothing`` mixing the
    target with the uniform one; ``mean`` averages the rows. Hard labels
    equal to ``ignore_index`` give zero loss; ``label_smoothing`` mixes
    the picked log-probability with the row's mean; ``weight`` scales a
    row by its label's class weight, and ``mean`` divides the f32 sum by
    the sum of the valid rows' weights (else by their count). Where the
    reference picks hard labels along another axis than the last it
    gathers a wrong shape; the port moves the class axis last first."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction {reduction!r} (want mean|sum|none)")
    axis = axis % input.dim()
    lp = torch.log_softmax(input, dim=axis) if use_softmax \
        else torch.log(torch.clamp(input, min=1e-30))
    if soft_label:
        if weight is not None:
            raise NotImplementedError(
                "cross_entropy with soft_label=True ignores weight in the "
                "reference; the port refuses it rather than ignore it")
        tgt = label
        if label_smoothing > 0:
            tgt = (1 - label_smoothing) * tgt + \
                label_smoothing / lp.shape[axis]
        return _reduce(-(tgt * lp).sum(dim=axis), reduction)
    lp = lp.movedim(axis, -1)
    lbl = label.long()
    if lbl.dim() == input.dim():
        lbl = lbl.squeeze(axis)
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    picked = torch.gather(lp, -1, safe[..., None])[..., 0]
    if label_smoothing > 0:
        picked = (1 - label_smoothing) * picked + \
            label_smoothing * lp.mean(dim=-1)
    loss = -torch.where(valid, picked, torch.zeros_like(picked))
    if weight is not None:
        tw = weight[safe]
        loss = loss * tw
        if reduction == "mean":
            wt = torch.where(valid, tw, torch.zeros_like(tw)).sum(
                dtype=torch.float32)
            return (loss.sum(dtype=torch.float32) /
                    torch.clamp(wt, min=1e-12)).to(loss.dtype)
    if reduction == "mean":
        denom = torch.clamp(valid.sum(dtype=torch.float32), min=1.0)
        return (loss.sum(dtype=torch.float32) / denom).to(loss.dtype)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False, axis=-1,
                               ignore_index=-100, return_softmax=False):
    """Reference :1115: the unreduced :func:`cross_entropy`, and the
    softmax over ``axis`` when ``return_softmax``."""
    loss = cross_entropy(logits, label, reduction="none",
                         soft_label=soft_label, axis=axis,
                         ignore_index=ignore_index)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


def square_error_cost(input, label):
    """Reference :1135: the elementwise ``(input - label)²``."""
    return torch.square(input - label)


def mse_loss(input, label, reduction="mean"):
    return _reduce(torch.square(input - label), reduction)


def l1_loss(input, label, reduction="mean"):
    return _reduce(torch.abs(input - label), reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean"):
    """Negative log-likelihood of log-probabilities over the last axis;
    ``mean`` divides by the count (or the weight sum) of the labels not
    equal to ``ignore_index``."""
    lbl = label.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    picked = torch.gather(input, -1, safe[..., None])[..., 0]
    loss = -torch.where(valid, picked, torch.zeros_like(picked))
    if weight is not None:
        tw = weight[safe]
        loss = loss * tw
        if reduction == "mean":
            return loss.sum() / torch.clamp(
                (tw * valid.to(tw.dtype)).sum(), min=1e-12)
    if reduction == "mean":
        return loss.sum() / torch.clamp(valid.to(input.dtype).sum(), min=1.0)
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean"):
    p = torch.clamp(input, 1e-12, 1 - 1e-12)
    loss = -(label * torch.log(p) + (1 - label) * torch.log1p(-p))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    neg_abs = -torch.abs(logit)
    if pos_weight is not None:
        log_w = (pos_weight - 1) * label + 1
        loss = (1 - label) * logit + log_w * (
            torch.log1p(torch.exp(neg_abs)) + torch.clamp(-logit, min=0))
    else:
        loss = torch.clamp(logit, min=0) - logit * label + \
            torch.log1p(torch.exp(neg_abs))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    d = torch.abs(input - label)
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean"):
    """KL divergence of log-probabilities ``input`` from ``label``;
    ``batchmean`` divides the sum by the batch size."""
    loss = label * (torch.log(torch.clamp(label, min=1e-30)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean"):
    """Reference :1216: ``max(-label * (input - other) + margin, 0)``."""
    return _reduce(torch.clamp(-label * (input - other) + margin, min=0.0),
                   reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean"):
    """Reference :1222: ``input`` where ``label == 1``, else ``max(margin
    - input, 0)``."""
    return _reduce(torch.where(label == 1, input,
                               torch.clamp(margin - input, min=0.0)),
                   reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean"):
    """Reference :1229: ``1 - cos`` where ``label == 1``, else ``max(cos -
    margin, 0)``; cos over the last axis, its norm product floored at
    1e-12."""
    cos = torch.sum(input1 * input2, -1) / torch.clamp(
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1), min=1e-12)
    return _reduce(torch.where(label == 1, 1 - cos,
                               torch.clamp(cos - margin, min=0.0)),
                   reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean"):
    """Reference :1240: ``max(d(a, pos) - d(a, neg) + margin, 0)`` with
    ``d`` the ``p``-norm of ``u - v + epsilon``; ``swap`` takes the
    smaller of ``d(a, neg)`` and ``d(pos, neg)``."""
    def dist(u, v):
        return torch.linalg.vector_norm(u - v + epsilon, ord=p, dim=-1)
    dn = dist(input, negative)
    if swap:
        dn = torch.minimum(dn, dist(positive, negative))
    return _reduce(torch.clamp(dist(input, positive) - dn + margin, min=0.0),
                   reduction)


def log_loss(input, label, epsilon=1e-4):
    """Reference :1254: the unreduced binary log loss of probabilities,
    ``epsilon`` inside each log."""
    return -label * torch.log(input + epsilon) - \
        (1 - label) * torch.log(1 - input + epsilon)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean"):
    """Reference :1260: the CTC loss of ``log_probs`` ``[T, B, C]``
    against ``labels`` ``[B, L]`` (padded; each row's first
    ``label_lengths[b]`` count), over each sample's own first
    ``input_lengths[b]`` frames, on ``torch.nn.functional.ctc_loss``.
    ``mean`` is the plain mean over the batch, as the reference's
    ``_reduce`` (PyTorch's own ``mean`` first divides each loss by its
    label length), so PyTorch is asked for ``none``.

    Two deliberate divergences from the reference. The loss is computed
    in float32 and cast back to the input's dtype (PyTorch's CUDA CTC
    takes no bfloat16; the reference computes in the input's dtype). A
    sample whose labels no alignment of its frames can emit gets an
    infinite loss (PyTorch's value), where the reference floors its
    log-space sums at -1e30 and gives a loss near 1e30."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction {reduction!r} (want mean|sum|none)")
    lp = log_probs.float()
    in_len = input_lengths.long()
    loss = _tf.ctc_loss(lp, labels.long(), in_len, label_lengths.long(),
                        blank=blank, reduction="none")
    if lp.requires_grad:
        # PyTorch's gradient with respect to log_probs is exp(lp) minus
        # the alignment posterior (what the logits under a log_softmax
        # receive); the reference's is minus the posterior. A term of
        # value 0 whose gradient is exp(lp) over each sample's frames
        # takes the difference off.
        live = torch.arange(lp.shape[0], device=lp.device)[:, None] < \
            in_len.to(lp.device)[None, :]
        s = (lp.exp() * live[..., None]).sum((0, 2))
        loss = loss - (s - s.detach())
    return _reduce(loss, reduction).to(log_probs.dtype)


from paddle_tpu_torch.nn import functional_extras as _fx  # noqa: E402
from paddle_tpu_torch.nn.functional_extras import *  # noqa: F401,F403,E402
__all__ = list(__all__) + list(_fx.__all__)


def _facade_boundary(fn, name):
    """``fn`` as the user API: called from outside a port layer's
    ``forward`` with Paddle ``Tensor`` arguments, it computes on their
    plain aliases and returns ``Tensor``s (``core/tensor.py``); inside a
    port forward (plain tensors only) it is ``fn`` behind one
    thread-local read. Under an ``amp.auto_cast`` policy either way
    casts its floating inputs by ``name``, the reference's op name."""
    from paddle_tpu_torch.amp.auto_cast import _open as amp_open
    from paddle_tpu_torch.amp.auto_cast import cast_inputs
    from paddle_tpu_torch.core.tensor import unwrap_args, wrap
    from paddle_tpu_torch.nn.layer_base import _state

    @functools.wraps(fn)
    def call(*args, **kwargs):
        if _state.in_port:
            if amp_open[0]:
                args, kwargs = cast_inputs(name, args, kwargs)
            return fn(*args, **kwargs)
        args, kwargs, had = unwrap_args(args, kwargs)
        if amp_open[0]:
            args, kwargs = cast_inputs(name, args, kwargs)
        out = fn(*args, **kwargs)
        return wrap(out) if had else out
    return call


for _name in __all__:
    globals()[_name] = _facade_boundary(globals()[_name], _name)
