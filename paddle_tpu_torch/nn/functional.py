"""Functional ops of the port (port of the matching functions in
``paddle_tpu/nn/functional.py``): activations, linear and embedding,
dropout, the norms, convolution, pooling, attention and the losses.

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
    "log_sigmoid", "thresholded_relu",
    # common
    "linear", "embedding", "dropout",
    # norms
    "layer_norm", "rms_norm", "batch_norm", "instance_norm", "group_norm",
    "local_response_norm",
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
    "smooth_l1_loss", "kl_div", "ctc_loss",
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
    PyTorch's pools refuse, raises."""
    ks = _ntuple(kernel_size, nd)
    st = _ntuple(stride if stride is not None else kernel_size, nd)
    pd = _ntuple(padding, nd)
    if any(p > k // 2 for p, k in zip(pd, ks)):
        raise NotImplementedError(
            f"pooling padding {pd} over half the window {ks} is not "
            f"ported to paddle_tpu_torch")
    channel_last = data_format in _CHANNEL_LAST
    if channel_last:
        x = x.movedim(-1, 1)
    if mode == "max":
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


_MAX_POOL = {1: _tf.max_pool1d, 2: _tf.max_pool2d, 3: _tf.max_pool3d}
_AVG_POOL = {2: _tf.avg_pool2d, 3: _tf.avg_pool3d}


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
