"""The long tail of ``nn.functional`` (port of
``paddle_tpu/nn/functional_extras.py``): ``pad`` and ``zeropad2d``,
``diag_embed``, ``gumbel_softmax``, ``affine_grid`` and
``grid_sample``, six losses, and ``max_pool2d_with_index`` /
``max_unpool2d``. ``nn.functional`` re-exports them, as the reference's
does. The reference computes each with ``jnp``; the port with PyTorch,
``grid_sample`` on ``torch.nn.functional.grid_sample`` (the reference's
arithmetic for its two padding modes and two sampling modes)."""
from __future__ import annotations

import math

import torch

from paddle_tpu_torch.core import generator as _gen
from paddle_tpu_torch.nn.functional import _ntuple, _reduce

__all__ = [
    "pad", "zeropad2d", "diag_embed", "gumbel_softmax", "grid_sample",
    "affine_grid", "poisson_nll_loss", "multi_label_soft_margin_loss",
    "sigmoid_focal_loss", "dice_loss", "npair_loss", "gaussian_nll_loss",
    "max_pool2d_with_index", "max_unpool2d",
]

_tf = torch.nn.functional


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """Reference :24: ``ops.manipulation.pad`` (Paddle's spatial list, or
    a ``[lo, hi]`` pair for every axis)."""
    if mode not in ("constant", "reflect", "replicate", "circular"):
        raise ValueError(f"unknown pad mode '{mode}'")
    from paddle_tpu_torch.ops import manipulation as _m
    return _m.pad(x, pad, mode=mode, value=value, data_format=data_format)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    """Reference :35: zeros by ``[left, right, top, bottom]``."""
    if isinstance(padding, int):
        padding = [padding] * 4
    return pad(x, list(padding), mode="constant", value=0.0,
               data_format=data_format)


def diag_embed(input, offset=0, dim1=-2, dim2=-1):
    """Reference :43: the last axis laid on the ``offset`` diagonal of two
    new axes placed at ``dim1`` (rows) and ``dim2`` (columns)."""
    return torch.diag_embed(input, offset, dim1, dim2)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """Reference :70: ``softmax((x + g) / temperature)`` with ``g`` Gumbel
    noise from the default generator (``-log(-log(u))``, ``u`` uniform
    above the smallest normal float, as ``jax.random.gumbel``); ``hard``
    gives the one-hot of the argmax with the soft sample's gradient
    (straight through)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(x.shape, dtype=torch.float32, device=x.device,
                   generator=_gen.torch_generator(x.device))
    g = -torch.log(-torch.log(torch.clamp(u, min=tiny))).to(x.dtype)
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        onehot = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = onehot + y - y.detach()
    return y


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """Reference :90: ``theta`` ``[N, 2, 3]`` applied to the ``[H, W]``
    grid of ``out_shape`` ``[N, C, H, W]`` in ``[-1, 1]`` coordinates
    (pixel centres when not ``align_corners``) -> ``[N, H, W, 2]``."""
    _, _, h, w = [int(s) for s in out_shape]
    kw = dict(dtype=theta.dtype, device=theta.device)
    if align_corners:
        ys, xs = torch.linspace(-1, 1, h, **kw), torch.linspace(-1, 1, w, **kw)
    else:
        ys = (torch.arange(h, **kw) * 2 + 1) / h - 1
        xs = (torch.arange(w, **kw) * 2 + 1) / w - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # [H, W, 3]
    return torch.einsum("nij,hwj->nhwi", theta, base)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Reference :109: NCHW ``x`` sampled at ``grid`` ``[N, H', W', 2]``
    (x, y in ``[-1, 1]``). ``bilinear`` blends the four neighbours,
    ``nearest`` takes the one at the coordinates rounded half to even;
    ``zeros`` reads 0 outside the input, ``border`` the nearest edge
    pixel. Those are ``torch.nn.functional.grid_sample``'s rules too."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"unknown mode '{mode}'")
    if padding_mode not in ("zeros", "border"):
        raise NotImplementedError(
            f"padding_mode '{padding_mode}' not supported (zeros/border)")
    return _tf.grid_sample(x, grid.to(x.dtype), mode=mode,
                           padding_mode=padding_mode,
                           align_corners=align_corners)


# ------------------------------------------------------------------ losses
def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean", name=None):
    """Reference :169: ``exp(x) - y x`` of a log rate, else ``x - y
    log(x + epsilon)``; ``full`` adds Stirling's term where ``y > 1``."""
    if log_input:
        loss = torch.exp(input) - label * input
    else:
        loss = input - label * torch.log(input + epsilon)
    if full:
        stirling = label * torch.log(label) - label + \
            0.5 * torch.log(2 * math.pi * label)
        loss = loss + torch.where(label > 1, stirling,
                                  torch.zeros_like(stirling))
    return _reduce(loss, reduction)


def multi_label_soft_margin_loss(input, label, weight=None, reduction="mean",
                                 name=None):
    """Reference :185: the mean over the last axis of the per-class
    logistic losses (scaled by ``weight``), then ``reduction``."""
    loss = -(label * _tf.logsigmoid(input)
             + (1 - label) * _tf.logsigmoid(-input))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss.mean(dim=-1), reduction)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    """Reference :198: RetinaNet's focal loss, ``ce * (1 - p_t)^gamma``
    weighted by ``alpha`` (when ``alpha >= 0``) and divided by
    ``normalizer``."""
    p = torch.sigmoid(logit)
    ce = -(label * _tf.logsigmoid(logit)
           + (1 - label) * _tf.logsigmoid(-logit))
    p_t = p * label + (1 - p) * (1 - label)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        loss = (alpha * label + (1 - alpha) * (1 - label)) * loss
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def dice_loss(input, label, epsilon=1e-5, name=None):
    """Reference :218: ``input`` ``[N, ..., C]`` probabilities against
    ``label`` ``[N, ..., 1]`` class ids; the mean over samples of ``1 -
    (2 |x ∩ y| + eps) / (|x| + |y| + eps)``."""
    onehot = _tf.one_hot(label.squeeze(-1).long(), input.shape[-1]).to(
        input.dtype)
    red = tuple(range(1, input.dim()))
    inter = torch.sum(input * onehot, dim=red)
    union = torch.sum(input, dim=red) + torch.sum(onehot, dim=red)
    return torch.mean(1 - (2 * inter + epsilon) / (union + epsilon))


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    """Reference :231: the cross entropy of ``anchor @ positiveᵀ`` against
    the rows' same-label distribution, plus ``l2_reg`` times a quarter of
    the two mean squared norms."""
    reg = l2_reg * (torch.mean(torch.sum(anchor * anchor, -1))
                    + torch.mean(torch.sum(positive * positive, -1))) / 4
    sim = anchor @ positive.T
    same = (labels[:, None] == labels[None, :]).to(anchor.dtype)
    tgt = same / torch.sum(same, -1, keepdim=True)
    ce = -torch.sum(tgt * torch.log_softmax(sim, -1), -1)
    return torch.mean(ce) + reg


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    """Reference :245: ``0.5 (log v + (y - mu)² / v)`` with ``v`` the
    variance floored at ``epsilon``; ``full`` adds ``0.5 log 2π``."""
    v = torch.clamp(variance, min=epsilon)
    loss = 0.5 * (torch.log(v) + (label - input) ** 2 / v)
    if full:
        loss = loss + 0.5 * math.log(2 * math.pi)
    return _reduce(loss, reduction)


# ------------------------------------------------------------- max unpool
def max_pool2d_with_index(x, kernel_size, stride=None, padding=0, name=None):
    """Reference ``functional_extras.py:259``: NCHW max pool (floor mode)
    returning ``(out, indices)``, each index the flat ``h * W + w``
    position of its window's maximum in the input's channel plane."""
    ks = _ntuple(kernel_size, 2)
    st = _ntuple(stride if stride is not None else kernel_size, 2)
    return _tf.max_pool2d(x, ks, st, _ntuple(padding, 2),
                          return_indices=True)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCHW", name=None):
    """Reference ``functional_extras.py:301``: scatter the pooled values
    back to the flat positions in ``indices``, zeros elsewhere; the output
    is ``(o - 1) * stride + kernel - 2 * padding`` a side unless
    ``output_size`` says otherwise."""
    if data_format != "NCHW":
        raise NotImplementedError("max_unpool2d supports NCHW only")
    ks = _ntuple(kernel_size, 2)
    st = _ntuple(stride if stride is not None else kernel_size, 2)
    size = None if output_size is None else list(output_size)[-2:]
    return _tf.max_unpool2d(x, indices.long(), ks, st, _ntuple(padding, 2),
                            output_size=size)
