"""Functional ops of the serving and training paths (port of the
matching functions in ``paddle_tpu/nn/functional.py``)."""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.ops.pallas.flash_attention import flash_attention_bshd

__all__ = ["linear", "embedding", "rms_norm", "silu",
           "scaled_dot_product_attention", "flash_attention",
           "cross_entropy"]


def linear(x, weight):
    """``x @ W`` with Paddle's ``[in, out]`` weight layout. The product
    goes to ``torch.matmul``, as the JAX package leaves it to XLA."""
    return torch.matmul(x, weight)


def embedding(ids, weight):
    """Row lookup ``weight[ids]``."""
    return weight[ids.long()]


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


def silu(x):
    """``x * sigmoid(x)``."""
    return torch.nn.functional.silu(x)


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
    broadcastable to ``[B, H, Sq, Sk]`` is an additive constant. Dropout
    draws its hash seed from PyTorch's default generator; the pattern is
    the kernels' position hash, not the reference's."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError(
            "q_segment_ids and kv_segment_ids must be passed together; for "
            "pure key padding use all-ones q_segment_ids")
    if attn_mask is not None and getattr(attn_mask, "requires_grad", False):
        raise NotImplementedError(
            "a trainable attn_mask (the reference's differentiable "
            "composite route) is not ported to paddle_tpu_torch yet")
    drop = float(dropout_p) if training else 0.0
    seed = None
    if drop > 0.0:
        seed = int(torch.randint(-2**31, 2**31 - 1, (1,)))
    bias = None if attn_mask is None else _additive_mask(attn_mask)
    return flash_attention_bshd(query, key, value, causal=is_causal,
                                bias=bias, q_segment_ids=q_segment_ids,
                                kv_segment_ids=kv_segment_ids,
                                dropout_p=drop, dropout_seed=seed)


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
def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Hard-label cross entropy over the last axis (reference :1068).
    Labels equal to ``ignore_index`` give zero loss; ``mean`` divides the
    f32 sum by the count of the other labels. The reference's other
    options are not ported yet and raise."""
    if weight is not None or soft_label or not use_softmax or \
            label_smoothing or axis not in (-1, input.dim() - 1):
        raise NotImplementedError(
            "cross_entropy takes hard labels over the last axis in "
            "paddle_tpu_torch; weight, soft_label, use_softmax=False, "
            "label_smoothing and other axes are not ported yet")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction {reduction!r} (want mean|sum|none)")
    lp = torch.log_softmax(input, dim=-1)
    lbl = label.long()
    if lbl.dim() == lp.dim():
        lbl = lbl.squeeze(-1)
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    picked = torch.gather(lp, -1, safe[..., None])[..., 0]
    loss = -torch.where(valid, picked, torch.zeros_like(picked))
    if reduction == "mean":
        denom = torch.clamp(valid.sum(dtype=torch.float32), min=1.0)
        return (loss.sum(dtype=torch.float32) / denom).to(loss.dtype)
    if reduction == "sum":
        return loss.sum()
    return loss
