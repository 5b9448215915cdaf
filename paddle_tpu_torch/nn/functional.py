"""Functional ops of the serving path (port of the matching functions in
``paddle_tpu/nn/functional.py``)."""
from __future__ import annotations

import torch

__all__ = ["linear", "embedding", "rms_norm", "silu"]


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
