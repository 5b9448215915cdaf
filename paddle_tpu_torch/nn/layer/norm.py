"""``RMSNorm`` (port of ``paddle_tpu/nn/layer/norm.py:51``)."""
from __future__ import annotations

import torch

from paddle_tpu_torch.nn import functional as F

__all__ = ["RMSNorm"]


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
