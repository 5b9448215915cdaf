"""``Linear`` and ``Embedding`` (port of ``paddle_tpu/nn/layer/common.py``).

``Linear`` keeps Paddle's ``[in_features, out_features]`` weight layout
(the reference stores W untransposed, unlike ``torch.nn.Linear``), so a
state dict moves between the packages under the same names with no
transposes. Parameters start at zero on the given device: their values
come from the owning model's initialisation or from the numpy bridge.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.nn import functional as F

__all__ = ["Linear", "Embedding"]


class Linear(torch.nn.Module):
    """``y = x @ W`` with ``W`` of shape ``[in_features, out_features]``.
    Bias-free, as every projection of the ported Llama path is."""

    def __init__(self, in_features, out_features, *, device,
                 dtype=torch.float32):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.zeros(
            in_features, out_features, device=device, dtype=dtype))

    def forward(self, x):
        return F.linear(x, self.weight)

    def extra_repr(self):
        return f"in_features={self.weight.shape[0]}, " \
            f"out_features={self.weight.shape[1]}"


class Embedding(torch.nn.Module):
    """Token lookup over a ``[num_embeddings, embedding_dim]`` table."""

    def __init__(self, num_embeddings, embedding_dim, *, device,
                 dtype=torch.float32):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.zeros(
            num_embeddings, embedding_dim, device=device, dtype=dtype))

    def forward(self, ids):
        return F.embedding(ids, self.weight)

    def extra_repr(self):
        return f"{self.weight.shape[0]}, {self.weight.shape[1]}"
