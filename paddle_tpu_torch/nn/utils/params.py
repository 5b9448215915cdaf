"""Flatten parameters into one vector and back (port of
``paddle_tpu/nn/utils/params.py``)."""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.tensor import unwrap

__all__ = ["parameters_to_vector", "vector_to_parameters"]


def parameters_to_vector(parameters, name=None):
    """Every parameter flattened and concatenated, in order."""
    return torch.cat([unwrap(p).reshape(-1) for p in parameters])


def vector_to_parameters(vec, parameters, name=None):
    """Copy consecutive runs of ``vec`` into the parameters, in order, in
    place (the reference's ``set_value``); no gradient flows."""
    vec = unwrap(vec)
    offset = 0
    with torch.no_grad():
        for p in parameters:
            n = p.numel()
            p.copy_(vec[offset:offset + n].reshape(p.shape))
            offset += n
