"""Layers of the port (``paddle_tpu/nn/layer``'s counterpart)."""
from .common import Embedding, Linear
from .norm import RMSNorm

__all__ = ["Embedding", "Linear", "RMSNorm"]
