"""Neural-network layers and functions of the port."""
from . import functional
from .layer import Embedding, Linear, RMSNorm

__all__ = ["functional", "Embedding", "Linear", "RMSNorm"]
