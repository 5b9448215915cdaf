"""Neural-network layers and functions of the port."""
from . import functional
from .clip import (ClipGradBase, ClipGradByGlobalNorm, ClipGradByNorm,
                   ClipGradByValue)
from .layer import Embedding, Linear, RMSNorm

__all__ = ["functional", "Embedding", "Linear", "RMSNorm", "ClipGradBase",
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]
