"""Neural-network layers and functions of the port (``paddle_tpu/nn``'s
counterpart): ``Layer``, the functional library, the initializers, the
containers, the gradient clips and the layer zoo."""
from . import functional, initializer, layer
from .layer_base import Layer
from .clip import (ClipGradBase, ClipGradByGlobalNorm, ClipGradByNorm,
                   ClipGradByValue)
from .containers import LayerDict, LayerList, ParameterList, Sequential
from .layer import *  # noqa: F401,F403

__all__ = (["Layer", "functional", "initializer", "layer", "ClipGradBase",
            "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
            "Sequential", "LayerList", "LayerDict", "ParameterList"]
           + layer.__all__)
