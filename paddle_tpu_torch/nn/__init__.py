"""Neural-network layers and functions of the port (``paddle_tpu/nn``'s
counterpart): ``Layer``, the functional library, the initializers, the
containers, the gradient clips, ``utils`` and the layer zoo."""
from . import functional, initializer, layer, utils
from .layer_base import Layer
from .clip import (ClipGradBase, ClipGradByGlobalNorm, ClipGradByNorm,
                   ClipGradByValue)
from .containers import LayerDict, LayerList, ParameterList, Sequential
from .layer import *  # noqa: F401,F403
from .utils import clip_grad_norm_

__all__ = (["Layer", "functional", "initializer", "layer", "utils",
            "ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
            "ClipGradByGlobalNorm", "clip_grad_norm_", "Sequential",
            "LayerList", "LayerDict", "ParameterList"]
           + layer.__all__)
