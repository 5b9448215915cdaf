"""Container layers — port of ``paddle_tpu/nn/containers.py``
(``Sequential``, ``LayerList``, ``LayerDict``, ``ParameterList``).

Each is PyTorch's container under Paddle's name and constructor, so
parameters are named as in the reference (``0.weight``,
``blocks.3.attn.q_proj.weight``) and cross the numpy bridge unchanged.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

__all__ = ["Sequential", "LayerList", "LayerDict", "ParameterList"]


class Sequential(torch.nn.Sequential):
    """Layers applied in order, named ``"0"``, ``"1"``, ... or by the
    names of ``(name, layer)`` pairs or of one ``OrderedDict``."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            super().__init__(layers[0])
            return
        super().__init__()
        for i, layer in enumerate(layers):
            if isinstance(layer, tuple):
                self.add_module(layer[0], layer[1])
            else:
                self.add_module(str(i), layer)


class LayerList(torch.nn.ModuleList):
    def __init__(self, sublayers=None):
        super().__init__(sublayers)


class LayerDict(torch.nn.ModuleDict):
    def __init__(self, sublayers=None):
        super().__init__(sublayers)


class ParameterList(torch.nn.ParameterList):
    def __init__(self, parameters=None):
        super().__init__(parameters)
