"""Container layers — port of ``paddle_tpu/nn/containers.py``
(``Sequential``, ``LayerList``, ``LayerDict``, ``ParameterList``).

Each is PyTorch's container under Paddle's name and constructor, and an
``nn.Layer``, so
parameters are named as in the reference (``0.weight``,
``blocks.3.attn.q_proj.weight``) and cross the numpy bridge unchanged.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from .layer_base import Layer

__all__ = ["Sequential", "LayerList", "LayerDict", "ParameterList"]


class Sequential(Layer, torch.nn.Sequential):
    """Layers applied in order, named ``"0"``, ``"1"``, ... or by the
    names of ``(name, layer)`` pairs or of one ``OrderedDict``."""

    def __init__(self, *layers):
        Layer.__init__(self)
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            layers = tuple(layers[0].items())
        for i, layer in enumerate(layers):
            if isinstance(layer, tuple):
                self.add_module(layer[0], layer[1])
            else:
                self.add_module(str(i), layer)


class LayerList(Layer, torch.nn.ModuleList):
    def __init__(self, sublayers=None):
        Layer.__init__(self)
        if sublayers is not None:
            self.extend(sublayers)


class LayerDict(Layer, torch.nn.ModuleDict):
    def __init__(self, sublayers=None):
        Layer.__init__(self)
        if sublayers is not None:
            self.update(sublayers)


class ParameterList(Layer, torch.nn.ParameterList):
    def __init__(self, parameters=None):
        Layer.__init__(self)
        if parameters is not None:
            self.extend(parameters)
