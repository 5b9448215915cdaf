"""QAT, quantization-aware training — port of
``paddle_tpu/quantization/qat.py`` (reference:
``python/paddle/quantization/qat.py`` + ``quantize.py``): walk the model,
replace the configured layers by their quanted wrappers; ``convert``
bakes the learned scales into plain layers."""
from __future__ import annotations

import copy

import torch

from paddle_tpu_torch.nn import Layer

from .config import QuantConfig
from .wrapper import _QuantedBase

__all__ = ["QAT"]


class Quantization:
    def __init__(self, config: QuantConfig):
        self._config = config

    def _walk_replace(self, model: Layer, make, orig=None, prefix=""):
        """Walk ``model`` (possibly a deepcopy) in lockstep with ``orig``
        (the user's original) so an id-based add_layer_config still
        resolves, matching names by full dotted path."""
        orig = orig if orig is not None else model
        for name, child in list(model._modules.items()):
            ochild = orig._modules.get(name, child)
            path = f"{prefix}.{name}" if prefix else name
            if self._config._is_quantifiable(child, path,
                                             orig_layer=ochild):
                cfg = self._config._get_config_by_layer(
                    child, path, orig_layer=ochild)
                model._modules[name] = make(child, cfg)
            else:
                self._walk_replace(child, make, ochild, path)
        return model


class QAT(Quantization):
    def quantize(self, model: Layer, inplace: bool = False) -> Layer:
        orig = model
        if not inplace:
            model = copy.deepcopy(model)
        mapping = self._config.qat_layer_mappings

        def make(child, cfg):
            return mapping[type(child)](child, cfg)
        return self._walk_replace(model, make, orig)

    def convert(self, model: Layer, inplace: bool = False) -> Layer:
        """Bake fake-quantized weights back into the plain layers for
        deployment (the reference's onnx-format convert collapses
        quant/dequant pairs the same way)."""
        if not inplace:
            model = copy.deepcopy(model)
        _convert_in_place(model)
        return model


@torch.no_grad()
def _convert_in_place(model: Layer):
    from .base import bcast_shape, channel_axis_of
    for name, child in list(model._modules.items()):
        if isinstance(child, _QuantedBase):
            plain = child._layer
            wq = child.weight_quanter
            if wq is not None and wq.scales() is not None:
                # scalar (per-tensor) or [channels] (per-channel,
                # broadcast along the quanter's channel axis)
                w = plain.weight
                scale = wq.scales().to(w.device, torch.float32)
                bits = wq.bit_length()
                if bool((scale > 0).any()):
                    if scale.dim():
                        axis = channel_axis_of(wq, "weight quanter")
                        scale = scale.reshape(bcast_shape(w.dim(), axis))
                    scale = torch.clamp(scale, min=1e-9)
                    bound = float(2 ** (bits - 1) - 1)
                    q = torch.clamp(torch.round(w / scale * bound), -bound,
                                    bound) * scale / bound
                    plain.weight.data = q.to(w.dtype)
            model._modules[name] = plain
        else:
            _convert_in_place(child)
