"""Quanted layer wrappers — port of ``paddle_tpu/quantization/wrapper.py``
(reference: ``python/paddle/nn/quant/qat/`` QuantedLinear/QuantedConv2D
and ``quantization/wrapper.py``): the original layer's compute with
fake-quant applied to its input and its weight."""
from __future__ import annotations

import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.nn import Layer

__all__ = ["QuantedLinear", "QuantedConv2D", "ObserveWrapper"]


class _QuantedBase(Layer):
    def __init__(self, layer: Layer, q_config):
        super().__init__()
        self._layer = layer
        self.activation_quanter = None
        self.weight_quanter = None
        dev = layer.weight.device
        if q_config.activation is not None:
            self.activation_quanter = q_config.activation._instance(
                layer).to(dev)
        if q_config.weight is not None:
            self.weight_quanter = q_config.weight._instance(layer).to(dev)

    # the wrapped layer's parameters are reached through _layer (a
    # sublayer); registering them here too would list them twice
    @property
    def weight(self):
        return self._layer.weight

    @property
    def bias(self):
        return getattr(self._layer, "bias", None)

    def _quant_inputs(self, x):
        w = self.weight
        if self.activation_quanter is not None:
            x = self.activation_quanter(x)
        if self.weight_quanter is not None:
            w = self.weight_quanter(w)
        return x, w


class QuantedLinear(_QuantedBase):
    def forward(self, x):
        x, w = self._quant_inputs(x)
        return F.linear(x, w, self.bias)


class QuantedConv2D(_QuantedBase):
    def forward(self, x):
        x, w = self._quant_inputs(x)
        lyr = self._layer
        return F.conv2d(x, w, self.bias, lyr._stride, lyr._padding,
                        lyr._dilation, lyr._groups, lyr._data_format)


class ObserveWrapper(Layer):
    """PTQ wrapper: observe the input, then run the original layer
    unchanged. Carries the resolved quant config so ``PTQ.convert``
    needs no second resolution (which would miss per-layer ids across the
    quantize deepcopy)."""

    def __init__(self, observer, observed: Layer, q_config=None):
        super().__init__()
        if observer is not None:
            observer = observer.to(observed.weight.device)
        self._observer = observer
        self._observed = observed
        self._q_config = q_config

    def forward(self, *args, **kwargs):
        if self._observer is not None and args:
            args = (self._observer(args[0]),) + args[1:]
        return self._observed(*args, **kwargs)
