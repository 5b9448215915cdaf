"""QuantConfig — port of ``paddle_tpu/quantization/config.py``
(reference: ``python/paddle/quantization/config.py``): maps layers,
names and types to (activation, weight) quanter factories, per-layer
overrides first, then per-name, then per-type."""
from __future__ import annotations

from typing import Optional

from paddle_tpu_torch.nn import Layer

from .factory import QuanterFactory

__all__ = ["SingleLayerConfig", "QuantConfig"]


class SingleLayerConfig:
    def __init__(self, activation: Optional[QuanterFactory],
                 weight: Optional[QuanterFactory]):
        self._activation = activation
        self._weight = weight

    @property
    def activation(self):
        return self._activation

    @property
    def weight(self):
        return self._weight

    def __str__(self):
        return f"activation: {self._activation}\nweight: {self._weight}"


class QuantConfig:
    def __init__(self, activation: Optional[QuanterFactory] = None,
                 weight: Optional[QuanterFactory] = None):
        if activation is None and weight is None:
            self._global_config = None
        else:
            self._global_config = SingleLayerConfig(activation, weight)
        self._layer2config = {}   # id(layer) -> config
        self._name2config = {}
        self._type2config = {}
        self._qat_layer_mapping = dict(_default_qat_mapping())
        self._customized_leaves = []

    # -- configuration surface ----------------------------------------------
    def add_layer_config(self, layer, activation=None, weight=None):
        layers = layer if isinstance(layer, (list, tuple)) else [layer]
        for lyr in layers:
            self._layer2config[id(lyr)] = SingleLayerConfig(activation,
                                                            weight)

    def add_name_config(self, layer_name, activation=None, weight=None):
        names = layer_name if isinstance(layer_name, (list, tuple)) \
            else [layer_name]
        for n in names:
            self._name2config[n] = SingleLayerConfig(activation, weight)

    def add_type_config(self, layer_type, activation=None, weight=None):
        types = layer_type if isinstance(layer_type, (list, tuple)) \
            else [layer_type]
        for t in types:
            self._type2config[t] = SingleLayerConfig(activation, weight)

    def add_qat_layer_mapping(self, source: type, target: type):
        if not issubclass(source, Layer):
            raise TypeError(f"{source!r} is not a Layer class")
        self._qat_layer_mapping[source] = target

    def add_customized_leaf(self, layer_type: type):
        self._customized_leaves.append(layer_type)

    @property
    def qat_layer_mappings(self):
        return self._qat_layer_mapping

    @property
    def customized_leaves(self):
        return self._customized_leaves

    # -- resolution ------------------------------------------------------------
    def _get_config_by_layer(self, layer, name: str = "",
                             orig_layer=None) -> Optional[SingleLayerConfig]:
        """``name`` is the full dotted path; ``orig_layer`` is the layer
        before a deepcopy, so add_layer_config identities survive
        quantize(inplace=False)."""
        for key in (id(layer), id(orig_layer) if orig_layer is not None
                    else None):
            if key is not None and key in self._layer2config:
                return self._layer2config[key]
        if name in self._name2config:
            return self._name2config[name]
        for t, cfg in self._type2config.items():
            if isinstance(layer, t):
                return cfg
        if type(layer) in self._qat_layer_mapping:
            return self._global_config
        return None

    def _is_quantifiable(self, layer, name: str = "",
                         orig_layer=None) -> bool:
        return self._get_config_by_layer(layer, name, orig_layer) \
            is not None and type(layer) in self._qat_layer_mapping


def _default_qat_mapping():
    from paddle_tpu_torch import nn
    from .wrapper import QuantedConv2D, QuantedLinear
    return {nn.Linear: QuantedLinear, nn.Conv2D: QuantedConv2D}
