"""QuanterFactory — port of ``paddle_tpu/quantization/factory.py``
(reference: ``python/paddle/quantization/factory.py``): a deferred
constructor, so one QuantConfig builds fresh quanter layers for each
wrapped layer."""
from __future__ import annotations

__all__ = ["QuanterFactory", "quanter"]


class QuanterFactory:
    def __init__(self, cls, *args, **kwargs):
        self._cls = cls
        self._args = args
        self._kwargs = kwargs

    def _instance(self, layer=None):
        # per-channel quanters need the wrapped layer to infer the channel
        # axis from the weight layout (Conv2D OIHW -> 0, Linear [in, out]
        # -> 1); classes opt in via _wants_layer
        if getattr(self._cls, "_wants_layer", False):
            return self._cls(*self._args, layer=layer, **self._kwargs)
        return self._cls(*self._args, **self._kwargs)

    def __call__(self, *args, **kwargs):
        return QuanterFactory(self._cls, *args, **kwargs)


def quanter(name=None):
    """Class decorator turning a quanter Layer class into a factory
    constructor: ``MyQuanter(bits=8)`` then yields a QuanterFactory for
    QuantConfig, instantiated fresh per wrapped layer."""
    def deco(cls):
        return QuanterFactory(cls)
    return deco
