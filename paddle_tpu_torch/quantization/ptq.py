"""PTQ, post-training quantization — port of
``paddle_tpu/quantization/ptq.py`` (reference:
``python/paddle/quantization/ptq.py``): insert observers, run
calibration batches, then ``convert`` to quanted layers at the observed
scales."""
from __future__ import annotations

import copy

from paddle_tpu_torch.nn import Layer

from .config import SingleLayerConfig
from .qat import Quantization
from .quanters import FakeQuanterWithAbsMaxObserverLayer
from .wrapper import ObserveWrapper

__all__ = ["PTQ"]


class PTQ(Quantization):
    def quantize(self, model: Layer, inplace: bool = False) -> Layer:
        orig = model
        if not inplace:
            model = copy.deepcopy(model)

        def make(child, cfg):
            obs = cfg.activation._instance(child) \
                if cfg.activation is not None else None
            return ObserveWrapper(obs, child, cfg)
        return self._walk_replace(model, make, orig)

    def convert(self, model: Layer, inplace: bool = False) -> Layer:
        """Replace observed layers with quanted layers whose activation
        quanter is frozen at the observed scale."""
        if not inplace:
            model = copy.deepcopy(model)
        mapping = self._config.qat_layer_mappings
        self._convert_walk(model, mapping)
        model.eval()  # deployment form: quanter scales stay frozen
        return model

    def _convert_walk(self, model: Layer, mapping):
        for name, child in list(model._modules.items()):
            if isinstance(child, ObserveWrapper):
                observed = child._observed
                cfg = child._q_config  # resolved at quantize time
                # the weight quanter from the config; the activation
                # quanter a fake quanter FROZEN at the observed scale
                quanted = mapping[type(observed)](
                    observed, SingleLayerConfig(None, cfg.weight))
                if quanted.weight_quanter is not None:
                    # calibrate the weight scale from the weights now (PTQ
                    # never trains, so the quanter would stay at scale 0,
                    # a no-op)
                    quanted.weight_quanter.train()
                    quanted.weight_quanter(observed.weight)
                    quanted.weight_quanter.eval()
                if child._observer is not None:
                    obs_scale = child._observer.scales()
                    if obs_scale is not None and obs_scale.numel() > 1:
                        raise ValueError(
                            "PTQ activation observers must be per-tensor "
                            f"(got {obs_scale.numel()} scales); "
                            "per-channel quantization applies to weights "
                            "(pass it as the weight= config)")
                    fq = FakeQuanterWithAbsMaxObserverLayer(
                        bit_length=child._observer.bit_length())
                    fq._scale.copy_(obs_scale.reshape(()))
                    fq.to(observed.weight.device).eval()
                    quanted.activation_quanter = fq
                model._modules[name] = quanted
            else:
                self._convert_walk(child, mapping)
