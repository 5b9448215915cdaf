"""``paddle.quantization`` of the port — ``paddle_tpu/quantization``'s
counterpart.

The QAT/PTQ framework (reference ``python/paddle/quantization/``:
``QuantConfig``, ``QAT``, ``PTQ``, the abs-max quanters and observers,
the quanted layer wrappers), real int8 execution (``Int8Linear``,
``Int8Conv2D``, ``convert_to_int8``) and the serving engine's weight-only
PTQ (``weight_only``: ``QuantizedLeaf``, ``quantize_state``,
calibration). Fake quantization is plain PyTorch: the reference notes
that it needs no custom kernel, and the port writes none.
"""
from .config import QuantConfig, SingleLayerConfig  # noqa: F401
from .factory import QuanterFactory, quanter  # noqa: F401
from .base import BaseQuanter, BaseObserver  # noqa: F401
from .quanters import FakeQuanterWithAbsMaxObserver  # noqa: F401
from .observers import AbsmaxObserver, PerChannelAbsmaxObserver  # noqa: F401
from .qat import QAT  # noqa: F401
from .ptq import PTQ  # noqa: F401
from .wrapper import QuantedLinear, QuantedConv2D  # noqa: F401
from .int8 import (  # noqa: F401
    Int8Linear, Int8Conv2D, convert_to_int8,
)
from .weight_only import (  # noqa: F401
    QuantizedLeaf, WEIGHT_MODES, quantize_state, quantized_bytes,
    calibrate, calibration_from_checkpoint, quantization_metrics,
)

__all__ = ["QuantConfig", "SingleLayerConfig", "QuanterFactory", "quanter",
           "BaseQuanter", "BaseObserver", "FakeQuanterWithAbsMaxObserver",
           "AbsmaxObserver", "PerChannelAbsmaxObserver", "QAT", "PTQ",
           "QuantedLinear",
           "QuantedConv2D", "Int8Linear", "Int8Conv2D", "convert_to_int8",
           "QuantizedLeaf", "WEIGHT_MODES", "quantize_state",
           "quantized_bytes", "calibrate", "calibration_from_checkpoint",
           "quantization_metrics"]
