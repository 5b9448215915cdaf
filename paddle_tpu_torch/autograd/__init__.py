"""``paddle.autograd`` — port of ``paddle_tpu/autograd/__init__.py``."""
from paddle_tpu_torch.core.autograd import (  # noqa: F401
    backward, enable_grad, grad, is_grad_enabled, no_grad, set_grad_enabled,
)
from .py_layer import PyLayer, PyLayerContext  # noqa: F401

__all__ = ["backward", "grad", "no_grad", "enable_grad", "is_grad_enabled",
           "set_grad_enabled", "PyLayer", "PyLayerContext"]
