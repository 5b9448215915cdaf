"""``paddle.nn.utils`` of the port (port of
``paddle_tpu/nn/utils/__init__.py``): the gradient clips of
``nn.clip``, weight normalisation and the parameter/vector helpers."""
from paddle_tpu_torch.nn.clip import clip_grad_norm_, clip_grad_value_  # noqa: F401
from .params import parameters_to_vector, vector_to_parameters  # noqa: F401
from .weight_norm import remove_weight_norm, weight_norm  # noqa: F401

__all__ = ["clip_grad_norm_", "clip_grad_value_", "parameters_to_vector",
           "vector_to_parameters", "weight_norm", "remove_weight_norm"]
