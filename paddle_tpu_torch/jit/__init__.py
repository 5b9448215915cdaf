"""``paddle.jit`` of the port (``paddle_tpu/jit``'s counterpart):
``to_static`` over CUDA-graph capture, the functional trio, the
training step, and ``save``/``load`` over ``torch.export``."""
from .api import StaticFunction, ignore_module, not_to_static, to_static
from .functional import functional_call, functional_state, swap_state
from .serialization import TranslatedLayer, load, save
from .train_step import TrainStep

__all__ = ["to_static", "StaticFunction", "not_to_static", "ignore_module",
           "functional_call", "functional_state", "swap_state", "TrainStep",
           "save", "load", "TranslatedLayer"]
