"""``paddle.jit`` of the port (``paddle_tpu/jit``'s counterpart):
``to_static`` over CUDA-graph capture, the functional trio and the
training step. ``jit.save``/``load`` are not ported."""
from .api import StaticFunction, ignore_module, not_to_static, to_static
from .functional import functional_call, functional_state, swap_state
from .train_step import TrainStep

__all__ = ["to_static", "StaticFunction", "not_to_static", "ignore_module",
           "functional_call", "functional_state", "swap_state", "TrainStep"]
