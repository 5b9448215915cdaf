"""The training step of the port (``paddle_tpu/jit``'s counterpart)."""
from .train_step import TrainStep

__all__ = ["TrainStep"]
