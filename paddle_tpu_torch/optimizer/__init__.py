"""Optimizers of the port (``paddle_tpu/optimizer``'s counterpart):
Adam and AdamW with Paddle's update rules, parameter groups, f32 master
weights and gradient clipping."""
from .adam import Adam
from .adamw import AdamW
from .optimizer import Optimizer

__all__ = ["Optimizer", "Adam", "AdamW"]
