"""Optimizers of the port (``paddle_tpu/optimizer``'s counterpart):
Paddle's update rules — SGD, Momentum, Adam, AdamW, Adagrad, RMSProp,
Adadelta, Adamax and Lamb — with parameter groups, f32 master weights,
gradient clipping, weight decay and the learning-rate schedulers of
``lr``."""
from . import lr
from .adadelta import Adadelta
from .adagrad import Adagrad
from .adam import Adam
from .adamax import Adamax
from .adamw import AdamW
from .lamb import Lamb
from .momentum import Momentum
from .optimizer import Optimizer
from .rmsprop import RMSProp
from .sgd import SGD

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "RMSProp", "Adadelta", "Adamax", "Lamb", "lr"]
