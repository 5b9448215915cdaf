"""``paddle.callbacks`` — port of ``paddle_tpu/callbacks.py``: the hapi
callback set."""
from paddle_tpu_torch.hapi.model import (  # noqa: F401
    Callback, EarlyStopping, LRScheduler, ModelCheckpoint, ProgBarLogger,
    StepTelemetry, VisualDL,
)

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
           "VisualDL", "LRScheduler", "StepTelemetry"]
