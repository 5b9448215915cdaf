"""``paddle.callbacks`` — port of ``paddle_tpu/callbacks.py``: the hapi
callbacks the port has. ``VisualDL`` and ``StepTelemetry`` wait for the
observability slice (ROADMAP §1)."""
from paddle_tpu_torch.hapi.model import (  # noqa: F401
    Callback, EarlyStopping, LRScheduler, ModelCheckpoint, ProgBarLogger,
)

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
           "LRScheduler"]
