"""hapi high-level API of the port (``paddle_tpu/hapi``'s counterpart)."""
from .model import (  # noqa: F401
    Callback, EarlyStopping, LRScheduler, Model, ModelCheckpoint,
    ProgBarLogger, StepTelemetry, VisualDL,
)
