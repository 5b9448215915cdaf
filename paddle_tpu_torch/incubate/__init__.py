"""``paddle.incubate`` — port of ``paddle_tpu/incubate/__init__.py``:
ASP (automatic structured sparsity), the functional and forward-mode
autodiff (``incubate.autograd``), the fused transformer layer set
(``incubate.nn``), LookAhead, ModelAverage and the exponential moving
average (``incubate.optimizer``), and the epoch-scoped auto-checkpoint
(``incubate.checkpoint``)."""
from . import asp  # noqa: F401
from . import autograd  # noqa: F401
from . import nn  # noqa: F401
from . import optimizer  # noqa: F401
from . import checkpoint  # noqa: F401

__all__ = ["asp", "autograd", "nn", "optimizer", "checkpoint"]
