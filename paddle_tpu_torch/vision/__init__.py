"""``paddle.vision`` of the port (port of ``paddle_tpu/vision``): the
model zoo (``models``), the host-side numpy ``transforms`` and the
``datasets``, and the detection ``ops`` (nms, roi_align, roi_pool,
box_coder)."""
from . import datasets, models, ops, transforms  # noqa: F401
from .models import (  # noqa: F401
    LeNet, ResNet, resnet18, resnet34, resnet50, resnet101, resnet152,
)
