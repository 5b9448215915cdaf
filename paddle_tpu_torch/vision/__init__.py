"""``paddle.vision`` of the port (port of ``paddle_tpu/vision``): the
model zoo (``models``), the host-side numpy ``transforms`` and the
``datasets``. The reference's ``vision.ops`` (nms, roi_align, roi_pool,
box_coder) is not ported yet."""
from . import datasets, models, transforms  # noqa: F401
from .models import (  # noqa: F401
    LeNet, ResNet, resnet18, resnet34, resnet50, resnet101, resnet152,
)
