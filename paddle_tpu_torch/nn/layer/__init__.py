"""Layers of the port (``paddle_tpu/nn/layer``'s counterpart)."""
from . import activation, common, conv, loss, norm, pooling, rnn, transformer
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .transformer import *  # noqa: F401,F403

__all__ = (activation.__all__ + common.__all__ + conv.__all__ +
           loss.__all__ + norm.__all__ + pooling.__all__ + rnn.__all__ +
           transformer.__all__)
