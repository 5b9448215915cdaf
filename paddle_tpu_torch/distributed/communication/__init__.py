"""``paddle.distributed.communication`` — port of
``paddle_tpu/distributed/communication/__init__.py``: the collectives of
``distributed.collective`` under the reference's namespace, with the
``stream`` variants."""
from ..collective import (  # noqa: F401
    ReduceOp, all_gather, all_gather_object, all_reduce, all_to_all,
    barrier, broadcast, p2p_shift, recv, reduce, reduce_scatter, scatter,
    send,
)
from . import stream  # noqa: F401

__all__ = ["ReduceOp", "all_reduce", "all_gather", "all_gather_object",
           "all_to_all", "barrier", "broadcast", "reduce",
           "reduce_scatter", "scatter", "send", "recv", "p2p_shift",
           "stream"]
