"""``paddle.distributed.communication.stream`` — port of
``paddle_tpu/distributed/communication/stream.py``.

Each collective returns a task with ``wait()`` and ``is_completed()``
over ``torch.distributed``'s asynchronous work handle: ``sync_op=False``
issues the collective and returns at once; ``sync_op=True`` (or
``use_calc_stream=True``) waits before returning, so the task is
already complete. On the card, ``wait()`` orders the current stream
after the collective rather than blocking the host."""
from __future__ import annotations

from .. import collective as C

__all__ = ["all_reduce", "all_gather", "reduce_scatter", "broadcast",
           "all_to_all", "reduce", "scatter", "send", "recv"]


class _Done:
    """A task whose collective ran synchronously."""

    def __init__(self, result):
        self._result = result

    def wait(self):
        return self._result

    def is_completed(self) -> bool:
        return True


def _wrap(fn):
    def stream_variant(*args, sync_op=True, use_calc_stream=False,
                       **kwargs):
        sync = sync_op or use_calc_stream
        out = fn(*args, sync_op=sync, **kwargs)
        return _Done(out) if sync or not isinstance(out, C._Task) else out
    stream_variant.__name__ = fn.__name__
    stream_variant.__doc__ = (f"stream.{fn.__name__}: returns a task with "
                              "wait() (reference stream API)")
    return stream_variant


all_reduce = _wrap(C.all_reduce)
all_gather = _wrap(C.all_gather)
reduce_scatter = _wrap(C.reduce_scatter)
broadcast = _wrap(C.broadcast)
reduce = _wrap(C.reduce)
send = _wrap(C.send)
recv = _wrap(C.recv)


def _sync_only(fn):
    def stream_variant(*args, sync_op=True, use_calc_stream=False,
                       **kwargs):
        return _Done(fn(*args, **kwargs))
    stream_variant.__name__ = fn.__name__
    stream_variant.__doc__ = (f"stream.{fn.__name__}: runs synchronously "
                              "and returns a completed task")
    return stream_variant


all_to_all = _sync_only(C.all_to_all)
scatter = _sync_only(C.scatter)
