"""The data package of the port (``paddle_tpu/data``'s counterpart): a
deterministic, checkpointable input pipeline — :class:`ShardedStream`
(seeded, per-host-sharded order), :class:`SequencePacker` (documents
packed into ``[B, seq]`` with segment ids), :class:`DataPipeline` (the
composed iterator whose ``state_dict`` ``FitResilience`` commits with
the model and optimizer) and :class:`DevicePrefetcher` (batches copied
to the card ahead of the loop from pinned memory on a side stream)."""
from .metrics import data_metrics  # noqa: F401
from .packing import SequencePacker  # noqa: F401
from .pipeline import DataPipeline  # noqa: F401
from .prefetch import DevicePrefetcher, to_device  # noqa: F401
from .stream import ShardedStream  # noqa: F401

__all__ = ["DataPipeline", "ShardedStream", "SequencePacker",
           "DevicePrefetcher", "to_device", "data_metrics"]
