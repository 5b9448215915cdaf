"""``paddle.distributed.auto_parallel`` of the port — what is ported of
``paddle_tpu/distributed/auto_parallel/``: the checkpoint
:class:`Converter` and the pipeline-layout converters
(``converter.py``). The ``Engine``, ``Strategy``, the planner and the
cost model are later slices and not exported.
"""
from .converter import (  # noqa: F401
    Converter, pipeline_state_to_spmd, spmd_state_to_pipeline,
    uniform_chunk_bounds,
)

__all__ = ["Converter", "pipeline_state_to_spmd", "spmd_state_to_pipeline",
           "uniform_chunk_bounds"]
