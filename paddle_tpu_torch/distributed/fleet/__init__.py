"""``fleet`` — port of ``paddle_tpu/distributed/fleet/__init__.py``.

``fleet.init`` builds the hybrid topology and its mesh from the
strategy's ``hybrid_configs``; ``distributed_model`` wraps a pure
data-parallel model in ``DataParallel`` (a tensor-parallel model, built
from the mpu layers, passes through), and ``distributed_optimizer``
passes the optimizer through (``jit.TrainStep`` owns the gradient
collectives), as in the reference. Also here: the tensor-parallel layers
(``mpu``), the Mixture-of-Experts layer and its gates (one device; its
expert parallelism is a later slice), ``recompute``, the pipeline
engines (``pipeline``: ``PipelineLayer`` and the 1F1B
``PipelineParallel``; ``spmd_pipeline``: the tick-loop pipeline and its
layers) and sequence parallelism (``sequence_parallel``: ring attention,
Ulysses, ``scatter_sequence``/``gather_sequence``) — every name of the
reference's ``fleet/__init__.py:19-42``.
"""
from __future__ import annotations

from typing import Optional

from ..env import get_rank, get_world_size
from ..mesh import get_mesh
from ..parallel import DataParallel
from ..topology import CommunicateTopology, HybridCommunicateGroup
from . import moe, mpu, pipeline, sequence_parallel, spmd_pipeline, utils
from .moe import GShardGate, MoELayer, NaiveGate, SwitchGate
from .mpu import (ColumnParallelLinear, ParallelCrossEntropy,
                  RowParallelLinear, VocabParallelEmbedding)
from .pipeline import (LayerDesc, PipelineLayer, PipelineParallel,
                       SharedLayerDesc)
from .sequence_parallel import (gather_sequence, ring_attention,
                                scatter_sequence, ulysses_attention)
from .spmd_pipeline import (SpmdHeteroPipelineLayer, SpmdPipelineLayer,
                            SpmdPipelineParallel, pipeline_spmd,
                            pipeline_spmd_hetero, spmd_schedule_stats)
from .utils import recompute

__all__ = ["init", "DistributedStrategy", "distributed_model",
           "distributed_optimizer", "get_hybrid_communicate_group",
           "worker_num", "worker_index", "mpu", "ColumnParallelLinear",
           "RowParallelLinear", "VocabParallelEmbedding",
           "ParallelCrossEntropy", "LayerDesc", "SharedLayerDesc",
           "PipelineLayer", "PipelineParallel", "pipeline_spmd",
           "spmd_schedule_stats", "SpmdPipelineLayer",
           "SpmdPipelineParallel", "pipeline_spmd_hetero",
           "SpmdHeteroPipelineLayer", "moe", "MoELayer", "NaiveGate",
           "SwitchGate", "GShardGate", "ring_attention",
           "ulysses_attention", "scatter_sequence", "gather_sequence",
           "pipeline", "sequence_parallel", "spmd_pipeline", "utils",
           "recompute"]

_state = {"hcg": None, "strategy": None}


class DistributedStrategy:
    """The reference's switchboard (``fleet/base/distributed_strategy.py``):
    ``hybrid_configs`` gives the mesh's degrees, ``recompute`` turns on
    a zoo model's ``cfg.recompute``; the other knobs are recorded."""

    def __init__(self):
        self.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 1, "sharding_degree": 1,
                               "sep_degree": 1}
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.sharding = False
        self.sharding_configs = {}
        self.pipeline = False
        self.pipeline_configs = {}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {}
        self.gradient_merge = False
        self.gradient_merge_configs = {}
        self.find_unused_parameters = False


def init(role_maker=None, is_collective=True, strategy: Optional[
        DistributedStrategy] = None):
    """Reference :68-81: the topology and its mesh from
    ``strategy.hybrid_configs``. Needs ``init_parallel_env`` first; when
    every degree is 1 the whole world goes on ``dp`` (Paddle's default),
    where the reference's mesh would not cover its devices."""
    strategy = strategy or DistributedStrategy()
    hc = strategy.hybrid_configs
    dims = [hc.get("dp_degree", 1), hc.get("pp_degree", 1),
            hc.get("sharding_degree", 1), hc.get("mp_degree", 1)]
    if dims == [1, 1, 1, 1]:
        dims[0] = get_world_size()
    topo = CommunicateTopology(["data", "pipe", "sharding", "model"], dims)
    hcg = HybridCommunicateGroup(topo)
    _state["hcg"] = hcg
    _state["strategy"] = strategy
    return hcg


def get_hybrid_communicate_group() -> HybridCommunicateGroup:
    if _state["hcg"] is None:
        raise RuntimeError("call fleet.init() first")
    return _state["hcg"]


def distributed_model(model):
    """Reference :89-106: ``DataParallel`` for a pure data-parallel
    topology; other models pass through. ``strategy.recompute`` sets a
    model's ``cfg.recompute``."""
    hcg = get_hybrid_communicate_group()
    strategy = _state.get("strategy")
    if strategy is not None and strategy.recompute:
        cfg = getattr(model, "cfg", None)
        if cfg is not None and hasattr(cfg, "recompute"):
            cfg.recompute = True
    if hcg.get_data_parallel_world_size() > 1 and \
            hcg.get_model_parallel_world_size() == 1 and \
            hcg.get_pipe_parallel_world_size() == 1:
        return DataParallel(model, mesh=get_mesh())
    return model


def distributed_optimizer(optimizer, strategy=None):
    """Reference :109-114: the optimizer as it is."""
    return optimizer


def worker_num() -> int:
    return get_world_size()


def worker_index() -> int:
    return get_rank()
