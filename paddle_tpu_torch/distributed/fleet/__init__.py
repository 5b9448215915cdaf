"""``fleet`` of the port: the Mixture-of-Experts layer and its gates
(``paddle_tpu/distributed/fleet/moe.py``), activation recomputation
(``utils.recompute``) and the strategy object
(``paddle_tpu/distributed/fleet/__init__.py:36-58``)."""
from . import moe, utils
from .moe import GShardGate, MoELayer, NaiveGate, SwitchGate
from .utils import recompute

__all__ = ["moe", "MoELayer", "NaiveGate", "SwitchGate", "GShardGate",
           "utils", "recompute", "DistributedStrategy"]


class DistributedStrategy:
    """The reference's switchboard (``fleet/base/distributed_strategy.py``):
    each knob recorded as set. ``recompute = True`` is what
    ``LlamaConfig.recompute`` carries on one card; the mesh knobs
    (``hybrid_configs``, sharding, pipeline, tensor parallelism) wait for
    the distributed slice."""

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
