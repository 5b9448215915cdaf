"""``fleet`` of the port: the Mixture-of-Experts layer and its gates
(``paddle_tpu/distributed/fleet/moe.py``)."""
from . import moe
from .moe import GShardGate, MoELayer, NaiveGate, SwitchGate

__all__ = ["moe", "MoELayer", "NaiveGate", "SwitchGate", "GShardGate"]
