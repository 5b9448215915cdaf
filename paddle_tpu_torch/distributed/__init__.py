"""``paddle.distributed`` of the port — ``paddle_tpu/distributed``'s
counterpart over ``torch.distributed``.

Each process is one rank on one device (NCCL on the card, gloo on the
CPU): ``init_parallel_env`` joins the process group and builds the
default mesh (a ``DeviceMesh`` with the reference's axis names), and
the collectives, placements, data parallelism, ZeRO and the
tensor-parallel layers act across processes. The reference's names are
exported (``paddle_tpu/distributed/__init__.py:8-43``) except those of
the modules later slices port: the ``auto_parallel`` engine
(``Engine``, ``Strategy``), ``rpc`` and ``ps``. ``auto_parallel`` itself
holds the checkpoint converters. ``launch`` is the launcher module
(``python -m paddle_tpu_torch.distributed.launch``).
"""
from .mesh import (  # noqa: F401
    init_mesh, get_mesh, set_mesh, mesh_scope, ProcessMesh,
)
from .env import (  # noqa: F401
    init_parallel_env, get_rank, get_world_size, ParallelEnv,
)
from .collective import (  # noqa: F401
    ReduceOp, Group, new_group, get_group, all_reduce, all_gather,
    all_gather_object, reduce, reduce_scatter, broadcast, all_to_all,
    scatter, send, recv, barrier, p2p_shift, spmd, shard_map, P,
)
from .sharding_api import (  # noqa: F401
    shard_tensor, reshard, named_sharding, spec_of, with_sharding_constraint,
)
from .topology import (  # noqa: F401
    CommunicateTopology, HybridCommunicateGroup,
)
from .parallel import DataParallel  # noqa: F401
from . import fleet  # noqa: F401
from . import sharding  # noqa: F401
from .sharding import (  # noqa: F401
    group_sharded_parallel, save_group_sharded_model,
)
from .tcp_store import TCPStore  # noqa: F401
from . import auto_parallel  # noqa: F401
from .fleet.utils import recompute  # noqa: F401
from .communication import stream  # noqa: F401
from .compat import (  # noqa: F401
    P2POp, batch_isend_irecv, broadcast_object_list, destroy_process_group,
    gather, get_backend, irecv, is_initialized, isend, scatter_object_list,
    spawn, split, wait,
)

#: names of the reference's ``paddle.distributed`` that later slices port
UNPORTED = ("Engine", "Strategy", "rpc")


def __getattr__(name):
    # the launcher module loads on first use, so that ``python -m
    # paddle_tpu_torch.distributed.launch`` runs it fresh as __main__
    if name == "launch":
        import importlib
        return importlib.import_module(f"{__name__}.launch")
    # the placements load torch.distributed.tensor on first use
    from . import sharding_api
    if name in sharding_api._PLACEMENTS:
        return getattr(sharding_api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
