"""paddle_tpu_torch.serving.fleet — cache-aware multi-replica serving,
port of ``paddle_tpu/serving/fleet``: N
:class:`~paddle_tpu_torch.serving.ServingEngine` replicas behind one
router front-end, in one process (on one card, or the CPU with
``device="cpu"``).

- **replica** — :class:`Replica`: one engine plus the router's view of
  it (role, liveness, ``health()``); ``build_fleet`` builds N of them
  from one model factory.
- **router** — :class:`FleetRouter`: cache-aware placement by
  chain-hash prefix sketch, least-loaded fallback, dead-replica failover
  with tail-only recompute through the prefix cache, disaggregated
  prefill/decode with a KV block handoff; engine-interface compatible.
- **server** — :class:`RouterServer`: the HTTP front-end over the
  router, shedding with ``serving_rejections_total{reason=
  "fleet_saturated"}`` when every live replica is at queue depth.
"""
from . import replica, router, server  # noqa: F401
from .replica import Replica, build_fleet  # noqa: F401
from .router import FleetRouter, RouteHandle, router_metrics  # noqa: F401
from .server import RouterHandler, RouterServer  # noqa: F401

__all__ = ["Replica", "build_fleet", "FleetRouter", "RouteHandle",
           "router_metrics", "RouterServer", "RouterHandler",
           "replica", "router", "server"]
