"""paddle_tpu_torch.serving — continuous-batching LLM inference on the card.

- **kv_cache** — block-paged KV-cache manager: refcounted blocks, the
  chain-hashed prefix cache, per-layer device pools updated in place,
  block export/import for the fleet's KV handoff.
- **scheduler** — FCFS continuous batching with token-budget packing of
  decode slots and prefill chunks, and preemption-by-recompute.
- **engine** — :class:`ServingEngine`: one unified token-packed
  prefill+decode step per iteration through the RPA kernel, with the
  ``serving_*`` metrics, the request ledger and the span chain.
- **server** — stdlib HTTP front-end: ``POST /generate`` (sync JSON or
  streamed NDJSON, with shedding, deadlines and ``traceparent``),
  ``GET /healthz``, ``/statusz``, ``/metrics[.json]``, ``/fleetz`` and
  ``POST /debug/profile``.
- **fleet** — multi-replica serving: :class:`FleetRouter` over
  :class:`Replica` engines, and :class:`RouterServer`.
"""
from . import engine, fleet, kv_cache, scheduler, server  # noqa: F401
from .engine import RequestHandle, ServingEngine  # noqa: F401
from .fleet import FleetRouter, Replica, RouterServer, build_fleet  # noqa: F401,E501
from .kv_cache import BlockAllocator, PagedKVCache  # noqa: F401
from .scheduler import Request, RequestState, Scheduler  # noqa: F401
from .server import Server  # noqa: F401

__all__ = ["ServingEngine", "RequestHandle", "Server", "Scheduler",
           "Request", "RequestState", "PagedKVCache", "BlockAllocator",
           "FleetRouter", "Replica", "RouterServer", "build_fleet",
           "engine", "fleet", "kv_cache", "scheduler", "server"]
