"""paddle_tpu_torch.serving — continuous-batching LLM inference on the card.

- **kv_cache** — block-paged KV-cache manager: refcounted blocks, the
  chain-hashed prefix cache, per-layer device pools updated in place.
- **scheduler** — FCFS continuous batching with token-budget packing of
  decode slots and prefill chunks, and preemption-by-recompute.
- **engine** — :class:`ServingEngine`: one unified token-packed
  prefill+decode step per iteration through the RPA kernel.
- **server** — stdlib HTTP front-end: ``POST /generate`` (sync JSON or
  streamed NDJSON) and ``GET /healthz``.
"""
from .engine import RequestHandle, ServingEngine
from .server import Server

__all__ = ["RequestHandle", "ServingEngine", "Server"]
