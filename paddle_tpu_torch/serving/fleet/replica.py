"""Replica wrapper for the serving fleet — port of
``paddle_tpu/serving/fleet/replica.py``.

A :class:`Replica` is one :class:`~paddle_tpu_torch.serving.ServingEngine`
plus the router's view of it: a role tag (``prefill`` / ``decode`` /
``mixed``), a liveness bit, and a ``health()`` snapshot built from the
engine's lock-free ``stats()`` — the fields ``/healthz`` and
``/statusz`` expose, so the router's view and an operator's probe never
disagree.

``build_fleet`` spins up N engine replicas from one model factory. Each
replica owns its KV pools, scheduler and run thread; replicas on one
card may share one model object (``model_fn`` returning the same
module), which holds the weights once — sound because the Llama forward
keeps no per-call state on the module. A model that does (the MoE LM's
gates keep their ``l_aux``) needs one model per replica. The reference
reads the replica count from ``PADDLE_TPU_FLEET_REPLICAS``; the port's
``n`` defaults to the reference's 2 and reads no environment variable.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

__all__ = ["Replica", "build_fleet", "ROLES"]

ROLES = ("prefill", "decode", "mixed")


class Replica:
    """One engine in the fleet, as the router sees it."""

    def __init__(self, engine, name: str, role: str = "mixed"):
        if role not in ROLES:
            raise ValueError(f"role {role!r} (want one of {ROLES})")
        self.engine = engine
        self.name = name
        self.role = role
        self.alive = True

    def __repr__(self):
        state = "live" if self.alive else "dead"
        return f"Replica({self.name!r}, role={self.role!r}, {state})"

    def kill(self):
        """Stub-kill (the in-process stand-in for a killed replica
        process): mark dead, then hard-stop the engine — in-flight
        requests fail as they would when a real process vanished
        mid-stream, which drives the router's failover path.
        Idempotent."""
        if not self.alive:
            return
        self.alive = False
        try:
            self.engine.shutdown(drain=False)
        except Exception:
            pass  # a dying engine can't make the kill fail

    def health(self) -> dict:
        """Liveness + capacity snapshot: the router's placement input.
        A replica whose ``stats()`` raises is treated as dead — the
        fleet analogue of a probe timeout."""
        base = {"name": self.name, "role": self.role}
        if not self.alive:
            return {**base, "alive": False}
        try:
            stats = self.engine.stats()
        except Exception:
            self.alive = False
            return {**base, "alive": False}
        return {**base, "alive": True, **stats}


def build_fleet(model_fn: Callable, n: int = 2,
                roles: Optional[Sequence[str]] = None,
                warm_start_from: Optional[str] = None,
                name_prefix: str = "replica",
                **engine_kw) -> List[Replica]:
    """N engine replicas from one model factory. ``model_fn()`` is
    called once per replica (it may return the same model each time:
    see the module docstring); ``warm_start_from=`` and ``engine_kw``
    (``device=``, the pool geometry, ...) go to every
    :class:`ServingEngine`, so the whole fleet serves one checkpoint.
    ``roles`` shorter than ``n`` pads with ``mixed``."""
    from paddle_tpu_torch.serving.engine import ServingEngine

    if n < 1:
        raise ValueError("a fleet needs at least one replica")
    roles = list(roles or [])
    roles += ["mixed"] * (n - len(roles))
    return [
        Replica(ServingEngine(model_fn(), warm_start_from=warm_start_from,
                              **engine_kw),
                f"{name_prefix}{i}", role=roles[i])
        for i in range(n)]
