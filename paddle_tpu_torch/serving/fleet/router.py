"""Cache-aware multi-replica router — port of
``paddle_tpu/serving/fleet/router.py``.

:class:`FleetRouter` fronts N :class:`~.replica.Replica` engines and
duck-types the engine interface the HTTP front-end speaks
(``submit / stats / abort / start / shutdown``), so
``serving.fleet.server.RouterServer`` is ``serving.server.Server`` with
the router in the engine seat. Three policies live here:

* **Cache-aware placement** — the prompt's full blocks are chain-hashed
  (the prefix cache's digest, :func:`prompt_digests`) and scored against
  each replica's prefix *sketch* (truncated digests of every registered
  block, polled from ``stats()["prefix_cache"]["sketch"]``); the longest
  leading match wins, so shared-prefix traffic lands where its KV blocks
  already live. No match (or ``affinity=False``) falls back to
  least-loaded, scored by ``requests_in_flight`` then ``kv_headroom``.
* **Failover** — a replica that dies mid-stream (``Replica.kill``, a
  failed stats probe, a refused submit) fails its in-flight attempts;
  the router re-submits each on a survivor with ``prompt + streamed
  tokens`` as the new prompt and the remaining token budget (the
  scheduler's recompute contract: greedy decoding makes the resumed
  stream token-identical). Tokens pass a per-attempt gate, so a stale
  attempt can never duplicate a streamed token. A survivor holding the
  prefix recomputes only the tail.
* **Disaggregated prefill/decode** — prompts of at least
  ``prefill_threshold`` tokens first run on a ``prefill``-role replica,
  capped at one generated token (discarded); the finished full blocks
  are exported from its KV pools (``engine.export_kv_blocks``, keyed by
  chain hash) and imported into a ``decode``-role replica, where prefix
  admission turns them into a cache hit — the decode replica prefills
  only the sub-block tail and serves every streamed token. The records
  stay on the card when both replicas share it.

Every hop carries the request's W3C trace id: the router emits
``router_route`` / ``router_handoff`` serving spans, the replicas emit
their per-request chains, and ``trace merge --requests`` stitches one
chain spanning router, prefill replica and decode replica.

The reference reads ``PADDLE_TPU_ROUTER_AFFINITY``, ``_ROUTER_DISAGG``
and ``_ROUTER_PREFILL_THRESHOLD``; the port reads no environment
variable: the constructor's ``affinity=True``, ``disagg=True`` and
``prefill_threshold=64`` carry them.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

from paddle_tpu_torch.serving.kv_cache import PrefixCache, chain_hash

from .replica import Replica

__all__ = ["FleetRouter", "RouteHandle", "router_metrics",
           "prompt_digests"]

_route_counter = itertools.count()

_router_metrics_cache = None


def router_metrics(registry=None) -> dict:
    """The ``serving_router_*`` / ``fleet_router_*`` metric families
    (created on first use) — the router-side twin of
    ``engine.serving_metrics``."""
    global _router_metrics_cache
    if registry is None and _router_metrics_cache is not None:
        return _router_metrics_cache
    from paddle_tpu_torch.observability import get_registry
    reg = registry if registry is not None else get_registry()
    d = {
        "requests": reg.counter(
            "serving_router_requests_total",
            "requests placed by the fleet router, by decision "
            "(affinity / least_loaded / disagg_prefill / failover)"),
        "failovers": reg.counter(
            "serving_router_failovers_total",
            "mid-stream re-admissions onto a survivor after a replica "
            "died"),
        "kv_handoffs": reg.counter(
            "serving_router_kv_handoffs_total",
            "disaggregated prefill->decode KV block handoffs"),
        "kv_handoff_blocks": reg.counter(
            "serving_router_kv_handoff_blocks_total",
            "KV blocks host-staged between replicas by disaggregated "
            "handoffs"),
        "affinity_hit_rate": reg.gauge(
            "serving_router_affinity_hit_rate",
            "fraction of primary placements that matched a replica's "
            "prefix sketch (cache-aware routing effectiveness)"),
        "replicas_live": reg.gauge(
            "fleet_router_replicas_live",
            "replicas the router currently considers alive"),
        "replicas_dead": reg.gauge(
            "fleet_router_replicas_dead",
            "replicas the router has marked dead (kill/probe/submit "
            "failure)"),
    }
    if registry is None:
        _router_metrics_cache = d
    return d


def prompt_digests(tokens: Sequence[int], block_size: int) -> List[bytes]:
    """Chain hashes of every FULL block of ``tokens`` — the affinity
    key. Identical to what each replica's prefix cache registers for
    the same prompt, so digest equality means the replica holds those
    exact KV blocks."""
    out: List[bytes] = []
    parent = None
    for i in range(len(tokens) // block_size):
        parent = chain_hash(
            parent, tokens[i * block_size:(i + 1) * block_size])
        out.append(parent)
    return out


class RouteHandle:
    """Router-side request handle, duck-typing the engine's
    ``RequestHandle`` surface (``req_id`` / ``trace_id`` / ``wait`` /
    ``result``) for the HTTP front-end.

    The handle IS the failover/disaggregation state machine: every
    ``wait()`` call advances it (prefill done -> KV handoff -> decode
    submit; attempt failed -> re-place on a survivor), so the server's
    ``handle.wait(0)`` streaming poll drives recovery with no router
    thread. Tokens stream through a per-attempt gate — only the
    current attempt forwards, so a killed replica's stragglers can
    never duplicate."""

    def __init__(self, router: "FleetRouter", prompt_tokens: List[int],
                 kwargs: dict, on_token: Optional[Callable],
                 trace_id: Optional[str]):
        self.router = router
        self.req_id = next(_route_counter)
        self.trace_id = trace_id
        self.prompt_tokens = prompt_tokens
        self.kwargs = kwargs           # sampling params, max_new_tokens
        self.on_token = on_token
        self._lock = threading.RLock()
        self._done = threading.Event()
        self._emitted: List[int] = []  # tokens already streamed out
        self._attempt = None           # live engine-side RequestHandle
        self._attempt_id = 0
        self._attempt_replica: Optional[Replica] = None
        self._phase = "new"            # new|prefill|stream|done
        self._prefill_replica: Optional[Replica] = None
        self._result: Optional[dict] = None
        self._error: Optional[str] = None
        self.failovers = 0
        self.t_submit = time.perf_counter()
        self.t_first_token: Optional[float] = None
        self.t_finish: Optional[float] = None
        self._finish_reason: Optional[str] = None

    @property
    def token_ids(self) -> List[int]:
        with self._lock:
            return list(self._emitted)

    # -- token forwarding --------------------------------------------------
    def _forward(self, attempt_id: int, tok: int):
        with self._lock:
            if attempt_id != self._attempt_id or self._done.is_set():
                return  # stale attempt (failed over / finished): drop
            if self.t_first_token is None:
                self.t_first_token = time.perf_counter()
            self._emitted.append(int(tok))
            cb = self.on_token
        if cb is not None:
            try:
                cb(self, int(tok))
            except Exception:
                pass  # a broken consumer must not kill the attempt

    # -- the state machine -------------------------------------------------
    def _advance(self):
        with self._lock:
            if self._done.is_set():
                return
            if self._phase == "prefill":
                self._advance_prefill()
            elif self._phase == "stream":
                self._advance_stream()

    def _advance_prefill(self):
        h = self._attempt
        if h is None or not h.wait(0):
            return
        rep = self._attempt_replica
        try:
            h.result(0.1)
            ok = rep.alive
        except (RuntimeError, TimeoutError):
            ok = False
        records = []
        if ok:
            # export the prompt's full committed blocks, keyed by chain
            # hash — the decode replica adopts them as cache entries
            bs = self.router._block_size(rep)
            digs = prompt_digests(self.prompt_tokens, bs)
            try:
                records = rep.engine.export_kv_blocks(digs)
            except Exception:
                records = []
        else:
            self.router._mark_dead(rep)
        self._start_stream(handoff_from=rep if records else None,
                           records=records)

    def _advance_stream(self):
        h = self._attempt
        if h is None or not h.wait(0):
            return
        rep = self._attempt_replica
        try:
            res = h.result(0.1)
        except (RuntimeError, TimeoutError) as e:
            if rep is not None and (not rep.alive
                                    or "shut down" in str(e)
                                    or "step failed" in str(e)):
                # the replica died under the request: re-admit the tail
                # on a survivor (recompute semantics — greedy-identical)
                self.router._mark_dead(rep)
                self.failovers += 1
                self.router._m["failovers"].inc()
                try:
                    self._start_stream(failover=True)
                except RuntimeError as e2:  # no survivor left
                    self._fail(f"failover exhausted: {e2}")
                return
            self._fail(str(e))
            return
        self._finish_reason = res.get("finish_reason")
        self._finalize()

    def _start_stream(self, handoff_from: Optional[Replica] = None,
                      records: Sequence[tuple] = (),
                      failover: bool = False):
        """(Re)submit the request body on a serving replica. Called
        under the handle lock from _advance, or once at creation (via
        FleetRouter.submit) before the handle escapes."""
        done = len(self._emitted)
        prompt = self.prompt_tokens + self._emitted
        remaining = self.kwargs["max_new_tokens"] - done
        if remaining <= 0:
            # the dead replica delivered every budgeted token before
            # failing; nothing is left to recompute
            self._finish_reason = self._finish_reason or "length"
            self._finalize()
            return
        decision = "failover" if failover else None
        rep, dec = self.router._place_serving(prompt)
        if decision is None:
            decision = dec
        if records:
            t0 = time.perf_counter_ns()
            adopted = rep.engine.import_kv_blocks(records)
            self.router._m["kv_handoffs"].inc()
            self.router._m["kv_handoff_blocks"].inc(adopted)
            self.router._span("router_handoff", t0,
                              args={"trace": self.trace_id,
                                    "req": self.req_id,
                                    "from": handoff_from.name,
                                    "to": rep.name, "blocks": adopted})
        aid = self._attempt_id + 1
        self._attempt_id = aid
        self._attempt_replica = rep
        self._phase = "stream"
        t0 = time.perf_counter_ns()
        kw = dict(self.kwargs)
        kw["max_new_tokens"] = remaining
        self._attempt = self.router._submit_on(
            rep, prompt, kw,
            on_token=lambda seq, tok: self._forward(aid, tok),
            trace_id=self.trace_id)
        self.router._note_decision(decision)
        self.router._span("router_route", t0,
                          args={"trace": self.trace_id, "req": self.req_id,
                                "replica": rep.name, "decision": decision,
                                "attempt": aid})

    def _start_prefill(self, rep: Replica):
        """Disaggregated first hop: run the whole prompt on a prefill
        replica, capped at ONE generated token (it exists only to
        complete the prompt's prefill; the sampled token is discarded —
        the decode replica regenerates it, greedy-identical)."""
        self._phase = "prefill"
        self._attempt_replica = rep
        kw = dict(self.kwargs)
        kw["max_new_tokens"] = 1
        kw["temperature"] = 0.0
        kw["eos_token_id"] = None
        t0 = time.perf_counter_ns()
        self._attempt = self.router._submit_on(
            rep, list(self.prompt_tokens), kw, on_token=None,
            trace_id=self.trace_id)
        self.router._note_decision("disagg_prefill")
        self.router._span("router_route", t0,
                          args={"trace": self.trace_id, "req": self.req_id,
                                "replica": rep.name,
                                "decision": "disagg_prefill"})

    def _fail(self, error: str):
        self._error = error
        self.t_finish = time.perf_counter()
        self._done.set()
        self.router._retire(self)

    def _finalize(self):
        self.t_finish = time.perf_counter()
        self._result = {
            "request_id": self.req_id,
            "trace_id": self.trace_id,
            "token_ids": list(self._emitted),
            "num_generated": len(self._emitted),
            "prompt_len": len(self.prompt_tokens),
            "finish_reason": self._finish_reason,
            "preemptions": self.failovers,
            "ttft_s": (None if self.t_first_token is None
                       else self.t_first_token - self.t_submit),
            "latency_s": self.t_finish - self.t_submit,
            "failovers": self.failovers,
        }
        self._done.set()
        self.router._retire(self)

    # -- engine-handle surface --------------------------------------------
    def wait(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        while True:
            self._advance()
            if self._done.is_set():
                return True
            now = time.monotonic()
            if deadline is not None and now >= deadline:
                return False
            step = 0.05 if deadline is None \
                else max(min(0.05, deadline - now), 0.001)
            h = self._attempt
            if h is not None:
                h.wait(step)
            else:
                time.sleep(min(step, 0.01))

    def result(self, timeout: Optional[float] = None) -> dict:
        if not self.wait(timeout):
            raise TimeoutError(
                f"request {self.req_id} not finished in {timeout}s")
        if self._error is not None:
            raise RuntimeError(
                f"request {self.req_id} failed: {self._error}")
        return dict(self._result)

    def abort(self, reason: str = "aborted") -> bool:
        with self._lock:
            if self._done.is_set():
                return False
            rep, h = self._attempt_replica, self._attempt
            self._fail(reason)
        # engine abort OUTSIDE the handle lock: the engine's loop
        # thread takes (engine lock -> handle lock) through on_token;
        # holding the handle lock while acquiring the engine lock here
        # would be the reverse order. _done is already set, so a token
        # emitted in the gap is dropped by the attempt gate.
        if rep is not None and h is not None:
            try:
                rep.engine.abort(h.req_id, reason=reason)
            except Exception:
                pass
        return True


class FleetRouter:
    """Cache-aware router over N replicas; engine-interface compatible
    (see module docstring). ``affinity``: sketch-based placement (off =
    pure least-loaded); ``disagg``: disaggregated prefill/decode when
    prefill-role replicas exist; ``prefill_threshold``: the shortest
    prompt (tokens) that takes the disaggregated path."""

    def __init__(self, replicas: Sequence[Replica], affinity: bool = True,
                 disagg: bool = True, prefill_threshold: int = 64):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        self.replicas = list(replicas)
        names = [r.name for r in self.replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        self.affinity = bool(affinity)
        self.disagg = bool(disagg)
        self.prefill_threshold = int(prefill_threshold)
        self._lock = threading.RLock()
        self._handles = {}  # router req_id -> RouteHandle (in flight)
        self._m = router_metrics()
        #: routing-decision counters (the /fleetz view; the registry
        #: counter families mirror them)
        self.decisions = {"affinity": 0, "least_loaded": 0,
                          "disagg_prefill": 0, "failover": 0}
        self._update_liveness_gauges()

    # -- liveness ----------------------------------------------------------
    def _live(self, roles: Tuple[str, ...]) -> List[Replica]:
        return [r for r in self.replicas if r.alive and r.role in roles]

    def _mark_dead(self, rep: Replica):
        if rep.alive:
            rep.kill()
        self._update_liveness_gauges()

    def _update_liveness_gauges(self):
        live = sum(1 for r in self.replicas if r.alive)
        self._m["replicas_live"].set(live)
        self._m["replicas_dead"].set(len(self.replicas) - live)

    # -- placement ---------------------------------------------------------
    @staticmethod
    def _block_size(rep: Replica) -> int:
        return rep.engine.cache.block_size

    def _place_serving(
            self, prompt: Sequence[int]) -> Tuple[Replica, str]:
        """Pick the replica that serves (prefills the tail of + decodes)
        this prompt: sketch affinity first, least-loaded fallback."""
        cands = []
        for r in self._live(("mixed", "decode")):
            h = r.health()
            if h.get("alive"):
                cands.append((r, h))
        self._update_liveness_gauges()
        if not cands:
            raise RuntimeError("no live serving replica")
        if self.affinity:
            best, best_score = None, 0
            trunc = PrefixCache.SKETCH_PREFIX_BYTES
            by_rep = {}
            for r, h in cands:
                sk = set((h.get("prefix_cache") or {}).get("sketch") or [])
                score = 0
                for d in prompt_digests(prompt, self._block_size(r)):
                    if d[:trunc].hex() not in sk:
                        break  # chain hashes: the leading run is what
                    score += 1  # admission can actually reuse
                by_rep[r.name] = score
                if score > best_score:
                    best, best_score = r, score
            if best is not None:
                return best, "affinity"
        # least-loaded: fewest in-flight requests, then most KV headroom
        rep, _ = min(
            cands, key=lambda rh: (rh[1].get("requests_in_flight", 0),
                                   -rh[1].get("kv_headroom", 0.0)))
        return rep, "least_loaded"

    def _place_prefill(self, prompt: Sequence[int]) -> Optional[Replica]:
        """A live prefill-role replica for the disaggregated first hop
        (least-loaded among them); None disables disaggregation for
        this request."""
        cands = []
        for r in self._live(("prefill",)):
            h = r.health()
            if h.get("alive"):
                cands.append((r, h))
        if not cands:
            return None
        rep, _ = min(
            cands, key=lambda rh: (rh[1].get("requests_in_flight", 0),
                                   -rh[1].get("kv_headroom", 0.0)))
        return rep

    def _note_decision(self, decision: str):
        with self._lock:
            self.decisions[decision] = self.decisions.get(decision, 0) + 1
            placed = (self.decisions["affinity"]
                      + self.decisions["least_loaded"])
            if placed:
                self._m["affinity_hit_rate"].set(
                    self.decisions["affinity"] / placed)
        self._m["requests"].inc(decision=decision)

    def _submit_on(self, rep: Replica, prompt: List[int], kw: dict,
                   on_token, trace_id):
        """Submit on one replica; a refusal (engine already shut down)
        marks it dead and bubbles as RuntimeError for the caller's
        re-placement loop."""
        try:
            return rep.engine.submit(
                prompt, max_new_tokens=kw["max_new_tokens"],
                temperature=kw.get("temperature", 0.0),
                top_k=kw.get("top_k", 0), top_p=kw.get("top_p", 1.0),
                eos_token_id=kw.get("eos_token_id"),
                on_token=on_token, trace_id=trace_id,
                adapter_id=kw.get("adapter_id", 0))
        except RuntimeError:
            self._mark_dead(rep)
            raise

    def _span(self, name: str, t0_ns: int, args: dict):
        from paddle_tpu_torch.observability import trace
        if trace.active() is not None:
            trace.span("serving", name, t0_ns, time.perf_counter_ns(),
                       args=args)

    def _retire(self, handle: RouteHandle):
        with self._lock:
            self._handles.pop(handle.req_id, None)

    # -- engine interface --------------------------------------------------
    def submit(self, prompt_tokens: Sequence[int],
               max_new_tokens: int = 32, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0,
               eos_token_id: Optional[int] = None,
               on_token: Optional[Callable] = None,
               trace_id: Optional[str] = None,
               adapter_id: int = 0) -> RouteHandle:
        """Place and start a request; returns a handle whose ``wait``
        drives failover/handoff (engine-``submit``-compatible).
        ``adapter_id`` rides to whichever replica the request lands on
        (every replica of a multi-tenant fleet serves the same slot
        layout — the warm-start seam replicates adapters like weights)."""
        from paddle_tpu_torch.observability import requests as obs_requests
        prompt_tokens = [int(t) for t in prompt_tokens]
        if not prompt_tokens:
            raise ValueError("empty prompt")
        kw = {"max_new_tokens": int(max_new_tokens),
              "temperature": float(temperature), "top_k": int(top_k),
              "top_p": float(top_p), "eos_token_id": eos_token_id,
              "adapter_id": int(adapter_id)}
        handle = RouteHandle(self, prompt_tokens, kw, on_token,
                             trace_id or obs_requests.new_trace_id())
        pre = None
        if self.disagg and len(prompt_tokens) >= self.prefill_threshold:
            pre = self._place_prefill(prompt_tokens)
        # retry placement until a submit sticks — a replica dying
        # between health() and submit() must not fail the request
        # while survivors exist
        while True:
            try:
                if pre is not None:
                    handle._start_prefill(pre)
                else:
                    handle._start_stream()
                break
            except RuntimeError:
                if pre is not None:
                    pre = self._place_prefill(prompt_tokens)
                    continue
                if not self._live(("mixed", "decode")):
                    raise
        with self._lock:
            self._handles[handle.req_id] = handle
        return handle

    def abort(self, req_id: int, reason: str = "aborted") -> bool:
        with self._lock:
            handle = self._handles.get(req_id)
        if handle is None:
            return False
        return handle.abort(reason)

    def start(self):
        for r in self.replicas:
            if r.alive:
                r.engine.start()

    def drain(self, timeout: Optional[float] = None):
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        while True:
            with self._lock:
                handles = list(self._handles.values())
            if not handles:
                return
            t = None if deadline is None \
                else max(deadline - time.monotonic(), 0.0)
            if t == 0.0:
                raise TimeoutError("fleet drain timed out")
            handles[0].wait(0.2 if t is None else min(t, 0.2))

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None):
        if drain:
            self.drain(timeout)
        for r in self.replicas:
            if r.alive:
                try:
                    r.engine.shutdown(drain=drain, timeout=timeout)
                except Exception:
                    pass

    # -- introspection -----------------------------------------------------
    def saturated(self, max_queue_depth: Optional[int]) -> bool:
        """The router-level shed condition: EVERY live serving replica's
        queue is at/over the depth limit (or nothing is alive) — one
        replica with room means the fleet can still absorb the
        request."""
        if max_queue_depth is None:
            return not self._live(("mixed", "decode"))
        reps = self._live(("mixed", "decode"))
        if not reps:
            return True
        for r in reps:
            h = r.health()
            if h.get("alive") and h.get("waiting", 0) < max_queue_depth:
                return False
        return True

    def stats(self) -> dict:
        """Aggregate engine-``stats()``-shaped snapshot (the /healthz
        payload): fleet sums for occupancy, the WORST live headroom
        (the shed-relevant number), and the routing counters."""
        per = [r.health() for r in self.replicas]
        live = [h for h in per if h.get("alive")]
        self._update_liveness_gauges()
        with self._lock:
            decisions = dict(self.decisions)
            in_flight = len(self._handles)
        placed = decisions["affinity"] + decisions["least_loaded"]
        return {
            "replicas": len(self.replicas),
            "replicas_live": len(live),
            "replicas_dead": len(self.replicas) - len(live),
            "running": sum(h.get("running", 0) for h in live),
            "waiting": sum(h.get("waiting", 0) for h in live),
            "requests_in_flight": in_flight,
            "kv_headroom": (min(h.get("kv_headroom", 0.0) for h in live)
                            if live else 0.0),
            "routing": decisions,
            "affinity_hit_rate": round(
                decisions["affinity"] / placed, 4) if placed else None,
            "failovers": decisions["failover"],
            "disagg": self.disagg,
            "affinity": self.affinity,
            "prefill_threshold": self.prefill_threshold,
        }

    def fleetz(self) -> dict:
        """The /fleetz payload: ``stats()`` plus the full per-replica
        health table (occupancy, headroom, prefix-cache hit rates —
        each replica's /healthz fields, aggregated in one place)."""
        per = []
        for r in self.replicas:
            h = r.health()
            pc = h.pop("prefix_cache", None) or {}
            h.pop("sketch", None)
            if pc:
                h["prefix_cache_entries"] = pc.get("entries")
                h["prefix_cache_hit_rate"] = pc.get("hit_rate")
            per.append(h)
        return {**self.stats(), "per_replica": per}
