"""Continuous-batching scheduler — port of ``paddle_tpu/serving/scheduler.py``.

FCFS admission, token-budget packing of mixed prefill+decode steps, and
preemption-by-recompute. Each engine iteration asks for a
:class:`StepPlan` that packs work into the engine's fixed
``step_tokens`` budget: every running sequence decodes one token
(decode is planned first, so a long prefill never starves running
decoders), then prefill chunks fill the remaining budget FCFS, each
capped at ``prefill_chunk`` tokens.

Prefix-cache-aware admission: a request entering a slot first claims
its prompt's longest registered full-block prefix; a fully cached
prompt is capped at ``len(prompt) - 1`` matched tokens and its last
matched block becomes a copy-on-write source (``cow_src``) that the
engine copies into a private block before the step runs.

When the block pool can't cover an allocation, the sequence with the
latest arrival is preempted: its blocks are freed and it re-enters the
queue with ``prompt + generated`` as its new prefill text, so greedy
output is identical to the unpreempted run. Host Python, ported
verbatim with the reference's observability hooks: a request carries
its W3C ``trace_id`` and its first admission time (``slot_time``), the
request ledger's occupancy integral is closed right before preempt and
finish free the blocks, and a preemption is marked in the span trace. A
request's ``adapter_id`` and ``cache_seed`` (its LoRA slot and the
prefix-cache namespace of that slot's load) ride along.
"""
from __future__ import annotations

import bisect
import itertools
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, List, Optional, Tuple

from .kv_cache import PagedKVCache

__all__ = ["RequestState", "Request", "StepPlan", "Scheduler"]

_req_counter = itertools.count()


class RequestState(Enum):
    WAITING = "waiting"    # queued (fresh or preempted), no slot
    PREFILL = "prefill"    # slot assigned, prompt not fully cached
    RUNNING = "running"    # decoding one token per engine step
    FINISHED = "finished"
    FAILED = "failed"


@dataclass
class Request:
    """One generation request plus its runtime sequence state."""

    prompt_tokens: List[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_token_id: Optional[int] = None
    #: per-token streaming callback ``(request, token_id) -> None``
    on_token: Optional[Callable] = None
    req_id: int = field(default_factory=lambda: next(_req_counter))
    arrival_time: float = field(default_factory=time.perf_counter)
    #: W3C trace id (32 lowercase hex) — client-supplied via
    #: ``traceparent`` or minted at submit; stamped into every span of
    #: this request so ``trace merge --requests`` can stitch its chain
    trace_id: Optional[str] = None
    #: LoRA adapter slot applied to this request's rows (0 = base model)
    adapter_id: int = 0

    # -- runtime state (engine/scheduler managed) --------------------------
    state: RequestState = RequestState.WAITING
    slot: Optional[int] = None
    block_ids: List[int] = field(default_factory=list)
    #: first admission into a batch slot — the end of the queue-wait span
    slot_time: Optional[float] = None
    #: tokens to (re)prefill — the prompt, or prompt+generated after a
    #: preemption (recompute)
    pending_tokens: List[int] = field(default=None)
    prefill_pos: int = 0     # pending tokens already cached
    num_cached: int = 0      # total tokens written to the KV cache
    generated: List[int] = field(default_factory=list)
    # -- prefix-cache state ------------------------------------------------
    #: prompt tokens recovered from the prefix cache at the LAST admission
    cached_prompt_tokens: int = 0
    #: prompt tokens actually prefilled over the request's whole life
    #: (incl. preemption recompute)
    prefilled_tokens: int = 0
    #: lifetime accumulators across every admission: pending-token demand
    #: and cache-matched tokens
    admitted_pending_total: int = 0
    cached_tokens_total: int = 0
    #: full blocks already registered in the prefix index + the chain
    #: digest of the last one (the next block's hash parent)
    committed_blocks: int = 0
    committed_hash: Optional[bytes] = None
    #: prefix-cache chain root: non-base adapters hash their blocks under
    #: an adapter-specific seed so one tenant's KV never answers another's
    cache_seed: Optional[bytes] = None
    #: copy-on-write: claimed source block + the logical index of the
    #: private destination block the engine copies it into pre-step
    cow_src: Optional[int] = None
    cow_index: Optional[int] = None
    first_token_time: Optional[float] = None
    last_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    preemptions: int = 0
    finish_reason: Optional[str] = None
    error: Optional[str] = None

    def __post_init__(self):
        self.prompt_tokens = [int(t) for t in self.prompt_tokens]
        if self.pending_tokens is None:
            self.pending_tokens = list(self.prompt_tokens)

    @property
    def done(self) -> bool:
        return self.state in (RequestState.FINISHED, RequestState.FAILED)

    def last_token(self) -> int:
        """The decode-step input: the newest sampled, not-yet-cached
        token (prefill completion always samples one before decoding)."""
        return self.generated[-1]

    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    def latency(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time


@dataclass
class StepPlan:
    #: prefill chunks packed into this step's token budget, FCFS order:
    #: (sequence, number of prompt tokens to prefill)
    prefills: List[Tuple[Request, int]] = field(default_factory=list)
    #: running sequences to advance one decode token
    decode: List[Request] = field(default_factory=list)

    @property
    def empty(self) -> bool:
        return not self.prefills and not self.decode

    @property
    def total_tokens(self) -> int:
        return len(self.decode) + sum(n for _, n in self.prefills)


class Scheduler:
    """FCFS continuous-batching policy over ``max_batch`` engine slots
    and a ``step_tokens`` per-step token budget."""

    def __init__(self, cache: PagedKVCache, max_batch: int,
                 prefill_chunk: int, step_tokens: Optional[int] = None):
        if prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.cache = cache
        self.max_batch = max_batch
        self.prefill_chunk = prefill_chunk
        # default budget: every decode slot plus one full chunk
        self.step_tokens = int(step_tokens if step_tokens is not None
                               else max_batch + prefill_chunk)
        if self.step_tokens < max_batch + 1:
            raise ValueError(
                f"step_tokens {self.step_tokens} can't cover "
                f"{max_batch} decode slots plus any prefill")
        self.waiting: List[Request] = []   # sorted by arrival_time
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.num_preemptions = 0

    # -- queue state -------------------------------------------------------
    def slotted(self) -> List[Request]:
        return [s for s in self.slots if s is not None]

    @property
    def num_waiting(self) -> int:
        return len(self.waiting)

    @property
    def num_running(self) -> int:
        return len(self.slotted())

    def has_work(self) -> bool:
        return bool(self.waiting or self.slotted())

    def add(self, req: Request):
        """FCFS enqueue (kept sorted by arrival so a preempted earlier
        request resumes ahead of later arrivals)."""
        bisect.insort(self.waiting, req, key=lambda r: r.arrival_time)

    # -- planning ----------------------------------------------------------
    def schedule(self) -> StepPlan:
        """Admit, collect the decode batch, then pack prefill chunks
        into the remaining token budget (preempting by recompute where
        the block pool falls short). A plan entry whose sequence a later
        allocation of the same plan preempted turns stale; the engine
        filters on slot/state before acting."""
        self._admit()
        plan = StepPlan()
        plan.decode = self._plan_decode()
        plan.prefills = self._plan_prefills(
            self.step_tokens - len(plan.decode))
        return plan

    def _admit(self):
        for i, s in enumerate(self.slots):
            if s is not None or not self.waiting:
                continue
            req = self.waiting.pop(0)
            req.slot = i
            self.slots[i] = req
            req.state = RequestState.PREFILL
            if req.slot_time is None:
                req.slot_time = time.perf_counter()
            req.admitted_pending_total += len(req.pending_tokens)
            self._prefix_admit(req)

    def _prefix_admit(self, seq: Request):
        """Match the longest cached prefix of ``seq.pending_tokens`` and
        seed its block table with the claimed blocks. Fully-cached
        prompts are capped at ``len - 1`` tokens (the last token must
        prefill to produce sampling logits); the cap lands mid-block, so
        the final matched block turns into a held COW source instead of
        a table entry."""
        pc = self.cache.prefix_cache
        if pc is None or seq.block_ids:
            return
        tokens = seq.pending_tokens
        if len(tokens) <= self.cache.block_size:
            return  # no full block can match under the one-token cap
        blocks, digests = pc.match(tokens, seed=seq.cache_seed)
        if not blocks:
            return
        matched = len(blocks) * self.cache.block_size
        if matched >= len(tokens):
            # fully-cached aligned prompt: the last matched block is the
            # COW source (we hold its claimed reference until the engine
            # copies it); usable cache shrinks to len - 1 tokens
            seq.cow_src = blocks.pop()
            seq.cow_index = len(blocks)
            matched = len(tokens) - 1
        seq.block_ids = blocks
        seq.prefill_pos = matched
        seq.num_cached = matched
        seq.cached_tokens_total += matched
        seq.cached_prompt_tokens = matched
        seq.committed_blocks = len(blocks)
        seq.committed_hash = (digests[len(blocks) - 1] if blocks
                              else seq.cache_seed)
        pc.hit_tokens += matched

    def _release_cow(self, seq: Request):
        """Drop a held COW source reference (preempt/finish/abort before
        the engine performed the copy — or after: the engine clears
        ``cow_src`` once the copy ran)."""
        if seq.cow_src is not None:
            self.cache.allocator.free([seq.cow_src])
            seq.cow_src = None
        seq.cow_index = None

    def _plan_prefills(self, budget: int) -> List[Tuple[Request, int]]:
        """FCFS prefill packing: each PREFILL-state sequence gets up to
        ``prefill_chunk`` tokens, as many sequences as the budget covers.
        Stops at the first sequence the pool can't serve even after
        preemption, keeping FCFS order under pressure."""
        out: List[Tuple[Request, int]] = []
        cands = sorted((s for s in self.slotted()
                        if s.state is RequestState.PREFILL),
                       key=lambda r: r.arrival_time)
        for seq in cands:
            if budget <= 0:
                break
            if seq.slot is None or seq.state is not RequestState.PREFILL:
                # preempted mid-loop by a senior candidate's allocation
                continue
            n = min(self.prefill_chunk, budget,
                    len(seq.pending_tokens) - seq.prefill_pos)
            if n <= 0:
                continue
            if not self._ensure_blocks(seq, seq.prefill_pos + n):
                break  # pool contended; retry later, keep FCFS order
            out.append((seq, n))
            budget -= n
        return out

    def _plan_decode(self) -> List[Request]:
        batch = []
        # earliest arrivals first: preemption victims come from the tail,
        # so a seq preempted mid-planning is simply never reached
        for seq in sorted(self.slotted(), key=lambda r: r.arrival_time):
            if seq.state is not RequestState.RUNNING or seq.slot is None:
                continue
            if self._ensure_blocks(seq, seq.num_cached + 1):
                batch.append(seq)
        return batch

    # -- block management --------------------------------------------------
    def _ensure_blocks(self, seq: Request, total_tokens: int) -> bool:
        """Grow ``seq``'s block table to cover ``total_tokens`` cached
        positions, preempting latest-arrival sequences as needed.
        Victims are always strictly younger than ``seq``."""
        alloc = self.cache.allocator
        need = self.cache.blocks_for(total_tokens) - len(seq.block_ids)
        if need <= 0:
            return True
        while not alloc.can_allocate(need):
            victim = self._pick_victim(after=seq)
            if victim is None:
                holders = [s for s in self.slotted()
                           if s is not seq and s.block_ids]
                if (holders and seq.slot is not None and seq.block_ids
                        and all(h.arrival_time < seq.arrival_time
                                for h in holders)):
                    # only FCFS-senior sequences hold the pool: hand our
                    # blocks back so the head can finish sooner
                    self.preempt(seq)
                return False
            self.preempt(victim)
        seq.block_ids.extend(alloc.allocate(need))
        return True

    def _pick_victim(self, after: Request) -> Optional[Request]:
        """Latest-arrival slotted sequence strictly younger than
        ``after``."""
        cands = [s for s in self.slotted()
                 if s is not after and s.block_ids
                 and s.arrival_time > after.arrival_time]
        if not cands:
            return None
        return max(cands, key=lambda r: r.arrival_time)

    def preempt(self, seq: Request):
        """Preemption-by-recompute: free every block, requeue with
        prompt+generated as the new prefill text. With the prefix cache
        on, the freed committed blocks park as reclaimable, and
        readmission recomputes only the uncached tail."""
        from ..observability import requests as obs_requests
        from ..observability import trace
        led = obs_requests._active
        if led is not None:
            # close out the occupancy interval at the pre-free level —
            # the request holds zero blocks until readmission
            led.note_occupancy(seq, time.monotonic())
        self._release_cow(seq)
        self.cache.allocator.free(seq.block_ids)
        seq.block_ids = []
        self.release_slot(seq)
        seq.pending_tokens = list(seq.prompt_tokens) + list(seq.generated)
        seq.prefill_pos = 0
        seq.num_cached = 0
        seq.committed_blocks = 0
        seq.committed_hash = seq.cache_seed
        seq.cached_prompt_tokens = 0
        seq.state = RequestState.WAITING
        seq.preemptions += 1
        self.num_preemptions += 1
        trace.mark("serving", "preempted",
                   args={"req": seq.req_id, "trace": seq.trace_id,
                         "preemptions": seq.preemptions,
                         "generated": len(seq.generated)})
        self.add(seq)

    def release_slot(self, seq: Request):
        if seq.slot is not None:
            self.slots[seq.slot] = None
            seq.slot = None

    def finish(self, seq: Request, state: RequestState,
               reason: str = "stop"):
        """Return every resource; the engine records metrics and runs
        the callbacks. Registered blocks park in the reclaimable tier."""
        from ..observability import requests as obs_requests
        led = obs_requests._active
        if led is not None:
            # bill the final holding interval before the blocks go back
            led.note_occupancy(seq, time.monotonic())
        self._release_cow(seq)
        self.cache.allocator.free(seq.block_ids)
        seq.block_ids = []
        self.release_slot(seq)
        seq.state = state
        seq.finish_reason = reason
        seq.finish_time = time.perf_counter()
