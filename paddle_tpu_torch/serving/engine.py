"""Continuous-batching serving engine over a block-paged KV cache — port
of ``paddle_tpu/serving/engine.py``.

``ServingEngine`` keeps a fixed ``max_batch``-slot layout and swaps
finished slots for queued requests between steps. Every iteration runs
one **unified step** over a token-packed ragged batch: a flat
``[1, step_tokens]`` axis holding all live decode slots (one token
each) plus as many prefill chunks as the budget covers, back to back.
Attention reads go through the ragged-paged-attention kernel
(``ops/pallas/ragged_paged_attention.py``) unless the engine is built
with ``attn_impl="gather"``.

What differs from the reference: PyTorch runs the step eagerly, so
there is no compiled executable and no trace counter — ``stats()``
reports the number of ``steps`` and the kernel's ``rpa_launches``
instead; the KV pools are updated in place rather than threaded
through the step; and the reference's quantisation, int8 KV, LoRA
slots, tensor-parallel ``mesh=``, warm start, metrics, request ledger,
numerics taps and fleet KV handoff are not ported yet (their
constructor arguments raise ``NotImplementedError``).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.models.generation import decode_surfaces, sample_token
from paddle_tpu_torch.ops.paged_attention import RaggedLayerCache
from paddle_tpu_torch.ops.pallas.ragged_paged_attention import (
    DEFAULT_TILE_Q, build_step_maps, ragged_paged_attention, rpa_max_steps)

from .kv_cache import PagedKVCache, chain_hash
from .scheduler import Request, RequestState, Scheduler

__all__ = ["ServingEngine", "RequestHandle"]


class RequestHandle:
    """Caller-side view of a submitted request (thread-safe wait)."""

    def __init__(self, req: Request):
        self._req = req
        self._done = threading.Event()

    @property
    def req_id(self) -> int:
        return self._req.req_id

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> dict:
        """Block until finished; raises on request failure/timeout."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self._req.req_id} not finished in {timeout}s")
        r = self._req
        if r.state is RequestState.FAILED:
            raise RuntimeError(f"request {r.req_id} failed: {r.error}")
        return {
            "request_id": r.req_id,
            "token_ids": list(r.generated),
            "num_generated": len(r.generated),
            "prompt_len": len(r.prompt_tokens),
            "finish_reason": r.finish_reason,
            "preemptions": r.preemptions,
            "ttft_s": r.ttft(),
            "latency_s": r.latency(),
        }


class ServingEngine:
    """Continuous-batching inference over a causal LM that speaks the
    ragged ``caches=`` protocol (``models.llama``). Runs on the card
    unless ``device="cpu"``; the model must already live on that
    device."""

    def __init__(self, model, max_batch: int = 8, max_blocks: int = 64,
                 block_size: int = 16, prefill_chunk: int = 16,
                 max_blocks_per_seq: Optional[int] = None,
                 warm_start_from: Optional[str] = None,
                 attn_impl: Optional[str] = None,
                 prefix_cache: Optional[bool] = None,
                 mesh=None, quantize: Optional[str] = None,
                 kv_dtype: Optional[str] = None, calibration=None,
                 device=None):
        for name, val in (("warm_start_from", warm_start_from),
                          ("mesh", mesh), ("quantize", quantize),
                          ("kv_dtype", kv_dtype),
                          ("calibration", calibration)):
            if val is not None:
                raise NotImplementedError(
                    f"ServingEngine({name}=...) is not ported to "
                    f"paddle_tpu_torch yet")
        if getattr(model, "_lora_slots", 0):
            raise NotImplementedError(
                "LoRA adapter slots are not ported to paddle_tpu_torch yet")
        self.device = resolve_device(device)
        model_dev = next(iter(model.parameters())).device
        if model_dev.type != self.device.type or (
                self.device.index is not None
                and model_dev.index != self.device.index):
            raise ValueError(
                f"model lives on {model_dev} but the engine runs on "
                f"{self.device}; build the model on the engine's device")
        model.eval()
        self.model = model
        cfg = model.cfg
        self._backbone, self._project, dtype = decode_surfaces(model)

        nl = cfg.num_hidden_layers
        n_kv = cfg.num_key_value_heads
        hd = cfg.hidden_size // cfg.num_attention_heads
        #: block-granular prefix-cache KV reuse — on by default;
        #: prefix_cache=False is the bit-parity oracle
        self.prefix_cache_enabled = True if prefix_cache is None \
            else bool(prefix_cache)
        max_pos = cfg.max_position_embeddings
        if max_blocks_per_seq is None:
            max_blocks_per_seq = min(max_blocks, -(-max_pos // block_size))
        self.cache = PagedKVCache(nl, max_blocks, block_size, n_kv, hd,
                                  max_blocks_per_seq, dtype=dtype,
                                  device=self.device,
                                  prefix_cache=self.prefix_cache_enabled)
        self.max_model_len = min(self.cache.max_seq_len, max_pos)
        self.max_batch = int(max_batch)
        self.prefill_chunk = int(prefill_chunk)
        #: attention read path: the RPA kernel, or the gather path only
        #: when asked for by name
        self.attn_impl = "rpa" if attn_impl is None else attn_impl
        if self.attn_impl not in ("rpa", "gather"):
            raise ValueError(
                f"attn_impl {self.attn_impl!r} (want rpa|gather)")
        # unified-step geometry: the flat token budget covers every
        # decode slot plus one full prefill chunk, rounded up to the RPA
        # kernel's q-tile height; max_steps is the static per-tile
        # work-list bound
        self._tile_q = DEFAULT_TILE_Q
        budget = self.max_batch + self.prefill_chunk
        self.step_tokens = -(-budget // self._tile_q) * self._tile_q
        self._max_steps = rpa_max_steps(
            self._tile_q, self.cache.max_blocks_per_seq, self.max_batch)
        # all-sentinel work lists for the gather path, which ignores them
        n_tiles = self.step_tokens // self._tile_q
        self._null_step_maps = (
            np.full((n_tiles, self._max_steps), self.max_batch, np.int32),
            np.zeros((n_tiles, self._max_steps), np.int32))
        self.scheduler = Scheduler(self.cache, self.max_batch,
                                   self.prefill_chunk,
                                   step_tokens=self.step_tokens)
        #: unified steps run so far
        self.steps = 0
        # temperature > 0 draws; greedy requests never touch it
        self._generator = torch.Generator().manual_seed(0)

        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._shutdown = False
        self._handles = {}  # req_id -> RequestHandle

    # -- submission --------------------------------------------------------
    def submit(self, prompt_tokens: Sequence[int], max_new_tokens: int = 32,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               eos_token_id: Optional[int] = None,
               on_token: Optional[Callable] = None) -> RequestHandle:
        """Enqueue a request; returns immediately with a handle. Tokens
        stream through ``on_token(request, token_id)`` as they decode."""
        prompt_tokens = list(prompt_tokens)
        if not prompt_tokens:
            raise ValueError("empty prompt")
        # an id outside the vocabulary would reach the embedding lookup,
        # whose device-side assert on the card ends every request
        vocab = self.model.cfg.vocab_size
        bad = [t for t in prompt_tokens if not 0 <= t < vocab]
        if bad:
            raise ValueError(f"prompt ids must lie in [0, {vocab}), got "
                             f"{bad[:4]}")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = len(prompt_tokens) + max_new_tokens
        if total > self.max_model_len:
            raise ValueError(
                f"prompt+max_new_tokens = {total} exceeds the engine's "
                f"max sequence length {self.max_model_len}")
        need = self.cache.blocks_for(total)
        if need > min(self.cache.allocator.capacity,
                      self.cache.max_blocks_per_seq):
            raise ValueError(
                f"request needs {need} KV blocks but the engine has "
                f"{self.cache.allocator.capacity} (table width "
                f"{self.cache.max_blocks_per_seq}) — raise max_blocks or "
                "shorten the request")
        req = Request(prompt_tokens=prompt_tokens,
                      max_new_tokens=int(max_new_tokens),
                      temperature=float(temperature), top_k=int(top_k),
                      top_p=float(top_p), eos_token_id=eos_token_id,
                      on_token=on_token)
        handle = RequestHandle(req)
        with self._cv:
            if self._shutdown:
                raise RuntimeError("engine is shut down")
            self._handles[req.req_id] = handle
            self.scheduler.add(req)
            self._cv.notify_all()
        return handle

    # -- one engine iteration ----------------------------------------------
    def step(self) -> bool:
        """Plan + run one unified token-packed step (all live decode
        slots + the packed prefill chunks). Returns whether any work
        happened."""
        with self._lock:
            plan = self.scheduler.schedule()
            # never act on a sequence that lost its slot/blocks during
            # planning (a later allocation in the same plan may have
            # preempted it)
            decode = [s for s in plan.decode
                      if s.slot is not None
                      and s.state is RequestState.RUNNING]
            prefills = [(s, n) for (s, n) in plan.prefills
                        if s.slot is not None
                        and s.state is RequestState.PREFILL]
            if decode or prefills:
                self._run_unified(decode, prefills)
            return bool(decode or prefills)

    def _run_unified(self, decode: List[Request],
                     prefills: List[tuple]):
        """Pack the planned work into the flat token budget, build the
        step's ragged metadata (token->sequence map, per-token positions,
        the RPA kernel's work lists) host-side, run the model once, and
        harvest per-sequence results."""
        # copy-on-write divergence: a fully-cached aligned prompt's last
        # matched block is copied into the sequence's private block
        # BEFORE the step, so the final-token write lands in owned
        # storage and the shared block stays immutable
        for seq, _ in prefills:
            if seq.cow_src is not None and seq.cow_index is not None \
                    and seq.cow_index < len(seq.block_ids):
                self.cache.copy_block(seq.cow_src,
                                      seq.block_ids[seq.cow_index])
                self.scheduler._release_cow(seq)

        entries = [(seq, 1, False) for seq in decode] + \
                  [(seq, n, True) for seq, n in prefills]
        T, S = self.step_tokens, self.max_batch
        if len(entries) > S or sum(n for _, n, _ in entries) > T:
            raise RuntimeError("scheduler over-packed the step")
        tokens = np.zeros((1, T), np.int32)
        bt = np.zeros((S + 1, self.cache.max_blocks_per_seq), np.int32)
        cu = np.zeros((S + 2,), np.int32)
        ctx = np.zeros((S + 1,), np.int32)
        sid = np.full((T,), S, np.int32)   # sentinel = padding
        pos = np.zeros((T,), np.int32)
        last_idx = np.zeros((S,), np.int32)
        kv_lens = []
        off = 0
        for i, (seq, n, is_prefill) in enumerate(entries):
            if is_prefill:
                tokens[0, off:off + n] = seq.pending_tokens[
                    seq.prefill_pos:seq.prefill_pos + n]
                c = seq.prefill_pos
            else:
                tokens[0, off] = seq.last_token()
                c = seq.num_cached
            bt[i] = self.cache.pad_block_table(seq.block_ids)
            ctx[i] = c
            sid[off:off + n] = i
            pos[off:off + n] = c + np.arange(n)
            cu[i + 1] = off + n
            last_idx[i] = off + n - 1
            kv_lens.append(c + n)
            off += n
        cu[len(entries) + 1:] = off
        if self.attn_impl == "rpa":
            ssq, sbk = build_step_maps(
                cu[:len(entries) + 1], kv_lens, total_tokens=T,
                tile_q=self._tile_q, block_size=self.cache.block_size,
                max_steps=self._max_steps, max_seqs=S)
        else:
            ssq, sbk = self._null_step_maps

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        meta = [dev(a) for a in (bt, cu, ctx, sid, pos, ssq, sbk)]
        caches = [RaggedLayerCache(kp, vp, *meta) for kp, vp in
                  zip(self.cache.k_pools, self.cache.v_pools)]
        with torch.no_grad():
            h, _ = self._backbone(dev(tokens), caches=caches,
                                  attn_impl=self.attn_impl)
            # logits at each sequence's LAST packed token only (rows of
            # empty metadata slots gather token 0 and are discarded)
            hsel = h[0][dev(last_idx).long()][:, None, :]
            logits = self._project(hsel)[:, 0].float()
        arr = logits.cpu().numpy()
        self.steps += 1

        for i, (seq, n, is_prefill) in enumerate(entries):
            if is_prefill:
                seq.prefill_pos += n
                seq.num_cached += n
                seq.prefilled_tokens += n
                self._commit_cached_blocks(seq)
                if seq.prefill_pos == len(seq.pending_tokens):
                    # prompt fully cached: sample the continuation (the
                    # request's first token — or, after preemption, the
                    # next)
                    tok = self._sample(arr[i], seq)
                    seq.state = RequestState.RUNNING
                    self._emit_token(seq, tok)
            else:
                seq.num_cached += 1
                self._commit_cached_blocks(seq)
                tok = self._sample(arr[i], seq)
                self._emit_token(seq, tok)

    def _commit_cached_blocks(self, seq: Request):
        """Register every newly-completed full block in the prefix
        index, right after a step advanced ``num_cached`` and before the
        sampled token can finish the request. Committed blocks are never
        written again, so the index entry is immutable."""
        pc = self.cache.prefix_cache
        if pc is None:
            return
        bs = self.cache.block_size
        full = seq.num_cached // bs
        if full <= seq.committed_blocks:
            return
        stream = seq.prompt_tokens + seq.generated
        for i in range(seq.committed_blocks, full):
            d = chain_hash(seq.committed_hash,
                           stream[i * bs:(i + 1) * bs])
            pc.register(d, seq.block_ids[i])
            seq.committed_hash = d
        seq.committed_blocks = full

    def _sample(self, logits_row: np.ndarray, seq: Request) -> int:
        if seq.temperature == 0:
            return int(np.argmax(logits_row))
        tok = sample_token(torch.from_numpy(logits_row)[None, :],
                           seq.temperature, seq.top_k, seq.top_p,
                           generator=self._generator)
        return int(tok[0])

    def _emit_token(self, seq: Request, tok: int):
        now = time.perf_counter()
        if seq.first_token_time is None:
            seq.first_token_time = now
        seq.last_token_time = now
        seq.generated.append(int(tok))
        if seq.on_token is not None:
            try:
                seq.on_token(seq, int(tok))
            except Exception:  # noqa: BLE001
                pass  # a broken stream consumer must not kill the batch
        if seq.eos_token_id is not None and tok == seq.eos_token_id:
            self._finish(seq, "eos")
        elif len(seq.generated) >= seq.max_new_tokens:
            self._finish(seq, "length")

    def _finish(self, seq: Request, reason: str,
                state: RequestState = RequestState.FINISHED):
        self.scheduler.finish(seq, state, reason)
        handle = self._handles.pop(seq.req_id, None)
        if handle is not None:
            handle._done.set()
        with self._cv:
            self._cv.notify_all()

    def abort(self, req_id: int, reason: str = "aborted") -> bool:
        """Cancel a queued or in-flight request, releasing its batch slot
        and KV blocks. Returns False when the request is unknown or
        already finished."""
        with self._cv:
            handle = self._handles.get(req_id)
            if handle is None:
                return False
            seq = handle._req
            if seq.done:
                return False
            if seq in self.scheduler.waiting:
                self.scheduler.waiting.remove(seq)
            seq.error = reason
            self._finish(seq, "aborted", RequestState.FAILED)
            return True

    # -- run loop ----------------------------------------------------------
    def has_pending(self) -> bool:
        with self._lock:
            return self.scheduler.has_work()

    def run_until_idle(self):
        """Synchronous loop (tests / batch jobs): step until every
        submitted request has finished."""
        while True:
            did = self.step()
            if not did and not self.has_pending():
                return
            if not did:
                raise RuntimeError(
                    "engine stalled with pending work — KV pool "
                    "undersized for the admitted requests")

    def start(self):
        """Background step loop (the server front-end's mode)."""
        with self._lock:
            if self._thread is not None:
                return
            self._shutdown = False
            self._thread = threading.Thread(
                target=self._run_loop, name="pt-torch-serving-engine",
                daemon=True)
            self._thread.start()

    def _run_loop(self):
        while True:
            with self._cv:
                if self._shutdown and not self.scheduler.has_work():
                    return
                if not self.scheduler.has_work():
                    self._cv.wait(timeout=0.1)
                    continue
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 — loop must not die silently
                # a failed step would strand every pending handle: fail
                # them all loudly, stop the loop, and re-raise
                with self._cv:
                    for seq in (list(self.scheduler.slotted())
                                + list(self.scheduler.waiting)):
                        seq.error = f"engine step failed: {e!r}"
                        self._finish(seq, "error", RequestState.FAILED)
                    self.scheduler.waiting.clear()
                    self._shutdown = True
                    self._cv.notify_all()
                raise

    def drain(self, timeout: Optional[float] = None):
        """Block until every accepted request has finished."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        while self.has_pending():
            if self._thread is None:
                self.run_until_idle()
                break
            if deadline is not None and time.perf_counter() > deadline:
                raise TimeoutError("engine drain timed out")
            with self._cv:
                if self.scheduler.has_work():
                    self._cv.wait(timeout=0.1)

    def shutdown(self, drain: bool = True, timeout: Optional[float] = None):
        """Graceful stop: optionally finish in-flight work, then stop the
        loop thread. New submissions are rejected once shut down."""
        if drain:
            self.drain(timeout)
        with self._cv:
            self._shutdown = True
            if not drain:
                for seq in (list(self.scheduler.slotted())
                            + list(self.scheduler.waiting)):
                    seq.error = "engine shut down"
                    self._finish(seq, "aborted", RequestState.FAILED)
                self.scheduler.waiting.clear()
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        """Lock-free snapshot for ``/healthz``."""
        alloc = self.cache.allocator
        cap = max(alloc.capacity, 1)
        free = alloc.num_free()
        reclaim = alloc.num_reclaimable()
        pc = self.cache.prefix_cache
        out = {
            "running": self.scheduler.num_running,
            "waiting": self.scheduler.num_waiting,
            "kv_blocks_in_use": alloc.blocks_in_use(),
            "kv_blocks_free": free,
            "kv_blocks_reclaimable": reclaim,
            "preemptions": self.scheduler.num_preemptions,
            "requests_in_flight": len(self._handles),
            "steps": self.steps,
            # compiled executables of the unified step (the reference's
            # count is 1): the port runs the step eagerly and compiles none
            "step_compiles": 0,
            # process-wide count of RPA kernel launches (CPU tensors run
            # the plain version and count none)
            "rpa_launches": ragged_paged_attention.launches,
            "attn_impl": self.attn_impl,
            "device": str(self.device),
            "step_tokens": self.step_tokens,
            "kv_headroom": round((free + reclaim) / cap, 4),
            "kv_free_fraction": round(free / cap, 4),
            "kv_reclaimable_fraction": round(reclaim / cap, 4),
            "max_batch": self.max_batch,
            "max_model_len": self.max_model_len,
            "block_size": self.cache.block_size,
            "kv_dtype": str(self.cache.dtype).replace("torch.", ""),
            "prefix_cache": None,
        }
        if pc is not None:
            s = pc.stats()
            s["hit_rate"] = round(s["hits"] / max(s["lookups"], 1), 4)
            out["prefix_cache"] = s
        return out
