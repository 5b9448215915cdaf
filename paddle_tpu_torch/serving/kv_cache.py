"""Block-paged KV-cache manager — port of ``paddle_tpu/serving/kv_cache.py``.

* :class:`BlockAllocator` — host-side refcounted free list over block
  ids ``1..num_blocks`` (block 0 is the null block and never handed
  out), with an LRU reclaimable tier for prefix-cached blocks whose
  refcount dropped to zero, and leak assertions.
* :class:`PrefixCache` — the chain-hashed index of committed full
  blocks: admission claims the longest registered prefix and only the
  uncached tail prefills.
* :class:`PagedKVCache` — one ``[num_blocks + 1, block_size, n_kv, hd]``
  K pool and V pool per layer, as torch tensors on the engine's device.
  Unlike the reference, which threads the pools functionally through
  its compiled step, the pools are updated **in place** (a functional
  copy per layer per step would double the cache's memory at 8B width),
  and the copy-on-write block copy is an in-place slice copy.
  ``kv_dtype="int8"`` stores int8 pools and, per layer, f32 scale pools
  ``[num_blocks + 1, block_size, n_kv]`` (one dequant multiplier per
  token slot and kv head, reference :357-390); the block copy copies
  the scales with the values.

The allocator (with its block-seconds occupancy integral), prefix index
(with the router-facing ``sketch``) and hashing are host Python and port
verbatim apart from the dropped tensor-parallel hook.
``PrefixCache.match(seed=)`` roots a chain in a namespace (the engine's
per-adapter-slot seed).

Cross-replica block transfer (``export_block`` / ``import_block``, the
fleet's prefill->decode handoff): the wire dtype is the compute dtype,
as in the reference, so an int8 pool dequantizes on export and
re-quantizes on import and quantized and unquantized replicas hand
blocks to each other. Unlike the reference's host-staged numpy rows, an
exported record holds tensors on the exporting pool's device, so a
handoff between two replicas on one card stays on the card.
"""
from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["BlockAllocator", "PagedKVCache", "PrefixCache", "chain_hash"]

#: physical block id reserved as the write-off target for padding
NULL_BLOCK = 0

#: chain seed for the first block's digest (no parent)
_HASH_SEED = b"\x00" * 16


def chain_hash(parent: Optional[bytes], tokens: Sequence[int]) -> bytes:
    """Digest of one full token block, chained to its prefix: two blocks
    collide only if their entire token prefixes agree (16-byte blake2b —
    keyed content addressing, not cryptographic auth)."""
    h = hashlib.blake2b(parent or _HASH_SEED, digest_size=16)
    h.update(np.asarray(tokens, dtype=np.int64).tobytes())
    return h.digest()


class BlockAllocator:
    """Refcounted free-list allocator over block ids ``1..num_blocks``
    with an LRU reclaimable tier for prefix-cached refcount-0 blocks."""

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError("need at least one allocatable block")
        self.num_blocks = num_blocks
        self._lock = threading.Lock()
        # ids 1..num_blocks (0 is the null block); popped from the end
        self._free: List[int] = list(range(num_blocks, 0, -1))
        self._refcount: Dict[int, int] = {}
        # block-seconds occupancy integral: bill the PREVIOUS holding
        # level for each elapsed interval at every occupancy transition
        # (left-continuous — the exact pool-level cost the per-request
        # ledger approximates at step granularity)
        self._occ_t = time.monotonic()
        self._occ_seconds = 0.0
        # refcount-0 blocks still holding registered prefix-cache
        # contents, LRU order (oldest first — the eviction order)
        self._reclaimable: "OrderedDict[int, bytes]" = OrderedDict()
        # block id -> prefix digest for every REGISTERED block (live or
        # parked); registration survives free/park until eviction
        self._cached_key: Dict[int, bytes] = {}
        #: called (block_id, key) under the allocator lock when an LRU
        #: reclaimable block is repurposed — the PrefixCache drops its
        #: index entry here (must not re-enter the allocator)
        self._evict_cb: Optional[Callable[[int, bytes], None]] = None

    def _occ_tick_locked(self, now: Optional[float] = None):
        """Accrue block-seconds at the current holding level (lock held;
        called BEFORE any occupancy mutation)."""
        now = time.monotonic() if now is None else now
        dt = now - self._occ_t
        if dt > 0:
            self._occ_seconds += len(self._refcount) * dt
            self._occ_t = now

    def block_seconds_total(self) -> float:
        """Cumulative pool occupancy integral (blocks held by live
        sequences x seconds held) since construction."""
        with self._lock:
            self._occ_tick_locked()
            return self._occ_seconds

    @property
    def capacity(self) -> int:
        return self.num_blocks

    def num_free(self) -> int:
        with self._lock:
            return len(self._free)

    def num_reclaimable(self) -> int:
        with self._lock:
            return len(self._reclaimable)

    def blocks_in_use(self) -> int:
        with self._lock:
            return len(self._refcount)

    def can_allocate(self, n: int) -> bool:
        """Reclaimable blocks count as capacity: they are evicted before
        an allocation is allowed to fail."""
        with self._lock:
            return len(self._free) + len(self._reclaimable) >= n

    def allocate(self, n: int = 1) -> List[int]:
        """``n`` fresh blocks at refcount 1; raises ``MemoryError`` when
        the pool can't cover the request (callers preempt on that).
        Free-list blocks go first; then LRU reclaimable cached blocks
        are evicted (their prefix-index entries invalidated via the
        eviction callback)."""
        with self._lock:
            self._occ_tick_locked()
            if len(self._free) + len(self._reclaimable) < n:
                raise MemoryError(
                    f"KV block pool exhausted: need {n}, free "
                    f"{len(self._free)}+{len(self._reclaimable)} "
                    f"reclaimable /{self.num_blocks}")
            out = []
            for _ in range(n):
                if self._free:
                    b = self._free.pop()
                else:
                    b, key = self._reclaimable.popitem(last=False)
                    del self._cached_key[b]
                    if self._evict_cb is not None:
                        self._evict_cb(b, key)
                self._refcount[b] = 1
                out.append(b)
            return out

    def incref(self, block_id: int):
        with self._lock:
            if block_id not in self._refcount:
                raise ValueError(f"block {block_id} is not allocated")
            self._refcount[block_id] += 1

    def free(self, block_ids: Sequence[int]):
        """Drop one reference per id. At refcount 0 a registered
        (prefix-cached) block PARKS in the reclaimable tier — contents
        kept, evictable LRU — while an unregistered block returns to
        the free list."""
        with self._lock:
            self._occ_tick_locked()
            for b in block_ids:
                rc = self._refcount.get(b)
                if rc is None:
                    raise ValueError(f"double free of block {b}")
                if rc == 1:
                    del self._refcount[b]
                    key = self._cached_key.get(b)
                    if key is not None:
                        self._reclaimable[b] = key  # MRU end
                    else:
                        self._free.append(b)
                else:
                    self._refcount[b] = rc - 1

    def refcount(self, block_id: int) -> int:
        with self._lock:
            return self._refcount.get(block_id, 0)

    # -- prefix-cache hooks ------------------------------------------------
    def mark_cached(self, block_id: int, key: bytes):
        """Register a LIVE block as prefix-cache backed: when its
        refcount later hits 0 it parks as reclaimable instead of
        returning to the free list."""
        with self._lock:
            if block_id not in self._refcount:
                raise ValueError(
                    f"block {block_id} is not allocated (cannot cache)")
            self._cached_key[block_id] = key

    def reuse_cached(self, block_id: int) -> bool:
        """Claim one reference on a registered block for a cache hit:
        incref a live holder, or resurrect a parked reclaimable block at
        refcount 1. False when the block was already evicted."""
        with self._lock:
            self._occ_tick_locked()
            if block_id not in self._cached_key:
                return False  # evicted (and possibly reallocated)
            if block_id in self._refcount:
                self._refcount[block_id] += 1
                return True
            if block_id in self._reclaimable:
                del self._reclaimable[block_id]
                self._refcount[block_id] = 1
                return True
            return False

    def is_cached(self, block_id: int) -> bool:
        with self._lock:
            return block_id in self._cached_key

    def assert_no_leaks(self):
        """Every block is back in the pool (end-of-drain invariant).
        Parked reclaimable blocks are NOT leaks — they are evictable
        capacity — but every block must be accounted for exactly once."""
        with self._lock:
            leaked = sorted(self._refcount)
            if leaked:
                raise AssertionError(
                    f"{len(leaked)} KV blocks leaked: {leaked[:16]}")
            total = len(self._free) + len(self._reclaimable)
            if total != self.num_blocks:
                raise AssertionError(
                    f"pool accounting broke: {len(self._free)} free + "
                    f"{len(self._reclaimable)} reclaimable != "
                    f"{self.num_blocks}")


class PrefixCache:
    """Hash index over committed full KV blocks.

    ``match`` walks the chain hashes of a prompt's full blocks and
    CLAIMS every hit (incref / resurrect through the allocator) so a
    concurrent eviction can't invalidate an earlier link mid-walk;
    ``register`` is called by the engine's post-step commit pass — only
    for blocks whose final token the executed step wrote, so an indexed
    block is always immutable."""

    def __init__(self, allocator: BlockAllocator, block_size: int):
        self.allocator = allocator
        self.block_size = block_size
        self._index: Dict[bytes, int] = {}   # digest -> physical block
        self.lookups = 0
        self.hits = 0
        self.evictions = 0
        self.hit_tokens = 0      # prompt tokens served from the cache
        allocator._evict_cb = self._on_evict

    def __len__(self) -> int:
        return len(self._index)

    def lookup(self, digest: bytes) -> Optional[int]:
        return self._index.get(digest)

    def _on_evict(self, block_id: int, key: bytes):
        # under the allocator lock — dict surgery only
        if self._index.get(key) == block_id:
            del self._index[key]
        self.evictions += 1

    def match(self, tokens: Sequence[int],
              seed: Optional[bytes] = None) -> Tuple[List[int], List[bytes]]:
        """Longest registered full-block prefix of ``tokens``: returns
        the CLAIMED physical blocks (one reference each, caller owns)
        and their digests. The caller applies the at-least-one-token
        prefill cap (scheduler admission). ``seed`` roots the chain in a
        namespace (a LoRA adapter slot's digest, so KV computed under one
        adapter never matches another tenant's identical prompt);
        ``None`` is the base model's."""
        self.lookups += 1
        bs = self.block_size
        blocks: List[int] = []
        digests: List[bytes] = []
        parent = seed
        for i in range(len(tokens) // bs):
            d = chain_hash(parent, tokens[i * bs:(i + 1) * bs])
            b = self._index.get(d)
            if b is None or not self.allocator.reuse_cached(b):
                if b is not None:
                    # index raced an eviction path — drop the stale entry
                    self._index.pop(d, None)
                break
            blocks.append(b)
            digests.append(d)
            parent = d
        if blocks:
            self.hits += 1
        return blocks, digests

    def register(self, digest: bytes, block_id: int):
        """Index a completed full block. First writer wins: duplicate
        content keeps the existing entry and the caller's block simply
        stays a plain (uncached) block."""
        if digest in self._index:
            return
        self.allocator.mark_cached(block_id, digest)
        self._index[digest] = block_id

    def stats(self) -> dict:
        return {
            "lookups": self.lookups,
            "hits": self.hits,
            "evictions": self.evictions,
            "hit_tokens": self.hit_tokens,
            "entries": len(self._index),
        }

    #: bytes of each digest kept in the router-facing sketch — 8 bytes
    #: (64 bits) keeps accidental cross-replica collisions negligible
    SKETCH_PREFIX_BYTES = 8

    def sketch(self, limit: int = 4096) -> List[str]:
        """Compact content summary of the index for the fleet router:
        the hex-truncated digest of every registered block (chain hashes
        commit to their whole prefix, so digest-set intersection IS
        prefix overlap). Capped at ``limit`` entries — a partial sketch
        only costs affinity accuracy, never correctness: admission
        re-walks the real index."""
        n = self.SKETCH_PREFIX_BYTES
        keys = list(self._index.keys())[:limit]
        return [d[:n].hex() for d in keys]


class PagedKVCache:
    """Per-layer block pools on the device + the allocator + the
    block-table padding helper. The pools live on the card unless
    ``device`` names another (``resolve_device``: ``None`` is ``cuda``,
    which raises where PyTorch sees no card). ``dtype`` is the attention's
    compute dtype; ``kv_dtype="int8"`` stores int8 pools with f32 scale
    pools beside them (``k_scales``/``v_scales``, empty otherwise)."""

    def __init__(self, num_layers: int, num_blocks: int, block_size: int,
                 num_kv_heads: int, head_dim: int,
                 max_blocks_per_seq: Optional[int] = None,
                 dtype=torch.float32, device=None,
                 prefix_cache: bool = False,
                 kv_dtype: Optional[str] = None):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_dtype={kv_dtype!r} (want None or 'int8')")
        self.num_layers = num_layers
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq or num_blocks
        self.allocator = BlockAllocator(num_blocks)
        self.prefix_cache = (PrefixCache(self.allocator, block_size)
                             if prefix_cache else None)
        #: compute dtype of the attention; the storage may be narrower
        self.dtype = dtype
        self.kv_dtype = kv_dtype
        device = resolve_device(device)
        # +1: physical block 0 is the null block and backs no sequence
        shape = (num_blocks + 1, block_size, num_kv_heads, head_dim)
        store = torch.int8 if kv_dtype == "int8" else dtype
        self.k_pools = [torch.zeros(shape, dtype=store, device=device)
                        for _ in range(num_layers)]
        self.v_pools = [torch.zeros(shape, dtype=store, device=device)
                        for _ in range(num_layers)]
        self.k_scales: List[torch.Tensor] = []
        self.v_scales: List[torch.Tensor] = []
        if kv_dtype == "int8":
            # paged like the pools, so the block tables address both
            sshape = (num_blocks + 1, block_size, num_kv_heads)
            self.k_scales = [torch.zeros(sshape, dtype=torch.float32,
                                         device=device)
                             for _ in range(num_layers)]
            self.v_scales = [torch.zeros(sshape, dtype=torch.float32,
                                         device=device)
                             for _ in range(num_layers)]

    @property
    def max_seq_len(self) -> int:
        """Longest sequence one block table can address."""
        return self.max_blocks_per_seq * self.block_size

    def blocks_for(self, num_tokens: int) -> int:
        return -(-num_tokens // self.block_size)  # ceil div

    def pool_bytes(self) -> int:
        """Bytes of every pool the cache holds: values and, for int8 KV,
        the scale pools."""
        return sum(t.numel() * t.element_size() for t in
                   self.k_pools + self.v_pools + self.k_scales
                   + self.v_scales)

    @torch.no_grad()
    def copy_block(self, src: int, dst: int):
        """Copy-on-write: duplicate physical block ``src`` into ``dst``
        across every layer's K and V pool, in place, and their scale pools
        with them (a block copied without its scales would dequantize to
        garbage)."""
        for p in self.k_pools + self.v_pools + self.k_scales + \
                self.v_scales:
            p[dst].copy_(p[src])

    # -- cross-replica block transfer (fleet disaggregation) ---------------
    @torch.no_grad()
    def export_blocks(self, block_ids: Sequence[int]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Physical blocks' KV rows across every layer: ``(k, v)``, each
        ``[len(block_ids), num_layers, block_size, n_kv, hd]`` in the
        compute dtype on the pools' device (an int8 pool dequantized
        with its scales), one gather a pool. The copies are ordered on
        the current stream, before any later write to the blocks; the
        caller holds a reference on each block while it calls (the
        engine claims them through ``reuse_cached``)."""
        ids = torch.as_tensor(list(block_ids), dtype=torch.long,
                              device=self.k_pools[0].device)
        k = torch.stack([p[ids] for p in self.k_pools], dim=1)
        v = torch.stack([p[ids] for p in self.v_pools], dim=1)
        if self.kv_dtype == "int8":
            # wire format stays the compute dtype so handoffs work
            # between quantized and unquantized replicas
            ks = torch.stack([p[ids] for p in self.k_scales], dim=1)
            vs = torch.stack([p[ids] for p in self.v_scales], dim=1)
            k = (k.float() * ks[..., None]).to(self.dtype)
            v = (v.float() * vs[..., None]).to(self.dtype)
        return k, v

    def export_block(self, block_id: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One block of :meth:`export_blocks`: ``[num_layers, block_size,
        n_kv, hd]`` each."""
        k, v = self.export_blocks([block_id])
        return k[0], v[0]

    @torch.no_grad()
    def import_blocks(self, block_ids: Sequence[int], k, v):
        """Write exported KV rows ``[len(block_ids), num_layers, ...]``
        (tensors on any device, or numpy arrays) into physical
        ``block_ids`` of every layer (the inverse of
        :meth:`export_blocks`): cast to the compute dtype, quantized per
        (token, kv head) into an int8 pool; one scatter a pool. The
        caller owns the blocks (freshly allocated) and registers them
        with the prefix index afterwards."""
        dev = self.k_pools[0].device
        ids = torch.as_tensor(list(block_ids), dtype=torch.long, device=dev)
        k = torch.as_tensor(k).to(device=dev, dtype=self.dtype)
        v = torch.as_tensor(v).to(device=dev, dtype=self.dtype)
        if self.kv_dtype == "int8":
            from ..ops.paged_attention import quantize_kv_slots
            (k, ks), (v, vs) = quantize_kv_slots(k), quantize_kv_slots(v)
            for i in range(self.num_layers):
                self.k_scales[i][ids] = ks[:, i]
                self.v_scales[i][ids] = vs[:, i]
        for i in range(self.num_layers):
            self.k_pools[i][ids] = k[:, i]
            self.v_pools[i][ids] = v[:, i]

    def import_block(self, block_id: int, k, v):
        """One block of :meth:`import_blocks`: ``k``, ``v`` of
        ``[num_layers, block_size, n_kv, hd]``."""
        self.import_blocks([block_id], torch.as_tensor(k)[None],
                           torch.as_tensor(v)[None])

    def gauge_in_use(self):
        """Publish pool occupancy through the observability registry."""
        from ..observability import get_registry
        g = get_registry().gauge(
            "serving_kv_blocks_in_use",
            "KV-cache blocks currently held by live sequences")
        g.set(self.allocator.blocks_in_use())
        return g

    def pad_block_table(self, block_ids: Sequence[int]) -> np.ndarray:
        """[max_blocks_per_seq] int32 row, null-padded."""
        if len(block_ids) > self.max_blocks_per_seq:
            raise ValueError(
                f"sequence holds {len(block_ids)} blocks > table width "
                f"{self.max_blocks_per_seq}")
        row = np.full((self.max_blocks_per_seq,), NULL_BLOCK, np.int32)
        row[:len(block_ids)] = block_ids
        return row
