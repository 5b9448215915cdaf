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

The allocator, prefix index and hashing are host Python and port
verbatim apart from the dropped fleet, tensor-parallel, int8 and
metrics hooks.
"""
from __future__ import annotations

import hashlib
import threading
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

    def free(self, block_ids: Sequence[int]):
        """Drop one reference per id. At refcount 0 a registered
        (prefix-cached) block PARKS in the reclaimable tier — contents
        kept, evictable LRU — while an unregistered block returns to
        the free list."""
        with self._lock:
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

    def _on_evict(self, block_id: int, key: bytes):
        # under the allocator lock — dict surgery only
        if self._index.get(key) == block_id:
            del self._index[key]
        self.evictions += 1

    def match(self, tokens: Sequence[int]) -> Tuple[List[int], List[bytes]]:
        """Longest registered full-block prefix of ``tokens``: returns
        the CLAIMED physical blocks (one reference each, caller owns)
        and their digests. The caller applies the at-least-one-token
        prefill cap (scheduler admission)."""
        self.lookups += 1
        bs = self.block_size
        blocks: List[int] = []
        digests: List[bytes] = []
        parent = None
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


class PagedKVCache:
    """Per-layer block pools on the device + the allocator + the
    block-table padding helper. The pools live on the card unless
    ``device`` names another (``resolve_device``: ``None`` is ``cuda``,
    which raises where PyTorch sees no card)."""

    def __init__(self, num_layers: int, num_blocks: int, block_size: int,
                 num_kv_heads: int, head_dim: int,
                 max_blocks_per_seq: Optional[int] = None,
                 dtype=torch.float32, device=None,
                 prefix_cache: bool = False):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_layers = num_layers
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq or num_blocks
        self.allocator = BlockAllocator(num_blocks)
        self.prefix_cache = (PrefixCache(self.allocator, block_size)
                             if prefix_cache else None)
        self.dtype = dtype
        device = resolve_device(device)
        # +1: physical block 0 is the null block and backs no sequence
        shape = (num_blocks + 1, block_size, num_kv_heads, head_dim)
        self.k_pools = [torch.zeros(shape, dtype=dtype, device=device)
                        for _ in range(num_layers)]
        self.v_pools = [torch.zeros(shape, dtype=dtype, device=device)
                        for _ in range(num_layers)]

    @property
    def max_seq_len(self) -> int:
        """Longest sequence one block table can address."""
        return self.max_blocks_per_seq * self.block_size

    def blocks_for(self, num_tokens: int) -> int:
        return -(-num_tokens // self.block_size)  # ceil div

    @torch.no_grad()
    def copy_block(self, src: int, dst: int):
        """Copy-on-write: duplicate physical block ``src`` into ``dst``
        across every layer's K and V pool, in place."""
        for p in self.k_pools + self.v_pools:
            p[dst].copy_(p[src])

    def pad_block_table(self, block_ids: Sequence[int]) -> np.ndarray:
        """[max_blocks_per_seq] int32 row, null-padded."""
        if len(block_ids) > self.max_blocks_per_seq:
            raise ValueError(
                f"sequence holds {len(block_ids)} blocks > table width "
                f"{self.max_blocks_per_seq}")
        row = np.full((self.max_blocks_per_seq,), NULL_BLOCK, np.int32)
        row[:len(block_ids)] = block_ids
        return row
