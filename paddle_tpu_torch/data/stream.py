"""ShardedStream — port of ``paddle_tpu/data/stream.py``.

A deterministic, seeded, per-host-sharded sample stream: the samples a
shard yields are a pure function of ``(dataset, base_seed, num_shards,
shard_index)``; epoch ``e``'s order comes from ``epoch_seed(base_seed,
e)`` through numpy's ``RandomState``, as in the reference, so a stream
rebuilt in either package replays the other's order. The whole iterator
state is ``{epoch, cursor}`` (plus ``consumed_ahead`` after an elastic
reshard), and :meth:`ShardedStream.reshard_state` remaps a complete set
of per-shard states onto a new world size exactly-once.

Sharding is strided over the epoch's order (shard ``k`` takes positions
``k, k+N, …``); the remainder is dropped by default. Iterable datasets
cannot seek: their resume replays the source and discards ``cursor``
samples, counted in ``data_skipped_on_resume_total``. Bad samples spend
from the loader's retry-then-skip budget under ``stage="stream"``; a
skipped sample still advances the cursor.

The default shard is the ``torch.distributed`` rank of the world size
when a process group is up, else shard 0 of 1.
"""
from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np

from paddle_tpu_torch.io.dataloader import _SKIP, _BadSampleBudget
from paddle_tpu_torch.io.dataset import IterableDataset
from paddle_tpu_torch.io.sampler import _world, epoch_seed

from .metrics import data_metrics

__all__ = ["ShardedStream"]


class ShardedStream:
    def __init__(self, dataset, base_seed: int = 0, shuffle: bool = True,
                 shard_index: Optional[int] = None,
                 num_shards: Optional[int] = None,
                 drop_remainder: bool = True,
                 max_bad_samples: Optional[int] = None,
                 registry=None):
        di, dn = _world()
        self.dataset = dataset
        self.base_seed = int(base_seed)
        self.shuffle = bool(shuffle)
        self.num_shards = int(num_shards if num_shards is not None else dn)
        self.shard_index = int(shard_index if shard_index is not None
                               else di)
        if not 0 <= self.shard_index < self.num_shards:
            raise ValueError(
                f"shard_index {self.shard_index} out of range for "
                f"{self.num_shards} shards")
        self.drop_remainder = bool(drop_remainder)
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable and self.shuffle:
            raise ValueError(
                "an IterableDataset has no index space to shuffle "
                "deterministically; pass shuffle=False (shuffle inside "
                "the dataset with its own seeded rng if needed)")
        self.epoch = 0
        self.cursor = 0  # samples already yielded of the CURRENT epoch
        # order-positions of THIS shard's current epoch already consumed
        # BEYOND the cursor prefix — only ever non-empty right after an
        # elastic reshard (old shards' cursors interleave unevenly under
        # the new stride); __iter__ skips them without yielding
        self.consumed_ahead: set = set()
        self._m = data_metrics(registry)
        self._budget: Optional[_BadSampleBudget] = None
        if max_bad_samples is None:
            max_bad_samples = int(os.environ.get(
                "PADDLE_TPU_LOADER_MAX_BAD_SAMPLES", "0") or 0)
        if int(max_bad_samples) > 0:
            self._budget = _BadSampleBudget(int(max_bad_samples))

    # -- deterministic order ---------------------------------------------------
    def epoch_order(self, epoch: int) -> np.ndarray:
        """This shard's dataset indices for ``epoch`` (map-style only) —
        pure function of the constructor args and ``epoch``."""
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.RandomState(
                epoch_seed(self.base_seed, epoch)).permutation(n)
        else:
            order = np.arange(n)
        rem = n % self.num_shards
        if rem:
            if self.drop_remainder:
                order = order[:n - rem]
            else:
                order = np.concatenate(
                    [order, order[:self.num_shards - rem]])
        return order[self.shard_index::self.num_shards]

    def samples_per_epoch(self) -> int:
        if self._iterable:
            raise TypeError("IterableDataset stream has no length")
        n = len(self.dataset)
        if self.drop_remainder:
            return (n - n % self.num_shards) // self.num_shards
        return -(-n // self.num_shards)

    __len__ = samples_per_epoch

    # -- iteration -------------------------------------------------------------
    def __iter__(self) -> Iterator:
        """Yield the REMAINDER of the current epoch (all of it when
        ``cursor`` is 0), then advance to the next epoch. A mid-epoch
        ``load_state_dict`` therefore resumes exactly where the restored
        state left off."""
        if self._iterable:
            yield from self._iter_iterable()
            return
        order = self.epoch_order(self.epoch)
        ds, budget = self.dataset, self._budget
        while self.cursor < len(order):
            if self.cursor in self.consumed_ahead:
                # already delivered pre-reshard by a departed peer shard
                self.consumed_ahead.discard(self.cursor)
                self.cursor += 1
                continue
            i = int(order[self.cursor])
            # advance BEFORE the fetch: a checkpoint taken after this
            # sample lands downstream must not replay it
            self.cursor += 1
            if budget is None:
                yield ds[i]
            else:
                s = budget.fetch(ds, i, stage="stream")
                if s is not _SKIP:
                    yield s
        self.epoch += 1
        self.cursor = 0
        self.consumed_ahead = set()

    def _iter_iterable(self):
        skip = self.cursor
        pos = 0  # arrival position within this shard, this epoch
        replayed = 0  # counted into the metric when the skip phase ends:
        # a truncated source must not inflate it with samples that were
        # never replayed, and a multi-million-sample fast-forward must
        # not pay a counter lock per sample
        for j, sample in enumerate(self.dataset):
            if j % self.num_shards != self.shard_index:
                continue
            if pos < skip:
                pos += 1
                replayed += 1
                continue
            if replayed:
                self._m["skipped_on_resume"].inc(replayed)
                replayed = 0
            pos += 1
            self.cursor = pos
            yield sample
        if replayed:
            self._m["skipped_on_resume"].inc(replayed)
        if pos < skip:
            raise RuntimeError(
                f"iterable source exhausted after {pos} samples for "
                f"shard {self.shard_index}/{self.num_shards} while "
                f"fast-forwarding to resume cursor {skip} — the source "
                "shrank or changed since the checkpoint, so the saved "
                "position no longer exists and deterministic resume is "
                "impossible; restart the epoch with a fresh pipeline "
                "instead")
        self.epoch += 1
        self.cursor = 0

    # -- checkpointable state --------------------------------------------------
    def state_dict(self) -> dict:
        state = {"epoch": int(self.epoch), "cursor": int(self.cursor),
                 "base_seed": self.base_seed,
                 "num_shards": self.num_shards,
                 "shard_index": self.shard_index,
                 "shuffle": self.shuffle,
                 "drop_remainder": self.drop_remainder}
        if not self._iterable:
            state["dataset_len"] = len(self.dataset)
        if self.consumed_ahead:
            state["consumed_ahead"] = sorted(int(p)
                                             for p in self.consumed_ahead)
        return state

    def load_state_dict(self, state: dict):
        if int(state.get("num_shards", self.num_shards)) != self.num_shards:
            raise ValueError(
                f"stream state was saved with num_shards="
                f"{state['num_shards']}, this stream has "
                f"{self.num_shards} — a membership change must remap the "
                "data order first: gather ALL old shards' states and pass "
                "them through ShardedStream.reshard_state(states, "
                "new_num_shards), then load the remapped per-shard state")
        if int(state.get("shard_index", self.shard_index)) != \
                self.shard_index:
            raise ValueError(
                f"stream state belongs to shard "
                f"{state['shard_index']}, this stream is shard "
                f"{self.shard_index} — each rank must restore its OWN "
                "data state")
        if bool(state.get("shuffle", self.shuffle)) != self.shuffle or \
                int(state.get("base_seed", self.base_seed)) != \
                self.base_seed or \
                bool(state.get("drop_remainder", self.drop_remainder)) != \
                self.drop_remainder:
            raise ValueError(
                "stream state disagrees with this stream's shuffle/"
                "base_seed/drop_remainder — the cursor would index a "
                "different order; resuming would silently change the "
                "sample sequence")
        if not self._iterable and "dataset_len" in state and \
                int(state["dataset_len"]) != len(self.dataset):
            raise ValueError(
                f"stream state was saved over a dataset of "
                f"{state['dataset_len']} samples, this dataset has "
                f"{len(self.dataset)} — the epoch permutation would "
                "differ and the cursor would index different samples; "
                "deterministic resume requires the same dataset")
        self.epoch = int(state["epoch"])
        self.cursor = int(state["cursor"])
        self.consumed_ahead = set(
            int(p) for p in state.get("consumed_ahead", ()))
        # a state captured with an epoch's FINAL batch has cursor at the
        # end of the order (rollover happens lazily on the next pull);
        # normalize so `epoch` always means "next epoch to iterate" and
        # a resumed fit doesn't spend one epoch iteration yielding nothing
        if not self._iterable and self.cursor >= self.samples_per_epoch():
            self.epoch += 1
            self.cursor = 0
            self.consumed_ahead = set()

    # -- elastic reshard -------------------------------------------------------
    @staticmethod
    def reshard_state(states, new_num_shards: int):
        """Remap a complete set of per-shard states onto a new world size.

        ``states`` must hold every old shard's ``state_dict()`` (any
        order, one per ``shard_index``). Returns ``new_num_shards`` state
        dicts, index ``j`` for new shard ``j``, preserving the GLOBAL
        sample order exactly-once: every epoch-order position any old
        shard consumed is never yielded again, every unconsumed position
        is yielded by exactly one new shard.

        Works because old and new stride over the SAME epoch permutation
        — truncation (``drop_remainder=True``) and wrap (False) only edit
        the tail, so position ``p`` means the same sample under both
        world sizes wherever both define it. Old per-shard prefixes
        interleave unevenly under the new stride; the surplus lands in
        ``consumed_ahead`` and the new shard skips those positions.
        """
        M = int(new_num_shards)
        if M < 1:
            raise ValueError(f"new_num_shards must be >= 1, got {M}")
        if not states:
            raise ValueError("reshard_state needs every old shard's state")
        ref = dict(states[0])
        N = int(ref["num_shards"])
        for f in ("base_seed", "shuffle", "drop_remainder"):
            if any(s.get(f) != ref.get(f) for s in states):
                raise ValueError(
                    f"old shard states disagree on {f!r} — they do not "
                    "come from one coherent stream family")
        if "dataset_len" not in ref:
            raise ValueError(
                "reshard_state needs map-style stream states (an "
                "IterableDataset has no index space to remap)")
        n = int(ref["dataset_len"])
        if any(int(s["dataset_len"]) != n for s in states):
            raise ValueError("old shard states disagree on dataset_len")
        seen = sorted(int(s["shard_index"]) for s in states)
        if seen != list(range(N)):
            raise ValueError(
                f"need exactly one state per old shard 0..{N - 1}, "
                f"got shard indices {seen}")
        by_idx = {int(s["shard_index"]): s for s in states}

        def _epoch_len(world):
            rem = n % world
            if rem == 0:
                return n
            return (n - rem) if ref["drop_remainder"] else \
                n + (world - rem)

        L_old, L_new = _epoch_len(N), _epoch_len(M)
        per_old = L_old // N

        # normalize epoch rollover per shard (state_dict captures the raw
        # cursor; a shard that just finished its epoch means epoch+1/0)
        norm = {}
        for k, s in by_idx.items():
            e, c = int(s["epoch"]), int(s["cursor"])
            ahead = set(int(p) for p in s.get("consumed_ahead", ()))
            if c >= per_old:
                e, c, ahead = e + 1, 0, set()
            norm[k] = (e, c, ahead)
        epochs = {e for e, _, _ in norm.values()}
        if len(epochs) > 1:
            raise ValueError(
                f"old shard states sit in different epochs {sorted(epochs)}"
                " — reshard at a consensus step boundary, where lockstep "
                "shards agree on the epoch")
        epoch = epochs.pop()

        # the globally consumed epoch-order positions
        consumed = set()
        for k, (_, c, ahead) in norm.items():
            for i in range(c):
                consumed.add(k + i * N)
            for i in ahead:
                consumed.add(k + i * N)
        if consumed and max(consumed) >= L_new:
            raise ValueError(
                f"old world consumed epoch-order position {max(consumed)} "
                f"but the {M}-shard epoch only covers positions 0.."
                f"{L_new - 1} — this boundary sits inside the old world's "
                "remainder tail and cannot be represented exactly-once at "
                f"the new size; finish the epoch at {N} shards (or "
                "reshard one step earlier) instead")

        out = []
        for j in range(M):
            npos = (L_new - j + M - 1) // M  # positions j, j+M, ... < L_new
            cur = 0
            while cur < npos and (j + cur * M) in consumed:
                cur += 1
            ahead = sorted(i for i in range(cur + 1, npos)
                           if (j + i * M) in consumed)
            st = {"epoch": epoch, "cursor": cur,
                  "base_seed": int(ref["base_seed"]),
                  "num_shards": M, "shard_index": j,
                  "shuffle": bool(ref["shuffle"]),
                  "drop_remainder": bool(ref["drop_remainder"]),
                  "dataset_len": n}
            if ahead:
                st["consumed_ahead"] = ahead
            out.append(st)
        return out
