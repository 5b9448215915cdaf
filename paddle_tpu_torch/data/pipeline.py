"""DataPipeline — port of ``paddle_tpu/data/pipeline.py``.

The checkpointable front door of the data package: a
:class:`~.stream.ShardedStream` feeding a collate batcher or a
:class:`~.packing.SequencePacker` (``pack=True``), optionally behind the
device prefetcher (``device_prefetch=N``: batches land on the device N
steps ahead of the training loop, copied from pinned host memory on a
side CUDA stream).

``state_dict()`` is the compact iterator state ``{version, step, epoch,
drop_last, stream, packer, pending}`` — the reference's, key for key,
so a state written by either package resumes in the other — and it
describes exactly the batches the trainer has RECEIVED: each produced
batch carries its post-batch state, which commits only when the batch
is delivered (``__next__`` returning it), whatever the prefetch depth.
``FitResilience`` commits it in the same checkpoint step as the model
and optimizer.

Iteration yields one epoch per ``__iter__``; a restored mid-epoch state
resumes inside its epoch, and a ``pack=True, drop_last=False`` state
taken after an epoch's last in-loop batch flushes the packer's carry as
that epoch's tail batch. Batches are numpy dicts (``pack=True``) or the
``collate_fn``'s host tensors, and torch tensors on ``device`` under
``device_prefetch``.

Not ported yet: ``sharding=`` (placement onto a mesh) raises
``NotImplementedError``, and the flight recorder's commit events.
"""
from __future__ import annotations

import copy
from typing import Callable, Iterator, Optional

import numpy as np

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.io.dataloader import default_collate_fn

from .metrics import data_metrics
from .packing import IGNORE_LABEL, SequencePacker
from .stream import ShardedStream

__all__ = ["DataPipeline"]

STATE_VERSION = 1


class DataPipeline:
    """``pack=True`` expects each dataset item to be (or map, via
    ``to_tokens``, to) a 1-D int token sequence and yields packed dict
    batches (see :class:`SequencePacker` for the layout — feed them to a
    network that computes its own loss, ``Model.prepare(opt, loss=None)``).
    ``pack=False`` collates ``batch_size`` items with ``collate_fn``
    (tuple batches, the classic ``(x, y)`` fit shape)."""

    def __init__(self, dataset, batch_size: int, *, seq_len: int = 0,
                 pack: bool = False, base_seed: int = 0,
                 shuffle: bool = True, shard_index: Optional[int] = None,
                 num_shards: Optional[int] = None, drop_last: bool = False,
                 collate_fn: Optional[Callable] = None,
                 to_tokens: Optional[Callable] = None, pad_id: int = 0,
                 device_prefetch: int = 0, sharding=None,
                 max_bad_samples: Optional[int] = None, registry=None,
                 device=None):
        """``device`` is where ``device_prefetch`` puts the batches:
        ``None`` is the CUDA card (raising where there is none), or pass
        ``device="cpu"``."""
        if sharding is not None:
            raise NotImplementedError(
                "DataPipeline(sharding=...) places batches onto a mesh, "
                "which is not ported to paddle_tpu_torch yet")
        self.stream = ShardedStream(
            dataset, base_seed=base_seed, shuffle=shuffle,
            shard_index=shard_index, num_shards=num_shards,
            max_bad_samples=max_bad_samples, registry=registry)
        self.pack = bool(pack)
        self.batch_size = int(batch_size)
        self.drop_last = bool(drop_last)
        self.collate_fn = collate_fn or default_collate_fn
        self.to_tokens = to_tokens
        self.packer: Optional[SequencePacker] = None
        if self.pack:
            if seq_len < 2:
                raise ValueError("pack=True requires seq_len >= 2")
            self.packer = SequencePacker(seq_len, batch_size,
                                         pad_id=pad_id, registry=registry)
        self.device_prefetch = int(device_prefetch)
        self.device = None
        if self.device_prefetch > 0:
            self.device = resolve_device(device)
        self._registry = registry
        self._m = data_metrics(registry)
        self._step = 0  # batches DELIVERED over the pipeline's lifetime
        # batches built but not yet yielded: one packer.add() can flush
        # SEVERAL batches from a single long document, while the stream
        # cursor has already moved past that document — these must ride
        # the checkpoint state or a kill between them loses the later
        # ones (they exist nowhere else)
        self._pending: list = []
        # set by a mid-epoch elastic reshard: a new shard may start the
        # epoch with cursor 0 yet hold pendings/carry that belong to the
        # CURRENT (in-flight) epoch, not a finished epoch's tail — the
        # cursor==0 tail inference below must not early-return the epoch
        self._mid_epoch_reshard = False
        self._committed = self._capture()

    # -- state -----------------------------------------------------------------
    def _next_epoch(self) -> int:
        """Epoch of the next batch this pipeline will deliver, given
        the CURRENT stream/packer/pending state. Two corrections over
        raw ``stream.epoch``: a normalized-to-next-epoch stream whose
        pending batches / unflushed drop_last=False carry still owe the
        finished epoch its tail reports the FINISHED epoch; an epoch's
        final in-loop batch (captured before the stream's lazy
        rollover, cursor at epoch length) reports the NEXT epoch once
        nothing more is owed."""
        e, cur = self.stream.epoch, self.stream.cursor
        tail_owed = bool(self._pending or
                         (self.pack and not self.drop_last and
                          self.packer.has_carry))
        if cur == 0:
            if self._mid_epoch_reshard:
                return e  # pendings/carry belong to the CURRENT epoch
            return e - 1 if tail_owed else e
        try:
            n = self.stream.samples_per_epoch()
        except TypeError:
            return e  # iterable: no length, rollover stays lazy
        if cur >= n and not tail_owed:
            return e + 1
        return e

    def _capture(self) -> dict:
        state = {"version": STATE_VERSION, "step": int(self._step),
                 "epoch": self._next_epoch(),
                 "drop_last": self.drop_last,
                 "stream": self.stream.state_dict()}
        if self.packer is not None:
            state["packer"] = self.packer.state_dict()
            if self._pending:
                state["pending"] = [
                    {k: v.copy() for k, v in b.items()}
                    for b in self._pending]
        if self._mid_epoch_reshard and self.stream.cursor == 0:
            state["mid_epoch"] = True
        return state

    def state_dict(self) -> dict:
        """Iterator state as of the last DELIVERED batch (see module
        docstring — prefetched-but-unconsumed batches are not counted)."""
        return copy.deepcopy(self._committed)

    def load_state_dict(self, state: dict):
        if int(state.get("version", 0)) != STATE_VERSION:
            raise ValueError(
                f"unsupported pipeline state version "
                f"{state.get('version')!r} (this build writes "
                f"{STATE_VERSION})")
        if bool(state.get("drop_last", self.drop_last)) != self.drop_last:
            raise ValueError(
                f"pipeline state was saved with drop_last="
                f"{state['drop_last']}, this pipeline has drop_last="
                f"{self.drop_last} — the flag decides whether a "
                "restored epoch-tail carry flushes or rides into the "
                "next epoch, so resuming across it would silently "
                "change the batch sequence")
        self.stream.load_state_dict(state["stream"])
        if self.packer is not None:
            if "packer" not in state:
                raise ValueError("state has no packer carry but this "
                                 "pipeline packs")
            self.packer.load_state_dict(state["packer"])
        elif "packer" in state:
            raise ValueError(
                "state carries a packer carry but this pipeline does "
                "not pack — the carry (and any pending batches) would "
                "be silently dropped; rebuild with pack=True to resume "
                "this state")
        self._pending = [
            {k: np.asarray(v) for k, v in b.items()}
            for b in state.get("pending", [])]
        self._mid_epoch_reshard = bool(state.get("mid_epoch", False))
        self._step = int(state["step"])
        self._committed = self._capture()

    @property
    def step(self) -> int:
        """Batches DELIVERED (the producer may be ahead under prefetch)."""
        return int(self._committed["step"])

    @property
    def epoch(self) -> int:
        """Epoch of the NEXT batch to be delivered — read from the
        COMMITTED state like ``step`` (under prefetch the producer's
        live stream may already be an epoch ahead of the trainer). At a
        restored epoch tail (stream normalized to the next epoch while
        pending batches / an unflushed drop_last=False carry still owe
        the finished epoch its tail) this is still the FINISHED epoch —
        so ``epochs - pipe.epoch`` relaunch loops drive one more
        ``__iter__`` to collect the tail instead of skipping it."""
        return int(self._committed["epoch"])

    def __len__(self):
        if self.pack:
            raise TypeError(
                "a packing pipeline's batch count depends on document "
                "lengths; it has no static length")
        n = self.stream.samples_per_epoch()
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    # -- elastic reshard -------------------------------------------------------
    @staticmethod
    def reshard_state(states, new_num_shards: int, *, pad_id: int = 0,
                      ignore_label: int = IGNORE_LABEL):
        """Remap a complete set of per-shard pipeline states onto
        ``new_num_shards`` — the :meth:`ShardedStream.reshard_state`
        order remap plus the packing layer's carry: old shards' pending
        batches are redistributed round-robin, and every open packer bin
        is refolded through fresh per-shard packers (spilled batches join
        that shard's pendings), so not a token is dropped or duplicated
        across the membership change. ``pad_id``/``ignore_label`` must
        match the live pipelines' packer (they are not part of the
        carry state). Returns ``new_num_shards`` state dicts.
        """
        M = int(new_num_shards)
        if not states:
            raise ValueError("reshard_state needs every old shard's state")
        states = sorted((dict(s) for s in states),
                        key=lambda s: int(s["stream"]["shard_index"]))
        for s in states:
            if int(s.get("version", 0)) != STATE_VERSION:
                raise ValueError(
                    f"unsupported pipeline state version "
                    f"{s.get('version')!r} (this build writes "
                    f"{STATE_VERSION})")
        drop_last = bool(states[0]["drop_last"])
        pack = "packer" in states[0]
        if any(bool(s["drop_last"]) != drop_last or
               ("packer" in s) != pack for s in states):
            raise ValueError(
                "old shard states disagree on drop_last/pack — they do "
                "not come from one coherent pipeline family")

        new_streams = ShardedStream.reshard_state(
            [s["stream"] for s in states], M)
        mid_epoch = any(st["cursor"] > 0 or st.get("consumed_ahead")
                        for st in new_streams)
        step = max(int(s["step"]) for s in states)

        pendings: list = [[] for _ in range(M)]
        for i, b in enumerate(b for s in states
                              for b in s.get("pending", [])):
            pendings[i % M].append(
                {k: np.asarray(v) for k, v in b.items()})

        packers = None
        if pack:
            seq_len = int(states[0]["packer"]["seq_len"])
            bsz = int(states[0]["packer"]["batch_size"])
            if any(int(s["packer"]["seq_len"]) != seq_len or
                   int(s["packer"]["batch_size"]) != bsz for s in states):
                raise ValueError(
                    "old shard states disagree on packer geometry")
            packers = [SequencePacker(seq_len, bsz, pad_id=pad_id,
                                      ignore_label=ignore_label)
                       for _ in range(M)]
            # refold every open bin (shard order, bin order) through the
            # new shards' packers; a refold that overflows a new packer
            # flushes a full batch straight into that shard's pendings
            open_bins = [docs for s in states
                         for docs in s["packer"]["bins"] if len(docs)]
            for b_idx, docs in enumerate(open_bins):
                j = b_idx % M
                for chunk in docs:
                    pendings[j].extend(packers[j].add(chunk))

        out = []
        for j in range(M):
            st = {"version": STATE_VERSION, "step": step,
                  "drop_last": drop_last, "stream": new_streams[j]}
            e, cur = int(new_streams[j]["epoch"]), \
                int(new_streams[j]["cursor"])
            tail_owed = bool(pendings[j] or
                             (pack and not drop_last and
                              packers[j].has_carry))
            if cur == 0 and not mid_epoch and tail_owed:
                e -= 1
            st["epoch"] = e
            if pack:
                st["packer"] = packers[j].state_dict()
                if pendings[j]:
                    st["pending"] = pendings[j]
                if mid_epoch:
                    st["mid_epoch"] = True
            out.append(st)
        return out

    # -- production ------------------------------------------------------------
    def _pairs_for_epoch(self) -> Iterator[tuple]:
        """(post_batch_state, batch) pairs for the remainder of the
        current epoch. The state in each pair describes the stream/packer
        AFTER every sample that batch consumed — committing it and
        resuming reproduces the next batch exactly."""
        if self.pack:
            # deliver batches restored into _pending first: a checkpoint
            # can land between the flushes of one multi-batch add() (long
            # document) and the stream cursor is already past that doc —
            # these batches exist only in the saved state. cursor == 0
            # means the stream normalized to the next epoch's start, i.e.
            # the state was captured at the FINISHED epoch's tail: any
            # pending batches — and, with drop_last=False, the packer's
            # still-unflushed carry — complete that epoch, so this
            # __iter__ ends after them instead of bleeding them into the
            # next epoch's samples.
            at_tail = self.stream.cursor == 0 and \
                not self._mid_epoch_reshard
            if self._pending or (at_tail and
                                 not self.drop_last and
                                 self.packer.has_carry):
                tail_of_epoch = at_tail
                while self._pending:
                    yield self._pair(self._pending.pop(0))
                if tail_of_epoch:
                    if not self.drop_last:
                        # the restored carry is the finished epoch's tail
                        # batch the kill landed in front of — deliver it
                        # exactly where the uninterrupted run would have
                        tail = self.packer.flush()
                        if tail is not None:
                            yield self._pair(tail)
                    return
            for sample in self.stream:
                doc = sample if self.to_tokens is None \
                    else self.to_tokens(sample)
                self._pending = self.packer.add(doc)
                while self._pending:
                    yield self._pair(self._pending.pop(0))
            self._mid_epoch_reshard = False  # epoch completed
            if not self.drop_last:
                # epoch boundary: flush the carry so every token of the
                # epoch is trained on; drop_last=True keeps the carry
                # open across epochs for maximum packing density
                tail = self.packer.flush()
                if tail is not None:
                    yield self._pair(tail)
            return
        buf = []
        for sample in self.stream:
            buf.append(sample)
            if len(buf) == self.batch_size:
                yield self._pair(self.collate_fn(buf))
                buf = []
        if buf and not self.drop_last:
            yield self._pair(self.collate_fn(buf))

    def _pair(self, batch):
        self._step += 1
        return (self._capture(), batch)

    # -- consumption -----------------------------------------------------------
    def __iter__(self):
        if self._step != int(self._committed["step"]):
            # a prefetching producer ran AHEAD of an early-exiting
            # consumer (num_iters break, preemption stop): re-anchor
            # production at the last DELIVERED batch, else re-iterating
            # would skip the batches that died in the buffer
            self.load_state_dict(self._committed)
        pairs = self._pairs_for_epoch()
        if self.device_prefetch > 0:
            from .prefetch import prefetch_pairs
            pairs = prefetch_pairs(pairs, depth=self.device_prefetch,
                                   device=self.device,
                                   registry=self._registry)
        for state, batch in pairs:
            # the commit point: this batch is now the trainer's problem
            self._committed = state
            self._m["batches"].inc()
            yield batch
