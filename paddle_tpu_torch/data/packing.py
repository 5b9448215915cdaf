"""SequencePacker — port of ``paddle_tpu/data/packing.py``.

First-fit packing of variable-length documents into fixed ``[B, seq]``
batches, numpy int32 like the reference (the arrays are also the
packer's checkpoint state): ``input_ids`` (documents back to back,
``pad_id`` in the tail), ``attention_mask`` (segment ids 1, 2, … per
document in a row, 0 on padding: the flash kernels' segment-id masking),
``position_ids`` (restarting at 0 in each document, for RoPE) and
``labels`` (``ignore_label`` on padding and on each document's first
token, so no document predicts across its boundary).

``batch_size`` bins are open at once; each document, split into chunks
of at most ``seq_len``, goes to the first bin with room, and when none
fits the batch flushes. The open bins are the carry state
(``state_dict``/``load_state_dict``), so a resumed pipeline emits the
identical next batch. Each batch's real-token share lands in the
``data_packing_efficiency`` histogram.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .metrics import data_metrics

__all__ = ["SequencePacker"]

IGNORE_LABEL = -100


class SequencePacker:
    def __init__(self, seq_len: int, batch_size: int, pad_id: int = 0,
                 ignore_label: int = IGNORE_LABEL, registry=None):
        if seq_len < 2:
            raise ValueError("seq_len must be >= 2 (causal-LM shift "
                             "leaves nothing to predict below that)")
        self.seq_len = int(seq_len)
        self.batch_size = int(batch_size)
        self.pad_id = int(pad_id)
        self.ignore_label = int(ignore_label)
        self._bins: List[List[np.ndarray]] = \
            [[] for _ in range(self.batch_size)]
        self._fill = [0] * self.batch_size
        self._m = data_metrics(registry)
        # per-instance efficiency accounting: the histogram is process-
        # global (a second packer's batches land in the same family), so
        # efficiency_stats() must not read it back
        self._eff_sum = 0.0
        self._eff_n = 0

    # -- packing ---------------------------------------------------------------
    def _chunks(self, doc: np.ndarray) -> List[np.ndarray]:
        doc = np.asarray(doc).reshape(-1).astype(np.int32)
        if len(doc) == 0:
            return []
        return [doc[i:i + self.seq_len]
                for i in range(0, len(doc), self.seq_len)]

    def add(self, doc) -> List[Dict[str, np.ndarray]]:
        """Pack one document; returns the batches it completed (usually
        none or one; a long document split into many chunks can flush
        several)."""
        out = []
        for chunk in self._chunks(doc):
            placed = False
            for b in range(self.batch_size):
                if self._fill[b] + len(chunk) <= self.seq_len:
                    self._bins[b].append(chunk)
                    self._fill[b] += len(chunk)
                    placed = True
                    break
            if not placed:
                out.append(self._emit())
                self._bins[0].append(chunk)
                self._fill[0] = len(chunk)
        return out

    @property
    def has_carry(self) -> bool:
        """True while the open bins hold tokens — i.e. ``flush()`` would
        emit a batch (the pipeline uses this to spot an epoch tail whose
        flush a checkpoint landed in front of)."""
        return any(self._fill)

    def flush(self) -> Optional[Dict[str, np.ndarray]]:
        """Emit the open bins as a (partial) batch; None when empty."""
        if not any(self._fill):
            return None
        return self._emit()

    def _emit(self) -> Dict[str, np.ndarray]:
        B, S = self.batch_size, self.seq_len
        ids = np.full((B, S), self.pad_id, np.int32)
        seg = np.zeros((B, S), np.int32)
        pos = np.zeros((B, S), np.int32)
        lab = np.full((B, S), self.ignore_label, np.int32)
        real = 0
        for b, docs in enumerate(self._bins):
            at = 0
            for s, d in enumerate(docs):
                n = len(d)
                ids[b, at:at + n] = d
                seg[b, at:at + n] = s + 1
                pos[b, at:at + n] = np.arange(n, dtype=np.int32)
                lab[b, at:at + n] = d
                lab[b, at] = self.ignore_label  # no cross-doc prediction
                at += n
                real += n
        self._bins = [[] for _ in range(B)]
        self._fill = [0] * B
        eff = real / float(B * S)
        self._eff_sum += eff
        self._eff_n += 1
        self._m["packing_efficiency"].observe(eff)
        self._m["tokens"].inc(real)
        return {"input_ids": ids, "attention_mask": seg,
                "position_ids": pos, "labels": lab}

    def efficiency_stats(self) -> Optional[dict]:
        """Mean/count of THIS packer's batch efficiencies (the
        ``data_packing_efficiency`` histogram aggregates every packer in
        the process)."""
        if self._eff_n == 0:
            return None
        return {"mean": self._eff_sum / self._eff_n,
                "count": self._eff_n}

    # -- checkpointable carry --------------------------------------------------
    def state_dict(self) -> dict:
        return {"seq_len": self.seq_len, "batch_size": self.batch_size,
                "bins": [[np.array(d, copy=True) for d in docs]
                         for docs in self._bins]}

    def load_state_dict(self, state: dict):
        if int(state["seq_len"]) != self.seq_len or \
                int(state["batch_size"]) != self.batch_size:
            raise ValueError(
                f"packer state is for [B={state['batch_size']}, "
                f"seq={state['seq_len']}], this packer is "
                f"[B={self.batch_size}, seq={self.seq_len}] — geometry "
                "must be restart-stable for deterministic resume")
        self._bins = [[np.asarray(d).reshape(-1).astype(np.int32)
                       for d in docs] for docs in state["bins"]]
        # tolerate list-of-list state (a checkpoint round trip may have
        # turned arrays into lists)
        if len(self._bins) != self.batch_size:
            raise ValueError("packer state bin count mismatch")
        self._fill = [sum(len(d) for d in docs) for docs in self._bins]
        if any(f > self.seq_len for f in self._fill):
            raise ValueError("packer state overflows seq_len")
