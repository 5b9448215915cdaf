"""Bucketed data-parallel gradient collectives — port of
``paddle_tpu/jit/bucketing.py``.

The step's gradients are reduced in size-targeted buckets rather than
one collective per parameter: parameters fill buckets in reverse
registration order (the backward produces gradients output to input, so
the first bucket to fill is the first that can be reduced), a bucket
closes at its byte target or where the gradient dtype changes, and
every bucket holds at least one parameter. ``jit.TrainStep`` issues each
bucket's all-reduce asynchronously as its last gradient lands, so it
overlaps the rest of the backward.

The reference's ``PADDLE_TPU_BUCKETED_GRADS`` and
``PADDLE_TPU_COMM_BUCKET_MB`` are arguments here, with its defaults:
``TrainStep(bucketed=...)`` (on unless ``False``) and the bucket size
in MB (``DataParallel(comm_buffer_size=25)``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = ["plan_comm_buckets", "comm_bucket_bytes", "bucketed_eligibility",
           "DEFAULT_BUCKET_MB"]

DEFAULT_BUCKET_MB = 25.0


def comm_bucket_bytes(mb: float = DEFAULT_BUCKET_MB) -> int:
    """Target payload bytes of a gradient bucket."""
    return max(int(float(mb) * 1024 * 1024), 1)


def plan_comm_buckets(train: Dict[str, object],
                      target_bytes: Optional[int] = None
                      ) -> List[Tuple[str, ...]]:
    """Partition ``train`` (name -> tensor, registration order) into
    size-targeted buckets in reverse registration order (reference
    :61-90)."""
    if target_bytes is None:
        target_bytes = comm_bucket_bytes()
    buckets: List[Tuple[str, ...]] = []
    cur: List[str] = []
    cur_bytes = 0
    cur_dtype = None
    for name in reversed(list(train.keys())):
        t = train[name]
        nbytes = t.numel() * t.element_size()
        if cur and (cur_dtype != t.dtype or
                    cur_bytes + nbytes > target_bytes):
            buckets.append(tuple(cur))
            cur, cur_bytes = [], 0
        cur.append(name)
        cur_bytes += nbytes
        cur_dtype = t.dtype
    if cur:
        buckets.append(tuple(cur))
    return buckets


def bucketed_eligibility(mesh, batch_axes, zero_level=None) -> Optional[str]:
    """None when the step reduces gradients in buckets; otherwise why not
    (each parameter is then reduced on its own after the backward)."""
    if mesh is None:
        return "no mesh"
    if not batch_axes:
        return "the batch is not split over any mesh axis"
    if zero_level in ("os_g", "p_g_os"):
        return f"ZeRO level {zero_level} reduce-scatters its gradients"
    return None
