"""Chaos harness — port of ``paddle_tpu/resilience/chaos.py``: fault
seams that prove the recovery paths end to end.

* ``kill_at_step=N`` — SIGKILL this process right after fit step ``N``
  completes (a hard preemption or a lost host).
* ``hang_collective="op[:seconds]"`` (or ``(op, seconds)``) — the
  first traced collective named ``op`` sleeps ``seconds`` (default 3600)
  inside its comm span (a wedged all-reduce: the watchdog's collective
  deadline should fire first).
* ``poison_batch={N, ...}`` — NaN-fill the floating leaves of those fit
  steps' batches (a corrupt shard). A batch with no floating leaf (a
  packed pipeline's, all token ids) cannot hold a NaN: the fault
  escalates to corrupting that step's loss instead, so the NaN guard
  still sees it.
* ``corrupt_loss={N, ...}`` — replace those steps' losses with NaN after
  the train step (a host-side blow-up).
* ``mark_dir=path`` — each event fires at most once a job: a marker file
  is written before it fires, so a relaunched worker replaying the same
  steps does not die again.

Step numbers are the fit loop's 1-based batch counter. The reference
reads ``PADDLE_TPU_CHAOS_{KILL_AT_STEP,HANG_COLLECTIVE,POISON_BATCH,
CORRUPT_LOSS,MARK_DIR}`` (they cross a launcher's process boundary); the
port reads no environment variable: :func:`configure` sets them (a
launched worker takes them as arguments), and ``Model.fit`` runs the
seams while :func:`enabled`.
"""
from __future__ import annotations

import os
import signal
import sys
import time
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

__all__ = ["configure", "refresh", "enabled", "kill_at_step",
           "poison_batch", "corrupt_loss", "active_config"]

_cfg: dict = {"kill": None, "hang": None, "poison": frozenset(),
              "corrupt": frozenset(), "mark_dir": None}


def configure(kill_at_step: Optional[int] = None,
              hang_collective: Optional[Tuple[str, float]] = None,
              poison_batch: Iterable[int] = (),
              corrupt_loss: Iterable[int] = (),
              mark_dir: Optional[str] = None) -> dict:
    """Set the faults (everything off by default: ``configure()`` clears
    them) and (un)install the collective hang hook."""
    _cfg["kill"] = None if kill_at_step is None else int(kill_at_step)
    if hang_collective is not None:
        # "op[:seconds]" as the reference's variable, or (op, seconds)
        op, *secs = hang_collective.split(":", 1) \
            if isinstance(hang_collective, str) else tuple(hang_collective)
        hang_collective = (str(op), float(secs[0]) if secs else 3600.0)
    _cfg["hang"] = hang_collective
    _cfg["poison"] = frozenset(int(s) for s in poison_batch)
    _cfg["corrupt"] = frozenset(int(s) for s in corrupt_loss)
    _cfg["mark_dir"] = mark_dir
    return refresh()


def refresh() -> dict:
    """Re-apply the configuration: clear pending loss corruptions and
    (un)install the collective hang hook."""
    _poison_loss_steps.clear()
    from paddle_tpu_torch.observability import comm
    comm._chaos_hook = _hang_hook if _cfg["hang"] else None
    return dict(_cfg)


def active_config() -> dict:
    return dict(_cfg)


def enabled() -> bool:
    return bool(_cfg["kill"] is not None or _cfg["hang"] or _cfg["poison"]
                or _cfg["corrupt"])


def _fire_once(event: str) -> bool:
    """True if ``event`` should fire now; with a mark dir, each event
    fires at most once a job (the marker outlives the process)."""
    d = _cfg["mark_dir"]
    if d is None:
        return True
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"chaos_{event}")
    if os.path.exists(path):
        return False
    with open(path, "w") as f:
        f.write(f"{os.getpid()} {time.time()}\n")
        f.flush()
        os.fsync(f.fileno())
    return True


# -- seams (called from the fit loop / comm_scope) ----------------------------

def kill_at_step(step: int):
    """SIGKILL: no atexit, no finally, no flushed buffers, as a preempted
    host looks to a launcher."""
    if _cfg["kill"] is not None and step == _cfg["kill"] \
            and _fire_once(f"kill_step{step}"):
        print(f"[chaos] SIGKILL at step {step}", file=sys.stderr, flush=True)
        os.kill(os.getpid(), signal.SIGKILL)


def poison_batch(step: int, x):
    """NaN-fill the floating leaves (tensors or arrays) of a poisoned
    step's batch; a batch with none escalates to corrupting the step's
    loss."""
    if step not in _cfg["poison"] or not _fire_once(f"poison_step{step}"):
        return x
    hit = [False]
    out = _poison_tree(x, hit)
    if not hit[0]:
        print(f"[chaos] poison at step {step}: batch has no float "
              "leaves (packed int batch) — corrupting the step's loss "
              "instead", file=sys.stderr, flush=True)
        _poison_loss_steps.add(step)
    return out


def _poison_tree(x, hit):
    if isinstance(x, dict):
        return {k: _poison_tree(v, hit) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_poison_tree(e, hit) for e in x)
    if isinstance(x, torch.Tensor):
        if x.is_floating_point():
            hit[0] = True
            return torch.full_like(x, float("nan"))
        return x
    arr = np.asarray(x)
    if np.issubdtype(arr.dtype, np.floating):
        hit[0] = True
        return np.full_like(arr, np.nan)
    return x


# poisoned steps whose batch had no float leaf: corrupt_loss takes them
# in the same fit iteration (poison_batch runs before the train step,
# corrupt_loss after)
_poison_loss_steps: set = set()


def corrupt_loss(step: int, loss: float) -> float:
    if step in _poison_loss_steps:
        _poison_loss_steps.discard(step)
        return float("nan")
    if step in _cfg["corrupt"] and _fire_once(f"corrupt_step{step}"):
        return float("nan")
    return loss


def _hang_hook(op: str, axes_label: str):
    """Installed into ``observability.comm._chaos_hook``."""
    hang = _cfg["hang"]
    if hang is None or hang[0] != op:
        return
    if not _fire_once(f"hang_{op}"):
        return
    print(f"[chaos] hanging collective {op}@{axes_label} for {hang[1]}s",
          file=sys.stderr, flush=True)
    time.sleep(hang[1])
