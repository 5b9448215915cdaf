"""Auto-checkpoint: epoch-scoped snapshot and resume — port of
``paddle_tpu/incubate/checkpoint.py`` (Paddle's
``fluid/incubate/checkpoint/auto_checkpoint.py`` ``train_epoch_range``).

Persistence goes through ``checkpoint.CheckpointManager``, one committed
step per epoch (step number = epoch): the model's and the optimizer's
state commit together, so a crash mid-save leaves only an uncommitted
directory and the resume falls back to the last committed epoch. A
``meta.json`` mirror, written after each commit, names the last epoch;
a job from before the manager (``meta.json`` beside ``model.pdparams``
and ``opt.pdopt``) restores through those two files. The layout is the
reference's, so either package resumes the other's job.
"""
from __future__ import annotations

import json
import os
from typing import Iterator, Optional

__all__ = ["TrainEpochRange", "train_epoch_range"]


class TrainEpochRange:
    """Epochs with an automatic snapshot after each and a resume after
    the last saved one::

        for epoch in TrainEpochRange(10, "ckpt_dir", model=m, optimizer=o):
            train_one_epoch()

    ``save_dir`` defaults to ``$PADDLE_CHECKPOINT_DIR`` (else
    ``./paddle_tpu_auto_ckpt``) and the job name to ``$PADDLE_JOB_ID``
    (else ``default``), as in the reference."""

    def __init__(self, max_epoch_num: int, save_dir: Optional[str] = None,
                 model=None, optimizer=None, save_checkpoint_inter: int = 1,
                 name: Optional[str] = None, keep_last_k: Optional[int] = 2,
                 async_: bool = False):
        from paddle_tpu_torch.checkpoint import CheckpointManager
        self.max_epoch_num = int(max_epoch_num)
        self.save_dir = save_dir or os.environ.get(
            "PADDLE_CHECKPOINT_DIR", "./paddle_tpu_auto_ckpt")
        job = name or os.environ.get("PADDLE_JOB_ID", "default")
        self._dir = os.path.join(self.save_dir, job)
        self.model = model
        self.optimizer = optimizer
        self.inter = max(int(save_checkpoint_inter), 1)
        self._meta = os.path.join(self._dir, "meta.json")
        # synchronous by default: an epoch a process believed durable
        # must not be lost with it
        self._mgr = CheckpointManager(self._dir, keep_last_k=keep_last_k,
                                      async_=async_)
        self.restored_from = self._restore()

    def _device(self):
        p = None if self.model is None else next(
            iter(self.model.parameters()), None)
        return "cpu" if p is None else p.device

    # -- persistence ---------------------------------------------------------
    def _restore(self) -> int:
        """Restore the newest committed epoch; the next epoch to run (0
        without a checkpoint)."""
        if self._mgr.latest_step() is None:
            return self._restore_legacy()
        state = self._mgr.restore(device=self._device())
        self._load(state.get("model"), state.get("optimizer"))
        return self._mgr.last_restored_step + 1

    def _load(self, model_state, opt_state):
        if self.model is not None and model_state is not None:
            self.model.set_state_dict(model_state)
        if self.optimizer is not None and opt_state is not None and \
                hasattr(self.optimizer, "set_state_dict"):
            self.optimizer.set_state_dict(opt_state)

    def _restore_legacy(self) -> int:
        """The layout from before the manager: ``meta.json`` with
        ``model.pdparams`` and ``opt.pdopt``."""
        if not os.path.exists(self._meta):
            return 0
        from paddle_tpu_torch.framework.io import load
        with open(self._meta) as f:
            meta = json.load(f)
        paths = [os.path.join(self._dir, n)
                 for n in ("model.pdparams", "opt.pdopt")]
        self._load(*(load(p, device=self._device()) if os.path.exists(p)
                     else None for p in paths))
        return int(meta.get("epoch", -1)) + 1

    def _save(self, epoch: int):
        state = {}
        if self.model is not None:
            state["model"] = self.model.state_dict()
        if self.optimizer is not None and hasattr(self.optimizer,
                                                  "state_dict"):
            state["optimizer"] = self.optimizer.state_dict()
        # overwrite: an epoch re-run after a fallback may find its step
        # committed (and corrupt) on disk
        self._mgr.save(epoch, state, overwrite=True,
                       metadata={"epoch": epoch,
                                 "max_epoch_num": self.max_epoch_num})
        self._write_meta()

    def _write_meta(self):
        """The mirror, written only once its step committed."""
        last = self._mgr.latest_step()
        if last is None:
            return
        tmp = self._meta + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"epoch": last, "max_epoch_num": self.max_epoch_num},
                      f)
        os.replace(tmp, self._meta)

    def wait(self):
        """Wait for saves in flight and bring the mirror up to date."""
        self._mgr.wait_all()
        self._write_meta()

    # -- iteration -----------------------------------------------------------
    def __iter__(self) -> Iterator[int]:
        try:
            for epoch in range(self.restored_from, self.max_epoch_num):
                yield epoch
                if (epoch + 1) % self.inter == 0 or \
                        epoch == self.max_epoch_num - 1:
                    self._save(epoch)
        finally:
            # an early break must not lose a save in flight
            self.wait()


def train_epoch_range(max_epoch_num: int, save_checkpoint_inter: int = 1,
                      **kwargs) -> TrainEpochRange:
    """Paddle's ``acp.train_epoch_range(n)``."""
    return TrainEpochRange(max_epoch_num,
                           save_checkpoint_inter=save_checkpoint_inter,
                           **kwargs)
