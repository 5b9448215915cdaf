"""Checkpointing of the port (``paddle_tpu/checkpoint``'s counterpart):
async save with atomic commit, crc-verified restore, in the reference's
on-disk format (a step directory written by either package restores in
the other)."""
from . import layout, manager, reshard, writer  # noqa: F401
from .layout import (  # noqa: F401
    CheckpointError, CheckpointIntegrityError, is_checkpoint_dir,
    list_committed_steps,
)
from .manager import CheckpointManager, load_state_dir  # noqa: F401
from .reshard import place_on_mesh, read_state  # noqa: F401
from .writer import SaveFuture, snapshot  # noqa: F401

__all__ = ["CheckpointManager", "load_state_dir", "read_state",
           "place_on_mesh", "snapshot", "SaveFuture", "CheckpointError",
           "CheckpointIntegrityError", "is_checkpoint_dir",
           "list_committed_steps", "layout", "writer", "manager",
           "reshard"]
