"""Device resolution for the port (``paddle_tpu/device``'s counterpart).

Every entry point of the port runs on the card unless the caller names
another device: ``resolve_device(None)`` is ``cuda``, and asking for
``cuda`` where PyTorch sees no card raises instead of moving the work to
the CPU.
"""
from __future__ import annotations

import subprocess

import torch

__all__ = ["resolve_device", "card_name"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"``/``"cuda"``/``"cuda:N"`` or a
    ``torch.device`` as given. Raises when a CUDA device is asked for and
    none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default, and PyTorch "
            "sees none here; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (want cuda or cpu)")
    return dev


def card_name() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them
    (``name, power.limit``), one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=30)
    return out.stdout.strip()
