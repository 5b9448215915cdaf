"""Devices of the port — port of ``paddle_tpu/device/__init__.py``
(``set_device`` and its queries, :155-279).

Every entry point of the port runs on the device that
:func:`resolve_device` gives for ``None``: the one :func:`set_device`
chose, and ``cuda`` while no choice was made. ``set_device("cpu")`` is
the caller asking for the CPU; asking for a card where PyTorch sees none
raises, from ``set_device`` and from ``resolve_device`` alike, instead of
moving the work to the CPU. The choice is process-wide.
"""
from __future__ import annotations

import subprocess

import torch

from . import cuda  # noqa: F401

__all__ = ["resolve_device", "card_name", "set_device", "get_device",
           "get_available_device", "get_all_custom_device_type",
           "get_available_custom_device", "device_count", "synchronize",
           "memory_stats", "memory_allocated", "max_memory_allocated",
           "reset_max_memory_allocated", "is_compiled_with_cuda",
           "is_compiled_with_rocm", "is_compiled_with_xpu",
           "is_compiled_with_npu", "is_compiled_with_custom_device", "cuda"]

#: the device ``set_device`` chose (None: no choice, the card)
_chosen = [None]


def _torch_device(device) -> torch.device:
    """Paddle's spellings (``"gpu"``, ``"gpu:1"``, ``"cpu"``) and torch's
    (``"cuda:1"``, a ``torch.device``, an index) -> ``torch.device``."""
    if isinstance(device, torch.device):
        return device
    if isinstance(device, int):
        return torch.device("cuda", device)
    name = str(device).strip().lower()
    plat, _, idx = name.partition(":")
    plat = {"gpu": "cuda"}.get(plat, plat)
    if plat not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (want gpu, gpu:N "
                         f"or cpu)")
    return torch.device(plat, int(idx)) if idx else torch.device(plat)


def resolve_device(device=None) -> torch.device:
    """``None`` -> the device ``set_device`` chose, else ``cuda``; any
    other spelling as given. Raises when a CUDA device is asked for and
    none is available."""
    if device is None:
        device = _chosen[0] if _chosen[0] is not None else "cuda"
    dev = _torch_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (want cuda or cpu)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default, and PyTorch "
            "sees none here; pass device='cpu' or call "
            "paddle_tpu_torch.set_device('cpu') to run on the CPU")
    return dev


def set_device(device: str) -> str:
    """Choose the device every entry point defaults to: ``"gpu"``,
    ``"gpu:N"`` or ``"cpu"``. Returns the choice in Paddle's spelling.
    Raises for a card PyTorch cannot see."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None and \
            dev.index >= torch.cuda.device_count():
        raise ValueError(f"{device!r}: only {torch.cuda.device_count()} "
                         f"card(s)")
    _chosen[0] = dev
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    return get_device()


def get_device() -> str:
    """The default device in Paddle's spelling (``"gpu:0"``, ``"cpu"``)."""
    dev = _chosen[0]
    if dev is None:
        if not torch.cuda.is_available():
            return "cpu"
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cpu":
        return "cpu"
    return f"gpu:{dev.index if dev.index is not None else torch.cuda.current_device()}"


def get_available_device():
    return [f"gpu:{i}" for i in range(device_count())]


def get_all_custom_device_type():
    """The platforms of the available devices other than ``cpu`` and
    ``gpu`` (reference :173-175): none on a CUDA card."""
    return sorted({d.split(":")[0] for d in get_available_device()}
                  - {"cpu", "gpu"})


def get_available_custom_device():
    """The available devices of a platform other than ``cpu`` and ``gpu``
    (reference :178-180): none on a CUDA card."""
    return [d for d in get_available_device()
            if d.split(":")[0] not in ("cpu", "gpu")]


def device_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def synchronize(device=None):
    """Wait for the card's queued work (a no-op on the CPU)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def memory_stats(device=None) -> dict:
    """The caching allocator's statistics for the card
    (``torch.cuda.memory_stats``), plus the reference's keys
    ``bytes_in_use``, ``peak_bytes_in_use`` and ``bytes_limit``. Empty
    on the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {}
    stats = dict(torch.cuda.memory_stats(dev))
    stats["bytes_in_use"] = torch.cuda.memory_allocated(dev)
    stats["peak_bytes_in_use"] = torch.cuda.max_memory_allocated(dev)
    stats["bytes_limit"] = torch.cuda.get_device_properties(dev).total_memory
    return stats


def memory_allocated(device=None) -> int:
    return int(memory_stats(device).get("bytes_in_use", 0))


def max_memory_allocated(device=None) -> int:
    return int(memory_stats(device).get("peak_bytes_in_use", 0))


def reset_max_memory_allocated(device=None) -> bool:
    """Reset the peak so ``max_memory_allocated`` counts from here on.
    False on the CPU, which keeps no peak."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return False
    torch.cuda.reset_peak_memory_stats(dev)
    return True


def is_compiled_with_cuda() -> bool:
    return torch.version.cuda is not None


def is_compiled_with_rocm() -> bool:
    return getattr(torch.version, "hip", None) is not None


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_npu() -> bool:
    return False


def is_compiled_with_custom_device(device_type: str = "tpu") -> bool:
    return False


def card_name() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them
    (``name, power.limit``), one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=30)
    return out.stdout.strip()
