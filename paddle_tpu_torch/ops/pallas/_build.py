"""Build and load the port's CUDA kernels (no JAX counterpart).

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc`` for ``sm_90a`` into a shared library, which the kernel's
wrapper loads with ``ctypes``. A source builds at its first use, into
``_build_cache/`` beside this file (listed in ``.gitignore``), under a
name keyed by a hash of the source, the shared headers (``csrc/*.cuh``)
and the flags, so an edited source or header never loads a stale
library. :func:`build` starts one ``nvcc`` per
source, all at once, and waits for all of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build", "load", "sources"]

_HERE = Path(__file__).resolve().parent
_SRC_DIR = _HERE / "csrc"
_CACHE_DIR = _HERE / "_build_cache"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict = {}


def sources() -> list:
    """Names of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in _SRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); "
            "the port's CUDA kernels build on a machine with the CUDA "
            "toolkit")
    return path


def _target(name: str) -> Path:
    """The library's path, keyed by the source, every shared header of
    ``csrc/`` (a ``.cu`` may include any of them) and the flags."""
    h = hashlib.sha256((_SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(_SRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _CACHE_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile the named sources (default: all) that are not built yet.
    Returns ``{name: {"seconds": s, "log": compiler output}}`` for the
    sources compiled by this call; raises with the compiler's output if
    any fails."""
    names = sources() if names is None else list(names)
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return {}
    _CACHE_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_SRC_DIR / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out, failed = {}, []
    for n, (tmp, p) in procs.items():
        try:
            log, _ = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            p.kill()
            log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{n}.cu (exit {p.returncode}):\n{log}")
            continue
        os.replace(tmp, _target(n))  # atomic: a reader never sees half
        out[n] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    # a one-time cost on the step's path: the goodput ledger's compile bin
    from paddle_tpu_torch.observability import goodput
    goodput.record_compile(time.perf_counter() - t0)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _loaded[name] = lib
        return lib
