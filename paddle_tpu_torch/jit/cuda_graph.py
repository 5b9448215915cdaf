"""Capture a callable on the card as a CUDA graph, and replay it.

This helper has no file in the JAX package: it is the port's counterpart
of XLA's cache of compiled programs, on which the reference's
``jit.to_static`` and ``models.generation.compiled_generate`` rest. The
reference traces a function once per signature and runs the compiled
executable; the port runs the function once more on the card under
stream capture and then replays the recorded launches, with no Python in
between.

:class:`CapturedGraph` does one job:

* it runs the callable once on a side stream first (one warm-up, a real
  run whose result is the caller's first), so that everything
  that may not happen under capture happens before it: the kernels'
  builds (``ops/pallas/_build.py``), their one ``cudaFuncSetAttribute``
  each, cuBLAS's workspace and PyTorch's lazy initialisations;
* it captures into a private memory pool, on that side stream, so the
  graph's tensors outlive the call and nothing else allocates into them;
* it registers every ``torch.Generator`` the captured region draws from
  (``CUDAGraph.register_generator_state``), so each replay draws new
  numbers (an unregistered generator would repeat one dropout mask or one
  sample on every replay);
* a replay adds the launch counts the capture recorded to the kernels'
  counters (the registry of ``ops/pallas/counters.py``): those are
  Python integers that a wrapper
  bumps when it launches, so they count once while the launches are
  recorded, and the capture itself, which runs nothing, gives its counts
  back.

The callable reads its inputs from tensors that the caller keeps (the
static inputs) and the graph writes its outputs into the tensors it
returned at capture (:attr:`CapturedGraph.outputs`); a caller copies new
inputs in before :meth:`CapturedGraph.replay` and clones what it hands
on. CPU tensors are refused: a caller on the CPU takes its eager route
through an explicit branch on the device, and nothing on the card falls
back to eager. A capture that fails raises.
"""
from __future__ import annotations

import time

from typing import Callable, Dict, Iterable, Tuple

import torch

from paddle_tpu_torch.ops.pallas import counters

__all__ = ["CapturedGraph", "captures"]

#: CUDA graphs captured by this process (each :meth:`CapturedGraph.capture`)
captures = 0


class CapturedGraph:
    """``fn`` (no arguments) captured on ``device``'s card (by default the
    card every entry point defaults to) as one CUDA graph.
    ``generators`` are the ``torch.Generator``s of that card that ``fn``
    draws from. ``fn`` runs once on the side stream before the capture, a
    real run with its effects, and a caller takes that run's result as
    its first call's. The capture itself runs nothing."""

    def __init__(self, fn: Callable, device=None, generators: Iterable = ()):
        from paddle_tpu_torch.device import resolve_device
        device = resolve_device(device)
        if device.type != "cuda":
            raise ValueError(
                f"CUDA-graph capture runs on the card, not {device}: a "
                f"caller on the CPU takes its eager route")
        self._fn = fn
        self._device = device
        self._generators = tuple(generators)
        self._graph = None
        #: what ``fn`` returned at capture: the tensors each replay
        #: writes
        self.outputs = None
        #: the kernel launches one replay makes, by counter
        self.per_replay: Dict[Tuple[str, str], int] = {}

    def capture(self):
        """Warm up, then capture ``fn``. Returns what the warm-up run
        returned (a real result; :attr:`outputs` holds the graph's)."""
        global captures
        t0 = time.perf_counter()
        with torch.cuda.device(self._device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                result = self._fn()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            for g in self._generators:
                graph.register_generator_state(g)
            before = counters.read()
            with torch.cuda.graph(graph, stream=side):
                outputs = self._fn()
            after = counters.read()
        # the capture ran nothing: give its counts back
        self.per_replay = {c: n - before.get(c, 0) for c, n in after.items()
                           if n != before.get(c, 0)}
        counters.add({c: -n for c, n in self.per_replay.items()})
        self._graph = graph
        self.outputs = outputs
        captures += 1
        # a one-time cost: the goodput ledger's compile bin
        from paddle_tpu_torch.observability import goodput
        goodput.record_compile(time.perf_counter() - t0)
        return result

    def replay(self):
        """Run the captured launches once on the current stream. Returns
        :attr:`outputs`, which the replay has written."""
        if self._graph is None:
            raise RuntimeError("replay() before capture()")
        self._graph.replay()
        counters.add(self.per_replay)
        return self.outputs
