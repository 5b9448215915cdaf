"""RNG state — port of ``paddle_tpu/core/generator.py``.

Paddle's stateful-seed interface over ``torch.Generator``s: a
:class:`Generator` holds one seed and one ``torch.Generator`` per device,
made at first use and seeded with that seed, so a draw on the card never
waits on the host and a draw on the host never touches the card.
``seed(n)`` reseeds the default generator; dropout masks, the flash
kernels' dropout seed and the initializers of ``nn.initializer`` draw
from it. Host-side integers (the flash dropout seed) come from the CPU
stream, so drawing one does not synchronise with the card. The
reference's named streams for tensor parallelism (``RNGStatesTracker``)
wait for the distributed slice.

The JAX package derives keys with ``fold_in(key(seed), n)``; PyTorch's
Philox streams give other numbers from the same seed, so dropout masks
and initial weights differ between the packages by contract, and parity
tests carry weights across through numpy.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

__all__ = ["Generator", "default_generator", "seed", "get_rng_state",
           "set_rng_state", "rng_guard", "torch_generator", "host_int"]


def _key(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


class Generator:
    """A seed and one ``torch.Generator`` per device, all seeded with it."""

    def __init__(self, seed: int = 0):
        self._seed = int(seed)
        self._gens: dict = {}

    def manual_seed(self, seed: int) -> "Generator":
        self._seed = int(seed)
        for g in self._gens.values():
            g.manual_seed(self._seed)
        return self

    def seed(self) -> int:
        return self._seed

    def torch_generator(self, device="cpu") -> torch.Generator:
        """The ``torch.Generator`` of ``device``, made and seeded at
        first use."""
        key = _key(device)
        g = self._gens.get(key)
        if g is None:
            g = torch.Generator(device=key).manual_seed(self._seed)
            self._gens[key] = g
        return g

    def get_state(self):
        """``(seed, {device: state tensor})``."""
        return (self._seed, {k: g.get_state().clone()
                             for k, g in self._gens.items()})

    def set_state(self, state):
        seed, states = state
        self._seed = int(seed)
        self._gens = {}
        for key, st in states.items():
            self.torch_generator(key).set_state(st.clone())


default_generator = Generator(0)


def seed(s: int) -> Generator:
    """``paddle.seed``: reseed the default generator."""
    return default_generator.manual_seed(s)


def get_rng_state():
    return default_generator.get_state()


def set_rng_state(state):
    default_generator.set_state(state)


def torch_generator(device) -> torch.Generator:
    """The default generator's ``torch.Generator`` for ``device``."""
    return default_generator.torch_generator(device)


def host_int(low: int = -2**31, high: int = 2**31 - 1) -> int:
    """One integer in ``[low, high)`` from the default generator's CPU
    stream (no device synchronisation)."""
    return int(torch.randint(low, high, (1,),
                             generator=torch_generator("cpu")))


@contextlib.contextmanager
def rng_guard(seed_value: int, generator: Optional[Generator] = None):
    """Run the block on ``generator`` (default: the default generator)
    reseeded with ``seed_value``, then restore its streams as they were:
    the block's draws repeat whenever it runs with the same seed."""
    gen = generator or default_generator
    saved = gen.get_state()
    gen._gens = {}
    gen._seed = int(seed_value)
    try:
        yield gen
    finally:
        gen.set_state(saved)
