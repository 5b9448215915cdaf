"""Hand-written CUDA kernels of the port, one per Pallas TPU kernel of
``paddle_tpu/ops/pallas``, each beside its plain PyTorch version
(sources in ``csrc/``, built by ``_build``).

The package re-exports ``flash_attention_bshd``, as the reference's does
(:5). It does not rebind ``ragged_paged_attention`` to the entry point
(reference :6): that name stays its submodule, which the port's modules
and tests import for its counters and helpers, and the entry point is
``ragged_paged_attention.ragged_paged_attention``."""
from . import ragged_paged_attention  # noqa: F401
from .flash_attention import flash_attention_bshd  # noqa: F401
