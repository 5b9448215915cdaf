"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The JAX package (``paddle_tpu``) stays the reference; this package
mirrors it path for path, written in PyTorch for one NVIDIA H100. Every
Pallas kernel on a ported path becomes a kernel written by hand for
Hopper (``ops/pallas/csrc/``), built with ``nvcc`` at first use and
bound through ``ctypes``; everything around the kernels is plain
PyTorch. The package never imports ``jax`` or ``paddle_tpu``.

Entry points run on the card unless the caller passes ``device="cpu"``;
on a CPU tensor a kernel wrapper computes its plain PyTorch version,
which is how the CPU tests hold the port against the reference.

Ported so far: the serving path — ``serving.ServingEngine`` and its
HTTP ``serving.Server`` over ``models.llama.LlamaForCausalLM``, with
attention over the paged KV pool in the ragged-paged-attention kernel —
and the training path — ``jit.TrainStep`` over the cacheless
``LlamaForCausalLM`` and its causal-LM loss (``ops.fused_ce``), with
attention in the flash-attention forward, dq and dk/dv kernels, and the
optimizer layer: Paddle's rules (``optimizer``: SGD, Momentum, Adam,
AdamW, Adagrad, RMSProp, Adadelta, Adamax, Lamb) with f32 master
weights, the learning-rate schedulers (``optimizer.lr``), the clips of
``nn.clip`` and the regularizers, under ``TrainStep``'s fused
multi-tensor update (``jit.fused_update``, one hand-written pass per
Adam/AdamW bucket). The MoE family (``models.moe``) trains through the
same step, with the grouped-matmul kernels at ``ops.pallas``. ERNIE
(``models.ernie``) and DiT (``models.dit``) train through it too, on the
transformer layer set of ``nn`` (biased ``Linear``, ``LayerNorm``,
``MultiHeadAttention``, the encoder and decoder stacks, ``Conv2D``, the
activations, losses and initializers); ``metric`` holds the metrics of
``hapi.Model.prepare``. ``seed(n)`` seeds the port's generator
(``core.generator``), from which dropout and the initializers draw.
"""
from . import metric
from .core.generator import seed

__all__ = ["metric", "seed"]
