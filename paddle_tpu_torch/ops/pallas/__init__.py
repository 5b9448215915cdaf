"""Hand-written CUDA kernels of the port, one per Pallas TPU kernel of
``paddle_tpu/ops/pallas``, each beside its plain PyTorch version
(sources in ``csrc/``, built by ``_build``)."""
