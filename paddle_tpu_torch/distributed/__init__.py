"""Distributed layers of the port (``paddle_tpu/distributed``'s
counterpart). Only the Mixture-of-Experts layer of ``fleet`` is ported so
far, on one device; meshes, collectives and sharding are not."""
