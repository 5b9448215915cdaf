"""Distributed layers of the port (``paddle_tpu/distributed``'s
counterpart). Of ``fleet``, the Mixture-of-Experts layer, ``recompute``
and ``DistributedStrategy`` are ported so far, on one device; meshes,
collectives and sharding are not."""
