"""Core helpers of the port (``paddle_tpu/core``'s counterpart): dtype
names and the RNG state."""
