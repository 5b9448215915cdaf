"""``paddle.framework`` of the port: ``save`` and ``load``."""
from .io import load, save  # noqa: F401

__all__ = ["save", "load"]
