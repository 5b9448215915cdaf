"""Utilities of the port (the numpy state-dict bridge)."""
