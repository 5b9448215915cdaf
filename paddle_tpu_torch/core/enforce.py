"""Error-enforcement machinery — port of ``paddle_tpu/core/enforce.py``
(reference: ``paddle/phi/core/enforce.h`` /
``paddle/fluid/platform/enforce.h`` — the PADDLE_ENFORCE_* macro family
raising EnforceNotMet with a formatted error summary + call-stack).

Python-native rebuild: ``enforce*`` helpers raise :class:`EnforceNotMet`
carrying the failed condition, a user message, and the captured Python
stack (the C++ version captures the C++ stack; here the Python frames ARE
the useful context). Ops and user code use these for precondition checks
with reference-style error text.
"""
from __future__ import annotations

import traceback
from typing import Any, Optional

__all__ = ["EnforceNotMet", "enforce", "enforce_eq", "enforce_ne",
           "enforce_gt", "enforce_ge", "enforce_lt", "enforce_le",
           "enforce_not_none", "enforce_shape_match"]


class EnforceNotMet(RuntimeError):
    """Reference: ``platform::EnforceNotMet`` — carries the error summary
    and the captured stack."""

    def __init__(self, message: str, stack: Optional[str] = None):
        self.error_str = message
        self.stack = stack or "".join(traceback.format_stack()[:-2])
        super().__init__(
            f"\n\n--------------------------------------\n"
            f"C++ Traceback (most recent call last):\n"
            f"--------------------------------------\n"
            f"(python-native build: python stack below)\n\n"
            f"----------------------\nError Message Summary:\n"
            f"----------------------\n{message}\n\n{self.stack}")


def _fail(cond_str: str, message: str):
    raise EnforceNotMet(
        f"InvalidArgumentError: Expected {cond_str}, but received the "
        f"opposite. {message}")


def enforce(condition: Any, message: str = ""):
    """PADDLE_ENFORCE: the condition must be truthy."""
    if not condition:
        _fail("condition to be true", message)


def enforce_eq(a, b, message: str = ""):
    if not (a == b):
        _fail(f"{a!r} == {b!r}", message)


def enforce_ne(a, b, message: str = ""):
    if not (a != b):
        _fail(f"{a!r} != {b!r}", message)


def enforce_gt(a, b, message: str = ""):
    if not (a > b):
        _fail(f"{a!r} > {b!r}", message)


def enforce_ge(a, b, message: str = ""):
    if not (a >= b):
        _fail(f"{a!r} >= {b!r}", message)


def enforce_lt(a, b, message: str = ""):
    if not (a < b):
        _fail(f"{a!r} < {b!r}", message)


def enforce_le(a, b, message: str = ""):
    if not (a <= b):
        _fail(f"{a!r} <= {b!r}", message)


def enforce_not_none(value, message: str = ""):
    if value is None:
        _fail("value to be not None", message)
    return value


def enforce_shape_match(shape_a, shape_b, message: str = ""):
    """Shape compatibility with -1/None wildcards (the InferMeta-style
    check ops use at the Python boundary)."""
    a, b = list(shape_a), list(shape_b)
    if len(a) != len(b):
        _fail(f"rank {len(a)} == rank {len(b)}",
              f"shapes {a} vs {b}. {message}")
    for i, (x, y) in enumerate(zip(a, b)):
        wild = (x in (-1, None)) or (y in (-1, None))
        if not wild and x != y:
            _fail(f"shape[{i}] {x} == {y}", f"shapes {a} vs {b}. {message}")
