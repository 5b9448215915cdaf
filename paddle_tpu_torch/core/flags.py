"""Global flag registry — port of ``paddle_tpu/core/flags.py``.

Paddle's ``set_flags``/``get_flags`` over plain Python values, each
overridable from the environment (``FLAGS_<name>``). Only the flags the
port honours are defined: ``check_nan_inf`` (the op library checks every
floating output for NaN/Inf), ``default_dtype`` (the floating dtype of
the creation ops), ``benchmark`` (the op library waits for the card
after every op) and ``use_autotune`` (``ops/pallas/autotune.py`` sweeps
the RPA kernel's q tile and the fused cross entropy's chunk count once
per signature on the card and caches the winner). ``set_flags`` of any
other name defines it, as in the reference; the port reads none of
those.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Iterable, Union

_REGISTRY: Dict[str, "_Flag"] = {}


class _Flag:
    __slots__ = ("name", "value", "default", "doc", "type")

    def __init__(self, name: str, default: Any, doc: str = ""):
        self.name = name
        self.default = default
        self.doc = doc
        self.type = type(default)
        env = os.environ.get("FLAGS_" + name)
        if env is not None:
            self.value = _parse(env, self.type)
        else:
            self.value = default


def _parse(s: str, ty):
    if ty is bool:
        return s.lower() in ("1", "true", "yes", "on")
    if ty is int:
        return int(s)
    if ty is float:
        return float(s)
    return s


def define_flag(name: str, default: Any, doc: str = "") -> None:
    if name not in _REGISTRY:
        _REGISTRY[name] = _Flag(name, default, doc)


def set_flags(flags: Dict[str, Any]) -> None:
    """paddle.set_flags parity (reference: pybind global_value_getter_setter.cc)."""
    for k, v in flags.items():
        k = k[len("FLAGS_"):] if k.startswith("FLAGS_") else k
        if k not in _REGISTRY:
            define_flag(k, v)
        else:
            _REGISTRY[k].value = v


def get_flags(flags: Union[str, Iterable[str]]) -> Dict[str, Any]:
    if isinstance(flags, str):
        flags = [flags]
    out = {}
    for k in flags:
        key = k[len("FLAGS_"):] if k.startswith("FLAGS_") else k
        if key not in _REGISTRY:
            raise ValueError(f"unknown flag {k!r}")
        out[k] = _REGISTRY[key].value
    return out


def flag(name: str) -> Any:
    """Fast internal accessor."""
    return _REGISTRY[name].value


# The flags the port honours.
define_flag("check_nan_inf", False, "check every op output for NaN/Inf (reference: FLAGS_check_nan_inf)")
define_flag("default_dtype", "float32", "default floating dtype for tensor creation")
define_flag("benchmark", False, "wait for the card after every op of the op library, for timing")
define_flag("use_autotune", False, "sweep the RPA q tile and the fused-CE chunk count once per signature on the card and cache the winner (reference: FLAGS_use_autotune + phi/kernels/autotune)")
