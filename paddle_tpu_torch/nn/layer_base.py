"""``nn.Layer`` — port of ``paddle_tpu/nn/layer_base.py`` (:34-299).

A ``torch.nn.Module`` with Paddle's methods: ``create_parameter``,
``add_parameter``, ``add_sublayer``, ``register_buffer(persistable=)``,
``parameters``/``named_parameters(include_sublayers=)``, ``sublayers``,
``named_sublayers``, ``state_dict``/``set_state_dict`` (numpy or
tensors), ``register_forward_pre_hook``/``register_forward_post_hook``,
``to(device=, dtype=)`` in Paddle's spellings, ``astype``, ``full_name``
and ``clear_gradients``. Every layer and model of the port derives from
it, so ``isinstance(model, paddle.nn.Layer)`` holds as in Paddle; torch's
own methods keep working with torch's arguments, so state-dict keys,
parameter order and the numpy bridge are PyTorch's as before.

The facade boundary (``core/tensor.py``). The port's own layers (those
defined in this package) compute on plain tensors: a call from outside
unwraps Paddle ``Tensor`` arguments and, when it got any, wraps the
outputs; a call made inside a port layer's ``forward`` goes straight to
``torch.nn.Module.__call__`` (one thread-local read), so the training
step pays nothing for the facade. A user's ``Layer`` subclass is the
other side: its ``forward`` gets Paddle ``Tensor``s, and what it returns
goes back unwrapped when a port layer called it.
"""
from __future__ import annotations

import threading
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.core.dtype import DType, convert_dtype, dtype_name
from paddle_tpu_torch.core.tensor import (Parameter, _unwrap_tree, unwrap,
                                          unwrap_args, wrap)

__all__ = ["Layer"]

_Module = torch.nn.Module


class _State(threading.local):
    #: True while a port layer's forward runs on this thread
    in_port = False


_state = _State()


def _user_inputs(args, kwargs):
    """A user layer's inputs as Paddle ``Tensor``s; and whether the caller
    passed any."""
    found = [False]
    _unwrap_tree((args, kwargs), found)
    return wrap(args), wrap(kwargs) if kwargs else kwargs, found[0]


def _plain(out):
    return _unwrap_tree(out, [False])


class Layer(_Module):
    #: True for the port's own layers (their forward sees plain tensors)
    _port_layer = True

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        cls._port_layer = cls.__module__.startswith("paddle_tpu_torch.")

    def __init__(self, name_scope: Optional[str] = None, dtype="float32"):
        super().__init__()
        self._dtype = dtype_name(dtype)
        self._full_name = name_scope or type(self).__name__.lower()

    # -- the call ----------------------------------------------------------
    def __call__(self, *args, **kwargs):
        if self._port_layer:
            if _state.in_port:
                # in place of torch's ``_wrapped_call_impl``, not on top
                # of it: a nested call costs no more Python frames
                return (self._compiled_call_impl or self._call_impl)(
                    *args, **kwargs)
            args, kwargs, had = unwrap_args(args, kwargs)
            _state.in_port = True
            try:
                out = _Module.__call__(self, *args, **kwargs)
            finally:
                _state.in_port = False
            return wrap(out) if had else out
        was = _state.in_port
        args, kwargs, had = _user_inputs(args, kwargs)
        _state.in_port = False
        try:
            out = _Module.__call__(self, *args, **kwargs)
        finally:
            _state.in_port = was
        return wrap(out) if had and not was else _plain(out)

    # -- construction ------------------------------------------------------
    def create_parameter(self, shape, dtype=None, is_bias=False,
                         default_initializer=None, attr=None) -> Parameter:
        """A :class:`~paddle_tpu_torch.core.tensor.Parameter` of ``shape``
        on the default device: ``attr``'s initializer, else
        ``default_initializer``, else zeros for a bias and Xavier-uniform
        for a weight."""
        from paddle_tpu_torch.device import resolve_device
        from paddle_tpu_torch.param_attr import create_parameter
        return create_parameter(
            shape, device=resolve_device(None),
            dtype=convert_dtype(dtype or self._dtype), attr=attr,
            is_bias=is_bias, default_initializer=default_initializer)

    def add_parameter(self, name: str, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name: str, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name: str, tensor, persistable: bool = True,
                        persistent: Optional[bool] = None):
        """Paddle's ``persistable`` or torch's ``persistent``: a buffer
        that is not persistable stays out of ``state_dict``. A Paddle
        ``Tensor`` is kept as its plain tensor, as parameters are."""
        tensor = unwrap(tensor)
        super().register_buffer(
            name, tensor, persistable if persistent is None else persistent)
        return tensor

    # -- traversal -----------------------------------------------------------
    def named_parameters(self, prefix: str = "",
                         include_sublayers: bool = True,
                         recurse: Optional[bool] = None,
                         remove_duplicate: bool = True
                         ) -> Iterator[Tuple[str, torch.nn.Parameter]]:
        return super().named_parameters(
            prefix, include_sublayers if recurse is None else recurse,
            remove_duplicate)

    def parameters(self, include_sublayers: bool = True,
                   recurse: Optional[bool] = None) -> List:
        """A list, as Paddle's (torch's ``parameters()`` is a generator)."""
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers, recurse=recurse)]

    def named_buffers(self, prefix: str = "", include_sublayers: bool = True,
                      recurse: Optional[bool] = None,
                      remove_duplicate: bool = True):
        return super().named_buffers(
            prefix, include_sublayers if recurse is None else recurse,
            remove_duplicate)

    def buffers(self, include_sublayers: bool = True,
                recurse: Optional[bool] = None) -> List:
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers, recurse=recurse)]

    def sublayers(self, include_self: bool = False) -> List[_Module]:
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix: str = "", include_self: bool = False):
        for name, m in self.named_modules(prefix=prefix):
            if m is not self or include_self:
                yield name, m

    # -- state dict ------------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers: bool = True,
                   structured_name_prefix: str = "", use_hook: bool = True,
                   *, prefix: str = "", keep_vars: bool = False):
        """PyTorch's state dict (parameters and persistable buffers), with
        Paddle's ``include_sublayers`` and ``structured_name_prefix``."""
        prefix = prefix or structured_name_prefix
        if include_sublayers:
            return super().state_dict(destination=destination, prefix=prefix,
                                      keep_vars=keep_vars)
        dest = destination if destination is not None else {}
        self._save_to_state_dict(dest, prefix, keep_vars)
        return dest

    def set_state_dict(self, state_dict, use_structured_name: bool = True):
        """Copy ``state_dict``'s values (numpy arrays or tensors) into this
        layer's parameters and buffers in place. Returns ``(missing,
        unexpected)`` key lists; a shape that differs raises."""
        own = self.state_dict(keep_vars=True)
        unexpected = []
        with torch.no_grad():
            for name, value in state_dict.items():
                tgt = own.get(name)
                if tgt is None:
                    unexpected.append(name)
                    continue
                src = value.detach() if isinstance(value, torch.Tensor) \
                    else torch.as_tensor(np.asarray(value))
                if tuple(src.shape) != tuple(tgt.shape):
                    raise ValueError(
                        f"shape mismatch for {name}: checkpoint "
                        f"{tuple(src.shape)} vs layer {tuple(tgt.shape)}")
                tgt.copy_(src.to(tgt.device, tgt.dtype))
        missing = [n for n in own if n not in state_dict]
        return missing, unexpected

    load_dict = set_state_dict

    # -- hooks -------------------------------------------------------------------
    def register_forward_post_hook(self, hook: Callable):
        """``hook(layer, inputs, output)``; a non-None result replaces the
        output."""
        return self.register_forward_hook(hook)

    # -- dtype / device ----------------------------------------------------------
    def to(self, *args, **kwargs):
        """``to(device=, dtype=)`` with Paddle's spellings (``"gpu:0"``,
        ``"cpu"``, ``"bfloat16"``) as well as torch's arguments."""
        from paddle_tpu_torch.device import resolve_device
        device = kwargs.pop("device", None)
        dtype = kwargs.pop("dtype", None)
        kwargs.pop("blocking", None)
        for a in args:
            if isinstance(a, torch.Tensor):
                return super().to(a, **kwargs)
            if isinstance(a, (torch.dtype, DType)):
                dtype = a
            elif isinstance(a, str):
                try:
                    dtype = convert_dtype(a)
                except TypeError:
                    device = a
            else:
                device = a
        if device is not None:
            device = resolve_device(device)
        if dtype is not None:
            dtype = convert_dtype(dtype)
            self._dtype = dtype_name(dtype)
        return super().to(device=device, dtype=dtype, **kwargs)

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def full_name(self) -> str:
        return self._full_name

    def clear_gradients(self, set_to_zero: bool = True):
        """Zero every parameter's gradient (Paddle's default), or drop
        them."""
        for p in self.parameters():
            if set_to_zero:
                if p.grad is not None:
                    p.grad.zero_()
            else:
                p.grad = None
