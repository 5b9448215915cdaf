"""The eager Tensor — port of ``paddle_tpu/core/tensor.py``.

Paddle's ``Tensor`` is a facade over ``torch.Tensor``: :class:`Tensor`
subclasses it with Paddle's methods and properties (``shape`` as a
list, ``dtype`` as a :class:`~paddle_tpu_torch.core.dtype.DType`,
``stop_gradient``, ``numpy()`` on a card tensor that needs a gradient,
``astype``, ``place``, ``set_value``, ``clear_grad``, and the op library's
methods: ``transpose(perm)``, ``sum(axis=, keepdim=)``, ...). Its
``__torch_function__`` is PyTorch's disabled one, so a torch op on a
``Tensor`` costs nothing extra and returns a plain ``torch.Tensor``.

The facade lives only at the user API. The op library and the port's
entry points (``nn.Layer.__call__``, ``jit.TrainStep``, ``generate``)
unwrap it (:func:`unwrap`, zero-copy through ``as_subclass``, which
stays on the autograd graph) and hand plain tensors to the port's code,
so no port ``forward`` ever sees a Paddle-semantics object and
``torch.Tensor`` itself is never patched. What a call takes in, it gives
back: an entry point called with a ``Tensor`` returns ``Tensor``s
(:func:`wrap`), one called with plain tensors returns plain tensors.

Autograd is PyTorch's (``core/autograd.py``): ``stop_gradient`` is the
inverse of ``requires_grad``, ``.grad`` accumulates until
``clear_grad()``, and a backward through an unwrapped alias fills the
leaf ``Tensor``'s ``.grad``.

:class:`Parameter` is a ``torch.nn.Parameter`` subclass, so the
optimizer's and ``TrainStep``'s identity maps hold; it adds only what
torch lacks (``stop_gradient``, ``trainable``, ``name``, ``numpy()``,
``set_value``, ``clear_grad``, ``astype``) and keeps every torch method
with torch's meaning, so its ``shape`` is a ``torch.Size``.
``isinstance(x, Tensor)`` holds for any ``torch.Tensor``, as every
tensor of Paddle is a ``Tensor``.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from .dtype import DType, convert_dtype, to_dtype

__all__ = ["Tensor", "Parameter", "to_tensor", "wrap", "unwrap",
           "unwrap_args"]

_Base = torch._C.TensorBase


def _ops():
    from paddle_tpu_torch import ops
    return ops


def unwrap(x):
    """A :class:`Tensor` -> the plain ``torch.Tensor`` alias of it
    (zero-copy, on the autograd graph); anything else as it is."""
    return x.as_subclass(torch.Tensor) if type(x) is Tensor else x


def wrap(x):
    """A plain ``torch.Tensor`` -> a :class:`Tensor` alias; tuples, lists
    and dicts element by element; anything else (a :class:`Parameter`
    too) as it is."""
    if type(x) is torch.Tensor:
        return x.as_subclass(Tensor)
    if isinstance(x, (tuple, list)):
        out = [wrap(v) for v in x]
        return type(x)(*out) if hasattr(x, "_fields") else type(x)(out)
    if isinstance(x, dict):
        return type(x)((k, wrap(v)) for k, v in x.items())
    return x


def _unwrap_tree(x, found):
    if type(x) is Tensor:
        found[0] = True
        return x.as_subclass(torch.Tensor)
    if isinstance(x, (tuple, list)) and x:
        out = [_unwrap_tree(v, found) for v in x]
        return type(x)(*out) if hasattr(x, "_fields") else type(x)(out)
    if isinstance(x, dict) and x:
        return type(x)((k, _unwrap_tree(v, found)) for k, v in x.items())
    return x


def unwrap_args(args, kwargs):
    """``(args, kwargs, had_facade)`` with every :class:`Tensor` inside
    (one level of tuples, lists and dicts deep, and deeper) unwrapped."""
    found = [False]
    args = tuple(_unwrap_tree(a, found) for a in args)
    if kwargs:
        kwargs = {k: _unwrap_tree(v, found) for k, v in kwargs.items()}
    return args, kwargs, found[0]


def _place_name(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"gpu:{dev.index if dev.index is not None else 0}"
    return dev.type


class _TensorMeta(type(torch.Tensor)):
    def __instancecheck__(cls, obj):
        # every torch tensor is a Paddle Tensor (parameters included)
        if cls is Tensor:
            return isinstance(obj, torch.Tensor)
        return super().__instancecheck__(obj)


class Tensor(torch.Tensor, metaclass=_TensorMeta):
    """Paddle's eager Tensor over a ``torch.Tensor`` (see the module
    docstring)."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    def __new__(cls, data=None, dtype=None, place=None,
                stop_gradient: bool = True):
        return to_tensor(data, dtype, place, stop_gradient)

    def __init__(self, *args, **kwargs):
        pass

    # -- storage ---------------------------------------------------------
    @property
    def data(self):
        return _Base.data.__get__(self).as_subclass(Tensor)

    @data.setter
    def data(self, value):
        _Base.data.__set__(self, unwrap(value))

    @property
    def shape(self):
        return list(_Base.shape.__get__(self))

    @property
    def dtype(self) -> DType:
        return to_dtype(_Base.dtype.__get__(self))

    @property
    def size(self) -> int:
        return _Base.numel(self)

    def numel(self):
        return wrap(torch.tensor(_Base.numel(self), dtype=torch.int64,
                                 device=_Base.device.__get__(self)))

    @property
    def place(self) -> str:
        return _place_name(_Base.device.__get__(self))

    @property
    def name(self) -> str:
        return self.__dict__.get("_paddle_name", "")

    @name.setter
    def name(self, value):
        self.__dict__["_paddle_name"] = value or ""

    @property
    def persistable(self) -> bool:
        return self.__dict__.get("_persistable", False)

    @persistable.setter
    def persistable(self, value):
        self.__dict__["_persistable"] = bool(value)

    @property
    def stop_gradient(self) -> bool:
        return not _Base.requires_grad.__get__(self)

    @stop_gradient.setter
    def stop_gradient(self, value: bool):
        if value and _Base.grad_fn.__get__(self) is not None:
            _Base.detach_(self)  # cut a computed tensor from its graph
        else:
            if not value:
                _check_differentiable(self.dtype)
            _Base.requires_grad_(self, not value)

    @property
    def trainable(self) -> bool:
        return not self.stop_gradient

    @trainable.setter
    def trainable(self, value: bool):
        self.stop_gradient = not value

    @property
    def grad(self):
        if _Base.grad_fn.__get__(self) is not None:
            return None  # Paddle keeps no gradient on a computed tensor
        g = _Base.grad.__get__(self)
        return None if g is None else g.as_subclass(Tensor)

    @grad.setter
    def grad(self, value):
        _Base.grad.__set__(self, unwrap(value))

    @property
    def inplace_version(self) -> int:
        return _Base._version.__get__(self)

    @property
    def T(self):
        return _ops().transpose(self, list(range(self.ndim))[::-1])

    # -- conversion ------------------------------------------------------
    def numpy(self):
        """A numpy copy, from any device and whether or not the tensor
        needs a gradient (bfloat16 comes back as float32, numpy having
        no bfloat16)."""
        t = unwrap(self).detach()
        if t.dtype is torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def astype(self, dtype):
        return _ops().cast(self, dtype)

    cast = astype

    def cpu(self):
        return wrap(unwrap(self).cpu())

    def cuda(self, device_id=None, blocking=True):
        from paddle_tpu_torch.device import resolve_device
        dev = resolve_device("cuda" if device_id is None
                             else f"cuda:{int(device_id)}")
        return wrap(unwrap(self).to(dev))

    def to(self, *args, **kwargs):
        """``to(device)``, ``to(dtype)``, ``to(device, dtype)`` in Paddle's
        or torch's spellings (``"gpu:0"``, ``"bfloat16"``)."""
        from paddle_tpu_torch.device import resolve_device
        dtype = kwargs.pop("dtype", None)
        device = kwargs.pop("device", None) or kwargs.pop("place", None)
        kwargs.pop("blocking", None)
        for a in args:
            if isinstance(a, (DType, torch.dtype)):
                dtype = a
            elif isinstance(a, torch.Tensor):
                dtype = _Base.dtype.__get__(a)
            else:
                try:
                    dtype = convert_dtype(a)
                except TypeError:
                    device = a
        t = unwrap(self)
        if device is not None:
            t = t.to(resolve_device(device))
        if dtype is not None:
            t = t.to(convert_dtype(dtype))
        return wrap(t)

    def pin_memory(self):
        return wrap(unwrap(self).pin_memory())

    def bfloat16(self):
        return self.astype("bfloat16")

    def half(self):
        return self.astype("float16")

    def float(self):
        return self.astype("float32")

    def contiguous(self):
        return self if _Base.is_contiguous(self) else \
            wrap(unwrap(self).contiguous())

    def sub(self, other):
        return _ops().subtract(self, other)

    # -- autograd ---------------------------------------------------------
    def backward(self, grad_tensor=None, retain_graph: bool = False):
        from . import autograd
        autograd.backward([self], [grad_tensor], retain_graph=retain_graph)

    def register_hook(self, hook):
        """``hook(grad) -> grad or None`` on this tensor's gradient, with
        the gradient as a :class:`Tensor`."""
        if self.stop_gradient:
            raise RuntimeError("cannot register hook on a tensor with "
                               "stop_gradient=True")

        def call(g):
            out = hook(wrap(g))
            return None if out is None else unwrap(out)
        return torch.Tensor.register_hook(self, call)

    def clear_grad(self):
        _Base.grad.__set__(self, None)

    clear_gradient = clear_grad

    def detach(self):
        return wrap(_Base.detach(self))

    def clone(self):
        return _ops().assign(self)

    # -- in place ---------------------------------------------------------
    def _write(self, value):
        with torch.no_grad():
            _Base.copy_(self, value)
        return self

    def set_value(self, value):
        value = _as_torch(value, _Base.device.__get__(self))
        if tuple(value.shape) != tuple(_Base.shape.__get__(self)):
            raise ValueError(
                f"set_value shape mismatch: {tuple(value.shape)} vs "
                f"{tuple(_Base.shape.__get__(self))}")
        return self._write(value)

    def copy_(self, other, blocking=True):
        return self.set_value(other)

    def _inplace_keep_dtype(self, new):
        # an in-place op keeps the dtype and the shape: an int tensor does
        # not become float, and a parameter does not broadcast
        if tuple(new.shape) != tuple(_Base.shape.__get__(self)):
            raise ValueError(
                f"in-place op would change shape "
                f"{tuple(_Base.shape.__get__(self))} -> {tuple(new.shape)}")
        return self._write(new.to(_Base.dtype.__get__(self)))

    def zero_(self):
        with torch.no_grad():
            _Base.zero_(self)
        return self

    def fill_(self, value):
        with torch.no_grad():
            _Base.fill_(self, value)
        return self

    def scale_(self, scale):
        return self._inplace_keep_dtype(unwrap(self).detach() * scale)

    def add_(self, other):
        return self._inplace_keep_dtype(unwrap(self).detach() + unwrap(other))

    def subtract_(self, other):
        return self._inplace_keep_dtype(unwrap(self).detach() - unwrap(other))

    def multiply_(self, other):
        return self._inplace_keep_dtype(unwrap(self).detach() * unwrap(other))

    def clip_(self, min=None, max=None):
        t = unwrap(self).detach()
        return self._inplace_keep_dtype(
            torch.clamp(t, min, max) if (min is not None or max is not None)
            else t)

    def uniform_(self, min=-1.0, max=1.0, seed=0):
        from .generator import draw_generator
        t = unwrap(self)
        g = draw_generator(t.device, seed)
        return self._write(torch.empty_like(t).uniform_(min, max,
                                                        generator=g))

    def normal_(self, mean=0.0, std=1.0, name=None):
        from .generator import draw_generator
        t = unwrap(self)
        return self._write(torch.empty_like(t).normal_(
            mean, std, generator=draw_generator(t.device)))

    def exponential_(self, lam=1.0):
        return _ops().exponential_(self, lam)

    # -- indexing ----------------------------------------------------------
    def __getitem__(self, idx):
        return wrap(torch.Tensor.__getitem__(unwrap(self), _unwrap_idx(idx)))

    def __setitem__(self, idx, value):
        idx, value = _unwrap_idx(idx), unwrap(value)
        if _Base.is_leaf.__get__(self) and \
                _Base.requires_grad.__get__(self):
            with torch.no_grad():
                _Base.__setitem__(self, idx, value)
        else:
            _Base.__setitem__(self, idx, value)

    # -- arithmetic (through the op library) -------------------------------
    def __add__(self, o):
        return _ops().add(self, o)

    __radd__ = __add__
    __iadd__ = __add__

    def __sub__(self, o):
        return _ops().subtract(self, o)

    __isub__ = __sub__

    def __rsub__(self, o):
        return _ops().subtract(o, self)

    def __mul__(self, o):
        return _ops().multiply(self, o)

    __rmul__ = __mul__
    __imul__ = __mul__

    def __truediv__(self, o):
        return _ops().divide(self, o)

    __itruediv__ = __truediv__

    def __rtruediv__(self, o):
        return _ops().divide(o, self)

    def __floordiv__(self, o):
        return _ops().floor_divide(self, o)

    def __rfloordiv__(self, o):
        return _ops().floor_divide(o, self)

    def __mod__(self, o):
        return _ops().remainder(self, o)

    def __rmod__(self, o):
        return _ops().remainder(o, self)

    def __pow__(self, o):
        return _ops().pow(self, o)

    def __rpow__(self, o):
        return _ops().pow(o, self)

    def __matmul__(self, o):
        return _ops().matmul(self, o)

    def __rmatmul__(self, o):
        return _ops().matmul(o, self)

    def __neg__(self):
        return _ops().scale(self, -1.0)

    def __pos__(self):
        return self

    def __abs__(self):
        return _ops().abs(self)

    def __invert__(self):
        return _ops().logical_not(self) if self.dtype == "bool" \
            else _ops().bitwise_not(self)

    def __eq__(self, o):
        return _ops().equal(self, o)

    def __ne__(self, o):
        return _ops().not_equal(self, o)

    def __lt__(self, o):
        return _ops().less_than(self, o)

    def __le__(self, o):
        return _ops().less_equal(self, o)

    def __gt__(self, o):
        return _ops().greater_than(self, o)

    def __ge__(self, o):
        return _ops().greater_equal(self, o)

    def __and__(self, o):
        return _ops().logical_and(self, o) if self.dtype == "bool" \
            else _ops().bitwise_and(self, o)

    def __or__(self, o):
        return _ops().logical_or(self, o) if self.dtype == "bool" \
            else _ops().bitwise_or(self, o)

    def __xor__(self, o):
        return _ops().logical_xor(self, o) if self.dtype == "bool" \
            else _ops().bitwise_xor(self, o)

    __hash__ = torch.Tensor.__hash__

    # -- Python protocol -----------------------------------------------------
    def __repr__(self):
        grad_info = "" if self.stop_gradient else ", stop_gradient=False"
        data = repr(self.numpy())
        return (f"Tensor(shape={self.shape}, dtype={self.dtype.name}, "
                f"place={self.place}{grad_info},\n       {data})")

    def __format__(self, spec):
        return format(unwrap(self), spec)

    def __deepcopy__(self, memo):
        out = copy.deepcopy(unwrap(self), memo).as_subclass(Tensor)
        out.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return out

    def __reduce_ex__(self, proto):
        return (_rebuild, (unwrap(self).detach(), self.stop_gradient,
                           dict(self.__dict__)))


def _rebuild(data, stop_gradient, attrs):
    t = torch.Tensor._make_subclass(Tensor, data, not stop_gradient)
    t.__dict__.update(attrs)
    return t


def _unwrap_idx(idx):
    if isinstance(idx, tuple):
        return tuple(unwrap(i) for i in idx)
    if isinstance(idx, list):
        return [unwrap(i) for i in idx]
    return unwrap(idx)


def _as_torch(value, device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return unwrap(value).detach().to(device)
    return torch.as_tensor(np.asarray(value), device=device)


class Parameter(torch.nn.Parameter):
    """A trainable leaf (reference ``Parameter``): a ``torch.nn.Parameter``
    with Paddle's ``name``, ``stop_gradient``/``trainable``,
    ``persistable``, ``numpy()``, ``set_value``, ``clear_grad`` and
    ``astype``. ``Parameter(data, name=None, trainable=True)``; ``data``
    may be numpy, and lands on the default device."""

    def __new__(cls, data=None, name=None, trainable=True):
        if isinstance(name, bool):  # torch's (data, requires_grad) form
            trainable, name = name, None
        if data is None:
            data = torch.empty(0)
        elif not isinstance(data, torch.Tensor):
            from paddle_tpu_torch.device import resolve_device
            data = torch.as_tensor(np.array(data), device=resolve_device())
        p = super().__new__(cls, unwrap(data).detach(), bool(trainable))
        if name:
            p.name = name
        return p

    def __init__(self, *args, **kwargs):
        pass

    @property
    def name(self) -> str:
        return self.__dict__.get("_paddle_name", "")

    @name.setter
    def name(self, value):
        self.__dict__["_paddle_name"] = value or ""

    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool):
        self.requires_grad_(not value)

    @property
    def trainable(self) -> bool:
        return self.requires_grad

    @trainable.setter
    def trainable(self, value: bool):
        self.requires_grad_(bool(value))

    @property
    def persistable(self) -> bool:
        return True

    def numpy(self):
        t = self.detach()
        if t.dtype is torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def set_value(self, value):
        value = _as_torch(value, self.device)
        if tuple(value.shape) != tuple(self.shape):
            raise ValueError(f"set_value shape mismatch: "
                             f"{tuple(value.shape)} vs {tuple(self.shape)}")
        with torch.no_grad():
            self.copy_(value)
        return self

    def clear_grad(self):
        self.grad = None

    clear_gradient = clear_grad

    def astype(self, dtype):
        return _ops().cast(self, dtype)

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = type(self)(self.data.clone(memory_format=torch.preserve_format),
                         self.requires_grad)
        memo[id(self)] = out
        out.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return out


def _check_differentiable(dtype):
    """PyTorch keeps no gradient for a bool or integer tensor, where
    Paddle stores ``stop_gradient=False`` on any: marking one trainable
    raises ``ValueError`` (for a bool attention mask, the error the
    reference raises at ``scaled_dot_product_attention``)."""
    dtype = convert_dtype(dtype)
    if not (dtype.is_floating_point or dtype.is_complex):
        raise ValueError(
            f"a {str(dtype)[6:]} tensor cannot receive a gradient (a bool "
            f"mask selects, it is not added to the logits); pass a float "
            f"tensor or keep stop_gradient=True")


def to_tensor(data, dtype=None, place=None,
              stop_gradient: bool = True) -> Tensor:
    """``paddle.to_tensor``: a new leaf :class:`Tensor` holding a copy of
    ``data`` (numpy, a list, a scalar or a tensor). Python floats become
    the default float dtype and Python ints int64, as in Paddle. The
    tensor lands on ``place``, else where a tensor ``data`` lies, else on
    the default device (``set_device``)."""
    from paddle_tpu_torch.device import resolve_device
    if isinstance(data, torch.Tensor):
        t = unwrap(data).detach()
        t = t.to(resolve_device(place)) if place is not None else t.clone()
    else:
        arr = np.array(data)
        if dtype is None and arr.dtype == np.float64 and isinstance(
                data, (float, list, tuple)):
            from .dtype import default_float
            arr = arr.astype(np.float32 if default_float() is torch.float32
                             else np.float64)
        if arr.dtype.kind in "US":
            raise TypeError(f"to_tensor: unsupported data of dtype "
                            f"{arr.dtype}")
        t = torch.as_tensor(arr, device=resolve_device(place))
    if dtype is not None:
        t = t.to(convert_dtype(dtype))
    if not stop_gradient:
        _check_differentiable(t.dtype)
    return torch.Tensor._make_subclass(Tensor, t, not stop_gradient)
