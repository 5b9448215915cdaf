"""Functional and forward-mode autodiff (Paddle's "prim" API) — port of
``paddle_tpu/incubate/autograd/__init__.py`` (Paddle's
``incubate/autograd/primapi.py`` ``forward_grad``/``grad`` and
``functional.py`` ``jvp``/``vjp``/``Jacobian``/``Hessian``).

The functional transforms are ``torch.func``'s (``jvp``, ``vjp``,
``jacrev``, ``hessian``, ``vmap``) over the user's function, which runs
on plain tensors; ``forward_grad`` and ``grad`` run on the autograd tape
(``forward_grad`` by the double-reverse construction, ``grad`` with
``create_graph`` so its result differentiates again). The prim toggles
only record the user's choice, as in the reference: there is no
primitive lowering to switch.

Given Paddle ``Tensor``s, the results are ``Tensor``s; given plain
tensors, plain tensors.
"""
from __future__ import annotations

from typing import Callable, List

import torch

from paddle_tpu_torch.core import autograd as _ag
from paddle_tpu_torch.core.tensor import Tensor, unwrap, wrap

__all__ = [
    "jvp", "vjp", "Jacobian", "Hessian", "forward_grad", "grad",
    "enable_prim", "disable_prim", "prim_enabled",
]

_prim_state = {"enabled": False}


def enable_prim():
    _prim_state["enabled"] = True


def disable_prim():
    _prim_state["enabled"] = False


def prim_enabled() -> bool:
    return _prim_state["enabled"]


def _as_seq(x) -> List:
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _plain(x):
    return unwrap(x) if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _facade(values, like):
    """``values`` as ``Tensor``s when any of ``like`` is one."""
    return wrap(values) if any(type(t) is Tensor for t in like) else values


def _purify(func: Callable):
    """``func`` as a function of plain tensors returning a tuple of plain
    tensors, and a cell saying whether it returned a list."""
    meta = {"multi": False}

    def pure(*arrays):
        out = func(*arrays)
        meta["multi"] = isinstance(out, (list, tuple))
        return tuple(_plain(o) for o in _as_seq(out))

    return pure, meta


def _out(values, multi):
    return list(values) if multi else values[0]


def jvp(func: Callable, xs, v=None):
    """``(func(xs), J @ v)``, forward mode; ``v`` defaults to ones, as in
    the reference."""
    xs_l = _as_seq(xs)
    arrays = tuple(_plain(x) for x in xs_l)
    tangents = tuple(torch.ones_like(a) for a in arrays) if v is None \
        else tuple(_plain(t) for t in _as_seq(v))
    pure, meta = _purify(func)
    out, dot = torch.func.jvp(pure, arrays, tangents)
    return _facade((_out(out, meta["multi"]), _out(dot, meta["multi"])),
                   xs_l)


def vjp(func: Callable, xs, v=None):
    """``(func(xs), vᵀ @ J)``, reverse mode; ``v`` defaults to ones.
    Several inputs give a list of gradients."""
    xs_l = _as_seq(xs)
    arrays = [_plain(x) for x in xs_l]
    pure, meta = _purify(func)
    out, vjp_fn = torch.func.vjp(pure, *arrays)
    cots = tuple(torch.ones_like(o) for o in out) if v is None \
        else tuple(_plain(t) for t in _as_seq(v))
    grads = list(vjp_fn(cots))
    return _facade((_out(out, meta["multi"]),
                    grads if isinstance(xs, (list, tuple)) else grads[0]),
                   xs_l)


def _flatten_inputs(func, xs, is_batched):
    """``(function of one flat tensor, the flat tensor)``: one input as
    it is; several flattened into one vector, columns ordered by input
    (the reference's order)."""
    if not isinstance(xs, (list, tuple)):
        return func, _plain(xs)
    if is_batched:
        raise NotImplementedError(
            "is_batched=True supports a single input tensor; flatten your "
            "inputs or call per input")
    parts = [_plain(x) for x in xs]
    shapes = [p.shape for p in parts]
    sizes = [p.numel() for p in parts]
    flat = torch.cat([p.reshape(-1) for p in parts])

    def f(a):
        pieces = torch.split(a, sizes)
        return func(*(p.reshape(s) for p, s in zip(pieces, shapes)))

    return f, flat


class _Lazy:
    """A matrix computed on first access and kept; indexing slices it."""

    def __init__(self, func: Callable, xs, is_batched: bool = False):
        self._xs = _as_seq(xs)
        self._func, self._flat_x = _flatten_inputs(func, xs, is_batched)
        self._is_batched = is_batched
        self._mat = None

    @property
    def shape(self):
        return list(self._compute().shape)

    def __getitem__(self, idx):
        return _facade(self._compute()[idx], self._xs)

    def numpy(self):
        return self._compute().detach().cpu().numpy()


class Jacobian(_Lazy):
    """The Jacobian of ``func: R^N -> R^M``, ``[M, N]`` (reference
    ``Jacobian``); with ``is_batched`` the leading axis of ``xs`` is a
    batch and the result ``[B, M, N]``. One ``torch.func.jacrev`` sweep
    (under ``vmap`` when batched)."""

    def _compute(self):
        if self._mat is None:
            pure, _ = _purify(self._func)

            def single(a):
                return pure(a)[0].reshape(-1)

            a = self._flat_x
            if self._is_batched:
                jac = torch.func.vmap(torch.func.jacrev(single))(a)
                self._mat = jac.reshape(a.shape[0], jac.shape[1], -1)
            else:
                jac = torch.func.jacrev(single)(a)
                self._mat = jac.reshape(jac.shape[0], -1)
        return self._mat


class Hessian(_Lazy):
    """The Hessian of a scalar ``func``, ``[N, N]`` (reference
    ``Hessian``); batched, ``[B, N, N]`` with ``func`` mapping each row
    to a scalar."""

    def _compute(self):
        if self._mat is None:
            pure, _ = _purify(self._func)

            def scalar(a):
                return pure(a)[0].reshape(())

            def one(a):
                return torch.func.hessian(scalar)(a).reshape(a.numel(),
                                                             a.numel())

            a = self._flat_x
            self._mat = torch.func.vmap(one)(a) if self._is_batched \
                else one(a)
        return self._mat


def forward_grad(outputs, inputs, grad_inputs=None):
    """Forward-mode gradients over the tape (reference ``primapi.py:25``):
    with ``u = (∂y/∂x)ᵀ w`` from a reverse pass that stays differentiable
    in ``w``, ``J v = ∂<u, v>/∂w`` from a second one. ``grad_inputs``
    defaults to ones."""
    ys = _as_seq(outputs)
    xs = _as_seq(inputs)
    vs = [torch.ones_like(_plain(x)) for x in xs] if grad_inputs is None \
        else [_plain(t) for t in _as_seq(grad_inputs)]
    ws = [torch.zeros_like(_plain(y), requires_grad=True) for y in ys]
    us = _ag.grad(ys, xs, grad_outputs=ws, create_graph=True,
                  allow_unused=True)
    terms = [(_plain(u) * v).sum() for u, v in zip(us, vs) if u is not None]
    if not terms:
        out = [torch.zeros_like(_plain(y)) for y in ys]
    else:
        gs = torch.autograd.grad(sum(terms), ws, allow_unused=True)
        out = [g if g is not None else torch.zeros_like(_plain(y))
               for g, y in zip(gs, ys)]
    out = _facade(out, ys + xs)
    return out if isinstance(outputs, (list, tuple)) else out[0]


def grad(outputs, inputs, grad_outputs=None):
    """Reverse-mode gradients that stay differentiable (reference
    ``primapi.py:108``): the tape's ``create_graph``."""
    res = _ag.grad(_as_seq(outputs), _as_seq(inputs),
                   grad_outputs=grad_outputs, create_graph=True,
                   allow_unused=True)
    return res if isinstance(inputs, (list, tuple)) else res[0]
