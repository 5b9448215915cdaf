"""Static-graph workflow: ``Program``, ``Executor``, ``program_guard``,
``data`` — port of ``paddle_tpu/static/graph.py``.

The reference builds a "Program" by running the ops once on placeholder
values, which records its tape, and ``Executor.run`` replays that tape
as one jit-compiled function of (feeds, parameters). PyTorch's autograd
cannot replay a graph forward, so the port records its own:

* inside ``program_guard``, a ``TorchDispatchMode`` (:class:`_Recorder`)
  sees every aten call. A call is kept when it reads a placeholder
  (``static.data``) or the output of a kept call, or, where grad is
  enabled, a tensor that requires grad (a parameter; in-place writes
  and ``detach`` of one, such as an initializer's, are not program
  ops). Everything else, a constant built once, is captured as it is;
* tensors are matched by their storage, offset, shape, stride and dtype,
  since the Paddle ``Tensor`` a user holds is an alias of the one the
  aten call returned (``core/tensor.py``); the program keeps every kept
  output alive, so no storage is reused while it lives;
* ``Executor.run`` replays the kept calls as one function of (feeds,
  parameters); each call's program tensors were resolved to slots of
  the replay's environment when it was recorded, so a run does no
  lookups. With an optimizer attached by ``minimize`` it
  takes ``torch.autograd.grad`` of the replayed loss over the
  parameters and steps. Each call replays under the grad mode it was
  recorded in;
* ``static.nn``'s control flow records each ``cond``/``while_loop``/
  ``case``/``switch_case`` as one node (:func:`record_node`) whose
  replay runs the branch or loop eagerly on the replayed values, as the
  reference's tape holds each as one op.

As in the reference, shapes the recorded calls take as arguments are
those of the placeholders (a dynamic dim is 1 there): a reshape that
bakes the batch size replays it (``static.nn.fc`` reshapes with -1).
Ops are recorded only inside ``program_guard``; the default main
program outside one records nothing.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from paddle_tpu_torch.core.dtype import convert_dtype
from paddle_tpu_torch.core.tensor import unwrap, wrap

__all__ = ["Program", "Executor", "program_guard", "data",
           "default_main_program", "default_startup_program",
           "global_scope", "record_node", "graph_parameters"]

# aten calls that read a parameter without being part of its program
_NOT_PROGRAM_OPS = {torch.ops.aten.detach.default}


class _Pause(threading.local):
    depth = 0


_pause = _Pause()


def _key(t: torch.Tensor):
    """A tensor's identity across aliases: one storage, one view."""
    return (t.untyped_storage().data_ptr(), t.storage_offset(),
            tuple(t.shape), tuple(t.stride()), t.dtype, t.device)


class _Slot:
    """A reference to a value of the replay's environment."""
    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i


class Program:
    """The placeholders, the recorded calls, the fetch targets and the
    optimizer attached while this program was built (reference Program
    surface)."""

    def __init__(self):
        self.feeds: Dict[str, torch.Tensor] = {}
        self.optimizer = None
        self.loss: Optional[torch.Tensor] = None
        # (fn, args and kwargs with slots, output slots, grad enabled)
        self._calls: List[tuple] = []
        self._slots: Dict[tuple, int] = {}  # tensor key -> env slot
        self._feed_slots: Dict[str, int] = {}
        self._keep: List[torch.Tensor] = []  # every recorded tensor

    def clone(self, for_test: bool = False):
        return self

    def global_block(self):
        return self

    # -- recording ---------------------------------------------------------
    def _slot_of(self, t) -> Optional[int]:
        return self._slots.get(_key(t)) if isinstance(t, torch.Tensor) \
            else None

    def _new_slot(self, t: torch.Tensor) -> int:
        i = len(self._keep)
        self._keep.append(t)
        self._slots[_key(t)] = i
        return i

    def _add_feed(self, name: str, t: torch.Tensor):
        self.feeds[name] = t
        self._feed_slots[name] = self._new_slot(t)

    def _reads_program(self, tensors) -> bool:
        return any(self._slot_of(t) is not None for t in tensors)

    def _record(self, fn, args, kwargs, out):
        """Keep one call: its program tensors resolved to their slots now
        (an in-place call gives its tensor a new slot for what follows),
        then a slot for each tensor it returns."""
        def to_slot(a):
            i = self._slot_of(a)
            return a if i is None else _Slot(i)
        args, kwargs = tree_map(to_slot, args), tree_map(to_slot, kwargs)
        slots = [self._new_slot(o) if isinstance(o, torch.Tensor) else None
                 for o in tree_flatten(out)[0]]
        self._calls.append((fn, args, kwargs, slots,
                            torch.is_grad_enabled()))

    # -- replay ------------------------------------------------------------
    def _replay(self, env: list, grad: bool):
        """Run the recorded calls on ``env`` (the feeds in their slots),
        filling every slot."""
        def value(a):
            return env[a.i] if isinstance(a, _Slot) else a
        for fn, args, kwargs, slots, grad_on in self._calls:
            with torch.set_grad_enabled(grad and grad_on):
                out = fn(*tree_map(value, args), **tree_map(value, kwargs))
            for i, o in zip(slots, tree_flatten(out)[0]):
                if i is not None:
                    env[i] = o


class _Recorder(TorchDispatchMode):
    """Records the program's aten calls while ``program_guard`` holds."""

    def __init__(self, program: Program):
        super().__init__()
        self.program = program

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _pause.depth:
            return out
        tensors = [a for a in tree_flatten((args, kwargs))[0]
                   if isinstance(a, torch.Tensor)]
        prog = self.program
        if prog._reads_program(tensors) or (
                torch.is_grad_enabled() and func not in _NOT_PROGRAM_OPS
                and not func._schema.is_mutable
                and any(t.requires_grad for t in tensors)):
            prog._record(func, args, kwargs, out)
        return out


_default_main = Program()
_default_startup = Program()
_stack: List[Program] = []


def default_main_program() -> Program:
    return _stack[-1] if _stack else _default_main


def default_startup_program() -> Program:
    return _default_startup


def _building() -> Optional[Program]:
    """The program being recorded, if any (and not paused)."""
    return _stack[-1] if _stack and not _pause.depth else None


class program_guard:
    """Reference ``static.program_guard``: ``main_program`` is the
    default program, and the ops run inside are recorded into it."""

    def __init__(self, main_program: Program,
                 startup_program: Optional[Program] = None):
        self.main = main_program

    def __enter__(self):
        _stack.append(self.main)
        self._recorder = _Recorder(self.main)
        self._recorder.__enter__()
        return self.main

    def __exit__(self, *exc):
        self._recorder.__exit__(*exc)
        _stack.pop()
        return False


def record_node(fn, *inputs):
    """``fn(*inputs)``, recorded as one node of the program being built
    when an input belongs to it: the replay calls ``fn`` on the replayed
    inputs, with nothing inside it recorded (how ``static.nn``'s control
    flow enters a program). Outside a program it is ``fn(*inputs)``."""
    prog = _building()
    if prog is None or not prog._reads_program(
            [t for t in tree_flatten(inputs)[0]
             if isinstance(t, torch.Tensor)]):
        return fn(*inputs)
    _pause.depth += 1
    try:
        out = fn(*inputs)
    finally:
        _pause.depth -= 1
    prog._record(fn, inputs, {}, out)  # the replay runs paused too
    return out


def data(name: str, shape: Sequence[Optional[int]], dtype="float32",
         lod_level: int = 0):
    """Declare a feed placeholder (reference ``static/input.py data``):
    zeros on the default device, a dynamic (``None``/-1) dim of size 1,
    so building runs the ops once; ``Executor.run`` puts the fed value in
    its place. A float placeholder has ``stop_gradient=False``, as the
    reference's, so the ops reading it build a graph."""
    from paddle_tpu_torch.core.tensor import to_tensor
    from paddle_tpu_torch.device import resolve_device

    dt = convert_dtype(dtype)
    concrete = tuple(1 if (s is None or int(s) < 0) else int(s)
                     for s in shape)
    t = to_tensor(torch.zeros(concrete, dtype=dt,
                              device=resolve_device(None)),
                  stop_gradient=not dt.is_floating_point)
    t.name = name
    default_main_program()._add_feed(name, t)
    return t


def graph_parameters(loss) -> list:
    """The trainable ``Parameter`` leaves of ``loss``'s autograd graph,
    in the order first reached (reference ``minimize``'s collection of
    the program's trainable parameters)."""
    params, seen, stack, visited = [], set(), [loss.grad_fn], set()
    while stack:
        node = stack.pop()
        if node is None or node in visited:
            continue
        visited.add(node)
        var = getattr(node, "variable", None)
        if isinstance(var, torch.nn.Parameter) and var.requires_grad \
                and id(var) not in seen:
            seen.add(id(var))
            params.append(var)
        stack.extend(reversed([n for n, _ in node.next_functions]))
    return params


class _Scope:
    def find_var(self, name):
        return None


_scope = _Scope()


def global_scope():
    return _scope


class Executor:
    """Reference ``executor.py`` ``Executor``: replays a program."""

    def __init__(self, place=None):
        self.place = place

    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict[str, np.ndarray]] = None,
            fetch_list: Optional[Sequence] = None,
            return_numpy: bool = True):
        """Replay ``program`` on ``feed`` and return ``fetch_list``'s
        values (numpy arrays, or tensors); with an optimizer attached,
        also step it on the gradients of the replayed loss."""
        program = program or default_main_program()
        feed = feed or {}
        fetch_list = list(fetch_list or [])
        if program is _default_startup or (not fetch_list
                                           and program.loss is None):
            return []  # the startup program: parameters are initialized
        env: list = [None] * len(program._keep)
        for name in sorted(program.feeds):
            if name not in feed:
                raise ValueError(f"missing feed '{name}'")
            ph = unwrap(program.feeds[name])
            value = feed[name]
            env[program._feed_slots[name]] = torch.as_tensor(
                unwrap(value) if isinstance(value, torch.Tensor)
                else np.asarray(value), dtype=ph.dtype).to(ph.device)
        opt = program.optimizer
        params = list(opt._parameter_list) if opt is not None else []
        fetch_slots = [self._fetch_slot(program, t) for t in fetch_list]
        _pause.depth += 1
        try:
            program._replay(env, grad=opt is not None)
        finally:
            _pause.depth -= 1
        results = [env[i] if i is not None else unwrap(t)
                   for i, t in zip(fetch_slots, fetch_list)]
        if opt is not None:
            loss = env[self._fetch_slot(program, program.loss)]
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            for p, g in zip(params, grads):
                p.grad = g
            opt.step()
            opt.clear_grad(set_to_zero=False)
        results = [r.detach() for r in results]
        if return_numpy:
            return [r.cpu().numpy() for r in results]
        return [wrap(r) for r in results]

    @staticmethod
    def _fetch_slot(program: Program, t) -> Optional[int]:
        i = program._slot_of(t)
        if i is None and not (isinstance(t, torch.nn.Parameter)
                              or t.grad_fn is None):
            raise ValueError(
                "a fetch target was computed outside this program's "
                "program_guard, so the program cannot replay it")
        return i

    def close(self):
        pass
