"""``paddle.static.nn`` — port of ``paddle_tpu/static/nn.py``.

The layer helpers (``fc``, ``embedding``, ``batch_norm``) build the
dygraph layer once (its parameters) and apply it, so inside a
``program_guard`` its ops land in the program (``static/graph.py``).

The control flow follows the reference's eager semantics and gradients
(``tests/test_control_flow.py``). The reference lowers each to XLA's
``cond``/``while``/``switch`` recorded as one tape op; the port runs
them eagerly, so gradients flow through the branch or the iterations
taken:

* ``cond`` with ``operands`` runs the taken branch on them and, as XLA
  compiles both, runs the other under ``no_grad`` to check the two
  return one structure; without operands it runs the taken branch on
  its closure (``None`` for a missing false branch);
* ``while_loop`` is forward-only, as the reference's: a loop var or a
  captured layer that requires grad raises ``ValueError``;
* ``bounded_while_loop`` is the trainable loop: at most ``max_iters``
  iterations, stopping when the condition fails, gradients through the
  loop vars and through what the closures capture;
* ``case`` runs the first branch whose predicate holds (else
  ``default``, else the last); ``switch_case`` the branch of the index
  (else ``default``, else the largest key's).

Inside a program, ``cond`` with operands and the two loops are one node
each (``graph.record_node``), so a replay takes the branch or the trip
count of the fed values; closure-style branches run as they are built,
their choice fixed, as in the reference.

A predicate held on the card under CUDA-graph capture (``to_static``)
raises ``NotImplementedError``: a graph cannot branch on device data.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils._pytree import tree_flatten

from .graph import record_node

__all__ = ["fc", "embedding", "batch_norm", "cond", "while_loop",
           "bounded_while_loop", "case", "switch_case"]


def fc(x, size: int, num_flatten_dims: int = 1, weight_attr=None,
       bias_attr=None, activation: Optional[str] = None, name=None):
    """Reference ``static/nn/common.py fc``: a ``Linear`` over the dims
    from ``num_flatten_dims`` on (reshaped with -1 for the batch, so a
    replay takes another batch size)."""
    from paddle_tpu_torch import nn, ops
    in_features = 1
    for s in x.shape[num_flatten_dims:]:
        in_features *= int(s)
    if tuple(x.shape[num_flatten_dims:]) != (in_features,):
        x = ops.reshape(x, [-1] + list(x.shape[1:num_flatten_dims])
                        + [in_features])
    layer = nn.Linear(in_features, size, weight_attr=weight_attr,
                      bias_attr=bias_attr)
    out = layer(x)
    if activation is not None:
        import paddle_tpu_torch.nn.functional as F
        out = getattr(F, activation)(out)
    out._static_layer = layer  # the parameters live with the graph
    return out


def embedding(input, size, weight_attr=None, is_sparse: bool = False,
              padding_idx=None, name=None):
    """Reference ``static/nn/common.py embedding``."""
    from paddle_tpu_torch import nn
    layer = nn.Embedding(size[0], size[1], padding_idx=padding_idx,
                         weight_attr=weight_attr, sparse=is_sparse)
    out = layer(input)
    out._static_layer = layer
    return out


def batch_norm(input, momentum: float = 0.9, epsilon: float = 1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               is_test: bool = False, name=None):
    """Reference ``static/nn/common.py batch_norm``."""
    from paddle_tpu_torch import nn
    ch = int(input.shape[1] if data_layout == "NCHW" else input.shape[-1])
    layer = nn.BatchNorm2D(ch, momentum=momentum, epsilon=epsilon,
                           weight_attr=param_attr, bias_attr=bias_attr)
    if is_test:
        layer.eval()
    out = layer(input)
    out._static_layer = layer
    return out


# ============================= control flow ==================================
def _host_value(x, what):
    """A scalar tensor's value on the host. Raises on the card under
    CUDA-graph capture, where the graph would bake one branch."""
    if x.is_cuda and torch.cuda.is_current_stream_capturing():
        raise NotImplementedError(
            f"static.nn control flow under CUDA-graph capture (to_static): "
            f"the {what} is on the card, and a CUDA graph cannot branch on "
            f"device data; call it outside to_static")
    return x.reshape(()).item()


def _truth(pred, what="predicate") -> bool:
    if isinstance(pred, torch.Tensor):
        return bool(_host_value(pred, what))
    return bool(pred)


def _structure(out):
    return tree_flatten(out)[1]


def _captures_grad(*fns) -> bool:
    """Whether ``fns``'s closures or bound ``self`` capture a tensor that
    requires grad (a captured layer's parameters; layers held in a list
    or a dict; helper callables followed), as the reference's collector
    finds them."""
    visited = set()

    def scan(obj):
        if obj is None or id(obj) in visited:
            return False
        visited.add(id(obj))
        if isinstance(obj, torch.nn.Module):
            return any(p.requires_grad for p in obj.parameters())
        if isinstance(obj, torch.Tensor):
            return obj.requires_grad
        if isinstance(obj, (list, tuple, set)):
            return any(scan(item) for item in obj)
        if isinstance(obj, dict):
            return any(scan(item) for item in obj.values())
        if callable(obj):
            cells = []
            for cell in getattr(obj, "__closure__", None) or ():
                try:
                    cells.append(cell.cell_contents)
                except ValueError:  # an empty cell
                    pass
            return scan(getattr(obj, "__self__", None)) or \
                any(scan(c) for c in cells)
        return False
    return any(scan(fn) for fn in fns)


def cond(pred, true_fn=None, false_fn=None, name=None, operands=()):
    """Reference ``control_flow.py cond``: ``true_fn`` where ``pred``
    holds, else ``false_fn``. With ``operands`` both branches are
    required and take them, and the result differentiates through the
    taken one."""
    if not operands:
        if _truth(pred):
            return true_fn()
        return None if false_fn is None else false_fn()
    if false_fn is None:
        raise ValueError(
            "cond with operands needs BOTH branches with matching output "
            "structures (the reference compiles both); pass a false_fn "
            "that returns the same structure as true_fn")

    def run(p, *ops):
        taken, other = (true_fn, false_fn) if _truth(p) else \
            (false_fn, true_fn)
        out = taken(*ops)
        with torch.no_grad():
            shape_of_other = _structure(other(*ops))
        if _structure(out) != shape_of_other:
            t, f = (_structure(out), shape_of_other) if taken is true_fn \
                else (shape_of_other, _structure(out))
            raise ValueError(
                f"cond branches returned different structures: true branch "
                f"{t}, false branch {f}")
        return out
    return record_node(run, pred, *operands)


def _as_vars(out, like):
    if not isinstance(out, (list, tuple)):
        out = (out,)
    return [o if isinstance(o, torch.Tensor) else
            torch.as_tensor(o, dtype=v.dtype, device=v.device)
            for o, v in zip(out, like)]


def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None):
    """Reference ``control_flow.py while_loop``: ``body_fn`` while
    ``cond_fn`` holds. Forward-only, as the reference's: where grad is
    enabled, a loop var or a tensor or layer captured by ``cond_fn`` or
    ``body_fn`` that requires grad raises ``ValueError``
    (``bounded_while_loop`` is the differentiable loop)."""
    if not isinstance(loop_vars, (list, tuple)) or not loop_vars:
        raise ValueError("loop_vars must be a non-empty list/tuple")
    if torch.is_grad_enabled() and (
            any(isinstance(v, torch.Tensor) and v.requires_grad
                for v in loop_vars)
            or _captures_grad(cond_fn, body_fn)):
        raise ValueError(
            "static.nn.while_loop is forward-only and a loop var or a "
            "tensor/layer captured by cond_fn/body_fn requires grad — its "
            "gradient would silently be zero. Detach the inputs or wrap "
            "the call in no_grad(), or use static.nn.bounded_while_loop("
            "cond, body, vars, max_iters), which IS differentiable")

    def run(*vs):
        vs = list(vs)
        with torch.no_grad():
            while _truth(cond_fn(*vs), "loop condition"):
                vs = _as_vars(body_fn(*vs), vs)
        return vs
    return list(record_node(run, *loop_vars))


def bounded_while_loop(cond_fn, body_fn, loop_vars, max_iters: int,
                       name=None):
    """The trainable loop (reference ``bounded_while_loop``): ``body_fn``
    while ``cond_fn`` holds, at most ``max_iters`` times; gradients flow
    through the loop vars and through what the closures capture, equal
    to those of the same Python loop."""
    if not isinstance(loop_vars, (list, tuple)) or not loop_vars:
        raise ValueError("loop_vars must be a non-empty list/tuple")
    if max_iters <= 0:
        return list(loop_vars)
    n_vars = len(loop_vars)

    def run(*vs):
        vs = list(vs)
        for _ in range(int(max_iters)):
            if not _truth(cond_fn(*vs), "loop condition"):
                break
            new = body_fn(*vs)
            if not isinstance(new, (list, tuple)):
                new = (new,)
            if len(new) != n_vars:
                raise ValueError(
                    f"body_fn returned {len(new)} values for {n_vars} "
                    f"loop vars")
            vs = _as_vars(new, vs)
        return vs
    return list(record_node(run, *loop_vars))


def case(pred_fn_pairs, default=None, name=None):
    """Reference ``control_flow.py case``: the first branch whose
    predicate holds; with no ``default`` the last runs when none does."""
    if not pred_fn_pairs:
        raise ValueError("pred_fn_pairs must be non-empty")
    fns = [fn for _, fn in pred_fn_pairs]
    for p, fn in pred_fn_pairs:
        if _truth(p):
            return fn()
    return (default or fns[-1])()


def switch_case(branch_index, branch_fns, default=None, name=None):
    """Reference ``control_flow.py switch_case``: the branch keyed by
    ``branch_index``; with no ``default`` the largest key's catches an
    unmatched index."""
    if isinstance(branch_fns, dict):
        pairs = sorted(branch_fns.items())
    else:
        pairs = sorted((i, fn) if not isinstance(fn, (tuple, list))
                       else tuple(fn) for i, fn in enumerate(branch_fns))
    index = int(_host_value(branch_index, "branch index")
                if isinstance(branch_index, torch.Tensor) else branch_index)
    fn = dict((int(k), f) for k, f in pairs).get(index)
    return (fn or default or pairs[-1][1])()
