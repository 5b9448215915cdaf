"""Mixture-of-Experts — port of ``paddle_tpu/distributed/fleet/moe.py``.

Experts are stacked weight tensors ``[E, d_model, d_hidden]``; each
token's top-k experts come from a softmax gate, every expert takes at
most ``C = max(int(capacity_factor * T * K / E), 1)`` assignments, and
over-capacity assignments drop (contribute zero). The expert products
are ``torch.bmm`` over the capacity layout ``[E, C, d_model]``, as the
reference leaves its einsums to XLA (:315-317); the grouped-matmul
kernels are not on this path in either package.

Two dispatch formulations behind the same API (``dispatch_mode``):

* ``"ragged"`` (default) — index routing: assignment ``(k, t)`` takes
  capacity slot ``e*C + position``; a slot→token map and a
  token→slot map are each other's inverse, so dispatch, combine and both
  their backward passes are row gathers (:class:`_Dispatch`,
  :class:`_Combine`). The port's gradients are therefore deterministic:
  no row scatter-add and no atomics.
* ``"dense"`` — the GShard one-hot ``[T, E, C]`` contraction, the
  reference's own oracle, kept for the same purpose.

Expert-parallel sharding (``mesh=``) is not ported and raises.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from paddle_tpu_torch.core.dtype import convert_dtype
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.nn.initializer import XavierUniform

__all__ = ["MoELayer", "NaiveGate", "SwitchGate", "GShardGate", "route"]

_ACTIVATIONS = {
    # jax.nn.gelu's default is the tanh approximation
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "relu": torch.relu,
    "silu": torch.nn.functional.silu,
}


def _take0(arr, idx):
    """``arr`` with a zero row appended, gathered at ``idx`` (an index of
    ``len(arr)`` reads the zero row)."""
    pad = torch.cat([arr, arr.new_zeros(1, arr.shape[1])])
    return pad[idx]


class _Dispatch(torch.autograd.Function):
    """Capacity slots from tokens: ``out[s] = xt[slot_src[s]]`` (the pad
    row for an empty slot). Backward: each token sums the gradient rows
    of its K slots, gathered through ``slots_stack`` (reference :73-88)."""

    @staticmethod
    def forward(ctx, xt, slot_src, slots_stack, n_slots):
        ctx.save_for_backward(slots_stack)
        return _take0(xt, slot_src[:n_slots])

    @staticmethod
    def backward(ctx, g):
        slots_stack, = ctx.saved_tensors
        pad = torch.cat([g, g.new_zeros(1, g.shape[1])])
        dxt = pad[slots_stack[0]]
        for k in range(1, slots_stack.shape[0]):
            dxt = dxt + pad[slots_stack[k]]
        return dxt, None, None, None


class _Combine(torch.autograd.Function):
    """Tokens from slots: ``out[t] = Σ_k flat[slots[k, t]] * w[k, t]``.
    Backward (reference :102-112): ``d_flat[s] = g[token(s)] * w_slot[s]``
    through the inverse map, and ``d_w[k, t] = <flat[slots[k, t]], g[t]>``;
    the integer maps and ``w_slot`` take no gradient."""

    @staticmethod
    def forward(ctx, flat, w_stack, slot_src, slots_stack, w_slot, n_slots):
        pad = torch.cat([flat, flat.new_zeros(1, flat.shape[1])])
        out = pad[slots_stack[0]] * w_stack[0][:, None]
        for k in range(1, slots_stack.shape[0]):
            out = out + pad[slots_stack[k]] * w_stack[k][:, None]
        ctx.save_for_backward(flat, w_stack, slot_src, slots_stack, w_slot)
        ctx.n_slots = n_slots
        return out

    @staticmethod
    def backward(ctx, g):
        flat, w_stack, slot_src, slots_stack, w_slot = ctx.saved_tensors
        n_slots = ctx.n_slots
        d_flat = _take0(g, slot_src[:n_slots]) * w_slot[:n_slots, None]
        pad = torch.cat([flat, flat.new_zeros(1, flat.shape[1])])
        d_w = torch.stack([(pad[slots_stack[k]] * g).sum(-1)
                           for k in range(slots_stack.shape[0])])
        return d_flat, d_w.to(w_stack.dtype), None, None, None, None


def _xavier_uniform_(p, generator):
    """``nn.initializer.XavierUniform``'s draw for a ``[fan_in,
    fan_out]`` weight, in place from ``generator``."""
    bound = XavierUniform().limit(p.shape)
    p.uniform_(-bound, bound, generator=generator)


class _GateBase(torch.nn.Module):
    top_k = 2
    aux = "none"

    def __init__(self, d_model, num_experts, top_k=None, *, device=None,
                 dtype="float32"):
        super().__init__()
        self.d_model = d_model
        self.num_experts = num_experts
        if top_k is not None:
            self.top_k = top_k
        self.weight = torch.nn.Parameter(torch.zeros(
            d_model, num_experts, device=resolve_device(device),
            dtype=convert_dtype(dtype)))


class NaiveGate(_GateBase):
    """top-k softmax gate, no auxiliary loss."""
    aux = "none"


class SwitchGate(_GateBase):
    """top-1 gate with the Switch-Transformer load-balance loss."""
    top_k = 1
    aux = "switch"


class GShardGate(_GateBase):
    """top-2 gate with GShard's ``mean(me * ce) * E^2`` aux loss."""
    top_k = 2
    aux = "gshard"


class Routing(NamedTuple):
    """One forward's routing: ``probs`` [T, E]; ``gate_k``/``idx_k`` [T, K]
    (descending, ties to the lower expert); ``pos`` [K, T] each
    assignment's position within its expert (pick-major order); ``kept``
    [K, T] bool; ``counts`` [E] assignments per expert (padding
    excluded); ``capacity`` C."""
    probs: torch.Tensor
    gate_k: torch.Tensor
    idx_k: torch.Tensor
    pos: torch.Tensor
    kept: torch.Tensor
    counts: torch.Tensor
    capacity: int


def _positions(e_flat):
    """Each entry's running count within its value, in order: one stable
    sort, position = index - segment start (reference :254-263)."""
    n = e_flat.shape[0]
    e_sorted, order = torch.sort(e_flat, stable=True)
    ar = torch.arange(n, device=e_flat.device)
    boundary = torch.ones(n, dtype=torch.bool, device=e_flat.device)
    boundary[1:] = e_sorted[1:] != e_sorted[:-1]
    seg_start = torch.cummax(torch.where(boundary, ar, torch.zeros_like(ar)),
                             dim=0).values
    pos = torch.empty_like(ar)
    pos[order] = ar - seg_start
    return pos


def route(xt, gate_weight, top_k, capacity_factor, valid=None) -> Routing:
    """The gate of :class:`MoELayer` on tokens ``xt`` [T, d_model]:
    softmax over ``xt @ gate_weight``, the top ``top_k`` experts per token
    (``lax.top_k``'s order: a stable descending sort keeps ties in index
    order), positions from one stable sort of the pick-major expert ids,
    and the capacity drop. ``valid`` [T] bool sends padding to the
    sentinel expert E, outside every count."""
    T = xt.shape[0]
    E = gate_weight.shape[1]
    C = max(int(capacity_factor * T * top_k / E), 1)
    probs = torch.softmax(xt @ gate_weight, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_k, idx_k = vals[:, :top_k], idx[:, :top_k]
    e_flat = idx_k.t().reshape(top_k * T)
    if valid is not None:
        e_flat = torch.where(valid.repeat(top_k), e_flat,
                             torch.full_like(e_flat, E))
    pos = _positions(e_flat).reshape(top_k, T)
    counts = torch.bincount(e_flat, minlength=E + 1)[:E]
    kept = pos < C
    if valid is not None:
        kept = kept & valid[None, :]
    return Routing(probs, gate_k, idx_k, pos, kept, counts, C)


class MoELayer(torch.nn.Module):
    """Experts are a stacked MLP (w1 -> act -> w2, with biases); the gate
    routes each token to its top-k experts. ``forward`` sets ``l_aux`` to
    the gate's balance loss, and ``last_capacity``/``last_dropped`` to the
    capacity and the number of real assignments dropped (a 0-d tensor on
    the device). ``device=None`` is the CUDA card; weights start from the
    reference's initializers drawn from a generator seeded with ``seed``.
    """

    def __init__(self, d_model, d_hidden, num_experts, gate="gshard",
                 top_k=None, capacity_factor=1.25, activation="gelu",
                 dispatch_mode="ragged", mesh=None,
                 axis: Optional[str] = "ep", name=None, *, device=None,
                 dtype="float32", seed: int = 0):
        super().__init__()
        if dispatch_mode not in ("ragged", "dense"):
            raise ValueError(f"dispatch_mode {dispatch_mode!r} must be "
                             "'ragged' or 'dense'")
        if mesh is not None:
            raise NotImplementedError(
                "expert-parallel sharding (mesh=) is not ported to "
                "paddle_tpu_torch yet")
        if activation not in _ACTIVATIONS:
            raise ValueError(f"activation {activation!r} (want one of "
                             f"{sorted(_ACTIVATIONS)})")
        device = resolve_device(device)
        dtype = convert_dtype(dtype)
        self.d_model = d_model
        self.d_hidden = d_hidden
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.dispatch_mode = dispatch_mode
        self._activation = activation
        own_gate = isinstance(gate, str)
        if own_gate:
            cls = {"naive": NaiveGate, "switch": SwitchGate,
                   "gshard": GShardGate}[gate]
            gate = cls(d_model, num_experts, top_k=top_k, device=device,
                       dtype=dtype)
        self.gate = gate

        def param(*shape):
            return torch.nn.Parameter(torch.zeros(*shape, device=device,
                                                  dtype=dtype))
        self.w1 = param(num_experts, d_model, d_hidden)
        self.b1 = param(num_experts, d_hidden)
        self.w2 = param(num_experts, d_hidden, d_model)
        self.b2 = param(num_experts, d_model)
        self.l_aux = None
        self.last_capacity = None
        self.last_dropped = None
        generator = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            if own_gate:
                _xavier_uniform_(self.gate.weight, generator)
            self.reset_experts(generator)

    @torch.no_grad()
    def reset_experts(self, generator):
        """The reference's expert init: w1 ~ U(±1/sqrt(d_model)), w2 ~
        U(±1/sqrt(d_hidden)), biases 0."""
        for w in (self.w1, self.w2):
            bound = 1.0 / math.sqrt(w.shape[1])
            w.uniform_(-bound, bound, generator=generator)
        self.b1.zero_()
        self.b2.zero_()

    def forward(self, x, token_mask=None):
        """x: [..., d_model] -> same shape; stores ``l_aux``.

        ``token_mask`` (optional, broadcastable to x's leading dims, True
        = real token) excludes padding from routing: masked tokens take
        the sentinel expert, so they claim no capacity, no count and no
        aux-loss weight."""
        E = self.num_experts
        K = self.gate.top_k
        act = _ACTIVATIONS[self._activation]
        lead = x.shape[:-1]
        xt = x.reshape(-1, x.shape[-1])
        T, M = xt.shape
        valid = None
        if token_mask is not None:
            valid = torch.broadcast_to(torch.as_tensor(
                token_mask, device=x.device).bool(), lead).reshape(T)
        r = route(xt, self.gate.weight, K, self.capacity_factor, valid)
        C = r.capacity
        probs = r.probs
        if valid is None:
            me = probs.mean(dim=0)
            ce = r.counts.to(probs.dtype) / T
        else:
            n_real = torch.clamp(valid.sum(), min=1).to(probs.dtype)
            me = (probs * valid[:, None].to(probs.dtype)).sum(dim=0) / n_real
            ce = r.counts.to(probs.dtype) / n_real
        kept = r.kept.to(probs.dtype)
        # renormalise the gates over the KEPT assignments
        denom = sum(r.gate_k[:, k] * kept[k] for k in range(K))
        denom = torch.clamp(denom, min=1e-9)

        if self.dispatch_mode == "ragged":
            n_slots = E * C
            slots_stack = torch.where(r.kept, r.idx_k.t() * C + r.pos,
                                      torch.full_like(r.pos, n_slots))
            slot_src = torch.full((n_slots + 1,), T, dtype=torch.long,
                                  device=x.device)
            tok = torch.arange(T, device=x.device)
            for k in range(K):  # kept slots are unique: no write conflicts
                slot_src[slots_stack[k]] = tok
            expert_in = _Dispatch.apply(xt, slot_src, slots_stack,
                                        n_slots).reshape(E, C, M)
        else:
            dispatch = torch.zeros(T, E, C, dtype=xt.dtype, device=x.device)
            combine = torch.zeros(T, E, C, dtype=xt.dtype, device=x.device)
            for k in range(K):
                onehot = torch.nn.functional.one_hot(r.idx_k[:, k], E)
                pos_oh = torch.nn.functional.one_hot(
                    torch.where(r.kept[k], r.pos[k],
                                torch.full_like(r.pos[k], C)), C + 1)[:, :C]
                cell = (onehot[:, :, None] * pos_oh[:, None, :]).to(xt.dtype)
                dispatch = dispatch + cell
                combine = combine + (r.gate_k[:, k] / denom).to(
                    xt.dtype)[:, None, None] * cell
            expert_in = torch.einsum("tec,tm->ecm", dispatch, xt)

        # the expert GEMMs over the capacity layout (empty slots included:
        # they are never gathered back and take a zero gradient)
        h = act(torch.bmm(expert_in, self.w1) + self.b1[:, None, :])
        expert_out = torch.bmm(h, self.w2) + self.b2[:, None, :]

        if self.dispatch_mode == "ragged":
            w_stack = torch.stack([(r.gate_k[:, k] * kept[k] / denom).to(
                xt.dtype) for k in range(K)])
            with torch.no_grad():
                w_slot = torch.zeros(n_slots + 1, dtype=xt.dtype,
                                     device=x.device)
                for k in range(K):
                    w_slot[slots_stack[k]] = w_stack[k]
            out = _Combine.apply(expert_out.reshape(n_slots, M), w_stack,
                                 slot_src, slots_stack, w_slot, n_slots)
        else:
            out = torch.einsum("tec,ecm->tm", combine, expert_out)

        aux_kind = getattr(self.gate, "aux", "none")
        if aux_kind == "switch":
            aux = (me * ce).sum() * E
        elif aux_kind == "gshard":
            aux = (me * (ce / K)).sum() * E
        else:
            aux = torch.zeros((), dtype=xt.dtype, device=x.device)
        self.l_aux = aux
        self.last_capacity = C
        n_assigned = T * K if valid is None else valid.sum() * K
        self.last_dropped = (n_assigned - r.kept.sum()).detach()
        return out.reshape(*lead, M)
