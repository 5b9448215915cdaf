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

**Expert parallelism** (``mesh=``, else the global mesh; reference
:188-196). Where the mesh's ``axis`` (``"ep"``) has ``ep`` ranks and
``ep`` divides ``E``, rank ``r`` keeps experts ``[r*E/ep, (r+1)*E/ep)``
of each stack (``_sharding_spec`` ``P("ep", None, None)``, the biases
``P("ep", None)``), drawn as the full stacks from the seeded generator
and cut, so the model equals the one-device model of its seed;
otherwise the stacks stay whole. The semantics stay the reference's
global ones: ``C`` over the global ``T``, every assignment's slot its
position in the pick-major order over the global token index (so
which assignment drops is decided globally), and ``l_aux`` from the
global ``me`` and ``ce``. Two token layouts, told apart by
``distributed.parallel.batch_split()``, which ``TrainStep(mesh=)`` sets
from its input spec (never guessed from the data):

* **(a) the batch whole on every rank** (``input_spec=P()``, and every
  eager call): each rank routes every token and runs only its experts'
  slots; the combine is a partial sum, all-reduced over ``ep`` in the
  forward (``mpu.reduce_from_group``); the input of the dispatch and
  the combine weights pass ``mpu.copy_to_group``, so the partial
  gradients of ``x`` and of the gate are summed in the backward.
* **(b) rows split over the mesh** (``input_spec=P("ep")``, with any
  other axes on dim 0): each rank routes its own rows. One all-gather of
  the per-(pick, expert) counts over the row axes gives the global
  ``C``, each assignment's global position (rank ``r``'s tokens come
  after those of ranks below it) and the global ``ce``; the gate
  probabilities' sum is all-reduced for ``me``. Each rank fills an
  ``[E, C, M]`` buffer with its slots (disjoint across ranks), an
  ``all_to_all`` over ``ep`` takes every expert's rows to its owner,
  which sums them, and the outputs come back the same way. Under a
  split ``ep`` whose stacks are whole (``ep`` does not divide ``E``)
  every rank runs all experts on its own slots.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from paddle_tpu_torch.core.dtype import convert_dtype
from paddle_tpu_torch.core.tensor import Parameter
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.nn.initializer import XavierUniform
from paddle_tpu_torch.nn.layer_base import Layer

from .. import collective as CC
from ..collective import P
from ..mesh import axis_index, axis_size, get_mesh, local_block
from ..parallel import batch_split
from .mpu import copy_to_group, reduce_from_group

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


class _AllReduceSum(torch.autograd.Function):
    """A sum over ``group`` whose every rank's result depends on every
    rank's input: the gradient is all-reduced too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return CC.all_reduce(x.contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return CC.all_reduce(g.contiguous().clone(), group=ctx.group), None


class _ToOwners(torch.autograd.Function):
    """``[E, C, M]`` slots filled by this rank -> ``[E/ep, C, M]`` of this
    rank's experts: each expert block goes to its owner, which sums what
    the ``ep`` ranks sent (a slot is filled on one rank only). The
    backward sends the owner's gradient block back to every rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = CC.all_to_all(list(x.chunk(group.nranks, 0)), group=group)
        return torch.stack(parts).sum(0)

    @staticmethod
    def backward(ctx, g):
        parts = CC.all_to_all([g.contiguous()] * ctx.group.nranks,
                              group=ctx.group)
        return torch.cat(parts), None


class _FromOwners(torch.autograd.Function):
    """``[E/ep, C, M]`` outputs of this rank's experts -> every expert's
    ``[E, C, M]`` on every rank; the transpose of :class:`_ToOwners`."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return torch.cat(CC.all_to_all([y.contiguous()] * group.nranks,
                                       group=group))

    @staticmethod
    def backward(ctx, g):
        parts = CC.all_to_all(list(g.chunk(ctx.group.nranks, 0)),
                              group=ctx.group)
        return torch.stack(parts).sum(0), None


def _xavier_uniform_(p, generator):
    """``nn.initializer.XavierUniform``'s draw for a ``[fan_in,
    fan_out]`` weight, in place from ``generator``."""
    bound = XavierUniform().limit(p.shape)
    p.uniform_(-bound, bound, generator=generator)


class _GateBase(Layer):
    top_k = 2
    aux = "none"

    def __init__(self, d_model, num_experts, top_k=None, *, device=None,
                 dtype="float32"):
        super().__init__()
        self.d_model = d_model
        self.num_experts = num_experts
        if top_k is not None:
            self.top_k = top_k
        self.weight = Parameter(torch.zeros(
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


def _route_local(xt, gate_weight, top_k, valid):
    """``(probs, gate_k, idx_k, pos, counts_ke)`` of this rank's tokens:
    positions within this rank's pick-major order, and the ``[K, E]``
    assignments per (pick, expert), padding excluded."""
    T = xt.shape[0]
    E = gate_weight.shape[1]
    probs = torch.softmax(xt @ gate_weight, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_k, idx_k = vals[:, :top_k], idx[:, :top_k]
    e_flat = idx_k.t().reshape(top_k * T)
    if valid is not None:
        e_flat = torch.where(valid.repeat(top_k), e_flat,
                             torch.full_like(e_flat, E))
    pos = _positions(e_flat).reshape(top_k, T)
    # E + 1 fixed bins (the sentinel's last): no read of the largest id
    # back to the host, so the count runs under CUDA-graph capture
    e_kt = e_flat.reshape(top_k, T)
    counts_ke = torch.zeros(top_k, E + 1, dtype=torch.long,
                            device=xt.device).scatter_add_(
        1, e_kt, torch.ones_like(e_kt))[:, :E]
    return probs, gate_k, idx_k, pos, counts_ke


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
    probs, gate_k, idx_k, pos, counts_ke = _route_local(
        xt, gate_weight, top_k, valid)
    kept = pos < C
    if valid is not None:
        kept = kept & valid[None, :]
    return Routing(probs, gate_k, idx_k, pos, kept, counts_ke.sum(0), C)


def _route_split(xt, gate_weight, top_k, capacity_factor, valid, group,
                 rank):
    """:func:`route` over the rows of every rank of ``group`` (this one's
    are ``xt``, its index ``rank``), with the global semantics: one
    all-gather of each rank's ``[K, E]`` counts, its token count and its
    real tokens gives ``C`` over the global ``T``, the global position of
    each assignment and the global counts. Returns the routing (``pos``
    global, ``counts`` global) and ``(T, n_real)`` over the group."""
    T = xt.shape[0]
    E = gate_weight.shape[1]
    probs, gate_k, idx_k, pos, cnt = _route_local(xt, gate_weight, top_k,
                                                 valid)
    n_real = T if valid is None else valid.sum()
    mine = torch.cat([cnt.reshape(-1), torch.as_tensor(
        [T, n_real], dtype=torch.long, device=xt.device)])
    every = CC.all_gather(mine[None], group=group, axis=0)
    counts_all = every[:, :-2].reshape(-1, top_k, E)   # [n, K, E]
    glob = counts_all.sum(0)
    t_glob, n_glob = every[:, -2].sum(), every[:, -1].sum()
    # position = local position - this rank's earlier picks + every
    # rank's earlier picks + the earlier ranks' assignments of this pick
    shift = torch.cumsum(glob - cnt, 0) - (glob - cnt) + \
        counts_all[:rank].sum(0)                        # [K, E]
    idx_c = torch.clamp(idx_k.t(), max=E - 1)
    pos = pos + torch.gather(shift, 1, idx_c)
    C = max(int(capacity_factor * int(t_glob) * top_k / E), 1)
    kept = pos < C
    if valid is not None:
        kept = kept & valid[None, :]
    return Routing(probs, gate_k, idx_k, pos, kept, glob.sum(0), C), \
        (t_glob, n_glob)


class MoELayer(Layer):
    """Experts are a stacked MLP (w1 -> act -> w2, with biases); the gate
    routes each token to its top-k experts. ``forward`` sets ``l_aux`` to
    the gate's balance loss, and ``last_capacity``/``last_dropped`` to the
    capacity and the number of real assignments dropped (a 0-d tensor on
    the device; both global under a row split). ``device=None`` is the
    CUDA card; weights start from the reference's initializers drawn
    from a generator seeded with ``seed``. ``mesh``/``axis``: the expert
    parallelism of the module docstring (``mesh=None`` takes the global
    mesh, as the reference does).
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
        # expert parallelism: the group over ``axis`` when it has ranks,
        # and this rank's experts when it divides E
        self._mesh = mesh or get_mesh()
        self._axis = axis
        self._group = None
        n_local, self._e0 = num_experts, 0
        if self._mesh is not None and axis in self._mesh.mesh_dim_names \
                and axis_size(self._mesh, axis) > 1:
            self._group = CC.Group((axis,), self._mesh)
            ep = axis_size(self._mesh, axis)
            if num_experts % ep == 0:
                n_local = num_experts // ep
                self._e0 = axis_index(self._mesh, axis) * n_local
        self.sharded = n_local != num_experts

        def param(*shape):
            p = Parameter(torch.zeros(n_local, *shape, device=device,
                                      dtype=dtype))
            if self.sharded:
                p._sharding_spec = P(axis, *([None] * len(shape)))
                p._sharding_mesh = self._mesh
            return p
        self.w1 = param(d_model, d_hidden)
        self.b1 = param(d_hidden)
        self.w2 = param(d_hidden, d_model)
        self.b2 = param(d_model)
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
        U(±1/sqrt(d_hidden)), biases 0. A sharded stack draws the full
        stack and keeps its block, as every rank does."""
        for w in (self.w1, self.w2):
            bound = 1.0 / math.sqrt(w.shape[1])
            if not self.sharded:
                w.uniform_(-bound, bound, generator=generator)
                continue
            full = torch.empty(self.num_experts, *w.shape[1:],
                               dtype=w.dtype, device=w.device)
            full.uniform_(-bound, bound, generator=generator)
            w.copy_(local_block(full, w._sharding_spec, self._mesh))
        self.b1.zero_()
        self.b2.zero_()

    def _token_layout(self):
        """The row group when this forward's tokens are this rank's rows
        of a batch split over ``axis`` (layout (b)), else None (layout
        (a): the batch whole on every rank)."""
        if self._group is None:
            return None
        rows, batch = batch_split()
        if self._axis in rows:
            return CC.Group(rows, self._mesh)
        if self._axis in batch:
            raise NotImplementedError(
                f"the batch is split over {self._axis!r} on a dim other "
                "than its rows: the expert-parallel layer takes a split "
                "of dim 0 only")
        return None

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
        rows = self._token_layout()
        ep = self._group
        if rows is None:
            r = route(xt, self.gate.weight, K, self.capacity_factor, valid)
            n_tok = T if valid is None else \
                torch.clamp(valid.sum(), min=1).to(r.probs.dtype)
        else:
            r, (t_glob, n_glob) = _route_split(
                xt, self.gate.weight, K, self.capacity_factor, valid, rows,
                rows.rank)
            n_tok = (t_glob if valid is None else
                     torch.clamp(n_glob, min=1)).to(r.probs.dtype)
        C = r.capacity
        probs = r.probs
        if valid is None:
            psum = probs.sum(dim=0)
        else:
            psum = (probs * valid[:, None].to(probs.dtype)).sum(dim=0)
        if rows is None:
            me = probs.mean(dim=0) if valid is None else psum / n_tok
        else:
            me = _AllReduceSum.apply(psum, rows) / n_tok
        ce = r.counts.to(probs.dtype) / n_tok
        kept = r.kept.to(probs.dtype)
        # renormalise the gates over the KEPT assignments
        denom = sum(r.gate_k[:, k] * kept[k] for k in range(K))
        denom = torch.clamp(denom, min=1e-9)

        # the capacity buffer: this rank's experts (layout (a), sharded)
        # or every expert's slots of this rank's tokens
        partial = self.sharded and rows is None
        e0, n_e = (self._e0, self.w1.shape[0]) if partial else (0, E)
        xd = copy_to_group(xt, ep) if partial else xt
        n_slots = n_e * C
        if self.dispatch_mode == "ragged":
            mine = r.kept & (r.idx_k.t() >= e0) & (r.idx_k.t() < e0 + n_e)
            slots_stack = torch.where(mine, (r.idx_k.t() - e0) * C + r.pos,
                                      torch.full_like(r.pos, n_slots))
            slot_src = torch.full((n_slots + 1,), T, dtype=torch.long,
                                  device=x.device)
            tok = torch.arange(T, device=x.device)
            for k in range(K):  # kept slots are unique: no write conflicts
                slot_src[slots_stack[k]] = tok
            expert_in = _Dispatch.apply(xd, slot_src, slots_stack,
                                        n_slots).reshape(n_e, C, M)
        else:
            scale = torch.stack([r.gate_k[:, k] / denom for k in range(K)])
            if partial:
                scale = copy_to_group(scale, ep)
            dispatch = torch.zeros(T, n_e, C, dtype=xt.dtype,
                                   device=x.device)
            combine = torch.zeros(T, n_e, C, dtype=xt.dtype, device=x.device)
            for k in range(K):
                onehot = torch.nn.functional.one_hot(
                    r.idx_k[:, k], E)[:, e0:e0 + n_e]
                pos_oh = torch.nn.functional.one_hot(
                    torch.where(r.kept[k], r.pos[k],
                                torch.full_like(r.pos[k], C)), C + 1)[:, :C]
                cell = (onehot[:, :, None] * pos_oh[:, None, :]).to(xt.dtype)
                dispatch = dispatch + cell
                combine = combine + scale[k].to(
                    xt.dtype)[:, None, None] * cell
            expert_in = torch.einsum("tec,tm->ecm", dispatch, xd)

        exchange = self.sharded and rows is not None
        if exchange:  # every expert's rows to its owner
            expert_in = _ToOwners.apply(expert_in, ep)
        # the expert GEMMs over the capacity layout (empty slots included:
        # they are never gathered back and take a zero gradient)
        h = act(torch.bmm(expert_in, self.w1) + self.b1[:, None, :])
        expert_out = torch.bmm(h, self.w2) + self.b2[:, None, :]
        if exchange:
            expert_out = _FromOwners.apply(expert_out, ep)

        if self.dispatch_mode == "ragged":
            w_stack = torch.stack([(r.gate_k[:, k] * kept[k] / denom).to(
                xt.dtype) for k in range(K)])
            with torch.no_grad():
                w_slot = torch.zeros(n_slots + 1, dtype=xt.dtype,
                                     device=x.device)
                for k in range(K):
                    w_slot[slots_stack[k]] = w_stack[k]
            out = _Combine.apply(
                expert_out.reshape(n_slots, M),
                copy_to_group(w_stack, ep) if partial else w_stack,
                slot_src, slots_stack, w_slot, n_slots)
        else:
            out = torch.einsum("tec,ecm->tm", combine, expert_out)
        if partial:  # the other experts' parts of each token
            out = reduce_from_group(out, ep)

        aux_kind = getattr(self.gate, "aux", "none")
        if aux_kind == "switch":
            aux = (me * ce).sum() * E
        elif aux_kind == "gshard":
            aux = (me * (ce / K)).sum() * E
        else:
            aux = torch.zeros((), dtype=xt.dtype, device=x.device)
        self.l_aux = aux
        self.last_capacity = C
        if rows is None:
            n_assigned = T * K if valid is None else valid.sum() * K
            self.last_dropped = (n_assigned - r.kept.sum()).detach()
        else:  # positions run 0.. per expert over the row group
            self.last_dropped = torch.clamp(r.counts - C, min=0).sum()
        return out.reshape(*lead, M)
