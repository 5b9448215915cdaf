"""The SPMD pipeline — port of
``paddle_tpu/distributed/fleet/spmd_pipeline.py``.

The reference runs the whole schedule as one compiled program: a
``lax.scan`` over clock ticks inside a ``shard_map`` over the ``pp``
axis, boundary activations rotating one stage a tick by ``ppermute``,
and its backward is ``jax.grad`` through the scan (:1-45). Here each
process is one stage and runs the same tick loop in Python:

* at tick ``t`` stage ``s`` decomposes ``u = t - s`` as ``u = g·vS + r·S
  + i`` and runs its virtual chunk ``r`` on micro-batch ``m = g·S + i``
  iff ``u >= 0 and m < M`` (reference :123-170); the micro-batch enters
  at stage 0, round 0, and an inactive tick's input is zeros. An
  inactive tick runs no body here (the reference computes one on zeros
  and masks it): its output is the zero carry itself, which keeps the
  ring's autograd graph whole, so every rank runs the same backward hops;
* the ring hop is :func:`~paddle_tpu_torch.distributed.collective.
  ring_hop`: one autograd node a tick for the whole boundary pytree,
  its backward the reverse hop;
* the last chunk's outputs are selected on stage S-1 and summed over
  ``pp`` (``fleet.mpu.reduce_from_group``: an all-reduce forward, the
  identity backward — the reference's ``psum`` to a replicated output,
  :172-181);
* the micro-batch inputs (and the hetero form's tied parameters) come in
  through :class:`_GradSum`, the identity forward whose backward sums
  the gradients over ``pp`` in one all-reduce — the transpose of a
  replicated ``shard_map`` input. Its node runs last in every rank's
  backward, after every tick's;
* ``remat`` runs each chunk body under ``fleet.utils.recompute``
  (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).

:class:`SpmdPipelineLayer` keeps the reference's stacked ``[v, S, ...]``
parameters sharded on ``pp``: each rank holds its ``[v, 1, ...]`` slice
(``_sharding_spec = P(None, "pp", ...)``, so ``TrainStep(mesh=)`` sums
their squared norms over ``pp`` and reduces their gradients over the
batch axes only), and ``state_dict()`` gives the full stacked tensors
(an all-gather over ``pp``). :class:`SpmdHeteroPipelineLayer` keeps each
stage's chunks flattened into one padded ``[v, 1, Lmax]`` slice of the
reference's ``[v, S, Lmax]``; the gradients of its tied ``shared``
layer sum over ``pp`` (reference tests/test_spmd_pipeline.py:489).
"""
from __future__ import annotations

import inspect
from typing import Callable, Optional

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import Parameter, unwrap
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.nn.layer_base import Layer

from .. import collective as C
from ..collective import P
from ..mesh import axis_index, axis_size, get_mesh
from .mpu import reduce_from_group
from .pipeline import _building_on

__all__ = ["pipeline_spmd", "spmd_schedule_stats", "SpmdPipelineLayer",
           "SpmdPipelineParallel", "pipeline_spmd_hetero",
           "SpmdHeteroPipelineLayer"]


def _completion_ticks(S: int, v: int, M: int) -> np.ndarray:
    """Tick at which micro-batch m's LAST chunk (stage S-1, round v-1)
    executes: t_m = (S-1) + (m//S)·vS + (v-1)·S + (m%S)."""
    m = np.arange(M)
    return (S - 1) + (m // S) * v * S + (v - 1) * S + (m % S)


def spmd_schedule_stats(num_stages: int, num_virtual_stages: int,
                        n_micro: int) -> dict:
    """The schedule's accounting in forward ticks (reference :69-83)."""
    S, v, M = num_stages, num_virtual_stages, n_micro
    span = int(_completion_ticks(S, v, M)[-1]) + 1
    busy = v * M
    return {
        "slots_span": span,
        "busy": {s: busy for s in range(S)},
        "bubble_fraction": round(1.0 - busy / span, 4) if span else 0.0,
        "n_micro": M,
        "n_chunks": S * v,
    }


# -- pytrees of tensors (dicts, tuples, lists) ---------------------------------
def _leaves(x) -> list:
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return [x]


def _rebuild(x, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(x)


def _tmap(fn, x):
    return _rebuild(x, [fn(t) for t in _leaves(x)])


def _pp(mesh, axis, what):
    mesh = mesh or get_mesh()
    if mesh is None or axis not in mesh.mesh_dim_names:
        raise RuntimeError(f"{what} needs a mesh with axis {axis!r}")
    return mesh, axis_size(mesh, axis), axis_index(mesh, axis), \
        C.Group((axis,), mesh)


class _GradSum(torch.autograd.Function):
    """The identity forward; backward, every gradient summed over the
    group in one all-reduce of their flat f32 concatenation."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        ctx.meta = [(x.shape, x.dtype) for x in xs]
        ctx.set_materialize_grads(True)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        flat = torch.cat([g.reshape(-1).float() for g in gs])
        C.all_reduce(flat, group=ctx.group)
        out, off = [], 0
        for shape, dtype in ctx.meta:
            n = int(np.prod(shape)) if len(shape) else 1
            out.append(flat[off:off + n].reshape(shape).to(dtype))
            off += n
        return (None,) + tuple(out)


class _Anchor(torch.autograd.Function):
    """Zeros like each of the first ``n`` tensors, hung off the rest (the
    tensors of this stage that require grad). The ring's carry starts
    here, so every tick's hop lies on a path from the loss to whatever
    the backward is asked for: autograd runs no node off such a path
    (``backward(inputs=...)`` prunes the rest), and a hop's backward has
    to run on every rank of the ring. The roots get no gradient here."""

    @staticmethod
    def forward(ctx, n, *ts):
        ctx.n_in = len(ts)
        out = tuple(torch.zeros_like(t) for t in ts[:n])
        ctx.mark_non_differentiable(*(o for o in out
                                      if not o.is_floating_point()))
        return out

    @staticmethod
    def backward(ctx, *gs):
        return (None,) * (1 + ctx.n_in)


def _run_ticks(step_fn, xs, shared, roots, S, v, s, group, remat):
    """The tick loop shared by both engines. ``step_fn(r, shared, x)``
    runs this stage's virtual chunk ``r`` with this stage's parameters
    ``roots`` (a pytree). Returns the last chunk's outputs (leaves
    ``[M, ...]``), on every rank of ``group``."""
    from .utils import recompute
    M = _leaves(xs)[0].shape[0]
    t_idx = _completion_ticks(S, v, M)
    span = int(t_idx[-1]) + 1
    x_leaves, sh_leaves = _leaves(xs), _leaves(shared)
    if S > 1 and any(t.requires_grad for t in x_leaves + sh_leaves):
        both = _GradSum.apply(group, *x_leaves, *sh_leaves)
        x_leaves, sh_leaves = both[:len(x_leaves)], both[len(x_leaves):]
        xs, shared = _rebuild(xs, x_leaves), _rebuild(shared, sh_leaves)
    dev = x_leaves[0].device
    vS = v * S
    roots = [t for t in [*_leaves(roots), *x_leaves, *sh_leaves]
             if t.requires_grad]
    likes = [b[0] for b in x_leaves]
    if S > 1 and roots and torch.is_grad_enabled():
        carry = _rebuild(xs, _Anchor.apply(len(likes), *likes, *roots))
    else:
        carry = _rebuild(xs, [torch.zeros_like(t) for t in likes])
    # the masks as device scalars made once (no host copy a tick)
    flags = {v_: torch.full((), v_, dtype=torch.bool, device=dev)
             for v_ in (False, True)}
    ys = []
    for t in range(span):
        u = t - s
        g, rem = divmod(u, vS)
        r, i = divmod(rem, S)
        m = g * S + i
        active = u >= 0 and m < M
        inject = active and s == 0 and r == 0
        m_safe = min(max(m, 0), M - 1)
        a, j = flags[active], flags[inject]
        x_in = _rebuild(xs, [
            torch.where(a, torch.where(j, b[m_safe], c), torch.zeros_like(c))
            for b, c in zip(_leaves(xs), _leaves(carry))])
        if active:
            y = recompute(step_fn, r, shared, x_in) if remat \
                else step_fn(r, shared, x_in)
        else:
            y = x_in
        ys.append(y)
        if t < span - 1 and S > 1:
            carry = _rebuild(y, C.ring_hop(*_leaves(y), group=group))
        else:
            carry = y
    is_last = torch.tensor(s == S - 1, device=dev)

    def collect(k):
        out = torch.stack([_leaves(ys[int(t)])[k] for t in t_idx])
        out = torch.where(is_last, out, torch.zeros_like(out))
        return reduce_from_group(out, group)
    return _rebuild(ys[0], [collect(k) for k in range(len(_leaves(ys[0])))])


def _stage_slice(a, v, S, s):
    """This stage's ``[v, ...]`` of a ``[v, S, ...]`` leaf (or of its own
    ``[v, 1, ...]`` slice)."""
    a = unwrap(a)
    if tuple(a.shape[:2]) == (v, S):
        return a[:, s]
    if tuple(a.shape[:2]) == (v, 1):
        return a[:, 0]
    raise ValueError(f"stacked param leaf {tuple(a.shape)} must lead with "
                     f"[v={v}, S={S}] (or this stage's [v={v}, 1])")


def pipeline_spmd(body_fn: Callable, stacked_params, micro_inputs,
                  mesh=None, axis: str = "pp", num_virtual_stages: int = 1,
                  remat: bool = True):
    """The collective pipeline on pytrees of tensors (reference :86-187).

    ``body_fn(chunk_params, x) -> y`` is one chunk, ``x`` and ``y`` of one
    structure, shape and dtype. ``stacked_params`` has leaves ``[v, S,
    ...]`` (this stage's ``[:, s]`` is used; its gradient lands there) or
    this stage's own ``[v, 1, ...]``; ``micro_inputs`` has leaves ``[M,
    ...]``. Returns the last chunk's outputs, leaves ``[M, ...]``, on
    every rank of ``axis``. Differentiable; run it on every rank."""
    mesh, S, s, group = _pp(mesh, axis, "pipeline_spmd")
    v = num_virtual_stages
    params = _tmap(lambda a: _stage_slice(a, v, S, s), stacked_params)
    xs = _tmap(unwrap, micro_inputs)

    def step(r, _shared, x):
        return body_fn(_tmap(lambda a: a[r], params), x)
    return _run_ticks(step, xs, {}, params, S, v, s, group, remat)


def _wants_shared(block) -> bool:
    """Only REQUIRED positional parameters beyond ``x`` opt a block into
    receiving the shared layer (reference :616-625)."""
    sig = inspect.signature(block.forward)
    required = [p for p in sig.parameters.values()
                if p.default is inspect.Parameter.empty
                and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    return len(required) >= 2


def _structure_only(block):
    """``block`` with its parameters on the meta device: a template for
    ``functional_call``, which passes every parameter in by name."""
    return torch.nn.Module.to(block, device="meta")


class _StackedOnPp(Layer):
    """A layer whose own parameters are stacked ``[v, S, ...]`` and split
    on ``pp`` (this rank keeps ``[v, 1, ...]``): ``state_dict()`` gives
    the full tensors (an all-gather over ``pp``: call it on every rank)
    and ``set_state_dict`` takes them."""

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        # keep_vars gives the local Parameters (the storage), as
        # set_state_dict needs
        for name, p in self._parameters.items():
            destination[prefix + name] = p if keep_vars else \
                C.all_gather(p.detach(), group=self._group, axis=1)

    def set_state_dict(self, state_dict, use_structured_name: bool = True):
        """Full ``[v, S, ...]`` values (numpy or tensors) of the stacked
        parameters into this rank's slices; other keys as usual."""
        s = self.stage_id
        local = {}
        for k, val in state_dict.items():
            val = val.detach() if isinstance(val, torch.Tensor) else \
                torch.as_tensor(np.asarray(val))
            local[k] = val[:, s:s + 1] if k in self._parameters and \
                val.shape[1] == self.num_stages else val
        return super().set_state_dict(local, use_structured_name)


class SpmdPipelineLayer(_StackedOnPp):
    """A homogeneous trunk over the ``pp`` axis (reference :190-289):
    ``block_factory()`` builds one chunk; ``S * num_virtual_stages`` are
    built on every rank, in order and one at a time (the random draws of
    one model built whole), and the parameters of this rank's chunks
    stacked into its ``[v, 1, ...]`` slice of the reference's ``[v, S,
    ...]``; the other chunks are dropped as they are built.
    The forward takes ``[M, B, ...]`` micro-batches and returns the last
    chunk's ``[M, B, ...]``. Blocks must be stateless apart from their
    parameters."""

    def __init__(self, block_factory: Callable[[], Layer],
                 num_virtual_stages: int = 1, mesh=None, axis: str = "pp",
                 remat: bool = True, loss_fn: Optional[Callable] = None,
                 device=None):
        super().__init__()
        self._mesh, S, s, self._group = _pp(mesh, axis, "SpmdPipelineLayer")
        self.axis = axis
        self.num_stages, self.stage_id = S, s
        self.num_virtual_stages = num_virtual_stages
        self.num_chunks = S * num_virtual_stages
        self.remat = remat
        self._loss_fn = loss_fn
        dev = resolve_device(device)
        v = num_virtual_stages
        own = {r * S + s: r for r in range(v)}
        names, kept = None, [None] * v
        with _building_on(dev):
            # one block alive at a time, in order: every chunk takes the
            # random draws of one model built whole, and this rank keeps
            # only its own chunks' values
            for c in range(self.num_chunks):
                block = block_factory().to(dev)
                got = [n for n, _ in block.named_parameters()]
                if names is None:
                    names, template = got, block
                    stop = {n: p.stop_gradient
                            for n, p in block.named_parameters()}
                elif got != names:
                    raise ValueError(
                        "block_factory must build identical parameter "
                        f"structures (got {got} vs {names})")
                if any(b is not None for _, b in block.named_buffers()):
                    raise ValueError(
                        "SpmdPipelineLayer blocks must be stateless (no "
                        "buffers/running stats); use the host-scheduled "
                        "PipelineParallel for stateful stages")
                if c in own:
                    kept[own[c]] = {n: p.detach()
                                    for n, p in block.named_parameters()}
                del block
        self._param_names = names
        for name in names:
            # chunk c = r*S + s sits at index [r, s]; this rank's [:, s]
            p = Parameter(torch.stack([k[name] for k in kept]).unsqueeze(1))
            p.stop_gradient = stop[name]
            p._sharding_spec = P(None, axis, *([None] * (p.dim() - 2)))
            p._sharding_mesh = self._mesh
            self.add_parameter(name.replace(".", "__"), p)
        # only the structure is used: every parameter comes in by name
        self.__dict__["_template"] = _structure_only(template)

    def _stacked(self):
        """``{name: this rank's [v, 1, ...] Parameter}``."""
        return {n: getattr(self, n.replace(".", "__"))
                for n in self._param_names}

    def schedule_stats(self, n_micro: int) -> dict:
        return spmd_schedule_stats(self.num_stages, self.num_virtual_stages,
                                   n_micro)

    def forward(self, micro_x):
        template = self.__dict__["_template"]
        stacked = self._stacked()

        def body_fn(chunk_params, x):
            return torch.func.functional_call(template, chunk_params, (x,))

        return pipeline_spmd(body_fn, stacked, micro_x, mesh=self._mesh,
                             axis=self.axis,
                             num_virtual_stages=self.num_virtual_stages,
                             remat=self.remat)


class SpmdPipelineParallel(Layer):
    """``train_batch`` over an :class:`SpmdPipelineLayer` (reference
    :292-356): the batch reshaped to ``[M, B/M, ...]``, one forward, the
    loss, one backward, the step; ``last_schedule_stats`` is the
    schedule's exact accounting."""

    def __init__(self, layers: SpmdPipelineLayer,
                 accumulate_steps: Optional[int] = None):
        super().__init__()
        self._layers = layers
        self.accumulate_steps = accumulate_steps or layers.num_stages
        self._loss_fn = layers._loss_fn
        self.last_schedule_stats: dict = {}

    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def named_parameters(self, prefix="", include_sublayers=True):
        return self._layers.named_parameters(prefix, include_sublayers)

    def forward(self, micro_x):
        return self._layers(micro_x)

    def _merged(self, inputs):
        M = self.accumulate_steps
        B = inputs.shape[0]
        if B % M:
            raise ValueError(
                f"batch {B} not divisible by accumulate_steps {M}")
        out = self._layers(inputs.reshape([M, B // M] +
                                          list(inputs.shape[1:])))
        return out.reshape([B] + list(out.shape[2:]))

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        inputs, labels = data
        loss = self._loss_fn(self._merged(inputs), labels)
        if scaler is not None:
            scaler.scale(loss).backward()
            scaler.step(optimizer)
            scaler.update()
        else:
            loss.backward()
            optimizer.step()
        optimizer.clear_grad(set_to_zero=False)
        if lr_scheduler is not None:
            lr_scheduler.step()
        self.last_schedule_stats = self._layers.schedule_stats(
            self.accumulate_steps)
        return loss

    @torch.no_grad()
    def eval_batch(self, data, compute_loss=True):
        inputs, labels = data
        merged = self._merged(inputs)
        if compute_loss and self._loss_fn is not None:
            return self._loss_fn(merged, labels)
        return merged


# -- heterogeneous and tied-weight stages ------------------------------------
def _hetero(branches, own, shared, micro_inputs, mesh, axis, v, remat):
    """The tick loop over per-chunk bodies: ``branches[c](params_c,
    shared, x)`` for this stage's chunks ``c = r*S + s``, whose
    parameters are ``own[r]``."""
    mesh, S, s, group = _pp(mesh, axis, "pipeline_spmd_hetero")
    xs = _tmap(unwrap, micro_inputs)
    shared = _tmap(unwrap, shared or {})

    def step(r, sh, x):
        return branches[r * S + s](own[r], sh, x)
    return _run_ticks(step, xs, shared, own, S, v, s, group, remat)


def pipeline_spmd_hetero(chunk_bodies, chunk_params, micro_inputs,
                         mesh=None, axis: str = "pp",
                         num_virtual_stages: int = 1, shared_params=None,
                         remat: bool = True):
    """The heterogeneous collective pipeline (reference :383-454):
    ``chunk_bodies[c](params_c, shared_params, x) -> y`` for the ``v*S``
    chunks, every boundary of one pytree structure; ``chunk_params`` is
    the list of per-chunk pytrees (this rank uses its own chunks'),
    ``shared_params`` a pytree every chunk may read, whose gradients sum
    over ``pp``. Returns the last chunk's outputs ``[M, ...]``."""
    mesh, S, s, _ = _pp(mesh, axis, "pipeline_spmd_hetero")
    v = num_virtual_stages
    C_ = v * S
    if len(chunk_bodies) != C_ or len(chunk_params) != C_:
        raise ValueError(
            f"need {C_} chunk bodies/params (S={S} x v={v}); got "
            f"{len(chunk_bodies)}/{len(chunk_params)}")
    own = [_tmap(unwrap, chunk_params[r * S + s]) for r in range(v)]
    return _hetero(chunk_bodies, own, shared_params, micro_inputs, mesh,
                   axis, v, remat)


class _WithShared(torch.nn.Module):
    """A chunk that takes the tied layer: ``block(x, shared)``."""

    def __init__(self, block, shared):
        super().__init__()
        self.block = block
        self.shared = shared

    def forward(self, x):
        return self.block(x, self.shared)


class SpmdHeteroPipelineLayer(_StackedOnPp):
    """Per-chunk bodies and an optional tied ``shared`` layer over ``pp``
    (reference :565-740). ``block_factories`` builds the ``S * v``
    chunks (on every rank, in order and one at a time, keeping this
    rank's; their structures may differ, their boundaries share one
    shape). Each stage's chunks live flattened in
    its ``[v, 1, Lmax]`` slice of the reference's padded ``[v, S, Lmax]``
    ``trunk_flat``. A block whose forward takes two required arguments
    gets ``(x, shared)``; the shared layer's gradient is the sum of every
    chunk's contribution over ``pp``."""

    def __init__(self, block_factories, num_virtual_stages: int = 1,
                 mesh=None, axis: str = "pp", remat: bool = True,
                 loss_fn: Optional[Callable] = None, shared_factory=None,
                 device=None):
        super().__init__()
        self._mesh, S, s, self._group = _pp(mesh, axis,
                                            "SpmdHeteroPipelineLayer")
        self.axis = axis
        self.num_stages, self.stage_id = S, s
        self.num_virtual_stages = num_virtual_stages
        self.num_chunks = S * num_virtual_stages
        self.remat = remat
        self._loss_fn = loss_fn
        if len(block_factories) != self.num_chunks:
            raise ValueError(
                f"need {self.num_chunks} block factories "
                f"(S={S} x v={num_virtual_stages}); got "
                f"{len(block_factories)}")
        dev = resolve_device(device)
        v = num_virtual_stages
        own = {r * S + s: r for r in range(v)}
        self._names, self._shapes, self._wants_shared = [], [], []
        dtype, stop_gradient = None, True
        own_params, blocks = [None] * v, [None] * self.num_chunks
        with _building_on(dev):
            for c, factory in enumerate(block_factories):
                b = factory().to(dev)
                if any(buf is not None for _, buf in b.named_buffers()):
                    raise ValueError(
                        f"chunk {c} has buffers/running stats; hetero spmd "
                        "chunks must be stateless apart from parameters")
                named = list(b.named_parameters())
                self._names.append([n for n, _ in named])
                self._shapes.append([tuple(p.shape) for _, p in named])
                self._wants_shared.append(_wants_shared(b))
                for _, p in named:
                    if dtype is None:
                        dtype = p.dtype
                    elif p.dtype != dtype:
                        raise ValueError(
                            "hetero pipeline blocks must share one param "
                            f"dtype (chunk {c} mixes {p.dtype} with "
                            f"{dtype})")
                    stop_gradient = stop_gradient and p.stop_gradient
                if c in own:
                    own_params[own[c]] = [p.detach() for _, p in named]
                    blocks[c] = b
                del b, named
            shared = shared_factory().to(dev) if shared_factory else None
        self._sizes = [int(sum(int(np.prod(s)) for s in shp))
                       for shp in self._shapes]
        Lmax = max(max(self._sizes), 1)
        flats = [torch.nn.functional.pad(
            torch.cat([p.reshape(-1) for p in ps]) if ps else
            torch.zeros(0, dtype=dtype or torch.float32, device=dev),
            (0, Lmax - sum(p.numel() for p in ps))) for ps in own_params]
        # chunk c = r*S + s sits at index [r, s]; this rank's [:, s]
        p = Parameter(torch.stack(flats).unsqueeze(1))
        p.stop_gradient = stop_gradient
        p._sharding_spec = P(None, axis, None)
        p._sharding_mesh = self._mesh
        self.add_parameter("trunk_flat", p)
        # this stage's blocks give only their structure: every parameter
        # comes in by name
        self.__dict__["_blocks"] = [
            None if b is None else
            _WithShared(_structure_only(b), shared)
            if self._wants_shared[c] and shared is not None
            else _structure_only(b) for c, b in enumerate(blocks)]
        if shared is not None and S > 1:
            # one value on every stage: the first stage's
            with torch.no_grad():
                for q in shared.parameters():
                    C.broadcast(q.data, src=0, group=self._group)
        self.shared = shared

    def schedule_stats(self, n_micro: int) -> dict:
        return spmd_schedule_stats(self.num_stages,
                                   self.num_virtual_stages, n_micro)

    def chunk_state_dict(self, c: int):
        """Chunk ``c``'s parameters as a name -> numpy dict, unpadded and
        unflattened (an all-gather over ``pp``: call it on every rank)."""
        full = C.all_gather(self.trunk_flat.detach(), group=self._group,
                            axis=1)
        vec = full.reshape(self.num_chunks, -1)[c].cpu().numpy()
        out, off = {}, 0
        for name, shp in zip(self._names[c], self._shapes[c]):
            n = int(np.prod(shp)) if shp else 1
            out[name] = vec[off:off + n].reshape(shp)
            off += n
        return out

    def forward(self, micro_x):
        v = self.num_virtual_stages
        shared = self.shared
        shared_named = dict(shared.named_parameters()) \
            if shared is not None else {}
        blocks = self.__dict__["_blocks"]

        def make_branch(c):
            block, names, shapes = blocks[c], self._names[c], self._shapes[c]
            if block is None:
                return None
            wants = isinstance(block, _WithShared)

            def branch(vec, shared_p, x):
                vals, off = {}, 0
                for name, shp in zip(names, shapes):
                    n = int(np.prod(shp)) if shp else 1
                    vals[("block." if wants else "") + name] = \
                        vec[off:off + n].reshape(shp)
                    off += n
                if wants:
                    vals.update({"shared." + k: t
                                 for k, t in shared_p.items()})
                return torch.func.functional_call(block, vals, (x,))
            return branch

        branches = [make_branch(c) for c in range(self.num_chunks)]
        own = [self.trunk_flat[r, 0] for r in range(v)]
        return _hetero(branches, own, shared_named, micro_x, self._mesh,
                       self.axis, v, self.remat)
