"""The mesh path of ``TrainStep`` — port of the SPMD branch of
``paddle_tpu/jit/train_step.py`` (:579-660) with the bucketed gradient
collectives of ``paddle_tpu/jit/bucketing.py``.

The reference compiles one program over the global batch and lets GSPMD
place the collectives. Here each process is one rank and runs its part:

* **batch** — each tensor leaf of the batch is cut to this rank's block
  by ``input_spec`` (default ``P("dp")`` where the mesh has ``dp``: rows
  split over ``dp``, the reference's default, :643-645); the axes the
  spec splits, on any dim, are the step's *batch axes* (``P(None,
  "dp")`` splits an SPMD pipeline's ``[M, B, ...]`` micro-batches over
  ``dp``), and those of its dim 0 its *row axes*. The forward runs
  under ``distributed.parallel.splitting_batch(row axes, batch axes)``,
  which is how an expert-parallel ``MoELayer`` learns that its tokens
  are this rank's rows. A parameter split on another axis (a stacked
  SPMD pipeline parameter on ``pp``) is not reduced over it;
* **loss** — the loss is one mean over the global batch: each rank's
  loss reports the tokens it averages (``distributed.parallel.
  note_loss_tokens``, else every rank counts 1), one all-reduce of
  ``[count, loss * count]`` over the batch axes gives the global count
  and mean, and each rank back-propagates its loss times its share of
  the count, so the summed gradients are the global mean's (skipped
  when the batch axes hold one rank);
* **gradients** — summed over the batch axes in buckets
  (``bucketing.plan_comm_buckets``): each bucket is one flat buffer, a
  parameter's gradient is copied into it by a post-accumulate hook as it
  lands, and the bucket's all-reduce is issued asynchronously when its
  last gradient has; the reduced flats' views are the gradients the
  clip and the update read. ``bucketed=False`` reduces each parameter
  on its own after the backward;
* **split parameters** — a tensor-parallel block (``_sharding_spec``)
  trains on its own rank. Each gradient is reduced over the batch axes
  less the axes its parameter is split on (:meth:`MeshPlan.reduce_axes`):
  an expert stack split on ``ep`` under a batch split on ``ep`` holds
  other experts on each rank, and is not reduced over ``ep``; buckets
  are planned per reduction group. The global-norm clip sums each
  parameter's squares over the axes it is split on
  (:meth:`MeshPlan.reduce_sq`);
* **ZeRO** — read from the optimizer as the reference reads it
  (:603-605; ``distributed.sharding``): at ``os`` and ``os_g`` a
  parameter whose dim 0 divides by the ``sharding`` axis is updated on
  this rank's rows only (``Optimizer._apply_to``: the state holds those
  rows) and the rows are all-gathered back, its gradient all-reduced
  (``os``) or reduce-scattered (``os_g``); at ``p_g_os`` the parameter
  is its rows, gathered whole for the forward and backward
  (:class:`_GatherRows`, whose backward reduce-scatters the gradient)
  and updated as a shard. ZeRO runs the per-parameter update, as the
  reference's fused layout stands aside for it.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.distributed.collective import P
from paddle_tpu_torch.distributed.mesh import (axis_size, local_block,
                                               spec_axes)
from paddle_tpu_torch.distributed.parallel import DataParallel
from paddle_tpu_torch.distributed.sharding import _shardable

from .bucketing import (DEFAULT_BUCKET_MB, bucketed_eligibility,
                        comm_bucket_bytes, plan_comm_buckets)
from .fused_update import shard_axes

__all__ = ["MeshPlan"]


def _map_leaves(fn, x):
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_map_leaves(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: _map_leaves(fn, v) for k, v in x.items()}
    return x


@dataclass
class _CommBucket:
    """One bucket's flat gradient buffer (kept across steps), each
    member's ``(offset, size)`` in it, the members whose gradient landed
    this step, and its issued all-reduce."""
    names: Tuple[str, ...]
    flat: torch.Tensor
    slots: Dict[str, Tuple[int, int]]
    group: object = None
    landed: set = field(default_factory=set)
    task: Optional[object] = None

    def view(self, name, shape):
        off, size = self.slots[name]
        return self.flat[off:off + size].view(shape)


class _GatherRows(torch.autograd.Function):
    """ZeRO stage 3: a parameter's rows gathered whole over the sharding
    axis; the backward keeps this rank's rows of the gradient, summed
    over the batch axes."""

    @staticmethod
    def forward(ctx, rows, plan):
        ctx.plan = plan
        return C.all_gather(rows.detach(), group=plan.zero_group, axis=0)

    @staticmethod
    def backward(ctx, g):
        return ctx.plan.rows_of_grad(g.contiguous()), None


class MeshPlan:
    """What one ``TrainStep`` over a mesh needs: the batch split, the
    gradient buckets and hooks, the split parameters and the ZeRO
    level."""

    def __init__(self, model, opt, mesh, input_spec, bucketed, params):
        if input_spec is None and isinstance(model, DataParallel):
            input_spec = model.batch_spec
        names = tuple(mesh.mesh_dim_names)
        if input_spec is None and "dp" in names:
            input_spec = P("dp")
        self.mesh = mesh
        self.input_spec = None if input_spec is None else P(*input_spec)
        self.batch_axes = spec_axes(self.input_spec, mesh) \
            if self.input_spec else ()
        self.row_axes = spec_axes(P(self.input_spec[0]), mesh) \
            if self.input_spec else ()
        self.batch_group = C.Group(self.batch_axes, mesh)
        self._groups = {self.batch_axes: self.batch_group}
        self.n_batch = axis_size(mesh, self.batch_axes)
        self.bucket_mb = getattr(model, "comm_buffer_size",
                                 DEFAULT_BUCKET_MB)
        zaxis = getattr(opt, "_shard_states_axis", None)
        self.zero_level = getattr(opt, "_shard_level", None) \
            if zaxis in names and axis_size(mesh, zaxis) > 1 else None
        self.zero_axis = zaxis if self.zero_level else None
        self.zero_group = C.Group((zaxis,), mesh) if self.zero_level \
            else None
        self.n_zero = axis_size(mesh, zaxis) if self.zero_level else 1
        # ZeRO's reductions: reduce-scatter over the sharding axis when it
        # splits the batch, the rest of the batch axes all-reduced
        rest = tuple(a for a in self.batch_axes if a != self.zero_axis)
        self.rest_group = C.Group(rest, mesh) if rest else None
        self.bucketed = (bucketed is None or bool(bucketed)) and \
            bucketed_eligibility(mesh, self.batch_axes,
                                 self.zero_level) is None
        self._params = params
        self._name = {id(p): n for n, p in params.items()}
        # ZeRO stage 1/2 rows: name -> this rank's rows (a view)
        self.zero_rows: Dict[str, torch.Tensor] = {}
        if self.zero_level in ("os", "os_g"):
            for n, p in params.items():
                if getattr(p, "_sharding_spec", None) is None and \
                        _shardable(p.shape, self.n_zero):
                    self.zero_rows[n] = local_block(
                        p.detach(), P(zaxis), mesh)
        # ZeRO stage 3: (module, attribute, parameter) of the row shards
        self.stage3 = []
        if self.zero_level == "p_g_os":
            for mod in model.modules():
                for attr, p in mod._parameters.items():
                    spec = getattr(p, "_sharding_spec", None)
                    if p is not None and spec and spec[0] == zaxis and \
                            getattr(p, "_sharding_mesh", None) is mesh:
                        self.stage3.append((mod, attr, p))
        self._stage3 = {self._name[id(p)] for _, _, p in self.stage3}
        self._buckets: Optional[List[_CommBucket]] = None
        self._hooked = set()
        self._active = False
        self.comm_buckets = None  # the plan: tuples of names
        self.last_all_reduces = 0

    # -- the batch and the loss ----------------------------------------------
    def local_batch(self, args, kwargs):
        if not self.input_spec:
            return args, kwargs

        def cut(t):
            if t.dim() < len(self.input_spec):
                return t
            return local_block(t, self.input_spec, self.mesh)
        return _map_leaves(cut, args), _map_leaves(cut, kwargs)

    def weigh(self, loss, noted):
        """``(weight, global mean loss)`` of this rank's ``loss``, a mean
        over the ``noted`` token counts (none noted: every rank counts
        1); the weight (None: 1) scales the loss for the backward."""
        if self.n_batch == 1:
            return None, loss
        count = sum(torch.as_tensor(c, dtype=torch.float32,
                                    device=loss.device)
                    for c in noted) if noted else \
            torch.ones((), dtype=torch.float32, device=loss.device)
        vec = torch.stack([count, loss.detach().float() * count])
        C.all_reduce(vec, group=self.batch_group)
        return count / vec[0], (vec[1] / vec[0]).to(loss.dtype)

    # -- ZeRO stage 3 -----------------------------------------------------------
    def install_full(self):
        for mod, attr, p in self.stage3:
            mod._parameters[attr] = _GatherRows.apply(p, self)

    def restore_shards(self):
        for mod, attr, p in self.stage3:
            mod._parameters[attr] = p

    def rows_of_grad(self, g):
        """This rank's rows of a full gradient, summed over the batch
        axes."""
        if self.zero_axis in self.batch_axes:
            rows = C.reduce_scatter(g, group=self.zero_group)
        else:
            rows = local_block(g, P(self.zero_axis), self.mesh).clone()
        if self.rest_group is not None:
            C.all_reduce(rows, group=self.rest_group)
        return rows

    # -- the gradient collectives ----------------------------------------------
    def reduce_axes(self, name) -> tuple:
        """The axes ``name``'s gradient is summed over: the batch axes
        less those its parameter is split on."""
        split = shard_axes(self._params[name])
        return tuple(a for a in self.batch_axes if a not in split)

    def _group(self, axes):
        if axes not in self._groups:
            self._groups[axes] = C.Group(axes, self.mesh)
        return self._groups[axes]

    def _plan_buckets(self, train):
        by_axes: Dict[tuple, List[str]] = {}
        for n in train:
            by_axes.setdefault(self.reduce_axes(n), []).append(n)
        plans = [(axes, names) for axes, group in by_axes.items()
                 for names in plan_comm_buckets(
                     {n: self._params[n] for n in group},
                     comm_bucket_bytes(self.bucket_mb))]
        self.comm_buckets = [names for _, names in plans]
        out = []
        for axes, names in plans:
            p0 = self._params[names[0]]
            slots, off = {}, 0
            for n in names:
                slots[n] = (off, self._params[n].numel())
                off += self._params[n].numel()
            out.append(_CommBucket(names, torch.zeros(
                off, dtype=p0.dtype, device=p0.device), slots,
                self._group(axes)))
        self._buckets = out
        self._bucket_of = {n: b for b in out for n in b.names}
        for n in train:
            if n not in self._hooked:
                self._params[n].register_post_accumulate_grad_hook(
                    self._make_hook(n))
                self._hooked.add(n)

    def _make_hook(self, name):
        # the parameter holds its hooks where the cycle collector cannot
        # see them: a strong reference to the plan (which holds the
        # parameters) would keep the model and its buckets alive forever
        plan_ref = weakref.ref(self)

        def hook(p):
            self = plan_ref()
            if self is None or not self._active or \
                    name not in self._bucket_of:
                return
            b = self._bucket_of[name]
            b.view(name, (-1,)).copy_(p.grad.reshape(-1))
            p.grad = None
            b.landed.add(name)
            if len(b.landed) == len(b.names):
                self._launch(b)
        return hook

    def _launch(self, b):
        b.task = C.all_reduce(b.flat, group=b.group, sync_op=False)
        self.last_all_reduces += 1

    def begin(self, train: List[str]):
        """Before the backward: the buckets of the gradients the hooks
        collect (all but ZeRO's split ones), planned on the first step
        and when the trained set changes."""
        for n in train:
            self._params[n].grad = None
        self.last_all_reduces = 0
        reduced = [n for n in train if self._reduced_by_buckets(n)]
        if self.bucketed and reduced:
            if self._buckets is None or \
                    sorted(self._bucket_of) != sorted(reduced):
                self._plan_buckets(reduced)
            for b in self._buckets:
                b.landed.clear()
                b.task = None
            self._active = True

    def _reduced_by_buckets(self, n):
        return n not in self._stage3 and bool(self.reduce_axes(n)) and \
            not (self.zero_level == "os_g" and n in self.zero_rows)

    def finish(self, train: List[str]) -> Dict[str, torch.Tensor]:
        """After the backward: every trained parameter's gradient, summed
        over its :meth:`reduce_axes` (ZeRO's split ones: this rank's
        rows)."""
        self._active = False
        grads = {}
        if self.bucketed and self._buckets is not None:
            for b in self._buckets:
                if b.task is None:
                    # a parameter the loss did not reach: zero gradient
                    for n in set(b.names) - b.landed:
                        b.view(n, (-1,)).zero_()
                    self._launch(b)
            for b in self._buckets:
                b.task.wait()
                for n in b.names:
                    grads[n] = b.view(n, self._params[n].shape)
        for n in train:
            if n in grads:
                continue
            p = self._params[n]
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = None
            if n in self._stage3:
                grads[n] = g  # reduced in _GatherRows' backward
            elif self.zero_level == "os_g" and n in self.zero_rows:
                grads[n] = self.rows_of_grad(g)
            else:
                axes = self.reduce_axes(n)
                if axes:
                    C.all_reduce(g, group=self._group(axes))
                    self.last_all_reduces += 1
                grads[n] = g
        return grads

    # -- the clip and ZeRO's update --------------------------------------------
    def grad_axes(self, name) -> tuple:
        """The mesh axes ``name``'s gradient is split over."""
        if self.zero_level == "os_g" and name in self.zero_rows:
            return (self.zero_axis,)
        return shard_axes(self._params[name])

    def reduce_sq(self, keyed) -> torch.Tensor:
        """The global sum of squares from ``[(axes, local sum)]``: each
        axes' sum all-reduced over them; whole tensors count once."""
        by: dict = {}
        for axes, sq in keyed:
            by[axes] = sq if axes not in by else by[axes] + sq
        total = None
        for axes, sq in by.items():
            if axes:
                sq = C.all_reduce(sq.clone(), group=C.Group(axes, self.mesh))
            total = sq if total is None else total + sq
        return total

    def zero_update(self, opt, pairs, group_lrs, group_of):
        """The per-parameter update under ZeRO: split rows through
        ``_apply_to``, the rest as usual; then the rows all-gathered
        back into their parameters."""
        by_group = {}
        for p, g in pairs:
            name = self._name[id(p)]
            rows = self.zero_rows.get(name)
            if rows is not None and self.zero_level == "os":
                g = local_block(g, P(self.zero_axis), self.mesh)
            target = p if rows is None else rows
            by_group.setdefault(id(group_of[id(p)]), []).append(
                (p, target, g))
        for gi, group in enumerate(opt._param_groups):
            triples = by_group.get(id(group))
            if triples:
                opt._apply_to(group, triples, group_lrs[gi])
        with torch.no_grad():
            for name, rows in self.zero_rows.items():
                full = C.all_gather(rows.clone(), group=self.zero_group,
                                    axis=0)
                self._params[name].detach().copy_(full)

    def clip_reduce(self, params, sqs) -> torch.Tensor:
        """``ClipGradByGlobalNorm``'s ``reduce_sq`` over parameters."""
        return self.reduce_sq([(self.grad_axes(self._name[id(p)]), s)
                               for p, s in zip(params, sqs)])
