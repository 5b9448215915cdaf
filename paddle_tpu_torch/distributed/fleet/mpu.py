"""Megatron-style tensor-parallel layers — port of
``paddle_tpu/distributed/fleet/mpu.py``.

The reference annotates full weights with partition specs on the ``mp``
mesh axis and lets GSPMD insert the collectives (:1-37). Here each rank
keeps only its shard, in Paddle's ``[in, out]`` layout, and the
collectives are explicit ``torch.autograd.Function`` pairs, as in
Paddle's ``mp_ops.py``:

* ``_CopyToGroup``: identity forward, all-reduce of the gradient
  backward (``c_identity``), in front of a column-parallel matmul;
* ``_ReduceFromGroup``: all-reduce forward, identity backward
  (``mp_allreduce``), after a row-parallel matmul or a vocab-parallel
  lookup;
* ``_GatherFromGroup`` / ``_ScatterToGroup``: a dim (the last by
  default; the sequence for ``fleet.sequence_parallel``) gathered or cut
  to this rank's block, each the other's backward.

Shards (``[in, out]`` weights):

  ColumnParallelLinear   W ``[in, out/mp]``, bias ``[out/mp]``
  RowParallelLinear      W ``[in/mp, out]``, bias whole (added after the
                         reduction)
  VocabParallelEmbedding W ``[V/mp, d]``: a masked lookup, then a sum
  ParallelCrossEntropy   logits ``[..., V/mp]``: the softmax cross
                         entropy with the row max, the sum of
                         exponentials and the target logit all-reduced

A layer draws its full weight from its initializer (so every rank draws
the same numbers) and keeps its block, and records the block's partition
spec in the parameter's ``_sharding_spec`` (``P(None, "mp")``, ...) and
its mesh in ``_sharding_mesh``: the bridge (``utils.bridge``) cuts full
arrays and gathers them back by it, and ``TrainStep`` sums the squared
gradient norm of a block over its axis. With one rank on ``mp`` the
layers are their plain counterparts and issue no collective. Without a
model-parallel axis on the mesh they raise, as the reference's
(:40-46).
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.dtype import convert_dtype
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layer_base import Layer
from paddle_tpu_torch.param_attr import ParamAttr, create_parameter

from .. import collective as C
from ..collective import P
from ..mesh import axis_index, axis_size, get_mesh, local_block

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy",
           "copy_to_group", "reduce_from_group", "vocab_parallel_ce"]


def _mp_axis(mesh):
    if mesh is None:
        raise RuntimeError("the tensor-parallel layers need a mesh: call "
                           "init_parallel_env / fleet.init first")
    for cand in ("mp", "model", "tp"):
        if cand in mesh.mesh_dim_names:
            return cand
    raise ValueError(
        f"mesh {mesh.mesh_dim_names} has no model-parallel axis "
        "('mp'/'model'/'tp')")


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return C.all_reduce(g.contiguous().clone(), group=ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return C.all_reduce(x.contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim=-1):
        ctx.group, ctx.dim = group, dim
        return C.all_gather(x.contiguous(), group=group, axis=dim)

    @staticmethod
    def backward(ctx, g):
        n = ctx.group.nranks
        return g.chunk(n, dim=ctx.dim)[ctx.group.rank].contiguous(), None, \
            None


class _ScatterToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim=-1):
        ctx.group, ctx.dim = group, dim
        return x.chunk(group.nranks, dim=dim)[group.rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        return C.all_gather(g.contiguous(), group=ctx.group,
                            axis=ctx.dim), None, None


def copy_to_group(x, group):
    """Identity forward; the gradient all-reduced over ``group``."""
    return _CopyToGroup.apply(x, group) if group.nranks > 1 else x


def reduce_from_group(x, group):
    """All-reduce over ``group`` forward; identity backward."""
    return _ReduceFromGroup.apply(x, group) if group.nranks > 1 else x


class _MPLayer(Layer):
    """The mesh, axis, group and device handling the layers share."""

    def _setup(self, mesh, device, dtype):
        self._mesh = mesh or get_mesh()
        self._axis = _mp_axis(self._mesh)
        self._group = C.Group((self._axis,), self._mesh)
        self.is_mp = axis_size(self._mesh, self._axis) > 1
        self._kw = dict(device=resolve_device(device),
                        dtype=convert_dtype(dtype))

    def _sharded(self, shape, spec, attr=None, is_bias=False,
                 default_initializer=None):
        """A parameter holding this rank's block of a full ``shape``
        drawn from the initializer."""
        full = create_parameter(shape, attr=attr, is_bias=is_bias,
                                default_initializer=default_initializer,
                                **self._kw)
        if not self.is_mp:
            p = full
        else:
            # a copy: a block of dim 0 is a contiguous view, which would
            # keep the full tensor's storage alive
            p = type(full)(local_block(full.detach(), spec, self._mesh)
                           .clone(memory_format=torch.contiguous_format),
                           full.requires_grad)
        p._sharding_spec = spec
        p._sharding_mesh = self._mesh
        return p


class ColumnParallelLinear(_MPLayer):
    """Output-feature-split linear (reference :48-86)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, mesh=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._setup(mesh, device, dtype)
        self._in_features = in_features
        self._out_features = out_features
        self.gather_output = gather_output
        if ParamAttr._to_attr(weight_attr) is False:
            raise ValueError("weight_attr=False: the weight is mandatory")
        if out_features % axis_size(self._mesh, self._axis):
            raise ValueError(f"out_features {out_features} does not divide "
                             f"by the model-parallel degree")
        self.weight = self._sharded([in_features, out_features],
                                    P(None, self._axis), weight_attr)
        # reference (:70-75): the default None is falsy, no bias
        self.bias = self._sharded([out_features], P(self._axis),
                                  is_bias=True) if has_bias else None

    def forward(self, x):
        if self.is_mp:
            x = copy_to_group(x, self._group)
        out = F.linear(x, self.weight, self.bias)
        if self.is_mp and self.gather_output:
            out = _GatherFromGroup.apply(out, self._group)
        return out


class RowParallelLinear(_MPLayer):
    """Input-feature-split linear (reference :89-126): partial products
    summed over ``mp``, then the whole bias."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 mesh=None, *, device=None, dtype=torch.float32):
        super().__init__()
        self._setup(mesh, device, dtype)
        self._in_features = in_features
        self._out_features = out_features
        self.input_is_parallel = input_is_parallel
        if ParamAttr._to_attr(weight_attr) is False:
            raise ValueError("weight_attr=False: the weight is mandatory")
        if in_features % axis_size(self._mesh, self._axis):
            raise ValueError(f"in_features {in_features} does not divide "
                             f"by the model-parallel degree")
        self.weight = self._sharded([in_features, out_features],
                                    P(self._axis, None), weight_attr)
        self.bias = None if has_bias is False else create_parameter(
            [out_features], is_bias=True, **self._kw)

    def forward(self, x):
        if self.is_mp and not self.input_is_parallel:
            x = _ScatterToGroup.apply(x, self._group)
        out = reduce_from_group(F.linear(x, self.weight, None), self._group)
        if self.bias is not None:
            out = out + self.bias
        return out


class VocabParallelEmbedding(_MPLayer):
    """Vocab-split embedding table (reference :129-151): each rank looks
    up the ids in its rows (others read 0), then the sum over ``mp``."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, mesh=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._setup(mesh, device, dtype)
        attr = ParamAttr._to_attr(weight_attr)
        if attr is False:
            raise ValueError("weight_attr=False: the embedding table is "
                             "mandatory")
        n = axis_size(self._mesh, self._axis)
        if num_embeddings % n:
            raise ValueError(f"num_embeddings {num_embeddings} does not "
                             f"divide by the model-parallel degree {n}")
        self.weight = self._sharded(
            [num_embeddings, embedding_dim], P(self._axis, None), attr,
            default_initializer=I.XavierNormal() if (
                attr is None or attr.initializer is None) else None)
        self._rows = num_embeddings // n
        self._start = axis_index(self._mesh, self._axis) * self._rows

    def forward(self, x):
        if not self.is_mp:
            return F.embedding(x, self.weight)
        ids = x.long() - self._start
        outside = (ids < 0) | (ids >= self._rows)
        out = F.embedding(torch.where(outside, 0, ids), self.weight)
        out = torch.where(outside[..., None], 0, out)
        return reduce_from_group(out, self._group)


class _VocabParallelCE(torch.autograd.Function):
    """Softmax cross entropy over logits split on the vocab: the row
    max, the sum of exponentials and the target logit are all-reduced;
    the gradient of each block is its softmax minus its part of the
    one-hot label."""

    @staticmethod
    def forward(ctx, logits, labels, group, start, ignore_index):
        lf = logits.float()
        m = lf.amax(dim=-1)
        C.all_reduce(m, C.ReduceOp.MAX, group=group)
        e = torch.exp(lf - m[..., None])
        s = e.sum(dim=-1)
        C.all_reduce(s, group=group)
        local = labels.long() - start
        inside = (local >= 0) & (local < lf.shape[-1])
        idx = torch.where(inside, local, 0)
        tgt = torch.where(inside, lf.gather(-1, idx[..., None])[..., 0], 0.0)
        C.all_reduce(tgt, group=group)
        valid = labels != ignore_index
        loss = torch.where(valid, torch.log(s) + m - tgt, 0.0)
        ctx.save_for_backward(e, s, idx, inside, valid)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        e, s, idx, inside, valid = ctx.saved_tensors
        grad = e / s[..., None]
        grad.scatter_add_(-1, idx[..., None],
                          -inside.to(grad.dtype)[..., None])
        grad = grad * (g.float() * valid)[..., None]
        return grad.to(ctx.dtype), None, None, None, None


def vocab_parallel_ce(logits, labels, group, start: int,
                      ignore_index: int = -100):
    """Per-token cross entropy of vocab-split ``logits`` (this rank's
    columns ``start .. start + V/mp``) against global ``labels``; 0 where
    the label is ``ignore_index``."""
    if group.nranks == 1:
        return F.cross_entropy(logits, labels, ignore_index=ignore_index,
                               reduction="none")
    return _VocabParallelCE.apply(logits, labels, group, start,
                                  ignore_index)


class ParallelCrossEntropy(_MPLayer):
    """Vocab-parallel softmax cross entropy (reference :154-172): the
    input is this rank's logits block ``[..., V/mp]`` (a
    ``ColumnParallelLinear(gather_output=False)``'s output), the labels
    global; the loss ``[..., 1]``, 0 at ``ignore_index``."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100,
                 mesh=None):
        super().__init__()
        self._mesh = mesh or get_mesh()
        self._axis = _mp_axis(self._mesh)
        self._group = C.Group((self._axis,), self._mesh)
        self._ignore_index = ignore_index

    def forward(self, input, label):
        if label.dim() == input.dim():
            label = label[..., 0]
        start = axis_index(self._mesh, self._axis) * input.shape[-1]
        loss = vocab_parallel_ce(input, label, self._group, start,
                                 self._ignore_index)
        return loss.unsqueeze(-1)
