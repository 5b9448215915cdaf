"""Shape and layout ops — port of ``paddle_tpu/ops/manipulation.py``.

Paddle's forms: ``transpose(perm)``, ``reshape`` with 0 copying the
input's dim, ``split(num_or_sections)`` with one -1, ``concat(axis)``,
``gather``/``scatter`` over rows, ``expand`` with -1 keeping a dim, and
the pad convention of ``F.pad``. Index results are int64.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from paddle_tpu_torch.core.dtype import convert_dtype
from ._common import LONG, as_t, pair
from ._registry import op

__all__ = [
    "cast", "assign", "reshape", "transpose", "moveaxis", "swapaxes",
    "concat", "stack", "split", "chunk", "unbind", "squeeze", "unsqueeze",
    "flatten", "tile", "expand", "broadcast_to", "expand_as",
    "broadcast_tensors", "flip", "roll", "rot90", "gather", "gather_nd",
    "take_along_axis", "put_along_axis", "scatter", "scatter_nd_add",
    "scatter_nd", "index_select", "index_sample", "index_add",
    "masked_select", "masked_fill", "where", "nonzero", "tril", "triu", "pad",
    "repeat_interleave", "sort", "argsort", "searchsorted", "bucketize",
    "one_hot", "unique", "unique_consecutive", "slice", "strided_slice",
    "crop", "diagonal", "diff", "as_real", "as_complex", "numel",
    "shard_index",
]


def _int(v):
    if isinstance(v, torch.SymInt):
        return v  # a dim under torch.export stays symbolic
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def _ints(v):
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, torch.Tensor):
        return [int(s) for s in v.reshape(-1).tolist()]
    return [_int(x) for x in v]


def _list(v):
    return [v] if isinstance(v, (int, np.integer)) else list(v)


@op
def cast(x, dtype):
    return x.to(convert_dtype(dtype))


@op
def assign(x):
    return as_t(x).clone()


@op
def reshape(x, shape):
    dims = _list(_ints(shape))
    # Paddle: a 0 entry copies the input's dim at that index
    dims = [x.shape[i] if s == 0 else s for i, s in enumerate(dims)]
    return torch.reshape(x, dims)


@op
def transpose(x, perm):
    return x.permute(*_ints(perm))


@op(name="t")
def t_(x):
    return x.permute(*range(x.ndim - 1, -1, -1))


@op
def moveaxis(x, source, destination):
    return torch.movedim(x, source, destination)


@op
def swapaxes(x, axis1, axis2):
    return torch.swapaxes(x, _int(axis1), _int(axis2))


@op
def concat(xs, axis=0):
    return torch.cat(list(xs), dim=_int(axis))


@op
def stack(xs, axis=0):
    return torch.stack(list(xs), dim=_int(axis))


@op
def split(x, num_or_sections, axis=0):
    axis = _int(axis)
    total = x.shape[axis]
    if isinstance(num_or_sections, (int, np.integer)):
        n = int(num_or_sections)
        if total % n:
            raise ValueError(f"split: dim {total} does not divide into {n}")
        return tuple(torch.split(x, total // n, dim=axis))
    secs = _ints(num_or_sections)
    known = builtins.sum(s for s in secs if s >= 0)
    sizes = [s if s >= 0 else total - known for s in secs]
    return tuple(torch.split(x, sizes, dim=axis))


@op
def chunk(x, chunks, axis=0):
    return tuple(torch.tensor_split(x, int(chunks), dim=_int(axis)))


@op
def unbind(x, axis=0):
    return tuple(torch.unbind(x, dim=_int(axis)))


@op
def squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    ax = tuple(a for a in _list(_ints(axis)) if x.shape[a] == 1)
    return torch.squeeze(x, ax) if ax else x


@op
def unsqueeze(x, axis):
    for a in sorted(_list(_ints(axis))):
        x = torch.unsqueeze(x, a)
    return x


@op
def flatten(x, start_axis=0, stop_axis=-1):
    if x.ndim == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


@op
def tile(x, repeat_times):
    return torch.tile(x, tuple(_list(_ints(repeat_times))))


@op
def expand(x, shape):
    return x.expand(*_list(_ints(shape)))


@op
def broadcast_to(x, shape):
    return torch.broadcast_to(x, tuple(_list(_ints(shape))))


@op
def expand_as(x, y):
    return x.expand_as(y)


@op
def broadcast_tensors(xs):
    return tuple(torch.broadcast_tensors(*xs))


@op
def flip(x, axis):
    return torch.flip(x, _list(_ints(axis)))


@op
def roll(x, shifts, axis=None):
    shifts = _ints(shifts)
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, _ints(axis))


@op
def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, int(k), list(axes))


@op
def gather(x, index, axis=0):
    # Paddle's gather takes an index of shape [N] or [N, 1]
    axis = _int(axis)
    if index.ndim == 2 and index.shape[1] == 1:
        index = index.reshape(-1)
    out = torch.index_select(x, axis, index.reshape(-1).long())
    return out.reshape(tuple(x.shape[:axis]) + tuple(index.shape)
                       + tuple(x.shape[axis + 1:]))


@op
def gather_nd(x, index):
    return x[tuple(index.long().unbind(-1))]


@op
def take_along_axis(x, indices, axis, broadcast=True):
    axis = _int(axis)
    if broadcast:
        shape = list(x.shape)
        shape[axis] = indices.shape[axis]
        indices = indices.expand(shape)
    return torch.gather(x, axis, indices.long())


@op
def put_along_axis(x, indices, values, axis, reduce="assign"):
    axis = _int(axis)
    values = as_t(values, x).to(x.dtype).expand(indices.shape)
    idx = indices.long()
    if reduce == "assign":
        return x.scatter(axis, idx, values)
    if reduce in ("add", "sum"):
        return x.scatter_add(axis, idx, values)
    if reduce in ("mul", "multiply"):
        return x.scatter_reduce(axis, idx, values, "prod")
    raise ValueError(f"unsupported reduce {reduce!r}")


@op
def scatter(x, index, updates, overwrite=True):
    return x.index_put((index.reshape(-1).long(),), updates.to(x.dtype),
                       accumulate=not overwrite)


@op
def scatter_nd_add(x, index, updates):
    return x.index_put(tuple(index.long().unbind(-1)), updates.to(x.dtype),
                       accumulate=True)


@op
def scatter_nd(index, updates, shape):
    zeros = torch.zeros(_list(_ints(shape)), dtype=updates.dtype,
                        device=updates.device)
    return zeros.index_put(tuple(index.long().unbind(-1)), updates,
                           accumulate=True)


@op
def index_select(x, index, axis=0):
    return torch.index_select(x, _int(axis), index.long())


@op
def index_sample(x, index):
    return torch.gather(x, 1, index.long())


@op
def index_add(x, index, axis, value):
    return torch.index_add(x, _int(axis), index.long(), value.to(x.dtype))


@op
def masked_select(x, mask):
    return torch.masked_select(x, mask.bool())


@op
def masked_fill(x, mask, value):
    return torch.where(mask.bool(), as_t(value, x).to(x.dtype), x)


@op
def where(condition, x=None, y=None):
    if x is None and y is None:
        return torch.nonzero(condition)
    x, y = pair(x, y)
    return torch.where(condition.bool(), x, y)


@op
def nonzero(x, as_tuple=False):
    if as_tuple:
        return tuple(torch.nonzero(x, as_tuple=True))
    return torch.nonzero(x)


@op
def tril(x, diagonal=0):
    return torch.tril(x, _int(diagonal))


@op
def triu(x, diagonal=0):
    return torch.triu(x, _int(diagonal))


def _pad_index(n, lo, hi, mode, device):
    """The source index of each output position along a padded dim."""
    pos = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return pos.clamp(0, n - 1)
    if mode == "circular":
        return pos % n
    period = 2 * (n - 1)  # reflect: mirror without repeating the edge
    p = pos.abs() % period
    return torch.where(p >= n, period - p, p)


@op
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):
    pad = _list(_ints(pad))
    nd = x.ndim
    if len(pad) == 2 * nd:
        cfg = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        # F.pad's convention: the first pair pads the last spatial dim,
        # walking backwards; channel-last formats skip the last dim
        cfg = [(0, 0)] * nd
        npairs = len(pad) // 2
        last = nd - 2 if data_format.endswith("C") else nd - 1
        for i, d in enumerate(range(last, last - npairs, -1)):
            cfg[d] = (pad[2 * i], pad[2 * i + 1])
    if mode not in ("constant", "reflect", "replicate", "circular"):
        raise ValueError(f"unsupported pad mode {mode!r}")
    if mode == "constant":
        flat = []
        for lo, hi in reversed(cfg):
            flat += [lo, hi]
        return torch.nn.functional.pad(x, flat, value=value)
    for d, (lo, hi) in enumerate(cfg):
        if lo or hi:
            x = torch.index_select(
                x, d, _pad_index(x.shape[d], lo, hi, mode, x.device))
    return x


@op
def repeat_interleave(x, repeats, axis=None):
    if isinstance(repeats, torch.Tensor):
        repeats = repeats.long()
    return torch.repeat_interleave(x, repeats, dim=axis)


@op
def sort(x, axis=-1, descending=False):
    out = torch.sort(x, dim=_int(axis), stable=True).values
    return torch.flip(out, [_int(axis)]) if descending else out


@op
def argsort(x, axis=-1, descending=False):
    out = torch.argsort(x, dim=_int(axis), stable=True)
    return (torch.flip(out, [_int(axis)]) if descending else out).to(LONG)


@op
def searchsorted(sorted_sequence, values, out_int32=False, right=False):
    return torch.searchsorted(sorted_sequence, as_t(values, sorted_sequence),
                              right=right, out_int32=out_int32)


@op
def bucketize(x, sorted_sequence, out_int32=False, right=False):
    return torch.searchsorted(sorted_sequence, x, right=right,
                              out_int32=out_int32)


@op
def one_hot(x, num_classes):
    from paddle_tpu_torch.core.dtype import default_float
    return torch.nn.functional.one_hot(x.long(), int(num_classes)).to(
        default_float())


@op
def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None):
    vals, inv, counts = torch.unique(x, sorted=True, return_inverse=True,
                                     return_counts=True, dim=axis)
    out = [vals]
    if return_index:
        # the first position of each unique value (or slice along axis)
        inv_flat = inv.reshape(-1)
        pos = torch.arange(inv_flat.numel(), device=x.device)
        first = torch.full((vals.shape[0] if axis is not None
                            else vals.numel(),), inv_flat.numel(),
                           dtype=LONG, device=x.device)
        out.append(first.scatter_reduce(0, inv_flat, pos, "amin"))
    if return_inverse:
        out.append(inv.to(LONG))
    if return_counts:
        out.append(counts.to(LONG))
    return tuple(out) if len(out) > 1 else vals


@op
def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None):
    vals, inv, counts = torch.unique_consecutive(
        x, return_inverse=True, return_counts=True, dim=axis)
    out = [vals]
    if return_inverse:
        out.append(inv.to(LONG))
    if return_counts:
        out.append(counts.to(LONG))
    return tuple(out) if len(out) > 1 else vals


@op
def slice(x, axes, starts, ends):
    idx = [builtins.slice(None)] * x.ndim
    for ax, st, en in zip(_list(_ints(axes)), _list(_ints(starts)),
                          _list(_ints(ends))):
        idx[ax] = builtins.slice(st, en)
    return x[tuple(idx)]


@op
def strided_slice(x, axes, starts, ends, strides):
    for ax, st, en, sr in zip(_list(_ints(axes)), _list(_ints(starts)),
                              _list(_ints(ends)), _list(_ints(strides))):
        pos = list(range(*builtins.slice(st, en, sr).indices(x.shape[ax])))
        x = torch.index_select(x, ax, torch.tensor(pos, dtype=LONG,
                                                   device=x.device))
    return x


@op
def crop(x, shape, offsets):
    for d, (s, o) in enumerate(zip(_list(_ints(shape)),
                                   _list(_ints(offsets)))):
        o = builtins.min(builtins.max(o, 0), x.shape[d] - s)  # as XLA clamps
        x = x.narrow(d, o, s)
    return x


@op
def diagonal(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, int(offset), _int(axis1), _int(axis2))


@op
def diff(x, n=1, axis=-1):
    return torch.diff(x, n=int(n), dim=_int(axis))


@op
def as_real(x):
    return torch.stack([torch.real(x), torch.imag(x)], dim=-1)


@op
def as_complex(x):
    if x.dtype in (torch.float16, torch.bfloat16):
        # as the reference's lax.complex refuses them
        raise TypeError(f"as_complex takes float32 or float64 pairs, not "
                        f"{x.dtype}")
    return torch.complex(x[..., 0], x[..., 1])


@op
def numel(x):
    return torch.tensor(x.numel(), dtype=LONG, device=x.device)


@op
def shard_index(x, index_num, nshards, shard_id, ignore_value=-1):
    size = index_num // nshards
    lo, hi = shard_id * size, (shard_id + 1) * size
    inside = (x >= lo) & (x < hi)
    return torch.where(inside, x - lo, torch.full_like(x, ignore_value))
