"""Fused multi-tensor optimizer update — port of
``paddle_tpu/jit/fused_update.py``.

A per-parameter optimizer loop launches some twenty small kernels a
parameter, and each reads and writes the whole state again: ~158 bytes a
parameter for AdamW with f32 masters and a global-norm clip. The
reference plans flat buckets on the host and lets XLA fuse each bucket's
update into one pass; eager PyTorch fuses nothing, so here the bucket is
one hand-written pass.

:func:`build_layout` groups the trainable parameters into buckets by
everything the update needs to be uniform (the reference's key,
:169-171): parameter group, dtype, master-ness, the host-resolved
``lr_ratio`` and decoupled decay coefficient, the scalar state values
(``beta1_pow``, ...) and the rule's keyword arguments. Parameters that
cannot fuse (a rule that is not elementwise, such as Lamb; state of
another shape; unhashable keyword arguments; a decay that is not L1 or
L2) stay in the residue, which keeps the per-parameter loop.

:func:`build_flat_states` gives each bucket one flat buffer per vector
state (``moment1``, ``moment2``, ``master_weight``, ...) and one vector
per scalar state, one element a parameter, and leaves every parameter's
entries in ``optimizer._state`` as **views** of them. So the optimizer's
``state_dict`` reads current values with no flush, an eager ``step``
updates the flats in place, and the state is never held twice. A
``set_state_dict`` installs new tensors, which ``TrainStep`` notices by
identity and builds the flats again from.

The clip and the update of the fused buckets are :func:`fused_clip` and
:func:`fused_update` (:func:`fused_clip_and_update` runs both, as the
reference's function of that name). The kernels, in
``ops/pallas/csrc/fused_update.cu`` (no Pallas counterpart: they stand
in for XLA's fusion of the reference's :250-345):

* :func:`fused_sqnorm`: a bucket's sum of squared gradients in f32,
  reading each gradient element once, as a two-level reduction with no
  float atomics (the same bits on every run); the global norm is the
  square root of the sum over buckets and residue, as the reference's;
* :func:`fused_adam_update`: one elementwise pass over an Adam/AdamW
  bucket that folds in the clip scale (read from device memory), the
  f32 cast for a master, an L1/L2 decay or the decoupled ``1 - lr *
  coeff``, ``lr_ratio``, and updates m, v and the master or the
  parameter, writing the parameter.

Dispatch is explicit. On CUDA tensors an Adam/AdamW bucket always takes
the kernel and the global-norm clip always takes ``fused_sqnorm``; a
build or launch failure raises. The other elementwise rules (SGD,
Momentum, Adagrad, RMSProp, Adadelta, Adamax) have no kernel yet and run
:func:`bucket_update_plain` on the card. CPU tensors take the plain
versions, :func:`bucket_update_plain` and :func:`sqnorm_plain`: torch
ops over concatenated buffers in the reference's order, which the
kernels match bit for bit (the norm within its summation order).

Numerics: the fused update applies the per-parameter loop's elementwise
operations to every element, so it is bit-exact in f32 — except under
``ClipGradByGlobalNorm``, whose norm sums in another order (~1 ulp on
the scale), as in the reference (:33-37).

Disable with ``PADDLE_TPU_FUSED_OPTIMIZER=0`` or ``TrainStep(fused=False)``.
"""
from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer.adam import Adam
from paddle_tpu_torch.ops.pallas import counters
from paddle_tpu_torch.optimizer.optimizer import decay_factor
from paddle_tpu_torch.regularizer import L1Decay, L2Decay

__all__ = ["FlatLayout", "Bucket", "build_layout", "build_flat_states",
           "split_flat_states", "fused_clip", "fused_update",
           "fused_clip_and_update", "fused_enabled", "fused_sqnorm",
           "fused_adam_update", "sqnorm_plain", "bucket_update_plain"]

#: kernel launches since each count was last set to 0 (CPU calls, which
#: compute the plain versions, do not count)
launches_adam = 0
launches_sqnorm = 0
counters.register(__name__, "launches_adam", "launches_sqnorm")

# elements of one tensor that one block of the kernels takes
_CHUNK = 8192
# blocks of fused_sqnorm's first level (its partial sums)
_SQNORM_BLOCKS = 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def fused_enabled() -> bool:
    """Process default for the fused path (``TrainStep(fused=...)`` wins)."""
    return os.environ.get("PADDLE_TPU_FUSED_OPTIMIZER", "1") != "0"


@dataclass
class Bucket:
    """One fused-update group: every field that feeds the update rule is
    uniform across ``names`` (enforced by the bucket key)."""
    names: Tuple[str, ...]
    shapes: Tuple[tuple, ...]
    sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]
    group_index: int
    master: bool
    lr_ratio: Optional[float]       # None -> no per-param scaling
    decay_coeff: float              # decoupled (AdamW) coefficient
    decay: object                   # L1/L2 regularizer to fold, or None
    kwargs: dict                    # _update_delta keyword args
    vector_keys: Tuple[str, ...]    # state entries with the param's shape
    scalar_keys: Tuple[str, ...]    # 0-d state entries, equal bucket-wide
    # mesh axes each member is split over (tensor parallelism, ZeRO):
    # the clip sums a bucket's squares over them
    shard_axes: Tuple[str, ...] = ()
    # the kernels' device tables, built at their first launch
    table: object = field(default=None, repr=False, compare=False)


@dataclass
class FlatLayout:
    """Host-side plan: fusable buckets + the residue that keeps the
    per-param loop."""
    buckets: List[Bucket] = field(default_factory=list)
    residue: List[str] = field(default_factory=list)

    @property
    def fused_names(self) -> List[str]:
        return [n for b in self.buckets for n in b.names]


def build_layout(opt, params: Dict[str, torch.Tensor],
                 train_names: Sequence[str]) -> Optional[FlatLayout]:
    """Plan the fused update for ``train_names`` (``params``' keys, in
    order). Returns None when the optimizer's rule is not elementwise.
    Reads each scalar state value on the host (once per plan)."""
    if not getattr(opt, "_fusable_update", False):
        return None
    group_index = {id(p): gi for gi, g in enumerate(opt._param_groups)
                   for p in g["params"]}
    layout = FlatLayout()
    groups: Dict[tuple, list] = {}
    for name in train_names:
        p = params[name]
        gi = group_index.get(id(p))
        if gi is None:
            layout.residue.append(name)
            continue
        group = opt._param_groups[gi]
        decay = group.get("weight_decay", opt.regularization)
        if opt._decoupled_decay:
            dcoeff, fold_decay = float(opt._decay_coeff_for(p, decay)), None
        else:
            dcoeff, fold_decay = 0.0, decay
            if decay is not None and not isinstance(decay,
                                                    (L1Decay, L2Decay)):
                layout.residue.append(name)
                continue
        ratio = float(opt._param_lr(p, 1.0))
        lr_ratio = None if ratio == 1.0 else ratio
        # a parameter with no state yet is planned from fresh state that
        # is not kept: build_flat_states makes it one parameter at a time
        st = opt._state.get(id(p)) or opt._new_state(p)
        vector_keys, scalar_keys, scalar_vals = [], [], []
        fusable = True
        for k, v in st.items():
            if k == "master_weight":
                continue
            if v.shape == p.shape:
                vector_keys.append(k)
            elif v.dim() == 0:
                scalar_keys.append(k)
                scalar_vals.append((k, float(v)))
            else:
                fusable = False  # exotic state shape: keep per-param
                break
        if not fusable:
            layout.residue.append(name)
            continue
        try:
            kw = opt._param_group_kwargs(p, group)
            kw_key = tuple(sorted(kw.items()))
            hash(kw_key)
        except TypeError:
            layout.residue.append(name)
            continue
        key = (gi, str(p.dtype), "master_weight" in st, lr_ratio, dcoeff,
               tuple(scalar_vals), kw_key, shard_axes(p))
        groups.setdefault(key, []).append(
            (name, tuple(p.shape), kw, fold_decay, tuple(vector_keys),
             tuple(scalar_keys)))

    for (gi, _dt, master, lr_ratio, dcoeff, _sv, _kw, axes), members \
            in groups.items():
        sizes = [int(np.prod(shape)) for _, shape, *_ in members]
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).tolist()
        first = members[0]
        layout.buckets.append(Bucket(
            names=tuple(m[0] for m in members),
            shapes=tuple(m[1] for m in members), sizes=tuple(sizes),
            offsets=tuple(int(o) for o in offsets), group_index=gi,
            master=master, lr_ratio=lr_ratio, decay_coeff=dcoeff,
            decay=first[3], kwargs=first[2], vector_keys=first[4],
            scalar_keys=first[5], shard_axes=axes))
    return layout


def shard_axes(p) -> Tuple[str, ...]:
    """The mesh axes ``p`` is split over (its ``_sharding_spec``'s, set
    by the tensor-parallel layers and ZeRO stage 3), in the mesh's
    order; () for a whole parameter."""
    spec = getattr(p, "_sharding_spec", None)
    if not spec:
        return ()
    from paddle_tpu_torch.distributed.mesh import spec_axes
    return spec_axes(spec, getattr(p, "_sharding_mesh", None))


def _flat(tensors):
    """One 1-D buffer of ``tensors`` (a view when there is one)."""
    if len(tensors) == 1:
        return tensors[0].reshape(-1)
    return torch.cat([t.reshape(-1) for t in tensors])


def split_flat_states(layout: FlatLayout, flats) -> list:
    """Per-bucket lists of per-parameter state dicts, each entry a view of
    the bucket's flat buffers (a 0-d view of its scalar vectors)."""
    out = []
    for b, f in zip(layout.buckets, flats):
        per = []
        for i, (off, size, shape) in enumerate(zip(b.offsets, b.sizes,
                                                   b.shapes)):
            st = {k: f[k][i] for k in b.scalar_keys}
            for k in b.vector_keys + (("master_weight",) if b.master
                                      else ()):
                st[k] = f[k][off:off + size].view(shape)
            per.append(st)
        out.append(per)
    return out


@torch.no_grad()
def build_flat_states(opt, layout: FlatLayout, params) -> list:
    """Concatenate each bucket's per-parameter accumulators into flat
    buffers and install views of them (:func:`split_flat_states`) in
    their place, one parameter at a time, so the state is never held
    twice. Returns one ``{state key: flat tensor}`` per bucket."""
    flats = []
    for b in layout.buckets:
        ps = [params[n] for n in b.names]
        first = opt._ensure_state(ps[0])
        f = {k: torch.empty(sum(b.sizes), dtype=first[k].dtype,
                            device=ps[0].device)
             for k in b.vector_keys + (("master_weight",) if b.master
                                       else ())}
        f.update({k: torch.empty(len(ps), dtype=first[k].dtype,
                                 device=ps[0].device)
                  for k in b.scalar_keys})
        for p, views in zip(ps, split_flat_states(
                FlatLayout(buckets=[b]), [f])[0]):
            st = opt._ensure_state(p)
            for k, view in views.items():
                view.copy_(st[k])
            st.update(views)
        flats.append(f)
    return flats


# -- the plain versions -------------------------------------------------------
def sqnorm_plain(grads) -> torch.Tensor:
    """The sum of the squares of ``grads`` in f32 (the reference's
    per-bucket reduction, :320-324)."""
    return torch.sum(torch.square(_flat(grads).float()))


@torch.no_grad()
def bucket_update_plain(opt, b: Bucket, params, grads, flat, lr,
                        scale=None):
    """One bucket's update in torch ops over concatenated buffers, in
    place: the reference's ``fused_clip_and_update`` body for one bucket.
    ``lr`` is the bucket's effective lr (an f32 value), ``scale`` the
    global-norm clip's factor (a 0-d f32 tensor) or None."""
    flat_g = _flat(grads)
    if scale is not None:
        flat_g = flat_g * scale.to(flat_g.dtype)
    if b.master:
        flat_g = flat_g.float()
    if b.decay is not None:  # non-decoupled: fold into the gradient
        psrc = flat["master_weight"] if b.master else \
            _flat([p.detach() for p in params])
        flat_g = b.decay(psrc, flat_g)
    state = {k: flat[k] for k in b.vector_keys}
    # the bucket's scalar state advances once, from the first element
    state.update({k: flat[k][0] for k in b.scalar_keys})
    target = flat["master_weight"] if b.master else None
    delta = opt._update_delta(
        flat_g.to(torch.float32 if b.master else params[0].dtype), state,
        lr, **b.kwargs)
    for k in b.scalar_keys:
        flat[k][1:].fill_(flat[k][0])
    factor = decay_factor(lr, b.decay_coeff) if b.decay_coeff else None
    if target is not None:
        if factor is not None:
            target.mul_(factor)
        target.sub_(delta)
        for p, off, size in zip(params, b.offsets, b.sizes):
            p.copy_(target[off:off + size].view(p.shape))
    else:
        for p, off, size in zip(params, b.offsets, b.sizes):
            if factor is not None:
                p.mul_(factor)
            p.sub_(delta[off:off + size].view(p.shape).to(p.dtype))


# -- the kernels --------------------------------------------------------------
class _Table:
    """A bucket's tables on the card: per tensor its flat offset, size
    and first chunk (built once), and the parameter and gradient
    pointers (uploaded only when they change)."""

    def __init__(self, sizes, offsets, device):
        chunks = np.cumsum([0] + [-(-s // _CHUNK) for s in sizes])
        self.n = len(sizes)
        self.n_chunks = int(chunks[-1])
        self.meta = torch.tensor(
            list(offsets) + list(sizes) + chunks.tolist(),
            dtype=torch.int64).to(device)
        self._ptrs: dict = {}

    def pointers(self, what, tensors) -> torch.Tensor:
        host = tuple(t.data_ptr() for t in tensors)
        cached = self._ptrs.get(what)
        if cached is None or cached[0] != host:
            dev = torch.tensor(host, dtype=torch.int64).pin_memory().to(
                self.meta.device, non_blocking=True)
            self._ptrs[what] = cached = (host, dev)
        return cached[1]


def _bucket_table(b: Bucket, device) -> _Table:
    if b.table is None or b.table.meta.device != device:
        b.table = _Table(b.sizes, b.offsets, device)
    return b.table


def _lib():
    from paddle_tpu_torch.ops.pallas import _build
    lib = _build.load("fused_update")
    if lib.fused_sqnorm_launch.argtypes is None:
        P, I, L, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)
        lib.fused_sqnorm_launch.argtypes = [P, P, I, L, I, P, I, P, P]
        lib.fused_adam_launch.argtypes = [
            P, P, I, L, I, I, P, P, P, P, P, I, P,
            F, F, F, F, F, F, I, F, I, F, P]
        for fn in (lib.fused_sqnorm_launch, lib.fused_adam_launch):
            fn.restype = ctypes.c_int
        lib.fused_update_error_string.argtypes = [ctypes.c_int]
        lib.fused_update_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.fused_update_error_string(err).decode()}")


def _check_tensors(what, tensors, dtype=None):
    dt = dtype or tensors[0].dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"{what}: dtype {dt} is not float32, bfloat16 or "
                        f"float16")
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{what}: every tensor must be a contiguous "
                             f"{dt} tensor on {dev}")


def fused_sqnorm(grads, bucket: Optional[Bucket] = None) -> torch.Tensor:
    """The sum of the squares of ``grads`` (one bucket's gradients, any
    one float dtype) as an f32 0-d tensor: the kernel for CUDA tensors,
    :func:`sqnorm_plain` for CPU tensors."""
    global launches_sqnorm
    if not grads[0].is_cuda:
        return sqnorm_plain(grads)
    grads = [g.contiguous() for g in grads]
    _check_tensors("fused_sqnorm", grads)
    table = _bucket_table(bucket, grads[0].device) if bucket is not None \
        else _Table([g.numel() for g in grads], [0] * len(grads),
                    grads[0].device)
    lib = _lib()
    partials = torch.empty(_SQNORM_BLOCKS, dtype=torch.float64,
                           device=grads[0].device)
    out = torch.empty((), dtype=torch.float32, device=grads[0].device)
    err = lib.fused_sqnorm_launch(
        table.pointers("grads", grads).data_ptr(), table.meta.data_ptr(),
        table.n, table.n_chunks, _DTYPE_CODE[grads[0].dtype],
        partials.data_ptr(), _SQNORM_BLOCKS, out.data_ptr(),
        torch.cuda.current_stream(grads[0].device).cuda_stream)
    _raise_on(lib, err, "fused_sqnorm")
    launches_sqnorm += 1
    return out


def fused_adam_update(opt, b: Bucket, params, grads, flat, lr, scale=None):
    """One Adam/AdamW bucket's update (the arguments of
    :func:`bucket_update_plain`): the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    global launches_adam
    if not grads[0].is_cuda:
        return bucket_update_plain(opt, b, params, grads, flat, lr, scale)
    if not isinstance(opt, Adam):
        raise TypeError(f"fused_adam_update takes an Adam bucket, not "
                        f"{type(opt).__name__}")
    grads = [g.contiguous() for g in grads]
    _check_tensors("fused_adam_update params", params)
    _check_tensors("fused_adam_update grads", grads, params[0].dtype)
    sdt = torch.float32 if b.master else params[0].dtype
    if any(flat[k].dtype != sdt for k in ("moment1", "moment2")):
        raise TypeError(f"fused_adam_update: moments must be {sdt}")
    if b.master and flat["master_weight"].dtype != torch.float32:
        raise TypeError("fused_adam_update: the master weight must be f32")
    kw = b.kwargs
    decay_kind = 0 if b.decay is None else \
        1 if isinstance(b.decay, L2Decay) else 2
    table = _bucket_table(b, grads[0].device)
    lib = _lib()

    def f32(x):  # ctypes takes a Python float; this one is an f32 value
        return float(np.float32(x))
    err = lib.fused_adam_launch(
        table.pointers("adam", list(params) + grads).data_ptr(),
        table.meta.data_ptr(), table.n, table.n_chunks,
        _DTYPE_CODE[params[0].dtype], int(b.master),
        flat["moment1"].data_ptr(), flat["moment2"].data_ptr(),
        flat["master_weight"].data_ptr() if b.master else None,
        flat["beta1_pow"].data_ptr(), flat["beta2_pow"].data_ptr(),
        flat["beta1_pow"].numel(),
        scale.data_ptr() if scale is not None else None,
        f32(lr), f32(kw["beta1"]), f32(kw["beta2"]), f32(1 - kw["beta1"]),
        f32(1 - kw["beta2"]), f32(kw["epsilon"]), decay_kind,
        f32(b.decay.coeff if b.decay is not None else 0.0),
        int(bool(b.decay_coeff)), decay_factor(lr, b.decay_coeff),
        torch.cuda.current_stream(grads[0].device).cuda_stream)
    _raise_on(lib, err, "fused_adam_update")
    launches_adam += 1


# -- the step's clip and update -------------------------------------------
def fused_clip(opt, layout: FlatLayout, params, grads, reduce_sq=None):
    """The clip of the fused step. ``grads`` maps every train name to its
    gradient. Returns ``(bucket_grads, res_grads, scale, global_norm)``:
    per-bucket gradient lists and the residue's ``{name: grad}`` (clipped
    already, except by the global norm, whose factor ``scale`` the update
    folds in) and the pre-clip global norm under
    ``ClipGradByGlobalNorm`` (else None and None). ``reduce_sq``, given
    ``[(shard axes, squared norm)]``, returns the global sum of squares
    (``TrainStep`` over a mesh); by default the local sum."""
    clip = opt._grad_clip
    if clip is not None and not isinstance(clip, ClipGradByGlobalNorm):
        # a per-tensor strategy (ClipGradByNorm), or ClipGradByValue,
        # which is elementwise, so clipping before concatenation gives
        # the reference's values
        names = list(grads)
        grads = {n: g for n, (_, g) in zip(
            names, clip([(params[n], grads[n]) for n in names]))}
    bucket_grads = [[grads[n] for n in b.names] for b in layout.buckets]
    res_grads = {n: grads[n] for n in layout.residue}
    if not isinstance(clip, ClipGradByGlobalNorm):
        return bucket_grads, res_grads, None, None
    sq = [(b.shard_axes, fused_sqnorm(gs, b))
          for gs, b in zip(bucket_grads, layout.buckets)]
    sq += [(shard_axes(params[n]), sqnorm_plain([g]))
           for n, g in res_grads.items()]
    global_norm = torch.sqrt(sum(q for _, q in sq) if reduce_sq is None
                             else reduce_sq(sq))
    scale = clip.scale(global_norm)
    res_grads = {n: g * scale.to(g.dtype) for n, g in res_grads.items()}
    return bucket_grads, res_grads, scale, global_norm


def fused_update(opt, layout: FlatLayout, params, bucket_grads, flats,
                 group_lrs, scale=None):
    """The update of every fused bucket, in place. ``group_lrs`` holds one
    f32 effective lr per parameter group."""
    for b, gs, f in zip(layout.buckets, bucket_grads, flats):
        lr = group_lrs[b.group_index]
        if b.lr_ratio is not None:
            lr = np.float32(lr) * np.float32(b.lr_ratio)
        ps = [params[n] for n in b.names]
        update = fused_adam_update if isinstance(opt, Adam) \
            else bucket_update_plain
        update(opt, b, ps, gs, f, float(lr), scale)


def fused_clip_and_update(opt, layout: FlatLayout, params, grads, flats,
                          group_lrs):
    """Clip and update the fused buckets (:func:`fused_clip` then
    :func:`fused_update`). Returns ``(res_grads, global_norm)``: the
    residue's clipped gradients for the per-parameter loop, and the
    pre-clip global norm under ``ClipGradByGlobalNorm`` (else None)."""
    bucket_grads, res_grads, scale, gnorm = fused_clip(
        opt, layout, params, grads)
    fused_update(opt, layout, params, bucket_grads, flats, group_lrs, scale)
    return res_grads, gnorm
