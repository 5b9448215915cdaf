"""Sequence parallelism — port of
``paddle_tpu/distributed/fleet/sequence_parallel.py``.

Activations split the *sequence* dim over the ``sp`` mesh axis. Each
process is one rank and holds its shard ``[B, S/n, H, D]``: where the
reference annotates a global array (:35-49), :func:`scatter_sequence`
here returns this rank's shard of a global tensor and
:func:`gather_sequence` all-gathers the shards back.

:func:`ring_attention` rotates the K/V shards around the ``sp`` ring
with :func:`~paddle_tpu_torch.distributed.collective.p2p_shift` while
each rank's resident Q block folds every incoming block in. Two paths,
as in the reference:

* **ring-flash** (:class:`_RingFlash`, reference :124-276): each step
  runs K1 (``flash_block_fwd``) on the resident q against the incoming
  block, the diagonal block causal when ``causal``, and merges the
  block's ``(o, lse)`` into an f32 accumulator through the log-sum-exp;
  the backward runs K2 + K3 (``flash_block_bwd``) once per visible block
  with the **global** lse of the merged output, ``dq`` accumulating here
  while the f32 ``dk``/``dv`` accumulators ride the same ring and come
  home with one last rotation. Blocks wholly in the future are skipped
  when causal (``rank >= s``, :203-213). CUDA tensors launch the
  kernels or raise; CPU tensors run their plain versions through the
  same ring.
* **the composite** (reference :52-121): the same online softmax in f32
  PyTorch ops, differentiable by autograd. Every K/V block of the ring
  comes from one autograd node (:class:`_RingBlocks`) whose backward is
  the reverse ring, so every rank runs the same collectives in its
  backward whichever blocks it used.

``use_flash=None`` follows the reference's auto rule (:324-328): the
kernel path for CUDA tensors whose head_dim the kernels take (up to
128), the composite otherwise; ``True``/``False`` force a path.

:func:`ulysses_attention` does an all-to-all from sequence-sharded to
head-sharded, runs ``F.scaled_dot_product_attention`` (K1-K3 on the
card) on the whole sequence for ``H/n`` heads, and an all-to-all back
(:334-353).

The reference's ring takes no GQA (it reshapes k and v with q's head
count, :166-170); here a k or v with another head count than q raises
``ValueError``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from paddle_tpu_torch.core.tensor import Tensor, unwrap, wrap
from paddle_tpu_torch.ops.pallas import flash_attention as fa

from .. import collective as C
from ..mesh import axis_index, axis_size, get_mesh
from .mpu import _GatherFromGroup, _ScatterToGroup

__all__ = ["ring_attention", "ulysses_attention", "scatter_sequence",
           "gather_sequence"]


def _like(src, out):
    return wrap(out) if type(src) is Tensor else out


def _sp(mesh, axis, what):
    mesh = mesh or get_mesh()
    if mesh is None or axis not in mesh.mesh_dim_names:
        raise RuntimeError(f"{what} needs a mesh with axis {axis!r}")
    return mesh, C.Group((axis,), mesh)


def scatter_sequence(x, mesh=None, axis: str = "sp", seq_dim: int = 1):
    """This rank's shard of the global ``x`` along ``seq_dim`` (the
    reference annotates the global array instead); the backward
    all-gathers the gradient. Raises when the sequence does not divide
    by the ``axis`` size."""
    mesh, group = _sp(mesh, axis, "scatter_sequence")
    t = unwrap(x)
    if t.shape[seq_dim] % group.nranks:
        raise ValueError(f"scatter_sequence: a sequence of "
                         f"{t.shape[seq_dim]} does not split over the "
                         f"{group.nranks} ranks of {axis!r}")
    return _like(x, _ScatterToGroup.apply(t, group, seq_dim % t.dim()))


def gather_sequence(x, mesh=None, seq_dim: int = 1, axis: str = "sp"):
    """The global tensor of the shards along ``seq_dim``, on every rank
    of ``axis`` (an all-gather; the backward keeps this rank's block of
    the gradient)."""
    mesh, group = _sp(mesh, axis, "gather_sequence")
    t = unwrap(x)
    return _like(x, _GatherFromGroup.apply(t, group, seq_dim % t.dim()))


def _to_k(x):
    """``[B, S, H, D]`` -> the kernels' ``[B*H, S, D]``, contiguous: a
    block that arrived by the ring or a view is copied here, never inside
    a kernel's wrapper (the bf16 kernels load by TMA from 16-byte aligned
    bases)."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def _from_k(x, b, h):
    bh, s, d = x.shape
    return x.reshape(b, h, s, d).transpose(1, 2)


def _merge(o, lse, o_s, lse_s):
    """Fold block output ``o_s`` (its log-sum-exp ``lse_s``) into the f32
    accumulator ``o`` (``lse``) — reference :180-188."""
    m = torch.maximum(lse, lse_s)
    new = m + torch.log(torch.exp(lse - m) + torch.exp(lse_s - m))
    o = torch.exp(lse - new)[..., None] * o + \
        torch.exp(lse_s - new)[..., None] * o_s.float()
    return o, new


class _RingFlash(torch.autograd.Function):
    """Ring-flash over ``[B*H, S/n, D]`` blocks: K1 per visible block
    forward, K2 + K3 per visible block backward with the global lse."""

    @staticmethod
    def forward(ctx, qk, kk, vk, group, rank, n, causal, sm_scale):
        o, lse = fa.flash_block_fwd(qk, kk, vk, causal, sm_scale)
        acc = o.float()
        kc, vc = kk, vk
        for s in range(1, n):
            kc = C.p2p_shift(kc, group)
            vc = C.p2p_shift(vc, group)
            # src = rank - s (mod n) is a past shard iff rank >= s
            if not causal or rank >= s:
                o_s, lse_s = fa.flash_block_fwd(qk, kc, vc, False, sm_scale)
                acc, lse = _merge(acc, lse, o_s, lse_s)
        out = acc.to(qk.dtype)
        ctx.save_for_backward(qk, kk, vk, out, lse.contiguous())
        ctx.ring = (group, rank, n, causal, sm_scale)
        return out

    @staticmethod
    def backward(ctx, do):
        qk, kk, vk, out, lse = ctx.saved_tensors
        group, rank, n, causal, sm_scale = ctx.ring
        do = do.to(qk.dtype).contiguous()
        delta = (do.float() * out.float()).sum(dim=-1)
        dq, dk, dv = fa.flash_block_bwd(qk, kk, vk, out, lse, do, causal,
                                        sm_scale, delta)
        dq, dk_acc, dv_acc = dq.float(), dk.float(), dv.float()
        kc, vc = kk, vk
        for s in range(1, n):
            kc = C.p2p_shift(kc, group)
            vc = C.p2p_shift(vc, group)
            # the dk/dv accumulators ride the same ring, so each block's
            # contribution lands on its shard's row; n rotations in all
            # bring them home
            dk_acc = C.p2p_shift(dk_acc, group)
            dv_acc = C.p2p_shift(dv_acc, group)
            if not causal or rank >= s:
                g_q, g_k, g_v = fa.flash_block_bwd(qk, kc, vc, out, lse, do,
                                                   False, sm_scale, delta)
                dq += g_q
                dk_acc += g_k
                dv_acc += g_v
        dk_acc = C.p2p_shift(dk_acc, group)
        dv_acc = C.p2p_shift(dv_acc, group)
        return (dq.to(qk.dtype), dk_acc.to(kk.dtype), dv_acc.to(vk.dtype),
                None, None, None, None, None)


class _RingBlocks(torch.autograd.Function):
    """The n K/V blocks a rank sees around the ring: block ``s`` is the
    stacked ``kv`` of rank ``rank - s``. The backward is the reverse
    ring: ``d kv = sum_s hop^{-s}(g_s)`` by Horner's rule, n - 1 hops on
    every rank."""

    @staticmethod
    def forward(ctx, kv, group, n):
        ctx.group, ctx.n = group, n
        ctx.set_materialize_grads(True)
        blocks = [kv]
        for _ in range(1, n):
            blocks.append(C.p2p_shift(blocks[-1], group))
        return tuple(blocks)

    @staticmethod
    def backward(ctx, *grads):
        acc = grads[-1]
        for g in reversed(grads[:-1]):
            acc = C.p2p_shift(acc.contiguous(), ctx.group, shift=-1) + g
        return acc, None, None


def _ring_composite(q, k, v, group, rank, n, causal, sm_scale):
    """Reference :52-121 on this rank's ``[B, Sq, H, D]`` shards; f32
    online softmax, autograd through it."""
    b, sq, h, d = q.shape
    qt = q.transpose(1, 2).float()                       # [B, H, Sq, D]
    blocks = _RingBlocks.apply(torch.stack([k, v]).contiguous(), group, n)
    m = torch.full((b, h, sq), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for r in range(n):
        src = (rank - r) % n
        if causal and src > rank:
            continue  # a block wholly in the future
        kt = blocks[r][0].transpose(1, 2).float()
        vt = blocks[r][1].transpose(1, 2).float()
        s = torch.einsum("bhqd,bhkd->bhqk", qt, kt) * sm_scale
        if causal:
            q_pos = rank * sq + torch.arange(sq, device=q.device)
            k_pos = src * sq + torch.arange(sq, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            s = torch.where(mask, s, torch.full_like(s, -math.inf))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows (exp(-inf - -inf))
        safe = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new),
                           m_new)
        p = torch.exp(s - safe[..., None])
        p = torch.where(torch.isneginf(m_new)[..., None],
                        torch.zeros_like(p), p)
        alpha = torch.where(torch.isneginf(m), torch.zeros_like(m),
                            torch.exp(m - safe))
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vt)
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def ring_attention(query, key, value, mesh=None, axis: str = "sp",
                   causal: bool = False, sm_scale: Optional[float] = None,
                   use_flash: Optional[bool] = None):
    """Ring attention over this rank's sequence shards ``[B, S/n, H, D]``
    of q, k and v (reference :311-331); returns this rank's output shard.
    Differentiable in all three. ``use_flash``: None takes the kernel
    path for CUDA tensors whose head_dim the kernels take and the
    composite otherwise; True or False forces one (True on CPU tensors
    runs the kernels' plain versions through the same ring)."""
    mesh, group = _sp(mesh, axis, "ring_attention")
    q, k, v = unwrap(query), unwrap(key), unwrap(value)
    if k.shape[2] != q.shape[2] or v.shape[2] != q.shape[2]:
        raise ValueError(
            f"ring_attention takes as many k/v heads as q heads (the "
            f"reference's ring has no GQA), got q {q.shape[2]}, k "
            f"{k.shape[2]}, v {v.shape[2]}; repeat k and v first")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"ring_attention needs equal q, k and v shards, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    d = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if use_flash is None:
        use_flash = q.is_cuda and d <= fa._HEAD_DIMS[-1]
    n = axis_size(mesh, axis)
    rank = axis_index(mesh, axis)
    if use_flash:
        b, _, h, _ = q.shape
        out = _from_k(_RingFlash.apply(_to_k(q), _to_k(k), _to_k(v), group,
                                       rank, n, bool(causal),
                                       float(sm_scale)), b, h)
    else:
        out = _ring_composite(q, k, v, group, rank, n, bool(causal),
                              float(sm_scale))
    return _like(query, out)


class _SeqToHeads(torch.autograd.Function):
    """All-to-all of the stacked ``[3|1, B, S/n, H, D]`` shards to
    ``[3|1, B, S, H/n, D]`` (``back=False``) or the reverse; each is the
    other's backward."""

    @staticmethod
    def forward(ctx, x, group, back):
        ctx.group, ctx.back = group, back
        return _a2a(x, group, back)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g.contiguous(), ctx.group, not ctx.back), None, None


def _a2a(x, group, back):
    # split the heads (dim 3) and gather the sequence (dim 2), or back
    split, cat = (2, 3) if back else (3, 2)
    return C.all_to_all(x.contiguous(), group=group, split_axis=split,
                        concat_axis=cat).contiguous()


def ulysses_attention(query, key, value, mesh=None, axis: str = "sp",
                      causal: bool = False):
    """Ulysses sequence parallelism (reference :334-353): q, k, v
    sequence shards ``[B, S/n, H, D]`` go by one all-to-all to head
    shards ``[B, S, H/n, D]``, ``F.scaled_dot_product_attention`` runs
    on them (K1-K3 on the card), and one all-to-all brings the output
    back to this rank's sequence shard. The heads must divide by the
    ``axis`` size."""
    from paddle_tpu_torch.nn import functional as F
    mesh, group = _sp(mesh, axis, "ulysses_attention")
    q, k, v = unwrap(query), unwrap(key), unwrap(value)
    n = axis_size(mesh, axis)
    if q.shape[2] % n or k.shape[2] % n:
        raise ValueError(f"ulysses_attention splits the heads ({q.shape[2]}"
                         f" on q, {k.shape[2]} on k/v) over {n} ranks of "
                         f"{axis!r}: they must divide")
    if k.shape == q.shape and v.shape == q.shape:
        qh, kh, vh = _SeqToHeads.apply(torch.stack([q, k, v]), group, False)
    else:
        qh = _SeqToHeads.apply(q[None], group, False)[0]
        kh, vh = _SeqToHeads.apply(torch.stack([k, v]), group, False)
    out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
    return _like(query, _SeqToHeads.apply(out[None], group, True)[0])
