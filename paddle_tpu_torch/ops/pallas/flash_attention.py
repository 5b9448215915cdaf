"""Flash attention — port of ``paddle_tpu/ops/pallas/flash_attention.py``.

The kernels: ``csrc/flash_attention.cu``, CUDA C++ for ``sm_90a``,
replacing the three Pallas TPU kernels of the reference:

* K1 ``_fwd_kernel`` (reference ``:242``, launched at ``:386``): the
  forward, writing ``o`` and the row log-sum-exp ``lse``;
* K2 ``_dq_kernel`` (``:410``, launched at ``:575``): ``dq``;
* K3 ``_dkv_kernel`` (``:471``, launched at ``:640``): ``dk`` and ``dv``,
  with the GQA group reduced inside the kernel.

They cover the reference's generality: causal masking with a kv/q length
offset, cross attention, native GQA, segment ids, a row or full additive
bias, and post-softmax dropout from a position hash (:func:`dropout_keep`)
that the forward and both backward kernels evaluate alike. Their bound on
the H100 is operations: at the training shape (B=4, S=2048, Hq=16,
Hkv=4, hd=128, causal, bf16) K1 does 68.7 GFLOP (0.069 ms at 989
TFLOP/s), K2 103 GFLOP (0.104 ms) and K3 137 GFLOP (0.139 ms). In bf16
and in f16 (what ``amp.auto_cast(dtype="float16")`` sends them) all
three run on the tensor cores (wgmma, tiles by TMA), so their q, k, v
and do must start on a 16-byte boundary; in f32 they run FMA loops.
The source's header says why, and ``PERF.md`` holds their times.

Head dims: the kernels have instances at 64 and 128 (``_HEAD_DIMS``).
On the card, :func:`flash_attention_bhsd` (and so ``_bshd``) takes any
other head_dim below 128 by zero-padding q, k and v to the next instance
(:func:`pad_head_dim`) with ``sm_scale`` kept at ``1/sqrt(head_dim)``,
and its autograd function slices o, dq, dk and dv back: zero columns add nothing to
the scores and come out zero in o and in every gradient. DiT-XL/2's
head_dim 72 runs this way on the hd-128 instances, at 128/72 = 1.78x
the attention work plus the pad and slice copies; each launch at a
padded width also counts in ``launches_padded``. A head_dim above 128
raises on the card. CPU tensors compute the plain version at the
caller's head_dim.

K1 is the registered op ``paddle_tpu::flash_fwd``
(``torch.library.custom_op``, registered when this module is imported,
with a fake implementation giving ``o`` and the f32 ``lse``): its
geometry travels as explicit arguments, so ``torch.export`` records one
node, and a loaded program (``jit.load``, ``inference.Predictor``)
launches the same kernel as the eager path. K2 and K3 stay plain
functions: export is for inference. The op costs 29-42 µs of host time
a call over calling its body on the H100 machine (``PERF.md``).

Each of :func:`flash_attention_fwd`, :func:`flash_attention_dq` and
:func:`flash_attention_dkv` launches its kernel for CUDA tensors, or
raises; for CPU tensors it computes its plain PyTorch version, which
repeats the kernel's arithmetic on the whole score matrix at once. The
module counts kernel launches in ``launches_fwd``, ``launches_dq`` and
``launches_dkv``, and nothing else. :func:`flash_attention_reference` is
the plain, autograd-differentiable version of the whole function, which
the tests and ``chip_smoke.py`` hold the kernels against.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import _build, counters

__all__ = ["flash_attention_bhsd", "flash_attention_bshd",
           "flash_attention_reference", "flash_attention_fwd",
           "flash_attention_dq", "flash_attention_dkv", "dropout_keep",
           "pad_head_dim", "padded_launch", "flash_block_fwd",
           "flash_block_bwd", "FlashGeometry"]

#: kernel launches since each count was last set to 0 (CPU calls, which
#: compute the plain versions, do not count)
launches_fwd = 0
launches_dq = 0
launches_dkv = 0
#: the launches of the three above made at a zero-padded head_dim
launches_padded = 0
counters.register(__name__, "launches_fwd", "launches_dq", "launches_dkv",
                  "launches_padded")

# finite stand-in for -inf (the reference's _MASK_VALUE, :71)
_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
# the position hash's multipliers (the reference's _dropout_keep, :197)
_HASH_Q, _HASH_K, _HASH_MIX = 0x9E3779B9, 0xC2B2AE35, 0x85EBCA6B
_U32 = 0xFFFFFFFF

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (64, 128)


def _threshold(dropout_p: float) -> int:
    """uint32 drop threshold: hashes below it drop (P = dropout_p)."""
    return min(int(dropout_p * 2**32), 2**32 - 1)


def _mul32(x, c: int):
    """``x * c mod 2**32`` for int64 tensors holding uint32 values,
    without int64 overflow: ``c`` is split into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def dropout_keep(bh, q_pos, k_pos, seed, threshold: int):
    """The dropout keep mask of (flat q head, q position, k position):
    the reference's murmur3-style hash, bit for bit, in int64 tensors
    holding uint32 values. Arguments broadcast; ``seed`` is an int.
    Returns a bool tensor (True = keep)."""
    x = _mul32(torch.as_tensor(q_pos, dtype=torch.int64) & _U32, _HASH_Q)
    x = x ^ _mul32(torch.as_tensor(k_pos, dtype=torch.int64) & _U32,
                   _HASH_K)
    x = x ^ _mul32(torch.as_tensor(bh, dtype=torch.int64) & _U32, _HASH_MIX)
    x = x ^ (int(seed) & _U32)
    x = x ^ (x >> 16)
    x = _mul32(x, _HASH_MIX)
    x = x ^ (x >> 13)
    x = _mul32(x, _HASH_K)
    x = x ^ (x >> 16)
    return x >= threshold


@dataclass
class FlashGeometry:
    """What a call needs beyond q, k and v, normalised: heads per batch
    row (``hq``, ``hkv``), the masks and the dropout. ``bias`` is f32
    ``[Bb*Hb, rows, Sk]`` with ``bias_bh = (Bb, Hb)``; segment ids are
    int32 ``[B, S]``."""
    hq: int
    hkv: int
    causal: bool
    sm_scale: float
    bias: Optional[torch.Tensor] = None
    bias_bh: tuple = (1, 1)
    q_seg: Optional[torch.Tensor] = None
    kv_seg: Optional[torch.Tensor] = None
    dropout_p: float = 0.0
    seed: int = 0
    #: the caller's head_dim, where q, k and v were zero-padded to a
    #: kernel instance's (:func:`pad_head_dim`)
    padded_from: Optional[int] = None

    @property
    def drop_scale(self) -> float:
        return 1.0 / (1.0 - self.dropout_p)


# ------------------------------ plain versions ------------------------------
def _round_like(x, dtype):
    """``x`` (f32) rounded to ``dtype`` where the kernel rounds it, with
    an identity gradient (the kernels round values, not gradients)."""
    if dtype == torch.float32:
        return x
    return x + (x.to(dtype).float() - x).detach()


def _scores(q, k, g: FlashGeometry):
    """Masked, clamped scores ``[B*Hq, Sq, Sk]`` in f32 and the segment
    liveness (or None), exactly as every kernel scores a tile."""
    bhq, sq, d = q.shape
    sk = k.shape[1]
    b = bhq // g.hq
    group = g.hq // g.hkv
    qf = q.float().reshape(b, g.hkv, group, sq, d)
    kf = k.float().reshape(b, g.hkv, 1, sk, d)
    s = torch.matmul(qf, kf.transpose(-1, -2)).reshape(bhq, sq, sk)
    s = s * g.sm_scale
    if g.bias is not None:
        bb, hb = g.bias_bh
        rows = g.bias.shape[1]
        bias = g.bias.reshape(bb, hb, rows, sk).expand(b, g.hq, rows, sk)
        s = s + bias.reshape(bhq, rows, sk)
    seg = None
    if g.q_seg is not None:
        seg = (g.q_seg[:, :, None] == g.kv_seg[:, None, :])
        seg = seg[:, None].expand(b, g.hq, sq, sk).reshape(bhq, sq, sk)
        s = torch.where(seg, s, torch.full_like(s, _MASK_VALUE))
    if g.causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        ki = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(qi >= ki, s, torch.full_like(s, _MASK_VALUE))
    return torch.clamp(s, min=_MASK_VALUE), seg


def _keep(g: FlashGeometry, bhq, sq, sk, device):
    """The dropout keep mask ``[B*Hq, Sq, Sk]`` (None without dropout)."""
    if g.dropout_p <= 0.0:
        return None
    return dropout_keep(
        torch.arange(bhq, device=device)[:, None, None],
        torch.arange(sq, device=device)[None, :, None],
        torch.arange(sk, device=device)[None, None, :], g.seed,
        _threshold(g.dropout_p))


def _dropped(x, keep, g: FlashGeometry):
    return x if keep is None else \
        torch.where(keep, x, torch.zeros_like(x)) * g.drop_scale


def _forward_plain(q, k, v, g: FlashGeometry):
    """K1's plain version: ``(o, lse)`` with ``o`` in q's dtype and
    ``lse`` f32 ``[B*Hq, Sq]``. Differentiable by autograd."""
    bhq, sq, d = q.shape
    sk = k.shape[1]
    s, seg = _scores(q, k, g)
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(s - m)
    if seg is not None:
        # rows with no segment-live key add no p: they come out exactly 0
        p = torch.where(seg.any(dim=-1, keepdim=True), p,
                        torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    p_acc = _round_like(_dropped(p, _keep(g, bhq, sq, sk, q.device), g),
                        v.dtype)
    b = bhq // g.hq
    group = g.hq // g.hkv
    vf = v.float().reshape(b, g.hkv, 1, sk, d)
    acc = torch.matmul(p_acc.reshape(b, g.hkv, group, sq, sk), vf)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    o = (acc.reshape(bhq, sq, d) / l_safe).to(q.dtype)
    lse = torch.where(l == 0, torch.zeros_like(l), m + torch.log(l_safe))
    return o, lse[..., 0]


def _probs(q, k, v, do, lse, g: FlashGeometry):
    """What both backward kernels recompute: p = exp(s - lse), the keep
    mask and dp = do·vᵀ with the dropout applied."""
    bhq, sq, d = q.shape
    sk = k.shape[1]
    b = bhq // g.hq
    group = g.hq // g.hkv
    s, _ = _scores(q, k, g)
    p = torch.exp(s - lse[..., None])
    keep = _keep(g, bhq, sq, sk, q.device)
    dof = do.float().reshape(b, g.hkv, group, sq, d)
    vf = v.float().reshape(b, g.hkv, 1, sk, d)
    dp = torch.matmul(dof, vf.transpose(-1, -2)).reshape(bhq, sq, sk)
    return p, keep, _dropped(dp, keep, g), dof


def _dq_plain(q, k, v, do, lse, delta, g: FlashGeometry):
    """K2's plain version: ``ds = p * (dp - delta) * scale``, rounded to
    k's dtype, then ``dq = ds·k``."""
    bhq, sq, d = q.shape
    sk = k.shape[1]
    b = bhq // g.hq
    group = g.hq // g.hkv
    p, _, dp, _ = _probs(q, k, v, do, lse, g)
    ds = (p * (dp - delta[..., None]) * g.sm_scale).to(k.dtype).float()
    dq = torch.matmul(ds.reshape(b, g.hkv, group, sq, sk),
                      k.float().reshape(b, g.hkv, 1, sk, d))
    return dq.reshape(bhq, sq, d).to(q.dtype)


def _dkv_plain(q, k, v, do, lse, delta, g: FlashGeometry):
    """K3's plain version: ``dv = p_dropᵀ·do`` and ``dk = dsᵀ·q`` with
    p_drop and ds rounded to the input dtype, the GQA group summed into
    the kv heads."""
    bhq, sq, d = q.shape
    sk = k.shape[1]
    b = bhq // g.hq
    group = g.hq // g.hkv
    p, keep, dp, dof = _probs(q, k, v, do, lse, g)
    shape = (b, g.hkv, group, sq, sk)
    p_v = _dropped(p, keep, g).to(do.dtype).float().reshape(shape)
    dv = torch.matmul(p_v.transpose(-1, -2), dof).sum(dim=2)
    ds = (p * (dp - delta[..., None]) * g.sm_scale).to(q.dtype).float()
    dk = torch.matmul(ds.reshape(shape).transpose(-1, -2),
                      q.float().reshape(b, g.hkv, group, sq, d)).sum(dim=2)
    return (dk.reshape(b * g.hkv, sk, d).to(k.dtype),
            dv.reshape(b * g.hkv, sk, d).to(v.dtype))


# --------------------------------- kernels ----------------------------------
class _Params(ctypes.Structure):
    """The source's ``Params``, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "q", "k", "v", "dout", "lse_in", "delta", "bias", "q_seg", "kv_seg",
        "out0", "out1", "lse_out")] + [(n, ctypes.c_int) for n in (
            "bhq", "bhkv", "sq", "sk", "hq", "hkv", "head_dim", "dtype",
            "causal", "has_bias", "bias_bb", "bias_hb", "bias_rows",
            "has_seg", "has_dropout")] + [
        ("threshold", ctypes.c_uint), ("seed", ctypes.c_uint),
        ("sm_scale", ctypes.c_float), ("drop_scale", ctypes.c_float)]


def _lib():
    lib = _build.load("flash_attention")
    if lib.flash_fwd_launch.argtypes is None:
        for name in ("flash_fwd_launch", "flash_dq_launch",
                     "flash_dkv_launch"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.flash_error_string.argtypes = [ctypes.c_int]
        lib.flash_error_string.restype = ctypes.c_char_p
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_cuda(g: FlashGeometry, **tensors):
    q = tensors["q"]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash attention kernels take float32, "
                        f"bfloat16 or float16, not {q.dtype}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(
            f"flash attention kernels have head_dim instances "
            f"{_HEAD_DIMS}, not {q.shape[-1]}; flash_attention_bhsd/_bshd "
            f"take any head_dim up to {_HEAD_DIMS[-1]}, zero-padded to the "
            f"next instance")
    for name, t in tensors.items():
        want = torch.float32 if name in ("lse", "delta") else q.dtype
        if t.dtype != want or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {want} tensor on "
                             f"{q.device}")
    for name, t, want in (("bias", g.bias, torch.float32),
                          ("q_seg", g.q_seg, torch.int32),
                          ("kv_seg", g.kv_seg, torch.int32)):
        if t is not None and (t.dtype != want or t.device != q.device
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {want} tensor on "
                             f"{q.device}")


def _check_tma_base(kernel: str, **tensors):
    """The bf16 and f16 kernels load their operands by TMA, which reads
    from 16-byte aligned bases only: raise on any other (nothing is
    copied)."""
    for name, t in tensors.items():
        if t.dtype != torch.float32 and t.data_ptr() % 16:
            raise ValueError(
                f"the {str(t.dtype)[6:]} {kernel} kernel loads {name} by "
                f"TMA, which needs a 16-byte aligned base, not "
                f"{t.data_ptr():#x}")


def _params(q_like, k_like, g: FlashGeometry, **ptrs) -> _Params:
    """The kernels' ``Params`` for q of ``q_like``'s shape and dtype and
    k/v of ``k_like``'s shape; ``ptrs`` name the data pointers."""
    bb, hb = g.bias_bh
    p = _Params(
        bhq=q_like.shape[0], bhkv=k_like.shape[0], sq=q_like.shape[1],
        sk=k_like.shape[1], hq=g.hq, hkv=g.hkv, head_dim=q_like.shape[2],
        dtype=_DTYPE_CODE[q_like.dtype], causal=int(g.causal),
        has_bias=int(g.bias is not None), bias_bb=bb, bias_hb=hb,
        bias_rows=1 if g.bias is None else g.bias.shape[1],
        has_seg=int(g.q_seg is not None),
        has_dropout=int(g.dropout_p > 0.0),
        threshold=_threshold(g.dropout_p) if g.dropout_p > 0.0 else 0,
        seed=int(g.seed) & _U32, sm_scale=float(g.sm_scale),
        drop_scale=float(g.drop_scale),
        bias=_ptr(g.bias), q_seg=_ptr(g.q_seg), kv_seg=_ptr(g.kv_seg))
    for name, value in ptrs.items():
        setattr(p, name, value)
    return p


def _launch(entry: str, q, params: _Params):
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, entry)(ctypes.byref(params), stream)
    if rc != 0:
        raise RuntimeError(
            f"flash attention kernel launch ({entry}) failed: "
            f"{lib.flash_error_string(rc).decode()} (cudaError {rc})")


def _device(q) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu tensors, "
                         f"not {q.device}")
    return q.device.type


def _count_padded(g: FlashGeometry):
    global launches_padded
    if g.padded_from is not None:
        launches_padded += 1


def flash_attention_fwd(q, k, v, g: FlashGeometry):
    """K1: ``(o, lse)`` for q ``[B*Hq, Sq, D]``, k/v ``[B*Hkv, Sk, D]``;
    ``lse`` is f32 ``[B*Hq, Sq]``. The call goes through the registered
    op ``paddle_tpu::flash_fwd`` (:func:`_flash_fwd_op`), with the
    geometry as its explicit arguments, so an exported program reaches
    the same kernel: CUDA tensors launch it (or raise); CPU tensors
    compute the plain version."""
    _device(q)
    bb, hb = g.bias_bh
    return torch.ops.paddle_tpu.flash_fwd(
        q, k, v, g.bias, g.q_seg, g.kv_seg, g.hq, g.hkv, g.causal,
        g.sm_scale, bb, hb, g.dropout_p, int(g.seed) & _U32,
        -1 if g.padded_from is None else g.padded_from)


@torch.library.custom_op("paddle_tpu::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor],
                  q_seg: Optional[torch.Tensor],
                  kv_seg: Optional[torch.Tensor], hq: int, hkv: int,
                  causal: bool, sm_scale: float, bias_bb: int, bias_hb: int,
                  dropout_p: float, seed: int,
                  padded_from: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 as a registered op (``padded_from`` -1: not padded). The body
    is :func:`flash_attention_fwd`'s whole work; ``torch.export`` sees
    one node and its fake implementation (:func:`_flash_fwd_fake`), and
    a loaded program runs this body."""
    global launches_fwd
    g = FlashGeometry(hq=hq, hkv=hkv, causal=causal, sm_scale=sm_scale,
                      bias=bias, bias_bh=(bias_bb, bias_hb), q_seg=q_seg,
                      kv_seg=kv_seg, dropout_p=dropout_p, seed=seed,
                      padded_from=None if padded_from < 0 else padded_from)
    if _device(q) == "cpu":
        with torch.no_grad():
            return _forward_plain(q, k, v, g)
    _check_cuda(g, q=q, k=k, v=v)
    _check_tma_base("forward", q=q, k=k, v=v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _launch("flash_fwd_launch", q, _params(
        q, k, g, q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
        out0=o.data_ptr(), lse_out=lse.data_ptr()))
    launches_fwd += 1
    _count_padded(g)
    return o, lse


@_flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, bias, q_seg, kv_seg, hq, hkv, causal,
                    sm_scale, bias_bb, bias_hb, dropout_p, seed,
                    padded_from):
    return (torch.empty_like(q),
            q.new_empty(q.shape[:2], dtype=torch.float32))


def flash_attention_dq(q, k, v, do, lse, delta, g: FlashGeometry):
    """K2: ``dq`` from the forward's ``lse`` and ``delta = rowsum(do *
    o)`` (both f32 ``[B*Hq, Sq]``)."""
    global launches_dq
    if _device(q) == "cpu":
        return _dq_plain(q, k, v, do, lse, delta, g)
    _check_cuda(g, q=q, k=k, v=v, do=do, lse=lse, delta=delta)
    _check_tma_base("dq", q=q, k=k, v=v, do=do)
    dq = torch.empty_like(q)
    _launch("flash_dq_launch", q, _params(
        q, k, g, q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
        dout=do.data_ptr(), lse_in=lse.data_ptr(), delta=delta.data_ptr(),
        out0=dq.data_ptr()))
    launches_dq += 1
    _count_padded(g)
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, g: FlashGeometry):
    """K3: ``(dk, dv)`` at kv-head resolution, the GQA group summed."""
    global launches_dkv
    if _device(q) == "cpu":
        return _dkv_plain(q, k, v, do, lse, delta, g)
    _check_cuda(g, q=q, k=k, v=v, do=do, lse=lse, delta=delta)
    _check_tma_base("dk/dv", q=q, k=k, v=v, do=do)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_dkv_launch", q, _params(
        q, k, g, q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
        dout=do.data_ptr(), lse_in=lse.data_ptr(), delta=delta.data_ptr(),
        out0=dk.data_ptr(), out1=dv.data_ptr()))
    launches_dkv += 1
    _count_padded(g)
    return dk, dv


def _padded_fwd(q, k, v, g: FlashGeometry):
    """K1 as the autograd path runs it: q, k and v zero-padded to the
    kernels' head_dim (:func:`pad_head_dim`). Returns the padded
    ``(q, k, v)`` and K1's padded ``o`` and its ``lse``."""
    qkv = pad_head_dim(q, k, v, g)
    return (qkv, *flash_attention_fwd(*qkv, g))


def _padded_bwd(qkv, o, lse, do, g: FlashGeometry):
    """K2 and K3 on :func:`_padded_fwd`'s tensors, ``do`` zero-padded to
    their width. Returns ``delta`` and the padded ``dq``, ``dk``, ``dv``."""
    do = torch.nn.functional.pad(do, (0, o.shape[-1] - do.shape[-1])) \
        if do.shape[-1] != o.shape[-1] else do.contiguous()
    # rowsum(do * o) in f32, a plain op as in the reference (:554)
    delta = (do.float() * o.float()).sum(dim=-1)
    dq = flash_attention_dq(*qkv, do, lse, delta, g)
    return (delta, dq, *flash_attention_dkv(*qkv, do, lse, delta, g))


def padded_launch(q, k, v, do, g: FlashGeometry):
    """K1, K2 and K3 once on ``[B*H, S, D]`` inputs, padded and sliced
    back as :func:`flash_attention_bhsd`'s autograd path runs them.
    Returns ``(o, lse, delta, dq, dk, dv)`` at width ``D``, and the
    largest magnitude the kernels wrote into the padded columns (0.0
    where nothing was padded; anything else is a kernel fault)."""
    d = q.shape[-1]
    qkv, o, lse = _padded_fwd(q, k, v, g)
    delta, dq, dk, dv = _padded_bwd(qkv, o, lse, do, g)
    padded = (o, dq, dk, dv)
    tail = max(float(t[..., d:].abs().max()) if t.shape[-1] > d else 0.0
               for t in padded)
    o, dq, dk, dv = (t[..., :d] for t in padded)
    return (o, lse, delta, dq, dk, dv), tail


def _block_geometry(q, k, causal, sm_scale) -> FlashGeometry:
    if q.dim() != 3 or k.shape[0] != q.shape[0] or \
            k.shape[2] != q.shape[2]:
        raise ValueError(f"flash blocks are [B*H, S, D] with matching "
                         f"B*H and D, got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    if causal and k.shape[1] < q.shape[1]:
        raise NotImplementedError(
            "a causal block with fewer keys than queries leaves rows with "
            "no visible key; the port does not take it")
    return FlashGeometry(hq=1, hkv=1, causal=bool(causal),
                         sm_scale=float(sm_scale))


def flash_block_fwd(q, k, v, causal, sm_scale):
    """K1 on one block of a ring (the reference's ``fa._fwd(q, k, v, ...,
    blk_causal, sm_scale, ...)`` of ``sequence_parallel.py:172-175``):
    q ``[B*H, Sq, D]``, k/v ``[B*H, Sk, D]``, contiguous (no copy is made
    here). Returns ``(o, lse)``: ``o`` in q's dtype, ``lse`` f32
    ``[B*H, Sq]``. A head_dim with no kernel instance is zero-padded as
    :func:`flash_attention_bhsd` pads it; CPU tensors compute the plain
    version."""
    g = _block_geometry(q, k, causal, sm_scale)
    d = q.shape[-1]
    _, o, lse = _padded_fwd(q, k, v, g)
    return (o if o.shape[-1] == d else o[..., :d]), lse


def flash_block_bwd(q, k, v, o, lse, do, causal, sm_scale, delta=None):
    """K2 and K3 on one block with an *external* ``o`` and ``lse`` (the
    reference's ``fa._bwd(q, k, v, o, lse, do, ...)``,
    ``sequence_parallel.py:176-178``): in ring-flash they are the merged
    output and its global log-sum-exp, so ``p = exp(s - lse)`` is this
    block's slice of the whole row's softmax. ``delta = rowsum(do * o)``
    (f32 ``[B*H, Sq]``) is computed from ``o`` unless given. ``do`` is in
    q's dtype. Returns ``(dq, dk, dv)`` at width ``D``."""
    g = _block_geometry(q, k, causal, sm_scale)
    if delta is None:
        delta = (do.float() * o.float()).sum(dim=-1)
    d = q.shape[-1]
    q, k, v = pad_head_dim(q, k, v, g)
    if q.shape[-1] != d:
        do = torch.nn.functional.pad(do, (0, q.shape[-1] - d))
    dq = flash_attention_dq(q, k, v, do, lse, delta, g)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, g)
    if dq.shape[-1] != d:
        dq, dk, dv = dq[..., :d], dk[..., :d], dv[..., :d]
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """Forward K1, backward K2 + K3, a head_dim with no instance padded
    inside (:func:`_padded_fwd`); bias and segment ids ride in the
    geometry as constants with no gradient (reference :685-691)."""

    @staticmethod
    def forward(ctx, q, k, v, g):
        qkv, o, lse = _padded_fwd(q, k, v, g)
        ctx.save_for_backward(*qkv, o, lse)
        ctx.g = g
        d = q.shape[-1]
        return o if o.shape[-1] == d else o[..., :d]

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        d = do.shape[-1]
        _, dq, dk, dv = _padded_bwd((q, k, v), o, lse, do, ctx.g)
        if dq.shape[-1] != d:
            dq, dk, dv = dq[..., :d], dk[..., :d], dv[..., :d]
        return dq, dk, dv, None


# ------------------------------- public API ---------------------------------
def _norm_bias(bias, b, hq, sq, sk, device):
    """Bias as f32 ``[Bb*Hb, Sq|1, Sk]`` and ``(Bb, Hb)`` (reference
    ``_norm_bias``, :725). A bool bias means True = attend."""
    bias = torch.as_tensor(bias, device=device)
    if bias.dtype == torch.bool:
        bias = torch.where(bias, torch.zeros((), device=device),
                           torch.full((), float(np.finfo(np.float32).min),
                                      device=device))
    if bias.dim() == 2:
        bias = bias[None, None]
    elif bias.dim() == 3:  # [B|H ambiguous, Sq, Sk]: per head
        bias = bias[None]
    if bias.dim() != 4:
        raise ValueError(f"bias must be 2/3/4-D, got shape "
                         f"{tuple(bias.shape)}")
    bb, hb = bias.shape[0], bias.shape[1]
    if bb not in (1, b) or hb not in (1, hq):
        raise ValueError(
            f"bias batch/head dims {tuple(bias.shape[:2])} must be 1 or "
            f"match (batch={b}, heads={hq})")
    rows = bias.shape[2]
    if rows not in (1, sq) or bias.shape[3] != sk:
        raise ValueError(
            f"bias tail {tuple(bias.shape[2:])} must equal (q_len|1, "
            f"kv_len)=({sq}|1, {sk})")
    return (bias.detach().float().reshape(bb * hb, rows, sk).contiguous(),
            (bb, hb))


def _norm_seg(seg, b, s, name, device):
    """Segment ids as int32 ``[B, S]`` (reference ``_norm_seg``, :753)."""
    seg = torch.as_tensor(seg, device=device)
    if seg.dim() == 1:
        seg = seg[None]
    if tuple(seg.shape) != (b, s):
        raise ValueError(f"{name} must have shape [batch={b}, {s}], got "
                         f"{tuple(seg.shape)}")
    return seg.detach().to(torch.int32).contiguous()


def _geometry(q, k, v, causal, sm_scale, bias, q_segment_ids,
              kv_segment_ids, dropout_p, dropout_seed):
    """Flatten q/k/v to ``[B*H, S, D]`` and normalise the rest, as the
    reference's ``flash_attention_bhsd`` does. Returns ``(q, k, v, g,
    (b, hq))``; ``(b, hq)`` is None for 3-D inputs."""
    squeeze = None
    if q.dim() == 4:
        b, hq, sq, d = q.shape
        hkv, sk = k.shape[1], k.shape[2]
        if tuple(k.shape) != (b, hkv, sk, d) or v.shape != k.shape:
            raise ValueError(f"k/v shapes {tuple(k.shape)}/"
                             f"{tuple(v.shape)} inconsistent")
        if hq % hkv:
            raise ValueError(
                f"q heads {hq} must be a multiple of kv heads {hkv}")
        q = q.reshape(b * hq, sq, d)
        k = k.reshape(b * hkv, sk, d)
        v = v.reshape(b * hkv, sk, d)
        squeeze = (b, hq)
    else:
        b, hq, hkv = q.shape[0], 1, 1
        if k.shape[0] != b or k.shape[2] != q.shape[2] or \
                v.shape != k.shape:
            raise ValueError(
                f"3-D flash attention requires matching batch*heads and "
                f"head_dim (and v matching k), got {tuple(q.shape)}/"
                f"{tuple(k.shape)}/{tuple(v.shape)}")
        sq, sk, d = q.shape[1], k.shape[1], q.shape[2]
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError(f"q, k and v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if causal and sk < sq:
        raise NotImplementedError(
            "causal attention with kv_len < q_len leaves rows with no "
            "visible key; the port does not take it")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("segment ids must be given for both q and kv")
    dropout_p = float(dropout_p)
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    if dropout_p > 0.0 and dropout_seed is None:
        raise ValueError(
            "dropout_p > 0 requires dropout_seed (an int or int32 "
            "array) so forward and recompute-backward agree")
    g = FlashGeometry(hq=hq, hkv=hkv, causal=bool(causal),
                      sm_scale=float(sm_scale), dropout_p=dropout_p)
    if bias is not None:
        g.bias, g.bias_bh = _norm_bias(bias, b, hq, sq, sk, q.device)
    if q_segment_ids is not None:
        g.q_seg = _norm_seg(q_segment_ids, b, sq, "q_segment_ids", q.device)
        g.kv_seg = _norm_seg(kv_segment_ids, b, sk, "kv_segment_ids",
                             q.device)
    if dropout_p > 0.0:
        g.seed = int(torch.as_tensor(dropout_seed).reshape(-1)[0])
    return (q.contiguous(), k.contiguous(), v.contiguous(), g, squeeze)


def pad_head_dim(q, k, v, g: FlashGeometry):
    """CUDA q, k, v (``[B*H, S, D]``) of a head_dim with no kernel
    instance, zero-padded to the next instance's, and ``g`` marked with
    the caller's head_dim (``sm_scale`` is already its own). Native
    head_dims and CPU tensors pass unchanged; a head_dim above the
    widest instance raises."""
    d = q.shape[-1]
    if q.device.type != "cuda" or d in _HEAD_DIMS:
        return q, k, v
    width = next((w for w in _HEAD_DIMS if w > d), None)
    if width is None:
        raise ValueError(
            f"flash attention on the card takes head_dim {_HEAD_DIMS} "
            f"natively and any head_dim below {_HEAD_DIMS[-1]} zero-padded "
            f"to the next of them, not {d}")
    g.padded_from = d
    pad = (0, width - d)
    return (torch.nn.functional.pad(q, pad),
            torch.nn.functional.pad(k, pad),
            torch.nn.functional.pad(v, pad))


def flash_attention_bhsd(q, k, v, causal=False, sm_scale=None, bias=None,
                         q_segment_ids=None, kv_segment_ids=None,
                         dropout_p=0.0, dropout_seed=None, block_q=None,
                         block_k=None):
    """Flash attention on tensors in ``[B, H, S, D]`` (or ``[BH, S, D]``)
    layout, differentiable in q, k and v.

    GQA: 4-D ``k``/``v`` may carry fewer heads than ``q``. Cross
    attention: ``kv_len`` may differ from ``q_len``; with ``causal=True``
    query i attends keys ``<= i + (kv_len - q_len)`` (``kv_len >= q_len``).
    ``bias`` is an additive mask broadcastable to ``[B, Hq, Sq, Sk]``
    (bool: True = attend); segment ids (``[B, Sq]``/``[B, Sk]`` ints)
    restrict attention to equal ids; both are constants. ``block_q`` and
    ``block_k`` are the TPU kernel's tile sizes and are ignored: the CUDA
    kernels use their own tiles. On the card a head_dim with no kernel
    instance is zero-padded to the next one (:func:`pad_head_dim`).
    """
    del block_q, block_k
    shape = q.shape
    q, k, v, g, squeeze = _geometry(q, k, v, causal, sm_scale, bias,
                                    q_segment_ids, kv_segment_ids,
                                    dropout_p, dropout_seed)
    return _Flash.apply(q, k, v, g).reshape(shape)


def flash_attention_bshd(query, key, value, causal=False, sm_scale=None,
                         bias=None, q_segment_ids=None, kv_segment_ids=None,
                         dropout_p=0.0, dropout_seed=None, block_q=None,
                         block_k=None):
    """Flash attention in Paddle's ``[batch, seq, heads, head_dim]``
    layout; ``key``/``value`` may carry fewer heads (GQA) and another
    sequence length (cross attention) than ``query``."""
    out = flash_attention_bhsd(
        query.transpose(1, 2), key.transpose(1, 2), value.transpose(1, 2),
        causal=causal, sm_scale=sm_scale, bias=bias,
        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
        dropout_p=dropout_p, dropout_seed=dropout_seed, block_q=block_q,
        block_k=block_k)
    return out.transpose(1, 2)


def flash_attention_reference(q, k, v, causal=False, sm_scale=None,
                              bias=None, q_segment_ids=None,
                              kv_segment_ids=None, dropout_p=0.0,
                              dropout_seed=None):
    """The plain PyTorch version of the whole function, in the
    arguments and layout of :func:`flash_attention_bhsd`, returning
    ``(o, lse)`` (``lse`` f32 ``[B, Hq, Sq]``, or ``[BH, Sq]``). It is
    written as the kernels compute: scores masked to ``-0.7 * f32max``
    and clamped there, a row with no segment-live key gives ``o = 0`` and
    ``lse = 0``, dropout from :func:`dropout_keep`, and in bf16 the
    probabilities rounded before the PV product. Autograd through it
    gives the gradients the backward kernels compute. One difference of
    the kernels it does not copy: a row whose every visible score is
    masked by the bias averages v over the keys of the tiles the kernel
    visits, where this version averages over every key."""
    shape = q.shape
    q, k, v, g, squeeze = _geometry(q, k, v, causal, sm_scale, bias,
                                    q_segment_ids, kv_segment_ids,
                                    dropout_p, dropout_seed)
    o, lse = _forward_plain(q, k, v, g)
    return o.reshape(shape), lse.reshape(shape[:-1])
