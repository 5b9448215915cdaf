"""Grouped matrix multiply — port of
``paddle_tpu/ops/pallas/grouped_matmul.py``.

Tokens arrive sorted by expert: ``group_sizes[e]`` rows belong to expert
``e``, and one kernel computes ``out[rows_e] = lhs[rows_e] @ rhs[e]`` for
every expert. The kernels: ``csrc/grouped_matmul.cu``, CUDA C++ for
``sm_90a``, replacing the four Pallas TPU kernels of the reference:

* K5 ``_gmm_fwd`` (reference ``:121``, launched at ``:178``): the grouped
  product over group-sorted rows; rows past ``sum(group_sizes)`` are 0;
* K6 ``_tgmm_fwd`` (``:186``, launched at ``:242``): ``out[e] =
  lhs[rows_e]ᵀ @ g[rows_e]`` in f32; an empty expert is 0;
* K7 ``_gmm_aligned_fwd`` (``:261``, launched at ``:283``): K5 on the
  bm-aligned layout, one expert per row block of ``bm`` rows;
* K8 ``_tgmm_aligned_fwd`` (``:291``, launched at ``:335``): K6 on the
  aligned layout; an expert with no block is left unwritten and
  :func:`gmm_aligned`'s backward replaces it with 0 by ``where``.

K5 and K7 with bf16 lhs and rhs run on the bf16 tensor cores (wgmma,
operands by TMA, or through registers where TMA cannot describe one: see
:func:`_gmm_loaders`) over row tiles that never straddle a group
(:func:`_gmm_tiles`; K7's groups are the runs of its block experts,
:func:`_aligned_offsets`). K6, always f32, runs on the bf16 tensor cores
too, each f32 value split into three bf16 values, to f32 accuracy. K8
with bf16 inputs runs on the tensor cores over the same block runs
(:func:`_tgmm_aligned_loader`). The f32 instances of K5, K7 and K8 keep
the FMA kernels: the tensor cores' TF32 would miss the f32 tolerances.

Each kernel wrapper launches its kernel for CUDA tensors, or raises; for
CPU tensors it computes its plain PyTorch version, which loops over the
groups with f32 products. The module counts kernel launches in
``launches_gmm`` (K5), ``launches_tgmm`` (K6), ``launches_gmm_aligned``
(K7) and ``launches_tgmm_aligned`` (K8), and nothing else. The public
functions :func:`gmm`, :func:`gmm_aligned` (both differentiable, with the
reference's backward) and :func:`tgmm` take ``bm`` as the reference does:
it fixes the divisibility of the rows and the aligned layout; the CUDA
tile height is the kernels' own. No wrapper reads ``group_sizes`` on the
host: offsets and block experts are computed on its device.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["gmm", "tgmm", "gmm_aligned"]

#: kernel launches since each count was last set to 0 (CPU calls, which
#: compute the plain versions, do not count)
launches_gmm = 0
launches_tgmm = 0
launches_gmm_aligned = 0
launches_tgmm_aligned = 0

_F32, _BF16 = torch.float32, torch.bfloat16
_DTYPE_CODE = {_F32: 0, _BF16: 1}
# the (lhs, rhs) dtype pairs each kernel takes: those the reference's
# forward and backward passes give it
_GMM_MIXES = ((_F32, _F32), (_BF16, _BF16), (_F32, _BF16))
_TILE_ROWS = 128  # rows of a tile in the bf16 kernel of K5 and K7
_FLUSH_ROWS = 1024  # rows K6 and K8 sum in one wgmma accumulator
_TGMM_MIXES = ((_F32, _F32),)
_TGMM_ALIGNED_MIXES = ((_F32, _F32), (_BF16, _BF16))


# ------------------------------ routing metadata ----------------------------
def _offsets_ext(group_sizes, r_pad):
    """int32 ``[E + 2]``: 0, ``cumsum(group_sizes)``, ``r_pad`` (reference
    :380) — the last entry closes the sentinel pad group."""
    gs = group_sizes.to(torch.int32)
    zero = torch.zeros(1, dtype=torch.int32, device=gs.device)
    pad = torch.full((1,), r_pad, dtype=torch.int32, device=gs.device)
    return torch.cat([zero, torch.cumsum(gs, 0, dtype=torch.int32), pad])


def _block_experts(group_sizes, n_blocks, n_groups, bm):
    """The expert of each ``bm``-row block of the aligned layout (reference
    :250-258): the group whose range holds the block's first row, found
    with ``side="right"`` so a block after an empty group goes to the next
    group; trailing blocks past the data clamp to ``n_groups - 1``."""
    offs = torch.cumsum(group_sizes.to(torch.int32), 0, dtype=torch.int32)
    starts = torch.arange(n_blocks, dtype=torch.int32,
                          device=offs.device) * bm
    be = torch.searchsorted(offs, starts, right=True, out_int32=True)
    return torch.clamp(be, max=n_groups - 1)


def _runs(block_experts):
    """``[(expert, first block, past last block)]`` of equal neighbours
    (host-side: the plain versions only)."""
    be = block_experts.tolist()
    runs, b = [], 0
    while b < len(be):
        n = b + 1
        while n < len(be) and be[n] == be[b]:
            n += 1
        runs.append((be[b], b, n))
        b = n
    return runs


# ------------------------------ plain versions ------------------------------
def _gmm_plain(lhs, rhs, offsets):
    """K5's plain version: each group's rows times its expert's matrix in
    f32, cast to lhs's dtype at the end; rows past the groups are 0."""
    rows = lhs.shape[0]
    out = torch.zeros(rows, rhs.shape[2], dtype=_F32, device=lhs.device)
    offs = offsets.tolist()
    for e in range(rhs.shape[0]):
        lo, hi = min(offs[e], rows), min(offs[e + 1], rows)
        if hi > lo:
            out[lo:hi] = lhs[lo:hi].float() @ rhs[e].float()
    return out.to(lhs.dtype)


def _tgmm_plain(lhs, g, offsets, n_groups):
    """K6's plain version: ``lhs[rows_e]ᵀ @ g[rows_e]`` in f32; an empty
    expert is 0."""
    rows = lhs.shape[0]
    out = torch.zeros(n_groups, lhs.shape[1], g.shape[1], dtype=_F32,
                      device=lhs.device)
    offs = offsets.tolist()
    for e in range(n_groups):
        lo, hi = min(offs[e], rows), min(offs[e + 1], rows)
        if hi > lo:
            out[e] = lhs[lo:hi].float().t() @ g[lo:hi].float()
    return out


def _gmm_aligned_plain(lhs, rhs, block_experts, bm):
    """K7's plain version: each run of blocks times its expert's matrix."""
    out = torch.empty(lhs.shape[0], rhs.shape[2], dtype=_F32,
                      device=lhs.device)
    for e, b0, b1 in _runs(block_experts):
        rows = slice(b0 * bm, b1 * bm)
        out[rows] = lhs[rows].float() @ rhs[e].float()
    return out.to(lhs.dtype)


def _tgmm_aligned_plain(lhs, g, block_experts, n_groups, bm):
    """K8's plain version in f32. An expert with no block is 0 here, where
    the kernel leaves it unwritten; compare the two only where an expert
    owns a block, or after :func:`gmm_aligned`'s ``where``."""
    out = torch.zeros(n_groups, lhs.shape[1], g.shape[1], dtype=_F32,
                      device=lhs.device)
    for e, b0, b1 in _runs(block_experts):
        rows = slice(b0 * bm, b1 * bm)
        out[e] = lhs[rows].float().t() @ g[rows].float()
    return out


def _tgmm_aligned_walk_plain(lhs, g, block_experts, n_groups, bm):
    """K8's bf16 walk in plain PyTorch: the (expert, 128 lhs columns, 128
    g columns) items over the runs of :func:`_aligned_offsets`, each
    summing its expert's rows in chunks of ``_FLUSH_ROWS`` (the kernel
    restarts its accumulators there) and adding each chunk to the output
    tile in f32. An expert with no block is left unwritten: NaN here."""
    rows, M = lhs.shape
    H = g.shape[1]
    offs = _aligned_offsets(block_experts, n_groups, bm).tolist()
    out = torch.full((n_groups, M, H), float("nan"), dtype=_F32,
                     device=lhs.device)
    t = _TILE_ROWS
    for e in range(n_groups):
        lo, hi = min(max(offs[e], 0), rows), min(offs[e + 1], rows)
        for m0 in range(0, M, t) if hi > lo else ():
            for n0 in range(0, H, t):
                for k0 in range(lo, hi, _FLUSH_ROWS):
                    k1 = min(hi, k0 + _FLUSH_ROWS)
                    part = lhs[k0:k1, m0:m0 + t].float().t() @ \
                        g[k0:k1, n0:n0 + t].float()
                    tile = out[e, m0:m0 + t, n0:n0 + t]
                    out[e, m0:m0 + t, n0:n0 + t] = \
                        part if k0 == lo else tile + part
    return out


# --------------------------------- kernels ----------------------------------
class _Params(ctypes.Structure):
    """The source's ``GmmParams``, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "lhs", "rhs", "offsets", "block_experts", "out", "tiles")] + [
        (n, ctypes.c_longlong) for n in ("rhs_se", "rhs_sk", "rhs_sn")] + [
        (n, ctypes.c_int) for n in ("rows", "lhs_cols", "n_dim", "experts",
                                    "bm", "lhs_dtype", "rhs_dtype",
                                    "max_tiles", "tma_lhs", "tma_rhs")]


def _lib():
    lib = _build.load("grouped_matmul")
    if lib.gmm_launch.argtypes is None:
        for name in ("gmm_launch", "tgmm_launch", "gmm_aligned_launch",
                     "tgmm_aligned_launch"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.gmm_tiles_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.gmm_tiles_launch.restype = ctypes.c_int
        lib.gmm_error_string.argtypes = [ctypes.c_int]
        lib.gmm_error_string.restype = ctypes.c_char_p
    return lib


def _device(*tensors) -> str:
    """``"cpu"`` or ``"cuda"``, the one device every tensor lies on."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"grouped matmul takes its tensors on one device, "
                         f"got {sorted(str(d) for d in devices)}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"grouped matmul runs on cuda or cpu tensors, not "
                         f"{device}")
    return device.type


def _check_shapes(lhs, other, index, n_index):
    """``other`` is rhs ``[E, M, H]`` (gmm) or g ``[R, H]`` (tgmm)."""
    if other.dim() == 3:
        ok = lhs.dim() == 2 and other.shape[1] == lhs.shape[1]
        want = "lhs [R, M] and rhs [E, M, H]"
    else:
        ok = lhs.dim() == 2 and other.dim() == 2 and \
            other.shape[0] == lhs.shape[0]
        want = "lhs [R, M] and g [R, H]"
    if not ok:
        raise ValueError(f"grouped matmul takes {want}, got "
                         f"{tuple(lhs.shape)} and {tuple(other.shape)}")
    if index.dim() != 1 or index.shape[0] != n_index:
        raise ValueError(f"expected an index vector of {n_index} entries, "
                         f"got shape {tuple(index.shape)}")


def _check_cuda(kernel, lhs, other, index, mixes, other_contiguous):
    if (lhs.dtype, other.dtype) not in mixes:
        names = ", ".join(f"({a}, {b})" for a, b in mixes)
        raise TypeError(f"{kernel} takes (lhs, rhs) dtypes {names}, not "
                        f"({lhs.dtype}, {other.dtype})".replace("torch.", ""))
    if not lhs.is_contiguous():
        raise ValueError(f"{kernel}: lhs must be contiguous")
    if other_contiguous and not other.is_contiguous():
        raise ValueError(f"{kernel}: g must be contiguous")
    if index.dtype != torch.int32 or not index.is_contiguous():
        raise ValueError(f"{kernel}: the group index must be a contiguous "
                         f"int32 tensor")


def _params(lhs, other, out, n_groups, bm, **ptrs) -> _Params:
    """``other`` is rhs ``[E, M, H]`` (any strides) or g ``[R, H]``."""
    strides = other.stride()
    se, sk, sn = (0,) + strides if other.dim() == 2 else strides
    return _Params(
        lhs=lhs.data_ptr(), rhs=other.data_ptr(), out=out.data_ptr(),
        rhs_se=se, rhs_sk=sk, rhs_sn=sn, rows=lhs.shape[0],
        lhs_cols=lhs.shape[1], n_dim=other.shape[-1], experts=n_groups,
        bm=bm, lhs_dtype=_DTYPE_CODE[lhs.dtype],
        rhs_dtype=_DTYPE_CODE[other.dtype], **ptrs)


def _launch(entry: str, lhs, *args):
    lib = _lib()
    with torch.cuda.device(lhs.device):
        stream = torch.cuda.current_stream(lhs.device).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(
            f"grouped matmul kernel launch ({entry}) failed: "
            f"{lib.gmm_error_string(rc).decode()} (cudaError {rc})")


def _max_tiles(rows, n_groups):
    """Entries of K5's tile list: the tiles of the ``n_groups + 1`` groups
    (the sentinel last) number at most ``ceil(rows / 128) + n_groups``."""
    return -(-rows // _TILE_ROWS) + n_groups


def _gmm_tiles_plain(offsets_ext, rows):
    """The tile list's plain version (the source's ``gmm_tiles_kernel``)."""
    n_groups = offsets_ext.shape[0] - 2
    off = offsets_ext.to(torch.int64)
    lo = off[:-1].clamp(0, rows)
    hi = torch.maximum(off[1:].clamp(0, rows), lo)
    n = (hi - lo + _TILE_ROWS - 1) // _TILE_ROWS
    ends = torch.cumsum(n, 0)
    t = torch.arange(_max_tiles(rows, n_groups), device=off.device)
    g = torch.searchsorted(ends, t, right=True)  # the group of tile t
    used = g <= n_groups
    g = g.clamp(max=n_groups)
    row0 = lo[g] + (t - (ends - n)[g]) * _TILE_ROWS
    row1 = torch.minimum(row0 + _TILE_ROWS, hi[g])
    zero = torch.zeros_like(t)
    return torch.stack([torch.where(used, row0, zero),
                        torch.where(used, row1, zero),
                        torch.where(used, g, zero - 1)], 1).to(torch.int32)


def _gmm_tiles(offsets_ext, rows):
    """The bf16 kernel's tile list, int32 ``[ceil(rows / 128) + E, 3]``
    (K5's groups, or K7's from :func:`_aligned_offsets`): each group of
    ``offsets_ext`` (the E experts, then the sentinel group of rows past
    ``sum(group_sizes)``) cut into tiles of 128 rows from its first row,
    the last one partial, as (first row, past last row, group); unused
    entries are (0, 0, -1). Built on the tensor's device, with no host
    sync: by a one-block kernel for CUDA tensors."""
    if offsets_ext.device.type == "cpu":
        return _gmm_tiles_plain(offsets_ext, rows)
    groups = offsets_ext.shape[0] - 1
    tiles = torch.empty(_max_tiles(rows, groups - 1), 3, dtype=torch.int32,
                        device=offsets_ext.device)
    _launch("gmm_tiles_launch", offsets_ext, offsets_ext.data_ptr(), groups,
            rows, tiles.shape[0], tiles.data_ptr())
    return tiles


# how the bf16 kernel brings rhs in: the source's gmm90::Load codes
_RHS_LOAD = {"registers": 0, "tma": 1, "tma_k_major": 2}


def _gmm_loaders(lhs, rhs):
    """How the bf16 kernel of K5 and K7 brings each operand in: ``"tma"``
    where TMA can describe it (16-byte aligned base and row pitch; rhs
    contiguous), ``"tma_k_major"`` for rhs the transposed view
    ``[E, K, N]`` of a contiguous ``[E, N, K]`` (gmm_aligned's backward
    passes ``rhsᵀ``), else ``"registers"``. Returns (lhs's, rhs's)."""
    aligned = rhs.data_ptr() % 16 == 0
    _, K, N = rhs.shape
    tma_lhs = lhs.data_ptr() % 16 == 0 and lhs.shape[1] % 8 == 0
    if aligned and N % 8 == 0 and rhs.is_contiguous():
        rhs_load = "tma"
    elif aligned and K % 8 == 0 and rhs.stride() == (K * N, 1, K):
        rhs_load = "tma_k_major"
    else:
        rhs_load = "registers"
    return "tma" if tma_lhs else "registers", rhs_load


def _set_wgmma(params, lhs, rhs, offsets_ext):
    """Fill the bf16 kernel's fields: the tile list of ``offsets_ext``
    (held by ``params`` until the launch) and each operand's loader."""
    params.tile_list = _gmm_tiles(offsets_ext, lhs.shape[0])
    params.tiles = params.tile_list.data_ptr()
    params.max_tiles = params.tile_list.shape[0]
    tma_lhs, rhs_load = _gmm_loaders(lhs, rhs)
    params.tma_lhs, params.tma_rhs = int(tma_lhs == "tma"), _RHS_LOAD[rhs_load]


def _gmm_fwd(lhs, rhs, offsets_ext):
    """K5: ``out[rows_e] = lhs[rows_e] @ rhs[e]`` over group-sorted rows,
    ``[R, H]`` in lhs's dtype; rows past the groups are 0. ``rhs`` may be
    a strided view (gmm's backward passes ``rhsᵀ``)."""
    global launches_gmm
    _check_shapes(lhs, rhs, offsets_ext, rhs.shape[0] + 2)
    if _device(lhs, rhs, offsets_ext) == "cpu":
        return _gmm_plain(lhs, rhs, offsets_ext)
    _check_cuda("gmm", lhs, rhs, offsets_ext, _GMM_MIXES, False)
    out = torch.empty(lhs.shape[0], rhs.shape[2], dtype=lhs.dtype,
                      device=lhs.device)
    params = _params(lhs, rhs, out, rhs.shape[0], 1,
                     offsets=offsets_ext.data_ptr())
    if lhs.dtype == _BF16:  # the tensor-core kernel walks the tile list
        _set_wgmma(params, lhs, rhs, offsets_ext)
    _launch("gmm_launch", lhs, ctypes.byref(params))
    launches_gmm += 1
    return out


def _tgmm_loader(lhs, g):
    """How K6's kernel brings its f32 operands in: ``"tma"`` where TMA can
    describe both (16-byte aligned bases and row pitches, some rows), else
    ``"cp.async"`` (4- or 8-byte copies, any pitch)."""
    ok = lhs.shape[0] > 0 and all(
        t.data_ptr() % 16 == 0 and t.shape[1] % 4 == 0 for t in (lhs, g))
    return "tma" if ok else "cp.async"


def _tgmm_fwd(lhs, g, offsets_ext, n_groups):
    """K6: ``out[e] = lhs[rows_e]ᵀ @ g[rows_e]``, f32 ``[E, M, H]``; an
    empty expert is 0. On the card each f32 value is split into three
    bf16 values and six of the nine products run on the tensor cores."""
    global launches_tgmm
    _check_shapes(lhs, g, offsets_ext, n_groups + 2)
    if _device(lhs, g, offsets_ext) == "cpu":
        return _tgmm_plain(lhs, g, offsets_ext, n_groups)
    _check_cuda("tgmm", lhs, g, offsets_ext, _TGMM_MIXES, True)
    out = torch.empty(n_groups, lhs.shape[1], g.shape[1], dtype=_F32,
                      device=lhs.device)
    _launch("tgmm_launch", lhs, ctypes.byref(_params(
        lhs, g, out, n_groups, 1, offsets=offsets_ext.data_ptr(),
        tma_lhs=int(_tgmm_loader(lhs, g) == "tma"))))
    launches_tgmm += 1
    return out


def _aligned_offsets(block_experts, n_groups, bm):
    """The groups of K7's bf16 kernel, int32 ``[E + 2]`` as
    :func:`_offsets_ext`: expert e's rows are ``[bm · its first block,
    bm · past its last block)`` of the non-decreasing ``block_experts``
    (clamped to ``[0, E − 1]``, as the FMA kernel reads them), so the
    trailing blocks clamped to E − 1 are E − 1's rows and the sentinel
    group is empty. On the tensor's device, with no host sync."""
    be = block_experts.clamp(0, n_groups - 1)
    experts = torch.arange(n_groups + 1, dtype=torch.int32, device=be.device)
    offs = torch.searchsorted(be, experts, out_int32=True) * bm
    return torch.cat([offs, offs[-1:]])


def _gmm_aligned_fwd(lhs, rhs, block_experts, bm):
    """K7: block ``b`` of ``bm`` rows times ``rhs[block_experts[b]]``,
    ``[R, H]`` in lhs's dtype. ``rhs`` may be a strided view
    (gmm_aligned's backward passes ``rhsᵀ``)."""
    global launches_gmm_aligned
    _check_shapes(lhs, rhs, block_experts, lhs.shape[0] // bm)
    if _device(lhs, rhs, block_experts) == "cpu":
        return _gmm_aligned_plain(lhs, rhs, block_experts, bm)
    _check_cuda("gmm_aligned", lhs, rhs, block_experts, _GMM_MIXES, False)
    out = torch.empty(lhs.shape[0], rhs.shape[2], dtype=lhs.dtype,
                      device=lhs.device)
    params = _params(lhs, rhs, out, rhs.shape[0], bm,
                     block_experts=block_experts.data_ptr())
    if lhs.dtype == _BF16:  # K5's tensor-core kernel over the block runs
        _set_wgmma(params, lhs, rhs,
                   _aligned_offsets(block_experts, rhs.shape[0], bm))
    _launch("gmm_aligned_launch", lhs, ctypes.byref(params))
    launches_gmm_aligned += 1
    return out


def _tgmm_aligned_loader(lhs, g):
    """How K8's bf16 kernel brings its operands in: ``"tma"`` where TMA
    can describe both (16-byte aligned bases and row pitches, some rows),
    else ``"registers"``."""
    ok = lhs.shape[0] > 0 and all(
        t.data_ptr() % 16 == 0 and t.shape[1] % 8 == 0 for t in (lhs, g))
    return "tma" if ok else "registers"


def _tgmm_aligned_fwd(lhs, g, block_experts, n_groups, bm):
    """K8: ``out[e] = Σ over e's blocks of lhs_blockᵀ @ g_block``, f32
    ``[E, M, H]``. An expert that owns no block is left unwritten (as on
    the TPU): the caller replaces it. In bf16 on the tensor cores over
    the runs of :func:`_aligned_offsets`, summing at most 1024 rows in one
    accumulator (:func:`_tgmm_aligned_walk_plain` is the same walk in
    plain PyTorch); (f32, f32) on the FMA kernel."""
    global launches_tgmm_aligned
    _check_shapes(lhs, g, block_experts, lhs.shape[0] // bm)
    if _device(lhs, g, block_experts) == "cpu":
        return _tgmm_aligned_plain(lhs, g, block_experts, n_groups, bm)
    _check_cuda("tgmm_aligned", lhs, g, block_experts, _TGMM_ALIGNED_MIXES,
                True)
    out = torch.empty(n_groups, lhs.shape[1], g.shape[1], dtype=_F32,
                      device=lhs.device)
    params = _params(lhs, g, out, n_groups, bm,
                     block_experts=block_experts.data_ptr())
    if lhs.dtype == _BF16:  # wgmma over the runs of the block experts
        offs = _aligned_offsets(block_experts, n_groups, bm)
        params.offsets = offs.data_ptr()
        params.tma_lhs = int(_tgmm_aligned_loader(lhs, g) == "tma")
    _launch("tgmm_aligned_launch", lhs, ctypes.byref(params))
    launches_tgmm_aligned += 1
    return out


# ------------------------------- public API ---------------------------------
def _check_rows(name, rows, bm):
    if rows % bm:
        raise ValueError(f"{name} rows {rows} must divide block size {bm}")


class _Gmm(torch.autograd.Function):
    """Forward K5; backward (reference :409-416) with ``g`` in f32:
    ``d_lhs`` is K5 on ``g`` against ``rhsᵀ`` (a strided view), ``d_rhs``
    is K6 on f32 ``lhs`` and ``g``, both cast back to the input dtypes."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes):
        offs = _offsets_ext(group_sizes, lhs.shape[0])
        ctx.save_for_backward(lhs, rhs, offs)
        return _gmm_fwd(lhs, rhs, offs)

    @staticmethod
    def backward(ctx, g):
        lhs, rhs, offs = ctx.saved_tensors
        g = g.float().contiguous()
        d_lhs = _gmm_fwd(g, rhs.transpose(1, 2), offs)
        d_rhs = _tgmm_fwd(lhs.float().contiguous(), g, offs, rhs.shape[0])
        return d_lhs.to(lhs.dtype), d_rhs.to(rhs.dtype), None


class _GmmAligned(torch.autograd.Function):
    """Forward K7; backward (reference :364-374) in the input dtype:
    ``d_lhs`` is K7 on ``g`` against ``rhsᵀ``, ``d_rhs`` is K8, and the
    slab of an expert with no rows is replaced by 0 with ``where`` (never
    a multiply: it was never written)."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes, bm):
        n_groups = rhs.shape[0]
        be = _block_experts(group_sizes, lhs.shape[0] // bm, n_groups, bm)
        ctx.save_for_backward(lhs, rhs, group_sizes, be)
        ctx.bm = bm
        return _gmm_aligned_fwd(lhs, rhs, be, bm)

    @staticmethod
    def backward(ctx, g):
        lhs, rhs, group_sizes, be = ctx.saved_tensors
        bm = ctx.bm
        g = g.contiguous()
        d_lhs = _gmm_aligned_fwd(g, rhs.transpose(1, 2), be, bm)
        d_rhs = _tgmm_aligned_fwd(lhs, g, be, rhs.shape[0], bm)
        live = (group_sizes > 0)[:, None, None]
        d_rhs = torch.where(live, d_rhs, torch.zeros((), dtype=d_rhs.dtype,
                                                     device=d_rhs.device))
        return d_lhs.to(lhs.dtype), d_rhs.to(rhs.dtype), None, None


def gmm(lhs, rhs, group_sizes, bm: int = 512):
    """Grouped matmul: ``out[rows_of_group_e] = lhs[rows] @ rhs[e]``.

    ``lhs`` [R, M] with rows sorted by group (rows past
    ``sum(group_sizes)`` are padding and produce zeros); ``rhs`` [E, M,
    H]; ``group_sizes`` [E] int on lhs's device. R must divide by ``bm``.
    Returns [R, H] in lhs's dtype, accumulated in f32. Differentiable in
    lhs and rhs."""
    _check_rows("gmm", lhs.shape[0], bm)
    return _Gmm.apply(lhs, rhs, group_sizes)


def gmm_aligned(lhs, rhs, group_sizes, bm: int = 512):
    """Grouped matmul over the bm-aligned sorted layout: every
    ``group_sizes[e]`` is a multiple of ``bm`` (each group's rows padded
    up with zero rows), so one expert owns each block of ``bm`` rows.
    Returns [R, H] in lhs's dtype. Differentiable in lhs and rhs."""
    _check_rows("gmm_aligned", lhs.shape[0], bm)
    return _GmmAligned.apply(lhs, rhs, group_sizes, bm)


def tgmm(lhs, g, group_sizes, n_groups: int, bm: int = 512):
    """Transposed grouped matmul: ``out[e] = lhs[rows_e]ᵀ @ g[rows_e]``,
    f32 ``[n_groups, M, H]`` (gmm's backward uses the same kernel)."""
    _check_rows("tgmm", lhs.shape[0], bm)
    offs = _offsets_ext(group_sizes, lhs.shape[0])
    return _tgmm_fwd(lhs.float().contiguous(), g.float().contiguous(), offs,
                     n_groups)
