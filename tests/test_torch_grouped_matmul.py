"""The port's grouped matmul against the JAX package's, on the CPU.

The same numpy inputs go through ``paddle_tpu``'s ``gmm``, ``gmm_aligned``
and ``tgmm`` (their Pallas kernels in interpret mode, as
``tests/test_grouped_matmul.py`` runs them) and through the port's,
whose wrappers compute their plain versions for CPU tensors. The cases
are the reference test's: E, M, H, bm = 4, 64, 32, 8, with empty
experts, one-row groups and a group holding nearly every row. Tolerances
are the reference test's too: atol 1e-4 for forward outputs and 1e-3 for
gradients, float32. Pad rows and empty experts must be exactly 0.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import grouped_matmul as jgm
from paddle_tpu_torch.ops.pallas import grouped_matmul as tgm

from test_torch_bridge import one_torch_thread  # noqa: F401

E, M, H, BM = 4, 64, 32, 8
FWD_ATOL, GRAD_ATOL = 1e-4, 1e-3
RAGGED = [[5, 0, 11, 3], [8, 8, 8, 8], [0, 0, 30, 2], [1, 1, 1, 1]]
ALIGNED = [[16, 0, 24, 8], [8, 8, 8, 8], [0, 0, 40, 0]]


def _inputs(seed, rows, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return (rng.randn(rows, M).astype(dtype), rng.randn(E, M, H).astype(dtype),
            rng.randn(rows, H).astype(dtype))


def _jax_grads(fn, lhs, rhs, proj, gs, rows=None):
    """Output and gradients of ``sum(fn(lhs, rhs)[:rows] * proj[:rows])``
    through the JAX package's custom_vjp."""
    def loss(a, b):
        out = fn(a, b, jnp.asarray(gs), bm=BM)
        return (out[:rows] * jnp.asarray(proj)[:rows]).sum()
    a, b = jnp.asarray(lhs), jnp.asarray(rhs)
    out = fn(a, b, jnp.asarray(gs), bm=BM)
    gl, gr = jax.grad(loss, argnums=(0, 1))(a, b)
    return np.asarray(out), np.asarray(gl), np.asarray(gr)


def _port_grads(fn, lhs, rhs, proj, gs, rows=None):
    a = torch.from_numpy(lhs).requires_grad_()
    b = torch.from_numpy(rhs).requires_grad_()
    out = fn(a, b, torch.from_numpy(gs), bm=BM)
    (out[:rows] * torch.from_numpy(proj)[:rows]).sum().backward()
    return out.detach().numpy(), a.grad.numpy(), b.grad.numpy()


@pytest.mark.parametrize("sizes", RAGGED)
def test_gmm_forward_and_gradients_match_jax(sizes):
    gs = np.array(sizes, np.int32)
    lhs, rhs, proj = _inputs(sum(sizes), 40)
    want = _jax_grads(jgm.gmm, lhs, rhs, proj, gs)
    got = _port_grads(tgm.gmm, lhs, rhs, proj, gs)
    np.testing.assert_allclose(got[0], want[0], atol=FWD_ATOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL)
    # rows past sum(group_sizes) are padding: exactly 0, and so is their
    # gradient; an empty expert's d_rhs is exactly 0
    assert np.all(got[0][gs.sum():] == 0) and np.all(got[1][gs.sum():] == 0)
    assert all(np.all(got[2][e] == 0) for e in range(E) if gs[e] == 0)


@pytest.mark.parametrize("sizes", RAGGED)
def test_tgmm_matches_jax(sizes):
    gs = np.array(sizes, np.int32)
    lhs, _, g = _inputs(sum(sizes) + 7, 40)
    want = np.asarray(jgm.tgmm(jnp.asarray(lhs), jnp.asarray(g),
                               jnp.asarray(gs), E, bm=BM))
    got = tgm.tgmm(torch.from_numpy(lhs), torch.from_numpy(g),
                   torch.from_numpy(gs), E, bm=BM)
    assert got.dtype == torch.float32 and got.shape == (E, M, H)
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_ATOL)
    assert all(bool((got[e] == 0).all()) for e in range(E) if gs[e] == 0)


@pytest.mark.parametrize("sizes", ALIGNED)
def test_gmm_aligned_forward_and_gradients_match_jax(sizes):
    """The bm-aligned layout: pad rows of lhs are 0. Outputs and lhs
    gradients are compared on the data rows (the reference test's
    loss), rhs gradients everywhere: an expert with no rows gets exactly
    0, never what the kernel left unwritten."""
    gs = np.array(sizes, np.int32)
    lhs, rhs, proj = _inputs(sum(sizes) + 1, 48)
    n = int(gs.sum())
    lhs[n:] = 0
    want = _jax_grads(jgm.gmm_aligned, lhs, rhs, proj, gs, rows=n)
    got = _port_grads(tgm.gmm_aligned, lhs, rhs, proj, gs, rows=n)
    np.testing.assert_allclose(got[0][:n], want[0][:n], atol=FWD_ATOL)
    np.testing.assert_allclose(got[1][:n], want[1][:n], atol=GRAD_ATOL)
    np.testing.assert_allclose(got[2], want[2], atol=GRAD_ATOL)
    assert np.all(got[0][n:] == 0)  # zero pad rows give zero rows
    assert all(np.all(got[2][e] == 0) for e in range(E) if gs[e] == 0)


@pytest.mark.parametrize("sizes,rows", [
    ([16, 0, 24, 8], 48), ([0, 0, 40, 0], 48), ([8, 0, 0, 8], 48),
    ([0, 8, 8, 0], 64), ([32, 0, 0, 0], 40), ([0, 0, 0, 0], 16)])
def test_block_experts_and_offsets_match_jax(sizes, rows):
    """``searchsorted(side="right")`` gives a block after an empty expert
    to the next expert, and trailing pad blocks clamp to E-1."""
    gs = np.array(sizes, np.int32)
    want = np.asarray(jgm._block_experts(jnp.asarray(gs), rows // BM, E, BM))
    got = tgm._block_experts(torch.from_numpy(gs), rows // BM, E, BM)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tgm._offsets_ext(torch.from_numpy(gs), rows).numpy(),
        np.asarray(jgm._offsets_ext(jnp.asarray(gs), rows)))


def test_bfloat16_follows_the_reference_dtypes():
    """bf16 inputs: gmm and gmm_aligned return bf16 and give bf16
    gradients, computed in f32 and rounded once (gmm's backward in f32,
    gmm_aligned's in the input dtype); tgmm is always f32. Both sides
    round f32 results to bf16: one bf16 unit apart at most."""
    gs = np.array([5, 0, 11, 3], np.int32)
    lhs, rhs, proj = _inputs(3, 40)
    bf = [jnp.asarray(a).astype(jnp.bfloat16) for a in (lhs, rhs)]
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (lhs, rhs)]
    for jfn, tfn in ((jgm.gmm, tgm.gmm), (jgm.gmm_aligned, tgm.gmm_aligned)):
        sizes = gs if jfn is jgm.gmm else np.array([8, 0, 16, 16], np.int32)

        def jloss(a, b):
            return (jfn(a, b, jnp.asarray(sizes), bm=BM).astype(jnp.float32)
                    * jnp.asarray(proj)).sum()
        jout = jfn(*bf, jnp.asarray(sizes), bm=BM)
        jg = jax.grad(jloss, argnums=(0, 1))(*bf)
        a, b = (t.clone().requires_grad_() for t in tb)
        out = tfn(a, b, torch.from_numpy(sizes), bm=BM)
        (out.float() * torch.from_numpy(proj)).sum().backward()
        assert out.dtype == a.grad.dtype == b.grad.dtype == torch.bfloat16
        for got, want in ((out, jout), (a.grad, jg[0]), (b.grad, jg[1])):
            want = np.asarray(want.astype(jnp.float32))
            np.testing.assert_allclose(got.detach().float().numpy(), want,
                                       rtol=2 ** -7, atol=1e-2)
    t = tgm.tgmm(tb[0], torch.from_numpy(proj).to(torch.bfloat16),
                 torch.from_numpy(gs), E, bm=BM)
    assert t.dtype == torch.float32


@pytest.mark.parametrize("fn", ["gmm", "gmm_aligned", "tgmm"])
def test_rows_must_divide_the_block(fn):
    gs = torch.tensor([10, 0, 0, 0], dtype=torch.int32)
    lhs = torch.zeros(10, M)
    other = torch.zeros(10, H) if fn == "tgmm" else torch.zeros(E, M, H)
    args = (E,) if fn == "tgmm" else ()
    with pytest.raises(ValueError, match="divide"):
        getattr(tgm, fn)(lhs, other, gs, *args, bm=BM)
    with pytest.raises(ValueError, match="divide"):
        getattr(jgm, fn)(jnp.zeros((10, M)), jnp.asarray(other.numpy()),
                         jnp.asarray(gs.numpy()), *args, bm=BM)


def test_cpu_calls_count_no_launch_and_mixed_devices_raise():
    counts = (tgm.launches_gmm, tgm.launches_tgmm, tgm.launches_gmm_aligned,
              tgm.launches_tgmm_aligned)
    lhs, rhs, proj = (torch.from_numpy(a) for a in _inputs(0, 16))
    gs = torch.tensor([8, 0, 8, 0], dtype=torch.int32)
    for fn in (tgm.gmm, tgm.gmm_aligned):
        a = lhs.clone().requires_grad_()
        (fn(a, rhs, gs, bm=BM) * proj).sum().backward()
    tgm.tgmm(lhs, proj, gs, E, bm=BM)
    assert (tgm.launches_gmm, tgm.launches_tgmm, tgm.launches_gmm_aligned,
            tgm.launches_tgmm_aligned) == counts
    with pytest.raises(ValueError, match="one device"):
        tgm.gmm(lhs, rhs.to("meta"), gs, bm=BM)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tgm.gmm(lhs.to("meta"), rhs.to("meta"), gs.to("meta"), bm=BM)


# ------------------------------ K5's tile list ------------------------------
# (R, group sizes): the card tests' cases (tests/test_torch_kernels.py) and
# chip_smoke.py phase 8(b)'s, then seeded random ones
TILE_CASES = {
    "mixed": (1024, [100, 0, 300, 1, 1, 0, 400, 150]),
    "hot_expert": (1024, [0, 1, 922, 0, 1, 50, 50, 0]),
    "tail_rows_not_zero": (1024, [100, 0, 300, 1, 1, 0, 200, 150]),
    "one_expert": (1024, [1000]),
    "edges_mid_tile": (1024, [37, 1, 90, 0, 129, 1, 255, 300]),
    "smoke_hot_empty_single": (4096, [1, 1, 0, 3686, 0, 0, 0, 1, 0, 200,
                                      0, 1, 0, 0, 0, 206]),
    "smoke_tail": (4096, [300, 0, 500, 1000, 0, 700, 400, 100]),
    "smoke_widths_1000_333": (2048, [256, 300, 0, 200, 512, 80, 300, 400]),
    "smoke_one_expert": (2048, [1900]),
    "all_empty": (256, [0, 0, 0]),
    "exact_multiples": (512, [128, 256, 0, 128]),
}
for _seed in range(4):
    _rng = np.random.RandomState(_seed)
    _e = int(_rng.randint(1, 70))
    _sizes = _rng.multinomial(int(_rng.randint(0, 3000)),
                              np.ones(_e) / _e).tolist()
    TILE_CASES[f"random_{_seed}"] = (-(-sum(_sizes) // 64) * 64 + 64 * _seed,
                                     _sizes)


def _tiles_by_loops(sizes, rows):
    """The tile list written as loops: each group (then the sentinel
    group of rows past the data) cut into 128-row tiles from its start."""
    out, start = [], 0
    for g, n in enumerate(list(sizes) + [rows - sum(sizes)]):
        for r in range(start, start + n, 128):
            out.append((r, min(r + 128, start + n), g))
        start += n
    return out


@pytest.mark.parametrize("name", sorted(TILE_CASES))
def test_gmm_tile_list_covers_every_row_once(name):
    """Every row of lhs lies in exactly one tile, no tile crosses a group
    edge, the sentinel group's rows come last, and the list has at most
    ceil(R / 128) + E entries (R / 128 + E when 128 divides R)."""
    rows, sizes = TILE_CASES[name]
    E = len(sizes)
    offs = tgm._offsets_ext(torch.tensor(sizes, dtype=torch.int32), rows)
    tiles = tgm._gmm_tiles(offs, rows)
    assert tiles.dtype == torch.int32
    assert tiles.shape == (-(-rows // 128) + E, 3)
    used = [tuple(t) for t in tiles.tolist() if t[0] < t[1]]
    assert used == _tiles_by_loops(sizes, rows)
    unused = tiles[len(used):].tolist()
    assert unused == [[0, 0, -1]] * len(unused)
    hits = np.zeros(rows, np.int64)
    edges = np.concatenate([[0], np.cumsum(sizes), [rows]])
    for r0, r1, g in used:
        assert 0 < r1 - r0 <= 128
        assert edges[g] <= r0 and r1 <= edges[g + 1]
        hits[r0:r1] += 1
    assert (hits == 1).all()


# ------------------------ K7's tile list on the card ------------------------
# group sizes in blocks of bm; two trailing blocks past the groups hold data
# and clamp to expert E-1, as _block_experts gives them
ALIGNED_BLOCKS = {"mixed": [2, 0, 3, 1], "one_hot": [0, 0, 5, 0],
                  "all_one": [1, 1, 1, 1]}


@pytest.mark.parametrize("bm", [32, 64, 128, 256])
@pytest.mark.parametrize("name", sorted(ALIGNED_BLOCKS))
def test_aligned_tile_list_follows_the_block_runs(name, bm):
    """K7's bf16 kernel walks the tile list of ``_aligned_offsets``: every
    row (the trailing rows too) lies in exactly one tile, a tile never
    crosses a run of equal block experts and multiplies by that run's
    expert, and the sentinel group is empty. Multiplying each tile's rows
    by its expert's matrix gives the reference's ``gmm_aligned`` forward
    and the port's plain version."""
    sizes = [n * bm for n in ALIGNED_BLOCKS[name]]
    rows = sum(sizes) + 2 * bm
    gs = torch.tensor(sizes, dtype=torch.int32)
    be = tgm._block_experts(gs, rows // bm, E, bm)
    offs = tgm._aligned_offsets(be, E, bm)
    runs = np.concatenate([[0], np.cumsum(sizes), [rows]])
    runs[E] = rows  # the trailing blocks are E-1's
    np.testing.assert_array_equal(offs.numpy(), np.append(runs[:E + 1], rows))
    tiles = tgm._gmm_tiles(offs, rows)
    used = [tuple(t) for t in tiles.tolist() if t[0] < t[1]]
    assert used == _tiles_by_loops(np.diff(runs[:E + 1]), rows)
    hits = np.zeros(rows, np.int64)
    be_rows = np.repeat(be.numpy(), bm)
    for r0, r1, g in used:
        assert g < E and 0 < r1 - r0 <= 128
        assert (be_rows[r0:r1] == g).all()
        hits[r0:r1] += 1
    assert (hits == 1).all()
    lhs, rhs, _ = _inputs(bm + len(name), rows)  # data in every row
    lt, rt = torch.from_numpy(lhs), torch.from_numpy(rhs)
    got = torch.empty(rows, H)
    for r0, r1, g in used:
        got[r0:r1] = lt[r0:r1] @ rt[g]
    np.testing.assert_allclose(
        got.numpy(), tgm._gmm_aligned_plain(lt, rt, be, bm).numpy(),
        rtol=1e-5, atol=1e-5)
    want = np.asarray(jgm._gmm_aligned_fwd(
        jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(be.numpy()), bm))
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_ATOL)


# --------------------- K6's split arithmetic, emulated ----------------------
def _split(x, n_parts=3):
    """x = h + m + l (or h + m) in bf16 values, each difference exact in
    f32 (the kernel's split, rounding to nearest even); returned as f32."""
    parts = []
    for _ in range(n_parts):
        b = x.to(torch.bfloat16).float()
        parts.append(b)
        x = x - b
    return parts


def _tf32(x):
    """x rounded to TF32's 10 stored mantissa bits, to nearest."""
    a = x.numpy().view(np.uint32).astype(np.uint64)
    return torch.from_numpy(((a + 0x1000) & 0xFFFFE000).astype(np.uint32)
                            .view(np.float32))


def _tgmm_emulated(lhs, g, sizes, scheme):
    """``out[e] = lhs[rows_e]ᵀ @ g[rows_e]`` with the products of
    ``scheme`` summed in f32: "split" is K6's design (six products of the
    three-way bf16 split: hh, hm, mh, hl, lh, mm); "split2" the three
    products of a two-way split (hh, hm, mh); "bf16" and "tf32" one
    product of the operands rounded so."""
    out = torch.zeros(len(sizes), lhs.shape[1], g.shape[1])
    o = 0
    for e, n in enumerate(sizes):
        a, b = lhs[o:o + n], g[o:o + n]
        o += n
        if scheme == "split":
            (ah, am, al), (bh, bm_, bl) = _split(a), _split(b)
            pairs = ((am, bm_), (ah, bl), (al, bh), (ah, bm_), (am, bh),
                     (ah, bh))
        elif scheme == "split2":
            (ah, am), (bh, bm_) = _split(a, 2), _split(b, 2)
            pairs = ((ah, bm_), (am, bh), (ah, bh))
        elif scheme == "bf16":
            pairs = ((a.to(torch.bfloat16).float(),
                      b.to(torch.bfloat16).float()),)
        else:
            pairs = ((_tf32(a), _tf32(b)),)
        for x, y in pairs:
            out[e] += x.t() @ y
    return out


@pytest.mark.parametrize("sizes", RAGGED)
def test_tgmm_split_scheme_meets_the_f32_tolerance(sizes):
    """K6's arithmetic on the CPU: within the reference test's atol of the
    JAX ``tgmm`` and within 1e-5 of the largest |out| of the port's plain
    version (the card's limit is 1e-4); an empty expert is exactly 0."""
    gs = np.array(sizes, np.int32)
    lhs, _, g = _inputs(sum(sizes) + 11, 40)
    got = _tgmm_emulated(torch.from_numpy(lhs), torch.from_numpy(g), sizes,
                         "split")
    want = np.asarray(jgm.tgmm(jnp.asarray(lhs), jnp.asarray(g),
                               jnp.asarray(gs), E, bm=BM))
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_ATOL)
    plain = tgm._tgmm_plain(torch.from_numpy(lhs), torch.from_numpy(g),
                            tgm._offsets_ext(torch.from_numpy(gs), 40), E)
    assert float((got - plain).abs().max()) <= 1e-5 * float(plain.abs().max())
    assert all(bool((got[e] == 0).all()) for e in range(E) if gs[e] == 0)


@pytest.mark.parametrize("scheme", ["bf16", "tf32"])
def test_one_rounded_product_misses_the_f32_tolerance(scheme):
    """Why K6 splits: one product of operands rounded to bf16 or to TF32
    misses the card's limit of 1e-4 of the largest |out|."""
    sizes = [600, 0, 900, 548]
    lhs, _, g = (torch.from_numpy(a) for a in _inputs(5, sum(sizes)))
    plain = tgm._tgmm_plain(lhs, g, tgm._offsets_ext(
        torch.tensor(sizes, dtype=torch.int32), sum(sizes)), E)
    err = (_tgmm_emulated(lhs, g, sizes, scheme) - plain).abs().max()
    assert float(err) > 1e-4 * float(plain.abs().max())


def test_two_way_split_misses_the_reference_atol():
    """Why K6 splits into three planes and not two: the two-way split's
    three products miss the reference test's atol against the JAX
    ``tgmm`` on its ragged shapes, where the three-way split meets it
    with ten times room."""
    err = {"split": 0.0, "split2": 0.0}
    for sizes in RAGGED:
        gs = np.array(sizes, np.int32)
        lhs, _, g = _inputs(sum(sizes) + 11, 40)
        want = np.asarray(jgm.tgmm(jnp.asarray(lhs), jnp.asarray(g),
                                   jnp.asarray(gs), E, bm=BM))
        for scheme in err:
            got = _tgmm_emulated(torch.from_numpy(lhs), torch.from_numpy(g),
                                 sizes, scheme)
            err[scheme] = max(err[scheme],
                              float(np.abs(got.numpy() - want).max()))
    assert err["split"] <= FWD_ATOL / 10
    assert err["split2"] > FWD_ATOL


# ---------------------- K8's bf16 walk, in plain PyTorch ---------------------
@pytest.mark.parametrize("sizes,bm", [
    ([16, 0, 24, 8], 8), ([0, 0, 40, 0], 8), ([1152, 0, 128, 64], 64)])
def test_tgmm_aligned_walk_matches_jax(one_torch_thread, sizes, bm):
    """K8's bf16 design: the (expert, 128 lhs columns, 128 g columns)
    items over the runs of ``_aligned_offsets``, the accumulators
    restarted every 1024 rows (the 1152-row expert sums two chunks) and
    each chunk added to the output tile in f32, against the JAX
    ``_tgmm_aligned_fwd`` (interpret mode) on the experts that own a
    block, at the reference test's atol; an expert with no block is left
    unwritten."""
    gs = np.array(sizes, np.int32)
    rows = int(gs.sum()) + bm  # a trailing block, clamped to E - 1
    lhs, _, g = _inputs(bm + rows, rows)
    be = tgm._block_experts(torch.from_numpy(gs), rows // bm, E, bm)
    want = np.asarray(jgm._tgmm_aligned_fwd(
        jnp.asarray(lhs), jnp.asarray(g), jnp.asarray(be.numpy()), E, bm))
    got = tgm._tgmm_aligned_walk_plain(torch.from_numpy(lhs),
                                       torch.from_numpy(g), be, E, bm)
    owns = np.isin(np.arange(E), be.numpy())
    np.testing.assert_allclose(got.numpy()[owns], want[owns], atol=FWD_ATOL)
    assert bool(torch.isnan(got[torch.from_numpy(~owns)]).all())
    if max(sizes) > tgm._FLUSH_ROWS:  # more than one accumulator chunk
        np.testing.assert_allclose(
            got.numpy()[owns],
            tgm._tgmm_aligned_plain(torch.from_numpy(lhs),
                                    torch.from_numpy(g), be, E,
                                    bm).numpy()[owns], atol=FWD_ATOL)
