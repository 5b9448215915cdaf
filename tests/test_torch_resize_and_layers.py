"""The layer leftovers of the port against the JAX package, on the CPU in
float32: the 24 functionals of ``nn/functional.py`` and 12 of
``nn/functional_extras.py`` that the port lacked, the nineteen layers of
``nn/layer/common.py`` and nine of ``nn/layer/loss.py``,
``nn.utils`` (weight norm, the parameter/vector helpers, the in-place
clips), pooling padding over half the window and the raises the port
pins.

Inputs are made from a numpy seed; weights cross through the bridge
(``state_dict_from_jax`` -> ``load_numpy_state``). Outputs and the
gradients of ``sum(out * cot)`` are held at the tolerance of the
reference's ``tests/test_layers.py`` (rtol 1e-4, atol 1e-5; gradients
twice that), and ``interpolate`` in every mode for 3-D, 4-D and 5-D
inputs, up, down and by non-integer factors, against
``jax.image.resize`` through the reference. Random layers (the dropouts,
``gumbel_softmax``) draw from each package's own generator, so they are
held by their structure and statistics.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.utils.bridge import load_numpy_state

from test_torch_bridge import one_torch_thread  # noqa: F401
from test_torch_bridge import state_dict_from_jax

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.data if hasattr(t, "data") else t)


def _x(*shape, seed=0, lo=None):
    r = np.random.RandomState(seed)
    if lo is not None:
        return r.uniform(lo, 1.0, shape).astype(np.float32)
    return r.randn(*shape).astype(np.float32)


def _jax_side(jfn, arrays, grad, cot):
    """The reference's output and the gradients of ``sum(out * cot)`` in
    ``arrays[i]`` for ``i`` in ``grad``, traced as one jitted program
    (``jax.grad`` over the package's function on wrapped tracers): one
    compile a case instead of one for each eager op and its vjp."""
    def f(*arrs):
        return jfn(*[pt.Tensor(a) for a in arrs]).data

    out = jax.jit(f)(*arrays)
    if not grad:
        return out, []
    c = cot(out.shape)
    g = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) * c), argnums=grad))(
        *arrays)
    return out, list(g)


def _cot(shape):
    return np.random.RandomState(9).uniform(0.5, 1.5, shape).astype(
        np.float32)


def _both(jfn, tfn, arrays, grad=(0,)):
    """``fn(*arrays)`` in both packages; the outputs, and the gradients in
    ``arrays[i]`` for ``i`` in ``grad`` of ``sum(out * cot)``."""
    jout, jgrads = _jax_side(jfn, [np.array(a) for a in arrays], grad, _cot)
    t_in = [torch.from_numpy(np.array(a)).requires_grad_(i in grad)
            for i, a in enumerate(arrays)]
    tout = tfn(*t_in)
    if grad:
        (tout * torch.from_numpy(_cot(tuple(tout.shape)))).sum().backward()
    return (_np(tout), np.asarray(jout),
            [(_np(t_in[i].grad), np.asarray(jg))
             for i, jg in zip(grad, jgrads)])


def _check(res, fwd=FWD, grad=GRAD):
    t, j, grads = res
    assert t.shape == j.shape, (t.shape, j.shape)
    np.testing.assert_allclose(t, j, **fwd)
    for tg, jg in grads:
        np.testing.assert_allclose(tg, jg, **grad)


# ------------------------------------------------------------ interpolate
_NATURAL = {3: "linear", 4: "bilinear", 5: "trilinear"}
_SHAPES = {3: (2, 3, 11), 4: (1, 2, 9, 13), 5: (1, 2, 5, 6, 7)}
_SIZES = {  # (size, scale_factor): up, down, a non-integer factor
    3: [((23,), None), ((4,), None), (None, 1.7)],
    4: [((20, 29), None), ((4, 5), None), (None, 0.6)],
    5: [((9, 13, 15), None), ((3, 2, 4), None), (None, [1.5, 0.7, 1.3])],
}


@pytest.mark.parametrize("ndim", [3, 4, 5])
@pytest.mark.parametrize("mode", ["nearest", "natural", "bicubic", "area"])
@pytest.mark.parametrize("which", [0, 1, 2], ids=["up", "down", "factor"])
def test_interpolate_equals_jax_image_resize(ndim, mode, which):
    """Every mode, up and down by size and by a non-integer factor: the
    values and the input gradient equal the reference's
    ``jax.image.resize`` (antialiased when shrinking)."""
    mode = _NATURAL[ndim] if mode == "natural" else mode
    size, sf = _SIZES[ndim][which]
    x = _x(*_SHAPES[ndim], seed=ndim)
    fmt = {3: "NCW", 4: "NCHW", 5: "NCDHW"}[ndim]
    _check(_both(
        lambda v: JF.interpolate(v, size=size, scale_factor=sf, mode=mode,
                                 data_format=fmt),
        lambda v: F.interpolate(v, size=size, scale_factor=sf, mode=mode,
                                data_format=fmt), [x]))


def test_interpolate_channel_last_and_upsample():
    x = _x(2, 7, 5, 3, seed=1)
    _check(_both(
        lambda v: JF.upsample(v, size=(12, 4), mode="bilinear",
                              data_format="NHWC"),
        lambda v: F.upsample(v, size=(12, 4), mode="bilinear",
                             data_format="NHWC"), [x]))


def test_interpolate_refuses_align_corners():
    """The reference never reads ``align_corners``: ``True`` raises, and
    so does ``UpsamplingBilinear2D``, which always passes it (reference
    ``nn/layer/common.py:183``), and ``Upsample(align_mode=1)`` as in the
    reference."""
    x = torch.zeros(1, 1, 4, 4)
    with pytest.raises(NotImplementedError, match="align_corners"):
        F.interpolate(x, size=(8, 8), mode="bilinear", align_corners=True)
    with pytest.raises(NotImplementedError, match="align_corners"):
        tnn.UpsamplingBilinear2D(size=(8, 8))
    with pytest.raises(NotImplementedError, match="align_corners"):
        tnn.Upsample(size=(8, 8), mode="bilinear", align_corners=True)
    with pytest.raises(NotImplementedError, match="align_mode"):
        tnn.Upsample(size=(8, 8), align_mode=1)
    with pytest.raises(NotImplementedError, match="align_mode"):
        jnn.Upsample(size=(8, 8), align_mode=1)


def test_upsample_layers_equal_the_reference():
    x = _x(1, 2, 6, 5, seed=2)
    for jl, tl in [(jnn.Upsample(scale_factor=2, mode="bicubic"),
                    tnn.Upsample(scale_factor=2, mode="bicubic")),
                   (jnn.UpsamplingNearest2D(size=(9, 3)),
                    tnn.UpsamplingNearest2D(size=(9, 3)))]:
        _check(_both(jl, tl, [x]))


# ---------------------------------------------- functionals with no weight
_CASES = {
    "swiglu_one": (lambda m: lambda v: m.swiglu(v), [(4, 12)]),
    "swiglu_two": (lambda m: lambda a, b: m.swiglu(a, b), [(4, 6), (4, 6)]),
    "label_smooth": (lambda m: lambda v: m.label_smooth(v, epsilon=0.2),
                     [(4, 6)]),
    "cosine_similarity": (lambda m: lambda a, b: m.cosine_similarity(
        a, b, axis=1), [(4, 6, 3), (4, 6, 3)]),
    "pairwise_distance": (lambda m: lambda a, b: m.pairwise_distance(
        a, b, p=3.0, keepdim=True), [(4, 6), (4, 6)]),
    "pairwise_inf": (lambda m: lambda a, b: m.pairwise_distance(
        a, b, p=float("inf")), [(4, 6), (4, 6)]),
    "normalize": (lambda m: lambda v: m.normalize(v, p=2, axis=1),
                  [(3, 5, 2)]),
    "normalize_p1": (lambda m: lambda v: m.normalize(v, p=1, axis=-1),
                     [(4, 6)]),
    "temporal_shift": (lambda m: lambda v: m.temporal_shift(
        v, seg_num=3, shift_ratio=0.25), [(6, 8, 2, 3)]),
    "pixel_shuffle": (lambda m: lambda v: m.pixel_shuffle(v, 2),
                      [(2, 8, 3, 4)]),
    "pixel_unshuffle": (lambda m: lambda v: m.pixel_unshuffle(v, 2),
                        [(2, 2, 6, 4)]),
    "channel_shuffle": (lambda m: lambda v: m.channel_shuffle(v, 3),
                        [(2, 6, 3, 2)]),
    "unfold": (lambda m: lambda v: m.unfold(v, [3, 2], strides=[2, 1],
                                            paddings=1, dilations=[1, 2]),
               [(2, 3, 7, 8)]),
    "fold": (lambda m: lambda v: m.fold(v, [6, 7], 3, strides=2,
                                        paddings=1), [(2, 18, 12)]),
    "margin_ranking": (lambda m: lambda a, b, t: m.margin_ranking_loss(
        a, b, t, margin=0.3), [(4,), (4,), "sign4"]),
    "hinge_embedding": (lambda m: lambda a, t: m.hinge_embedding_loss(
        a, t, margin=0.8, reduction="sum"), [(4, 6), "sign46"]),
    "cosine_embedding": (lambda m: lambda a, b, t: m.cosine_embedding_loss(
        a, b, t, margin=0.1), [(4, 6), (4, 6), "sign4"]),
    "triplet": (lambda m: lambda a, p, n: m.triplet_margin_loss(
        a, p, n, margin=0.5, reduction="none"), [(4, 6), (4, 6), (4, 6)]),
    "triplet_swap": (lambda m: lambda a, p, n: m.triplet_margin_loss(
        a, p, n, p=1.0, swap=True), [(4, 6), (4, 6), (4, 6)]),
    "log_loss": (lambda m: lambda p, t: m.log_loss(p, t), ["prob", "prob"]),
    "pad_reflect": (lambda m: lambda v: m.pad(v, [1, 2, 2, 1],
                                              mode="reflect"),
                    [(1, 2, 5, 6)]),
    "pad_all_axes": (lambda m: lambda v: m.pad(v, [0, 0, 1, 0, 2, 3],
                                               value=0.5), [(2, 3, 4)]),
    "zeropad2d": (lambda m: lambda v: m.zeropad2d(v, [1, 0, 2, 1]),
                  [(1, 2, 3, 4)]),
    "diag_embed": (lambda m: lambda v: m.diag_embed(v, offset=1),
                   [(2, 3)]),
    "diag_embed_dims": (lambda m: lambda v: m.diag_embed(
        v, offset=-1, dim1=-1, dim2=0), [(2, 3)]),
    "affine_grid": (lambda m: lambda t: m.affine_grid(t, [2, 1, 4, 5]),
                    [(2, 2, 3)]),
    "affine_grid_centres": (lambda m: lambda t: m.affine_grid(
        t, [2, 1, 3, 6], align_corners=False), [(2, 2, 3)]),
    "poisson_nll": (lambda m: lambda x, y: m.poisson_nll_loss(x, y),
                    [(4, 6), "counts"]),
    "poisson_nll_full": (lambda m: lambda x, y: m.poisson_nll_loss(
        x, y, log_input=False, full=True, reduction="sum"),
        ["prob", "counts"]),
    "multilabel_soft_margin": (
        lambda m: lambda x, y, w: m.multi_label_soft_margin_loss(
            x, y, w, reduction="none"), [(4, 6), "bits46", "prob6"]),
    "focal": (lambda m: lambda x, y: m.sigmoid_focal_loss(x, y),
              [(4, 6), "bits46"]),
    "focal_norm": (lambda m: lambda x, y, n: m.sigmoid_focal_loss(
        x, y, n, alpha=-1, gamma=1.5, reduction="mean"),
        [(4, 6), "bits46", "prob1"]),
    "dice": (lambda m: lambda x, y: m.dice_loss(x, y), ["simplex", "ids"]),
    "npair": (lambda m: lambda a, p, y: m.npair_loss(a, p, y),
              [(4, 6), (4, 6), "labels4"]),
    "gaussian_nll": (lambda m: lambda x, y, v: m.gaussian_nll_loss(
        x, y, v, full=True), [(4, 6), (4, 6), "prob46"]),
}


def _array(spec, seed):
    r = np.random.RandomState(seed)
    named = {
        "sign4": lambda: np.where(r.rand(4) > 0.5, 1.0, -1.0),
        "sign46": lambda: np.where(r.rand(4, 6) > 0.5, 1.0, -1.0),
        "prob": lambda: r.uniform(0.05, 0.95, (4, 6)),
        "prob6": lambda: r.uniform(0.5, 1.5, (6,)),
        "prob1": lambda: np.array([2.5]),
        "prob46": lambda: r.uniform(0.2, 2.0, (4, 6)),
        "counts": lambda: r.randint(0, 5, (4, 6)),
        "bits46": lambda: (r.rand(4, 6) > 0.5),
        "labels4": lambda: np.array([0, 1, 0, 2], np.int64),
    }
    if spec == "simplex":
        a = r.uniform(0.1, 1.0, (3, 4, 5))
        return (a / a.sum(-1, keepdims=True)).astype(np.float32)
    if spec == "ids":
        return r.randint(0, 5, (3, 4, 1)).astype(np.int64)
    if isinstance(spec, str):
        a = named[spec]()
        return a if a.dtype == np.int64 else a.astype(np.float32)
    return r.randn(*spec).astype(np.float32)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_functional_equals_the_reference(case):
    make, specs = _CASES[case]
    arrays = [_array(s, 10 + i) for i, s in enumerate(specs)]
    grad = tuple(i for i, (s, a) in enumerate(zip(specs, arrays))
                 if a.dtype == np.float32 and s not in (
                     "sign4", "sign46", "bits46", "counts", "prob1"))
    _check(_both(make(JF), make(F), arrays, grad))


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample_equals_the_reference(mode, padding_mode,
                                          align_corners):
    """Through ``affine_grid``, a rotation and scale that sends samples
    outside the input; the gradients in the image and (bilinear) in the
    grid. Nearest rounds half to even, as the reference's ``round``."""
    x = _x(2, 3, 6, 7, seed=3)
    th = np.array([[[0.9, -0.5, 0.1], [0.4, 1.1, -0.2]],
                   [[1.3, 0.2, 0.3], [-0.3, 0.8, 0.05]]], np.float32)
    grid = _np(JF.affine_grid(pt.to_tensor(th), [2, 3, 5, 4],
                              align_corners=align_corners))
    grad = (0, 1) if mode == "bilinear" else (0,)
    _check(_both(
        lambda v, g: JF.grid_sample(v, g, mode, padding_mode, align_corners),
        lambda v, g: F.grid_sample(v, g, mode, padding_mode, align_corners),
        [x, grid.astype(np.float32)], grad))


def test_small_maps_without_gradients():
    """``one_hot`` (float32), ``sequence_mask`` (the reference's default
    "int64" is int32 under JAX's 32-bit default, the port's int64: the
    values are compared) and ``bilinear`` with its bias."""
    ids = np.array([[0, 3], [2, 1]], np.int64)
    t, j = F.one_hot(torch.from_numpy(ids), 5), JF.one_hot(
        pt.to_tensor(ids), 5)
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(_np(t), _np(j))
    lens = np.array([3, 0, 5], np.int64)
    for maxlen in (None, 7):
        t = F.sequence_mask(torch.from_numpy(lens), maxlen)
        j = JF.sequence_mask(pt.to_tensor(lens), maxlen)
        assert t.dtype == torch.int64
        np.testing.assert_array_equal(_np(t), _np(j))
    t = F.sequence_mask(torch.from_numpy(lens), dtype="float32")
    assert t.dtype == torch.float32
    a, b = _x(4, 3, seed=4), _x(4, 5, seed=5)
    w, bias = _x(2, 3, 5, seed=6), _x(1, 2, seed=7)
    _check(_both(JF.bilinear, F.bilinear, [a, b, w, bias], (0, 1, 2, 3)))


def test_channel_last_formats_the_reference_ignores_raise():
    x = torch.zeros(1, 4, 4, 4)
    for fn, args in [(F.pixel_shuffle, (2,)), (F.pixel_unshuffle, (2,)),
                     (F.channel_shuffle, (2,)), (F.temporal_shift, (1,))]:
        with pytest.raises(NotImplementedError, match="NCHW"):
            fn(x, *args, data_format="NHWC")
    for cls, arg in [(tnn.PixelShuffle, 2), (tnn.PixelUnshuffle, 2),
                     (tnn.ChannelShuffle, 2)]:
        with pytest.raises(NotImplementedError, match="NCHW"):
            cls(arg, data_format="NHWC")
    with pytest.raises(NotImplementedError, match="dilations"):
        F.fold(torch.zeros(1, 9, 4), [4, 4], 3, dilations=2)
    with pytest.raises(NotImplementedError, match="dilations"):
        tnn.Fold([4, 4], 3, dilations=2)


# ----------------------------------------------------------- random ones
def test_dropouts_and_gumbel_by_structure_and_statistics():
    """Whole channels dropped (``dropout2d``/``3d``, channel-last too);
    ``alpha_dropout`` keeps the mean and variance of a unit normal; eval
    mode equals the reference's; ``gumbel_softmax`` samples are
    distributions, its hard form one-hot with the soft gradient, and its
    picks follow ``softmax(x)``."""
    ptt.seed(0)
    x = torch.ones(64, 32, 3, 4)
    y = F.dropout2d(x, 0.5)
    per = y.reshape(64, 32, -1)
    assert torch.all((per == 0).all(-1) | (per == 2).all(-1))
    assert 0.4 < (per[..., 0] == 0).float().mean() < 0.6
    y = F.dropout2d(torch.ones(8, 3, 4, 16), 0.5, data_format="NHWC")
    assert torch.all((y == 0).all(1).all(1) | (y == 2).all(1).all(1))
    y = F.dropout3d(torch.ones(16, 8, 2, 3, 4), 0.25).reshape(16, 8, -1)
    assert torch.all((y == 0).all(-1) | (y == 4 / 3).all(-1))
    z = torch.randn(200000, generator=torch.Generator().manual_seed(1))
    a = F.alpha_dropout(z, 0.2)
    assert abs(float(a.mean())) < 0.01 and abs(float(a.std()) - 1) < 0.01
    xs = _x(3, 4, seed=8)
    for jl, tl in [(jnn.Dropout2D(0.5), tnn.Dropout2D(0.5)),
                   (jnn.Dropout3D(0.5), tnn.Dropout3D(0.5)),
                   (jnn.AlphaDropout(0.5), tnn.AlphaDropout(0.5))]:
        jl.eval()
        tl.eval()
        x4 = xs.reshape(1, 3, 4, 1) if "3D" not in type(tl).__name__ \
            else xs.reshape(1, 3, 4, 1, 1)
        _check(_both(jl, tl, [x4]))
    logits = torch.tensor([[2.0, 0.0, -1.0, 0.5]]).repeat(40000, 1)
    soft = F.gumbel_softmax(logits, temperature=0.5)
    np.testing.assert_allclose(_np(soft.sum(-1)), 1.0, rtol=1e-5)
    freq = torch.bincount(soft.argmax(-1), minlength=4).float() / 40000
    np.testing.assert_allclose(_np(freq), _np(torch.softmax(logits[0], -1)),
                               atol=0.01)
    lg = logits[:3].clone().requires_grad_()
    hard = F.gumbel_softmax(lg, hard=True, axis=1)
    assert torch.all(hard.sum(-1) == 1) and torch.all(
        (hard == 0) | (hard == 1))
    (hard * torch.arange(4.0)).sum().backward()
    assert lg.grad.abs().sum() > 0


# ----------------------------------------------------------------- layers
def test_common_layers_equal_the_reference():
    cases = [
        (jnn.Pad1D([1, 2], mode="replicate"),
         tnn.Pad1D([1, 2], mode="replicate"), [(2, 3, 5)]),
        (jnn.Pad2D(1, value=0.3), tnn.Pad2D(1, value=0.3), [(1, 2, 3, 4)]),
        (jnn.Pad3D([1, 0, 0, 1, 1, 1], mode="circular"),
         tnn.Pad3D([1, 0, 0, 1, 1, 1], mode="circular"), [(1, 2, 3, 3, 3)]),
        (jnn.ZeroPad2D([0, 1, 2, 0]), tnn.ZeroPad2D([0, 1, 2, 0]),
         [(1, 2, 3, 4)]),
        (jnn.CosineSimilarity(axis=-1), tnn.CosineSimilarity(axis=-1),
         [(4, 5), (4, 5)]),
        (jnn.PairwiseDistance(p=1.5), tnn.PairwiseDistance(p=1.5),
         [(4, 5), (4, 5)]),
        (jnn.Unfold(2, strides=2), tnn.Unfold(2, strides=2), [(1, 2, 4, 6)]),
        (jnn.Fold([4, 6], 2, strides=2), tnn.Fold([4, 6], 2, strides=2),
         [(1, 8, 6)]),
        (jnn.PixelShuffle(3), tnn.PixelShuffle(3), [(1, 9, 2, 2)]),
        (jnn.PixelUnshuffle(2), tnn.PixelUnshuffle(2), [(1, 1, 4, 4)]),
        (jnn.ChannelShuffle(2), tnn.ChannelShuffle(2), [(1, 4, 2, 2)]),
        (jnn.LabelSmooth(0.3), tnn.LabelSmooth(0.3), [(3, 4)]),
    ]
    for i, (jl, tl, specs) in enumerate(cases):
        arrays = [_x(*s, seed=20 + i + k) for k, s in enumerate(specs)]
        _check(_both(jl, tl, arrays, tuple(range(len(arrays)))))


def test_bilinear_layer_bridged_weights():
    jl = jnn.Bilinear(3, 4, 2)
    tl = tnn.Bilinear(3, 4, 2, device="cpu")
    assert tl.weight.shape == (2, 3, 4) and tl.bias.shape == (1, 2)
    load_numpy_state(tl, state_dict_from_jax(jl))
    a, b = _x(5, 3, seed=30), _x(5, 4, seed=31)
    _check(_both(jl, tl, [a, b], (0, 1)))
    (tl(torch.from_numpy(a), torch.from_numpy(b))).sum().backward()
    assert tl.weight.grad is not None and tl.bias.grad is not None
    assert tnn.Bilinear(3, 4, 2, bias_attr=False, device="cpu").bias is None


_LOSSES = [
    ("MarginRankingLoss", dict(margin=0.2), [(4,), (4,), "sign4"]),
    ("CosineEmbeddingLoss", dict(margin=0.3, reduction="sum"),
     [(4, 6), (4, 6), "sign4"]),
    ("TripletMarginLoss", dict(margin=0.4, swap=True),
     [(4, 6), (4, 6), (4, 6)]),
    ("HingeEmbeddingLoss", dict(margin=0.5), [(4, 6), "sign46"]),
    ("SoftMarginLoss", dict(), [(4, 6), "sign46"]),
    ("SoftMarginLoss", dict(reduction="none"), [(4, 6), "sign46"]),
    ("LogLoss", dict(epsilon=1e-3), ["prob", "prob"]),
    ("PoissonNLLLoss", dict(full=True), [(4, 6), "counts"]),
    ("GaussianNLLLoss", dict(reduction="sum"), [(4, 6), (4, 6), "prob46"]),
    ("MultiLabelSoftMarginLoss", dict(), [(4, 6), "bits46"]),
]


@pytest.mark.parametrize("i", range(len(_LOSSES)),
                         ids=[f"{n}{i}" for i, (n, _, _) in
                              enumerate(_LOSSES)])
def test_loss_layers_equal_the_reference(i):
    name, kw, specs = _LOSSES[i]
    arrays = [_array(s, 40 + k) for k, s in enumerate(specs)]
    grad = tuple(k for k, s in enumerate(specs) if not isinstance(s, str)
                 or s == "prob46")
    _check(_both(getattr(jnn, name)(**kw), getattr(tnn, name)(**kw),
                 arrays, grad))


# ------------------------------------------------------------- pooling pad
@pytest.mark.parametrize("case", [
    ("max", 2, dict(kernel_size=2, stride=1, padding=2)),
    ("max", 1, dict(kernel_size=3, stride=2, padding=3, ceil_mode=True)),
    ("avg", 2, dict(kernel_size=3, stride=2, padding=2)),
    ("avg", 2, dict(kernel_size=2, stride=1, padding=[2, 1],
                    exclusive=False)),
    ("avg", 1, dict(kernel_size=2, padding=2, ceil_mode=True)),
    ("avg", 3, dict(kernel_size=2, stride=2, padding=2, ceil_mode=True)),
], ids=["max2d", "max1d_ceil", "avg2d", "avg2d_inclusive", "avg1d_ceil",
        "avg3d_ceil"])
def test_pooling_padding_over_half_the_window(case):
    """Padding PyTorch's pools refuse is padded explicitly: -inf for max,
    and for an exclusive average the reference's divisor (the count of
    input elements in each window)."""
    mode, nd, kw = case
    shape = {1: (2, 3, 7), 2: (1, 2, 5, 6), 3: (1, 2, 3, 4, 5)}[nd]
    name = f"{mode}_pool{nd}d"
    x = _x(*shape, seed=50)
    _check(_both(lambda v: getattr(JF, name)(v, **kw),
                 lambda v: getattr(F, name)(v, **kw), [x]))


# ----------------------------------------------------------- nn.utils
def test_weight_norm_equals_the_reference_and_removes():
    """``weight_norm`` on a Conv2D (``weight_g`` ``[out, 1, 1, 1]``,
    ``weight_v``) and on a Linear over all axes (``dim=None``): the
    forward and every parameter's gradient equal the reference's on
    bridged parameters; ``remove_weight_norm`` folds them back."""
    for jl, tl, x, dim in [
            (jnn.Conv2D(3, 4, 3), tnn.Conv2D(3, 4, 3, device="cpu"),
             _x(2, 3, 6, 6, seed=60), 0),
            (jnn.Linear(5, 3), tnn.Linear(5, 3, device="cpu"),
             _x(4, 5, seed=61), None)]:
        jnn.utils.weight_norm(jl, dim=dim)
        tnn.utils.weight_norm(tl, dim=dim)
        assert sorted(n for n, _ in tl.named_parameters()) == sorted(
            n for n, _ in jl.named_parameters())
        load_numpy_state(tl, state_dict_from_jax(jl))
        xt = torch.from_numpy(x)
        out = tl(xt)
        out.sum().backward()
        xj = pt.to_tensor(x)
        outj = jl(xj)
        outj.sum().backward()
        np.testing.assert_allclose(_np(out), _np(outj), **FWD)
        jg = {n: _np(p.grad) for n, p in jl.named_parameters()}
        for n, p in tl.named_parameters():
            np.testing.assert_allclose(_np(p.grad), jg[n], **GRAD)
        tnn.utils.remove_weight_norm(tl)
        assert "weight" in dict(tl.named_parameters())
        np.testing.assert_allclose(_np(tl(xt)), _np(outj), **FWD)


def test_parameters_vector_round_trip_and_clips():
    """``parameters_to_vector``/``vector_to_parameters`` equal the
    reference's; ``clip_grad_norm_`` (2, 3 and inf norms) and
    ``clip_grad_value_`` give the reference's norms and gradients, and
    are exported from ``nn`` and ``nn.utils`` as the reference's."""
    shapes = [(3, 2), (4,), (2, 2, 2)]
    vals = [_x(*s, seed=70 + i) for i, s in enumerate(shapes)]
    tp = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in vals]
    jp = [pt.Parameter(v.copy()) for v in vals]
    vec = tnn.utils.parameters_to_vector(tp)
    np.testing.assert_array_equal(
        _np(vec), _np(jnn.utils.parameters_to_vector(jp)))
    new = _x(vec.numel(), seed=79)
    tnn.utils.vector_to_parameters(torch.from_numpy(new), tp)
    jnn.utils.vector_to_parameters(pt.to_tensor(new), jp)
    for t, j in zip(tp, jp):
        np.testing.assert_array_equal(_np(t), _np(j))
    assert tnn.clip_grad_norm_ is tnn.utils.clip_grad_norm_
    for norm_type, max_norm in [(2.0, 0.5), (3.0, 100.0),
                                (float("inf"), 0.3)]:
        grads = [_x(*s, seed=80 + i) for i, s in enumerate(shapes)]
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g.copy())
        for p, g in zip(jp, grads):
            p.grad = pt.to_tensor(g)
        tn = tnn.clip_grad_norm_(tp, max_norm, norm_type)
        jn = jnn.utils.clip_grad_norm_(jp, max_norm, norm_type)
        np.testing.assert_allclose(_np(tn), _np(jn), **FWD)
        for t, j in zip(tp, jp):
            np.testing.assert_allclose(_np(t.grad), _np(j.grad), **FWD)
    tnn.utils.clip_grad_value_(tp, 0.2)
    jnn.utils.clip_grad_value_(jp, 0.2)
    for t, j in zip(tp, jp):
        np.testing.assert_allclose(_np(t.grad), _np(j.grad), **FWD)
    with pytest.raises(RuntimeError, match="non-finite"):
        tp[0].grad[0, 0] = float("nan")
        tnn.clip_grad_norm_(tp, 1.0, error_if_nonfinite=True)
    assert float(tnn.clip_grad_norm_([torch.nn.Parameter(
        torch.zeros(2))], 1.0)) == 0.0


def test_weight_norm_conv_trains_under_clip_grad_norm():
    """The card's census in small: a weight-normed conv takes three SGD
    steps under ``clip_grad_norm_`` in both packages, from bridged
    parameters, to equal parameters."""
    jl, tl = jnn.Conv2D(3, 4, 3), tnn.Conv2D(3, 4, 3, device="cpu")
    jnn.utils.weight_norm(jl)
    tnn.utils.weight_norm(tl)
    load_numpy_state(tl, state_dict_from_jax(jl))
    x = _x(2, 3, 6, 6, seed=90)
    for _ in range(3):
        out = tl(torch.from_numpy(x))
        (out ** 2).mean().backward()
        tnn.clip_grad_norm_(list(tl.parameters()), 0.1)
        with torch.no_grad():
            for p in tl.parameters():
                p -= 0.5 * p.grad
                p.grad = None
        outj = jl(pt.to_tensor(x))
        (outj ** 2).mean().backward()
        params = [p for _, p in jl.named_parameters()]
        jnn.utils.clip_grad_norm_(params, 0.1)
        for p in params:
            p.set_value(_np(p) - 0.5 * _np(p.grad))
            p.grad = None
    jv = dict((n, _np(p)) for n, p in jl.named_parameters())
    for n, p in tl.named_parameters():
        np.testing.assert_allclose(_np(p), jv[n], **FWD)
