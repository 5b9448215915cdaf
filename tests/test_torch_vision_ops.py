"""``paddle_tpu_torch.vision.ops`` against the JAX package's
``vision.ops`` on the same numpy inputs, on the CPU in float32:
``box_area``/``box_iou`` at the reference test's rtol 1e-6, ``nms``
indices equal (score ties, categories, ``top_k``), ``roi_align`` (fixed
and adaptive sampling ratios, ``aligned`` both ways) values and the
feature map's gradient, and ``roi_pool`` values and gradient at rtol
1e-4, atol 1e-5 (``tests/test_vision_ops.py``), ``box_coder`` both
ways at 1e-4.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.vision.ops as JV
import paddle_tpu_torch.vision as tvision
import paddle_tpu_torch.vision.ops as TV

from test_torch_bridge import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.data if hasattr(t, "data") else t)


def _jax_map_side(fn, x, cot):
    """The reference's ``fn(x)`` and the gradient of ``sum(fn(x) * cot)``
    in the feature map ``x``, on its eager tape (its RoI ops read the
    boxes' counts as Python numbers, so they do not trace)."""
    xj = pt.to_tensor(x, stop_gradient=False)
    out = fn(xj)
    (out * pt.to_tensor(cot)).sum().backward()
    return _np(out), _np(xj.grad)


def _boxes(n, size=40.0, seed=0, lo=2.0):
    r = np.random.RandomState(seed)
    xy = r.uniform(0, size * 0.7, (n, 2))
    wh = r.uniform(lo, size * 0.5, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_box_area_and_iou():
    a, b = _boxes(7, seed=1), _boxes(5, seed=2)
    np.testing.assert_allclose(_np(TV.box_area(torch.from_numpy(a))),
                               _np(JV.box_area(pt.to_tensor(a))), rtol=1e-6)
    np.testing.assert_allclose(
        _np(TV.box_iou(torch.from_numpy(a), torch.from_numpy(b))),
        _np(JV.box_iou(pt.to_tensor(a), pt.to_tensor(b))), rtol=1e-6)
    assert tvision.ops is TV


@pytest.mark.parametrize("case", ["scores", "ties", "no_scores", "top_k",
                                  "categories", "all_categories",
                                  "unlisted"])
def test_nms_indices_equal_the_reference(case):
    """Kept indices equal, int64, in descending score order; tied scores
    keep index order (a stable descending sort, as the reference's
    ``argsort(-s)``); categories never suppress across, unlisted ones are
    dropped; nothing listed gives an empty result."""
    b = _boxes(60, seed=3)
    r = np.random.RandomState(4)
    s = r.rand(60).astype(np.float32)
    kw, jkw = {}, {}
    if case == "ties":
        s = np.round(s * 4).astype(np.float32) / 4
    if case != "no_scores":
        kw["scores"], jkw["scores"] = torch.from_numpy(s), pt.to_tensor(s)
    if case == "top_k":
        kw["top_k"] = jkw["top_k"] = 5
    if case in ("categories", "all_categories", "unlisted"):
        cat = r.randint(0, 4, 60).astype(np.int64)
        kw["category_idxs"] = torch.from_numpy(cat)
        jkw["category_idxs"] = pt.to_tensor(cat)
        listed = {"categories": [0, 2, 3], "all_categories": None,
                  "unlisted": [7]}[case]
        kw["categories"] = jkw["categories"] = listed
    t = TV.nms(torch.from_numpy(b), 0.3, **kw)
    j = JV.nms(pt.to_tensor(b), 0.3, **jkw)
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(_np(t), _np(j))
    if case == "unlisted":
        assert t.numel() == 0


def _feat(seed=5, shape=(2, 3, 12, 14)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("ratio,aligned", [(2, True), (-1, True),
                                           (3, False)])
def test_roi_align_equals_the_reference(ratio, aligned, monkeypatch):
    """Values and the feature map's gradient; boxes cross the map's edge
    (clipped samples). The chunk budget is cut so the RoIs go in several
    chunks, as they do on the card at detection sizes."""
    monkeypatch.setattr(TV, "_CHUNK_ELEMS", 200)
    x = _feat()
    boxes = np.concatenate([_boxes(4, 20, seed=6, lo=0.5),
                            _boxes(3, 20, seed=7) - 3]).astype(np.float32)
    num = np.array([4, 3], np.int32)
    cot = np.random.RandomState(8).randn(7, 3, 2, 3).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    out = TV.roi_align(xt, torch.from_numpy(boxes), torch.from_numpy(num),
                       (2, 3), spatial_scale=0.5, sampling_ratio=ratio,
                       aligned=aligned)
    (out * torch.from_numpy(cot)).sum().backward()
    outj, gj = _jax_map_side(lambda v: JV.roi_align(
        v, pt.to_tensor(boxes), pt.to_tensor(num), (2, 3), spatial_scale=0.5,
        sampling_ratio=ratio, aligned=aligned), x, cot)
    np.testing.assert_allclose(_np(out), outj, **TOL)
    np.testing.assert_allclose(_np(xt.grad), gj, **TOL)


def test_roi_pool_equals_the_reference(monkeypatch):
    """The hard maximum over every pixel of each cell, a box over the
    map's edge (clipped cells) and a one-pixel box; the gradient goes to
    each cell's maximum."""
    monkeypatch.setattr(TV, "_CHUNK_ELEMS", 300)
    x = _feat(9)
    boxes = np.concatenate([_boxes(5, 28, seed=10),
                            [[20, 18, 40, 30], [3, 3, 3, 3]]]).astype(
        np.float32)
    num = np.array([3, 4], np.int32)
    cot = np.random.RandomState(11).randn(7, 3, 3, 2).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    out = TV.roi_pool(xt, torch.from_numpy(boxes), torch.from_numpy(num),
                      (3, 2), spatial_scale=0.5)
    (out * torch.from_numpy(cot)).sum().backward()
    outj, gj = _jax_map_side(lambda v: JV.roi_pool(
        v, pt.to_tensor(boxes), pt.to_tensor(num), (3, 2), spatial_scale=0.5),
        x, cot)
    np.testing.assert_allclose(_np(out), outj, **TOL)
    np.testing.assert_allclose(_np(xt.grad), gj, **TOL)


@pytest.mark.parametrize("normalized", [True, False])
def test_box_coder_both_ways(normalized):
    """Encode all pairs against priors with variances, then decode along
    axis 0 and axis 1 (a ``[M, 4]`` variance broadcast), and without a
    variance; an unknown code type raises."""
    priors = _boxes(4, seed=12)
    targets = _boxes(3, seed=13)
    var = np.tile(np.array([0.1, 0.1, 0.2, 0.2], np.float32), (4, 1))
    deltas = np.random.RandomState(14).randn(3, 4, 4).astype(np.float32) / 4
    for args, kw in [
            ((priors, var, targets), dict(code_type="encode_center_size")),
            ((priors, var, deltas), dict(code_type="decode_center_size")),
            ((priors, var, deltas.transpose(1, 0, 2).copy()),
             dict(code_type="decode_center_size", axis=1)),
            ((priors, None, deltas), dict(code_type="decode_center_size"))]:
        t = TV.box_coder(*[None if a is None else torch.from_numpy(a)
                           for a in args], box_normalized=normalized, **kw)
        j = JV.box_coder(*[None if a is None else pt.to_tensor(a)
                           for a in args], box_normalized=normalized, **kw)
        np.testing.assert_allclose(_np(t), _np(j), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="code_type"):
        TV.box_coder(torch.from_numpy(priors), None,
                     torch.from_numpy(targets), code_type="encode")
