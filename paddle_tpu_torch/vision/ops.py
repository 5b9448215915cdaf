"""Detection ops of ``paddle.vision.ops`` (port of
``paddle_tpu/vision/ops.py``): ``box_area``, ``box_iou``, ``nms``,
``roi_align``, ``roi_pool`` and ``box_coder``, with the reference's
semantics, not those of Paddle's C++ kernels.

- ``nms`` suppresses in the order of a stable descending sort of the
  scores (the reference's ``argsort(-s)``), so equal scores keep index
  order. The IoU matrix is computed on the boxes' device and the greedy
  pass runs on the host over its rows (the reference's ``lax.scan``).
- ``roi_align``'s adaptive ``sampling_ratio`` is one ratio for all boxes:
  the ceiling of the largest cell over all boxes, capped at 8. Its
  bilinear corner gathers are ``[R, C, out·r, out·r]`` a corner, so the
  RoIs go in chunks of at most ``_CHUNK_ELEMS`` gathered values.
- ``roi_pool`` takes the hard maximum over every pixel of each cell,
  gathered as each cell's window of at most the largest cell's size.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import unwrap

__all__ = ["box_area", "box_iou", "nms", "roi_align", "roi_pool",
           "box_coder"]

#: the most gathered values one chunk of RoIs holds per corner or window
_CHUNK_ELEMS = 1 << 25


def _div(a, n):
    """``a / n`` by IEEE division on every device: PyTorch's CUDA kernels
    divide by a Python number through its reciprocal, which moves a
    sample point by an ulp and, at a cell's edge, its floor."""
    return a / torch.full((), n, dtype=a.dtype, device=a.device)


def box_area(boxes):
    """``[N, 4]`` xyxy -> ``[N]`` areas."""
    return (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])


def _iou_matrix(b1, b2):
    area1, area2 = box_area(b1), box_area(b2)
    lt = torch.maximum(b1[:, None, :2], b2[None, :, :2])
    rb = torch.minimum(b1[:, None, 2:], b2[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / torch.clamp(area1[:, None] + area2[None, :] - inter,
                               min=1e-10)


def box_iou(boxes1, boxes2):
    """Pairwise IoU, ``[N, M]``."""
    return _iou_matrix(boxes1, boxes2)


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """Greedy non-maximum suppression (reference :47-113): boxes in the
    order of a stable descending sort of ``scores`` (``N, N-1, ..., 1``
    when None); a box is kept unless a kept box before it overlaps it by
    IoU above ``iou_threshold``. With ``category_idxs`` and
    ``categories``, only boxes of a listed category take part and boxes
    of different categories never suppress each other (each category's
    boxes offset by ``max - min + 1`` of the listed boxes' coordinates).
    Returns the kept indices (int64, on the boxes' device), by descending
    score, at most ``top_k``."""
    boxes = unwrap(boxes)
    dev = boxes.device
    if scores is None:
        scores = torch.arange(boxes.shape[0], 0, -1, dtype=torch.float32,
                              device=dev)
    scores = unwrap(scores)
    keep_map = None
    if category_idxs is not None and categories is not None:
        cat = unwrap(category_idxs).to(dev)
        listed = torch.as_tensor(np.asarray(categories), device=dev)
        keep_map = torch.nonzero(torch.isin(cat, listed))[:, 0]
        if keep_map.numel() == 0:
            return torch.zeros((0,), dtype=torch.int64, device=dev)
        boxes, scores = boxes[keep_map], scores[keep_map]
        category_idxs = cat[keep_map]
    if category_idxs is not None:
        cat = unwrap(category_idxs).to(dev)
        span = boxes.max() - boxes.min() + 1
        boxes = boxes + cat.to(boxes.dtype)[:, None] * span
    order = torch.argsort(-scores, stable=True)
    b = boxes[order]
    over = (_iou_matrix(b, b) > iou_threshold).cpu().numpy()
    removed = np.zeros(len(over), bool)
    kept = []
    for i in range(len(over)):
        if not removed[i]:
            kept.append(i)
            removed |= over[i]
    out = order[torch.as_tensor(kept, dtype=torch.int64, device=dev)]
    if keep_map is not None:
        out = keep_map[out]
    if top_k is not None:
        out = out[:top_k]
    return out.to(torch.int64)


def _output_hw(output_size):
    if isinstance(output_size, int):
        return output_size, output_size
    return tuple(int(s) for s in output_size)


def _batch_of_rois(boxes_num, device):
    bn = unwrap(boxes_num).to(device).long()
    return torch.repeat_interleave(torch.arange(bn.shape[0], device=device),
                                   bn)


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """RoIAlign (reference :116-205): in each box (scaled by
    ``spatial_scale``, shifted by half a pixel when ``aligned``) a regular
    grid of ``out·r`` by ``out·r`` points is sampled bilinearly (indices
    and weights clipped to the map) and each output cell averages its
    ``r × r`` samples. ``x`` ``[N, C, H, W]``, ``boxes`` ``[R, 4]`` xyxy,
    ``boxes_num`` ``[N]`` RoIs per image -> ``[R, C, out_h, out_w]``,
    differentiable in ``x``. ``sampling_ratio <= 0`` takes one ratio for
    every box: the ceiling of the largest cell side over all boxes,
    capped at 8."""
    out_h, out_w = _output_hw(output_size)
    if sampling_ratio > 0:
        ratio = int(sampling_ratio)
    else:
        b = unwrap(boxes).detach().float().cpu().numpy()
        cell = max(float(np.max(b[:, 3] - b[:, 1])) * spatial_scale / out_h,
                   float(np.max(b[:, 2] - b[:, 0])) * spatial_scale / out_w,
                   1.0)
        ratio = int(min(math.ceil(cell), 8))
    H, W = x.shape[2], x.shape[3]
    off = 0.5 if aligned else 0.0
    rois = boxes * spatial_scale - off
    rw = torch.clamp(rois[:, 2] - rois[:, 0], min=1e-3 if aligned else 1.0)
    rh = torch.clamp(rois[:, 3] - rois[:, 1], min=1e-3 if aligned else 1.0)
    kw = dict(device=x.device, dtype=rois.dtype)
    gy = _div(torch.arange(out_h * ratio, **kw) + 0.5, ratio)
    gx = _div(torch.arange(out_w * ratio, **kw) + 0.5, ratio)
    ys = rois[:, 1, None] + _div(rh[:, None] * gy[None, :], out_h)
    xs = rois[:, 0, None] + _div(rw[:, None] * gx[None, :], out_w)
    batch = _batch_of_rois(boxes_num, x.device)
    feat = x.permute(0, 2, 3, 1)  # [N, H, W, C]: a gather reads C at once
    per_roi = out_h * ratio * out_w * ratio * x.shape[1]
    step = max(1, _CHUNK_ELEMS // per_roi)
    outs = [_align_chunk(feat, batch[i:i + step], ys[i:i + step],
                         xs[i:i + step], H, W, out_h, out_w, ratio)
            for i in range(0, boxes.shape[0], step)]
    if not outs:
        return x.new_zeros((0, x.shape[1], out_h, out_w))
    return torch.cat(outs)


def _align_chunk(feat, batch, ys, xs, H, W, out_h, out_w, ratio):
    """The reference's per-RoI ``bilinear`` for a chunk of RoIs."""
    y0 = torch.clamp(torch.floor(ys), 0, H - 1)
    x0 = torch.clamp(torch.floor(xs), 0, W - 1)
    wy = (torch.clamp(ys, 0, H - 1) - y0)[:, :, None, None].to(feat.dtype)
    wx = (torch.clamp(xs, 0, W - 1) - x0)[:, None, :, None].to(feat.dtype)
    y0i, x0i = y0.long(), x0.long()
    y1i = torch.clamp(y0i + 1, max=H - 1)
    x1i = torch.clamp(x0i + 1, max=W - 1)
    b = batch[:, None, None]

    def at(yi, xi):  # [r, Sh, Sw, C]
        return feat[b, yi[:, :, None], xi[:, None, :]]

    s = (at(y0i, x0i) * ((1 - wy) * (1 - wx)) + at(y0i, x1i) * ((1 - wy) * wx)
         + at(y1i, x0i) * (wy * (1 - wx)) + at(y1i, x1i) * (wy * wx))
    r, C = s.shape[0], s.shape[-1]
    s = s.reshape(r, out_h, ratio, out_w, ratio, C).mean(dim=(2, 4))
    return s.permute(0, 3, 1, 2)


def _cells(start, span, n_cells, size):
    """Each cell's pixel range ``[lo, hi)`` along one axis (reference
    ``cell_mask``): ``floor(start + span·i/n)`` to ``ceil(start +
    span·(i+1)/n)``, at least one pixel, clipped to ``[0, size]``."""
    i = torch.arange(n_cells, dtype=torch.float32, device=start.device)
    lo = torch.floor(start[:, None] + _div(span[:, None] * i[None],
                                           n_cells))
    hi = torch.ceil(start[:, None] + _div(span[:, None] * (i[None] + 1),
                                          n_cells))
    lo = torch.clamp(lo, 0, size)
    hi = torch.clamp(torch.maximum(hi, lo + 1), 0, size)
    return lo.long(), hi.long()


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
             name=None):
    """RoIPool (reference :208-262): each box rounded (half to even) to
    pixels after ``spatial_scale``, ``w = max(x2 - x1 + 1, 1)`` (same for
    h), cut into ``out_h × out_w`` cells (:func:`_cells`), and the
    maximum over every pixel of a cell taken; an empty cell gives 0.
    Each cell's window is gathered at the largest cell's size over all
    boxes, pixels past its end read as -inf."""
    out_h, out_w = _output_hw(output_size)
    H, W = x.shape[2], x.shape[3]
    r = torch.round(boxes.float() * spatial_scale)
    rw = torch.clamp(r[:, 2] - r[:, 0] + 1, min=1.0)
    rh = torch.clamp(r[:, 3] - r[:, 1] + 1, min=1.0)
    ylo, yhi = _cells(r[:, 1], rh, out_h, H)  # [R, out_h]
    xlo, xhi = _cells(r[:, 0], rw, out_w, W)
    kh = max(int((yhi - ylo).max()), 1) if boxes.shape[0] else 1
    kw = max(int((xhi - xlo).max()), 1) if boxes.shape[0] else 1
    batch = _batch_of_rois(boxes_num, x.device)
    feat = x.permute(0, 2, 3, 1)  # [N, H, W, C]
    per_roi = out_h * kh * out_w * kw * x.shape[1]
    step = max(1, _CHUNK_ELEMS // per_roi)
    outs = []
    for i in range(0, boxes.shape[0], step):
        sl = slice(i, i + step)
        yy = ylo[sl, :, None] + torch.arange(kh, device=x.device)
        xx = xlo[sl, :, None] + torch.arange(kw, device=x.device)
        ok = ((yy < yhi[sl, :, None])[:, :, :, None, None]
              & (xx < xhi[sl, :, None])[:, None, None, :, :])
        v = feat[batch[sl, None, None, None, None],
                 torch.clamp(yy, max=H - 1)[:, :, :, None, None],
                 torch.clamp(xx, max=W - 1)[:, None, None, :, :]]
        v = torch.where(ok[..., None], v, torch.full(
            (), float("-inf"), dtype=v.dtype, device=v.device))
        m = torch.amax(v, dim=(2, 4))  # [r, out_h, out_w, C]
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        outs.append(m.permute(0, 3, 1, 2))
    if not outs:
        return x.new_zeros((0, x.shape[1], out_h, out_w))
    return torch.cat(outs)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0,
              name=None):
    """SSD-style box coding against priors (reference :265-316).
    ``encode_center_size``: target ``[N, 4]`` against prior ``[M, 4]``
    -> ``[N, M, 4]`` offsets (all pairs), divided by ``prior_box_var``.
    ``decode_center_size``: target ``[N, M, 4]`` (or ``[N, 4]``) with the
    prior broadcast along ``axis`` (0: prior indexed by M; 1: by N) ->
    boxes of the target's shape. Unnormalised boxes count ``+1`` in
    widths and heights."""
    if code_type not in ("encode_center_size", "decode_center_size"):
        raise ValueError(
            f"unknown code_type '{code_type}'; expected "
            "'encode_center_size' or 'decode_center_size'")
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    norm = 0.0 if box_normalized else 1.0
    pb, tb = prior_box, target_box
    pbv = prior_box_var
    pw = pb[..., 2] - pb[..., 0] + norm
    ph = pb[..., 3] - pb[..., 1] + norm
    pcx = (pb[..., 0] + pb[..., 2]) / 2
    pcy = (pb[..., 1] + pb[..., 3]) / 2
    if code_type == "encode_center_size":
        tw = (tb[:, 2] - tb[:, 0] + norm)[:, None]
        th = (tb[:, 3] - tb[:, 1] + norm)[:, None]
        tcx = ((tb[:, 0] + tb[:, 2]) / 2)[:, None]
        tcy = ((tb[:, 1] + tb[:, 3]) / 2)[:, None]
        out = torch.stack([(tcx - pcx[None]) / pw[None],
                           (tcy - pcy[None]) / ph[None],
                           torch.log(tw / pw[None]),
                           torch.log(th / ph[None])], dim=-1)
        return out / pbv if pbv is not None else out
    if tb.dim() == 3:
        def expand(a):
            return a[None, :] if axis == 0 else a[:, None]
        pw, ph, pcx, pcy = map(expand, (pw, ph, pcx, pcy))
        if pbv is not None and pbv.dim() == 2:
            pbv = pbv[None, :, :] if axis == 0 else pbv[:, None, :]
    t = tb * pbv if pbv is not None else tb
    cx = t[..., 0] * pw + pcx
    cy = t[..., 1] * ph + pcy
    w = torch.exp(t[..., 2]) * pw
    h = torch.exp(t[..., 3]) * ph
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2 - norm,
                        cy + h / 2 - norm], dim=-1)
