"""ASP, automatic structured (n:m) sparsity — port of
``paddle_tpu/incubate/asp/__init__.py`` (Paddle's ``incubate/asp``:
``asp.py`` ``decorate``/``prune_model``, ``utils.py``'s mask makers).

The masks are computed in numpy as the reference computes them, the
weights pruned in place, and a decorated optimizer multiplies each
pruned weight by its mask after every step, so the sparsity survives
training. The products stay dense: the reference has no sparse product,
and neither has the port.
"""
from __future__ import annotations

import weakref
from typing import Dict, List

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import unwrap

__all__ = ["calculate_density", "decorate", "prune_model",
           "set_excluded_layers", "reset_excluded_layers",
           "get_mask_1d", "get_mask_2d_greedy", "check_mask_1d",
           "ASPHelper", "OptimizerWithSparsityGuarantee"]

# every registry holds weak references: CPython reuses ids, so a dead
# model or parameter must drop out rather than alias a new object, and a
# mask must not keep its parameter alive
_excluded: Dict[int, tuple] = {}     # id(model) -> (weakref, [names])
_masks: Dict[int, tuple] = {}        # id(model) -> (weakref, {name: mask})
_param_masks: Dict[int, tuple] = {}  # id(param) -> (weakref, mask)


def _live(registry: Dict[int, tuple], key) -> bool:
    entry = registry.get(key)
    if entry is None:
        return False
    if entry[0]() is None:
        del registry[key]
        return False
    return True


def _prune_dead(registry: Dict[int, tuple]):
    for key in [k for k, (ref, _) in registry.items() if ref() is None]:
        del registry[key]


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return unwrap(x).detach().float().cpu().numpy()
    return np.asarray(x)


def calculate_density(x) -> float:
    """The fraction of nonzero entries."""
    arr = _numpy(x)
    return float((arr != 0).sum()) / max(arr.size, 1)


def get_mask_1d(mat: np.ndarray, n: int = 2, m: int = 4) -> np.ndarray:
    """Keep the ``n`` largest magnitudes in every group of ``m`` along
    the last axis."""
    flat = np.asarray(mat).reshape(-1, m)
    order = np.argsort(-np.abs(flat), axis=1)
    mask = np.zeros_like(flat, dtype=bool)
    np.put_along_axis(mask, order[:, :n], True, axis=1)
    return mask.reshape(np.shape(mat))


def check_mask_1d(mat: np.ndarray, n: int = 2, m: int = 4) -> bool:
    flat = (_numpy(mat) != 0).reshape(-1, m)
    return bool((flat.sum(axis=1) <= n).all())


def get_mask_2d_greedy(mat: np.ndarray, n: int = 2, m: int = 4) -> np.ndarray:
    """A greedy 2-D n:m mask: at most ``n`` nonzeros in each ``m``-group
    along both axes of every ``m x m`` block, largest magnitudes first."""
    mat = np.asarray(mat)
    h, w = mat.shape
    mask = np.zeros_like(mat, dtype=bool)
    absm = np.abs(mat)
    for i0 in range(0, h, m):
        for j0 in range(0, w, m):
            blk = absm[i0:i0 + m, j0:j0 + m]
            bm = np.zeros_like(blk, dtype=bool)
            row_cnt = np.zeros(blk.shape[0], dtype=int)
            col_cnt = np.zeros(blk.shape[1], dtype=int)
            for idx in np.argsort(-blk, axis=None):
                r, c = np.unravel_index(idx, blk.shape)
                if row_cnt[r] < n and col_cnt[c] < n:
                    bm[r, c] = True
                    row_cnt[r] += 1
                    col_cnt[c] += 1
            mask[i0:i0 + m, j0:j0 + m] = bm
    return mask


def set_excluded_layers(model, param_names: List[str]):
    _prune_dead(_excluded)
    _excluded[id(model)] = (weakref.ref(model), list(param_names))


def reset_excluded_layers(model=None):
    if model is None:
        _excluded.clear()
    else:
        _excluded.pop(id(model), None)


def _supported(name: str, p) -> bool:
    # the reference prunes weights of at least 2 axes whose last one
    # divides by 4 (FC and convolution weights)
    return p.dim() >= 2 and p.shape[-1] % 4 == 0 and "bias" not in name


@torch.no_grad()
def _apply_mask(p, mask: np.ndarray):
    unwrap(p).mul_(torch.from_numpy(mask).to(p.device, p.dtype))


def prune_model(model, n: int = 2, m: int = 4, mask_algo: str = "mask_1d",
                with_mask: bool = True):
    """Prune every supported weight of ``model`` to n:m sparsity; with
    ``with_mask`` the masks are kept for a decorated optimizer. Returns
    ``{parameter name: mask}``."""
    algo = {"mask_1d": get_mask_1d, "mask_2d_greedy": get_mask_2d_greedy}[
        mask_algo]
    _prune_dead(_param_masks)
    _prune_dead(_masks)
    _prune_dead(_excluded)
    excluded = set(_excluded[id(model)][1]) if _live(_excluded, id(model)) \
        else set()
    if not _live(_masks, id(model)):
        _masks[id(model)] = (weakref.ref(model), {})
    masks = _masks[id(model)][1]
    for name, p in model.named_parameters():
        if name in excluded or not _supported(name, p):
            continue
        w = _numpy(p)
        mask = algo(w.reshape(-1, w.shape[-1]), n, m).reshape(w.shape)
        _apply_mask(p, mask)
        if with_mask:
            masks[name] = mask
            _param_masks[id(p)] = (weakref.ref(p), mask)
    return masks


class OptimizerWithSparsityGuarantee:
    """An optimizer whose every ``step`` multiplies the pruned parameters
    it updates by their masks again."""

    def __init__(self, optimizer):
        self._inner = optimizer

    def step(self, *args, **kwargs):
        out = self._inner.step(*args, **kwargs)
        for g in self._inner._param_groups:
            for p in g["params"]:
                entry = _param_masks.get(id(p))
                if entry is not None and entry[0]() is p:
                    _apply_mask(p, entry[1])
        return out

    def __getattr__(self, name):
        return getattr(self._inner, name)


def decorate(optimizer):
    """``paddle.incubate.asp.decorate``: call after :func:`prune_model`,
    so the masks exist."""
    return OptimizerWithSparsityGuarantee(optimizer)


class ASPHelper:
    """The reference's introspection helper."""

    @staticmethod
    def masks_for(model):
        if _live(_masks, id(model)):
            return dict(_masks[id(model)][1])
        return {}
