"""Weight normalisation (port of ``paddle_tpu/nn/utils/weight_norm.py``):
a layer's ``weight`` re-parameterised as ``weight_g * weight_v /
||weight_v||``, the norm over every axis but ``dim`` (over all of them
when ``dim`` is None), recomputed before every forward."""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.tensor import Parameter

__all__ = ["weight_norm", "remove_weight_norm"]


def _norm_except(v, dim):
    if dim is None:
        return torch.linalg.vector_norm(v)
    axes = [a for a in range(v.dim()) if a != dim]
    return torch.linalg.vector_norm(v, dim=axes, keepdim=True)


def _compose(layer, name, dim):
    g = getattr(layer, name + "_g")
    v = getattr(layer, name + "_v")
    return g * v / _norm_except(v, dim)


def weight_norm(layer, name="weight", dim=0):
    """Replace the parameter ``name`` by ``name_g`` (its norm, keeping
    the reduced axes) and ``name_v`` (its value); a forward pre-hook
    sets ``layer.<name>`` from them on every call. Returns ``layer``."""
    w = getattr(layer, name).detach()
    del layer._parameters[name]
    layer.add_parameter(name + "_g", Parameter(_norm_except(w, dim).clone()))
    layer.add_parameter(name + "_v", Parameter(w.clone()))

    def hook(lyr, inputs):
        setattr(lyr, name, _compose(lyr, name, dim))

    layer._weight_norm_hook = layer.register_forward_pre_hook(hook)
    layer._weight_norm_dim = dim
    hook(layer, None)
    return layer


def remove_weight_norm(layer, name="weight"):
    """Fold ``name_g`` and ``name_v`` back into one parameter ``name``
    and drop the hook. Returns ``layer``."""
    dim = getattr(layer, "_weight_norm_dim", 0)
    with torch.no_grad():
        w = _compose(layer, name, dim)
    del layer._parameters[name + "_g"], layer._parameters[name + "_v"]
    layer.__dict__.pop(name, None)
    layer.add_parameter(name, Parameter(w))
    if hasattr(layer, "_weight_norm_hook"):
        layer._weight_norm_hook.remove()
        del layer._weight_norm_hook
    return layer
