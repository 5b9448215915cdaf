"""numpy state-dict bridge between the packages.

The JAX package exports ``{qualified name: numpy array}`` from its
functional state (the tests hold that side, since it touches
``paddle_tpu``); :func:`load_numpy_state` takes such a dict into a port
model under the same names, checking names, shapes and dtypes loudly,
and :func:`numpy_state` gives the port's state back in the same form.

The state is every parameter and every buffer that the reference model
has too, which this module knows by name (:data:`BRIDGED_BUFFERS`: the
batch norms' running statistics, SpectralNorm's power-iteration
vectors). Buffers that only the port keeps (RoPE tables, masks) never
cross, so a model without the named buffers keeps its parameter-only key
set. LoRA adapters (``tuning.apply_lora``) cross under the reference's
names (``...q_proj.lora_A``/``lora_B``), in the 2-D training form and
the ``[n_slots + 1, ...]`` serving stacks alike; ``adapter_slot=`` puts
a training checkpoint's 2-D leaves into one row of a serving stack, as
the reference's engine loads a trained adapter into a slot.
:func:`optimizer_state_to_numpy` and :func:`load_optimizer_state` do the
same for an optimizer's ``state_dict`` (``param_<i>.moment1``, ...,
``@step_count``), so moments can be compared across the packages.

A parameter split over a mesh (a tensor-parallel block or a ZeRO stage-3
shard: its ``_sharding_spec``) takes this rank's block of the full
array; :func:`numpy_state` and :func:`full_state_dict` gather the blocks
back, a collective that every rank of the mesh calls.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.dtype import dtype_name

__all__ = ["load_numpy_state", "numpy_state", "optimizer_state_to_numpy",
           "load_optimizer_state", "full_state_dict", "BRIDGED_BUFFERS"]

#: buffer names (the last part of the qualified name) that the reference's
#: layers hold as well: ``_BatchNormBase``'s ``_mean`` and ``_variance``,
#: ``SpectralNorm``'s ``weight_u`` and ``weight_v``
BRIDGED_BUFFERS = ("_mean", "_variance", "weight_u", "weight_v")


def _state_tensors(model: torch.nn.Module) -> dict:
    """``{name: tensor}`` of the parameters and the bridged buffers."""
    out = dict(model.named_parameters())
    out.update((n, b) for n, b in model.named_buffers()
               if n.rsplit(".", 1)[-1] in BRIDGED_BUFFERS)
    return out


def _to_tensor(name, arr):
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own: carry the bits over
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    if arr.dtype.name not in ("float32", "float16", "int32"):
        raise TypeError(f"{name}: unsupported array dtype {arr.dtype}")
    return torch.from_numpy(np.array(arr, order="C", copy=True))


def _is_lora(name: str) -> bool:
    return name.rsplit(".", 1)[-1].startswith("lora_")


@torch.no_grad()
def load_numpy_state(model: torch.nn.Module, state: dict,
                     adapter_slot=None):
    """Copy ``state`` ({name: array}) into ``model``'s parameters and
    bridged buffers. The name sets must be equal, and every array must
    have its tensor's shape and dtype; anything else raises before any
    tensor changes. With ``adapter_slot`` a 2-D LoRA leaf lands in that
    row of the model's 3-D serving stack of the same name."""
    params = _state_tensors(model)
    missing = sorted(set(params) - set(state))
    unknown = sorted(set(state) - set(params))
    if missing or unknown:
        raise KeyError(f"state does not match the model: missing "
                       f"{missing[:4]}, unknown {unknown[:4]}")
    tensors = {}
    for name, arr in state.items():
        p = params[name]
        t = _to_tensor(name, arr)
        if adapter_slot is not None and _is_lora(name) and p.dim() == 3 \
                and t.dim() == 2:
            p = p[int(adapter_slot)]
            params[name] = p
        spec = getattr(p, "_sharding_spec", None)
        if spec is not None and tuple(t.shape) != tuple(p.shape):
            from paddle_tpu_torch.distributed.mesh import local_block
            t = local_block(t, spec, p._sharding_mesh).contiguous()
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != parameter "
                             f"shape {tuple(p.shape)}")
        if t.dtype != p.dtype:
            raise TypeError(f"{name}: dtype {dtype_name(t.dtype)} != "
                            f"parameter dtype {dtype_name(p.dtype)}")
        tensors[name] = t
    for name, t in tensors.items():
        params[name].copy_(t)


def full_state_dict(model: torch.nn.Module) -> dict:
    """``{name: tensor}`` of every parameter and bridged buffer, split
    parameters gathered whole (every rank of their mesh calls this)."""
    from paddle_tpu_torch.distributed.collective import gather_block
    out = {}
    for name, p in _state_tensors(model).items():
        spec = getattr(p, "_sharding_spec", None)
        t = p.detach()
        out[name] = t if spec is None else \
            gather_block(t.contiguous(), spec, p._sharding_mesh)
    return out


def numpy_state(model: torch.nn.Module) -> dict:
    """``{name: numpy array}`` of every parameter and bridged buffer
    (float32, float16 and int32; numpy cannot hold bfloat16), split
    parameters gathered whole."""
    out = {}
    for name, p in full_state_dict(model).items():
        if p.dtype == torch.bfloat16:
            raise TypeError(f"{name}: numpy has no bfloat16")
        out[name] = p.cpu().numpy().copy()
    return out


def optimizer_state_to_numpy(optimizer) -> dict:
    """``{key: numpy array}`` of ``optimizer.state_dict()``, with
    ``@step_count`` as an int. bfloat16 state raises, as in
    :func:`numpy_state`."""
    out = {}
    for key, v in optimizer.state_dict().items():
        if not isinstance(v, torch.Tensor):
            out[key] = v
            continue
        if v.dtype == torch.bfloat16:
            raise TypeError(f"{key}: numpy has no bfloat16")
        out[key] = v.detach().cpu().numpy().copy()
    return out


def load_optimizer_state(optimizer, state: dict):
    """Load ``{key: array}`` (the form above, or the JAX package's
    ``state_dict`` turned into numpy) into ``optimizer``, each tensor on
    its parameter's device."""
    optimizer.set_state_dict({
        k: v if isinstance(v, (int, np.integer)) else _to_tensor(k, v)
        for k, v in state.items()})
