"""``jit.save``/``jit.load`` — port of ``paddle_tpu/jit/serialization.py``.

The reference serializes the traced forward as StableHLO through
``jax.export``; the port exports the eval forward with
``torch.export.export`` and writes the program with
``torch.export.save`` to ``<path>.pdmodel``, beside the state in
``<path>.pdiparams`` (``framework.io``'s pickle, which a fine-tune
reloads). The two packages' ``.pdmodel`` files do not cross: one is
StableHLO, the other a ``torch.export`` archive. The state file does.

The flash-attention forward (K1) is the registered op
``paddle_tpu::flash_fwd`` (``ops/pallas/flash_attention.py``), so the
exported graph holds it as one node, and a loaded program launches the
same kernel on the card.

Dynamic dims (``None``/``-1`` in an ``InputSpec``): the leading one is
one ``torch.export.Dim`` shared by every input, so a batch stays
consistent across them; every other dynamic dim gets its own (reference
:27-70). ``torch.export`` specializes a dim whose example size is 0 or 1,
so the example inputs hold 2 where a dim is dynamic (the reference's
``to_shape_dtype_struct`` uses 1).

bfloat16: ``.pdiparams`` goes through ``framework.io``, which refuses
bfloat16 (PR 9's divergence), so ``save`` of a bf16 layer raises,
naming the checkpoint manager as the route for its state.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.nn.layer_base import Layer

__all__ = ["save", "load", "TranslatedLayer"]

#: the example size of a dynamic dim (``torch.export`` specializes 0 and 1)
_DYNAMIC_EXAMPLE = 2


def _example_inputs(input_spec, device):
    """Zero example inputs for ``input_spec`` on ``device`` and their
    ``dynamic_shapes``: one ``Dim`` for every leading dynamic dim, and
    ``Dim.DYNAMIC`` (a dim of its own, whose range ``torch.export``
    infers from the model: a sequence up to the position table) for
    each other."""
    from paddle_tpu_torch.core.dtype import convert_dtype
    from paddle_tpu_torch.static import InputSpec

    batch = torch.export.Dim("batch")

    def dims_of(shape):
        dyn = {}
        for i, s in enumerate(shape):
            if s is None or int(s) < 0:
                if i == 0:
                    dyn[i] = batch
                else:  # its own, its range what the model allows
                    dyn[i] = torch.export.Dim.DYNAMIC
        return dyn

    args, dynamic = [], []
    for spec in input_spec:
        if isinstance(spec, InputSpec):
            shape, dtype = spec.shape, spec.dtype.torch_dtype
        elif isinstance(spec, torch.Tensor):
            shape, dtype = tuple(spec.shape), spec.dtype
        elif hasattr(spec, "shape") and hasattr(spec, "dtype"):
            shape, dtype = tuple(spec.shape), convert_dtype(spec.dtype)
        else:
            raise TypeError(f"unsupported input spec {spec!r}")
        dyn = dims_of(shape) if not isinstance(spec, torch.Tensor) else {}
        concrete = [_DYNAMIC_EXAMPLE if i in dyn else int(s)
                    for i, s in enumerate(shape)]
        args.append(torch.zeros(concrete, dtype=dtype, device=device))
        dynamic.append(dyn or None)
    return tuple(args), tuple(dynamic)


class _Function(torch.nn.Module):
    """A function over tensors as the module ``torch.export`` takes."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _device_of(layer):
    from paddle_tpu_torch.device import resolve_device
    p = next(iter(layer.parameters()), None) \
        if isinstance(layer, torch.nn.Module) else None
    return p.device if p is not None else resolve_device(None)


def save(layer, path: str, input_spec: Optional[Sequence] = None,
         **configs):
    """Export ``layer`` (or a function over tensors, or either wrapped by
    ``to_static``) for inference:
    ``<path>.pdmodel``, the ``torch.export`` program of its eval forward
    under ``no_grad``, and for a layer ``<path>.pdiparams``, its state
    dict. Every sublayer's train mode is restored afterwards (reference
    :117-121). Returns ``path``."""
    from paddle_tpu_torch.framework.io import save as save_state
    from .api import StaticFunction

    if isinstance(layer, StaticFunction):  # export what it wraps
        layer = layer._layer if layer._layer is not None else layer._fn
    if input_spec is None:
        raise ValueError(
            "input_spec is required: pass InputSpecs or example Tensors")
    args, dynamic = _example_inputs(input_spec, _device_of(layer))
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    if isinstance(layer, torch.nn.Module):
        save_state(layer.state_dict(), path + ".pdiparams")
        module = layer
        prev_modes = [(m, m.training) for m in layer.modules()]
        layer.eval()
    else:  # its forward takes *args
        module, prev_modes = _Function(layer), []
        dynamic = {"args": dynamic}
    try:
        with torch.no_grad():
            program = torch.export.export(module, args,
                                          dynamic_shapes=dynamic)
    finally:
        for m, mode in prev_modes:  # export must not flip train mode
            m.training = mode
    with open(path + ".pdmodel", "wb") as f:  # a file: no .pt2 suffix
        torch.export.save(program, f)
    return path


def _program_device(program) -> Optional[torch.device]:
    for t in list(program.state_dict.values()) + \
            list(program.constants.values()):
        if isinstance(t, torch.Tensor):
            return t.device
    return None


def load_program(path: str, device=None):
    """The ``torch.export`` program of ``<path>.pdmodel`` on ``device``
    (``None``: the default device, the card unless ``set_device`` chose
    the CPU), moved there with ``move_to_device_pass`` when it was
    exported on the other one."""
    from paddle_tpu_torch.device import resolve_device
    from torch.export.passes import move_to_device_pass

    from paddle_tpu_torch.ops.pallas import flash_attention  # noqa: F401
    device = resolve_device(device)
    model_path = path if path.endswith(".pdmodel") else path + ".pdmodel"
    with open(model_path, "rb") as f:
        program = torch.export.load(f)
    if _program_device(program) not in (None, device):
        program = move_to_device_pass(program, device)
    return program, device


class TranslatedLayer(Layer):
    """A loaded ``jit.save`` program presented as a layer (reference
    ``translated_layer.py``): its forward runs the program under
    ``no_grad`` on the device it was loaded to, taking tensors or numpy
    arrays."""

    def __init__(self, program, device):
        super().__init__()
        self._program = program
        self._device = torch.device(device)
        self._module = program.module()

    def forward(self, *args):
        args = [torch.as_tensor(np.asarray(a) if not isinstance(
                    a, torch.Tensor) else a).to(self._device)
                for a in args]
        with torch.no_grad():
            return self._module(*args)


def load(path: str, device=None) -> TranslatedLayer:
    """Load a ``jit.save`` program as a callable layer."""
    return TranslatedLayer(*load_program(path, device))
