"""LoRA — port of ``paddle_tpu/tuning/lora.py``: rank-r adapters on the
Llama projections, in two forms.

**Training** (``apply_lora(model, cfg)``): each targeted linear grows
``lora_A [in, r]`` (normal init from ``core.generator``) and ``lora_B
[r, out]`` (zeros: the delta starts at exactly 0), the base parameters
are frozen, and a forward post-hook adds ``x @ A @ B * (alpha / rank)``
to the layer's output; ``TrainStep`` then trains only the adapters, and
:func:`save_adapter` saves just the ``lora_*`` leaves.

**Serving** (``apply_lora(model, cfg, n_slots=N)``): the same
parameters as stacks ``[N + 1, in, r]`` / ``[N + 1, r, out]``, all
zeros. Row 0 is the empty base row (delta exactly 0); rows 1..N are
tenant slots that ``ServingEngine.load_adapter`` fills in place. The
engine pins each step's per-token slot ids on the card with
:func:`adapter_ids`; the hook gathers each token's rows and applies its
own delta in f32, with two einsums as the reference does outside any
Pallas kernel, so one step serves every tenant mix.

Parameter names are the same in both forms (``...q_proj.lora_A``), so a
training checkpoint's 2-D leaves go by name into one slot of a serving
stack. The reference's ``PADDLE_TPU_LORA_SLOTS`` is not read: the
``n_slots`` argument carries it.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

from paddle_tpu_torch.core.tensor import Parameter
from paddle_tpu_torch.nn import initializer as I

__all__ = ["LoRAConfig", "apply_lora", "adapter_ids", "lora_state_dict",
           "save_adapter", "load_adapter_state", "lora_param_bytes"]

#: Llama-family projections adapted by default — attention + MLP, the
#: same surface the weight-only quantizer targets
_DEFAULT_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj",
                    "gate_proj", "up_proj", "down_proj")


@dataclass
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    target_modules: Tuple[str, ...] = field(
        default_factory=lambda: _DEFAULT_TARGETS)
    #: init std of ``lora_A`` (B starts at zero either way)
    init_std: float = 0.02

    @property
    def scaling(self) -> float:
        return float(self.alpha) / float(self.rank)


# thread-local: the serving engine pins the step's per-token slot ids
# here around its model call
_ids_local = threading.local()


@contextlib.contextmanager
def adapter_ids(ids):
    """Pin the per-token adapter-slot ids (``[T]`` int32, on the model's
    device) for the forwards run inside the block on this thread."""
    prev = getattr(_ids_local, "value", None)
    _ids_local.value = ids
    try:
        yield
    finally:
        _ids_local.value = prev


def _lora_targets(model, cfg: LoRAConfig):
    """(qualified name, layer) for every targeted linear: last name
    component in ``target_modules`` and a 2-D ``weight``."""
    out = []
    for name, sub in model.named_sublayers():
        leaf = name.rsplit(".", 1)[-1]
        w = getattr(sub, "weight", None)
        if leaf in cfg.target_modules and getattr(w, "ndim", 0) == 2:
            out.append((name, sub))
    return out


def _make_hook(scaling: float):
    def _lora_hook(layer, inputs, out):
        A, B = layer.lora_A, layer.lora_B
        x = inputs[0]
        if A.dim() == 2:
            # training: one adapter, in the layer's dtype, on autograd
            return out + torch.matmul(torch.matmul(x, A), B) * scaling
        # serving: per-token slot dispatch over the [N + 1, ...] stacks;
        # outside an adapter_ids() block every token reads row 0, the
        # zero base row
        ids = getattr(_ids_local, "value", None)
        x2 = x.reshape(-1, x.shape[-1]).float()
        sl = (torch.zeros(x2.shape[0], dtype=torch.long, device=x.device)
              if ids is None else ids.long())
        t = torch.einsum("td,tdr->tr", x2, A[sl].float())
        d = torch.einsum("tr,tro->to", t, B[sl].float()) * scaling
        return out + d.reshape(out.shape).to(out.dtype)
    return _lora_hook


def apply_lora(model, cfg: Optional[LoRAConfig] = None, *,
               n_slots: int = 0, freeze_base: bool = True):
    """Attach LoRA adapters to ``model`` in place (returns it).

    ``n_slots=0`` builds single-adapter TRAINING parameters; ``n_slots =
    N`` builds the N-tenant SERVING stacks (all zeros, filled later by
    ``ServingEngine.load_adapter``). ``freeze_base`` stops gradients on
    every pre-existing parameter. The adapters live on each layer's
    device, in its weight's dtype."""
    cfg = cfg or LoRAConfig()
    n_slots = int(n_slots or 0)
    targets = _lora_targets(model, cfg)
    if not targets:
        raise ValueError(
            f"no LoRA targets matched {cfg.target_modules!r} on "
            f"{type(model).__name__}")
    if freeze_base:
        for p in model.parameters():
            p.stop_gradient = True
    hook = _make_hook(cfg.scaling)
    r = cfg.rank
    for _, layer in targets:
        d_in, d_out = layer.weight.shape
        dev, dt = layer.weight.device, layer.weight.dtype
        if n_slots > 0:
            a = torch.zeros(n_slots + 1, d_in, r, dtype=dt, device=dev)
            b = torch.zeros(n_slots + 1, r, d_out, dtype=dt, device=dev)
        else:
            a = I.Normal(std=cfg.init_std)([d_in, r], dt, dev)
            b = torch.zeros(r, d_out, dtype=dt, device=dev)
        # serving stacks hold tenant data, not trainables
        layer.lora_A = Parameter(a, trainable=n_slots == 0)
        layer.lora_B = Parameter(b, trainable=n_slots == 0)
        layer.register_forward_post_hook(hook)
    model._lora_cfg = cfg
    model._lora_slots = n_slots
    return model


# -- adapter checkpoints ------------------------------------------------------

def lora_state_dict(model) -> Dict[str, torch.Tensor]:
    """Just the adapter leaves of the model (``{name: tensor}`` on the
    CPU) — the small thing :func:`save_adapter` saves."""
    return {k: v.detach().cpu().clone()
            for k, v in model.named_parameters()
            if k.rsplit(".", 1)[-1].startswith("lora_")}


def lora_param_bytes(model) -> int:
    return sum(v.numel() * v.element_size()
               for v in lora_state_dict(model).values())


def save_adapter(model, path: str, step: int = 0):
    """Save ONLY the adapter state through the ``CheckpointManager``
    layout, so ``load_state_dir`` reads it back."""
    from paddle_tpu_torch.checkpoint import CheckpointManager
    mgr = CheckpointManager(path)
    mgr.save(step, lora_state_dict(model), async_=False)
    return path


def load_adapter_state(path: str, step: Optional[int] = None,
                       device=None) -> Dict[str, torch.Tensor]:
    """Read an adapter checkpoint back as ``{param name: tensor}`` on
    ``device`` (``None``: the card) — what ``ServingEngine.load_adapter
    (slot, state)`` takes."""
    from paddle_tpu_torch.checkpoint import load_state_dir
    from paddle_tpu_torch.device import resolve_device
    device = resolve_device(device)
    state = load_state_dir(path, step=step, device=device)
    # the reference saves numpy leaves, which the reader gives back as
    # numpy: every leaf comes back a tensor on ``device``
    return {k: torch.as_tensor(v, device=device)
            for k, v in state.items()
            if k.rsplit(".", 1)[-1].startswith("lora_")}
