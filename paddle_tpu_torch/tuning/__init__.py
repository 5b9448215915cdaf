"""Parameter-efficient tuning — port of ``paddle_tpu/tuning``: LoRA
adapters over a frozen base model, trainable through ``TrainStep`` and
``Model.fit``, saved as a small separate state, and served many tenants
at once from one engine through stacked adapter slots
(``tuning/lora.py``)."""
from .lora import (  # noqa: F401
    LoRAConfig, adapter_ids, apply_lora, load_adapter_state,
    lora_param_bytes, lora_state_dict, save_adapter,
)

__all__ = ["LoRAConfig", "apply_lora", "adapter_ids", "lora_state_dict",
           "save_adapter", "load_adapter_state", "lora_param_bytes"]
