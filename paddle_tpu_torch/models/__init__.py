"""Model zoo of the port: Llama-3 (serving and training paths) and the
MoE family (training path)."""
from .llama import LlamaConfig, LlamaForCausalLM, LlamaModel
from .moe import MoeConfig, MoeDecoderLayer, MoeForCausalLM

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel", "MoeConfig",
           "MoeDecoderLayer", "MoeForCausalLM"]
