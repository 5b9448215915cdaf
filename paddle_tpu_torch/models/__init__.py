"""Model zoo of the port (Llama-3: serving and training paths so far)."""
from .llama import LlamaConfig, LlamaForCausalLM, LlamaModel

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel"]
