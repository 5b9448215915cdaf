"""Model zoo of the port (Llama-3 serving path so far)."""
from .llama import LlamaConfig, LlamaForCausalLM, LlamaModel

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel"]
