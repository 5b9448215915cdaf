"""Model zoo of the port: Llama-3 (serving and training paths), the MoE
family, ERNIE (pretraining and sequence classification) and DiT
(training path)."""
from .dit import DiT, DiTConfig
from .ernie import (ErnieConfig, ErnieForPretraining,
                    ErnieForSequenceClassification, ErnieModel)
from .llama import LlamaConfig, LlamaForCausalLM, LlamaModel
from .moe import MoeConfig, MoeDecoderLayer, MoeForCausalLM

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel", "MoeConfig",
           "MoeDecoderLayer", "MoeForCausalLM", "ErnieConfig", "ErnieModel",
           "ErnieForSequenceClassification", "ErnieForPretraining",
           "DiTConfig", "DiT"]
