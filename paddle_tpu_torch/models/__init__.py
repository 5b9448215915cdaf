"""Model zoo of the port: Llama-3 (serving and training paths), the MoE
family, ERNIE (pretraining and sequence classification), DiT (training
path) and PP-OCRv4 text recognition. The vision zoo (ResNet, VGG,
MobileNet, LeNet) is ``paddle_tpu_torch.vision.models``."""
from .dit import DiT, DiTConfig
from .ernie import (ErnieConfig, ErnieForPretraining,
                    ErnieForSequenceClassification, ErnieModel)
from .llama import LlamaConfig, LlamaForCausalLM, LlamaModel
from .moe import MoeConfig, MoeDecoderLayer, MoeForCausalLM
from .ppocr import PPOCRRecConfig, PPOCRRecModel

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel", "MoeConfig",
           "MoeDecoderLayer", "MoeForCausalLM", "ErnieConfig", "ErnieModel",
           "ErnieForSequenceClassification", "ErnieForPretraining",
           "DiTConfig", "DiT", "PPOCRRecConfig", "PPOCRRecModel"]
