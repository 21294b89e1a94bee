"""Models of the port: the decoder-only Transformer LM and the CNNs of the
reference's scaling benchmarks (ResNet, VGG, Inception V3), and the MoE
feed-forward layer."""
from .inception import InceptionV3
from .moe import MoEMLP
from .resnet import (ResNet, ResNet18, ResNet34, ResNet50, ResNet101,
                     ResNet152)
from .transformer import (KVCache, PagedKVCache, TransformerConfig,
                          TransformerLM, gpt_medium, gpt_small, gpt_tiny)
from .vgg import VGG, VGG16, VGG19

__all__ = ["ResNet", "ResNet18", "ResNet34", "ResNet50", "ResNet101",
           "ResNet152", "KVCache", "PagedKVCache", "TransformerConfig",
           "TransformerLM", "gpt_small", "gpt_medium", "gpt_tiny", "VGG",
           "VGG16", "VGG19", "InceptionV3", "MoEMLP"]
