"""Models of the port: the decoder-only Transformer LM."""
from .transformer import (KVCache, PagedKVCache, TransformerConfig,
                          TransformerLM, gpt_medium, gpt_small, gpt_tiny)

__all__ = ["KVCache", "PagedKVCache", "TransformerConfig", "TransformerLM",
           "gpt_small", "gpt_medium", "gpt_tiny"]
