"""The model layer of the port: transformer, KV-cache decoding and
the continuous-batching serving engine."""

from .decode import (KVCache, greedy_generate, init_cache,
                     sample_generate)
from .transformer import TransformerConfig, forward, init_params

__all__ = ["KVCache", "TransformerConfig", "forward", "greedy_generate",
           "init_cache", "init_params", "sample_generate"]
