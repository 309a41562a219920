"""The model layer of the port: transformer, training step, data
loader, checkpointer, weight-only int8 quantization, KV-cache decoding
and the continuous-batching serving engine."""

from .checkpoint import ShardCorruption, TrainCheckpointer
from .data import (BatchLoader, as_global, load_token_file, local_rows,
                   write_token_file)
from .decode import (KVCache, greedy_generate, init_cache,
                     sample_generate)
from .layouts import transformer_rules
from .quant import QTensor, quantize_params, quantized_bytes
from .transformer import (TransformerConfig, forward, init_params, loss_fn,
                          make_optimizer, make_train_step, param_specs,
                          shard_params, stage_params, unstage_params)

__all__ = ["BatchLoader", "KVCache", "QTensor", "ShardCorruption",
           "TrainCheckpointer", "TransformerConfig", "as_global", "forward",
           "greedy_generate", "init_cache", "init_params", "load_token_file",
           "local_rows", "loss_fn", "make_optimizer", "make_train_step",
           "param_specs", "quantize_params", "quantized_bytes",
           "sample_generate", "shard_params", "stage_params",
           "transformer_rules", "unstage_params", "write_token_file"]
