"""Paged KV-cache bookkeeping: block-table allocation and refcounted
copy-on-write prefix sharing (numpy-only, host side).  The device
half — the block pool and the paged decode kernel — lives in
models/decode.py and ops/paged_attention.py; the engine mode is
``ServingEngine(..., kv_layout="paged")`` (models/serving.py)."""

from .manager import NULL_BLOCK, BlocksExhausted, KVBlockManager
from .prefix import PagedEntry, PagedPrefixStore, kv_bytes_per_token

__all__ = ["NULL_BLOCK", "BlocksExhausted", "KVBlockManager",
           "PagedEntry", "PagedPrefixStore", "kv_bytes_per_token"]
