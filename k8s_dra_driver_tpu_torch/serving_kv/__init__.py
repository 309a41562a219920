"""Paged KV-cache bookkeeping: block-table allocation, refcounted
copy-on-write prefix sharing (numpy-only, host side) and the host/disk
tiers an evicted prefix demotes to (tiers.py).  The device half — the
block pool and the paged decode kernel — lives in models/decode.py and
ops/paged_attention.py; the engine mode is ``ServingEngine(...,
kv_layout="paged")`` (models/serving.py), tiered with ``kv_host_bytes``
/ ``kv_spill_dir``."""

from .manager import NULL_BLOCK, BlocksExhausted, KVBlockManager
from .prefix import (PagedEntry, PagedPrefixStore, PrefixListeners,
                     kv_bytes_per_token)
from .tiers import (SLAB_FORMAT, TIER_DEVICE, TIER_DISK, TIER_HOST,
                    TIER_RANK, DiskTier, HostArena, HostSlab,
                    TierCorruption, TieredKVStore, slab_checksum)

__all__ = ["NULL_BLOCK", "BlocksExhausted", "KVBlockManager",
           "PagedEntry", "PagedPrefixStore", "PrefixListeners",
           "kv_bytes_per_token",
           "TieredKVStore", "TierCorruption", "HostSlab", "HostArena",
           "DiskTier", "slab_checksum", "SLAB_FORMAT", "TIER_DEVICE",
           "TIER_HOST", "TIER_DISK", "TIER_RANK"]
