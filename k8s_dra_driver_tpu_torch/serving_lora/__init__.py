"""Multi-adapter (LoRA) serving: the paged adapter pool and its probe.

The port of ``k8s_dra_driver_tpu/serving_lora/``.  This package holds
the host-side half, the refcounted pool of adapter slots and its
manifests; the per-row adapter gather lives in ``models/decode.py``
(the ``lora`` argument) and the engine plumbing in
``models/serving.py`` (``ServingEngine(..., adapter_pool=...)``).
"""

from .pool import (LORA_RULES, AdapterManifest, AdapterPool, adapter_leaves,
                   checkpoint_source, make_adapter, shard_lora_buffers)

__all__ = ["LORA_RULES", "AdapterManifest", "AdapterPool", "adapter_leaves",
           "checkpoint_source", "make_adapter", "shard_lora_buffers"]
