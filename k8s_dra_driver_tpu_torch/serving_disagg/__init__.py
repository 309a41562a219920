"""Disaggregated prefill/decode serving with a fleet-wide KV/prefix
index, over port engines.

The port of ``k8s_dra_driver_tpu/serving_disagg/``, with the wire
codec ``wirekv.py`` the multi-process gateway ships blocks through
(gateway/procpump.py).  Dedicated prefill
replicas turn arrivals into exported KV blocks (models/serving.py
``prefill_export``), decode replicas adopt them after a copy into fresh
storage (migrate.py) and generate, and the fleet prefix index
(index.py) makes any replica's cached prefix feed any fill.
Byte-equal to the unified pool by construction; the probe records the
time-to-first-token the split buys under overload.
"""

from .index import FleetPrefixIndex
from .migrate import KVMigrator, make_kv_shard_and_gather_fns
from .pool import DisaggReplicaManager, PrefillReplica
from .router import DisaggRouter

__all__ = [
    "DisaggReplicaManager", "DisaggRouter", "FleetPrefixIndex",
    "KVMigrator", "PrefillReplica", "disagg_probe",
    "make_kv_shard_and_gather_fns",
]


def __getattr__(name):
    # the probe pulls in the gateway and model layers: loaded on demand
    # so importing the pool types stays light
    if name == "disagg_probe":
        from .probe import disagg_probe
        return disagg_probe
    raise AttributeError(name)
