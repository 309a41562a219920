"""Role-aware routing for the disaggregated pool.

The port of ``k8s_dra_driver_tpu/serving_disagg/router.py``.  One
policy, two tiers: NEW requests are prefill work — they go to a
prefill replica, preferring the one the fleet index says already
holds the prompt's prefix (no migration needed), else the least-loaded
prefill replica (which will FETCH the prefix through the index if any
replica holds it — affinity is advisory, reuse is guaranteed either
way, which is the difference from the unified pool's
PrefixAffinityRouter where a spilled request recomputes).  When no
prefill replica can take work — all at bound, draining, or dead — the
router falls back to decode/unified replicas doing local prefill: a
degraded unified pool, never a stall (the chaos twin pins this).

Decode work never routes: blocks flow prefill→decode inside the pool
(pool.py ``_handoff``) by slot availability, so the router's depth
bound on prefill replicas is the single backpressure line and
shedding stays accounted in the admission queue.
"""

from __future__ import annotations

import numpy as np

from ..gateway.replica import ROLE_PREFILL
from ..gateway.router import Router, _depth, _under_bound
from .index import FleetPrefixIndex


class DisaggRouter(Router):
    """Prefill-first placement with index affinity + decode fallback.

    ``min_affinity`` is the same noise floor the unified affinity
    router uses: a fleet-index match shorter than this does not defeat
    load balancing.
    """

    def __init__(self, index: FleetPrefixIndex,
                 min_affinity: int = 4):
        if min_affinity < 1:
            raise ValueError("min_affinity must be >= 1")
        self.index = index
        self.min_affinity = min_affinity

    def route(self, prompt, replicas):
        prompt = np.asarray(prompt, np.int32)
        prefill = [r for r in replicas
                   if r.ready and _under_bound(r)
                   and getattr(r, "role", None) == ROLE_PREFILL]
        if prefill:
            p, holder, _ = self.index.lookup(prompt)
            if p >= self.min_affinity:
                for r in prefill:
                    if r.name == holder:
                        self.last_reason = "index_affinity"
                        return r
                # the holder is busy, draining, or a decode replica:
                # any prefill replica can pull the entry through the
                # index, so spill by depth without losing the reuse
            self.last_reason = "prefill_spill"
            return min(prefill, key=lambda r: (_depth(r), r.name))
        fallback = [r for r in replicas
                    if r.ready and _under_bound(r)
                    and getattr(r, "role", None) != ROLE_PREFILL]
        if not fallback:
            return None
        self.last_reason = "decode_fallback"
        return min(fallback, key=lambda r: (_depth(r), r.name))

    def forget(self, name: str) -> None:
        """A drained replica's caches died with it: its index entries
        must not keep attracting traffic (pool lifecycle drops them
        too — forget() covers gateways that drain without a
        DisaggReplicaManager)."""
        self.index.drop_replica(name)


__all__ = ["DisaggRouter"]
