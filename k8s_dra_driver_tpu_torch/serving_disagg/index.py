"""Fleet-level prefix index: which replica holds which prompt prefix.

The port of ``k8s_dra_driver_tpu/serving_disagg/index.py``, over the
port's prefix stores and ``serving_kv/tiers.py`` tier names.  Without
it prefix reuse stops at one replica: the gateway's
affinity router could steer same-prefix traffic AT a warm replica, but
a prefix cached on replica A was recomputed from scratch the moment
load spilled a request to replica B.  The index makes cached K/V a
fleet asset — it mirrors every pool engine's ``PrefixCache`` contents
(via the cache's listener hook, so the mirror can never drift from
the store it mirrors) and answers the one question the disaggregated
pool asks: *who holds the longest prefix of this prompt, and under
which exact key can it be fetched?*  A hit on another replica turns
into a KV migration (migrate.py) + a local ``import_prefix``, after
which the fill pays only the suffix — the vLLM automatic-prefix-cache
idea lifted from one engine to the pool, with DistServe's observation
that prefill work is exactly the part worth deduplicating fleet-wide.

Entries carry a residency TIER (serving_kv/tiers.py): a tiered store's
demotion events move the mirrored entry to "host"/"disk" instead of
dropping it, and ``lookup`` prefers the closest copy at equal depth —
device-resident exports by reference, host/disk pay a promotion
first.  A legacy (untier-ed) store never emits demote events, so its
entries are always "device" and ordering is unchanged —
degrade-never-invent.

The index stores KEYS ONLY (token tuples), never K/V: entries stay
resident on the replica that computed them until someone fetches, so
index memory is prompts, not caches, and an eviction on the owner
(mirrored here via the listener) simply makes the next lookup miss —
callers treat a failed fetch as a miss and compute (exactly-once is
never at stake; the index is pure optimization).
"""

from __future__ import annotations

import numpy as np

from ..serving_kv.tiers import TIER_DEVICE, TIER_RANK


class FleetPrefixIndex:
    """prefix keys → (holding replica, residency tier), pool-wide.

    ``attach(name, cache)`` wires one engine's PrefixCache: current
    contents are seeded and the cache's listeners keep the mirror
    synchronized (insert/promote adds as device, demote moves to
    host/disk, evict/drop removes).  ``drop_replica`` forgets
    everything a drained/retired replica held — its cache died with
    it (a tiered store's DISK entries survive a restart, but the
    restarted engine re-seeds them through ``attach``).
    """

    def __init__(self):
        #: replica name -> {key: tier}
        self._held: dict[str, dict[tuple, str]] = {}

    def attach(self, name: str, cache) -> None:
        held = {key: TIER_DEVICE for key in cache._store.keys()}
        residency_of = getattr(cache, "residency_of", None)
        if residency_of is not None:
            demoted = getattr(cache, "_demoted", {})
            for key in list(demoted):
                tier = residency_of(key)
                if tier is not None:
                    held[key] = tier
        self._held[name] = held
        cache.listeners.append(
            lambda event, key, name=name: self._on(name, event, key))

    def _on(self, name: str, event: str, key: tuple) -> None:
        held = self._held.get(name)
        if held is None:        # replica already dropped; stale cb
            return
        if event in ("insert", "promote"):
            held[key] = TIER_DEVICE
        elif event == "demote":
            held[key] = "host"
        elif event == "demote_disk":
            held[key] = "disk"
        else:                   # evict / drop / unknown-future event
            held.pop(key, None)

    def drop_replica(self, name: str) -> None:
        self._held.pop(name, None)

    def lookup(self, prompt) -> tuple[int, str | None, tuple | None]:
        """(p, replica, key): the longest common prefix of ``prompt``
        over every held key, capped at ``len(prompt) - 1`` (the last
        token is always re-prefilled — its logits seed generation,
        the engines' own cap).  Ties break by residency tier (device
        beats host beats disk — the fetch adopts by reference only
        from the device tier), then replica name, then key order, so
        placement is deterministic.  (0, None, None) on a fleet-wide
        miss."""
        toks = np.asarray(prompt).tolist()
        cap = len(toks) - 1
        best = None            # (p, -tier_rank) maximized
        best_p, best_name, best_key = 0, None, None
        for name in sorted(self._held):
            for key, tier in self._held[name].items():
                p = 0
                for a, b in zip(key, toks[:cap]):
                    if a != b:
                        break
                    p += 1
                rank = (p, -TIER_RANK.get(tier, len(TIER_RANK)))
                if p > 0 and (best is None or rank > best):
                    best = rank
                    best_p, best_name, best_key = p, name, key
        return best_p, best_name, best_key

    def tier_of(self, name: str, key: tuple) -> str | None:
        """Residency tier of one held entry (None when absent) — the
        fetch path's promotion-cost signal."""
        return self._held.get(name, {}).get(key)

    def holders(self) -> dict[str, int]:
        """Entries per replica (observability/tests)."""
        return {name: len(keys) for name, keys in self._held.items()}


__all__ = ["FleetPrefixIndex"]
