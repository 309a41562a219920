"""Request placement across serving replicas.

The port of ``k8s_dra_driver_tpu/gateway/router.py``: the same four
routers and the same tie-breaks, over the port engine's ``occupancy()``
keys.  Policies, one interface (``route(prompt, replicas) -> replica or
None``):

- **Prefix affinity** (the default): send same-system-prompt traffic
  to the replica whose ``PrefixCache`` already holds that prefix, so
  the shared tokens are prefilled ONCE per pool instead of once per
  replica.  Affinity is scored from two sources — the replica engine's
  own ``prefix_peek`` (what its cache holds NOW) and a bounded memory
  of prompts this router recently routed there (what its cache is
  ABOUT to hold: a burst of shared-prefix requests arrives faster than
  the first fill completes, and peek alone would scatter the burst
  across the pool before any cache has the prefix — the same
  arrives-together pattern the engine's same-round deferral handles
  one layer down).  Requests with no meaningful affinity spill to the
  least-loaded replica (queue depth = active + pending), ties broken
  by replica order, so cold traffic still statistically multiplexes
  across the pool (AlpaServe's argument for pooling at all).
- **Round robin**: the affinity-blind baseline (affinity routing pays
  strictly fewer prefill dispatches on a shared-prefix workload).
- **Least loaded**: the pure depth spill (also the affinity fallback).

Routers never overfill: a replica at its depth bound is not a
candidate, and ``route`` returns None when every replica is at bound —
backpressure stays IN the admission queue where shedding is
accounted, instead of hiding in per-replica queues.

**KV-memory admission** (serving_kv/): a paged replica's occupancy
carries ``kv_headroom_blocks`` — free blocks plus cold prefix-store
entries it can reclaim without touching live requests.  A replica
whose headroom cannot hold the prompt's blocks is not a candidate
(:func:`kv_admits`), so block exhaustion surfaces as queueing and
SLO shedding at the gateway, never as allocation churn inside an
engine; among candidates, more headroom wins load-spill ties
(``_spill_key``).  Replicas without the signal (contiguous engines,
remote stubs) are always admissible — the gate degrades to the old
behavior, it never invents pressure.

**Accept-aware preference** (speculative replicas): occupancy from a
speculative engine carries ``spec_accept_rate`` (accepted / proposed
drafts).  For SLO-TIGHT requests (a finite deadline — the gateway
sets ``router.slo_tight`` before each route, the ``last_reason``
attribute-hint idiom), a higher accept rate wins the spill tie right
after queue depth: at equal load, deadline-bearing work lands where
speculation is currently paying off (more tokens per weight stream =
lower expected latency).  The rate is decile-quantized first
(``_accept_bucket``) so EWMA jitter cannot thrash placement, and
replicas without the signal bucket to 0 — an all-plain pool keeps
the exact old ordering (degrade, never invent).

**Adapter residency** (serving_lora/): occupancy from a multi-adapter
replica carries ``adapter_resident`` (warm adapter names) and
``adapter_headroom_slots`` (pool slots claimable without touching a
decoding pin).  A replica that neither holds the request's adapter
nor has a claimable slot is not a candidate (:func:`adapter_admits` —
routing there would head-of-line-block its refill); among candidates,
a replica where the adapter is already RESIDENT wins the spill tie
right after queue depth, so repeat-adapter traffic lands warm and a
miss cold-loads on the least-loaded eligible replica — asynchronously
inside that engine's refill round, never as a synchronous stall in
the gateway pump.  The gateway sets ``router.adapter`` before each
route (the ``slo_tight`` hint idiom); replicas without the signal are
always admissible and score no bonus (degrade, never invent).
"""

from __future__ import annotations

from collections import deque

import numpy as np

from ..models.serving import _overlap


class Router:
    """Interface: pick a replica for a prompt, or None to hold it."""

    #: why the LAST route() picked its replica — a one-word tag the
    #: gateway copies into the dispatch span's attrs (utils/tracing),
    #: so a trace can tell an affinity placement from a load spill
    #: without re-deriving the router's decision.  Overwritten per
    #: call; meaningless when route() returned None.
    last_reason: str | None = None

    #: hint set by the CALLER before route() (the last_reason idiom
    #: in reverse): True when the request carries a finite deadline,
    #: letting spill ties prefer high-spec-accept replicas without
    #: widening the route() signature every policy implements.
    slo_tight: bool = False

    #: the request's adapter name (serving_lora/), set by the caller
    #: before route() like ``slo_tight``; None = base model.  Gates
    #: candidates through :func:`adapter_admits` and makes resident
    #: replicas win spill ties right after depth.
    adapter: str | None = None

    def route(self, prompt: np.ndarray, replicas: list):
        raise NotImplementedError

    def forget(self, name: str) -> None:
        """Drop any routing state tied to a replica (drain path)."""


def _depth(replica) -> int:
    occ = replica.occupancy()
    return occ["active"] + occ["pending"]


def _under_bound(replica) -> bool:
    occ = replica.occupancy()
    return occ["active"] + occ["pending"] < replica.depth_bound


def kv_admits(replica, prompt) -> bool:
    """Whether the replica's paged-KV headroom can hold ``prompt``'s
    fill: ceil((L + 1) / block_size) blocks (the +1 is the first
    generated token's row — a fill that cannot seed generation is a
    guaranteed immediate preemption).  True when the replica reports
    no KV signal (contiguous engine or remote stub)."""
    occ = replica.occupancy()
    if "kv_headroom_blocks" not in occ:
        return True
    need = -(-(len(prompt) + 1) // occ["kv_block_size"])
    return occ["kv_headroom_blocks"] >= need


def _headroom(replica) -> float:
    """Reclaimable KV blocks; inf when the replica has no block pool
    (no memory constraint to prefer against)."""
    return replica.occupancy().get("kv_headroom_blocks", float("inf"))


def adapter_admits(replica, adapter) -> bool:
    """Whether the replica can serve ``adapter``: resident, or one
    pool slot claimable without touching a decoding pin.  True for
    base requests and for replicas reporting no adapter signal
    (adapter-less engine or remote stub) — the gate degrades, it
    never invents pressure."""
    if adapter is None:
        return True
    occ = replica.occupancy()
    if "adapter_headroom_slots" not in occ:
        return True
    return (adapter in occ.get("adapter_resident", ())
            or occ["adapter_headroom_slots"] >= 1)


def _adapter_resident(replica, adapter) -> int:
    """1 when the request's adapter is warm on this replica — the
    spill tiebreak right after depth (resident wins; a miss lands on
    the least-loaded eligible replica and cold-loads there)."""
    if adapter is None:
        return 0
    occ = replica.occupancy()
    return int(adapter in occ.get("adapter_resident", ()))


def _accept_bucket(replica) -> int:
    """Decile-quantized speculative accept rate (0..10); 0 when the
    replica reports none — quantization keeps EWMA jitter from
    thrashing placement, and the 0 default keeps an all-plain pool's
    ordering byte-identical to the pre-speculative router."""
    rate = replica.occupancy().get("spec_accept_rate")
    if not rate:
        return 0
    return int(min(max(float(rate), 0.0), 1.0) * 10)


def _spill_key(replica, slo_tight: bool = False, adapter=None):
    """Least depth, then adapter residency (warm wins), then
    (SLO-tight requests only) HIGHEST spec accept bucket, then MOST
    KV headroom, then name order — the memory-pressure-aware
    tiebreak: at equal load, adapter traffic lands where its weights
    are warm, deadline-bearing work lands where speculation
    currently pays off, and new work lands where eviction/preemption
    is least likely."""
    return (_depth(replica),
            -_adapter_resident(replica, adapter),
            -(_accept_bucket(replica) if slo_tight else 0),
            -_headroom(replica), replica.name)


def _candidates(prompt, replicas, adapter=None) -> list:
    return [r for r in replicas
            if r.ready and _under_bound(r) and kv_admits(r, prompt)
            and adapter_admits(r, adapter)]


#: residency-tier preference order for equal-affinity ties —
#: device-resident adopts by reference, host/disk pay a promotion,
#: and a replica whose affinity is routed-history only (tier None)
#: holds nothing and ranks last (serving_kv/tiers.py)
_TIER_ORDER = {"device": 0, "host": 1, "disk": 2}


def _tier_rank(replica, prompt) -> int:
    """Rank a replica's KV residency for ``prompt``: 0 device, 1
    host, 2 disk, 3 nothing held.  Degrade-never-invent on a legacy
    replica (no ``prefix_residency``): its ``prefix_peek`` match can
    ONLY be device-resident, so a nonzero peek ranks 0."""
    fn = getattr(replica, "prefix_residency", None)
    if fn is None:
        return 0 if int(replica.prefix_peek(prompt)) else 3
    p, tier = fn(prompt)
    if not p or tier is None:
        return 3
    return _TIER_ORDER.get(tier, 3)


class LeastLoadedRouter(Router):
    """Pure least-queue-depth spill (also the affinity fallback)."""

    last_reason = "least_loaded"

    def route(self, prompt, replicas):
        ready = _candidates(prompt, replicas, self.adapter)
        if not ready:
            return None
        return min(ready,
                   key=lambda r: _spill_key(r, self.slo_tight,
                                            self.adapter))


class RoundRobinRouter(Router):
    """Affinity-blind baseline: next ready replica in turn."""

    last_reason = "round_robin"

    def __init__(self):
        self._i = 0

    def route(self, prompt, replicas):
        ready = _candidates(prompt, replicas, self.adapter)
        if not ready:
            return None
        pick = ready[self._i % len(ready)]
        self._i += 1
        return pick


class PrefixAffinityRouter(Router):
    """Longest-prefix placement with least-depth spill.

    ``min_affinity`` is the token floor below which a match is noise
    (a handful of coincidentally-equal leading tokens must not defeat
    load balancing); ``history`` bounds the per-replica routed-prompt
    memory (each entry is one prompt array reference, so the memory
    cost is pointers, not tokens).
    """

    def __init__(self, min_affinity: int = 4, history: int = 32):
        if min_affinity < 1:
            raise ValueError("min_affinity must be >= 1")
        self.min_affinity = min_affinity
        self.history = history
        self._routed: dict[str, deque] = {}

    def _affinity(self, prompt: np.ndarray, replica) -> int:
        # the last prompt token is always re-prefilled (its logits
        # seed generation), so cap matches the engine's own peek cap
        cap = prompt.size - 1
        score = min(int(replica.prefix_peek(prompt)), cap)
        for past in self._routed.get(replica.name, ()):
            score = max(score, min(_overlap(prompt, past), cap))
        return score

    def route(self, prompt, replicas):
        prompt = np.asarray(prompt, np.int32)
        ready = _candidates(prompt, replicas, self.adapter)
        if not ready:
            return None
        scored = [(self._affinity(prompt, r), r) for r in ready]
        best, _ = max(scored, key=lambda s: s[0])
        if best >= self.min_affinity:
            # deterministic among equals: deepest affinity, then the
            # best residency tier (device beats host beats disk — a
            # promotion costs a PCIe transfer a device hit does not),
            # then the memory-aware spill key (least depth, adapter
            # residency, accept bucket for SLO-tight requests, most
            # KV headroom)
            pick = min((r for a, r in scored if a == best),
                       key=lambda r: (_tier_rank(r, prompt),
                                      _spill_key(r, self.slo_tight,
                                                 self.adapter)))
            self.last_reason = "affinity"
        else:
            pick = min(ready,
                       key=lambda r: _spill_key(r, self.slo_tight,
                                                self.adapter))
            self.last_reason = "spill"
        hist = self._routed.setdefault(pick.name,
                                       deque(maxlen=self.history))
        hist.append(prompt)
        return pick

    def forget(self, name: str) -> None:
        """A drained replica's cache is gone with it; keeping its
        routed history would keep steering its old traffic at a fresh
        replica that holds none of those prefixes."""
        self._routed.pop(name, None)


__all__ = ["Router", "LeastLoadedRouter", "RoundRobinRouter",
           "PrefixAffinityRouter", "kv_admits", "adapter_admits"]
