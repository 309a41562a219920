"""The two-role pool: prefill replicas feeding decode replicas.

The port of ``k8s_dra_driver_tpu/serving_disagg/pool.py``, over the port
engine's ``prefill_export`` / ``adopt_block`` / ``export_prefix`` /
``import_prefix``.  DistServe/Splitwise-style phase disaggregation behind the EXISTING
gateway: the pump, admission queue, SLO accounting, drain path and
metrics are untouched — this module only changes what a "replica" is.

- :class:`PrefillReplica` owns no decode slots.  It turns queued
  requests into exported :class:`~..models.serving.KVBlock`\\ s
  (prompt K/V + first token + carried generator state) and hands each to
  a decode replica chosen by slot availability, via the pool's
  KV migrator (copy-on-transfer, never recompute).  Its
  ``occupancy().tokens`` reports 1 for every block that is ready but
  not yet adopted, which is exactly what makes the gateway's TTFT
  observation honest: the first token exists the moment prefill
  finishes, regardless of decode-slot pressure — the TTFT/TPOT
  interference split that is the whole point of disaggregation.
- Decode replicas are plain :class:`~..gateway.replica.EngineReplica`
  with ``role="decode"``: they adopt blocks into free slots and
  generate.  They still accept direct dispatch (local prefill) — the
  FALLBACK the router uses when prefill capacity is gone, so a
  prefill-replica failure degrades to the unified pool, never to an
  outage (pinned by tests/test_torch_disagg_pool.py and by the card's
  smoke run).

Exactly-once through failures: a request lives in exactly one
replica's ``in_flight`` at any time — the prefill replica's from
dispatch until its block is ADOPTED by a decode engine (the handoff
moves the record atomically in-process), the decode replica's after.
A prefill replica killed mid-transfer therefore takes its un-adopted
blocks down with it; the gateway's standard drain requeues those
requests and they re-run from scratch wherever the router sends them
next — same math, byte-equal (the gateway's requeue contract).

The fleet prefix index (index.py) rides the same machinery in the
other direction: before filling, a prefill replica asks the index for
the longest fleet-held prefix; a hit on ANOTHER replica is fetched
(migrated) into the local PrefixCache so the fill pays only the
suffix — zero recompute of tokens any replica already paid for.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from ..gateway.replica import (ROLE_DECODE, ROLE_PREFILL, DEAD,
                               EngineReplica, ReplicaManager)
from .index import FleetPrefixIndex
from .migrate import KVMigrator


class PrefillReplica(EngineReplica):
    """A replica that prefills and hands off, never decodes.

    The gateway sees the standard replica surface (``enqueue`` /
    ``cancel`` / ``step`` / ``occupancy`` / ``prefix_peek``); the
    difference is what ``step`` does: adopt-ready blocks are handed
    to decode replicas first (oldest first — FIFO fairness), then up
    to ``max_exports_per_step`` queued requests are prefilled and
    exported.  Blocks that cannot be placed (no free decode slot
    anywhere) wait here, visible in ``occupancy`` depth so the
    router's bound backpressures new work into the admission queue.
    """

    def __init__(self, name: str, engine, *, chip=None, lease=None,
                 depth_bound: int | None = None,
                 max_exports_per_step: int = 4):
        super().__init__(
            name, engine, chip=chip, lease=lease,
            # prefill turnover is per-request, not per-slot: the
            # default bound is wider than a decode replica's so TTFT
            # does not queue behind an artificial slot count
            depth_bound=(depth_bound if depth_bound is not None
                         else 4 * engine.slots),
            role=ROLE_PREFILL)
        self.max_exports_per_step = max_exports_per_step
        self.pending: deque = deque()        # Requests awaiting fill
        self.blocks: dict = {}               # uid -> ready KVBlock
        # bound by the owning DisaggReplicaManager at spawn:
        self._handoff = None      # (self, block) -> decode replica|None
        self._fetch = None        # (self, prompt) -> None (index pull)

    # -- the standard replica surface ------------------------------------

    def enqueue(self, g) -> None:
        # same refusal contract as a direct engine enqueue: an
        # unrunnable request raises ValueError and the pump turns it
        # into rejected_invalid
        req = self.engine._check_request(g.request)
        self.pending.append(req)
        self.in_flight[g.uid] = g

    def cancel(self, uid) -> bool:
        for req in self.pending:
            if req.uid == uid:
                self.pending.remove(req)
                return True
        return self.blocks.pop(uid, None) is not None

    def occupancy(self) -> dict:
        n_ready, n_pending = len(self.blocks), len(self.pending)
        return {
            "slots": self.engine.slots,
            "active": n_ready,
            "pending": n_pending,
            "free_slots": max(self.engine.slots - n_ready, 0),
            "depth": n_ready + n_pending,
            # a ready block IS a first token: the gateway's TTFT
            # observation fires here, before any decode slot frees
            "tokens": {uid: 1 for uid in self.blocks},
        }

    def step(self) -> list:
        # 1. place ready blocks (oldest first); a block that cannot be
        #    placed blocks younger ones — FIFO, and younger blocks
        #    could not be placed either (same capacity check)
        for uid in list(self.blocks):
            target = (self._handoff(self, self.blocks[uid])
                      if self._handoff is not None else None)
            if target is None:
                break
            self.blocks.pop(uid)
            g = self.in_flight.pop(uid)
            target.in_flight[uid] = g
            g.replica = target.name
        # 2. fill: index-assisted prefix fetch, then export
        n = 0
        while self.pending and n < self.max_exports_per_step:
            req = self.pending.popleft()
            if self._fetch is not None:
                self._fetch(self, req.prompt)
            t0 = (self.tracer.clock() if self.tracer is not None
                  else 0.0)
            self.blocks[req.uid] = self.engine.prefill_export(req)
            if self.tracer is not None:
                g = self.in_flight.get(req.uid)
                if g is not None and g.trace is not None:
                    self.tracer.emit(
                        g.trace, "prefill", t0, self.tracer.clock(),
                        track=self.name,
                        reused_tokens=self.blocks[req.uid]
                        .reused_tokens)
            n += 1
        return []                 # a prefill replica never finishes


class DisaggReplicaManager(ReplicaManager):
    """ReplicaManager with roles, a KV migrator, and the fleet index.

    ``engine_factory(name)`` builds decode engines;
    ``prefill_engine_factory`` (default: the same factory) builds
    prefill engines — give prefill engines a PrefixCache
    (``prefix_cache=N``) or the fleet index has nothing to mirror.
    ``dest_device_of(replica)`` maps a replica to the device its engine
    lives on (None = the payload's own device: a copy into fresh
    storage), making handoff a cross-card copy when replicas are placed
    apart.  Scale-up (a fleet reconciler's ``add_replica``) defaults to
    decode replicas — capacity lives there; prefill width is a
    deliberate operator choice.
    """

    def __init__(self, engine_factory, *,
                 prefill_replicas: int = 1, decode_replicas: int = 2,
                 prefill_engine_factory=None,
                 index: FleetPrefixIndex | None = None,
                 migrator: KVMigrator | None = None,
                 dest_device_of=None,
                 max_exports_per_step: int = 4,
                 prefill_depth_bound: int | None = None,
                 **kw):
        self.index = index or FleetPrefixIndex()
        self.migrator = migrator or KVMigrator()
        self.prefill_engine_factory = (prefill_engine_factory
                                       or engine_factory)
        self.dest_device_of = dest_device_of or (lambda replica: None)
        self.max_exports_per_step = max_exports_per_step
        self.prefill_depth_bound = prefill_depth_bound
        # handoffs aborted mid-move (target died / slot race): each
        # left the block safely with its prefill replica for retry
        self.handoff_failures = 0
        super().__init__(engine_factory, replicas=0, **kw)
        self.default_scale_role = ROLE_DECODE
        for _ in range(prefill_replicas):
            self.replicas.append(self._spawn(ROLE_PREFILL))
        for _ in range(decode_replicas):
            self.replicas.append(self._spawn(ROLE_DECODE))

    # -- construction ----------------------------------------------------

    def _spawn(self, role: str = ROLE_DECODE) -> EngineReplica:
        name = f"{role[0]}{next(self._gen)}"
        lease = self.lease_factory(name) if self.lease_factory else None
        if lease is not None:
            # deadline: lease protocol is caller-owned; the factory
            # decides blocking semantics (tests use instant fakes).
            lease.acquire()
        if role == ROLE_PREFILL:
            replica = PrefillReplica(
                name, self.prefill_engine_factory(name),
                chip=self._chip_of(name), lease=lease,
                depth_bound=self.prefill_depth_bound,
                max_exports_per_step=self.max_exports_per_step)
            replica._handoff = self._handoff
            replica._fetch = self._fetch_remote_prefix
        else:
            replica = EngineReplica(
                name, self.engine_factory(name),
                chip=self._chip_of(name), lease=lease,
                depth_bound=self.depth_bound, role=role)
        prefix = getattr(replica.engine, "_prefix", None)
        if prefix is not None:
            self.index.attach(name, prefix)
        self._notify_spawn(replica)
        return replica

    # -- the handoff (prefill -> decode) ---------------------------------

    def _handoff(self, source: PrefillReplica, block):
        """Adopt ``block`` into the least-loaded decode replica with a
        genuinely free slot (free slots minus its own queued fills —
        those will claim slots first); returns the target or None.
        The KV rides the migrator: fresh buffers on the target's
        devices, zero recompute.

        FAILURE-ATOMIC: the move is transfer + adopt, and a fault can
        land between them (the target drained this very cycle, a slot
        race, a migrator error — the drain-mid-handoff double fault).
        Any failure before the adopt COMPLETES returns None: the
        block stays with the prefill replica, exactly as if no slot
        had been free, and is retried next cycle — or dies with its
        replica and rides the standard drain-requeue path.  The
        caller only moves the gateway record after a non-None return,
        so the request is never in two in-flight maps and never in
        none."""
        best, best_key = None, None
        for r in self.replicas:
            if r.role != ROLE_DECODE or not r.ready:
                continue
            occ = r.occupancy()
            if occ["free_slots"] - occ["pending"] <= 0:
                continue
            key = (occ["depth"], r.name)
            if best is None or key < best_key:
                best, best_key = r, key
        if best is None:
            return None
        t0 = self.tracer.clock() if self.tracer is not None else 0.0
        try:
            moved = self.migrator.migrate_block(
                block, self.dest_device_of(best))
            best.engine.adopt_block(moved)
        except Exception:
            self.handoff_failures += 1
            return None
        if self.tracer is not None:
            # the migrate span covers transfer + adopt — the whole
            # prefill→decode handoff the request waited on; bytes
            # come from the migrator's last sample (full-buffer size)
            g = source.in_flight.get(block.request.uid)
            if g is not None and g.trace is not None:
                _, nbytes = self.migrator.last_event or (0.0, 0)
                self.tracer.emit(
                    g.trace, "migrate", t0, self.tracer.clock(),
                    track=best.name, source=source.name,
                    dest=best.name, nbytes=nbytes)
        return best

    # -- the fleet-index fetch (remote prefix -> local cache) ------------

    def _fetch_remote_prefix(self, replica, prompt) -> None:
        """If another replica holds a longer prefix of ``prompt`` than
        ``replica`` does, migrate that entry into ``replica``'s local
        PrefixCache so the imminent fill pays only the suffix.  Every
        failure mode (holder gone, entry evicted) degrades to a local
        compute — the index is optimization, never correctness.

        Local residency is measured across ALL KV tiers
        (serving_kv/tiers.py): an equal-depth prefix demoted to this
        replica's own host arena beats a wire migration (a local
        promotion moves the same bytes without the network hop), so
        the fleet fetch only fires for a STRICTLY longer remote
        match."""
        residency = getattr(replica.engine, "prefix_residency", None)
        if residency is not None:
            p_local, _ = residency(prompt)
        else:
            p_local = replica.engine.prefix_peek(prompt)
        p_fleet, holder, key = self.index.lookup(prompt)
        if (holder is None or holder == replica.name
                or p_fleet <= p_local):
            return
        source = next((r for r in self.replicas
                       if r.name == holder and r.state != DEAD), None)
        if source is None:
            return
        entry = source.engine.export_prefix(key)
        if entry is None:       # LRU eviction raced the index mirror
            return
        moved = self.migrator.migrate_entry(
            entry, self.dest_device_of(replica))
        replica.engine.import_prefix(
            np.asarray(key, np.int32), moved)

    # -- lifecycle (index hygiene) ---------------------------------------

    def mark_down(self, replica) -> None:
        super().mark_down(replica)
        self.index.drop_replica(replica.name)

    def retire(self, replica) -> None:
        super().retire(replica)
        self.index.drop_replica(replica.name)

    # -- observability (gateway/frontend.py scrapes these) ---------------

    def drain_migration_events(self):
        return self.migrator.take_events()

    def migration_stats(self) -> dict:
        return self.migrator.stats()


__all__ = ["DisaggReplicaManager", "PrefillReplica"]
