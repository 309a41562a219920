"""Replica pool lifecycle: DRA-acquired engines + health-driven drain.

The port of ``k8s_dra_driver_tpu/gateway/replica.py``.  A replica is one
``ServingEngine`` with a name.  This module owns the two facts about a
replica the engine itself cannot know:

- **Where its capacity came from.**  A replica may hold a lease: any
  object with ``acquire`` / ``heartbeat`` / ``release`` (built by
  ``lease_factory``), acquired at spawn, heartbeaten by the pump and
  released on drain or retire.  :class:`DraChipLease` is the one a
  prepared claim gives: it resolves ``TPU_COORDINATOR_DIR`` through the
  claim's mounts, registers with the claim's coordinator daemon as one
  more sharing-slot client (coordclient/client.py), heartbeats while
  the replica serves so the daemon never evicts it as dead, and
  unregisters on drain.  It names its devices as the claim does: a TPU
  claim's chip indices (``TPU_VISIBLE_CHIPS``), or, on an NVIDIA card,
  the GPU UUIDs of ``CUDA_VISIBLE_DEVICES``; the first is the replica's
  ``chip`` label.  Pools without a lease pass no factory.
- **Whether it should keep receiving traffic.**  ``ReplicaManager``
  folds two down-signals into one verdict per replica: a health view
  (``health_source()``, a dict of unhealthy labels, matched against
  each replica's ``chip`` from ``chip_of(name)`` or its lease; the
  labels are any hashable, not devices; :func:`card_health_source`
  turns the plugin's card indices into UUID labels) and a scripted
  fault plan (``fault_plan``, duck-typed: ``decide("health",
  "Replica", name)`` returning a decision whose ``error`` is set kills
  the replica).  The gateway pump turns a down verdict into drain: stop
  dispatch, active-cancel the in-flight rows, requeue them, and route
  around the hole until a replacement is up.
"""

from __future__ import annotations

import itertools
from pathlib import Path
from typing import Callable

from ..cluster.faults import HEALTH_VERB
from ..coordclient.client import ENV_COORDINATION_DIR, CoordinatorClient
from ..coordclient.gate import ENV_VISIBLE_CHIPS, claim_cards

READY = "ready"
DRAINING = "draining"
DEAD = "dead"
RETIRED = "retired"     # counts() key only: gracefully scaled down

# Replica roles (serving_disagg/): a unified replica prefills AND
# decodes (every pool before the disaggregated one); a prefill replica
# only computes prompt K/V and exports blocks; a decode replica adopts
# blocks and generates (it can still prefill locally — the fallback
# when prefill capacity is gone).
ROLE_UNIFIED = "unified"
ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"


def resolve_container_path(path: str, mounts: list[dict] | None
                           ) -> str:
    """Map a container path from prepared-claim env back to the host
    path through the claim's CDI mounts: the serving process and the
    coordinator daemon rendezvous on the HOST directory; only
    containerized workloads see the container alias."""
    for m in mounts or []:
        cpath = m.get("containerPath", "")
        if path == cpath or path.startswith(cpath.rstrip("/") + "/"):
            return m["hostPath"] + path[len(cpath):]
    return path


def claim_devices(env: dict[str, str]) -> list:
    """The devices a prepared claim's env names: a TPU claim's chip
    indices, or, where it has no ``TPU_VISIBLE_CHIPS``, an NVIDIA
    claim's GPU UUIDs."""
    if ENV_VISIBLE_CHIPS in env:
        return [int(x) for x in env[ENV_VISIBLE_CHIPS].split(",")
                if x != ""]
    return claim_cards(env)


def card_health_source(health: Callable[[], dict],
                       topology) -> Callable[[], dict]:
    """A ``health_source`` for replicas labelled by GPU UUID: the
    plugin's view ``health()`` (``{card index: reason}``, a backend's
    ``health`` or a health monitor's last verdict) mapped to
    ``{uuid: reason}`` through the discovered ``topology``'s cards.  An
    index the topology does not know maps to nothing."""
    uuid_of = {c.index: c.uuid for c in topology.chips}

    def source() -> dict:
        return {uuid_of[i]: reason for i, reason in (health() or {}).items()
                if i in uuid_of}
    return source


class DraChipLease:
    """One replica's hold on its prepared-claim sharing slot.

    Built from the env/mounts a DRA prepare injected (a test bed's
    ``PodView`` or a real pod's environment).  ``None`` coordination
    dir (an exclusive, non-coordinated claim) degrades to a no-op
    lease: the claim still pins the device and the lease still names
    it; there is just no daemon to register with.
    """

    def __init__(self, env: dict[str, str],
                 mounts: list[dict] | None = None, *,
                 name: str | None = None, weight: float = 1.0):
        self.env = dict(env)
        self.chips = claim_devices(self.env)
        cdir = env.get(ENV_COORDINATION_DIR)
        self.client: CoordinatorClient | None = None
        if cdir:
            self.client = CoordinatorClient(
                Path(resolve_container_path(cdir, mounts)),
                name=name, weight=weight)

    def acquire(self, wait_ready_s: float = 0.0) -> None:
        """Register as a sharing-slot client (and optionally wait for
        the coordinator daemon): after this the duty-cycle schedule
        includes the replica."""
        if self.client is None:
            return
        if wait_ready_s > 0:
            self.client.wait_ready(timeout_s=wait_ready_s)
        self.client.register()

    def heartbeat(self) -> None:
        """Called from the gateway pump: a serving replica must never
        look SIGKILLed to the daemon's staleness eviction."""
        if self.client is not None:
            self.client.maybe_heartbeat()

    def release(self) -> None:
        if self.client is not None:
            self.client.unregister()


class EngineReplica:
    """One named engine in the pool, with the router-facing surface
    (`ready`/`occupancy`/`prefix_peek`/`depth_bound`) and the gateway
    verbs (`enqueue`/`cancel`/`step`)."""

    def __init__(self, name: str, engine, *,
                 chip=None,
                 lease=None,
                 depth_bound: int | None = None,
                 role: str = ROLE_UNIFIED):
        self.name = name
        self.engine = engine
        # routing/arbitration dimension, not a state: roles never
        # change over a replica's lifetime (a replacement spawns with
        # the dead replica's role)
        self.role = role
        self.chip = chip if chip is not None else (
            lease.chips[0] if getattr(lease, "chips", None) else None)
        self.lease = lease
        self.state = READY
        # router backpressure line: slots (being decoded) + this many
        # queued-behind fills; beyond it the request stays in the
        # admission queue where shedding is accounted
        self.depth_bound = (depth_bound if depth_bound is not None
                            else 2 * engine.slots)
        # uids this replica currently owns (dispatch -> finish/cancel);
        # THE drain worklist, kept gateway-side so a dead engine's
        # internals are never needed to know what it owed
        self.in_flight: dict = {}
        #: span recorder handed down by the gateway
        #: (utils/tracing.py ``wire_pool`` — set for the initial pool
        #: and every later spawn); None when tracing is off, and the
        #: unified replica itself never emits — the disagg roles
        #: (serving_disagg/pool.py) use it for prefill/migrate arcs
        self.tracer = None

    @property
    def ready(self) -> bool:
        return self.state == READY

    def occupancy(self) -> dict:
        return self.engine.occupancy()

    def prefix_peek(self, prompt) -> int:
        return self.engine.prefix_peek(prompt)

    def prefix_residency(self, prompt) -> tuple:
        """(p, tier) across every KV storage tier — the router's
        tier-preference probe (serving_kv/tiers.py).  Degrades to the
        device-only peek when the engine predates tiering."""
        fn = getattr(self.engine, "prefix_residency", None)
        if fn is not None:
            return fn(prompt)
        p = self.prefix_peek(prompt)
        return p, ("device" if p else None)

    def enqueue(self, g) -> None:
        self.engine.enqueue(g.request)
        self.in_flight[g.uid] = g

    def cancel(self, uid) -> bool:
        return self.engine.cancel(uid)

    def step(self) -> list:
        return self.engine.step()


class ReplicaManager:
    """Owns the pool: construction, health verdicts, replacement.

    ``engine_factory(name)`` builds a fresh engine (closing over params
    and config).  ``health_source`` is any zero-arg callable returning
    the unhealthy dict (``{chip label: reason}``) — a health monitor's
    bound method or a test dict's ``.copy``.  ``fault_plan`` injects
    scripted replica-down decisions (the reference's
    ``cluster/faults.py`` ``FaultPlan`` fits).
    """

    def __init__(self, engine_factory: Callable[[str], object],
                 replicas: int = 2, *,
                 health_source: Callable[[], dict] | None = None,
                 fault_plan=None,
                 chip_of: Callable[[str], object] | None = None,
                 lease_factory: Callable[[str], object] | None = None,
                 depth_bound: int | None = None):
        self.engine_factory = engine_factory
        self.health_source = health_source
        self.fault_plan = fault_plan
        self.lease_factory = lease_factory
        self.depth_bound = depth_bound
        self._chip_of = chip_of or (lambda name: None)
        self._gen = itertools.count()
        # the role an external scale-up decision gets when it does not
        # say (a fleet reconciler's add_replica): unified pools grow
        # unified; the disaggregated manager overrides this to decode,
        # the capacity-bearing role
        self.default_scale_role = ROLE_UNIFIED
        # last successful health observation; reused when a probe
        # fails so a flaky transport neither mass-drains the pool
        # nor masks chips already known bad
        self._last_unhealthy: dict = {}
        # dead replicas compacted out of the pool by replace(); keeps
        # counts() monotone without growing the replica list forever
        self._dead_removed = 0
        # gracefully retired replicas (scale-down), same compaction
        # idea but a separate count: a retire is a decision, not a
        # failure, and the two must stay distinguishable in metrics
        self._retired = 0
        #: ``listener(replica)`` fired for every spawn (initial pool,
        #: replace, add_replica) — how the gateway wires per-engine
        #: event taps (prefix-cache stats listeners) without walking
        #: the pool every step looking for newcomers
        self.spawn_listeners: list[Callable] = []
        #: span recorder (utils/tracing.py ``wire_pool``): manager-
        #: level arcs — the disagg handoff's migrate span — emit here
        self.tracer = None
        self.replicas: list[EngineReplica] = [
            self._spawn() for _ in range(replicas)]

    def _notify_spawn(self, replica: EngineReplica) -> None:
        for cb in self.spawn_listeners:
            try:
                cb(replica)
            except Exception:
                pass            # a broken tap must not fail a spawn

    def _spawn(self, role: str = ROLE_UNIFIED) -> EngineReplica:
        name = f"r{next(self._gen)}"
        lease = self.lease_factory(name) if self.lease_factory else None
        if lease is not None:
            # deadline: lease protocol is caller-owned; the factory
            # decides blocking semantics (tests use instant fakes).
            lease.acquire()
        replica = EngineReplica(
            name, self.engine_factory(name),
            chip=self._chip_of(name), lease=lease,
            depth_bound=self.depth_bound, role=role)
        self._notify_spawn(replica)
        return replica

    @property
    def ready_replicas(self) -> list[EngineReplica]:
        return [r for r in self.replicas if r.ready]

    def counts(self) -> dict:
        out = {READY: 0, DRAINING: 0, DEAD: 0}
        roles: dict[str, int] = {}
        for r in self.replicas:
            out[r.state] += 1
            if r.state != DEAD:
                roles[r.role] = roles.get(r.role, 0) + 1
        out[DEAD] += self._dead_removed
        out[RETIRED] = self._retired
        # LIVE-replica role breakdown rides along so the gateway's
        # role gauge and the reconciler's arbitration see the same
        # view (a nested dict: the state keys stay flat for the
        # replicas-by-state gauge; dead replicas serve nothing and
        # must not pad a role's apparent capacity)
        out["roles"] = roles
        return out

    # -- health verdicts -------------------------------------------------

    def poll_down(self) -> list[EngineReplica]:
        """Replicas newly judged down this poll (chip unhealthy or a
        scripted fault fired).  Judging is separate from draining: the
        gateway pump owns the requeue so the admission accounting
        stays in one place."""
        down: list[EngineReplica] = []
        unhealthy = self._last_unhealthy
        if self.health_source is not None:
            try:
                unhealthy = self.health_source() or {}
                self._last_unhealthy = unhealthy
            except Exception:
                # the driver's health-monitor contract: a failed probe
                # keeps the LAST OBSERVED state — neither mass-
                # draining the pool nor forgetting known-bad chips
                pass
        for r in self.replicas:
            if not r.ready:
                continue
            if r.chip is not None and r.chip in unhealthy:
                down.append(r)
                continue
            if self.fault_plan is not None:
                d = self.fault_plan.decide(HEALTH_VERB, "Replica",
                                           r.name)
                if d is not None and d.error:
                    down.append(r)
        return down

    # -- lifecycle -------------------------------------------------------

    def mark_down(self, replica: EngineReplica) -> None:
        replica.state = DEAD
        if replica.lease is not None:
            replica.lease.release()

    def replace(self, replica: EngineReplica) -> EngineReplica:
        """Stand up a replacement for a dead replica (fresh name —
        its PrefixCache starts cold, so routing history must not
        follow the old identity).  The dead replica leaves the pool
        list — it serves nothing, holds no lease, and owns no
        in-flight work, so keeping it would only grow submit()'s
        live-uid scan and step()'s iteration without bound over a
        long-running gateway; ``counts()`` still reports it dead via
        a compaction counter."""
        if replica in self.replicas:
            self.replicas.remove(replica)
            self._dead_removed += 1
        fresh = self._spawn(replica.role)
        self.replicas.append(fresh)
        return fresh

    # -- external-controller verbs (a fleet reconciler) -------------------

    def add_replica(self, chip=None,
                    role: str | None = None) -> EngineReplica:
        """Scale-up: one fresh replica joins the pool.  ``chip`` pins
        the ledger chip an external arbiter allocated it (overriding
        ``chip_of``) so the health mapping and the supply bookkeeping
        agree on who sits where; ``role`` defaults to
        ``default_scale_role`` (decode in a disaggregated pool —
        capacity lives there)."""
        fresh = self._spawn(role or self.default_scale_role)
        if chip is not None:
            fresh.chip = chip
        self.replicas.append(fresh)
        return fresh

    def begin_drain(self, replica: EngineReplica) -> bool:
        """Graceful scale-down, the planned twin of ``mark_down``: the
        replica stops receiving dispatch (routers skip non-ready) but
        its engine is HEALTHY, so in-flight work runs to completion on
        it instead of being cancelled and requeued.  ``retire`` it
        once ``in_flight`` empties.

        Returns whether the drain started.  Role guard: the LAST ready
        prefill replica is never drained by a decision — without it
        every fill falls back to the decode side, which is exactly the
        interference disaggregation exists to remove (a FAILURE may
        still take it: ``mark_down`` is unconditional, and the router
        falls back to decode-local prefill)."""
        if replica.state != READY:
            return False
        if replica.role == ROLE_PREFILL and not any(
                r is not replica and r.role == ROLE_PREFILL
                and r.ready for r in self.replicas):
            return False
        replica.state = DRAINING
        return True

    def retire(self, replica: EngineReplica) -> None:
        """Remove a replica from the pool: a finished graceful drain,
        or a dead replica in a pool whose controller owns replacement
        (``auto_replace=False``).  The lease is released so its
        capacity frees up;
        ``counts()`` keeps the cumulative dead/retired totals."""
        if replica in self.replicas:
            self.replicas.remove(replica)
            if replica.state == DEAD:
                self._dead_removed += 1
            else:
                self._retired += 1
        if replica.state != DEAD and replica.lease is not None:
            replica.lease.release()   # mark_down released dead leases

    def heartbeat(self) -> None:
        for r in self.replicas:
            # draining replicas still serve their in-flight rows —
            # the daemon must not evict them as dead mid-request
            if r.state != DEAD and r.lease is not None:
                r.lease.heartbeat()


__all__ = ["DEAD", "DRAINING", "READY", "RETIRED", "ROLE_DECODE",
           "ROLE_PREFILL", "ROLE_UNIFIED", "DraChipLease", "EngineReplica",
           "ReplicaManager", "card_health_source", "claim_devices",
           "resolve_container_path"]
