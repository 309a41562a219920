"""Multi-tenant fleet arbitration: quotas, priority classes, and a
fair-share preemption cascade over N gangs + N pools.

The port's copy of ``k8s_dra_driver_tpu/fleet/tenancy.py``, pure host
logic over the port's gateways and adapter pools.  The 1x1 reconciler
(fleet/reconciler.py) arbitrates exactly one training gang against one
serving pool with a fixed priority.  This module is the
cluster-operator generalization: k tenants,
each owning a serving pool (a FleetGateway + ReplicaManager) or a
training gang (a GangSupervisor), registered with

- a **priority class** (int; higher outranks lower),
- a **quota** (burst ceiling in chips), and
- a **guaranteed floor** (chips never reclaimed away) with a
  **burstable share** weight splitting headroom inside one class.

Every tick the :class:`MultiTenantReconciler` converts per-tenant
demand (each pool's ``GatewayMetrics`` gauges — or its tagged
``demand`` events on the shared bus — and each gang's target width)
into a **fair-share entitlement**: floors first, then remaining
healthy supply water-filled down the priority classes, share-weighted
inside a class.  The :class:`FairShareArbiter` then emits at most ONE
action:

- **grant** — a pressured tenant below entitlement gets one chip,
  placed by the topology bin-packer (fleet/binpack.py: link-domain
  conflict table + anti-fragmentation scoring);
- **preemption cascade** — when a grant is blocked on supply, chips
  are reclaimed from tenants ABOVE entitlement in strict
  lowest-priority-first order: a floor-zero gang is PARKED
  (checkpoint-then-release-everything), a floored gang shrinks one
  power-of-two step (checkpoint-then-shrink), a serving tenant
  drains a replica gracefully — all through the existing
  ``GangSupervisor.request_width``/``park`` and
  ``ReplicaManager.begin_drain`` paths, so cascades lose zero
  training steps and cancel zero requests.  The lowest class is
  reclaimed to its entitlement before the next class up is touched.
- **release / regrow** — a calm tenant above entitlement returns
  chips; a gang below its target regrows (priority order, EXPAND
  path) onto a bin-packed contiguous home.
- **adapter_evict** — serving tenants may also carry an
  ``adapter_quota_bytes`` ceiling on resident adapter-HBM
  (serving_lora/ AdapterPool slots whose manifests bear their tag).
  An over-quota tenant with COLD (unpinned) residents is evicted
  back under quota BEFORE any chip action is considered: freeing
  adapter slots costs no drain, no checkpoint, and touches no
  decoding request, so it must never escalate into a preemption
  cascade.  A fully pinned over-quota pool is left alone until pins
  drop (the check gates on cold-evictable bytes — no livelock).

Floors are invariant: no reclaim ever takes a tenant below
``max(floor, entitlement)``, and entitlements never fall below
floors.  One action per tick bounds the actuation rate exactly like
the 1x1 policy; a sustained condition keeps firing (the cascade IS
repeated single actions), quota/entitlement caps bound it.
"""

from __future__ import annotations

import dataclasses
import heapq
import logging
import time

from ..utils.metrics import FleetMetrics
from .binpack import TopologyBinPacker
from .policy import DemandSignals, Streaks, is_calm, pressured
from .reconciler import read_demand
from .supply import (ChipLedger, owner_tenant, serving_tag,
                     training_tag)

log = logging.getLogger(__name__)

SERVING = "serving"
TRAINING = "training"

# arbiter action kinds (MtAction.kind — also the event / metrics
# labels the acceptance tests pin)
GRANT = "grant"
RECLAIM_PARK = "reclaim_park"
RECLAIM_SHRINK = "reclaim_shrink"
RECLAIM_DRAIN = "reclaim_drain"
RELEASE = "release"
REGROW = "regrow"
ADAPTER_EVICT = "adapter_evict"


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's contract with the fleet."""

    name: str
    priority: int               # class rank; higher outranks lower
    quota: int                  # chip ceiling (bursts stop here)
    floor: int = 0              # guaranteed chips, never reclaimed
    share: float = 1.0          # burstable weight within the class
    # resident adapter-HBM ceiling (serving_lora/ AdapterPool slots
    # whose manifests carry this tenant's tag), enforced through the
    # arbiter tick by evicting the tenant's COLD adapters — never a
    # chip action.  None = unlimited.
    adapter_quota_bytes: int | None = None

    def __post_init__(self):
        if self.floor < 0 or self.quota < self.floor:
            raise ValueError(
                f"tenant {self.name}: need 0 <= floor <= quota, got "
                f"floor={self.floor} quota={self.quota}")
        if self.share <= 0:
            raise ValueError(f"tenant {self.name}: share must be > 0")
        if (self.adapter_quota_bytes is not None
                and self.adapter_quota_bytes < 0):
            raise ValueError(
                f"tenant {self.name}: adapter_quota_bytes must be "
                f">= 0, got {self.adapter_quota_bytes}")


class ServingTenant:
    """A tenant whose workload is a gateway-fronted replica pool."""

    kind = SERVING

    def __init__(self, gateway):
        self.gateway = gateway
        self.manager = gateway.manager

    def chips(self) -> set:
        return {r.chip for r in self.manager.replicas
                if r.state != "dead" and r.chip is not None}

    # -- adapter-HBM accounting (serving_lora/) -------------------

    def adapter_pools(self) -> list:
        """Every live replica's AdapterPool (engines without one are
        skipped — a mixed pool accounts only what exists)."""
        out = []
        for r in self.manager.replicas:
            if r.state == "dead":
                continue
            pool = getattr(getattr(r, "engine", None),
                           "adapter_pool", None)
            if pool is not None:
                out.append(pool)
        return out

    def adapter_bytes(self, tenant: str) -> int:
        """Resident adapter-HBM attributed to ``tenant``'s manifests
        across this workload's pools — the quota numerator."""
        return sum(p.resident_bytes(tenant)
                   for p in self.adapter_pools())

    def adapter_cold_bytes(self, tenant: str) -> int:
        """The COLD (refcount==1, evictable without touching a
        decoding request) portion of :meth:`adapter_bytes` — what an
        ``adapter_evict`` action can actually reclaim this tick."""
        return sum(len(p.cold_names(tenant)) * p.bytes_per_slot
                   for p in self.adapter_pools())


class TrainingTenant:
    """A tenant whose workload is an elastic training gang."""

    kind = TRAINING

    def __init__(self, supervisor, *, target_dp: int | None = None):
        self.supervisor = supervisor
        self.target_dp = (target_dp if target_dp is not None
                          else supervisor.dp)

    @property
    def tp(self) -> int:
        return int(getattr(self.supervisor.job, "tp", 1))

    def chips(self) -> set:
        return {c for w in self.supervisor.workers if w.alive
                for c in w.chips}


class TenantRegistry:
    """The fleet's tenant table: spec + workload per name, iterable
    in priority order.  Registration validates that floors fit the
    declared capacity — a fleet whose guarantees cannot all hold at
    once is a configuration error, not a runtime surprise."""

    def __init__(self, capacity: int | None = None):
        self.capacity = capacity
        self._specs: dict[str, TenantSpec] = {}
        self._workloads: dict[str, object] = {}
        # running floor total + memoized priority order: at fleet-
        # simulator scale (10k tenants, sim/) re-summing floors per
        # add is O(T^2) registration and re-sorting per tick is pure
        # waste — the order only changes when the table does
        self._floor_total = 0
        self._order: list[TenantSpec] | None = None

    def add(self, spec: TenantSpec, workload) -> None:
        if spec.name in self._specs:
            raise ValueError(f"tenant {spec.name!r} already registered")
        floors = self._floor_total + spec.floor
        if self.capacity is not None and floors > self.capacity:
            raise ValueError(
                f"guaranteed floors ({floors}) exceed fleet capacity "
                f"({self.capacity}) adding tenant {spec.name!r}")
        self._specs[spec.name] = spec
        self._workloads[spec.name] = workload
        self._floor_total = floors
        self._order = None

    def __iter__(self):
        return iter(self.by_priority())

    def __len__(self) -> int:
        return len(self._specs)

    def spec(self, name: str) -> TenantSpec:
        return self._specs[name]

    def workload(self, name: str):
        return self._workloads[name]

    def by_priority(self, reverse: bool = True) -> list[TenantSpec]:
        """Specs ordered by (priority, name) — descending by default
        (claim order); ascending is reclaim order.  Returns a fresh
        list each call (callers may mutate); the sort itself is
        cached until the next ``add``."""
        if self._order is None:
            self._order = sorted(self._specs.values(),
                                 key=lambda s: (s.priority, s.name))
        return (list(reversed(self._order)) if reverse
                else list(self._order))


@dataclasses.dataclass
class TenantState:
    """One tick's view of one tenant, as the arbiter sees it."""

    spec: TenantSpec
    kind: str
    chips: frozenset
    wanted: int                  # chips the tenant asks for this tick
    pressured: bool = False      # serving only
    calm: bool = False           # serving only
    gang_dp: int = 0             # training only
    gang_tp: int = 1             # training only
    parked: bool = False         # training only
    adapter_bytes: int = 0       # serving only (serving_lora/)
    adapter_cold_bytes: int = 0  # evictable portion of the above
    #: serving only: held chips whose replicas already drain, on their
    #: way back to the pool (port-only, ROADMAP Queue C item 19)
    draining: int = 0

    @property
    def held(self) -> int:
        return len(self.chips)


def entitlements(states: list[TenantState], capacity: int
                 ) -> dict[str, int]:
    """Fair-share entitlement per tenant: every floor is honored
    first, then the remaining healthy supply water-fills down the
    priority classes — a class is topped up to its wants (capped at
    quota) before the next class down sees a chip, and inside one
    class chips go one at a time to the tenant with the lowest
    entitlement-per-share (weighted max-min fairness).

    Implementation: a per-class min-heap keyed exactly like the
    naive argmin — ``(entitlement/share, name)``.  A tenant's key
    changes only when IT receives a chip (pop, bump, re-push), so
    every heap entry is always current and the grant sequence is
    identical to recomputing the argmin per chip — O(capacity log T)
    instead of the O(capacity x T) rescan, which a 10k-tenant fleet
    cannot afford."""
    ent = {s.spec.name: min(s.spec.floor, s.spec.quota)
           for s in states}
    remaining = capacity - sum(ent.values())
    by_prio: dict[int, list[TenantState]] = {}
    for s in states:
        by_prio.setdefault(s.spec.priority, []).append(s)
    for prio in sorted(by_prio, reverse=True):
        if remaining <= 0:
            break
        want = {s.spec.name: min(s.wanted, s.spec.quota)
                for s in by_prio[prio]}
        share = {s.spec.name: s.spec.share for s in by_prio[prio]}
        heap = [(ent[n] / share[n], n) for n in want
                if ent[n] < want[n]]
        heapq.heapify(heap)
        while remaining > 0 and heap:
            _, name = heapq.heappop(heap)
            ent[name] += 1
            remaining -= 1
            if ent[name] < want[name]:
                heapq.heappush(heap,
                               (ent[name] / share[name], name))
    return ent


@dataclasses.dataclass(frozen=True)
class MtAction:
    kind: str
    tenant: str                  # the acted-on tenant
    beneficiary: str | None = None   # who the reclaim is FOR
    chip: int | None = None      # grant placement
    dp: int | None = None        # gang resize target
    run: tuple | None = None     # gang home (bin-packed)


class FairShareArbiter:
    """Stateful per-tenant hysteresis + the one-action-per-tick
    decision (module docstring).  Pure bookkeeping over
    :class:`TenantState` snapshots, a ledger, and a bin-packer — no
    tensor, no I/O — so every branch is unit-testable."""

    def __init__(self, *, up_after: int = 2, down_after: int = 4,
                 regrow_after: int = 3):
        self.up_after = up_after
        self.down_after = down_after
        self.regrow_after = regrow_after
        self._streaks: dict[str, Streaks] = {}
        self._regrow: dict[str, int] = {}
        #: the last computed entitlement map (exported by the
        #: reconciler's gauges; the probe's fairness-error input)
        self.entitled: dict[str, int] = {}

    def _streak(self, name: str) -> Streaks:
        if name not in self._streaks:
            self._streaks[name] = Streaks(up_after=self.up_after,
                                          down_after=self.down_after)
        return self._streaks[name]

    def decide(self, states: list[TenantState], ledger: ChipLedger,
               packer: TopologyBinPacker) -> MtAction | None:
        capacity = sum(1 for c in ledger.chips
                       if c not in ledger.unhealthy)
        self.entitled = entitlements(states, capacity)
        for s in states:
            self._streak(s.spec.name).update(s.pressured, s.calm)
        claim_order = sorted(
            states, key=lambda s: (s.spec.priority, s.spec.name),
            reverse=True)
        # 0. adapter-quota enforcement BEFORE any chip action, lowest
        #    class first (reclaim order): an over-quota tenant's COLD
        #    adapters free HBM without draining a replica or touching
        #    a decoding pin, so they go before any preemption cascade
        #    sees the fleet.  Gated on cold-evictable bytes — a fully
        #    pinned over-quota pool has nothing to give this tick and
        #    must not livelock the one-action-per-tick budget.
        for s in reversed(claim_order):
            quota = s.spec.adapter_quota_bytes
            if (s.kind == SERVING and quota is not None
                    and s.adapter_bytes > quota
                    and s.adapter_cold_bytes > 0):
                return MtAction(ADAPTER_EVICT, tenant=s.spec.name)
        # 1. pressure grants, highest class first; a blocked grant
        #    turns into one cascade step against the lowest class
        for s in claim_order:
            if s.kind != SERVING:
                continue
            ent = self.entitled[s.spec.name]
            if not self._streak(s.spec.name).hot_fired or s.held >= ent:
                continue
            chip = packer.place_chip(s.spec.name)
            if chip is not None:
                return MtAction(GRANT, tenant=s.spec.name, chip=chip)
            return self._reclaim_for(s, states)
        # 2. calm release, lowest class first: idle capacity above
        #    entitlement returns to the pool (the regrow fuel)
        for s in reversed(claim_order):
            if (s.kind == SERVING
                    and self._streak(s.spec.name).calm_fired
                    and s.held > self.entitled[s.spec.name]):
                return MtAction(RELEASE, tenant=s.spec.name)
        # 3. gang regrow, highest class first, gated on a feasibility
        #    streak (flapping a mesh costs a reform each way)
        for s in claim_order:
            if s.kind != TRAINING:
                continue
            name = s.spec.name
            ent = self.entitled[name]
            deficit = s.held < min(ent, s.wanted)
            if not deficit:
                self._regrow[name] = 0
                continue
            cap_dp = min(ent, s.spec.quota) // max(s.gang_tp, 1)
            target = min(s.wanted // max(s.gang_tp, 1), cap_dp)
            best = packer.regrow_width(name, tp=s.gang_tp,
                                       target_dp=target)
            if best <= s.gang_dp or (s.parked and best < 1):
                self._regrow[name] = 0
                continue
            self._regrow[name] = self._regrow.get(name, 0) + 1
            if self._regrow[name] < self.regrow_after:
                continue
            self._regrow[name] = 0
            run = packer.place_run(name, best * s.gang_tp,
                                   usable_owner=training_tag(name))
            return MtAction(REGROW, tenant=name, dp=best,
                            run=run.chips if run else None)
        return None

    def _reclaim_for(self, claimant: TenantState,
                     states: list[TenantState]) -> MtAction | None:
        """One cascade step: the lowest-priority tenant strictly
        below the claimant's class that still holds chips above its
        entitlement gives ground — parked outright at floor zero,
        shrunk one power-of-two step otherwise, drained one replica
        if serving.  Strict order: a class is never touched while a
        lower one has anything left to give."""
        # a replica already draining counts as given: without that, a
        # sustained claim drains one more replica a tick while a busy
        # victim finishes its work, down past the floor (the reference
        # counts it held: ROADMAP Queue C item 19)
        victims = sorted(
            (s for s in states
             if s.spec.priority < claimant.spec.priority
             and s.held - s.draining > max(s.spec.floor,
                                           self.entitled[s.spec.name])),
            key=lambda s: (s.spec.priority, s.spec.name))
        for v in victims:
            name = v.spec.name
            if v.kind == TRAINING:
                if v.spec.floor == 0 and self.entitled[name] == 0:
                    return MtAction(RECLAIM_PARK, tenant=name,
                                    beneficiary=claimant.spec.name)
                new_dp = v.gang_dp // 2
                while (new_dp >= 1 and new_dp * v.gang_tp
                        < max(v.spec.floor, 1)):
                    new_dp //= 2
                if new_dp < 1:
                    continue        # floored: nothing left to give
                return MtAction(RECLAIM_SHRINK, tenant=name,
                                beneficiary=claimant.spec.name,
                                dp=new_dp)
            return MtAction(RECLAIM_DRAIN, tenant=name,
                            beneficiary=claimant.spec.name)
        return None


@dataclasses.dataclass
class MtConfig:
    """Signal thresholds for the per-tenant hysteresis — the
    multi-tenant analog of PolicyConfig (duck-typed into the shared
    :func:`~.policy.pressured`/:func:`~.policy.is_calm`
    classifiers)."""

    queue_high: int = 4
    margin_floor_s: float = 0.0
    arrival_low_rps: float = 0.5
    up_after: int = 2
    down_after: int = 4
    regrow_after: int = 3
    # reclaim_drain victim ordering: prefer the victim whose drain
    # EMPTIES its link domain (frees a whole overlap token), newest
    # first as the tie-break.  The fleet simulator's thousand-replica
    # soak found the False behavior (pure newest-first) starving a
    # higher-class grant FOREVER: when the entitlement floor halts
    # the cascade before any domain empties, every free chip stays
    # domain-conflicted and place_chip returns None on every tick
    # (ddmin-minimized to a 6-chip repro — tests/test_sim.py
    # test_drain_starvation_*; docs/SIMULATION.md writeup).  False
    # reproduces the pre-fix ordering for that A/B.
    domain_aware_drain: bool = True


class MultiTenantReconciler:
    """The N×N control loop: k tenants over one chip ledger.

    Same run shape as the 1x1 reconciler — single-threaded,
    clock-injected ``tick()`` driven by the owner's co-loop (every
    tenant gateway's ``step()`` and every gang's ``step_once()``
    interleave with it).  Pass ``bus=`` (the tenants' shared
    EventBus) to tick on each pool's tagged ``demand`` events instead
    of re-reading k registries per tick; gateways publish the tag
    when built with ``tenant=<name>``.
    """

    def __init__(self, registry: TenantRegistry, *,
                 ledger: ChipLedger,
                 packer: TopologyBinPacker | None = None,
                 config: MtConfig | None = None,
                 metrics: FleetMetrics | None = None,
                 clock=time.monotonic,
                 bus=None,
                 tracer=None):
        self.registry = registry
        self.ledger = ledger
        self.packer = packer or TopologyBinPacker(ledger)
        self.cfg = config or MtConfig()
        self.arbiter = FairShareArbiter(
            up_after=self.cfg.up_after,
            down_after=self.cfg.down_after,
            regrow_after=self.cfg.regrow_after)
        self.metrics = metrics or FleetMetrics()
        self.clock = clock
        self.bus = bus
        self._bus_demand: dict[str, dict] = {}
        if bus is not None:
            bus.subscribe("demand", self._on_demand)
        #: actuation log: (clock t, kind, info) — the acceptance
        #: tests' and the probe's evidence of WHEN and in WHAT ORDER
        #: each cascade step fired
        self.events: list[tuple[float, str, dict]] = []
        #: optional span recorder (utils/tracing.py), same contract
        #: as the 1x1 reconciler: every arbiter actuation doubles as
        #: an instant "reconcile" span
        self.tracer = tracer
        self._trace_ctx = (tracer.begin("arbiter")
                           if tracer is not None else None)
        # labeled gauge children, resolved once per tenant: the
        # prometheus ``labels()`` lookup (lock + tuple build + child
        # dict) dominated the tick at fleet-simulator scale — 30k
        # lookups per tick at 10k tenants (sim/) — and the child for
        # a given tenant never changes
        self._gauge_cache: dict[str, tuple] = {}

    # -- signals ---------------------------------------------------------

    def _on_demand(self, ev) -> None:
        tenant = ev.payload.get("tenant")
        if tenant is not None:
            self._bus_demand[tenant] = dict(ev.payload)

    def _state_of(self, spec: TenantSpec) -> TenantState:
        w = self.registry.workload(spec.name)
        if w.kind == SERVING:
            cached = self._bus_demand.get(spec.name)
            if self.bus is not None and cached is not None:
                d = DemandSignals(
                    queue_depth=int(cached.get("queue_depth", 0)),
                    arrival_rate_rps=float(
                        cached.get("arrival_rate_rps", 0.0)),
                    slo_margin_ewma_s=cached.get("slo_margin_ewma_s"))
            else:
                d = read_demand(w.gateway)
            hot = pressured(d, self.cfg)
            calm = is_calm(d, self.cfg)
            held = len(w.chips())
            wanted = (spec.quota if hot
                      else spec.floor if calm else held)
            return TenantState(
                spec=spec, kind=SERVING, chips=frozenset(w.chips()),
                wanted=max(wanted, spec.floor),
                pressured=hot, calm=calm,
                adapter_bytes=w.adapter_bytes(spec.name),
                adapter_cold_bytes=w.adapter_cold_bytes(spec.name),
                draining=sum(1 for r in w.manager.replicas
                             if r.state == "draining"
                             and r.chip is not None))
        sup = w.supervisor
        return TenantState(
            spec=spec, kind=TRAINING, chips=frozenset(w.chips()),
            wanted=min(w.target_dp * w.tp, spec.quota),
            gang_dp=sup.dp, gang_tp=w.tp,
            parked=getattr(sup, "state", None) == "parked")

    # -- one tick --------------------------------------------------------

    def tick(self) -> list[str]:
        """One reconcile round; returns the action kinds applied."""
        now = self.clock()
        self.metrics.ticks.inc()
        applied: list[str] = []
        # 1. observe: health first, then forward heals to EVERY
        #    gang's exclusion set exactly once (readmit is a no-op
        #    for chips a gang never lost).  A heal landing MID-
        #    CASCADE is the double-fault trap: a healed chip the
        #    arbiter has since granted to another tenant must not
        #    rejoin a gang's buildable set just because its health
        #    came back — readmit clears the HEALTH fence (dead set),
        #    so foreign-owned chips are simultaneously added to the
        #    PLACEMENT fence, which the next arbiter-issued resize
        #    replaces wholesale once ownership genuinely moves.
        self.ledger.observe_health()
        healed = self.ledger.take_healed()
        if healed:
            for spec in self.registry:
                w = self.registry.workload(spec.name)
                if w.kind != TRAINING:
                    continue
                foreign = {c for c in healed
                           if (owner_tenant(self.ledger.owners.get(c))
                               or spec.name) != spec.name}
                if foreign:
                    w.supervisor.update_fence(add=foreign)
                w.supervisor.readmit(healed)
            self._event(now, "readmit", chips=sorted(healed))
        # 2. lifecycle housekeeping per serving pool (fleet mode:
        #    auto_replace off, replacement is an allocation decision)
        for spec in self.registry:
            w = self.registry.workload(spec.name)
            if w.kind != SERVING:
                continue
            for r in list(w.manager.replicas):
                if r.state == "dead":
                    w.manager.retire(r)
                    self._event(now, "reap_dead", tenant=spec.name,
                                replica=r.name, chip=r.chip)
                elif r.state == "draining" and not r.in_flight:
                    w.manager.retire(r)
                    self._event(now, "retired", tenant=spec.name,
                                replica=r.name, chip=r.chip)
                    applied.append("retired")
        # 3. ownership resync from the subsystems' own records,
        #    tenant-qualified for the conflict table
        self.ledger.sync_multi(
            (spec.name,
             w.manager if w.kind == SERVING else None,
             w.supervisor if w.kind == TRAINING else None)
            for spec, w in ((s, self.registry.workload(s.name))
                            for s in self.registry))
        # 4. decide + actuate (at most one scale action per tick)
        states = [self._state_of(spec) for spec in self.registry]
        action = self.arbiter.decide(states, self.ledger, self.packer)
        if action is not None:
            applied += self._apply(action, now)
        # 5. export the tick's per-tenant view
        self._export(states)
        if self.bus is not None:
            self.bus.publish("reconciler_tick",
                             actions=list(applied))
            self.bus.pump()
        return applied

    # -- actuation -------------------------------------------------------

    def _apply(self, a: MtAction, now: float) -> list[str]:
        w = self.registry.workload(a.tenant)
        if a.kind == GRANT:
            self.ledger.claim(a.chip, serving_tag(a.tenant, "pending"))
            # fence the chip out of every gang IMMEDIATELY: a gang
            # recovery re-forming this very cycle rebuilds from the
            # unfenced device set, and the granted chip is no longer
            # in it — the next packer-chosen resize replaces the
            # fence wholesale when ownership moves again
            for spec in self.registry:
                other = self.registry.workload(spec.name)
                if other.kind == TRAINING:
                    other.supervisor.update_fence(add=[a.chip])
            fresh = w.manager.add_replica(chip=a.chip)
            self._mt_event(now, a, replica=fresh.name, chip=a.chip)
            log.info("mt: grant %s -> chip %d (%s)", a.tenant, a.chip,
                     fresh.name)
            return [GRANT]
        if a.kind == RECLAIM_PARK:
            w.supervisor.park()
            self._mt_event(now, a)
            log.info("mt: parking %s for %s", a.tenant, a.beneficiary)
            return [RECLAIM_PARK]
        if a.kind == RECLAIM_SHRINK:
            tp = w.tp
            keep = self.packer.place_run(
                a.tenant, a.dp * tp,
                usable_owner=training_tag(a.tenant))
            exclude = (None if keep is None else
                       set(self.ledger.chips) - set(keep.chips))
            try:
                w.supervisor.request_width(a.dp, exclude=exclude)
            except ValueError as e:
                log.warning("mt: shrink %s to dp=%s refused: %s",
                            a.tenant, a.dp, e)
                return []
            self._mt_event(now, a, dp=a.dp)
            return [RECLAIM_SHRINK]
        if a.kind == RECLAIM_DRAIN or a.kind == RELEASE:
            idle = [r for r in w.manager.replicas
                    if r.ready and not r.in_flight]
            busy = [r for r in w.manager.replicas
                    if r.ready and r.in_flight]
            # newest idle first (old caches stay), busy only if the
            # reclaim has nothing idle to take — graceful either way
            victims = (list(reversed(idle))
                       + (list(reversed(busy))
                          if a.kind == RECLAIM_DRAIN else []))
            if a.kind == RECLAIM_DRAIN and self.cfg.domain_aware_drain:
                # a reclaim exists to UNBLOCK a higher-class grant,
                # and a grant is only ever blocked on overlap-token
                # conflicts — so prefer the victim whose drain leaves
                # the fewest chips that still conflict the
                # BENEFICIARY in its link domain (0 = the domain
                # empties for the claimant and the token frees);
                # newest-first stays as the tie-break
                victims = sorted(
                    enumerate(victims),
                    key=lambda iv: (self._domain_residue(
                        a.beneficiary, iv[1]), iv[0]))
                victims = [v for _, v in victims]
            for victim in victims:
                if not w.manager.begin_drain(victim):
                    continue
                self._mt_event(now, a, replica=victim.name,
                               chip=victim.chip)
                return [a.kind]
            return []
        if a.kind == ADAPTER_EVICT:
            quota = self.registry.spec(a.tenant).adapter_quota_bytes
            evicted: list[str] = []
            for pool in w.adapter_pools():
                for name in pool.cold_names(a.tenant):
                    if w.adapter_bytes(a.tenant) <= (quota or 0):
                        break
                    if pool.evict(name):
                        evicted.append(name)
            if not evicted:
                return []
            self._mt_event(now, a, adapters=evicted)
            log.info("mt: adapter quota evict %s: %s", a.tenant,
                     evicted)
            return [ADAPTER_EVICT]
        if a.kind == REGROW:
            if a.run is None:
                return []
            exclude = set(self.ledger.chips) - set(a.run)
            try:
                w.supervisor.request_width(a.dp, exclude=exclude)
            except ValueError as e:
                log.warning("mt: regrow %s to dp=%s refused: %s",
                            a.tenant, a.dp, e)
                return []
            self._mt_event(now, a, dp=a.dp, run=list(a.run))
            return [REGROW]
        return []

    def _domain_residue(self, beneficiary: str | None,
                        replica) -> int:
        """How many chips would still CONFLICT a grant to
        ``beneficiary`` in the victim's link domain after its drain —
        the domain-aware reclaim key (0 means the drain leaves the
        domain holding nothing but the claimant's own chips and free
        ones, so its overlap token frees).  The beneficiary's own
        chips never conflict its grant (binpack.place_chip skips
        ``holders - {tenant}``).  Chips the packer does not track
        sort last."""
        chip = replica.chip
        if chip is None or chip not in self.packer._pos:
            return len(self.ledger.chips)
        dom = self.packer.domain_of(chip)
        left = 0
        for c in self.packer.domain_chips(dom):
            owner = owner_tenant(self.ledger.owners.get(c))
            if c != chip and owner is not None and owner != beneficiary:
                left += 1
        return left

    def _mt_event(self, now: float, a: MtAction, **info) -> None:
        self.metrics.mt_actions.labels(tenant=a.tenant,
                                       action=a.kind).inc()
        if a.beneficiary:
            info["beneficiary"] = a.beneficiary
        self._event(now, a.kind, tenant=a.tenant, **info)

    def _event(self, t: float, kind: str, **info) -> None:
        self.events.append((t, kind, info))
        if self.tracer is not None:
            self.tracer.emit(self._trace_ctx, "reconcile", t,
                             track="reconciler", kind=kind, **info)

    # -- observability ---------------------------------------------------

    def _tenant_gauges(self, name: str) -> tuple:
        g = self._gauge_cache.get(name)
        if g is None:
            g = (self.metrics.tenant_chips.labels(tenant=name),
                 self.metrics.tenant_entitled.labels(tenant=name),
                 self.metrics.tenant_adapter_bytes.labels(
                     tenant=name))
            self._gauge_cache[name] = g
        return g

    def _export(self, states: list[TenantState]) -> None:
        for s in states:
            chips_g, ent_g, adapter_g = self._tenant_gauges(
                s.spec.name)
            chips_g.set(s.held)
            ent_g.set(self.arbiter.entitled.get(s.spec.name, 0))
            if s.kind == SERVING:
                adapter_g.set(s.adapter_bytes)
        free = len(self.ledger.healthy_free())
        self.metrics.chips.labels(owner="free").set(free)
        self.metrics.chips.labels(owner="unhealthy").set(
            len(self.ledger.unhealthy))

    def fairshare_error(self) -> float:
        """Instantaneous fair-share error: sum over tenants of
        |held − entitled| normalized by total entitlement — 0.0 when
        the allocation matches the water-filled ideal exactly (the
        ``mt_fairshare_err`` bench scalar samples this through a
        contention cycle)."""
        ent = self.arbiter.entitled
        if not ent:
            return 0.0
        states = [self._state_of(spec) for spec in self.registry]
        total = sum(ent.values()) or 1
        return sum(abs(s.held - ent.get(s.spec.name, 0))
                   for s in states) / total


__all__ = ["ADAPTER_EVICT", "FairShareArbiter", "GRANT", "MtAction",
           "MtConfig",
           "MultiTenantReconciler", "RECLAIM_DRAIN", "RECLAIM_PARK",
           "RECLAIM_SHRINK", "REGROW", "RELEASE", "ServingTenant",
           "TenantRegistry", "TenantSpec", "TenantState",
           "TrainingTenant", "entitlements"]
