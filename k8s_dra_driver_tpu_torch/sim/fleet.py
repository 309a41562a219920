"""Fleet construction: a thousand-replica, 10k-tenant simulated cluster
under the port's policy layer.

The port's copy of ``k8s_dra_driver_tpu/sim/fleet.py``.  It wires the
sim ducks (sim/workload.py) to the port's control plane:
:class:`~..fleet.supply.ChipLedger`,
:class:`~..fleet.binpack.TopologyBinPacker`,
:class:`~..fleet.tenancy.TenantRegistry` /
:class:`~..fleet.tenancy.MultiTenantReconciler`, over the event heap
(sim/clock.py).  Nothing in fleet/ is subclassed or monkeypatched: the
reconciler ticks against the simulated gateways and gangs exactly as
it ticks against live ones, and cluster/invariants.check_cycle sweeps
the result unchanged.  Everything here runs on the host.

Topology: ``n_domains * domain_size`` chips in interconnect (ledger)
order.  Training gangs take the HEAD domains, serving pools a per-pool
REGION behind them, and the tail domains stay free, the supply.py
head/tail convention at fleet scale.  Two placement modes:

- ``packed``: each pool's replicas fill its region contiguously, so
  free chips sit in whole, conflict-free link domains;
- ``spread``: each pool round-robins replicas across its region's
  domains (the availability-motivated topology-spreading pattern), so
  EVERY free chip shares a domain with an owned one and a newcomer's
  ``place_chip`` finds nothing conflict-free.

Workload: arrivals are scheduled UP FRONT as heap events from the
port's checked-in loadgen traces (gateway/loadgen.py), with a seeded
heavy-tail skew across the hot pools and a long-tail trickle across a
seeded subset of the 10k floor-zero tenants.  An idle replica, and an
idle tenant, therefore costs zero events: advancing an hour of virtual
quiet pops nothing.

Determinism: one ``np.random.default_rng(cfg.seed)`` drawn in a fixed
order at build time; everything after build is heap-ordered.  The same
seed replays the identical journal byte for byte.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np

from ..cluster import invariants
from ..fleet.binpack import TopologyBinPacker
from ..fleet.supply import ChipLedger
from ..fleet.tenancy import (MtConfig, MultiTenantReconciler,
                             ServingTenant, TenantRegistry, TenantSpec,
                             TrainingTenant)
from ..gateway import loadgen
from .clock import EventHeap
from .workload import SimGateway, SimSupervisor

SPIKE = "spike"


@dataclasses.dataclass
class SimConfig:
    """One simulated fleet's shape.  Defaults are the headline scale:
    2048 chips in 64 link domains, 1000 replicas across 6 pools,
    8 gangs of dp=8 x tp=4, 10k registered tenants."""

    seed: int = 7
    # supply
    n_domains: int = 64
    domain_size: int = 32
    # training gangs (head domains)
    n_gangs: int = 8
    gang_dp: int = 8
    gang_tp: int = 4
    gang_step_s: float = 0.25
    gang_ckpt_every: int = 5
    gang_recover_s: float = 2.0
    # serving pools
    n_pools: int = 6
    n_calm_pools: int = 2           # last pools get no arrivals
    n_replicas: int = 1000
    pool_region_domains: int = 8    # per-pool region width
    placement: str = "packed"       # or "spread"
    slots: int = 8
    service_s: float = 0.05
    queue_capacity: int = 512
    calm_floor: int = 128           # calm pools' guaranteed chips
    hot_floor: int = 16
    # tenants
    n_tenants: int = 10_000
    tail_active: int = 32           # long-tail tenants with arrivals
    tail_frac: float = 0.05
    # the high-priority newcomer the burst faults aim at
    spike_quota: int = 16
    # arrivals
    trace: str = "diurnal"
    n_requests: int = 2000
    arrival_rps: float = 20.0
    slo_s: float = 60.0
    hot_weights: tuple = (0.4, 0.3, 0.2, 0.1)
    # control plane
    cycle_s: float = 1.0
    mt_config: MtConfig | None = None
    # sim-layer starvation detector (docs/SIMULATION.md): consecutive
    # action-free ticks a pressured, under-entitled tenant waits with
    # free supply on the floor before it counts as a violation
    starve_after: int = 10

    @property
    def n_chips(self) -> int:
        return self.n_domains * self.domain_size

    @classmethod
    def contended(cls, placement: str = "spread",
                  **kw) -> "SimConfig":
        """The A/B / pathology shape: pool regions tile EVERY
        non-gang domain (no wholly-free tail domains), so under
        ``spread`` placement a newcomer's grant has no conflict-free
        chip anywhere and must go through the reclaim cascade — the
        layout the thousand-replica soak starved under (docs/
        SIMULATION.md).  ``packed`` over the same shape keeps whole
        domains free and grants instantly: the probe's A/B
        (sim/probe.py)."""
        base = dict(placement=placement, n_pools=8, n_calm_pools=2,
                    pool_region_domains=7, calm_floor=96,
                    hot_floor=8, tail_active=0,
                    hot_weights=(0.3, 0.2, 0.2, 0.15, 0.1, 0.05))
        base.update(kw)
        return cls(**base)

    @classmethod
    def tiny(cls, **kw) -> "SimConfig":
        """Testbed-sized fleet for the fast tier: 32 chips, 3 pools,
        one gang, a handful of tenants — same structure, same code
        paths, fraction-of-a-second soaks."""
        base = dict(n_domains=8, domain_size=4, n_gangs=1, gang_dp=2,
                    gang_tp=2, n_pools=3, n_calm_pools=1,
                    n_replicas=12, pool_region_domains=2,
                    n_tenants=24, tail_active=4, calm_floor=2,
                    hot_floor=1, spike_quota=2, n_requests=120,
                    arrival_rps=8.0, hot_weights=(0.6, 0.4))
        base.update(kw)
        return cls(**base)

    @classmethod
    def repro(cls, **kw) -> "SimConfig":
        """The ddmin target: the smallest fleet that still exhibits
        the drain-starvation pathology found at 1000 replicas
        (docs/SIMULATION.md).  28 chips in 7 four-chip domains, one
        gang domain plus three 2-domain pool regions tiling the rest
        (no conflict-free domain anywhere), ``spread`` placement, no
        background arrivals — the burst fault alone wedges the
        pre-fix arbiter.  This is the shape the drain-starvation
        regression tests pin."""
        base = dict(n_domains=7, domain_size=4, n_gangs=1, gang_dp=2,
                    gang_tp=2, n_pools=3, n_calm_pools=1,
                    n_replicas=15, pool_region_domains=2,
                    placement="spread", n_tenants=5, tail_active=0,
                    calm_floor=2, hot_floor=5, spike_quota=2,
                    n_requests=0, hot_weights=(0.6, 0.4))
        base.update(kw)
        return cls(**base)


class FleetSim:
    """The built fleet: heap + ledger + registry + reconciler + every
    simulated workload, plus the journal and invariant plumbing the
    soak rig (sim/rig.py) drives."""

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        self.heap = EventHeap()
        #: (virtual t, kind, info) — every gateway/gang/fault event;
        #: :meth:`journal_digest` pins byte-identical reruns over it
        self.journal: list[tuple] = []
        #: scripted health map the ledger polls (chip -> reason);
        #: the rig's chip_kill/heal faults mutate it
        self.health: dict[int, str] = {}
        self.ledger = ChipLedger(
            range(cfg.n_chips),
            health_source=lambda: dict(self.health))
        self.packer = TopologyBinPacker(self.ledger,
                                        domain_size=cfg.domain_size)
        self.registry = TenantRegistry(capacity=cfg.n_chips)
        self.gateways: dict[str, SimGateway] = {}
        self.sups: dict[str, SimSupervisor] = {}
        self.pool_names: list[str] = []
        self.hot_pools: list[str] = []
        self.calm_pools: list[str] = []
        self.tail_names: list[str] = []
        #: set by build_fleet: latest virtual time any scheduled
        #: arrival can still be alive (rig drains at least to here)
        self.arrival_horizon_s: float = 0.0
        self.recon: MultiTenantReconciler | None = None
        #: sim-layer starvation streaks (tenant -> action-free ticks
        #: spent pressured + under-entitled + supply-available)
        self._starve: dict[str, int] = {}
        self._records: list[tuple] | None = None
        self._gateway_pairs: list[tuple] | None = None

    # -- construction (build_fleet) --------------------------------------

    def _add_gateway(self, name: str, **kw) -> SimGateway:
        gw = SimGateway(name, self.heap, journal=self.journal, **kw)
        self.gateways[name] = gw
        return gw

    # -- invariant plumbing ----------------------------------------------

    def records(self) -> list[tuple]:
        """The ``sync_multi`` / ledger_conservation iterable, from
        the registry's own table.  Cached: the tenant census and
        every workload object are fixed at build time (only replica
        LISTS inside the managers mutate), and rebuilding 10k triples
        per cycle was pure sweep overhead."""
        if self._records is None:
            out = []
            for spec in self.registry:
                w = self.registry.workload(spec.name)
                if isinstance(w, ServingTenant):
                    out.append((spec.name, w.manager, None))
                else:
                    out.append((spec.name, None, w.supervisor))
            self._records = out
        return self._records

    def specs(self) -> list[TenantSpec]:
        return list(self.registry)

    def check(self) -> list[str]:
        """One full invariant sweep — the UNCHANGED production
        checkers (cluster/invariants.py) over the simulated fleet."""
        if self._gateway_pairs is None:
            self._gateway_pairs = list(self.gateways.items())
        return invariants.check_cycle(
            gateways=self._gateway_pairs,
            supervisors=list(self.sups.items()),
            ledger=self.ledger, records=self.records(),
            specs=self.specs(), events=self.recon.events)

    def check_starvation(self, applied: list[str]) -> list[str]:
        """Sim-layer liveness detector: a pressured serving tenant
        below entitlement, with healthy free chips on the floor,
        watching an ARBITER THAT TOOK NO ACTION — for
        ``cfg.starve_after`` consecutive ticks — is starving.  Blocked
        ticks during an advancing cascade don't count (every cascade
        step is an action); only a wedged arbiter does.  This is the
        detector that surfaced the domain-blind drain-ordering
        pathology (fleet/tenancy.py MtConfig.domain_aware_drain)."""
        violations: list[str] = []
        entitled = self.recon.arbiter.entitled
        free = len(self.ledger.healthy_free())
        for name, gw in self.gateways.items():
            queued = len(gw.queue)
            held = sum(1 for r in gw.manager.replicas
                       if r.state != "dead" and r.chip is not None)
            hungry = (queued >= self.recon.cfg.queue_high
                      and held < entitled.get(name, 0) and free > 0
                      and not applied)
            if not hungry:
                self._starve[name] = 0
                continue
            self._starve[name] = self._starve.get(name, 0) + 1
            if self._starve[name] >= self.cfg.starve_after:
                violations.append(
                    f"starvation: tenant {name} pressured "
                    f"{self._starve[name]} ticks below entitlement "
                    f"(held={held} < entitled={entitled.get(name, 0)})"
                    f" with {free} free chips and an idle arbiter")
        return violations

    def end_of_run(self) -> list[str]:
        """The end-of-run exactly-once sweep per gateway."""
        violations: list[str] = []
        for name, gw in self.gateways.items():
            violations += [f"[{name}] {v}" for v in
                           invariants.exactly_once_terminal(
                               gw, sorted(gw._uids))]
        return violations

    # -- evidence ---------------------------------------------------------

    def journal_digest(self) -> str:
        """sha256 over the canonical-JSON journal + reconciler event
        log — the byte-identity pin for same-seed reruns."""
        payload = json.dumps(
            [list(self.journal), list(self.recon.events)],
            sort_keys=True, separators=(",", ":"), default=str)
        return hashlib.sha256(payload.encode()).hexdigest()

    def fragmentation(self) -> dict:
        """The A/B detail row: how torn-up the free space is, and how
        reachable it is for a newcomer's grant."""
        table = self.packer.conflict_table()
        view = self.ledger.view()
        free_conflicted = sum(
            1 for c in view.free
            if table.get(self.packer.domain_of(c), set()))
        return {
            "free": len(view.free),
            "free_conflicted": free_conflicted,
            "straddled_domains": sum(
                1 for holders in table.values() if len(holders) > 1),
            "largest_free_block": view.largest_free_block,
        }


def _submit(gw: SimGateway, uid: str, service_s: float,
            slo_s: float) -> None:
    """Positional shim: EventHeap callbacks take ``*args`` only."""
    gw.submit(uid, service_s=service_s, slo_s=slo_s)


def _pool_counts(cfg: SimConfig) -> list[int]:
    base, extra = divmod(cfg.n_replicas, cfg.n_pools)
    return [base + (1 if p < extra else 0)
            for p in range(cfg.n_pools)]


def _place_pool(cfg: SimConfig, region_start: int, count: int
                ) -> list[int]:
    """Replica chips for one pool inside its region (module
    docstring: packed = contiguous fill, spread = domain round-robin
    — the topology-spreading layout)."""
    region = cfg.pool_region_domains * cfg.domain_size
    if count > region:
        raise ValueError(f"pool of {count} replicas exceeds its "
                         f"region of {region} chips")
    if cfg.placement == "packed":
        return [region_start + i for i in range(count)]
    if cfg.placement != "spread":
        raise ValueError(f"unknown placement {cfg.placement!r}")
    doms = cfg.pool_region_domains
    return [region_start + (k % doms) * cfg.domain_size + k // doms
            for k in range(count)]


def _place_gang(cfg: SimConfig, g: int) -> list[int]:
    """Gang g's home: one whole head domain when packed; striped
    across the head domains when spread."""
    width = cfg.gang_dp * cfg.gang_tp
    if width != cfg.domain_size:
        # homes are blocks of `width` chips from the head either way
        return list(range(g * width, (g + 1) * width))
    if cfg.placement == "packed":
        return list(range(g * width, (g + 1) * width))
    return [k * cfg.n_gangs + g for k in range(width)]


def build_fleet(cfg: SimConfig) -> FleetSim:
    """Construct (and start) the whole simulated fleet: gangs formed,
    replicas placed, tenants registered, arrivals scheduled, the
    reconciler clocked off the heap.  Pure build — no virtual time
    has passed when this returns."""
    fleet = FleetSim(cfg)
    rng = np.random.default_rng(cfg.seed)
    chips = fleet.ledger.chips

    # training gangs over the head domains
    for g in range(cfg.n_gangs):
        name = f"gang-{g}"
        home = _place_gang(cfg, g)
        sup = SimSupervisor(
            name, fleet.heap, universe=chips, tp=cfg.gang_tp,
            dp=cfg.gang_dp, step_s=cfg.gang_step_s,
            ckpt_every=cfg.gang_ckpt_every,
            recover_s=cfg.gang_recover_s, journal=fleet.journal)
        sup._placement_excluded = set(chips) - set(home)
        sup.start()
        fleet.sups[name] = sup
        fleet.registry.add(
            TenantSpec(name=name, priority=3,
                       quota=cfg.gang_dp * cfg.gang_tp,
                       floor=cfg.gang_tp if g % 2 == 0 else 0),
            TrainingTenant(sup))

    # serving pools over per-pool regions behind the gangs
    counts = _pool_counts(cfg)
    gang_chips = cfg.n_gangs * cfg.gang_dp * cfg.gang_tp
    region = cfg.pool_region_domains * cfg.domain_size
    if gang_chips + cfg.n_pools * region > cfg.n_chips:
        raise ValueError("fleet does not fit: gangs + pool regions "
                         "exceed the chip supply")
    n_hot = cfg.n_pools - cfg.n_calm_pools
    for p, count in enumerate(counts):
        name = f"pool-{p}"
        gw = fleet._add_gateway(
            name, queue_capacity=cfg.queue_capacity,
            service_s=cfg.service_s, slots=cfg.slots)
        for c in _place_pool(cfg, gang_chips + p * region, count):
            gw.manager.add_replica(chip=c)
        calm = p >= n_hot
        fleet.registry.add(
            TenantSpec(name=name, priority=2,
                       quota=count + (0 if calm else cfg.spike_quota),
                       floor=cfg.calm_floor if calm else cfg.hot_floor),
            ServingTenant(gw))
        fleet.pool_names.append(name)
        (fleet.calm_pools if calm else fleet.hot_pools).append(name)

    # the high-priority newcomer (burst faults target it)
    spike = fleet._add_gateway(
        SPIKE, queue_capacity=cfg.queue_capacity,
        service_s=cfg.service_s, slots=cfg.slots)
    fleet.registry.add(
        TenantSpec(name=SPIKE, priority=4, quota=cfg.spike_quota,
                   floor=0),
        ServingTenant(spike))

    # the long tail: floor-zero single-chip tenants to the configured
    # census.  They are REGISTERED (the reconciler and the invariant
    # sweep iterate all of them every cycle) but idle unless picked
    # into the active subset below — an idle tenant costs zero events
    n_named = cfg.n_gangs + cfg.n_pools + 1
    for i in range(max(cfg.n_tenants - n_named, 0)):
        name = f"t-{i:05d}"
        gw = fleet._add_gateway(
            name, queue_capacity=cfg.queue_capacity,
            service_s=cfg.service_s, slots=cfg.slots)
        fleet.registry.add(
            TenantSpec(name=name, priority=1, quota=1, floor=0),
            ServingTenant(gw))
        fleet.tail_names.append(name)

    # arrivals: open-loop, scheduled up front from the checked-in
    # trace (loadgen replay semantics: times fixed in advance).  RNG
    # draw order is fixed — interarrival trace is a fixture, then
    # pool picks, tail picks, service times — so the schedule is a
    # pure function of cfg.seed
    trace = loadgen.load_trace(cfg.trace)
    gaps = trace["interarrivals"]
    active_tail = (list(rng.choice(fleet.tail_names,
                                   size=min(cfg.tail_active,
                                            len(fleet.tail_names)),
                                   replace=False))
                   if cfg.tail_active and fleet.tail_names else [])
    hot_w = np.asarray(cfg.hot_weights[:n_hot], dtype=float)
    hot_w = hot_w / hot_w.sum()
    pool_pick = rng.choice(n_hot, size=cfg.n_requests, p=hot_w)
    tail_roll = rng.random(cfg.n_requests)
    tail_pick = (rng.integers(0, len(active_tail),
                              size=cfg.n_requests)
                 if active_tail else np.zeros(cfg.n_requests, int))
    service = rng.exponential(cfg.service_s, size=cfg.n_requests)
    t = 0.0
    for i in range(cfg.n_requests):
        t += gaps[i % len(gaps)] / cfg.arrival_rps
        if active_tail and tail_roll[i] < cfg.tail_frac:
            target = active_tail[int(tail_pick[i])]
        else:
            target = fleet.hot_pools[int(pool_pick[i])]
        fleet.heap.at(t, _submit, fleet.gateways[target],
                      f"req-{i:06d}", float(service[i]), cfg.slo_s)
    # latest virtual time any scheduled request can still be alive
    # (arrival + SLO window + longest service draw): the soak rig
    # drains to at least here so end-of-run exactly-once sweeps a
    # settled fleet, not one with arrivals still in the heap
    fleet.arrival_horizon_s = (
        t + cfg.slo_s + float(service.max())
        if cfg.n_requests else 0.0)

    # the reconciler, clocked off the heap's virtual now
    fleet.recon = MultiTenantReconciler(
        fleet.registry, ledger=fleet.ledger, packer=fleet.packer,
        config=cfg.mt_config or MtConfig(),
        clock=fleet.heap.clock)
    return fleet
