"""N admission/routing pumps over ONE replica pool.

The port of ``k8s_dra_driver_tpu/gateway/sharded.py``, whole, over
the port's ``FleetGateway`` / ``ReplicaManager`` /
``PrefixAffinityRouter``.  ``ShardedGateway`` splits the
admission/routing tier into N member pumps while keeping every
pool-level concern — health verdicts, drain/requeue, replica stepping,
lease heartbeats — exactly once per cycle:

- **Prefix-hash sharding.**  ``submit`` routes a request to the pump
  owning its prompt-head hash (crc32 of the first ``shard_tokens``
  tokens), so a shared-system-prompt family always lands in ONE pump
  and that pump's ``PrefixAffinityRouter`` sees the whole family.
- **Door spill.**  A FULL home shard sends the request to the
  least-loaded sibling with room instead of rejecting.
- **Work-stealing spill.**  After the dispatch round, any pump with an
  EMPTY queue steals the NEWEST queued request from the deepest
  sibling queue (FIFO heads — and drain victims requeued at the front
  — never move), then dispatches again.  Steal order is drawn from the
  bus's seeded RNG, so runs replay.
- **One pool cycle.**  ``step()`` = health-poll ONCE → drain (victims
  requeue at the FRONT of their owning pump, deadlines unchanged) →
  pumps shed+dispatch in seeded order → work-steal → advance every
  busy replica ONCE → account/heartbeat/events.  Member pumps share
  this gateway's ``outcomes``/``results``/``refused`` and metrics
  registry, so the exactly-once guard and every counter span shards.

Scheduling, never outcomes: with the same seed the cycle is fully
deterministic, and a replica killed mid-stream under bursty arrivals
leaves every stream byte-equal through 2 pumps exactly as through 1.
"""

from __future__ import annotations

import time
import zlib

import numpy as np

from ..cluster.bus import EventBus
from ..utils import dispatch, tracing
from ..utils.digest import DigestBank
from ..utils.metrics import GatewayMetrics
from .admission import QUEUED, GatewayRequest
from .frontend import FleetGateway, _RATE_ALPHA
from .replica import DEAD, EngineReplica, ReplicaManager
from .router import PrefixAffinityRouter


class ShardedGateway:
    """N gateway pumps serving one replica pool (module docstring).

    ``router_factory`` builds each pump's router (default: a fresh
    ``PrefixAffinityRouter`` per pump — shard-local history is correct
    because sharding is by prefix hash); ``queue_capacity`` is PER
    PUMP.  The surface mirrors ``FleetGateway`` (``submit`` / ``step``
    / ``run_until_idle`` / ``stats`` / ``outcomes`` / ``results``), so
    probes and the load generator drive either interchangeably.
    """

    def __init__(self, manager: ReplicaManager, *,
                 pumps: int = 2,
                 router_factory=None,
                 queue_capacity: int = 64,
                 metrics: GatewayMetrics | None = None,
                 bus: EventBus | None = None,
                 clock=time.monotonic,
                 auto_replace: bool = True,
                 steal: bool = True,
                 shard_tokens: int = 8,
                 seed: int = 0,
                 tenant: str | None = None,
                 tracer=None,
                 burn=None,
                 memwatch=None,
                 digests: bool = True):
        if pumps < 1:
            raise ValueError("ShardedGateway needs >= 1 pump")
        self.manager = manager
        #: shared span recorder: member pumps emit the per-request
        #: spans (admit/dispatch/terminal); the sharded cycle adds
        #: the tier-only arcs (door spill, steal, pool-level drain)
        self.tracer = tracer
        self._trace_ctx = (tracer.begin(f"gw-{tenant or 'pool'}")
                           if tracer is not None else None)
        if tracer is not None:
            tracing.wire_pool(tracer, manager)
        #: same contract as FleetGateway.tenant: tags demand events
        #: and defaults untagged submits
        self.tenant = tenant
        self.metrics = metrics or GatewayMetrics()
        self.bus = bus if bus is not None else EventBus(seed=seed)
        self.clock = clock
        self.auto_replace = auto_replace
        self.steal = steal
        self.shard_tokens = shard_tokens
        router_factory = router_factory or PrefixAffinityRouter
        # shared terminal bookkeeping: ONE outcomes dict across pumps
        # means the exactly-once guard in _terminal spans shards
        self.outcomes: dict = {}
        self.results: dict = {}
        self.refused: list[GatewayRequest] = []
        self.per_replica = dispatch.Aggregator()
        #: shared SLO burn-rate engine (gateway/burnrate.py
        #: ``SloBurnEngine``): member pumps feed observe() from their
        #: terminal accounting; the CYCLE steps it exactly once (member
        #: step() never runs)
        self.burn = burn
        #: shared device-memory ledger (utils/memwatch.py ``MemWatch``),
        #: fed by the member pumps
        self.memwatch = memwatch
        self.pumps: list[FleetGateway] = []
        for _ in range(pumps):
            p = FleetGateway(
                manager, router=router_factory(),
                queue_capacity=queue_capacity, metrics=self.metrics,
                clock=clock, auto_replace=False, bus=self.bus,
                pool_owner=False, tracer=tracer, burn=burn,
                memwatch=memwatch, digests=digests)
            p.outcomes = self.outcomes
            p.results = self.results
            p.refused = self.refused
            self.pumps.append(p)
        if burn is not None:
            burn.attach(self)
        # the merge contract on the production render path: the
        # registry's digest source is the ON-DEMAND merge of every
        # member pump's own bank (utils/digest.py merged)
        labels = {} if tenant is None else {"tenant": tenant}
        self.metrics.add_digest_source(self.merged_digests, **labels)
        #: live uid -> owning pump index (drain victims requeue HOME)
        self._owner: dict = {}
        self._steps = 0
        self.admissions_total = 0
        self.steals_total = 0
        # fleet-level demand EWMA (the per-pump ones only see shards)
        self.arrival_rate_rps = 0.0
        self._arrivals = 0
        self._rate_t = self.clock()
        self.metrics.pumps.set(pumps)
        # pool-owner duties: engine event taps + the prefix fold
        self.bus.subscribe("prefix", self.pumps[0]._on_prefix_event)
        for r in manager.replicas:
            self.pumps[0]._wire_replica(r)
        listeners = getattr(manager, "spawn_listeners", None)
        if listeners is not None:
            listeners.append(self.pumps[0]._wire_replica)

    # -- demand signal (the fleet reconciler's contract) ------------------

    @property
    def slo_margin_ewma_s(self) -> float | None:
        # every FINISH is accounted through pump 0 (_account runs
        # there for all replicas), so its EWMA is the fleet's
        return self.pumps[0].slo_margin_ewma_s

    # -- intake ----------------------------------------------------------

    def _shard(self, prompt) -> int:
        arr = np.asarray(prompt, np.int32)
        head = arr[:max(min(self.shard_tokens, arr.size - 1), 1)]
        return zlib.crc32(head.tobytes()) % len(self.pumps)

    def submit(self, req, slo_s: float | None = None, *,
               tenant: str | None = None) -> GatewayRequest:
        """Admit into the prompt's home shard (or refuse with the
        explicit status).  The duplicate-uid contract spans shards:
        sibling pumps' queued uids ride in as ``extra_live``.  Door
        spill: a FULL home shard sends the request to the least-loaded
        sibling with room instead of rejecting — reject-on-full means
        the whole TIER is full, not one hot shard (the request loses
        its affinity placement, which is the same trade the unified
        router's least-depth spill already makes)."""
        self.admissions_total += 1
        self._arrivals += 1
        i = home = self._shard(req.prompt)
        if len(self.pumps[i].queue) >= self.pumps[i].queue.capacity:
            j = min(range(len(self.pumps)),
                    key=lambda k: (len(self.pumps[k].queue), k))
            if len(self.pumps[j].queue) < self.pumps[j].queue.capacity:
                i = j
        extra = set()
        for j, p in enumerate(self.pumps):
            if j != i:
                extra.update(p.queue.uids())
        g = self.pumps[i].submit(
            req, slo_s, tenant=(tenant if tenant is not None
                                else self.tenant),
            extra_live=frozenset(extra))
        if g.status == QUEUED:
            self._owner[req.uid] = i
            if (self.tracer is not None and g.trace is not None
                    and i != home):
                # door spill: admitted, but away from its affinity
                # home — the trace records the placement sacrifice
                self.tracer.emit(g.trace, "spill", g.arrival_s,
                                 track="gateway", home=home, pump=i)
        return g

    # -- the cycle --------------------------------------------------------

    def step(self) -> list[GatewayRequest]:
        """One control cycle; returns every terminal record."""
        now = self.clock()
        done: list[GatewayRequest] = []
        # 0. fleet demand accounting (same EWMA as the single pump)
        dt = now - self._rate_t
        if dt > 0:
            inst = self._arrivals / dt
            self.arrival_rate_rps = (_RATE_ALPHA * inst
                                     + (1 - _RATE_ALPHA)
                                     * self.arrival_rate_rps)
            self.metrics.arrival_rate.set(self.arrival_rate_rps)
            self._arrivals = 0
            self._rate_t = now
        # 1. health ONCE per cycle (N pumps must not multiply polls —
        #    fault-plan skip counts and probe costs stay pump-count-
        #    independent), then drain
        for replica in self.manager.poll_down():
            self._drain(replica, now)
        # 2. admission pumps in seeded order: shed + dispatch
        for i in self.bus.shuffle(range(len(self.pumps))):
            self.pumps[i]._shed(now, done)
            self.pumps[i]._dispatch(now, done)
        # 3. work-steal so a hot shard's backlog spreads to idle pumps
        if self.steal and len(self.pumps) > 1:
            self._work_steal(now, done)
        # 4. advance every busy live replica ONCE
        for replica in list(self.manager.replicas):
            if replica.state == DEAD or not replica.in_flight:
                continue
            with dispatch.track() as t:
                finished = replica.step()
            self.per_replica.add(replica.name, t)
            # shared outcomes/results/metrics make pump 0 the fleet
            # accountant for TTFT + finishes
            self.pumps[0]._account(replica, finished, done)
        for g in done:
            self._owner.pop(g.uid, None)
        # 5. leases + gauges + events
        self.manager.heartbeat()
        self.metrics.queue_depth.set(self.pending())
        counts = self.manager.counts()
        for role, n in counts.pop("roles", {}).items():
            self.metrics.replica_roles.labels(role=role).set(n)
        for state, n in counts.items():
            self.metrics.replicas.labels(state=state).set(n)
        self.pumps[0]._drain_migrations()
        if self.burn is not None:
            # exactly once per CYCLE (member pump step() never runs
            # under the sharded cycle), after terminal accounting and
            # before the bus pump — same ordering as the single pump
            self.burn.step()
        self.bus.publish("demand", queue_depth=self.pending(),
                         arrival_rate_rps=self.arrival_rate_rps,
                         slo_margin_ewma_s=self.slo_margin_ewma_s,
                         tenant=self.tenant)
        if self.tracer is not None:
            self.tracer.flush()     # ONE "spans" event per cycle
        self.bus.pump()
        self._steps += 1
        return done

    def run_until_idle(self, max_steps: int = 10_000
                       ) -> list[GatewayRequest]:
        out: list[GatewayRequest] = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not self.pending() and not any(
                    r.in_flight for r in self.manager.replicas):
                return out
        raise RuntimeError(f"gateway not idle after {max_steps} steps")

    def pending(self) -> int:
        return sum(len(p.queue) for p in self.pumps)

    def merged_digests(self) -> DigestBank:
        """The fleet view of the per-pump quantile digests: a fresh
        bucket-wise merge on every call, so render/debug always see
        current counts.  Merge-of-parts equals the whole-stream
        digest exactly (utils/digest.py)."""
        return DigestBank.merged(p.digests for p in self.pumps)

    @property
    def routes_total(self) -> int:
        return sum(p.routes_total for p in self.pumps)

    # -- internals -------------------------------------------------------

    def _work_steal(self, now: float,
                    done: list[GatewayRequest]) -> None:
        """Idle pumps pull the newest queued request off the deepest
        sibling queue until no pump is empty while another holds a
        backlog, then the thieves dispatch.  Moves are scheduling
        only: arrival time, deadline, and requeue count travel with
        the request."""
        thieves = set()
        while True:
            lens = [len(p.queue) for p in self.pumps]
            hungry = [i for i, n in enumerate(lens) if n == 0]
            donor = max(range(len(lens)), key=lambda i: lens[i])
            if not hungry or lens[donor] <= 1:
                break
            thief = self.bus.shuffle(hungry)[0]
            g = self.pumps[donor].queue.steal_newest()
            if g is None:
                break
            self.pumps[thief].queue.adopt(g)
            self._owner[g.uid] = thief
            self.steals_total += 1
            self.metrics.steals.inc()
            if self.tracer is not None and g.trace is not None:
                self.tracer.emit(g.trace, "steal", now,
                                 track="gateway", donor=donor,
                                 thief=thief)
            thieves.add(thief)
        for i in sorted(thieves):
            self.pumps[i]._dispatch(now, done)

    def _drain(self, replica: EngineReplica,
               now: float | None = None) -> None:
        """Pool-level drain: same contract as the single pump's
        (active-cancel, requeue at the FRONT with deadlines unchanged,
        optional cold replacement) except each victim returns to the
        queue of the pump that OWNED it — its shard home, so affinity
        re-forms where the family lives.  ``now`` is the cycle's
        timestamp (see FleetGateway._drain: drained_s must not run
        ahead of the clock the re-dispatch spans read)."""
        self.metrics.drains.inc()
        self.manager.mark_down(replica)
        for p in self.pumps:
            p.router.forget(replica.name)
        victims = list(replica.in_flight.values())
        replica.in_flight.clear()
        if now is None:
            now = self.clock() if self.tracer is not None else 0.0
        for g in reversed(victims):     # appendleft x reversed = FIFO
            try:
                replica.cancel(g.uid)
            except Exception:
                pass
            owner = self._owner.get(g.uid, 0)
            self.pumps[owner].queue.requeue(g)
            self.metrics.requeued.inc()
            if self.tracer is not None and g.trace is not None:
                g.trace.drained_s = now
                self.tracer.emit(g.trace, "requeue", now,
                                 track=replica.name,
                                 replica=replica.name,
                                 requeues=g.requeues)
        if self.tracer is not None:
            self.tracer.emit(self._trace_ctx, "drain", now,
                             track="gateway", replica=replica.name,
                             requeued=len(victims))
        self.bus.publish("drain", replica=replica.name,
                         requeued=len(victims))
        if self.auto_replace:
            self.manager.replace(replica)

    # -- observability ---------------------------------------------------

    def stats(self) -> dict:
        by_status: dict[str, int] = {}
        for g in self.outcomes.values():
            by_status[g.status] = by_status.get(g.status, 0) + 1
        for g in self.refused:
            by_status[g.status] = by_status.get(g.status, 0) + 1
        return {
            "pumps": len(self.pumps),
            "queued": self.pending(),
            "queued_per_pump": [len(p.queue) for p in self.pumps],
            "in_flight": sum(len(r.in_flight)
                             for r in self.manager.replicas),
            "steps": self._steps,
            "steals": self.steals_total,
            "outcomes": by_status,
            "replicas": self.manager.counts(),
            "per_replica_dispatches": self.per_replica.snapshot(),
        }


__all__ = ["ShardedGateway"]
