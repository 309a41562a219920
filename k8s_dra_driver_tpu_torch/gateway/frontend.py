"""The fleet gateway: one front door over a pool of serving engines.

The port of ``k8s_dra_driver_tpu/gateway/frontend.py``, whole.
``FleetGateway`` is the pump that connects bounded SLO admission
(admission.py), prefix-affinity placement (router.py) and
health-driven replica lifecycle (replica.py) over port engines.

Invariants the CPU tests pin against the reference gateway
(tests/test_torch_gateway.py) and the card's smoke run pins at the
154M:

- **Exactly-once, byte-equal.**  Every admitted request reaches
  exactly one terminal status; finished tokens equal a single-engine
  oracle's byte-for-byte — routing, refills, drains and requeues are
  scheduling, never math (a requeued request re-runs from scratch on
  its new replica: greedy rows and seeded sampling make the rerun
  identical, and its partial work on the dead replica was cancelled
  via the engine's active-cancel hook, so nothing is emitted twice).
- **No silent drops.**  Overload turns into explicit
  ``rejected_full``/``shed_expired`` statuses and metrics, never
  missing uids.
- **Drain is observable.**  A replica kill surfaces as
  ``tpu_gateway_drains_total``/``tpu_gateway_requeued_total``
  advancing and second queue-wait samples for the victims.

The pump is single-threaded and clock-injected: one ``step()`` = shed,
health-poll, dispatch, step-ready-replicas, account.  On one card every
replica's engine lives on the same device and the pump steps them in
turn.

Event model (cluster/bus.py): the pump OWNS an :class:`EventBus`.
Engine prefix-cache hits/misses arrive as events (published by the
``PrefixCache.stats_listeners`` tap wired at replica spawn) and fold
into the fleet-wide counters at O(events) per step.  The pump publishes
``drain`` and ``demand`` events for other observers.  The bus is pumped
synchronously at the end of ``step()``: events change WHEN bookkeeping
happens inside a step, never outcomes.  ``_shed``/``_dispatch``/
``_account`` stay separately callable pieces, as the reference's
sharded gateway drives them.
"""

from __future__ import annotations

import time

from ..cluster.bus import EventBus
from ..models.serving import Finished, Request
from ..utils import dispatch, tracing
from ..utils.digest import DigestBank, NullDigestBank
from ..utils.metrics import GatewayMetrics

#: digest bank roster every pump carries (utils/digest.py): the
#: streaming-quantile twins of the three latency histograms
_DIGEST_SERIES = ("queue_wait", "ttft", "slo_margin")
from .admission import (DISPATCHED, FINISHED, QUEUED,
                        REJECTED_INVALID, SHED_EXPIRED, AdmissionError,
                        AdmissionQueue, GatewayRequest)
from .replica import DEAD, EngineReplica, ReplicaManager
from .router import (PrefixAffinityRouter, Router, _under_bound,
                     kv_admits)

# metrics outcome labels
_FINISHED_ATTAINED = "finished_attained"
_FINISHED_LATE = "finished_late"

# EWMA smoothing for the fleet-reconciler demand signals: heavy enough
# that one quiet (or bursty) pump step cannot flip a scaling decision,
# light enough that a sustained change shows within a few steps — the
# hysteresis the fleet policy adds on top is the real damper.
_RATE_ALPHA = 0.3
_MARGIN_ALPHA = 0.3


class FleetGateway:
    """SLO-aware admission + routing + drain over a replica pool."""

    def __init__(self, manager: ReplicaManager, *,
                 router: Router | None = None,
                 queue_capacity: int = 64,
                 metrics: GatewayMetrics | None = None,
                 clock=time.monotonic,
                 auto_replace: bool = True,
                 bus: EventBus | None = None,
                 pool_owner: bool = True,
                 tenant: str | None = None,
                 tracer=None,
                 burn=None,
                 memwatch=None,
                 digests: bool = True):
        self.manager = manager
        #: this pool's tenant in a multi-tenant fleet
        #: tags the pump's ``demand`` events so
        #: the arbiter can tell k pools apart on one bus, and is the
        #: default tag for untagged submits
        self.tenant = tenant
        self.router = router or PrefixAffinityRouter()
        self.queue = AdmissionQueue(queue_capacity)
        self.metrics = metrics or GatewayMetrics()
        self.clock = clock
        self.auto_replace = auto_replace
        #: uid -> terminal GatewayRequest (exactly-once bookkeeping)
        self.outcomes: dict = {}
        #: uid -> Finished (tokens) for completed requests
        self.results: dict = {}
        #: submit-time refusals (kept as records, uids may repeat)
        self.refused: list[GatewayRequest] = []
        #: per-replica dispatch attribution (utils/dispatch.py)
        self.per_replica = dispatch.Aggregator()
        self._steps = 0
        #: control-plane throughput counters
        self.admissions_total = 0
        self.routes_total = 0
        #: demand signals for the fleet reconciler: arrival-rate EWMA
        #: (updated once per pump step from the arrivals since the
        #: last one) and the signed SLO-margin EWMA over finished
        #: SLO-bearing requests (None until one finishes)
        self.arrival_rate_rps = 0.0
        self.slo_margin_ewma_s: float | None = None
        self._arrivals = 0
        self._rate_t = self.clock()
        #: the event spine (module docstring).  ``pool_owner=False``
        #: makes this a member pump of a sharded gateway: the sharded
        #: cycle owns the pool-level phases (health, replica stepping,
        #: engine-event wiring, demand publication) and this pump only
        #: sheds/dispatches its own shard.
        self.bus = bus if bus is not None else EventBus()
        self._pool_owner = pool_owner
        #: optional causal-span recorder (utils/tracing.py).  Every
        #: tracing touch below is behind ``is not None`` so the traced
        #: pump stays within the bench-pinned ≤1.05x overhead budget
        #: and an untraced pump pays one attribute check per phase.
        self.tracer = tracer
        self._trace_ctx = (tracer.begin(f"gw-{tenant or 'pool'}")
                           if tracer is not None else None)
        # per-replica last-seen eviction totals, so the fleet counter
        # advances by deltas (a replaced replica's name never recurs
        # — ReplicaManager names are generation-fresh)
        self._kv_evictions_seen: dict[str, int] = {}
        # tiered-KV counter fold (serving_kv/tiers.py): last seen
        # per-tier totals per replica, same delta-fold pattern
        self._kv_tier_seen: dict[str, dict[str, int]] = {}
        # adapter churn counter fold (serving_lora/): last seen
        # (cold_loads_total, evictions_total) per replica, same
        # delta-fold pattern as _kv_evictions_seen
        self._adapter_counts_seen: dict[str, tuple[int, int]] = {}
        #: per-replica speculative accept-rate EWMAs — the router's
        #: accept-aware preference signal, smoothed here (not in the
        #: engine) so a single cold window cannot flip placement
        self._spec_accept_ewma: dict[str, float] = {}
        #: per-pump streaming quantile digests (utils/digest.py) —
        #: each pump owns its OWN bank so a sharded gateway can merge
        #: them (the mergeability contract); ``digests=False`` swaps
        #: in the no-op bank (the observatory probe's off arm)
        self.digests = (DigestBank(_DIGEST_SERIES) if digests
                        else NullDigestBank(_DIGEST_SERIES))
        #: optional SLO burn-rate engine (gateway/burnrate.py
        #: ``SloBurnEngine``, or anything with ``attach``, ``observe``
        #: and ``step``): fed per terminal SLO-bearing outcome, stepped
        #: once per cycle
        self.burn = burn
        if burn is not None:
            burn.attach(self)
        #: optional per-component device-memory ledger
        #: (utils/memwatch.py ``MemWatch``, or anything with
        #: ``account_engine`` and ``forget``), fed from the per-step KV
        #: occupancy fold
        self.memwatch = memwatch
        #: the MemWatch units this gateway accounted, so a replica that
        #: left the pool stops reporting (``_forget_departed``)
        self._mw_units: set = set()
        if tracer is not None and pool_owner:
            tracing.wire_pool(tracer, manager)
        if pool_owner:
            self.metrics.pumps.set(1)
            # a standalone pump is its own merge group of one; a
            # sharded gateway (pool_owner=False members) registers the
            # merged-across-pumps view instead
            labels = {} if tenant is None else {"tenant": tenant}
            self.metrics.add_digest_source(lambda: self.digests,
                                           **labels)
            self.bus.subscribe("prefix", self._on_prefix_event)
            for r in manager.replicas:
                self._wire_replica(r)
            listeners = getattr(manager, "spawn_listeners", None)
            if listeners is not None:
                listeners.append(self._wire_replica)

    # -- intake ----------------------------------------------------------

    def submit(self, req: Request,
               slo_s: float | None = None, *,
               tenant: str | None = None,
               extra_live: frozenset = frozenset()) -> GatewayRequest:
        """Admit or refuse; ALWAYS returns the request's gateway
        record with an explicit status (``queued`` or a terminal
        rejection) — refusal is a return value here, not an exception,
        because shedding under load is an outcome the caller must see,
        not a bug.  ``tenant`` tags the record for the per-tenant
        metric series (defaults to the gateway's own tenant; never
        affects placement or admission).  ``extra_live``: uids queued
        in SIBLING pump shards of a sharded gateway, so the pool-wide
        duplicate contract spans shards."""
        now = self.clock()
        tenant = tenant if tenant is not None else self.tenant
        self._arrivals += 1      # offered load counts refusals too
        self.admissions_total += 1
        live = frozenset(
            uid for r in self.manager.replicas
            for uid in r.in_flight) | extra_live
        try:
            g = self.queue.offer(req, now, slo_s=slo_s, live_uids=live,
                                 tenant=tenant)
        except AdmissionError as e:
            g = GatewayRequest(request=req, arrival_s=now,
                               deadline_s=now, status=e.status,
                               tenant=tenant)
            self.refused.append(g)
            self.metrics.requests.labels(outcome=e.status).inc()
            if tenant is not None:
                self.metrics.tenant_requests.labels(
                    tenant=tenant, outcome=e.status).inc()
            if self.tracer is not None:
                # refusals get a one-span trace: the admit span IS the
                # terminal record (no dispatch ever happens), so the
                # exactly-once accounting can tell "refused at the
                # door" from "admitted and orphaned"
                g.trace = self.tracer.begin(req.uid, tenant)
                self.tracer.emit(g.trace, "admit", now,
                                 track="gateway", status=e.status)
            return g
        # uid reuse after a terminal outcome starts a FRESH lifecycle:
        # the old record is forgotten so the exactly-once guard in
        # _terminal keeps catching gateway bugs (a uid terminating
        # twice within ONE lifecycle), not client uid recycling
        self.outcomes.pop(req.uid, None)
        self.results.pop(req.uid, None)
        if self.tracer is not None:
            # admission is recorded ON the dispatch span (its t0 is
            # arrival, its ``depth`` attr is the depth seen here), not
            # as its own span: admission is the hottest path in the
            # control plane and one emit per request there is the
            # single biggest slice of the ≤1.05x overhead budget
            g.trace = self.tracer.begin(req.uid, tenant)
            g.trace.admit_depth = len(self.queue)
        self.metrics.queue_depth.set(len(self.queue))
        return g

    # -- the pump --------------------------------------------------------

    def step(self) -> list[GatewayRequest]:
        """One pump round; returns requests that reached a terminal
        status this round (finished or shed)."""
        now = self.clock()
        done: list[GatewayRequest] = []
        # 0. demand accounting: fold the arrivals since the last step
        #    into the rate EWMA (a zero-arrival step decays it, which
        #    is what lets the reconciler see calm)
        dt = now - self._rate_t
        if dt > 0:
            inst = self._arrivals / dt
            self.arrival_rate_rps = (_RATE_ALPHA * inst
                                     + (1 - _RATE_ALPHA)
                                     * self.arrival_rate_rps)
            self.metrics.arrival_rate.set(self.arrival_rate_rps)
            self._arrivals = 0
            self._rate_t = now
        # 1. shed-on-expired BEFORE dispatch: a dead-on-arrival-at-
        #    the-front request must never occupy a slot
        self._shed(now, done)
        # 2. health verdicts -> drain (stop dispatch, cancel, requeue)
        for replica in self.manager.poll_down():
            self._drain(replica, now)
        # 3. place what the pool can take; the rest stays queued
        #    (router returns None at the pool's depth bound)
        self._dispatch(now, done)
        # 4. advance every busy live replica — READY or DRAINING: a
        #    gracefully draining replica (scale-down) must finish its
        #    in-flight rows even though routers no longer feed it —
        #    attributing its host dispatches to its name
        for replica in list(self.manager.replicas):
            if replica.state == DEAD or not replica.in_flight:
                continue
            with dispatch.track() as t:
                finished = replica.step()
            self.per_replica.add(replica.name, t)
            self._account(replica, finished, done)
        # 5. leases + gauges + event accounting: the bus delivers this
        #    step's engine events (prefix hits/misses) into the
        #    registry at O(events) cost, and the demand snapshot goes
        #    out as an event for the reconciler to fold
        self.manager.heartbeat()
        self.metrics.queue_depth.set(len(self.queue))
        counts = self.manager.counts()
        for role, n in counts.pop("roles", {}).items():
            self.metrics.replica_roles.labels(role=role).set(n)
        for state, n in counts.items():
            self.metrics.replicas.labels(state=state).set(n)
        self._fold_kv_occupancy()
        self._fold_spec_accept()
        self._fold_adapter_occupancy()
        if self.memwatch is not None:
            self._forget_departed()
        self._drain_migrations()
        if self.burn is not None:
            # close the burn-rate cycle AFTER this step's terminal
            # accounting and BEFORE the bus pump, so an alert event
            # fired here is delivered within the same step
            self.burn.step()
        self.bus.publish("demand", queue_depth=len(self.queue),
                         arrival_rate_rps=self.arrival_rate_rps,
                         slo_margin_ewma_s=self.slo_margin_ewma_s,
                         tenant=self.tenant)
        if self.tracer is not None:
            self.tracer.flush()     # ONE "spans" event per step
        self.bus.pump()
        self._steps += 1
        return done

    # -- pump phases (a sharded gateway drives these separately) ----------

    def _shed(self, now: float, done: list[GatewayRequest]) -> None:
        """Phase 1: sweep expired queued requests into explicit
        terminal SHED outcomes."""
        for g in self.queue.shed_expired(now):
            self._terminal(g, SHED_EXPIRED, done)

    def _dispatch(self, now: float, done: list[GatewayRequest]) -> None:
        """Phase 3: place what the pool can take; the rest stays
        queued (router returns None at the pool's depth bound)."""
        while len(self.queue):
            g = self.queue.peek()
            # attribute-hint to the router (the last_reason idiom in
            # reverse): deadline-bearing requests prefer high-accept
            # replicas at equal depth; best-effort traffic keeps the
            # plain spill ordering.  The adapter hint gates
            # candidates on residency/headroom and makes warm
            # replicas win the spill tie.
            self.router.slo_tight = g.deadline_s != float("inf")
            self.router.adapter = getattr(g.request, "adapter", None)
            if self.tracer is None:
                route_s = 0.0
                target = self.router.route(g.request.prompt,
                                           self.manager.replicas)
            else:
                rt0 = self.clock()
                target = self.router.route(g.request.prompt,
                                           self.manager.replicas)
                route_s = self.clock() - rt0
            if target is None:
                # distinguish WHY the head is stuck: a depth-bounded
                # pool is ordinary backpressure, but candidates held
                # back solely by KV block headroom are fleet-wide
                # block exhaustion — counted so an operator can tell
                # "pool busy" from "pool out of KV memory" (the
                # request itself waits and sheds at its deadline:
                # shed-not-crash)
                if any(r.ready and _under_bound(r)
                       and not kv_admits(r, g.request.prompt)
                       for r in self.manager.replicas):
                    self.metrics.kv_exhausted_holds.inc()
                break
            g = self.queue.pop(now)
            if g is None:
                # the head expired AFTER this step's sweep — a drain
                # victim requeued past its deadline.  Shed it with the
                # explicit status right now (never dispatch it dead,
                # never crash the pump) and keep placing whatever live
                # work sits behind it.
                for expired in self.queue.shed_expired(now):
                    self._terminal(expired, SHED_EXPIRED, done)
                continue
            g.status = DISPATCHED
            g.replica = target.name
            g.dispatched_s = now
            try:
                target.enqueue(g)
            except ValueError:
                # the engine refused it (e.g. prompt + max_new exceeds
                # the cache): no replica in a homogeneous pool can run
                # it — an explicit terminal status, never a lost
                # request or a crashed pump
                self._terminal(g, REJECTED_INVALID, done)
                continue
            self.routes_total += 1
            self.metrics.queue_wait_seconds.observe(now - g.arrival_s)
            self.digests.observe("queue_wait", now - g.arrival_s)
            if g.tenant is not None:
                self.metrics.tenant_queue_wait_seconds.labels(
                    tenant=g.tenant).observe(now - g.arrival_s)
            if self.tracer is not None and g.trace is not None:
                # first placement spans [arrival, dispatch] — the
                # queue wait; a post-drain placement spans
                # [drained, re-dispatch] — the drain gap the
                # queue-wait histogram cannot attribute on its own
                gap = (g.requeues > 0
                       and g.trace.drained_s is not None)
                self.tracer.emit(
                    g.trace, "drain_gap" if gap else "dispatch",
                    g.trace.drained_s if gap else g.arrival_s, now,
                    track=target.name, replica=target.name,
                    route_s=route_s, requeues=g.requeues,
                    depth=g.trace.admit_depth,
                    why=getattr(self.router, "last_reason", None))

    def pending(self) -> int:
        """Queued (not yet dispatched) requests — the surface a
        trace-replay loop polls."""
        return len(self.queue)

    def run_until_idle(self, max_steps: int = 10_000
                       ) -> list[GatewayRequest]:
        """Pump until no request is queued or in flight; returns every
        terminal record from these rounds."""
        out: list[GatewayRequest] = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not len(self.queue) and not any(
                    r.in_flight for r in self.manager.replicas):
                return out
        raise RuntimeError(f"gateway not idle after {max_steps} steps")

    # -- internals -------------------------------------------------------

    def _account(self, replica: EngineReplica, finished: list[Finished],
                 done: list[GatewayRequest]) -> None:
        now = self.clock()
        tokens = replica.occupancy()["tokens"]
        for uid, n in tokens.items():
            g = replica.in_flight.get(uid)
            if g is not None and g.first_token_s is None and n >= 1:
                g.first_token_s = now
                self.metrics.ttft_seconds.observe(now - g.arrival_s)
                self.digests.observe("ttft", now - g.arrival_s)
        for f in finished:
            g = replica.in_flight.pop(f.uid, None)
            if g is None:
                # an engine must never emit a uid the gateway did not
                # place on it — surfacing it beats silent corruption
                raise RuntimeError(
                    f"replica {replica.name} finished unknown uid "
                    f"{f.uid!r}")
            if g.first_token_s is None:
                g.first_token_s = now
                self.metrics.ttft_seconds.observe(now - g.arrival_s)
                self.digests.observe("ttft", now - g.arrival_s)
            g.finished_s = now
            self.results[g.uid] = f
            self._terminal(g, FINISHED, done)

    def _terminal(self, g: GatewayRequest, status: str,
                  done: list[GatewayRequest]) -> None:
        if g.uid in self.outcomes:
            raise RuntimeError(
                f"uid {g.uid!r} reached a second terminal status "
                f"({self.outcomes[g.uid].status} then {status})")
        g.status = status
        if status == FINISHED:
            margin = g.deadline_s - g.finished_s
            if margin == float("inf"):
                outcome = _FINISHED_ATTAINED
            else:
                self.metrics.slo_margin_seconds.observe(margin)
                self.digests.observe("slo_margin", margin)
                prev = self.slo_margin_ewma_s
                self.slo_margin_ewma_s = (
                    margin if prev is None
                    else _MARGIN_ALPHA * margin
                    + (1 - _MARGIN_ALPHA) * prev)
                self.metrics.slo_margin_ewma.set(self.slo_margin_ewma_s)
                outcome = (_FINISHED_ATTAINED if margin >= 0
                           else _FINISHED_LATE)
        else:
            outcome = status
        self.metrics.requests.labels(outcome=outcome).inc()
        if g.tenant is not None:
            self.metrics.tenant_requests.labels(
                tenant=g.tenant, outcome=outcome).inc()
            # per-tenant SLO attainment: only SLO-bearing requests
            # count (an inf-deadline request cannot attain or miss
            # anything); a shed IS a miss — the user never got tokens
            if g.deadline_s != float("inf"):
                if outcome == _FINISHED_ATTAINED:
                    self.metrics.tenant_slo_attained.labels(
                        tenant=g.tenant).inc()
                    if self.burn is not None:
                        self.burn.observe(g.tenant, True)
                elif outcome in (_FINISHED_LATE, SHED_EXPIRED):
                    self.metrics.tenant_slo_missed.labels(
                        tenant=g.tenant).inc()
                    if self.burn is not None:
                        self.burn.observe(g.tenant, False)
        if self.tracer is not None and g.trace is not None:
            end = (g.finished_s if g.finished_s is not None
                   else self.clock())
            f = self.results.get(g.uid)
            toks = getattr(f, "tokens", None) if f is not None else None
            attrs = {"status": status, "outcome": outcome,
                     "tokens": 0 if toks is None else len(toks),
                     "requeues": g.requeues}
            if g.first_token_s is not None:
                attrs["ttft_s"] = g.first_token_s - g.arrival_s
            # the span covers decode (first token -> finish); sheds
            # and rejects collapse to an instant at the terminal time
            self.tracer.emit(
                g.trace, "terminal",
                g.first_token_s if g.first_token_s is not None
                else end, end,
                track=g.replica or "gateway", **attrs)
        self.outcomes[g.uid] = g
        done.append(g)

    def _wire_replica(self, replica: EngineReplica) -> None:
        """Tap a replica's engine-level event sources into the bus.
        Called for the initial pool and for every later spawn
        (``ReplicaManager.spawn_listeners``), so per-step accounting
        never has to walk the pool looking for newcomers.  Engines
        without a PrefixCache (stubs, null engines) wire nothing —
        and are therefore never touched by metrics accounting at all
        (the O(events) contract)."""
        cache = getattr(replica.engine, "_prefix", None)
        if cache is None or not hasattr(cache, "stats_listeners"):
            return
        name, bus = replica.name, self.bus
        cache.stats_listeners.append(
            lambda event, tokens, nbytes: bus.publish(
                "prefix", replica=name, event=event,
                tokens=tokens, nbytes=nbytes))

    def _on_prefix_event(self, ev) -> None:
        """Fold one engine prefix-cache event into the fleet-wide
        counters — the O(events) replacement for the per-step
        every-engine ``stats()`` scrape.  Totals stay equal to the
        sum of engine counters because the events fire exactly where
        those counters increment (``PrefixCache.longest_prefix``)."""
        p = ev.payload
        if p["event"] == "hit":
            self.metrics.prefix_hits.inc()
            if p["nbytes"]:
                self.metrics.prefix_bytes_reused.inc(p["nbytes"])
        elif p["event"] == "miss":
            self.metrics.prefix_misses.inc()

    def _fold_kv_occupancy(self) -> None:
        """Fold every paged replica's block-ledger levels into the
        registry, once per pump step.  Gauges are levels, not events
        — there is nothing to event-fold — and the walk touches only
        host-side numpy counters (KVBlockManager.view), so the cost
        is O(live replicas) with no device sync.  Replicas without
        the KV signal (contiguous engines, stubs) are skipped
        entirely — the same degrade contract as the router's
        ``kv_admits``."""
        for r in self.manager.replicas:
            if r.state == DEAD:
                continue
            occ = r.occupancy()
            if "kv_free_blocks" not in occ:
                continue
            if self.memwatch is not None:
                # per-replica byte attribution rides the same walk:
                # params + the paged pool's full reservation
                # (utils/memwatch.py account_engine)
                self.memwatch.account_engine(r.engine, unit=r.name)
                self._mw_units.add(r.name)
            free = occ["kv_free_blocks"]
            self.metrics.kv_blocks_free.labels(replica=r.name).set(free)
            self.metrics.kv_blocks_used.labels(replica=r.name).set(
                occ["kv_total_blocks"] - free)
            self.metrics.kv_cow_shared.labels(replica=r.name).set(
                occ["kv_cow_shared_blocks"])
            store = getattr(r.engine, "_prefix", None)
            total = getattr(store, "evictions", None)
            if total is not None:
                seen = self._kv_evictions_seen.get(r.name, 0)
                if total > seen:
                    self.metrics.kv_block_evictions.inc(total - seen)
                    self._kv_evictions_seen[r.name] = total
            # tiered stores (serving_kv/tiers.py) additionally fold
            # their per-tier counters as deltas and set the host-arena
            # level; untiered stores have no tier_counters — skipped
            tiers = getattr(store, "tier_counters", None)
            if tiers is not None:
                counts = tiers()
                seen = self._kv_tier_seen.setdefault(
                    r.name, dict.fromkeys(counts, 0))
                for kind, counter in (
                        ("hits", self.metrics.kv_tier_hits),
                        ("promotions",
                         self.metrics.kv_tier_promotions),
                        ("demotions",
                         self.metrics.kv_tier_demotions),
                        ("corrupt_fallbacks",
                         self.metrics.kv_tier_corrupt_fallbacks)):
                    if counts[kind] > seen[kind]:
                        counter.inc(counts[kind] - seen[kind])
                        seen[kind] = counts[kind]
                self.metrics.kv_host_arena_bytes.labels(
                    replica=r.name).set(store.host_arena_bytes())

    def _forget_departed(self) -> None:
        """Drop the ``MemWatch`` cells of replicas that left the pool
        (a graceful retire: a health drain already forgets its
        replica), so the ledger names only live replicas.  Port-only:
        the reference keeps a retired replica's bytes (ROADMAP Queue C
        item 18)."""
        live = {r.name for r in self.manager.replicas if r.state != DEAD}
        for unit in self._mw_units - live:
            self.memwatch.forget(unit)
        self._mw_units &= live

    def _fold_adapter_occupancy(self) -> None:
        """Fold every multi-adapter replica's pool levels and churn
        counters into the registry, once per pump step — the
        serving_lora twin of ``_fold_kv_occupancy``: residency and
        free-slot gauges are levels, cold-loads/evictions fold as
        counter deltas against the last-seen totals.  Replicas
        without the adapter signal are skipped (degrade contract)."""
        for r in self.manager.replicas:
            if r.state == DEAD:
                continue
            occ = r.occupancy()
            if "adapter_pool_slots" not in occ:
                continue
            if self.memwatch is not None and \
                    "kv_free_blocks" not in occ:
                # paged replicas were already accounted by the KV
                # fold; this covers contiguous engines with a pool
                self.memwatch.account_engine(r.engine, unit=r.name)
                self._mw_units.add(r.name)
            self.metrics.adapter_residents.labels(
                replica=r.name).set(len(occ["adapter_resident"]))
            self.metrics.adapter_pool_blocks_free.labels(
                replica=r.name).set(occ["adapter_free_slots"])
            pool = getattr(r.engine, "adapter_pool", None)
            if pool is None:
                continue
            cold, evic = (pool.cold_loads_total,
                          pool.evictions_total)
            seen = self._adapter_counts_seen.get(r.name, (0, 0))
            if cold > seen[0]:
                self.metrics.adapter_cold_loads.inc(cold - seen[0])
            if evic > seen[1]:
                self.metrics.adapter_evictions.inc(evic - seen[1])
            self._adapter_counts_seen[r.name] = (cold, evic)

    def _fold_spec_accept(self) -> None:
        """Fold each speculative replica's draft accept rate into a
        per-replica EWMA + gauge, once per pump step — the twin of
        ``_fold_kv_occupancy`` for the accept-aware routing signal.
        Smoothing lives HERE (not in the engine) so one cold window
        cannot flip placement; replicas without the signal (plain
        engines, stubs) are skipped — the degrade contract again."""
        for r in self.manager.replicas:
            if r.state == DEAD:
                continue
            rate = r.occupancy().get("spec_accept_rate")
            if rate is None:
                continue
            prev = self._spec_accept_ewma.get(r.name)
            ewma = (float(rate) if prev is None
                    else _RATE_ALPHA * float(rate)
                    + (1 - _RATE_ALPHA) * prev)
            self._spec_accept_ewma[r.name] = ewma
            self.metrics.spec_accept_rate.labels(
                replica=r.name).set(ewma)

    def _drain_migrations(self) -> None:
        """Fold the pool's KV-migration events into the registry —
        already event-shaped (the migrator keeps a take-exactly-once
        ledger), so the cost is O(migrations), not O(replicas)."""
        drain = getattr(self.manager, "drain_migration_events", None)
        if drain is not None:
            for wall_s, nbytes in drain():
                self.metrics.kv_migrations.inc()
                self.metrics.kv_bytes_moved.inc(nbytes)
                self.metrics.kv_migrate_seconds.observe(wall_s)

    def _drain(self, replica: EngineReplica,
               now: float | None = None) -> None:
        """Health-driven drain: the replica stops receiving dispatch
        (state DEAD), its in-flight rows are pulled back through the
        engine's active-cancel hook and requeued AT THE FRONT with
        their deadlines unchanged, and (``auto_replace``) a cold
        replacement joins the pool under a fresh name.  ``now`` is the
        pump cycle's timestamp: drained_s must not run AHEAD of the
        cycle clock, or a victim re-dispatched later in the same cycle
        would get a negative-duration drain-gap span."""
        self.metrics.drains.inc()
        self.manager.mark_down(replica)
        self.router.forget(replica.name)
        if self.memwatch is not None:
            self.memwatch.forget(replica.name)
        victims = list(replica.in_flight.values())
        replica.in_flight.clear()
        if now is None:
            now = self.clock() if self.tracer is not None else 0.0
        for g in reversed(victims):     # appendleft x reversed = FIFO
            try:
                replica.cancel(g.uid)
            except Exception:
                # a truly dead engine cannot cancel; the requeue is
                # what guarantees delivery either way
                pass
            self.queue.requeue(g)
            self.metrics.requeued.inc()
            if self.tracer is not None and g.trace is not None:
                # the victim's trace continues: this instant starts
                # the drain gap the next placement span closes
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
            "queued": len(self.queue),
            "in_flight": sum(len(r.in_flight)
                             for r in self.manager.replicas),
            "steps": self._steps,
            "outcomes": by_status,
            "replicas": self.manager.counts(),
            "per_replica_dispatches": self.per_replica.snapshot(),
        }


__all__ = ["FleetGateway"]
