"""The fleet reconciler: one control loop over serving and training.

The port's copy of ``k8s_dra_driver_tpu/fleet/reconciler.py``, over the
port's gateway (gateway/frontend.py, gateway/replica.py).  A periodic
``tick`` over

- **demand** — the ``GatewayMetrics`` gauges (queue depth, signed
  SLO-margin EWMA, arrival-rate EWMA), read from the metrics registry
  so the wiring works for anything that exports them;
- **supply** — the :class:`~.supply.ChipLedger` (free, contiguous,
  healthy chips; ownership recomputed each tick from the replica pool
  and the gang's worker records); and
- **policy** — :class:`~.policy.FleetPolicy` hysteresis,

actuating exclusively through existing machinery: replica scale-up /
graceful-drain / retire on the :class:`~..gateway.replica.ReplicaManager`,
and gang resizes through the supervisor's ``request_width`` /
``readmit`` (duck-typed: any object with those verbs, ``dp``, ``job.tp``
and ``workers``; ``supervisor=None`` runs a serving-only fleet).  The
reconciler never touches an engine or a tensor directly: it moves
chips, the subsystems move work.

Run shape: like the gateway pump, the reconciler is single-threaded
and clock-injected — ``tick()`` is the unit, driven either by the
owner's own co-loop (``gw.step(); rec.tick()``) or by
``start(interval)``'s daemon thread in a long-running process.  Pool
health flows through the ledger's ONE observation
(``ledger.current_unhealthy`` as the manager's health_source), so the
pump's drain verdicts and the reconciler's supply view can never
disagree about which chips are down.  Fleet mode expects the gateway's
``auto_replace=False``: replacement is an allocation decision, and the
reconciler owns those.
"""

from __future__ import annotations

import logging
import threading
import time

from ..utils.metrics import FleetMetrics
from .policy import (Action, DemandSignals, FleetPolicy, PREEMPT,
                     REGROW, SCALE_DOWN, SCALE_UP)
from .supply import ChipLedger

log = logging.getLogger(__name__)


def read_demand(gateway) -> DemandSignals:
    """One gateway's demand signals scraped from its
    ``GatewayMetrics`` registry — the gauges are the contract, not
    the gateway object's internals.  Shared by the 1x1 reconciler's
    no-bus fallback and the multi-tenant arbiter (fleet/tenancy.py),
    which reads one of these PER TENANT pool."""
    reg = gateway.metrics.registry
    qd = reg.get_sample_value("tpu_gateway_queue_depth") or 0.0
    rate = reg.get_sample_value("tpu_gateway_arrival_rate_rps") or 0.0
    # the gauge defaults to 0.0 before any SLO-bearing request
    # finishes; the gateway object knows the difference, so prefer
    # its None when it has seen nothing (0.0 would read "exactly on
    # deadline" — neutral, but None is honest)
    margin = getattr(gateway, "slo_margin_ewma_s", None)
    if margin is None:
        margin_sample = reg.get_sample_value(
            "tpu_gateway_slo_margin_ewma_seconds")
        margin = margin_sample if margin_sample else None
    return DemandSignals(queue_depth=int(qd),
                         arrival_rate_rps=float(rate),
                         slo_margin_ewma_s=margin)


class FleetReconciler:
    """Demand-driven autoscaling + chip arbitration (module docstring).

    ``supervisor`` may be None (a serving-only fleet): preempt/regrow
    decisions are then never emitted because ``gang_dp`` reads 0.
    ``policy.train_target_dp`` defaults to the supervisor's formation
    width at construction — the width regrow aims back at.
    """

    def __init__(self, gateway, supervisor=None, *,
                 ledger: ChipLedger,
                 policy: FleetPolicy | None = None,
                 metrics: FleetMetrics | None = None,
                 clock=time.monotonic,
                 bus=None,
                 tracer=None):
        self.gateway = gateway
        self.supervisor = supervisor
        self.ledger = ledger
        self.policy = policy or FleetPolicy()
        if self.policy.train_target_dp is None and supervisor is not None:
            self.policy.train_target_dp = supervisor.dp
        self.metrics = metrics or FleetMetrics()
        self.clock = clock
        #: event-driven demand (cluster/bus.py): subscribe to the
        #: gateway pump's per-step ``demand`` events and tick on the
        #: CACHED latest instead of re-reading the metrics registry
        #: every tick — O(events), and the reconciler sees exactly
        #: what the pump published, not a racy re-scrape.  Pass the
        #: gateway's own bus; None keeps the registry-read fallback.
        self.bus = bus
        self._bus_demand: DemandSignals | None = None
        if bus is not None:
            bus.subscribe("demand", self._on_demand)
        #: actuation log: (clock t, action kind, info dict) — the
        #: probe's and the tests' evidence of WHEN each decision fired
        self.events: list[tuple[float, str, dict]] = []
        #: optional span recorder (utils/tracing.py): every actuation
        #: ALSO lands as an instant "reconcile" span on the
        #: reconciler's own trace, so a preemption cascade and the
        #: request drains it caused line up on one timeline
        self.tracer = tracer
        self._trace_ctx = (tracer.begin("reconciler")
                           if tracer is not None else None)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- one tick --------------------------------------------------------

    def tick(self) -> list[str]:
        """One reconcile round; returns the action kinds applied (at
        most one scale action, plus any lifecycle housekeeping)."""
        now = self.clock()
        self.metrics.ticks.inc()
        mgr = self.gateway.manager
        # 1. observe: health first (the supply view must be current
        #    before any decision), then forward heals to the
        #    supervisor's exclusion set exactly once
        self.ledger.observe_health()
        healed = self.ledger.take_healed()
        if healed and self.supervisor is not None:
            self.supervisor.readmit(healed)
            self._event(now, "readmit", chips=sorted(healed))
        # 2. lifecycle housekeeping the pump does not own in fleet
        #    mode: drained-dead replicas leave the pool (replacement
        #    is OUR call, auto_replace is off), and graceful drains
        #    whose in-flight work finished retire, freeing their chips
        applied: list[str] = []
        for r in list(mgr.replicas):
            if r.state == "dead":
                mgr.retire(r)
                self._event(now, "reap_dead", replica=r.name,
                            chip=r.chip)
            elif r.state == "draining" and not r.in_flight:
                mgr.retire(r)
                self.metrics.scale_events.labels(action="down").inc()
                self._event(now, "retired", replica=r.name,
                            chip=r.chip)
                applied.append("retired")
        # 3. ownership resync from the subsystems' own records
        self.ledger.sync(mgr, self.supervisor)
        # 4. decide + actuate (at most one scale action per tick)
        demand = self._demand()
        live = [r for r in mgr.replicas if r.state != "dead"]
        action = self.policy.decide(
            demand, self.ledger,
            replicas=len(live),
            idle_replicas=sum(1 for r in live
                              if r.ready and not r.in_flight),
            gang_dp=self.supervisor.dp if self.supervisor else 0,
            gang_tp=self._gang_tp())
        if action is not None:
            applied += self._apply(action, now)
        # 5. export the tick's view; on a bus, the tick itself is an
        #    event other subsystems (and the chaos journal) can see
        self._export()
        if self.bus is not None:
            self.bus.publish("reconciler_tick", actions=list(applied))
            self.bus.pump()
        return applied

    # -- signals ---------------------------------------------------------

    def _on_demand(self, ev) -> None:
        """Cache the gateway pump's latest demand event (bus mode)."""
        p = ev.payload
        margin = p.get("slo_margin_ewma_s")
        self._bus_demand = DemandSignals(
            queue_depth=int(p.get("queue_depth", 0)),
            arrival_rate_rps=float(p.get("arrival_rate_rps", 0.0)),
            slo_margin_ewma_s=margin)

    def _demand(self) -> DemandSignals:
        """Demand signals: the cached bus event when riding the
        gateway's bus (no registry re-read per tick), else
        :func:`read_demand` over the gateway's registry."""
        if self.bus is not None and self._bus_demand is not None:
            return self._bus_demand
        return read_demand(self.gateway)

    def _gang_tp(self) -> int:
        if self.supervisor is None:
            return 1
        return int(getattr(self.supervisor.job, "tp", 1))

    # -- actuation -------------------------------------------------------

    def _apply(self, action: Action, now: float) -> list[str]:
        mgr = self.gateway.manager
        if action.kind == SCALE_UP:
            chip = self.ledger.take_for_serving()
            if chip is None:            # raced away since decide()
                return []
            # role-aware growth: add_replica defaults to the
            # manager's default_scale_role — decode in a
            # disaggregated pool (capacity lives there), unified
            # otherwise
            fresh = mgr.add_replica(chip=chip)
            self.metrics.scale_events.labels(action="up").inc()
            self._event(now, SCALE_UP, replica=fresh.name, chip=chip,
                        role=fresh.role)
            log.info("fleet: scale-up %s (%s) onto chip %d",
                     fresh.name, fresh.role, chip)
            return [SCALE_UP]
        if action.kind == SCALE_DOWN:
            idle = [r for r in mgr.replicas
                    if r.ready and not r.in_flight]
            # newest idle first (old caches stay); begin_drain may
            # refuse a victim on role grounds (the last prefill
            # replica), so walk the candidates until one accepts
            for victim in reversed(idle):
                if not mgr.begin_drain(victim):
                    continue
                self._event(now, SCALE_DOWN, replica=victim.name,
                            chip=victim.chip, role=victim.role)
                log.info("fleet: draining %s for scale-down",
                         victim.name)
                return [SCALE_DOWN]
            return []
        if action.kind in (PREEMPT, REGROW):
            if self.supervisor is None:
                return []
            try:
                self.supervisor.request_width(action.dp)
            except ValueError as e:
                log.warning("fleet: %s to dp=%s refused: %s",
                            action.kind, action.dp, e)
                return []
            self.metrics.scale_events.labels(action=action.kind).inc()
            self.metrics.gang_dp_target.set(action.dp)
            self._event(now, action.kind, dp=action.dp)
            log.info("fleet: requested gang %s to dp=%d",
                     action.kind, action.dp)
            return [action.kind]
        return []

    def _event(self, t: float, kind: str, **info) -> None:
        self.events.append((t, kind, info))
        if self.tracer is not None:
            self.tracer.emit(self._trace_ctx, "reconcile", t,
                             track="reconciler", kind=kind, **info)

    # -- observability ---------------------------------------------------

    def _export(self) -> None:
        view = self.ledger.view()
        self.metrics.chips.labels(owner="free").set(len(view.free))
        self.metrics.chips.labels(owner="serving").set(
            len(view.serving))
        self.metrics.chips.labels(owner="training").set(
            len(view.training))
        self.metrics.chips.labels(owner="unhealthy").set(
            len(view.unhealthy))
        self.metrics.pressure_ticks.set(self.policy.hot)
        self.metrics.calm_ticks.set(self.policy.calm)

    def serve_metrics(self, address: str = "127.0.0.1:0",
                      debug_source=None):
        """Mount the fleet's combined exposition — reconciler +
        gateway + supervisor registries, and the gateway's ``MemWatch``
        when it has one, on one ``/metrics`` (utils/httpendpoint.py) —
        and return the started endpoint.  ``debug_source`` (a
        zero-arg callable returning a JSON-safe dict) additionally
        mounts ``/debugz``."""
        from ..utils.httpendpoint import HTTPEndpoint
        extras = [self.gateway.metrics]
        if self.supervisor is not None:
            extras.append(self.supervisor.metrics)
        # port-only: the reference leaves the device-memory ledger off
        # this scrape
        memwatch = getattr(self.gateway, "memwatch", None)
        if memwatch is not None:
            extras.append(memwatch)
        endpoint = HTTPEndpoint(address, self.metrics,
                                extra_metrics=extras,
                                debug_source=debug_source)
        endpoint.start()
        return endpoint

    # -- lifecycle (a daemon thread) --------------------------------------

    def start(self, interval_s: float = 1.0) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def _run():
            while not self._stop.wait(interval_s):
                try:
                    self.tick()
                except Exception:   # the loop must outlive surprises
                    log.exception("fleet tick failed")

        self._thread = threading.Thread(
            target=_run, name="tpu-fleet-reconciler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


__all__ = ["FleetReconciler", "read_demand"]
