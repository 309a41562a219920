"""Per-tenant SLO burn-rate alerting for the fleet gateway.

The port's copy of ``k8s_dra_driver_tpu/gateway/burnrate.py`` (no
tensor anywhere: pure host bookkeeping).  Multi-window burn-rate
alerting (SRE Workbook ch. 5) made cycle-denominated for injected
clocks: the per-tenant attained/missed outcomes the gateway already
counts (utils/metrics.py ``tpu_gateway_tenant_slo_*``) become, per pump
cycle,

    burn(window) = miss_fraction(window) / error_budget

where ``error_budget = 1 - slo_target``.  A burn of 1.0 spends the
budget exactly at the sustainable rate; an alert fires only when BOTH a
fast window (catches a cliff in a few cycles) and a slow window
(refuses to page on a blip) exceed their thresholds.  Windows are
counted in pump CYCLES, not seconds, so the engine is deterministic
under an injected clock.

On a firing edge the engine (1) increments
``tpu_gateway_tenant_slo_alerts_total``, (2) publishes an ``alert``
event on the EventBus, and (3) emits an ``alert`` span through the
tracer.  Re-arm is hysteresis on the fast window dropping below
threshold: one alert per burn episode, not one per burning cycle.
"""

from __future__ import annotations

from collections import deque

__all__ = ["SloBurnEngine"]


class SloBurnEngine:
    """Multi-window per-tenant burn-rate tracker (module docstring).

    Construct once, hand to :class:`FleetGateway` (or
    :class:`ShardedGateway`, which shares it across member pumps via
    ``attach``) — the gateway feeds ``observe()`` from its terminal
    accounting and calls ``step()`` once per pump cycle.
    """

    def __init__(self, *, slo_target: float = 0.9,
                 fast_window: int = 8, slow_window: int = 40,
                 fast_threshold: float = 2.0,
                 slow_threshold: float = 1.0,
                 min_samples: int = 3,
                 metrics=None, bus=None, tracer=None, clock=None):
        if not 0.0 < slo_target < 1.0:
            raise ValueError("slo_target must be in (0, 1)")
        if fast_window < 1 or slow_window < fast_window:
            raise ValueError("need 1 <= fast_window <= slow_window")
        self.slo_target = slo_target
        self.budget = 1.0 - slo_target
        self.fast_window = fast_window
        self.slow_window = slow_window
        self.fast_threshold = fast_threshold
        self.slow_threshold = slow_threshold
        self.min_samples = min_samples
        self.metrics = metrics
        self.bus = bus
        self.tracer = tracer
        self.clock = clock
        self.cycle = 0
        self.alerts_total = 0
        #: tenants currently in a burn episode (hysteresis state)
        self.active: set[str] = set()
        # per-tenant: current-cycle accumulators and the closed
        # per-cycle (attained, missed) ring of slow_window length
        self._acc: dict[str, list[int]] = {}
        self._ring: dict[str, deque] = {}
        self._ctx = None

    def attach(self, gateway) -> None:
        """Adopt a gateway's wiring for anything not set explicitly —
        lets tests construct the engine bare and the gateway complete
        it (the tracer/bus/metrics all already live there)."""
        self.metrics = self.metrics or gateway.metrics
        self.bus = self.bus or gateway.bus
        self.tracer = self.tracer or getattr(gateway, "tracer", None)
        self.clock = self.clock or getattr(gateway, "clock", None)

    # -- ingest ---------------------------------------------------

    def observe(self, tenant: str, attained: bool) -> None:
        """One terminal SLO-bearing outcome (the gateway's
        ``_terminal`` attained/missed branch, inf-deadline excluded
        there)."""
        acc = self._acc.setdefault(tenant, [0, 0])
        acc[0 if attained else 1] += 1

    # -- per-cycle evaluation -------------------------------------

    def _burn(self, ring: deque, window: int) -> tuple[float, int]:
        att = miss = 0
        for a, m in list(ring)[-window:]:
            att += a
            miss += m
        n = att + miss
        if n == 0:
            return 0.0, 0
        return (miss / n) / self.budget, n

    def step(self) -> list[dict]:
        """Close the cycle for every tenant, update burn gauges, and
        fire/clear alerts.  Returns the alerts fired this cycle
        (for callers beyond bus subscribers)."""
        self.cycle += 1
        fired = []
        tenants = set(self._acc) | set(self._ring)
        for tenant in sorted(tenants):
            acc = self._acc.pop(tenant, [0, 0])
            ring = self._ring.setdefault(
                tenant, deque(maxlen=self.slow_window))
            ring.append((acc[0], acc[1]))
            fast, n_fast = self._burn(ring, self.fast_window)
            slow, _ = self._burn(ring, self.slow_window)
            if self.metrics is not None:
                self.metrics.tenant_burn_rate.labels(
                    tenant=tenant, window="fast").set(fast)
                self.metrics.tenant_burn_rate.labels(
                    tenant=tenant, window="slow").set(slow)
            burning = (n_fast >= self.min_samples
                       and fast >= self.fast_threshold
                       and slow >= self.slow_threshold)
            if burning and tenant not in self.active:
                self.active.add(tenant)
                fired.append(self._fire(tenant, fast, slow))
            elif not burning and tenant in self.active:
                # re-arm only once the fast window cools below its
                # threshold — mid-episode wobble must not re-page
                if fast < self.fast_threshold:
                    self.active.discard(tenant)
        return fired

    def _fire(self, tenant: str, fast: float, slow: float) -> dict:
        self.alerts_total += 1
        payload = {"tenant": tenant, "cycle": self.cycle,
                   "burn_fast": round(fast, 3),
                   "burn_slow": round(slow, 3),
                   "fast_window": self.fast_window,
                   "slow_window": self.slow_window,
                   "slo_target": self.slo_target}
        if self.metrics is not None:
            self.metrics.tenant_slo_alerts.labels(tenant=tenant).inc()
        if self.bus is not None:
            self.bus.publish("alert", **payload)
        if self.tracer is not None:
            if self._ctx is None:
                self._ctx = self.tracer.begin("burnrate")
            now = self.clock() if self.clock is not None else 0.0
            self.tracer.emit(self._ctx, "alert", now, now,
                             track="gateway", **payload)
        return payload
