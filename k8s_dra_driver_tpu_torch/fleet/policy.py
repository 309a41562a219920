"""Fleet arbitration policy: hysteresis + priority over one chip pool.

The port's copy of ``k8s_dra_driver_tpu/fleet/policy.py``.  The
decision kernel of the reconciler, deliberately pure bookkeeping (no
tensor, no I/O) so every branch is unit-testable: given one tick's
demand signals and the supply ledger, emit at most ONE action.

Priority model:

- **Serving outranks training under sustained SLO pressure.**  A
  pressured tick streak first spends FREE chips (scale-up); only when
  the pool is dry does it preempt the gang — and preemption is
  checkpoint-then-shrink through the supervisor's REFORM path, never
  a kill, so training pays a placement change, not lost work.
- **Training reclaims when calm.**  A calm streak first retires idle
  replicas (their chips return to the pool), then regrows the gang to
  the largest power-of-two width that fits a contiguous block —
  the regrow rule mirrors the supervisor's own shrink rule, so the
  two never disagree about what widths are runnable.

Hysteresis: pressure and calm are COUNTED in consecutive ticks
(``up_after`` / ``down_after`` / ``regrow_after``), and any tick that
is neither resets both counters.  One action per tick bounds the
actuation rate; the counters reset after an action fires, so a
persistent condition re-arms instead of machine-gunning the pool.
Scale-down is deliberately slower than scale-up (default
``down_after > up_after``) and regrow waits for the calm streak too:
flapping chips between the gang and the pool costs a reform each way.
"""

from __future__ import annotations

import dataclasses

# action kinds (Action.kind)
SCALE_UP = "scale_up"
SCALE_DOWN = "scale_down"
PREEMPT = "preempt"
REGROW = "regrow"


@dataclasses.dataclass(frozen=True)
class DemandSignals:
    """One tick's demand view, read from ``GatewayMetrics`` gauges
    (fleet/reconciler.py ``_demand``): queue depth, the arrival-rate
    EWMA, and the signed SLO-margin EWMA (None until an SLO-bearing
    request has finished)."""

    queue_depth: int = 0
    arrival_rate_rps: float = 0.0
    slo_margin_ewma_s: float | None = None


@dataclasses.dataclass(frozen=True)
class Action:
    kind: str
    dp: int | None = None       # target gang width for preempt/regrow


def pressured(d: DemandSignals, cfg) -> bool:
    """Deep queue, or a bad SLO-margin EWMA WITH work actually
    waiting.  The margin clause is gated on a non-empty queue because
    the EWMA only updates when SLO-bearing requests finish: after
    traffic stops, a stale negative margin with nothing queued is
    history, not actionable pressure — acting on it would scale up an
    idle pool and (worse) block calm forever.  ``cfg`` is anything
    with ``queue_high``/``margin_floor_s`` (PolicyConfig, or the
    multi-tenant MtConfig in fleet/tenancy.py)."""
    return (d.queue_depth >= cfg.queue_high
            or (d.queue_depth > 0
                and d.slo_margin_ewma_s is not None
                and d.slo_margin_ewma_s < cfg.margin_floor_s))


def is_calm(d: DemandSignals, cfg) -> bool:
    """Empty queue and the arrival EWMA decayed low.  Margin is
    deliberately absent (see :func:`pressured`): an empty queue IS
    the SLO recovering."""
    return (d.queue_depth == 0
            and d.arrival_rate_rps <= cfg.arrival_low_rps)


class Streaks:
    """Consecutive-tick pressure/calm counting — the hysteresis core
    shared by :class:`FleetPolicy` (one global pair of counters) and
    the multi-tenant arbiter (one pair PER TENANT, fleet/tenancy.py).
    A tick that is neither pressured nor calm resets both; once a
    streak reaches its threshold it stays "fired" for as long as the
    condition persists — the multi-tenant preemption cascade needs
    one action per tick under SUSTAINED pressure, not one action per
    re-armed streak."""

    def __init__(self, *, up_after: int, down_after: int):
        self.up_after = up_after
        self.down_after = down_after
        self.hot = 0
        self.calm = 0

    def update(self, pressured_now: bool, calm_now: bool) -> None:
        if pressured_now:
            self.hot += 1
            self.calm = 0
        elif calm_now:
            self.calm += 1
            self.hot = 0
        else:
            self.hot = 0
            self.calm = 0

    @property
    def hot_fired(self) -> bool:
        return self.hot >= self.up_after

    @property
    def calm_fired(self) -> bool:
        return self.calm >= self.down_after


@dataclasses.dataclass
class PolicyConfig:
    queue_high: int = 4          # queue depth that signals pressure
    margin_floor_s: float = 0.0  # margin EWMA below this = pressure
    arrival_low_rps: float = 0.5  # calm needs arrivals at/below this
    up_after: int = 2            # pressured ticks before scale-up
    down_after: int = 4          # calm ticks before scale-down
    regrow_after: int = 3        # calm ticks before gang regrow
    min_replicas: int = 0
    max_replicas: int = 8
    min_train_dp: int = 1        # preemption floor


class FleetPolicy:
    """Stateful hysteresis over :class:`PolicyConfig` thresholds.

    ``train_target_dp`` is the width the gang WANTS (its formation
    width when the reconciler adopted it); regrow never exceeds it.
    """

    def __init__(self, cfg: PolicyConfig | None = None, *,
                 train_target_dp: int | None = None):
        self.cfg = cfg or PolicyConfig()
        self.train_target_dp = train_target_dp
        self.hot = 0             # consecutive pressured ticks
        self.calm = 0            # consecutive calm ticks

    # -- signal classification -------------------------------------------

    def pressured(self, d: DemandSignals) -> bool:
        """Module-level :func:`pressured` over this policy's config."""
        return pressured(d, self.cfg)

    def is_calm(self, d: DemandSignals) -> bool:
        """Module-level :func:`is_calm` over this policy's config."""
        return is_calm(d, self.cfg)

    # -- width rules ------------------------------------------------------

    def shrunk_dp(self, gang_dp: int) -> int | None:
        """Preemption target: the largest power of two strictly below
        ``gang_dp``, floored at ``min_train_dp``; None when the gang
        has nothing left to give.  (Batch divisibility is the
        supervisor's check — request_width raises, the reconciler
        logs and drops.)"""
        if gang_dp <= self.cfg.min_train_dp:
            return None
        t = 1
        while t * 2 < gang_dp:
            t *= 2
        return t if t >= self.cfg.min_train_dp else None

    def grown_dp(self, gang_dp: int, gang_tp: int, ledger) -> int | None:
        """Regrow target: the largest power-of-two dp ≤
        ``train_target_dp`` whose ``dp*tp`` chips form an
        contiguous healthy block counting the gang's own chips
        (ChipLedger.contiguous_available); None when the gang is at
        target or nothing bigger fits."""
        tgt = self.train_target_dp
        if tgt is None or gang_dp >= tgt:
            return None
        best = None
        t = max(gang_dp, 1) * 2
        while t <= tgt:
            if ledger.contiguous_available(t * gang_tp):
                best = t
            t *= 2
        return best

    # -- the decision ----------------------------------------------------

    def decide(self, demand: DemandSignals, ledger, *,
               replicas: int, idle_replicas: int,
               gang_dp: int, gang_tp: int) -> Action | None:
        """At most one action for this tick (see module docstring)."""
        cfg = self.cfg
        if self.pressured(demand):
            self.calm = 0
            self.hot += 1
            if self.hot < cfg.up_after or replicas >= cfg.max_replicas:
                return None
            if ledger.healthy_free():
                self.hot = 0
                return Action(SCALE_UP)
            target = self.shrunk_dp(gang_dp)
            if target is not None:
                self.hot = 0
                return Action(PREEMPT, dp=target)
            return None          # saturated: nothing left to give
        if self.is_calm(demand):
            self.hot = 0
            self.calm += 1
            if (self.calm >= cfg.down_after and idle_replicas > 0
                    and replicas > cfg.min_replicas):
                # scale-down before regrow: the retired replica's chip
                # is exactly what the gang regrows onto next tick
                self.calm = 0
                return Action(SCALE_DOWN)
            if self.calm >= cfg.regrow_after:
                grow = self.grown_dp(gang_dp, gang_tp, ledger)
                if grow is not None:
                    self.calm = 0
                    return Action(REGROW, dp=grow)
            return None
        # neither pressured nor calm: streaks break
        self.hot = 0
        self.calm = 0
        return None


__all__ = ["Action", "DemandSignals", "FleetPolicy", "PolicyConfig",
           "Streaks", "is_calm", "pressured",
           "PREEMPT", "REGROW", "SCALE_DOWN", "SCALE_UP"]
