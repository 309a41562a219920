"""SLO-aware bounded admission for the fleet gateway.

The front door of the serving stack: every request enters through one
bounded queue with an absolute deadline, and leaves it in exactly one
of three ways — dispatched to a replica, REJECTED at the door because
the queue is full, or SHED once its deadline passed while waiting.
Nothing is ever dropped silently: both refusal paths carry an explicit
status the caller (and the metrics) can see, which is the difference
between load shedding and losing traffic.  AlpaServe (OSDI'23) makes
the statistical argument for why the queue exists at all: bursty
per-model traffic multiplexed over a replica pool needs a place to
absorb the burst — but only up to the point where waiting would blow
the SLO anyway, at which point shedding early is strictly better than
serving late (the request's user already gave up).

The port of ``k8s_dra_driver_tpu/gateway/admission.py``; requests are
the port engine's :class:`~..models.serving.Request`.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Any

from ..models.serving import Request

# Terminal request outcomes (explicit-status contract: exactly one of
# these per admitted-or-refused request, never silence).
FINISHED = "finished"            # completed; tokens delivered
SHED_EXPIRED = "shed_expired"    # deadline passed while queued
REJECTED_FULL = "rejected_full"  # bounded queue was full at submit
REJECTED_DUPLICATE = "rejected_duplicate"  # uid already live pool-wide
REJECTED_INVALID = "rejected_invalid"  # no engine can run it (size &c.)

# Non-terminal lifecycle states.
QUEUED = "queued"
DISPATCHED = "dispatched"


@dataclasses.dataclass
class GatewayRequest:
    """One request's gateway-side record: the engine request plus the
    SLO/accounting state the engine deliberately knows nothing about."""

    request: Request
    arrival_s: float                 # gateway clock at admission
    deadline_s: float                # absolute; inf = no SLO
    status: str = QUEUED
    replica: str | None = None       # where it is (or last was) placed
    dispatched_s: float | None = None
    first_token_s: float | None = None
    finished_s: float | None = None
    requeues: int = 0                # drain evictions survived
    #: tenant tag (multi-tenant fleets): pure
    #: accounting — placement and admission never read it, but every
    #: queue-wait sample and terminal outcome carries it into the
    #: per-tenant metric series
    tenant: str | None = None
    #: causal-trace cursor (utils/tracing.py ``TraceContext``),
    #: attached at admission when the gateway runs with a tracer.
    #: Deliberately carried on the record — not in a side table — so
    #: drain → requeue → re-dispatch CONTINUES the same trace (the
    #: drain-gap span) and work stealing moves the trace with the
    #: request across pump shards.  None when tracing is off.
    trace: Any | None = None

    @property
    def uid(self):
        return self.request.uid

    def expired(self, now_s: float) -> bool:
        return now_s >= self.deadline_s


class AdmissionError(ValueError):
    """Submit-time refusal (full queue / duplicate uid) — raised so a
    caller that ignores return values cannot mistake refusal for
    admission; the gateway front-end catches it and returns the
    explicit status instead."""

    def __init__(self, status: str, msg: str):
        super().__init__(msg)
        self.status = status


class AdmissionQueue:
    """Bounded FIFO of :class:`GatewayRequest` with deadline shedding.

    ``capacity`` bounds WAITING requests only — in-flight work is the
    replicas' concern (their slots + engine queues bound it), and
    counting it here would make admission depend on pool size.  Expired
    entries are swept by :meth:`shed_expired`, which the gateway pump
    calls every step; ``pop``/``requeue`` keep FIFO order except that
    drain victims re-enter at the FRONT (they already waited their
    turn once — pushing them behind the burst that arrived after them
    would double-charge the queue wait and starve them under load).

    Capacity contract on requeue: drain victims re-enter WITHOUT a
    capacity check — they were already admitted once, and bouncing
    them at the door would turn a replica failure into a silent drop.
    The queue may therefore transiently hold up to ``capacity`` plus
    the dead replica's in-flight count; :meth:`offer` keeps rejecting
    NEW traffic until the backlog drains back under the bound, which
    is the intended degraded-mode behavior (admitted work outranks
    new work).
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("admission queue needs capacity >= 1")
        self.capacity = capacity
        self._q: deque[GatewayRequest] = deque()
        # monotone admission stamp: FIFO ties in tests/logs stay
        # deterministic even with an injected coarse clock
        self._seq = itertools.count()

    def __len__(self) -> int:
        return len(self._q)

    def offer(self, req: Request, now_s: float,
              slo_s: float | None = None,
              live_uids: frozenset | None = None,
              tenant: str | None = None) -> GatewayRequest:
        """Admit or refuse; refusal raises :class:`AdmissionError`
        with the explicit status (reject-on-full, never a silent
        drop).  ``live_uids``: uids currently dispatched or queued
        elsewhere in the gateway, so the engine-level duplicate-uid
        contract holds pool-wide.  ``tenant`` rides the record into
        per-tenant accounting; admission itself is tenant-blind."""
        if any(g.uid == req.uid for g in self._q) or (
                live_uids and req.uid in live_uids):
            raise AdmissionError(
                REJECTED_DUPLICATE,
                f"uid {req.uid!r} already in flight pool-wide")
        if len(self._q) >= self.capacity:
            raise AdmissionError(
                REJECTED_FULL,
                f"admission queue full ({self.capacity})")
        g = GatewayRequest(
            request=req, arrival_s=now_s,
            deadline_s=(now_s + slo_s) if slo_s is not None
            else float("inf"), tenant=tenant)
        self._q.append(g)
        return g

    def shed_expired(self, now_s: float) -> list[GatewayRequest]:
        """Remove and return every queued request whose deadline has
        passed, marked with the explicit SHED status — the pump turns
        these into terminal outcomes + metrics, never silence."""
        shed, keep = [], deque()
        for g in self._q:
            if g.expired(now_s):
                g.status = SHED_EXPIRED
                shed.append(g)
            else:
                keep.append(g)
        self._q = keep
        return shed

    def pop(self, now_s: float) -> GatewayRequest | None:
        """Oldest non-expired request, or None.  Expiry is checked
        here too so a request can never be dispatched dead even if the
        sweep has not run this step."""
        while self._q:
            g = self._q[0]
            if g.expired(now_s):
                # leave it for shed_expired to account explicitly
                return None
            return self._q.popleft()
        return None

    def peek(self) -> GatewayRequest | None:
        return self._q[0] if self._q else None

    def uids(self) -> list:
        """Queued uids, oldest first — a sharded gateway's
        cross-pump duplicate check scans every
        sibling queue so the pool-wide uid contract spans shards."""
        return [g.uid for g in self._q]

    def steal_newest(self) -> GatewayRequest | None:
        """Work-stealing donor side: remove and return the NEWEST
        queued request.  Stealing from the tail keeps this queue's
        FIFO head — and any drain victims requeued at the front —
        exactly where they were; the stolen request was going to wait
        longest here anyway."""
        return self._q.pop() if self._q else None

    def adopt(self, g: GatewayRequest) -> None:
        """Work-stealing thief side: an already-admitted request joins
        the TAIL of this queue.  No capacity check — same contract as
        :meth:`requeue`: admission happened once, at the door; moving
        a request between pump shards must never turn into a silent
        drop."""
        self._q.append(g)

    def requeue(self, g: GatewayRequest) -> None:
        """Drain path: an in-flight request returns to the FRONT of
        the queue (see class docstring) with its arrival time — and
        therefore its deadline — unchanged: a replica failure does not
        grant a request more SLO budget.  No capacity check — the
        request was already admitted (see the class docstring's
        capacity contract)."""
        g.status = QUEUED
        g.replica = None
        g.dispatched_s = None
        g.requeues += 1
        self._q.appendleft(g)


__all__ = ["AdmissionError", "AdmissionQueue", "GatewayRequest",
           "FINISHED", "SHED_EXPIRED", "REJECTED_FULL",
           "REJECTED_DUPLICATE", "REJECTED_INVALID", "QUEUED",
           "DISPATCHED"]
