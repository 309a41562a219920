"""Simulated workloads: the duck-typed gateway / replica-manager /
gang-supervisor surfaces the port's policy layer actuates.

The port's copy of ``k8s_dra_driver_tpu/sim/workload.py``.  The
multi-tenant reconciler (fleet/tenancy.py) and the invariant sweep
(cluster/invariants.py) never import engine classes; they duck through
a narrow surface: ``manager.replicas`` with per-replica
``state/ready/in_flight/name/chip``, ``manager.begin_drain/retire/
add_replica``, ``supervisor.dp/state/workers/losses/recoveries/
park/request_width/update_fence/readmit``, and a gateway whose
``metrics.registry`` serves the demand gauges ``read_demand`` scrapes
(fleet/reconciler.py).  This module implements exactly that surface
over virtual time (sim/clock.py EventHeap), so the bin-packer, arbiter
and reconciler run UNMODIFIED against a thousand simulated replicas:
no sockets, no threads, no engines, no tensors.  It runs on the host.

Fidelity contract: the sim models TIMING, CAPACITY, PLACEMENT and
LIFECYCLE (request arrival/service/deadline races, slot occupancy,
chip ownership, drain/kill/heal state machines, gang
step/checkpoint/reform arithmetic).  It deliberately does NOT model
bytes: no tokens, no KV pages, no checkpoint files, so the byte-level
invariants (byte_equal, untainted_restores) are vacuous here and stay
owned by the live crucible.

A draining replica keeps ``state == "draining"`` and its chip until it
retires; the port's reconciler counts such a replica as already given
back (fleet/tenancy.py ``TenantState.draining``, ROADMAP Queue C item
19), which the reference's does not.

Determinism: every callback runs off the event heap in (time, seq)
order; the only randomness is the seeded trace workload the fleet
build schedules (sim/fleet.py).  A same-seed rerun replays the
identical journal byte for byte.
"""

from __future__ import annotations

import dataclasses
from collections import deque

#: EWMA weight for the SLO-margin gauge, in the spirit of the live
#: gateway's smoothed margin (gateway/admission.py): recent finishes
#: dominate, one outlier cannot flip the calm classifier
_MARGIN_ALPHA = 0.3

#: arrival-rate window (seconds of virtual time) for the
#: ``tpu_gateway_arrival_rate_rps`` gauge
_RATE_WINDOW_S = 10.0


@dataclasses.dataclass
class SimRequest:
    """One simulated request: arrival + service demand, no payload."""

    uid: str
    tenant: str
    arrival_s: float
    service_s: float
    deadline_s: float | None = None
    adapter: str | None = None


@dataclasses.dataclass
class SimOutcome:
    """Terminal record, status drawn from invariants.TERMINAL_STATUSES
    so the real checkers classify sim outcomes unmodified."""

    uid: str
    status: str
    tenant: str
    arrival_s: float
    finished_s: float | None = None


class SimQueue:
    """FIFO with the ``uids()`` face terminal_is_final walks."""

    def __init__(self):
        self._q: deque[SimRequest] = deque()

    def __len__(self) -> int:
        return len(self._q)

    def uids(self) -> list[str]:
        return [r.uid for r in self._q]

    def push(self, req: SimRequest) -> None:
        self._q.append(req)

    def push_front(self, reqs) -> None:
        """Requeue (kill recovery) preserving original order."""
        for r in reversed(list(reqs)):
            self._q.appendleft(r)

    def pop(self) -> SimRequest:
        return self._q.popleft()


class SimReplica:
    """One simulated serving replica: a slot-bounded server whose
    service completions are heap events.  State machine mirrors the
    live EngineReplica: ready -> draining -> retired, or -> dead."""

    def __init__(self, name: str, chip: int | None, slots: int):
        self.name = name
        self.chip = chip
        self.slots = slots
        self.state = "ready"
        #: uid -> SimRequest, the in-flight map every conservation
        #: and exactly-once checker sums over
        self.in_flight: dict[str, SimRequest] = {}

    @property
    def ready(self) -> bool:
        return self.state == "ready"

    def free_slots(self) -> int:
        return (self.slots - len(self.in_flight)
                if self.state == "ready" else 0)


class SimReplicaManager:
    """The ``manager`` duck: replicas list + the three lifecycle verbs
    the reconciler actuates (begin_drain / retire / add_replica)."""

    def __init__(self, gateway: "SimGateway", prefix: str,
                 slots: int = 8):
        self.gateway = gateway
        self.prefix = prefix
        self.default_slots = slots
        self.replicas: list[SimReplica] = []
        self._n = 0

    def add_replica(self, chip=None, role=None, **_) -> SimReplica:
        r = SimReplica(f"{self.prefix}{self._n}",
                       None if chip is None else int(chip),
                       self.default_slots)
        self._n += 1
        self.replicas.append(r)
        self.gateway._on_capacity(r)
        return r

    def begin_drain(self, replica: SimReplica) -> bool:
        """Graceful drain: stop dispatching, let in-flight finish.
        Refuses non-ready replicas (the live manager's rule)."""
        if replica.state != "ready":
            return False
        self.gateway._free_slots -= replica.free_slots()
        replica.state = "draining"
        return True

    def retire(self, replica: SimReplica) -> None:
        replica.state = "retired"
        if replica in self.replicas:
            self.replicas.remove(replica)

    def counts(self) -> dict:
        out: dict[str, int] = {}
        for r in self.replicas:
            out[r.state] = out.get(r.state, 0) + 1
        return out


class _SimRegistry:
    """The two demand gauges ``read_demand`` scrapes, served straight
    from the simulated gateway's state."""

    def __init__(self, gw: "SimGateway"):
        self._gw = gw

    def get_sample_value(self, name: str, labels=None):
        if name == "tpu_gateway_queue_depth":
            return float(len(self._gw.queue))
        if name == "tpu_gateway_arrival_rate_rps":
            return self._gw.arrival_rate_rps()
        if name == "tpu_gateway_slo_margin_ewma_seconds":
            return self._gw.slo_margin_ewma_s
        return None


class _SimMetrics:
    def __init__(self, gw: "SimGateway"):
        self.registry = _SimRegistry(gw)


class SimGateway:
    """One tenant pool's gateway over virtual time.

    Open-loop: ``submit`` admits or refuses instantly; dispatch is
    event-driven (a submit or a completion triggers it, never a poll),
    so an idle pool schedules NOTHING — the O(events) property the
    scale soak pins.  Conservation by construction: every admitted
    uid is queued, in flight, or terminal at every instant between
    events, which is exactly when the invariant sweep looks.
    """

    def __init__(self, name: str, heap, *, queue_capacity: int = 256,
                 service_s: float = 0.05, slots: int = 8,
                 journal=None):
        self.name = name
        self.heap = heap
        self.queue_capacity = queue_capacity
        self.default_service_s = service_s
        self.queue = SimQueue()
        self.manager = SimReplicaManager(self, prefix=f"{name}-r",
                                         slots=slots)
        self.metrics = _SimMetrics(self)
        #: uid -> SimOutcome (terminal only; invariants walk this)
        self.outcomes: dict[str, SimOutcome] = {}
        #: capacity refusals (never also in outcomes)
        self.refused: list[SimOutcome] = []
        self.admissions_total = 0
        self.slo_margin_ewma_s: float | None = None
        self._journal = journal
        self._arrivals: deque[float] = deque()
        self._uids = set()
        self._n = 0
        #: aggregate spare capacity — dispatch short-circuits at 0 so
        #: a saturated pool costs O(1) per arrival, not O(replicas)
        self._free_slots = 0
        self._rr = 0

    # -- demand signals ---------------------------------------------------

    def arrival_rate_rps(self) -> float:
        now = self.heap.now
        while self._arrivals and self._arrivals[0] < now - _RATE_WINDOW_S:
            self._arrivals.popleft()
        return len(self._arrivals) / _RATE_WINDOW_S

    def pending(self) -> int:
        return len(self.queue)

    # -- admission --------------------------------------------------------

    def submit(self, uid: str | None = None, *,
               service_s: float | None = None,
               slo_s: float | None = None, tenant: str | None = None,
               adapter: str | None = None) -> str:
        now = self.heap.now
        if uid is None:
            uid = f"{self.name}-{self._n}"
        self._n += 1
        self.admissions_total += 1
        tenant = tenant or self.name
        if uid in self._uids:
            self.refused.append(SimOutcome(
                uid, "rejected_duplicate", tenant, now))
            self._log("refuse", uid=uid, why="duplicate")
            return uid
        self._uids.add(uid)
        self._arrivals.append(now)
        if len(self.queue) >= self.queue_capacity:
            self.refused.append(SimOutcome(
                uid, "rejected_full", tenant, now))
            self._log("refuse", uid=uid, why="full")
            return uid
        self.queue.push(SimRequest(
            uid=uid, tenant=tenant, arrival_s=now,
            service_s=(self.default_service_s if service_s is None
                       else service_s),
            deadline_s=None if slo_s is None else now + slo_s,
            adapter=adapter))
        self._log("submit", uid=uid)
        self._dispatch()
        return uid

    # -- dispatch / completion (event-driven) ----------------------------

    def _on_capacity(self, replica: SimReplica) -> None:
        """A replica appeared or freed a slot — pull from the queue."""
        if replica.state == "ready":
            self._free_slots += replica.free_slots()
        self._dispatch()

    def _dispatch(self) -> None:
        while len(self.queue) and self._free_slots > 0:
            req = self.queue.pop()
            now = self.heap.now
            if req.deadline_s is not None and now > req.deadline_s:
                self.outcomes[req.uid] = SimOutcome(
                    req.uid, "shed_expired", req.tenant,
                    req.arrival_s, finished_s=now)
                self._log("shed", uid=req.uid)
                continue
            r = self._pick_replica()
            if r is None:             # free-count drifted; resync
                self._free_slots = sum(x.free_slots()
                                       for x in self.manager.replicas)
                if self._free_slots == 0:
                    self.queue.push_front([req])
                    return
                r = self._pick_replica()
            r.in_flight[req.uid] = req
            self._free_slots -= 1
            self.heap.after(req.service_s, self._complete, r, req)
            self._log("dispatch", uid=req.uid, replica=r.name)

    def _pick_replica(self) -> SimReplica | None:
        n = len(self.manager.replicas)
        for k in range(n):
            r = self.manager.replicas[(self._rr + k) % n]
            if r.free_slots() > 0:
                self._rr = (self._rr + k + 1) % n
                return r
        return None

    def _complete(self, replica: SimReplica, req: SimRequest) -> None:
        if replica.in_flight.get(req.uid) is not req:
            return                    # stale event: replica was killed
        del replica.in_flight[req.uid]
        now = self.heap.now
        self.outcomes[req.uid] = SimOutcome(
            req.uid, "finished", req.tenant, req.arrival_s,
            finished_s=now)
        if req.deadline_s is not None:
            margin = req.deadline_s - now
            prev = self.slo_margin_ewma_s
            self.slo_margin_ewma_s = (
                margin if prev is None
                else _MARGIN_ALPHA * margin + (1 - _MARGIN_ALPHA) * prev)
        self._log("finish", uid=req.uid, replica=replica.name)
        if replica.state == "ready":
            self._free_slots += 1
        self._dispatch()

    def expire_queued(self) -> int:
        """Shed every queued request whose deadline has passed — the
        teardown sweep (sim/rig.py drain phase).  Live pools shed at
        dispatch time; a pool that never got a replica has no
        dispatch events, so its dead-on-arrival queue needs this
        explicit pass before the end-of-run exactly-once sweep."""
        now = self.heap.now
        kept, shed = [], 0
        while len(self.queue):
            req = self.queue.pop()
            if req.deadline_s is not None and now > req.deadline_s:
                self.outcomes[req.uid] = SimOutcome(
                    req.uid, "shed_expired", req.tenant,
                    req.arrival_s, finished_s=now)
                self._log("shed", uid=req.uid)
                shed += 1
            else:
                kept.append(req)
        for req in kept:
            self.queue.push(req)
        return shed

    # -- faults -----------------------------------------------------------

    def kill_replica(self, replica: SimReplica,
                     reason: str = "chip_kill") -> None:
        """Atomic kill + requeue: the in-flight map empties and the
        queue gains the same requests in one event, so conservation
        holds at every instant the sweep can observe."""
        if replica.state == "dead":
            return
        if replica.state == "ready":
            self._free_slots -= replica.free_slots()
        replica.state = "dead"
        reqs = list(replica.in_flight.values())
        replica.in_flight.clear()
        self.queue.push_front(reqs)
        self._log("replica_dead", replica=replica.name,
                  chip=replica.chip, why=reason,
                  requeued=len(reqs))
        self._dispatch()

    def replicas_on_chips(self, chips) -> list[SimReplica]:
        cs = set(chips)
        return [r for r in self.manager.replicas
                if r.chip in cs and r.state != "dead"]

    def _log(self, kind: str, **info) -> None:
        if self._journal is not None:
            self._journal.append((self.heap.now,
                                  f"gw.{kind}",
                                  dict(info, gw=self.name)))


# -- training gangs -------------------------------------------------------


@dataclasses.dataclass
class SimJob:
    tp: int = 1


@dataclasses.dataclass
class SimRecovery:
    """The recovery record losses_exactly_once consumes."""

    restored_step: int
    cause: str
    mttr_s: float = 0.0


class SimWorker:
    def __init__(self, name: str, chips: tuple):
        self.name = name
        self.chips = tuple(int(c) for c in chips)
        self.alive = True


class SimSupervisor:
    """The ``supervisor`` duck: an elastic gang whose steps are heap
    events and whose reform arithmetic honors the checkpoint/rewind
    contract losses_exactly_once checks.

    Placement: the supervisor picks chips from its ``universe`` (the
    ledger's chip list) minus the health fence (``_dead_chips``) and
    the placement fence (``_placement_excluded``), preferring chips it
    already holds — the reconciler steers it purely through
    ``request_width(exclude=...)`` fence replacement, exactly as it
    steers the live GangSupervisor.
    """

    def __init__(self, name: str, heap, *, universe, tp: int = 1,
                 dp: int = 2, step_s: float = 1.0,
                 ckpt_every: int = 5, recover_s: float = 2.0,
                 journal=None):
        self.name = name
        self.heap = heap
        self.universe = [int(c) for c in universe]
        self.job = SimJob(tp=tp)
        self.dp = dp
        self.state = "running"
        self.workers: list[SimWorker] = []
        self.losses: list[tuple[int, float]] = []
        self.recoveries: list[SimRecovery] = []
        self._dead_chips: set[int] = set()
        self._placement_excluded: set[int] = set()
        self.step_s = step_s
        self.ckpt_every = ckpt_every
        self.recover_s = recover_s
        self._journal = journal
        self._step = 0
        self._ckpt = 0
        self._epoch = 0
        self._wn = 0

    # -- introspection ----------------------------------------------------

    def chips(self) -> set[int]:
        return {c for w in self.workers if w.alive for c in w.chips}

    # -- formation --------------------------------------------------------

    def _candidates(self) -> list[int]:
        fence = self._dead_chips | self._placement_excluded
        own = [c for c in sorted(self.chips()) if c not in fence]
        rest = [c for c in self.universe
                if c not in fence and c not in set(own)]
        return own + rest

    def _form(self, dp: int, cause: str) -> None:
        chips = self._candidates()
        need = dp * self.job.tp
        if len(chips) < need:
            raise ValueError(
                f"gang {self.name}: need {need} chips, "
                f"{len(chips)} usable")
        for w in self.workers:
            w.alive = False
        self.workers = []
        for i in range(dp):
            lo = i * self.job.tp
            self.workers.append(SimWorker(
                f"{self.name}-w{self._wn}",
                tuple(chips[lo:lo + self.job.tp])))
            self._wn += 1
        self.dp = dp
        self.state = "running"
        # resume from the checkpoint: the steps since it replay, and
        # the recovery record declares the rewind the checker consumes
        self.recoveries.append(SimRecovery(
            restored_step=self._ckpt, cause=cause,
            mttr_s=self.recover_s))
        self._step = self._ckpt
        self._epoch += 1
        self._schedule_step()
        self._log("form", dp=dp, cause=cause,
                  chips=sorted(self.chips()))

    def start(self) -> None:
        """Initial formation (no recovery record — nothing to rewind)."""
        chips = self._candidates()
        need = self.dp * self.job.tp
        if len(chips) < need:
            raise ValueError(
                f"gang {self.name}: need {need} chips, "
                f"{len(chips)} usable")
        for i in range(self.dp):
            lo = i * self.job.tp
            self.workers.append(SimWorker(
                f"{self.name}-w{self._wn}",
                tuple(chips[lo:lo + self.job.tp])))
            self._wn += 1
        self._epoch += 1
        self._schedule_step()
        self._log("start", dp=self.dp, chips=sorted(self.chips()))

    # -- stepping ---------------------------------------------------------

    def _schedule_step(self) -> None:
        self.heap.after(self.step_s, self._on_step, self._epoch)

    def _on_step(self, epoch: int) -> None:
        if epoch != self._epoch or self.state != "running":
            return
        self._step += 1
        self.losses.append((self._step, 1.0 / (1.0 + self._step)))
        if self._step % self.ckpt_every == 0:
            self._ckpt = self._step
        self._schedule_step()

    # -- the reconciler-facing verbs -------------------------------------

    def park(self) -> None:
        """Checkpoint-then-release-everything (RECLAIM_PARK)."""
        self._ckpt = self._step
        for w in self.workers:
            w.alive = False
        self.state = "parked"
        self._epoch += 1
        self._log("park", step=self._step)

    def request_width(self, dp: int, exclude=None) -> None:
        """Resize to ``dp`` (RECLAIM_SHRINK / REGROW).  ``exclude``
        replaces the placement fence wholesale when given — the
        arbiter's bin-packed home is authoritative (tenancy.py)."""
        if dp < 1:
            raise ValueError(f"gang {self.name}: dp must be >= 1")
        if exclude is not None:
            self._placement_excluded = {int(c) for c in exclude}
        self._ckpt = self._step
        self._form(dp, cause="resize")

    def update_fence(self, add=()) -> None:
        self._placement_excluded |= {int(c) for c in add}

    def readmit(self, chips) -> None:
        self._dead_chips -= {int(c) for c in chips}

    # -- faults -----------------------------------------------------------

    def on_chip_down(self, chips) -> None:
        """Health fence + eviction: workers on a killed chip die NOW;
        the reform fires after ``recover_s`` (a heap event), or not at
        all if the gang cannot rebuild — the arbiter's regrow path
        owns that case."""
        down = {int(c) for c in chips}
        hit = [w for w in self.workers
               if w.alive and set(w.chips) & down]
        self._dead_chips |= {c for w in hit for c in w.chips
                             if c in down}
        if not hit:
            return
        for w in hit:
            w.alive = False
        self._epoch += 1
        self._log("evict", workers=[w.name for w in hit],
                  down=sorted(down))
        if self.state == "running":
            self.heap.after(self.recover_s, self._recover,
                            self._epoch)

    def crash_worker(self, index: int = 0,
                     cause: str = "worker_crash") -> None:
        """A worker process dies on healthy chips: evict + reform at
        the same width on the same chips."""
        alive = [w for w in self.workers if w.alive]
        if not alive:
            return
        w = alive[index % len(alive)]
        w.alive = False
        self._epoch += 1
        self._log("evict", workers=[w.name], down=[], why=cause)
        if self.state == "running":
            self.heap.after(self.recover_s, self._recover,
                            self._epoch)

    def _recover(self, epoch: int) -> None:
        if epoch != self._epoch or self.state != "running":
            return
        for dp in self._halvings(self.dp):
            try:
                self._form(dp, cause="fault_recover")
                return
            except ValueError:
                continue
        # nothing buildable: the gang idles dead-in-place until the
        # arbiter regrows it (its alive workers are already gone)
        self._log("recover_blocked", dp=self.dp)

    @staticmethod
    def _halvings(dp: int) -> list[int]:
        out = []
        while dp >= 1:
            out.append(dp)
            dp //= 2
        return out

    def _log(self, kind: str, **info) -> None:
        if self._journal is not None:
            self._journal.append((self.heap.now,
                                  f"gang.{kind}",
                                  dict(info, gang=self.name)))


__all__ = ["SimGateway", "SimJob", "SimOutcome", "SimQueue",
           "SimRecovery", "SimReplica", "SimReplicaManager",
           "SimRequest", "SimSupervisor", "SimWorker"]
