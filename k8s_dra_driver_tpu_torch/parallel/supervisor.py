"""Elastic gang supervisor: the training analog of the fleet
gateway's drain/replace loop.

The port of ``k8s_dra_driver_tpu/parallel/supervisor.py``: the same
states, recovery state machine, verbs, report and contract file, the
control logic line for line.  It owns the train loop and RECOVERS it:
a worker death, a wedged step or a chip going down ends in a resumed
run on a re-formed (usually smaller) gang, restored from the latest
readable checkpoint generation, instead of a failed job.

The gang is in-process, as the reference's is: :class:`ElasticTrainJob`
numbers ``chips`` slots on one device (the counterpart of the
reference's virtual host devices), a formation takes the first
``dp x tp`` surviving slots, and its train step computes each dp row's
``B/dp`` shard as its own forward and backward, in row order, sums the
gradients over the rows in f32 and takes one AdamW step — so a dp
change is a placement change, not a math change, and the parameters
and the optimizer stay in the supervisor's process for its checkpoint,
park and restore.  tp, like dp, is a change of placement, not of math:
a formation's ``dp x tp`` grid of slots decides which chips a dp row
owns (row i the slots ``[i tp, (i+1) tp)`` of the survivors), and each
row's step still runs on whole tensors.  The formation's ``MeshSpec(dp,
tp)`` is handed to every save; a ``ShardedCheckpointer`` built with
the model's rule table (models/layouts.py ``transformer_rules``)
writes its generations in that layout, as the reference writes its
tp-sharded arrays, and a re-formed gang
restores from whatever layout the generation holds — so a tp change
across a reform moves through the reference's format as JAX's does.

Recovery state machine::

    RUNNING ──(worker death / watchdog stall / health down)──▶ SUSPECT
       ▲                                                          │
       │                                    classify via heartbeat │
       │                                    files (dead vs wedged) │
       │                                                          ▼
    RESUME ◀── restore latest checkpoint ◀── REFORM ◀────────── EVICT
               generation onto the NEW         re-issue the gang
               (smaller) mesh + replay         contract at dp//…
               the data loader state           (shrink-to-fit)

- **Detection** rides utils/watchdog.py: every train step runs under
  a per-step deadline (the first steps of each formation get a warm-up
  allowance), the completed-step signal is a scalar readback
  (``float(loss)``, which waits for the card), and each worker keeps a
  heartbeat file under the coordination dir so a stall can be
  attributed: ``dead`` (tombstone), ``wedged`` (stale heartbeat, no
  tombstone), ``slow`` (metric only).
- **Eviction/shrink**: victims' chips leave the slot set and the
  gang reforms at the largest power-of-two dp width that fits the
  survivors and still divides the global batch (dp=4 → 2 on 8
  slots).  An *unattributed* stall (every heartbeat fresh) reforms at
  the SAME width — the chips are not provably gone, so the gang
  restarts in place instead of shrinking on rumor.
- **Resume**: params/opt restore from the latest *readable*
  checkpoint generation into the new formation's state, and the
  data-loader sidecar replays so no batch is skipped or double-applied.

Down-signals mirror the gateway wiring (gateway/replica.py): a
polled ``health_source`` or a pushed :meth:`GangSupervisor.on_health`
(attachable to a health monitor's ``listeners`` hook) maps unhealthy
chip indices to the workers that own them; a scripted
:class:`~..cluster.faults.FaultPlan` injects worker death
(``error: "crash"``) and wedges (``error: "hang"``) through the same
decision path (verb ``"gang"``, kind ``"Worker"``).

External control (the fleet reconciler's surface, fleet/):

- The loop is steppable: ``begin`` + ``step_once`` let one
  single-threaded control loop interleave train steps with serving
  work and reconcile ticks; ``run`` remains begin + drain.
- :meth:`GangSupervisor.request_width` re-forms the gang at a
  requested dp at the next step boundary, AFTER checkpointing the
  current step — a controlled resize loses zero steps.  Shrinks ride
  the same REFORM path an eviction takes (checkpoint-then-shrink
  preemption); grows pass through the EXPAND transition, closing the
  shrink-only gap (the reconciler's heal-driven regrow is its first
  consumer).  ``exclude=`` pins the placement (fleet/binpack.py picks
  WHICH chips in a multi-tenant fleet), :meth:`GangSupervisor.park`
  is the full-reclaim verb (checkpoint, release every chip, idle in
  PARKED until the next request_width), and concurrent requests
  queue latest-wins at the boundary — coalesced to a no-op when the
  gang already matches — so external controllers can never race the
  state machine.  :meth:`GangSupervisor.readmit` is the chip
  up-signal twin of eviction: healed chips return to the buildable
  set (the placement fence is arbitration, not health, and stays).
- ``listeners`` mirror the health monitor's hook: each state transition
  calls ``listener(state, info)`` so external controllers observe
  RUNNING→…→RESUME without polling.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import threading
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..cluster import faults
from ..utils import atomicio, watchdog
from ..utils.device import resolve_device
from ..utils.metrics import RecoveryMetrics
from ..utils.watchdog import (HeartbeatMonitor, WatchdogTimeout,
                              WorkerHeartbeat, run_with_deadline)
from .mesh import MeshSpec

log = logging.getLogger(__name__)

# supervisor states (the contract FAILURE_SEMANTICS.md documents);
# EXPAND marks an externally requested GROW re-formation — the only
# transition the failure paths never emit.  PARKED is the full-reclaim
# state (fleet/tenancy.py preemption cascades): checkpointed, every
# chip released, waiting for a request_width to re-form.
RUNNING = "running"
SUSPECT = "suspect"
EVICT = "evict"
REFORM = "reform"
EXPAND = "expand"
RESUME = "resume"
PARKED = "parked"
FAILED = "failed"
STATES = (RUNNING, SUSPECT, EVICT, REFORM, EXPAND, RESUME, PARKED,
          FAILED)

CONTRACT_FILENAME = "gang.json"


class SupervisorError(RuntimeError):
    """The gang cannot continue (no shrink left, or recovery budget
    exhausted) — the caller's own supervisor owns the restart."""


class GangDeath(RuntimeError):
    """A worker died mid-step; surfaces in-band from the step itself
    (the survivors' collective fails, never hangs — the invariant
    tests/test_multihost_train.py pins)."""

    def __init__(self, worker: str):
        self.worker = worker
        super().__init__(f"gang worker {worker} died mid-step")


class _Aborted(Exception):
    """Internal: a wedged simulated step released by the abort event;
    its (discarded) watchdog thread exits without dispatching."""


@dataclasses.dataclass
class Recovery:
    """One eviction→resume cycle, as recorded in the report."""

    cause: str                   # "dead" | "wedged" | "health"
    victims: list[str]
    from_dp: int
    to_dp: int
    restored_step: int
    steps_lost: int
    mttr_s: float = -1.0         # eviction → first post-resume step


@dataclasses.dataclass
class SupervisorReport:
    losses: list                 # (step, loss) per COMPLETED step
    recoveries: list[Recovery]
    transitions: list[str]
    dp: int                      # final dp width
    steps: int                   # total completed steps
    contract: dict               # the last issued gang contract


@dataclasses.dataclass(eq=False)
class GangMesh:
    """One formation of an :class:`ElasticTrainJob`: ``devices`` is the
    ``[dp, tp]`` array of chip slots (ints) the dp rows own, all
    computing on ``device``; :attr:`spec` is the formation a
    checkpoint save is cut for."""

    devices: np.ndarray
    device: torch.device

    @property
    def spec(self) -> MeshSpec:
        return MeshSpec(dp=self.dp, tp=self.tp)

    @property
    def dp(self) -> int:
        return int(self.devices.shape[0])

    @property
    def tp(self) -> int:
        return int(self.devices.shape[1])


def _row_train_step(cfg, device: torch.device, dp: int):
    """``train_step(params, opt, tokens) -> (params, opt, loss)`` over
    ``dp`` rows: each row's ``B/dp`` shard runs its own forward and
    backward, in row order, on its share of the global mean (its own
    mean over ``dp``); the rows' gradients are summed in f32, as
    ``models/transformer.py``'s ``_sum_grads`` sums a process mesh's,
    then one optimizer step is taken in place.  The loss returned is
    the global mean.  The step makes ``device`` current in the thread
    that runs it (the supervisor's watchdog thread)."""
    from ..models.transformer import bound_leaves, loss_fn

    def train_step(params, opt, tokens):
        leaves = bound_leaves(params, opt)
        tokens = torch.as_tensor(tokens)
        if tokens.shape[0] % dp:
            raise ValueError(f"batch {tokens.shape[0]} does not split "
                             f"over dp={dp} rows")
        rows = tokens.shape[0] // dp
        ctx = (torch.cuda.device(device) if device.type == "cuda"
               else contextlib.nullcontext())
        with ctx:
            tokens = tokens.to(device)
            opt.zero_grad(set_to_none=True)
            sums = None
            loss = torch.zeros((), dtype=torch.float32, device=device)
            for r in range(dp):
                share = loss_fn(params, tokens[r * rows:(r + 1) * rows],
                                cfg) / dp
                share.backward()
                loss += share.detach().float()
                grads = [t.grad.float() for t in leaves]
                for t in leaves:
                    t.grad = None
                if sums is None:
                    sums = grads
                else:
                    for acc, g in zip(sums, grads):
                        acc += g
            for t, g in zip(leaves, sums):
                t.grad = g.to(t.dtype)
            opt.step()
        return params, opt, loss

    return train_step


class ElasticTrainJob:
    """The hermetic gang a supervisor runs: a dp-row transformer train
    step over ``chips`` numbered slots, all on ``device``.

    ``build(dp, exclude_chips)`` is the re-formation hook — the
    in-process analog of re-running a gang prepare at a smaller world
    size: victims' chips never reappear in the new formation.  Real
    deployments supply their own job with the same three methods
    (``build`` / ``make_loader`` / ``batch``).  ``tp`` defaults to 2, as
    in the reference; it places, it does not split the math (module
    docstring).
    """

    def __init__(self, cfg, tokens, *, batch: int, seq_len: int,
                 tp: int = 2, loader_seed: int = 1, chips: int = 8,
                 device="cuda"):
        self.cfg = cfg
        self.tokens = tokens
        self.batch = batch
        self.seq_len = seq_len
        self.tp = tp
        self.loader_seed = loader_seed
        self.chips = chips
        self.device = resolve_device(device)

    def build(self, dp: int, exclude_chips=frozenset(),
              tp: int | None = None):
        """(gang, train_step, init_state) over the first ``dp x tp``
        surviving slots, never touching an excluded (evicted) chip.
        ``tp`` re-aims the tensor-parallel width for this and later
        formations; None keeps the current one.  The job's width only
        commits on a successful build, so a failed formation leaves
        the old tp intact for retries."""
        from ..models import make_train_step

        tp = self.tp if tp is None else tp
        devs = [c for c in range(self.chips) if c not in exclude_chips]
        need = dp * tp
        if len(devs) < need:
            raise SupervisorError(
                f"cannot form dp={dp} tp={tp}: need {need} "
                f"devices, {len(devs)} survive eviction")
        gang = GangMesh(np.asarray(devs[:need]).reshape(dp, tp),
                        self.device)
        _, init_state = make_train_step(self.cfg, self.device)
        step_fn = _row_train_step(self.cfg, self.device, dp)
        self.tp = tp
        return gang, step_fn, init_state

    def make_loader(self):
        from ..models.data import BatchLoader
        return BatchLoader(self.tokens, batch=self.batch,
                           seq_len=self.seq_len, seed=self.loader_seed)


@dataclasses.dataclass
class _Worker:
    name: str
    chips: tuple                 # device ids this dp row owns
    hb: WorkerHeartbeat
    alive: bool = True


class GangSupervisor:
    """Owns the train loop and recovers it (see module docstring).

    ``step_deadline_s`` bounds every steady-state step;
    ``first_step_deadline_s`` is the warm-up allowance for the first
    ``warmup_steps`` steps of each formation (a new formation's first
    steps pay the allocator's growth and, on the card, the kernels'
    first loads).  ``ckpt`` is a models/checkpoint.py
    ``TrainCheckpointer`` or a parallel/resharding.py
    ``ShardedCheckpointer`` (both take the formation as ``save(...,
    mesh=)``; the first ignores it); a generation is
    saved every ``checkpoint_every`` completed steps (plus generation
    0 at start, so an early death never strands the gang without a
    restore point) with the loader state as the ``extra`` sidecar.
    """

    def __init__(self, job, ckpt, *, coordination_dir: Path | str,
                 dp: int, fault_plan: faults.FaultPlan | None = None,
                 health_source: Callable[[], dict] | None = None,
                 metrics: RecoveryMetrics | None = None,
                 step_deadline_s: float = 30.0,
                 first_step_deadline_s: float = 300.0,
                 warmup_steps: int = 2,
                 soft_deadline_s: float | None = None,
                 checkpoint_every: int = 4,
                 max_recoveries: int = 4,
                 init_seed: int = 0,
                 placement_exclude=()):
        self.job = job
        self.ckpt = ckpt
        self.dir = Path(coordination_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.dp = dp
        self.plan = fault_plan
        self.health_source = health_source
        self.metrics = metrics or RecoveryMetrics()
        self.step_deadline_s = step_deadline_s
        self.first_step_deadline_s = first_step_deadline_s
        self.warmup_steps = warmup_steps
        self.monitor = HeartbeatMonitor(
            self.dir,
            soft_s=(soft_deadline_s if soft_deadline_s is not None
                    else step_deadline_s / 2),
            hard_s=step_deadline_s)
        self.checkpoint_every = checkpoint_every
        self.max_recoveries = max_recoveries
        self.init_seed = init_seed

        self.state = RUNNING
        self.transitions: list[str] = [RUNNING]
        self.losses: list = []
        self.recoveries: list[Recovery] = []
        self.contract: dict = {}
        self.slow_steps = 0
        # state-transition subscribers, mirroring the health monitor's
        # listener hook: called with (state, info) on every
        # transition; must not raise — one failing listener must not
        # starve its siblings or the recovery itself
        self.listeners: list = []
        self._gen = 0                    # formation generation
        self._dead_chips: set = set()
        # placement arbitration (fleet/tenancy.py): chips an external
        # arbiter fenced off from this gang — healthy, just someone
        # else's.  Disjoint from _dead_chips so a heal (readmit)
        # never hands the gang a chip the arbiter took away.
        self._placement_excluded: set = set(
            int(c) for c in placement_exclude)
        self._unhealthy: dict = {}
        # last merged (push + poll) unhealthy view, refreshed by
        # _poll_down and consumed by _form: a chip that is down RIGHT
        # NOW must not join a formation even if no current worker
        # owns it (the chip-death-mid-REFORM double fault: the victim
        # set was counted before the second chip died)
        self._last_unhealthy: dict = {}
        self._unhealthy_lock = threading.Lock()
        # externally requested operation (request_width / park),
        # consumed at the next step boundary by step_once.  A single
        # latest-wins slot: a second request arriving while a
        # REFORM/EXPAND is already in flight queues here and is
        # coalesced at the boundary if the gang already matches it —
        # requests can never race the state machine mid-transition.
        self._requested: tuple | None = None
        self._width_lock = threading.Lock()
        self._step = 0
        self._total_steps = 0
        # released on eviction so a simulated wedge (fault "hang")
        # unblocks promptly instead of leaking a sleeping thread
        self._abort = threading.Event()
        self.workers: list[_Worker] = []
        self._formation_steps = 0        # steps since the last reform

    # -- down-signals (the gateway-mirroring surface) --------------------

    def on_health(self, unhealthy: dict) -> None:
        """Health-monitor listener signature: the full unhealthy
        dict on every transition.  Thread-safe; consumed at the next
        loop iteration."""
        with self._unhealthy_lock:
            self._unhealthy = dict(unhealthy)

    def attach(self, health_monitor) -> None:
        """Subscribe to a health monitor (anything with a
        ``listeners`` list, like the driver plugin's ``HealthMonitor``)
        — chip-down events reach the supervisor even when the apiserver
        is unreachable, exactly like the gateway's replica drain
        wiring."""
        health_monitor.listeners.append(self.on_health)

    def request_width(self, dp: int, *, tp=None, exclude=None) -> None:
        """Ask the gang to re-form at ``dp`` data-parallel rows at the
        next step boundary (the fleet reconciler's resize verb):
        checkpoint-then-shrink preemption when ``dp`` is smaller,
        EXPAND regrow when larger — including regrow out of PARKED.
        ``tp`` (optional) re-aims the tensor-parallel width in the
        same boundary (a dp AND tp change is still restore-onto-a-new-
        layout, not a different operation); None keeps the job's
        current tp.
        ``exclude`` (optional) replaces the placement-exclusion set,
        so a multi-tenant arbiter can pin WHICH chips the formation
        may use (fleet/binpack.py chose them); None keeps the current
        placement fence.

        Concurrency contract: thread-safe, latest request wins, and a
        request arriving while a REFORM/EXPAND is already in flight
        QUEUES for the next step boundary — it never races the state
        machine.  A request the gang already satisfies (same dp, same
        placement) coalesces to a no-op at the boundary instead of
        burning a reform.  Raises ``ValueError`` for a width no
        formation could ever run (static infeasibility); a width that
        is merely infeasible RIGHT NOW (chips vanished since the
        request) is dropped at apply time with a warning instead of
        killing the run."""
        if dp < 1:
            raise ValueError(f"dp must be >= 1, got {dp}")
        if self.job.batch % dp:
            raise ValueError(
                f"dp {dp} does not divide global batch {self.job.batch}")
        if tp is not None and tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        with self._width_lock:
            self._requested = ("width", dp, None if tp is None
                               else int(tp),
                               None if exclude is None
                               else frozenset(int(c) for c in exclude))

    def park(self) -> None:
        """Full reclaim, the floor-zero verb of the multi-tenant
        preemption cascade (fleet/tenancy.py): at the next step
        boundary the gang checkpoints its CURRENT step, releases
        EVERY chip, and idles in PARKED — zero steps lost, exactly
        like a controlled shrink, but the tenant's whole allocation
        returns to the pool.  A later ``request_width`` re-forms from
        the parked checkpoint through EXPAND→REFORM→RESUME.
        Thread-safe; latest request wins (a park followed by a
        request_width before the boundary resolves to the resize)."""
        with self._width_lock:
            self._requested = ("park",)

    def readmit(self, chips) -> None:
        """Chip up-signal, the heal twin of eviction: the caller (the
        reconciler, forwarding the health stack's recovery) asserts
        these chips are healthy again, and the supervisor stops
        excluding them — they rejoin the buildable set at the next
        (re)formation, which is what makes an EXPAND back to full
        width possible after a health eviction."""
        chips = set(chips)
        with self._unhealthy_lock:
            self._dead_chips -= chips
            for c in chips:
                self._unhealthy.pop(c, None)
                self._last_unhealthy.pop(c, None)

    def _probation_readmit(self) -> set:
        """Release-valve for the eviction fence: readmit fenced chips
        the merged health view does NOT currently report down, and
        return the set released.  A crash eviction fences the
        victim's chips, but a SOFTWARE crash never produces the heal
        that :meth:`readmit` forwards for a real chip death — without
        a release valve every crash permanently burns a chip and a
        long-lived gang starves out of its own allocation.  Called
        only from a resize's infeasibility path (the fence must hold
        through ``_recover`` itself: reforming straight back onto a
        just-crashed chip would race a lagging health signal)."""
        with self._unhealthy_lock:
            down = set(self._last_unhealthy) | set(self._unhealthy)
            cleared = {c for c in self._dead_chips if c not in down}
            self._dead_chips -= cleared
        if cleared:
            log.warning("probation readmit of fenced chips %s "
                        "(health view reports them up)",
                        sorted(cleared))
        return cleared

    def update_fence(self, add=(), discard=()) -> None:
        """Incremental placement-fence maintenance between resizes.

        ``request_width(exclude=...)`` REPLACES the fence wholesale
        (the packer chose a run); this verb lets the arbiter keep the
        fence truthful BETWEEN formations — e.g. a chip just granted
        to a serving tenant must stop being buildable for every gang
        immediately, or a heal landing mid-cascade hands the gang a
        chip someone else now owns (the heal-mid-preemption double
        fault).  Thread-safe; takes effect at the next formation and
        never triggers one."""
        with self._unhealthy_lock:
            self._placement_excluded |= {int(c) for c in add}
            self._placement_excluded -= {int(c) for c in discard}

    def _poll_down(self):
        """(victims, cause) from push/poll health plus tombstones an
        external bed may have written.  Stale-heartbeat classification
        stays OUT of this path: between steps the supervisor itself
        owns the clock, and a wedge is only diagnosable while a step
        is actually overdue (the watchdog path)."""
        unhealthy = dict(self._unhealthy)
        if self.health_source is not None:
            try:
                unhealthy.update(self.health_source() or {})
            except Exception:
                # health-monitor contract: a failed probe keeps the
                # last observed state
                log.exception("health source failed; keeping last")
        self._last_unhealthy = dict(unhealthy)
        victims, cause = [], None
        for w in self.workers:
            if not w.alive:
                continue
            if any(c in unhealthy for c in w.chips):
                victims.append(w)
                cause = "health"
            elif self.monitor.classify(w.name) == watchdog.DEAD:
                victims.append(w)
                cause = cause or "dead"
        return victims, cause

    def _save(self, step: int) -> None:
        """Checkpoint ``step`` with the loader state as the sidecar,
        handing the checkpointer the formation (``mesh``): a
        ``ShardedCheckpointer`` built with the model's rules cuts the
        generation into that formation's blocks."""
        self.ckpt.save(step, self.params, self.opt,
                       extra=self.loader.state_dict(), mesh=self.mesh.spec)

    # -- formation -------------------------------------------------------

    def _form(self, dp: int, tp: int | None = None) -> None:
        """(Re-)issue the gang contract at world size ``dp`` and stand
        the gang/step program up over the surviving chips.  The build
        runs BEFORE any state mutates, so a failed formation (not
        enough healthy devices) leaves the current gang intact — the
        property the apply-time resize fallback relies on.

        The exclusion set folds in the last observed unhealthy view
        (push + poll), not just the dead and fenced chips: a chip can
        go down AFTER the victim set was counted (chip death mid-
        REFORM/EXPAND, the classic double fault) or while the gang is
        PARKED with nobody polling, and forming over it would only
        buy an immediate second eviction — or a formation on a chip
        another tenant's replica is actively using."""
        with self._unhealthy_lock:
            down = (set(self._last_unhealthy)
                    | set(self._unhealthy)) - set(self._dead_chips)
        # tp rides as a kwarg only when a resize re-aims it, so a
        # user-supplied job with the documented two-argument ``build``
        # keeps working for every dp-only arc
        kwargs = {} if tp is None else {"tp": int(tp)}
        mesh, step_fn, init_state = self.job.build(
            dp, exclude_chips=frozenset(self._dead_chips
                                        | self._placement_excluded
                                        | down), **kwargs)
        self.dp = dp
        self.mesh, self.step_fn, self.init_state = (mesh, step_fn,
                                                    init_state)
        grid = np.asarray(self.mesh.devices).reshape(dp, -1)
        self.workers = []
        for i in range(dp):
            name = f"g{self._gen}w{i}"
            chips = tuple(int(d) for d in grid[i])
            w = _Worker(name, chips, WorkerHeartbeat(self.dir, name))
            w.hb.beat(0, "formed")
            self.workers.append(w)
        self.contract = {
            "generation": self._gen,
            "num_workers": dp,
            "dp": dp,
            "tp": getattr(self.job, "tp", None),
            "world_devices": int(grid.size),
            "workers": [w.name for w in self.workers],
            "excluded_chips": sorted(self._dead_chips),
            "placement_excluded": sorted(self._placement_excluded),
        }
        # the contract is the checkpoint's manifest: restore reads it
        # to find the generation, so it gets the same tmp+fsync+rename
        # discipline as the generations themselves
        atomicio.write_atomic(self.dir / CONTRACT_FILENAME,
                              json.dumps(self.contract, indent=1))
        self._gen += 1
        self._formation_steps = 0
        self.metrics.dp_width.set(dp)

    # -- the supervised step ---------------------------------------------

    def _one_step(self, step: int):
        """One train step as the watchdog thread runs it.  Fault
        decisions are consumed BEFORE the loader advances or buffers
        are donated, so a failed step consumes no data and leaves the
        restore path nothing to unwind."""
        from ..models.data import as_global

        alive = [w for w in self.workers if w.alive]
        for w in alive:
            if self.plan is None:
                continue
            d = self.plan.decide(faults.GANG_VERB,
                                 faults.GANG_WORKER_KIND, w.name)
            if d is None or not d.error:
                continue
            if d.error == "crash":
                # in-band death: the worker tombstones (its teardown,
                # or the bed that SIGKILLed it, records the exit) and
                # the survivors' collective errors out
                w.hb.tombstone(faults.CRASH_EXIT_CODE)
                w.alive = False
                raise GangDeath(w.name)
            if d.error == "hang":
                # injected wedge: THIS worker's heartbeat freezes while
                # the survivors — blocked in the collective but with
                # live heartbeat threads — keep beating a stuck step.
                # The supervisor's watchdog fires and classification
                # attributes the stall to the silent worker.
                stall_until = time.monotonic() + (d.latency_s or 600.0)
                while (time.monotonic() < stall_until
                       and not self._abort.is_set()):
                    for s in alive:
                        if s is not w:
                            s.hb.beat(step + 1, "collective")
                    self._abort.wait(0.2)
                raise _Aborted()
        for w in alive:
            w.hb.beat(step + 1, "begin")
        tokens = as_global(next(self.loader), self.mesh)
        self.params, self.opt, loss = self.step_fn(
            self.params, self.opt, tokens)
        # scalar readback: waits for the step's last kernel, so a
        # wedged step cannot look finished
        loss = float(loss)
        for w in alive:
            w.hb.beat(step + 1, "end")
        return loss

    # -- recovery --------------------------------------------------------

    def _classify_stall(self):
        """Attribute an overdue step via heartbeat files.  Workers
        with a tombstone are dead; workers silent past the hard
        deadline are wedged; if every heartbeat is fresh the stall is
        unattributed (empty victim list → same-size reform)."""
        victims, cause = [], "wedged"
        for w in self.workers:
            if not w.alive:
                continue
            cls = self.monitor.classify(w.name)
            if cls == watchdog.DEAD:
                victims.append(w)
                cause = "dead"
            elif cls in (watchdog.WEDGED, watchdog.MISSING):
                victims.append(w)
        return victims, cause

    def _fit_dp(self, max_dp: int) -> int:
        """Largest power-of-two dp width ``<= max_dp`` that divides
        the global batch; 0 when nothing fits."""
        dp = 1
        while dp * 2 <= max_dp and self.job.batch % (dp * 2) == 0:
            dp *= 2
        if max_dp < 1 or self.job.batch % dp:
            return 0
        return dp

    def _shrunk_dp(self, n_victims: int) -> int:
        """Largest power-of-two dp width that fits the survivors and
        divides the global batch; 0 when nothing fits."""
        return self._fit_dp(self.dp - n_victims)

    def _transition(self, state: str) -> None:
        prev = self.state
        self.state = state
        self.transitions.append(state)
        self.metrics.set_state(state, STATES)
        # "from" rides along so listeners (the tracing span emitter,
        # utils/tracing.py attach_supervisor) see the full edge, not
        # just the destination — a PARKED->RESUME and a SUSPECT->
        # RESUME edge mean very different things to a flight recorder
        info = {"from": prev, "dp": self.dp, "step": self._step,
                "generation": self._gen}
        for listener in list(self.listeners):
            try:
                listener(state, info)
            except Exception:
                log.exception("supervisor state listener failed")

    def _recover(self, victims: list[_Worker], cause: str) -> None:
        t0 = time.perf_counter()
        self._transition(EVICT)
        self._abort.set()              # release any simulated wedge
        # only FAILURE recoveries consume the budget: controlled
        # resizes (preempt/expand, the reconciler's verbs) are
        # decisions, and a long arbitration history must not strand a
        # healthy gang in FAILED
        failures = sum(1 for r in self.recoveries
                       if r.cause in ("dead", "wedged", "health"))
        if failures >= self.max_recoveries:
            self._transition(FAILED)
            raise SupervisorError(
                f"recovery budget exhausted ({self.max_recoveries}) "
                f"on {cause}: {[w.name for w in victims]}")
        for w in victims:
            w.alive = False
            self._dead_chips.update(w.chips)
        self.metrics.restarts.labels(cause=cause).inc()
        self.metrics.evicted_workers.inc(len(victims))
        new_dp = self._shrunk_dp(len(victims)) if victims else self.dp
        log.warning("evicting %s (%s): dp %d -> %d",
                    [w.name for w in victims] or "nobody (unattributed"
                    " stall; restart in place)", cause, self.dp, new_dp)
        if new_dp < 1:
            self._transition(FAILED)
            raise SupervisorError(
                f"gang unrecoverable: {len(victims)} victim(s) leave "
                f"no dp width that divides batch {self.job.batch}")
        from_dp = self.dp
        self._transition(REFORM)
        while True:
            try:
                self._form(new_dp)
                break
            except SupervisorError as e:
                # a second fault landed mid-REFORM: the buildable set
                # shrank after the victims were counted (a chip died
                # between eviction and build).  Shrink to the next
                # width that fits what actually survives instead of
                # letting the recovery itself die.
                smaller = self._fit_dp(new_dp - 1)
                log.warning("reform at dp=%d infeasible (%s); "
                            "retrying at dp=%d", new_dp, e, smaller)
                if smaller < 1:
                    self._transition(FAILED)
                    raise SupervisorError(
                        f"gang unrecoverable: no dp width survives "
                        f"the compound fault (last tried {new_dp})"
                    ) from e
                new_dp = smaller
        self._transition(RESUME)
        params, opt = self.init_state(self._key())
        self.params, self.opt, at = self.ckpt.restore(params, opt)
        self.loader.load_state_dict(
            self.ckpt.restore_extra(at) or {"epoch": 0, "step": 0})
        lost = self._step - at
        rec = Recovery(cause=cause, victims=[w.name for w in victims],
                       from_dp=from_dp, to_dp=new_dp, restored_step=at,
                       steps_lost=lost)
        self.recoveries.append(rec)
        self._pending = (rec, t0)
        self._step = at
        self.metrics.steps_lost.inc(lost)
        self.metrics.steps_lost_last.set(lost)
        self._abort.clear()
        self._transition(RUNNING)
        log.warning("resumed at step %d on dp=%d (%d step(s) to "
                    "replay)", at, new_dp, lost)

    def _resize(self, target: int, exclude=None,
                tp: int | None = None) -> None:
        """Apply an externally requested width change (request_width):
        checkpoint the CURRENT step first — a controlled resize must
        lose nothing — then re-form through the same REFORM path an
        eviction takes.  Grows pass through EXPAND, the transition the
        shrink-only failure paths never emit; restore into the new
        formation rides the same path a recovery uses (a dp change is
        a placement change, not a math change).  A parked gang skips the save (its checkpoint was
        written at park time; there is nothing live to save) and
        resumes from it."""
        parked = self.state == PARKED
        cause = "expand" if (parked or target > self.dp) else "preempt"
        t0 = time.perf_counter()
        # refresh the health view before forming: the op slot is
        # consumed BEFORE this cycle's down-poll, and a PARKED gang
        # has not polled since it parked — without this, an unpark
        # resize forms over a chip that died while the request was
        # queued (the resize-while-PARKED double fault) and buys an
        # immediate second eviction instead of staying parked
        self._poll_down()
        if not parked:
            self._save(self._step)
        from_dp = self.dp
        old_placement = set(self._placement_excluded)
        if exclude is not None:
            self._placement_excluded = set(exclude)
        if cause == "expand":
            self._transition(EXPAND)
        self._transition(REFORM)
        for retry in (False, True):
            try:
                self._form(target, tp=tp)
                break
            except SupervisorError as e:
                # the fence itself may be all that blocks the width
                # (crash-fenced chips no heal will ever release):
                # _poll_down() above just refreshed the health view,
                # so readmit what it reports up and retry once
                if not retry and self._probation_readmit():
                    continue
                # transiently infeasible (chips vanished between
                # request and apply): keep training at the current
                # width — _form mutated nothing, and the reconciler
                # sees the unchanged dp gauge and may re-request when
                # supply returns
                self._placement_excluded = old_placement
                log.warning("resize to dp=%d infeasible (%s); staying"
                            " at dp=%d", target, e, from_dp)
                self._transition(PARKED if parked else RUNNING)
                return
        self._transition(RESUME)
        params, opt = self.init_state(self._key())
        self.params, self.opt, at = self.ckpt.restore(params, opt)
        self.loader.load_state_dict(
            self.ckpt.restore_extra(at) or {"epoch": 0, "step": 0})
        lost = self._step - at
        rec = Recovery(cause=cause, victims=[], from_dp=from_dp,
                       to_dp=target, restored_step=at, steps_lost=lost)
        self.recoveries.append(rec)
        self._pending = (rec, t0)
        self._step = at
        self.metrics.restarts.labels(cause=cause).inc()
        self.metrics.steps_lost.inc(lost)
        self.metrics.steps_lost_last.set(lost)
        self._transition(RUNNING)
        log.warning("resized gang dp %d -> %d (%s) at step %d",
                    from_dp, target, cause, at)

    def _park(self) -> None:
        """Apply a queued :meth:`park`: checkpoint the current step,
        release every chip (workers cleared, device buffers dropped),
        and idle in PARKED.  Zero steps lost by construction — the
        checkpoint IS the current step, and the later unpark restores
        it through the normal elastic path."""
        self._save(self._step)
        from_dp = self.dp
        self.workers = []
        self.dp = 0
        # drop the live program and its device buffers: a parked
        # tenant must hold no device memory, only its checkpoint on disk
        self.params = self.opt = None
        self.mesh = self.step_fn = None
        self.contract = {
            "generation": self._gen,
            "num_workers": 0,
            "dp": 0,
            "world_devices": 0,
            "workers": [],
            "parked": True,
            "excluded_chips": sorted(self._dead_chips),
            "placement_excluded": sorted(self._placement_excluded),
        }
        # the contract is the checkpoint's manifest: restore reads it
        # to find the generation, so it gets the same tmp+fsync+rename
        # discipline as the generations themselves
        atomicio.write_atomic(self.dir / CONTRACT_FILENAME,
                              json.dumps(self.contract, indent=1))
        self._gen += 1
        self.metrics.dp_width.set(0)
        self.recoveries.append(Recovery(
            cause="park", victims=[], from_dp=from_dp, to_dp=0,
            restored_step=self._step, steps_lost=0))
        self.metrics.restarts.labels(cause="park").inc()
        self._pending = None
        self._transition(PARKED)
        log.warning("parked gang (was dp=%d) at step %d; all chips "
                    "released", from_dp, self._step)

    def _key(self) -> torch.Generator:
        """The init generator, seeded ``init_seed``, on the job's
        device (the restore overwrites what it draws)."""
        dev = getattr(self.job, "device", "cpu")
        return torch.Generator(device=dev).manual_seed(self.init_seed)

    # -- the loop --------------------------------------------------------

    def begin(self, total_steps: int) -> None:
        """Form the gang and arm the loop.  Pair with ``step_once``
        when an external single-threaded control loop (the fleet
        reconciler's co-loop) interleaves train steps with serving
        work and reconcile ticks; ``run`` is begin + drain."""
        self._total_steps = total_steps
        self._form(self.dp)
        self.loader = self.job.make_loader()
        self.params, self.opt = self.init_state(self._key())
        self._save(0)
        self._step = 0
        self._pending = None
        self.metrics.set_state(RUNNING, STATES)

    def step_once(self) -> bool:
        """Advance the supervised run by at most one unit of work —
        one completed train step, one recovery, or one applied resize
        — and return True while steps remain.  Raises SupervisorError
        exactly like ``run`` when recovery bottoms out."""
        if self._step >= self._total_steps:
            return False
        with self._width_lock:
            op, self._requested = self._requested, None
        if op is not None:
            if op[0] == "park":
                if self.state != PARKED:
                    self._park()
                    return self._step < self._total_steps
            else:
                _, target, tp, exclude = op
                same_placement = (
                    exclude is None
                    or set(exclude) == self._placement_excluded)
                same_tp = tp is None or tp == getattr(
                    self.job, "tp", tp)
                if (self.state == PARKED or target != self.dp
                        or not same_tp or not same_placement):
                    self._resize(target, exclude, tp=tp)
                    return self._step < self._total_steps
                # coalesced: the gang already matches the request
                # (same width, same placement) — an idempotent no-op,
                # not another REFORM arc
        if self.state == PARKED:
            # parked gangs idle at zero cost: stay live for the
            # co-loop (an unpark request_width may arrive any tick)
            # but run nothing and poll nobody — there are no workers
            return self._step < self._total_steps
        victims, cause = self._poll_down()
        if victims:
            self._transition(SUSPECT)
            self._recover(victims, cause)
            return True
        warm = self._formation_steps >= self.warmup_steps
        deadline = (self.step_deadline_s if warm
                    else self.first_step_deadline_s)
        t_start = time.perf_counter()
        try:
            loss = run_with_deadline(
                lambda: self._one_step(self._step), deadline,
                label=f"train step {self._step + 1} "
                      f"(gen {self._gen - 1})")
        except WatchdogTimeout:
            self._transition(SUSPECT)
            self._recover(*self._classify_stall())
            return True
        except GangDeath as e:
            self._transition(SUSPECT)
            victim = [w for w in self.workers
                      if w.name == e.worker]
            self._recover(victim, "dead")
            return True
        if (warm and time.perf_counter() - t_start
                >= self.monitor.soft_s):
            self.slow_steps += 1     # progressing, just slow
        self._formation_steps += 1
        self._step += 1
        self.losses.append((self._step, loss))
        if self._pending is not None:
            rec, t0 = self._pending
            rec.mttr_s = time.perf_counter() - t0
            self.metrics.observe_recovery(rec.mttr_s)
            self._pending = None
        if self._step % self.checkpoint_every == 0:
            self._save(self._step)
        return self._step < self._total_steps

    def report(self) -> SupervisorReport:
        """The run's record so far — callable mid-run by an external
        control loop as well as at the end."""
        return SupervisorReport(
            losses=self.losses, recoveries=self.recoveries,
            transitions=self.transitions, dp=self.dp,
            steps=self._step, contract=self.contract)

    def run(self, total_steps: int) -> SupervisorReport:
        self.begin(total_steps)
        while self.step_once():
            pass
        return self.report()


__all__ = ["CONTRACT_FILENAME", "EVICT", "EXPAND", "FAILED", "PARKED",
           "REFORM", "RESUME", "RUNNING", "STATES", "SUSPECT",
           "ElasticTrainJob", "GangDeath", "GangMesh", "GangSupervisor",
           "Recovery", "SupervisorError", "SupervisorReport"]
