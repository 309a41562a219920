"""Compound-fault crucible: a seeded whole-fleet chaos soak.

The port of ``k8s_dra_driver_tpu/cluster/crucible.py`` over the port's
engines, gateways and gangs.  Real incidents are compound: the second
fault lands inside the first one's recovery window (a chip dies while
a gang is mid-REFORM, a decode replica drains while a KV handoff is in
flight, a heal arrives mid-preemption-cascade, a resize applies to a
gang that parked and lost a chip nobody was polling).  This module
composes such faults on demand at fleet scope.

One :class:`CrucibleRig` composes the FULL workload stack in a single
deterministic co-loop (a ShardedGateway over a disaggregated
prefill/decode pool, two elastic training gangs, and the multi-tenant
reconciler arbitrating one chip ledger) while a :class:`Schedule` of
:class:`FaultEvent`\\ s drives every fault primitive cluster/faults.py
exposes: chip kill/heal (ScriptedChipHealth), gang-worker crash and
hang, replica kills, and tenant load bursts.  Events fire either at a
fixed cycle or when a named RECOVERY WINDOW opens (``window=``,
matched by glob against the windows the rig observes every cycle:
``reform:<gang>``, ``resize_queued:<gang>``, ``parked:<gang>``,
``drain:hi``, ``handoff:hi``, ``cascade``), which is how a schedule
composes a second fault inside the first one's recovery arc.

The always-on checkers (cluster/invariants.py) run after EVERY cycle;
end-of-run adds exactly-once terminal outcomes and byte-equality
against single-engine oracles.  On violation, :func:`minimize`
delta-debugs (ddmin) the schedule down to a minimal failing event
set, :func:`write_repro` persists a replayable repro (seed + schedule
JSON + the violation log), and :func:`replay` re-runs it, with the
flight recorder (cluster/flightrec.py) dumping into the repro
directory.  The repro format and JSON are the reference's: a repro
written by either package replays in the other.

The model, the gangs' config and the device come from the caller:
``model=(cfg, params)`` for the engines and the oracles, ``gang_cfg=``
for the two gangs (default: the model's config) and ``device=``
(default ``"cuda"``); :func:`run_soak`, :func:`minimize`,
:func:`replay` and :func:`investigate` pass them through.  The default
model has the reference crucible's fields (vocab 64, d_model 32, 2
layers, 4 heads of 8 over 2 KV heads, d_ff 64, max_seq 48, f32) with
weights from the port's ``init_params`` on a CPU generator seeded 0,
and burst prompts are ``np.random.default_rng(seed).integers(0,
vocab, n)``; neither is the reference's (its weights and prompts come
from JAX's RNG).  On the card the default model's attention runs the
kernels at head dim 8.

Determinism contract: a run is a pure function of the schedule (and
the model).  Fault plans are armed at event fire time
(FaultPlan.arm), fire times are a function of (cycle, observed
windows), windows are a function of prior cycles, and every RNG in the
stack (EventBus shuffle, plan probability draws) is seeded from the
schedule, so replaying a repro reproduces the identical injection log
and the identical violation.  Wall-clock only enters through recovery
MTTR statistics and the watchdog deadline that converts a scripted
hang into an eviction; neither feeds back into scheduling.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import functools
import json
import logging
import math
import random
import zlib
from collections import deque
from pathlib import Path

import numpy as np

from . import invariants
from .faults import (CHIP_KIND, GANG_VERB, GANG_WORKER_KIND, HEAL,
                     HEALTH_VERB, PUMP_KIND, PUMP_VERB, FaultPlan,
                     FaultRule, ScriptedChipHealth)

log = logging.getLogger(__name__)

#: fault kinds a schedule may compose (FaultEvent.kind).  The three
#: corruption kinds damage a gang's NEWEST committed checkpoint
#: generation on disk: ``shard_bitflip``/``shard_truncate`` tamper
#: with a shard file (silent media corruption / a torn write), and
#: ``gen_tear`` deletes the generation's manifest — the exact on-disk
#: state a crash between the shard writes and the manifest commit
#: leaves behind (parallel/resharding.py two-phase discipline).
#: ``kv_exhaust`` (serving_kv/) seizes every free KV block on the
#: matching paged replicas for ``heal_after`` cycles — the fleet-wide
#: memory-pressure wave: admission must hold/shed at the gateway and
#: the starved engines must keep their in-flight rows byte-exact.
#: ``pump_kill`` (gateway/procpump.py) SIGKILLs a REAL pump
#: subprocess of a multi-process gateway via its ``pump_plan``
#: (cluster/faults.py PUMP_VERB) — the cross-process drain arc; on an
#: in-process gateway (no ``pump_plan``) it is a logged no-op.
#: ``adapter_evict_storm`` (serving_lora/) evicts every cold adapter
#: and pins the matching replicas' pools down to ONE usable resident
#: slot for ``heal_after`` cycles — the multi-adapter starvation
#: wave: adapter'd fills serialize through the surviving slot or
#: hold at their prefill replicas, and the release must cold-load
#: the evicted adapters back with byte-exact outputs.
#: ``tier_corrupt`` (serving_kv/tiers.py) bit-flips one demoted KV
#: slab (host arena in place, disk slab rewritten) on the matching
#: tiered replicas — silent media corruption below the device tier:
#: the next prefix hit must detect it at promote time (crc32), drop
#: the entry loudly and fall back to recompute, staying byte-exact
#: and exactly-once; on an untiered replica (or one with nothing
#: demoted yet) it is a logged no-op.
#: kind -> one-line description.  Insertion-ordered, so EVENT_KINDS
#: (derived below) keeps the historical tuple order and every count
#: pin becomes "matches the registry" instead of a hardcoded integer
#: that churns each time the crucible learns a new fault.
FAULT_KIND_REGISTRY: dict[str, str] = {}


def register_fault_kind(kind: str, description: str = "") -> str:
    """Add a fault kind to the roster (idempotent only for identical
    re-registration; a silent overwrite would hide a name collision
    between two subsystems' faults)."""
    if kind in FAULT_KIND_REGISTRY:
        if FAULT_KIND_REGISTRY[kind] != description:
            raise ValueError(f"fault kind {kind!r} already registered "
                             f"with a different description")
        return kind
    FAULT_KIND_REGISTRY[kind] = description
    global EVENT_KINDS
    EVENT_KINDS = tuple(FAULT_KIND_REGISTRY)
    return kind


EVENT_KINDS: tuple = ()
for _kind, _desc in (
        ("chip_kill", "chip goes unhealthy; heals after heal_after"),
        ("worker_crash", "gang worker process dies"),
        ("worker_hang", "gang worker wedges past the watchdog"),
        ("replica_kill", "serving replica marked down mid-flight"),
        ("burst", "open-loop request wave (load, not a fault)"),
        ("shard_bitflip", "newest checkpoint shard: silent bitflip"),
        ("shard_truncate", "newest checkpoint shard: torn write"),
        ("gen_tear", "newest generation: manifest deleted"),
        ("kv_exhaust", "paged replicas: free KV blocks seized"),
        ("pump_kill", "multi-process gateway pump SIGKILLed"),
        ("adapter_evict_storm", "adapter pools seized to one slot"),
        ("tier_corrupt", "demoted KV slab: silent bitflip")):
    register_fault_kind(_kind, _desc)
del _kind, _desc

CORRUPTION_KINDS = ("shard_bitflip", "shard_truncate", "gen_tear")

#: reconciler event kinds that open the "cascade" window
CASCADE_KINDS = frozenset({"grant", "reclaim_park", "reclaim_shrink",
                           "reclaim_drain", "release", "regrow"})

#: how long (in clock units = cycles) a reconciler action keeps the
#: "cascade" window open
CASCADE_WINDOW_S = 5.0

#: repro file format tag (versioned so a future schema change fails
#: loudly instead of replaying garbage)
REPRO_FORMAT = "tpu-dra-crucible-repro/1"

# -- the model ---------------------------------------------------------

#: the reference crucible's model fields (f32 on every side)
DEFAULT_FIELDS = dict(vocab=64, d_model=32, n_layers=2, n_heads=4,
                      d_head=8, d_ff=64, max_seq=48, n_kv_heads=2)

#: device -> (cfg, params) of the default model, built once
_DEFAULT_MODELS: dict = {}
#: id(params) -> (params, {(seed, n, max_new, adapter): tokens}); the
#: params are held so their id is never reused while cached
_ORACLES: dict = {}


def default_model(device="cuda") -> tuple:
    """The default ``(cfg, params)``: :data:`DEFAULT_FIELDS` in f32,
    weights from ``init_params`` on a CPU generator seeded 0 (so the
    CPU and the card hold the same weights), cached per device."""
    import torch

    from ..models import TransformerConfig, init_params
    from ..utils.device import resolve_device
    dev = resolve_device(device)
    key = str(dev)
    if key not in _DEFAULT_MODELS:
        cfg = TransformerConfig(dtype=torch.float32, **DEFAULT_FIELDS)
        _DEFAULT_MODELS[key] = (cfg, init_params(
            cfg, torch.Generator().manual_seed(0), device=dev))
    return _DEFAULT_MODELS[key]


def prompt_tokens(seed: int, n: int, vocab: int) -> np.ndarray:
    """Burst prompt ``seed`` of length ``n``: numpy's generator."""
    return np.random.default_rng(seed).integers(
        0, vocab, n).astype(np.int32)


#: the reference's host arena (1 MiB) in blocks of its model's slabs:
#: 2 layers x (k, v) x 16 positions x 2 KV heads x 8 dims x 4 bytes
#: = 4096 bytes a block, so 256 blocks; every shape gets that count
_HOST_TIER_BLOCKS = 256
_KV_BLOCK_SIZE = 16


def host_tier_bytes(cfg) -> int:
    """Host-arena bytes holding :data:`_HOST_TIER_BLOCKS` KV block
    slabs of ``cfg`` (1 MiB at the default model, as the reference)."""
    import torch
    itemsize = torch.empty((), dtype=cfg.dtype).element_size()
    per_block = (2 * cfg.n_layers * _KV_BLOCK_SIZE * cfg.kv_heads
                 * cfg.d_head * itemsize)
    return _HOST_TIER_BLOCKS * per_block


#: the crucible's LoRA roster (serving_lora/): three adapters with
#: deterministic weights over TWO resident slots per engine, so the
#: soak's adapter traffic churns residency (cold loads + evictions)
#: even before the storm seizes the pool down to one slot
_ADAPTER_RANK = 2
_ADAPTER_SEEDS = {"lora-a": 101, "lora-b": 102, "lora-c": 103}


def _adapter_pool(cfg, device):
    """A fresh per-engine AdapterPool with the full roster registered:
    every engine (and the oracle) sees byte-identical adapter weights
    because the sources are seed-deterministic."""
    from ..serving_lora import (AdapterManifest, AdapterPool,
                                make_adapter)
    pool = AdapterPool(cfg, _ADAPTER_RANK, n_resident=2, device=device)
    for name, seed in _ADAPTER_SEEDS.items():
        pool.register(AdapterManifest(
            name, _ADAPTER_RANK, tenant="hi",
            source=make_adapter(cfg, _ADAPTER_RANK, seed=seed)))
    return pool


def _oracle(model, device, seed: int, n: int, max_new: int,
            adapter: str | None = None) -> np.ndarray:
    """Single-engine greedy oracle, cached by (model, seed, n, max_new,
    adapter): ddmin re-runs the rig a dozen times and must not
    recompute the reference output per probe run, and two models in
    one process never share an entry.  Adapter'd requests compare
    against a dedicated single-slot engine holding ONLY that adapter
    (the per-adapter oracle)."""
    import torch
    cfg, params = model
    _, cache = _ORACLES.setdefault(id(params), (params, {}))
    key = (seed, n, max_new, adapter)
    if key not in cache:
        prompt = prompt_tokens(seed, n, cfg.vocab)
        if adapter is None:
            from ..models import greedy_generate
            from ..utils.device import resolve_device
            out = greedy_generate(
                params, torch.as_tensor(
                    prompt, device=resolve_device(device))[None, :],
                cfg, n_tokens=max_new)
            cache[key] = out[0].cpu().numpy().astype(np.int32)
        else:
            from ..models.serving import Request, ServingEngine
            eng = ServingEngine(params, cfg, slots=1,
                                adapter_pool=_adapter_pool(cfg, device),
                                device=device)
            eng.submit(Request(uid="oracle", prompt=prompt,
                               max_new=max_new, adapter=adapter))
            done = None
            while done is None:
                for f in eng.step():
                    done = f
            cache[key] = np.asarray(done.tokens, np.int32)
    return cache[key]


class Clock:
    """The co-loop's virtual clock: one unit per cycle, injected into
    the gateway and the reconciler so SLO math and cascade windows
    are cycle-deterministic, never wall-clock."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float = 1.0) -> None:
        self.t += dt


# -- the schedule ------------------------------------------------------


@dataclasses.dataclass
class FaultEvent:
    """One scheduled fault (or load burst).

    Fires once, at the first cycle ``>= at_cycle`` — or, when
    ``window`` is set instead, at the first cycle ``>= after_cycle``
    where an open recovery window matches the ``window`` glob (which
    makes the event an overlap hit BY CONSTRUCTION: it cannot fire
    outside the arc it targets).  ``fired_cycle``/``hit_windows`` are
    runtime records; :meth:`fresh` strips them for re-runs.
    """

    id: str
    kind: str
    at_cycle: int | None = None
    window: str | None = None       # glob over open windows
    after_cycle: int = 0            # window events wait at least this
    chip: int | None = None         # chip_kill target
    heal_after: int | None = None   # chip_kill: polls until the heal;
    #                                 kv_exhaust: cycles until release
    gang: str | None = None         # worker_*/corruption target gang
    row: int | None = None          # worker_* target dp row
    replica_glob: str | None = None  # replica_kill name glob
    shard: str | None = None        # corruption: shard-file glob
    #                                 (None = largest shard)
    n: int = 0                      # burst size
    prompt_seed: int = 0            # burst prompt family
    slo_s: float = 900.0            # burst per-request SLO (tight
    #                                 values drive burn-rate alerts)
    adapter: str | None = None      # burst LoRA adapter (None = base)
    fired_cycle: int | None = None
    hit_windows: tuple = ()

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {self.kind!r}; "
                             f"one of {EVENT_KINDS}")
        if self.at_cycle is None and self.window is None:
            raise ValueError(f"event {self.id}: needs at_cycle or "
                             f"window")

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["hit_windows"] = list(self.hit_windows)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "FaultEvent":
        d = dict(d)
        d["hit_windows"] = tuple(d.get("hit_windows", ()))
        return cls(**d)

    def fresh(self) -> "FaultEvent":
        """A copy with the runtime firing record cleared."""
        d = self.to_json()
        d["fired_cycle"] = None
        d["hit_windows"] = []
        return FaultEvent.from_json(d)


@dataclasses.dataclass
class Schedule:
    """A seeded, replayable fault schedule: the crucible's entire
    input.  ``seed`` feeds every RNG in the rig (EventBus, fault
    plans); ``cycles`` is the injection phase length (the drain phase
    that follows injects nothing)."""

    seed: int
    cycles: int
    events: list

    def to_json(self) -> dict:
        return {"seed": self.seed, "cycles": self.cycles,
                "events": [e.to_json() for e in self.events]}

    @classmethod
    def from_json(cls, data: dict | str) -> "Schedule":
        if isinstance(data, str):
            data = json.loads(data)
        return cls(seed=int(data["seed"]), cycles=int(data["cycles"]),
                   events=[FaultEvent.from_json(e)
                           for e in data.get("events", [])])

    def fresh(self) -> "Schedule":
        return Schedule(seed=self.seed, cycles=self.cycles,
                        events=[e.fresh() for e in self.events])


def default_schedule(seed: int = 7, cycles: int = 220) -> Schedule:
    """The canonical compound-fault composition: every fault kind,
    with the second faults aimed (by window trigger) into the first
    faults' recovery arcs.  Offsets scale with ``cycles`` so short
    probe runs and the full soak share one shape; ``cycles`` below
    ~60 leaves too little room between arcs to be interesting."""
    rng = random.Random(seed)
    u = max(cycles // 11, 5)        # one "act" of the run
    ps = lambda: rng.randrange(10_000)
    events = [
        # act 1: warm the serving pool so handoff windows exist; a
        # LoRA wave right behind it makes an adapter resident, so the
        # later storm has something real to evict
        FaultEvent(id="warm-burst", kind="burst", at_cycle=1,
                   n=6, prompt_seed=ps()),
        FaultEvent(id="adapter-warm-burst", kind="burst", at_cycle=3,
                   n=4, prompt_seed=ps(), adapter="lora-a"),
        # act 2: chip death evicts a mid-gang worker; a SECOND chip
        # dies inside the resulting REFORM window (the classic
        # chip-death-mid-REFORM double fault)
        FaultEvent(id="mid-chip3", kind="chip_kill", at_cycle=u,
                   chip=3, heal_after=2 * u),
        FaultEvent(id="mid-chip4-in-reform", kind="chip_kill",
                   window="reform:mid", after_cycle=u, chip=4,
                   heal_after=2 * u),
        # act 3: sustained pressure on hi — three back-to-back waves
        # hold the queue above MtConfig.queue_high across consecutive
        # reconciler ticks (one wave drains before up_after trips),
        # forcing the preemption cascade (park lo, shrink mid, grants
        # onto freed chips)
        FaultEvent(id="pressure-burst", kind="burst",
                   at_cycle=3 * u, n=12, prompt_seed=ps()),
        FaultEvent(id="pressure-burst-2", kind="burst",
                   at_cycle=3 * u + 1, n=12, prompt_seed=ps()),
        FaultEvent(id="pressure-burst-3", kind="burst",
                   at_cycle=3 * u + 2, n=12, prompt_seed=ps()),
        # ...and the decode pool's KV blocks are seized at the crest
        # of the wave (fleet-wide memory pressure: fills hold at the
        # gateway, in-flight rows stay byte-exact, release recovers)
        FaultEvent(id="kv-exhaust-in-pressure", kind="kv_exhaust",
                   at_cycle=3 * u + 3, replica_glob="d*",
                   heal_after=3),
        # ...and a demoted KV slab is silently bit-flipped at the
        # crest (the pressure bursts just demoted the warm bursts'
        # prefixes host-ward): the next same-prefix hit must catch
        # the damage at promote time and recompute byte-exact
        FaultEvent(id="tier-corrupt-in-pressure", kind="tier_corrupt",
                   at_cycle=3 * u + 2, replica_glob="d*"),
        # ...and a decode replica is killed while prefill->decode
        # handoffs are in flight (drain-mid-KV-handoff)
        FaultEvent(id="decode-kill-in-handoff", kind="replica_kill",
                   window="handoff:hi", after_cycle=3 * u + 2,
                   replica_glob="d*"),
        # ...and a gateway pump is killed at the crest of the same
        # wave.  On this soak's IN-PROCESS gateway the event is a
        # logged no-op by design (no pump_plan); a multi-process
        # gateway under the same schedule loses a real OS process
        # here
        FaultEvent(id="pump-kill-in-pressure", kind="pump_kill",
                   at_cycle=3 * u + 4, replica_glob="pump*"),
        # ...and a chip dies MID-CASCADE; its later heal lands while
        # grants/fences from the cascade are still live
        # (heal-mid-cascade)
        FaultEvent(id="chip0-in-cascade", kind="chip_kill",
                   window="cascade", after_cycle=3 * u, chip=0,
                   heal_after=u),
        # ...and a chip dies while lo is PARKED with nobody polling
        # it, so the eventual unpark resize must re-poll or form over
        # a corpse (resize-while-PARKED)
        FaultEvent(id="chip1-while-parked", kind="chip_kill",
                   window="parked:lo", after_cycle=3 * u, chip=1,
                   heal_after=u),
        # act 3.5: the decode pool's adapter slots are seized down to
        # one (every cold adapter evicted), and a DIFFERENT adapter's
        # burst lands inside the starvation window — its fills must
        # serialize through the surviving slot or hold at prefill,
        # then cold-load back byte-exact once the storm lifts
        FaultEvent(id="adapter-storm", kind="adapter_evict_storm",
                   at_cycle=5 * u, replica_glob="d*", heal_after=3),
        FaultEvent(id="adapter-burst-in-storm", kind="burst",
                   window="adapter_pressure:hi", after_cycle=5 * u,
                   n=4, prompt_seed=ps(), adapter="lora-b"),
        # act 4: in-band gang faults on their own arcs
        FaultEvent(id="mid-crash-w1", kind="worker_crash",
                   at_cycle=6 * u, gang="mid", row=1),
        FaultEvent(id="mid-hang-w0", kind="worker_hang",
                   at_cycle=7 * u, gang="mid", row=0),
        # ...a crash aimed into lo's unpark/EXPAND recovery window.
        # Row 1 only exists at dp>=2, so the armed rule waits out any
        # dp=1 interlude and fires on the regrown formation's first
        # steps — a shrink lo can survive, never a full wipeout.
        FaultEvent(id="lo-crash-in-reform", kind="worker_crash",
                   window="reform:lo", after_cycle=4 * u, gang="lo",
                   row=1),
        # act 5: checkpoint corruption aimed into recovery arcs — the
        # generation a recovery is ABOUT to restore gets damaged, so
        # verify-on-restore must detect it and fall back (never a
        # silent wrong-weights resume)
        FaultEvent(id="lo-shard-bitflip-parked", kind="shard_bitflip",
                   window="parked:lo", after_cycle=3 * u, gang="lo"),
        FaultEvent(id="mid-shard-truncate-reform",
                   kind="shard_truncate", window="reform:mid",
                   after_cycle=6 * u, gang="mid"),
        # ...a worker dies mid-streaming-restore (the restore: window
        # opens at the RESUME transition and stays sticky across the
        # first post-restore steps)
        FaultEvent(id="mid-crash-in-restore", kind="worker_crash",
                   window="restore:mid", after_cycle=6 * u,
                   gang="mid", row=1),
        # ...and a crash between shard writes and manifest commit
        # (replayed as its on-disk aftermath: manifest gone)
        FaultEvent(id="mid-gen-tear", kind="gen_tear",
                   at_cycle=7 * u + 2, gang="mid"),
        # act 6: a tail burst exercises granted replicas + regrow
        # contention on the way back to steady state
        FaultEvent(id="tail-burst", kind="burst", at_cycle=8 * u,
                   n=8, prompt_seed=ps()),
    ]
    return Schedule(seed=seed, cycles=cycles, events=events)


# -- the rig -----------------------------------------------------------


@dataclasses.dataclass
class CrucibleResult:
    """One soak's verdict + evidence summary."""

    cycles: int
    survived_cycles: int        # cycles before the first violation
    violations: list            # (cycle, [messages]); cycle -1 = end
    overlap_hits: int           # non-burst faults fired in a window
    fault_kinds_fired: list
    compound_mttr_ms: float     # mean gang recovery MTTR
    submitted: int
    finished: int
    operator_repairs: int
    gang_failures: list

    def ok(self) -> bool:
        return not self.violations and not self.gang_failures


class CrucibleRig:
    """The full stack under one co-loop (module docstring).

    8-chip board, carved exactly full: gang ``lo`` on {0,1} (dp=2),
    gang ``mid`` on {2,3,4,5} (dp=4), serving tenant ``hi`` runs a
    disaggregated pool with prefill p0 on 6 and decode d1 on 7.
    Specs hi(prio 3, quota 6, floor 2) / mid(2, 4, 2) / lo(1, 2, 0)
    give the tenancy cascade's shape, so pressure bursts park lo and
    shrink mid: the arcs the window-triggered faults aim into.  ``hi``
    has the highest priority, so the serving tenant is never a reclaim
    victim.  ``model``, ``gang_cfg`` and ``device``: module docstring.
    """

    GANGS = (("lo", dict(dp=2, batch=4, chips=(0, 1))),
             ("mid", dict(dp=4, batch=8, chips=(2, 3, 4, 5))))

    def __init__(self, schedule: Schedule, workdir,
                 *, dump_dir=None, step_deadline_s: float = 5.0,
                 hang_stall_s: float = 20.0,
                 kv_layout: str = "paged",
                 draft_source: str | None = None,
                 draft_len: int = 3,
                 model: tuple | None = None, gang_cfg=None,
                 device="cuda"):
        from ..utils.device import resolve_device
        self.schedule = schedule
        self.device = resolve_device(device)
        self.model = model if model is not None else \
            default_model(self.device)
        self.cfg, self.params = self.model
        self.gang_cfg = gang_cfg if gang_cfg is not None else self.cfg
        # serving engines run the paged KV layout by default so
        # kv_exhaust waves starve a REAL block ledger; "contiguous"
        # opts back into the dense-slab fleet (byte-equal either way)
        self.kv_layout = kv_layout
        # draft_source="ngram" runs the fleet speculatively (the
        # model-free source composes with paged KV and block
        # adoption); every burst is greedy, so the oracles need no
        # change — speculation is byte-exact by construction
        self.draft_source = draft_source
        self.draft_len = draft_len
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.dump_dir = dump_dir
        self.step_deadline_s = step_deadline_s
        # the scripted wedge outlives the watchdog deadline (the
        # eviction's abort event releases it) but never a warmed-up
        # first-step allowance, so a hang landing during compile
        # warmup degrades to one slow step instead of a stuck soak
        self.hang_stall_s = hang_stall_s
        self.clock = Clock()
        self.cycle = 0
        self.violations: list = []
        self.gang_failures: list = []
        self.operator_repairs = 0
        self.submitted: dict = {}     # uid -> (seed, n, max_new)
        self._win_hist: deque = deque(maxlen=4)   # 2 cycles x 2 samples
        # gang -> clock time of its last RESUME transition (opens the
        # restore:<gang> window); gang -> {tampered step -> recovery
        # count at tampering time} (the untainted_restores
        # invariant's ground truth)
        self._resume_at: dict = {}
        self.tampered: dict = {}
        # replica name -> cycle at which its seized KV blocks release
        self._kv_seized: dict = {}
        self.kv_seizures = 0
        # replica name -> cycle at which its adapter-pool storm lifts
        self._adapter_seized: dict = {}
        self.adapter_storms = 0
        # demoted KV slabs bit-flipped (serving_kv/tiers.py) — the
        # detection oracle: every one must surface as a
        # corrupt_fallback counter bump, never as wrong tokens
        self.tier_corruptions = 0
        self._build()

    # -- construction ----------------------------------------------------

    def _build(self) -> None:
        from ..fleet.binpack import TopologyBinPacker
        from ..fleet.supply import ChipLedger
        from ..fleet.tenancy import (MtConfig, MultiTenantReconciler,
                                     ServingTenant, TenantRegistry,
                                     TenantSpec, TrainingTenant)
        from ..gateway.sharded import ShardedGateway
        from ..models.serving import ServingEngine
        from ..parallel.resharding import ShardedCheckpointer
        from ..parallel.supervisor import (ElasticTrainJob,
                                           GangSupervisor)
        from ..serving_disagg import DisaggReplicaManager, DisaggRouter
        from ..utils.tracing import Tracer, attach_supervisor
        from .bus import EventBus
        from .flightrec import FlightRecorder

        seed = self.schedule.seed
        self.chip_plan = FaultPlan(seed=seed)
        self.replica_plan = FaultPlan(seed=seed + 1)
        self.gang_plans = {name: FaultPlan(seed=10 * seed + i + 2)
                           for i, (name, _) in enumerate(self.GANGS)}
        self.bus = EventBus(seed=seed)
        self.tracer = Tracer(bus=self.bus, clock=self.clock)
        self.ledger = ChipLedger(
            range(8), health_source=ScriptedChipHealth(
                self.chip_plan, chips=range(8)))

        self.sups = {}
        # gangs run the sharded, checksummed format — the corruption
        # events need real shard files + manifests to damage, and the
        # soak proves the whole fleet survives on verify-on-restore
        self._ckpts = {}
        motif = np.random.default_rng(seed).integers(
            0, self.gang_cfg.vocab, 32)
        for name, spec in self.GANGS:
            job = ElasticTrainJob(self.gang_cfg, np.tile(motif, 64),
                                  batch=spec["batch"], seq_len=16,
                                  tp=1, device=self.device)
            ckpt = ShardedCheckpointer(self.workdir / f"ckpt-{name}")
            self._ckpts[name] = ckpt
            self.sups[name] = GangSupervisor(
                job, ckpt,
                coordination_dir=self.workdir / f"coord-{name}",
                dp=spec["dp"], checkpoint_every=2,
                step_deadline_s=self.step_deadline_s,
                first_step_deadline_s=600.0, max_recoveries=8,
                fault_plan=self.gang_plans[name],
                health_source=self.ledger.current_unhealthy,
                placement_exclude=[c for c in range(8)
                                   if c not in spec["chips"]])

        chip_map = {"p0": 6, "d1": 7}
        # every engine (prefill validators included) carries its own
        # AdapterPool over the shared seed-deterministic roster, so
        # adapter'd bursts survive grants, drains and handoffs with
        # byte-identical weights everywhere
        # paged engines carry a host tier (serving_kv/tiers.py) so
        # pressure waves DEMOTE instead of dropping and tier_corrupt
        # has a real slab to damage; the arena holds 256 block slabs
        # of the model (1 MiB at the default model), the whole store
        # many times over (no disk tier in the soak: a spill dir per
        # replica would outlive the rig's tmpdir wipes)
        tier_kw = ({"kv_host_bytes": host_tier_bytes(self.cfg)}
                   if self.kv_layout == "paged" else {})
        self.mgr = DisaggReplicaManager(
            lambda name: ServingEngine(
                self.params, self.cfg, slots=2, prefix_cache=2,
                kv_layout=self.kv_layout, kv_block_size=_KV_BLOCK_SIZE,
                draft_source=self.draft_source,
                draft_len=self.draft_len,
                adapter_pool=_adapter_pool(self.cfg, self.device),
                device=self.device, **tier_kw),
            prefill_replicas=1, decode_replicas=1,
            chip_of=chip_map.get,
            health_source=self.ledger.current_unhealthy,
            fault_plan=self.replica_plan, depth_bound=2)
        # burn-rate alerting is ALWAYS-ON in the crucible (the soak
        # must prove alerting rides along at zero invariant cost);
        # clock.t-based windows stay deterministic under the seeded
        # schedule, and the tracer hookup routes a firing alert into
        # the flight recorder's "alert" trigger
        from ..gateway.burnrate import SloBurnEngine
        self.burn = SloBurnEngine(bus=self.bus, tracer=self.tracer,
                                  clock=self.clock)
        self.gw = ShardedGateway(
            self.mgr, pumps=2,
            router_factory=lambda: DisaggRouter(self.mgr.index),
            queue_capacity=64, clock=self.clock, bus=self.bus,
            auto_replace=False, seed=seed, tenant="hi",
            tracer=self.tracer, burn=self.burn)

        registry = TenantRegistry(capacity=8)
        registry.add(TenantSpec("hi", priority=3, quota=6, floor=2),
                     ServingTenant(self.gw))
        registry.add(TenantSpec("mid", priority=2, quota=4, floor=2),
                     TrainingTenant(self.sups["mid"], target_dp=4))
        registry.add(TenantSpec("lo", priority=1, quota=2, floor=0),
                     TrainingTenant(self.sups["lo"], target_dp=2))
        self.registry = registry
        self.rec = MultiTenantReconciler(
            registry, ledger=self.ledger,
            packer=TopologyBinPacker(self.ledger, domain_size=2),
            config=MtConfig(queue_high=4, up_after=2, down_after=3,
                            regrow_after=3, arrival_low_rps=0.5),
            clock=self.clock, bus=self.bus, tracer=self.tracer)
        self.flightrec = FlightRecorder(
            self.tracer, bus=self.bus,
            metrics=(self.gw.metrics, self.rec.metrics),
            dump_dir=self.dump_dir)
        for name, sup in self.sups.items():
            attach_supervisor(self.tracer, sup, name=f"gang-{name}")
            sup.listeners.append(self._mk_resume_listener(name))
            sup.begin(10_000)       # never completes within a soak
        self.live = {name: True for name in self.sups}

    def _mk_resume_listener(self, name: str):
        def on_state(state, info):
            if state == "resume":
                self._resume_at[name] = self.clock.t
        return on_state

    def close(self) -> None:
        for ckpt in self._ckpts.values():
            ckpt.close()

    # -- windows ---------------------------------------------------------

    def _sample_windows(self) -> None:
        """One instantaneous observation of every open recovery-arc
        window.  Sampled twice per cycle (pre- and post-reconcile:
        dead replicas are reaped AT the tick, so drain windows are
        only visible before it) and kept sticky over the last two
        cycles, because an arc that was open a moment ago is still
        the arc a second fault lands in."""
        from ..serving_disagg import PrefillReplica
        w = set()
        for name, sup in self.sups.items():
            # _pending spans REFORM/EXPAND until the first completed
            # post-restore step — the recovery window proper
            if getattr(sup, "_pending", None) is not None:
                w.add(f"reform:{name}")
            if sup._requested is not None:
                w.add(f"resize_queued:{name}")
            if sup.state == "parked":
                w.add(f"parked:{name}")
            # restore:<gang> — open from the RESUME transition through
            # the first post-restore steps (the streaming-restore
            # span, where a worker death or corruption lands hardest)
            if self.clock.t - self._resume_at.get(name,
                                                  float("-inf")) <= 2.0:
                w.add(f"restore:{name}")
        for r in self.mgr.replicas:
            if r.state == "dead":
                w.add("drain:hi")
            elif isinstance(r, PrefillReplica) and (r.blocks
                                                   or r.pending):
                w.add("handoff:hi")
        horizon = self.clock.t - CASCADE_WINDOW_S
        if any(t >= horizon and k in CASCADE_KINDS
               for t, k, _ in self.rec.events):
            w.add("cascade")
        if self._kv_seized:
            w.add("kv_pressure:hi")
        if self._adapter_seized:
            w.add("adapter_pressure:hi")
        self._win_hist.append(frozenset(w))

    def _sticky_windows(self) -> set:
        out: set = set()
        for s in self._win_hist:
            out |= s
        return out

    # -- event firing ----------------------------------------------------

    def _due(self, ev: FaultEvent, cycle: int) -> bool:
        if ev.fired_cycle is not None:
            return False
        if ev.at_cycle is not None:
            return cycle >= ev.at_cycle
        if cycle < ev.after_cycle:
            return False
        return any(fnmatch.fnmatchcase(w, ev.window)
                   for w in self._sticky_windows())

    def _fire(self, ev: FaultEvent, cycle: int) -> None:
        ev.fired_cycle = cycle
        ev.hit_windows = tuple(sorted(self._sticky_windows()))
        log.info("crucible: firing %s (%s) at cycle %d, windows %s",
                 ev.id, ev.kind, cycle, list(ev.hit_windows))
        if ev.kind == "chip_kill":
            rules = [FaultRule(verb=HEALTH_VERB, kind=CHIP_KIND,
                               name=str(ev.chip), times=1,
                               error="drop")]
            if ev.heal_after:
                rules.append(FaultRule(
                    verb=HEALTH_VERB, kind=CHIP_KIND,
                    name=str(ev.chip), skip=ev.heal_after, times=1,
                    error=HEAL))
            self.chip_plan.arm(*rules)
        elif ev.kind == "worker_crash":
            # g*w<row> matches the row across formation generations
            self.gang_plans[ev.gang].arm(FaultRule(
                verb=GANG_VERB, kind=GANG_WORKER_KIND,
                name=f"g*w{ev.row}", times=1, error="crash"))
        elif ev.kind == "worker_hang":
            self.gang_plans[ev.gang].arm(FaultRule(
                verb=GANG_VERB, kind=GANG_WORKER_KIND,
                name=f"g*w{ev.row}", times=1, error="hang",
                latency_s=self.hang_stall_s))
        elif ev.kind == "replica_kill":
            self.replica_plan.arm(FaultRule(
                verb=HEALTH_VERB, kind="Replica",
                name=ev.replica_glob or "d*", times=1, error="drop"))
        elif ev.kind == "pump_kill":
            # multi-process gateways consult pump_plan once per
            # (pump, cycle); "crash" SIGKILLs the worker subprocess
            plan = getattr(self.gw, "pump_plan", None)
            if plan is None:
                log.info("crucible: %s targets a pump process but the "
                         "gateway is in-process (no pump_plan); no-op",
                         ev.id)
            else:
                plan.arm(FaultRule(
                    verb=PUMP_VERB, kind=PUMP_KIND,
                    name=ev.replica_glob or "pump*", times=1,
                    error="crash"))
        elif ev.kind == "kv_exhaust":
            glob = ev.replica_glob or "*"
            hit = 0
            for r in self.mgr.replicas:
                km = getattr(r.engine, "kv_manager", None)
                if km is None or r.state == "dead":
                    continue
                if not fnmatch.fnmatchcase(r.name, glob):
                    continue
                km.seize_free()
                self._kv_seized[r.name] = cycle + (ev.heal_after or 2)
                hit += 1
            self.kv_seizures += hit
            if not hit:
                log.info("crucible: %s matched no paged replica "
                         "(glob %s, layout %s); no-op", ev.id, glob,
                         self.kv_layout)
        elif ev.kind == "adapter_evict_storm":
            glob = ev.replica_glob or "*"
            hit = 0
            for r in self.mgr.replicas:
                pool = getattr(r.engine, "adapter_pool", None)
                if pool is None or r.state == "dead":
                    continue
                if not fnmatch.fnmatchcase(r.name, glob):
                    continue
                pool.seize_to_one()
                self._adapter_seized[r.name] = (
                    cycle + (ev.heal_after or 2))
                hit += 1
            self.adapter_storms += hit
            if not hit:
                log.info("crucible: %s matched no adapter-pooled "
                         "replica (glob %s); no-op", ev.id, glob)
        elif ev.kind == "tier_corrupt":
            glob = ev.replica_glob or "*"
            hit = 0
            for r in self.mgr.replicas:
                store = getattr(r.engine, "_prefix", None)
                corrupt = getattr(store, "corrupt_slab", None)
                if corrupt is None or r.state == "dead":
                    continue
                if not fnmatch.fnmatchcase(r.name, glob):
                    continue
                # seeded per (schedule, cycle, replica): the soak is
                # replayable bit for bit (crc32, not hash() — str
                # hashing is salted per process)
                rng = random.Random(
                    self.schedule.seed * 1000003 + cycle * 1009
                    + zlib.crc32(r.name.encode()))
                key = corrupt(rng)
                if key is not None:
                    hit += 1
            self.tier_corruptions += hit
            if not hit:
                log.info("crucible: %s found no demoted KV slab to "
                         "corrupt (glob %s, layout %s); no-op",
                         ev.id, glob, self.kv_layout)
        elif ev.kind in CORRUPTION_KINDS:
            self._corrupt(ev)
        elif ev.kind == "burst":
            from ..models.serving import Request
            for i in range(ev.n):
                uid = f"{ev.id}-r{i}"
                n_tok = 4 + (i % 5)
                self.gw.submit(Request(
                    uid=uid, prompt=prompt_tokens(ev.prompt_seed + i,
                                                  n_tok, self.cfg.vocab),
                    max_new=3, adapter=ev.adapter), slo_s=ev.slo_s)
                self.submitted[uid] = (ev.prompt_seed + i, n_tok, 3,
                                       ev.adapter)

    def _corrupt(self, ev: FaultEvent) -> None:
        """Damage the target gang's NEWEST committed generation on
        disk.  ``gen_tear`` deletes the manifest (the on-disk
        aftermath of a crash between shard writes and commit) — the
        step is NOT recorded as tampered, because the supervisor
        legitimately rewrites that now-uncommitted step during
        post-rewind replay.  ``shard_bitflip``/``shard_truncate``
        damage shard bytes under an intact manifest; save() skips
        committed steps, so the damage is permanent and the step
        lands in ``tampered`` (the untainted_restores invariant's
        ground truth) together with the gang's recovery count at
        tampering time — earlier recoveries read the bytes while
        they were still good, only a LATER restore of this step
        proves detection failed."""
        from ..parallel import resharding
        from .faults import (CORRUPT_BITFLIP, CORRUPT_TRUNCATE,
                             corrupt_file)
        ckpt = self._ckpts[ev.gang]
        steps = ckpt.all_steps()
        if not steps:
            log.info("crucible: %s found no committed generation for "
                     "gang %s; no-op", ev.id, ev.gang)
            return
        step = steps[-1]
        sd = ckpt.step_path(step)
        if ev.kind == "gen_tear":
            (sd / resharding.MANIFEST).unlink(missing_ok=True)
            log.info("crucible: tore generation %d of gang %s "
                     "(manifest deleted)", step, ev.gang)
            return
        files = sorted(sd.glob("*.bin"))
        if ev.shard:
            files = [p for p in files
                     if fnmatch.fnmatchcase(p.name, ev.shard)]
        if not files:
            log.info("crucible: %s matched no shard files in step %d "
                     "of gang %s; no-op", ev.id, step, ev.gang)
            return
        target = max(files, key=lambda p: (p.stat().st_size, p.name))
        kind = (CORRUPT_BITFLIP if ev.kind == "shard_bitflip"
                else CORRUPT_TRUNCATE)
        desc = corrupt_file(target, kind, seed=self.schedule.seed)
        self.tampered.setdefault(ev.gang, {})[step] = len(
            self.sups[ev.gang].recoveries)
        log.info("crucible: %s on gang %s step %d: %s", ev.id,
                 ev.gang, step, desc)

    # -- the co-loop -----------------------------------------------------

    def run_cycle(self, inject: bool = True) -> list:
        """One full co-loop cycle: fire due events, step the gateway,
        every live gang, and the reconciler, then run the per-cycle
        invariant sweep.  Returns this cycle's violations."""
        from ..parallel.supervisor import SupervisorError
        cycle = self.cycle
        # release expired kv_exhaust seizures BEFORE injection, so a
        # schedule can re-seize the same replica in the same cycle; a
        # replica drained/compacted mid-wave took its blocks with it
        for name, until in list(self._kv_seized.items()):
            if cycle < until:
                continue
            del self._kv_seized[name]
            for r in self.mgr.replicas:
                if r.name == name and r.state != "dead":
                    r.engine.kv_manager.release_seized()
                    break
        # same release-before-inject discipline for adapter storms
        for name, until in list(self._adapter_seized.items()):
            if cycle < until:
                continue
            del self._adapter_seized[name]
            for r in self.mgr.replicas:
                if r.name == name and r.state != "dead":
                    r.engine.adapter_pool.release_storm()
                    break
        if inject:
            for ev in self.schedule.events:
                if self._due(ev, cycle):
                    self._fire(ev, cycle)
        self.gw.step()
        for name, sup in self.sups.items():
            if not self.live[name]:
                continue
            try:
                self.live[name] = sup.step_once()
            except SupervisorError as e:
                self.live[name] = False
                self.gang_failures.append(f"{name}: {e}")
        self._sample_windows()          # pre-tick: drains visible
        self.rec.tick()
        self.clock.advance(1.0)
        self._sample_windows()          # post-tick: cascade visible
        v = invariants.check_cycle(
            gateways=[("hi", self.gw)],
            supervisors=list(self.sups.items()),
            ledger=self.ledger, records=self._records(),
            specs=list(self.registry), events=self.rec.events,
            tainted=self.tampered)
        if v:
            self.violations.append((cycle, v))
        self.cycle += 1
        return v

    def _records(self) -> list:
        out = []
        for spec in self.registry:
            w = self.registry.workload(spec.name)
            out.append((spec.name,
                        getattr(w, "manager", None),
                        getattr(w, "supervisor", None)))
        return out

    def drain(self, max_cycles: int = 300) -> bool:
        """Pump injection-free cycles until the gateway is idle (the
        deadline is ``max_cycles`` — the crucible never waits
        unbounded).  Last-resort operator repair: ddmin probes run
        arbitrary event SUBSETS, and a subset can orphan the pool
        (decode capacity dead, queue too shallow to trip the
        pressure-grant path); after a stall with zero ready decode
        replicas, one replica is added on a free healthy chip so
        every probe run terminates and gets judged on its invariants.
        Repairs are counted — a default-schedule run needs none."""
        stall = 0
        last_terminal = -1
        for _ in range(max_cycles):
            if (self.gw.pending() == 0
                    and not any(r.in_flight
                                for r in self.mgr.replicas)):
                return True
            self.run_cycle(inject=False)
            terminal = len(self.gw.outcomes) + len(self.gw.refused)
            stall = 0 if terminal != last_terminal else stall + 1
            last_terminal = terminal
            if stall >= 25:
                stall = 0
                ready_decode = [
                    r for r in self.mgr.replicas
                    if r.ready and r.role in ("decode", "unified")]
                free = self.ledger.healthy_free()
                if not ready_decode and free:
                    self.mgr.add_replica(chip=free[-1])
                    self.operator_repairs += 1
                    log.warning("crucible: operator repair — decode "
                                "replica added on chip %d", free[-1])
        return False

    # -- verdicts --------------------------------------------------------

    def final_violations(self) -> list:
        """End-of-run checkers: exactly-once terminal outcomes over
        every submitted uid, byte-equality of every finished result
        against its single-engine oracle, and the full-run loss
        trajectory of both gangs."""
        out = invariants.exactly_once_terminal(
            self.gw, list(self.submitted))
        oracles = {}
        for uid, (seed, n, max_new, adapter) in self.submitted.items():
            g = self.gw.outcomes.get(uid)
            if g is not None and g.status == "finished":
                oracles[uid] = _oracle(self.model, self.device, seed, n,
                                       max_new, adapter)
        out += invariants.byte_equal(self.gw.results, oracles)
        for name, sup in self.sups.items():
            out += [f"[{name}] {v}"
                    for v in invariants.losses_exactly_once(
                        sup.losses, sup.recoveries)]
        return out

    def result(self) -> CrucibleResult:
        fired = [e for e in self.schedule.events
                 if e.fired_cycle is not None]
        mttrs = [r.mttr_s for sup in self.sups.values()
                 for r in sup.recoveries
                 if getattr(r, "mttr_s", -1.0) >= 0.0]
        first_bad = self.violations[0][0] if self.violations else None
        finished = sum(
            1 for uid in self.submitted
            if (g := self.gw.outcomes.get(uid)) is not None
            and g.status == "finished")
        return CrucibleResult(
            cycles=self.cycle,
            survived_cycles=(self.cycle if first_bad is None
                             else max(first_bad, 0)),
            violations=list(self.violations),
            overlap_hits=sum(1 for e in fired
                             if e.kind != "burst" and e.hit_windows),
            fault_kinds_fired=sorted({e.kind for e in fired}),
            compound_mttr_ms=(sum(mttrs) / len(mttrs) * 1000.0
                              if mttrs else 0.0),
            submitted=len(self.submitted), finished=finished,
            operator_repairs=self.operator_repairs,
            gang_failures=list(self.gang_failures))


def run_soak(schedule: Schedule, workdir, *, dump_dir=None,
             drain_cycles: int = 300, draft_source: str | None = None,
             draft_len: int = 3, model: tuple | None = None,
             gang_cfg=None, device="cuda"):
    """One full soak: injection phase (``schedule.cycles`` co-loop
    cycles), drain phase, end-of-run checkers.  Returns ``(result,
    rig)`` — the rig is closed but readable, so callers can inspect
    recoveries, events, and flight-recorder dumps.  ``draft_source``
    runs the serving fleet speculatively; ``model``, ``gang_cfg`` and
    ``device`` go to :class:`CrucibleRig`."""
    rig = CrucibleRig(schedule, workdir, dump_dir=dump_dir,
                      draft_source=draft_source, draft_len=draft_len,
                      model=model, gang_cfg=gang_cfg, device=device)
    try:
        for _ in range(schedule.cycles):
            rig.run_cycle()
        if not rig.drain(max_cycles=drain_cycles):
            rig.violations.append(
                (-1, [f"gateway not idle after {drain_cycles} drain "
                      f"cycles: {rig.gw.pending()} queued, "
                      f"{sum(len(r.in_flight) for r in rig.mgr.replicas)}"
                      f" in flight"]))
        end = rig.final_violations()
        if end:
            rig.violations.append((-1, end))
        if rig.violations and rig.dump_dir is not None:
            # a failing run with a dump dir ALWAYS ships forensics,
            # even when no individual span tripped a trigger
            rig.flightrec.record("failed")
        return rig.result(), rig
    finally:
        rig.close()


# -- schedule minimization (ddmin) -------------------------------------


def minimize(schedule: Schedule, workdir, *, max_runs: int = 16,
             check=None, soak=None, **rig_kw):
    """Delta-debug (Zeller's ddmin, complement-reduction form) the
    schedule's event list down to a minimal set that still fails.
    ``check(result) -> bool`` decides failure (default: any invariant
    violation).  ``max_runs`` bounds the probe budget — each probe is
    a full soak in a fresh workdir subdirectory.  ``soak(schedule,
    workdir, **kw) -> (result, rig)`` swaps the rig the probes run
    against (default :func:`run_soak` with ``rig_kw``, the live 8-chip
    crucible; a fleet simulator passes its own soak so the SAME ddmin
    minimizes its pathologies).  Returns ``(minimized_schedule,
    runs_used)``; the caller re-runs the minimized schedule to capture
    its violation log for the repro."""
    check = check or (lambda res: bool(res.violations))
    soak = soak or functools.partial(run_soak, **rig_kw)
    workdir = Path(workdir)
    events = [e.fresh() for e in schedule.events]
    runs = 0

    def failing(subset) -> bool:
        nonlocal runs
        runs += 1
        sub = Schedule(seed=schedule.seed, cycles=schedule.cycles,
                       events=[e.fresh() for e in subset])
        res, _ = soak(sub, workdir / f"probe-{runs:03d}")
        log.info("ddmin probe %d: %d event(s) -> %s", runs,
                 len(subset), "FAIL" if check(res) else "pass")
        return check(res)

    n = 2
    while len(events) >= 2 and runs < max_runs:
        size = math.ceil(len(events) / n)
        chunks = [events[i:i + size]
                  for i in range(0, len(events), size)]
        reduced = False
        for i in range(len(chunks)):
            if runs >= max_runs:
                break
            complement = [e for j, ch in enumerate(chunks)
                          if j != i for e in ch]
            if complement and failing(complement):
                events = complement
                n = max(n - 1, 2)
                reduced = True
                break
        if not reduced:
            if n >= len(events):
                break
            n = min(n * 2, len(events))
    return (Schedule(seed=schedule.seed, cycles=schedule.cycles,
                     events=[e.fresh() for e in events]), runs)


# -- repro files -------------------------------------------------------


def write_repro(path, schedule: Schedule,
                result: CrucibleResult) -> Path:
    """Persist a replayable repro: the (minimized) schedule plus the
    violation log it produced.  JSON, sorted keys — diffs of two
    repro files are meaningful."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {
        "format": REPRO_FORMAT,
        "schedule": schedule.to_json(),
        "violations": [[c, list(v)] for c, v in result.violations],
        "first_violation_cycle": (result.violations[0][0]
                                  if result.violations else None),
        "fault_kinds_fired": result.fault_kinds_fired,
        "overlap_hits": result.overlap_hits,
    }
    path.write_text(json.dumps(payload, indent=1, sort_keys=True))
    return path


def replay(path, workdir, *, dump_dir=None, drain_cycles: int = 300,
           soak=None, **rig_kw):
    """Re-run a repro file.  ``dump_dir`` hands the flight recorder a
    directory, so the confirming run ships forensic dumps next to the
    repro.  ``soak`` swaps the rig (see :func:`minimize`); otherwise
    ``rig_kw`` go to :func:`run_soak`.  Returns ``(result, rig)``."""
    payload = json.loads(Path(path).read_text())
    if payload.get("format") != REPRO_FORMAT:
        raise ValueError(
            f"not a crucible repro (format={payload.get('format')!r},"
            f" want {REPRO_FORMAT!r})")
    # the repro records fired_cycle/hit_windows as evidence of where
    # each event landed; fresh() strips that runtime state, else
    # _due() would see every event as already fired and replay a
    # fault-free run
    sched = Schedule.from_json(payload["schedule"]).fresh()
    soak = soak or functools.partial(run_soak, **rig_kw)
    return soak(sched, workdir, dump_dir=dump_dir,
                drain_cycles=drain_cycles)


def investigate(schedule: Schedule, workdir, *,
                max_runs: int = 16, soak=None, **rig_kw) -> dict:
    """The whole violation workflow in one call: soak; on violation,
    ddmin-minimize the schedule, write ``repro.json``, and REPLAY it
    (flight recorder dumping alongside) to confirm the repro fails
    deterministically.  Returns a dict with the soak ``result`` and —
    when a violation was found — ``minimized`` (Schedule), ``repro``
    (path), ``confirm_result``, and ``confirmed`` (bool).  ``soak``
    and ``rig_kw``: see :func:`minimize`."""
    workdir = Path(workdir)
    soak = soak or functools.partial(run_soak, **rig_kw)
    res, _rig = soak(schedule, workdir / "soak")
    out = {"result": res, "minimized": None, "repro": None,
           "confirm_result": None, "confirmed": None}
    if not res.violations:
        return out
    minimized, _runs = minimize(schedule, workdir / "ddmin",
                                max_runs=max_runs, soak=soak)
    min_res, _ = soak(minimized, workdir / "minimized")
    if not min_res.violations:
        # the budget ran out mid-reduction on a flaky boundary; the
        # full schedule is the (non-minimal but honest) repro
        minimized, min_res = schedule.fresh(), res
    repro = write_repro(workdir / "repro.json", minimized, min_res)
    confirm_res, _ = replay(repro, workdir / "confirm",
                            dump_dir=workdir / "confirm" / "flightrec",
                            soak=soak)
    out.update(minimized=minimized, repro=repro,
               confirm_result=confirm_res,
               confirmed=bool(confirm_res.violations))
    return out


__all__ = ["CASCADE_KINDS", "CORRUPTION_KINDS", "Clock",
           "CrucibleResult", "CrucibleRig",
           "EVENT_KINDS", "FAULT_KIND_REGISTRY", "FaultEvent",
           "REPRO_FORMAT", "Schedule", "default_model",
           "default_schedule", "host_tier_bytes", "prompt_tokens",
           "investigate", "minimize", "register_fault_kind", "replay",
           "run_soak", "write_repro"]
