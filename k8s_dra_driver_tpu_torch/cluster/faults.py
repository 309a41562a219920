"""Deterministic fault injection.

The port's copy of ``k8s_dra_driver_tpu/cluster/faults.py``:
``FaultRule``, ``Decision`` and ``FaultPlan`` with the plan's JSON form
and ``raise_for``; ``FaultyClusterClient``, which executes a plan in
front of any ``ClusterClient`` (cluster/client.py); the target names of
the gang-worker, chip-health and pump-kill faults;
``ScriptedChipHealth``, a chip-health source whose decisions latch
until a ``heal``; the process-level crashpoints armed through
``TPU_DRA_FAULT_PLAN``; and ``corrupt_file``, the seeded damage the
crucible (cluster/crucible.py) does to checkpoint shards.  The
environment variable, the plan JSON and the damage are the reference's,
so a plan written by either package loads in the other and
``corrupt_file`` flips the same bit.

Determinism contract: a plan is a pure function of (seed, rules, call
sequence).  Rule matching consumes per-rule counters in call order and
probabilistic rules draw from one seeded RNG, so replaying the same
call sequence against an identical plan yields the identical injection
log.

Plan JSON schema (one rule per dict, evaluated in order, first match
wins)::

    {"seed": 7, "rules": [
      {"verb": "create",        # one of VERBS, a crashpoint name,
                                #   "gang", "health", "pump" or "*"
       "kind": "Pump",          # object kind or "*" (glob ok)
       "name": "pump0",         # object name glob
       "skip": 0,               # let this many matching calls through
       "times": 1,              # then affect this many (-1 = forever)
       "probability": 1.0,      # seeded coin flip per candidate call
       "error": "crash",        # one of ERROR_KINDS
       "retry_after_s": null,   # Retry-After for 429/503 responses
       "latency_s": 0.0}]}      # injected delay before the outcome
"""

from __future__ import annotations

import dataclasses
import fnmatch
import json
import logging
import os
import random
import threading
import time
from pathlib import Path
from typing import Any, Callable

from .client import (ApiServerError, ApiUnavailableError, ClusterClient,
                     ConflictError, NotFoundError, WatchHandler)

log = logging.getLogger(__name__)

#: exit code a scripted crash dies with, distinguishable from real
#: failures in subprocess tests
CRASH_EXIT_CODE = 86

#: verbs a ClusterClient call can carry; crashpoints use free-form
#: names (namespaced like "checkpoint.saved") that never collide
VERBS = ("create", "update", "get", "list", "delete", "watch")

ERROR_KINDS = ("429", "500", "502", "503", "conflict", "notfound",
               "drop", "crash", "hang", "heal", "")

#: gang-worker fault targets (parallel/supervisor.py): one decision per
#: (worker, step), verb "gang", kind "Worker", name = the worker's gang
#: name.  ``error: "crash"`` kills the worker (in-band gang death);
#: ``error: "hang"`` wedges it for ``latency_s`` while its peers block
#: in the collective.
GANG_VERB = "gang"
GANG_WORKER_KIND = "Worker"

#: chip-health fault targets (fleet/supply.py, gateway/replica.py): one
#: decision per (chip, poll), verb "health", kind "Chip", name = the
#: decimal chip index.  A down-kind error (drop/5xx/crash) marks the
#: chip unhealthy until a rule with ``error: "heal"`` clears it.
HEALTH_VERB = "health"
CHIP_KIND = "Chip"
HEAL = "heal"

#: pump-process fault targets (gateway/procpump.py): one decision per
#: (pump, conductor cycle), verb "pump", kind "Pump", name = the pump
#: worker's name.  ``error: "crash"`` makes the conductor SIGKILL the
#: worker subprocess.
PUMP_VERB = "pump"
PUMP_KIND = "Pump"

#: injection-log cap: plans live for one scenario; a runaway loop must
#: not turn the log into the run's memory hog
_LOG_CAP = 10000


@dataclasses.dataclass
class FaultRule:
    verb: str = "*"
    kind: str = "*"
    name: str = "*"
    skip: int = 0
    times: int = 1
    probability: float = 1.0
    error: str = ""
    retry_after_s: float | None = None
    latency_s: float = 0.0

    def __post_init__(self):
        if self.error not in ERROR_KINDS:
            raise ValueError(
                f"unknown fault error {self.error!r}; one of {ERROR_KINDS}")
        # per-rule match counter (calls that matched verb/kind/name,
        # before the skip/times window is applied)
        self.seen = 0

    def matches(self, verb: str, kind: str, name: str) -> bool:
        return (fnmatch.fnmatchcase(verb, self.verb)
                and fnmatch.fnmatchcase(kind, self.kind)
                and fnmatch.fnmatchcase(name, self.name))

    def to_json(self) -> dict:
        return {k: getattr(self, k) for k in (
            "verb", "kind", "name", "skip", "times", "probability",
            "error", "retry_after_s", "latency_s")}


@dataclasses.dataclass
class Decision:
    """What to do to one call (returned by ``FaultPlan.decide``)."""

    error: str
    retry_after_s: float | None = None
    latency_s: float = 0.0
    rule_index: int = -1


class FaultPlan:
    """Ordered fault rules + one seeded RNG + an injection log."""

    def __init__(self, rules: list[FaultRule] | None = None, seed: int = 0):
        self.rules = list(rules or [])
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        # (verb, kind, name, outcome) per call, in decision order
        self.log: list[tuple[str, str, str, str]] = []

    @classmethod
    def from_json(cls, data: dict | str) -> "FaultPlan":
        if isinstance(data, str):
            data = json.loads(data)
        rules = [FaultRule(**r) for r in data.get("rules", [])]
        return cls(rules, seed=data.get("seed", 0))

    def to_json(self) -> dict:
        return {"seed": self.seed,
                "rules": [r.to_json() for r in self.rules]}

    def arm(self, *rules: FaultRule) -> None:
        """Append rules to a LIVE plan, serialized with ``decide``;
        every existing rule's ``seen`` counter is untouched."""
        with self._lock:
            self.rules.extend(rules)

    def decide(self, verb: str, kind: str = "",
               name: str = "") -> Decision | None:
        """First matching rule wins; ``None`` means pass through.
        Counters and RNG draws advance under one lock so concurrent
        callers serialize into a single deterministic decision order."""
        with self._lock:
            decision = None
            for idx, rule in enumerate(self.rules):
                if not rule.matches(verb, kind, name):
                    continue
                rule.seen += 1
                if rule.seen <= rule.skip:
                    continue
                if rule.times >= 0 and rule.seen - rule.skip > rule.times:
                    continue
                if rule.probability < 1.0 and \
                        self._rng.random() >= rule.probability:
                    continue
                decision = Decision(
                    error=rule.error, retry_after_s=rule.retry_after_s,
                    latency_s=rule.latency_s, rule_index=idx)
                break
            if len(self.log) < _LOG_CAP:
                self.log.append((verb, kind, name,
                                 decision.error if decision else "pass"))
            return decision

    def raise_for(self, decision: Decision, context: str) -> None:
        """Translate a decision's error into the typed exception the
        hardened client paths classify (latency already applied)."""
        err = decision.error
        if not err:
            return
        if err == "conflict":
            raise ConflictError(f"injected conflict: {context}")
        if err == "notfound":
            raise NotFoundError(f"injected not-found: {context}")
        if err == "drop":
            raise ApiUnavailableError(f"injected connection drop: {context}")
        if err == "crash":
            log.warning("fault plan: crashing process at %s", context)
            os._exit(CRASH_EXIT_CODE)
        if err in ("hang", HEAL):
            # a stall (latency already applied by the caller's gate) or
            # a recovery signal only ScriptedChipHealth consumes: at the
            # client layer the call proceeds
            return
        raise ApiServerError(f"injected HTTP {err}: {context}",
                             status=int(err),
                             retry_after_s=decision.retry_after_s)


class FaultyClusterClient(ClusterClient):
    """``ClusterClient`` wrapper executing a ``FaultPlan`` in front of a
    real backend.  Latency is applied before the outcome; error
    decisions fail the call before it reaches the backend (the request
    never happened, matching a rejected API call)."""

    def __init__(self, inner: ClusterClient, plan: FaultPlan,
                 sleep: Callable[[float], None] = time.sleep):
        self.inner = inner
        self.plan = plan
        self._sleep = sleep

    def _gate(self, verb: str, kind: str, name: str) -> None:
        decision = self.plan.decide(verb, kind, name)
        if decision is None:
            return
        if decision.latency_s > 0:
            self._sleep(decision.latency_s)
        self.plan.raise_for(decision, f"{verb} {kind} {name}")

    def create(self, obj: Any) -> Any:
        self._gate("create", type(obj).__name__, obj.metadata.name)
        return self.inner.create(obj)

    def update(self, obj: Any) -> Any:
        self._gate("update", type(obj).__name__, obj.metadata.name)
        return self.inner.update(obj)

    def apply(self, obj: Any) -> Any:
        # composed from the gated create/update, so scripted conflicts
        # steer the upsert exactly like a real 409 would
        try:
            return self.create(obj)
        except ConflictError:
            return self.update(obj)

    def delete(self, kind: str, namespace: str, name: str) -> None:
        self._gate("delete", kind, name)
        self.inner.delete(kind, namespace, name)

    def get(self, kind: str, namespace: str, name: str) -> Any:
        self._gate("get", kind, name)
        return self.inner.get(kind, namespace, name)

    def list(self, kind: str, namespace: str | None = None,
             label_selector: dict[str, str] | None = None) -> list[Any]:
        self._gate("list", kind, "")
        return self.inner.list(kind, namespace, label_selector)

    def watch(self, kind: str, handler: WatchHandler) -> Callable[[], None]:
        self._gate("watch", kind, "")
        return self.inner.watch(kind, handler)

    def close(self) -> None:
        close = getattr(self.inner, "close", None)
        if close:
            close()


class ScriptedChipHealth:
    """A deterministic chip-health source scripted by a ``FaultPlan``.

    Callable with the zero-argument ``health_source`` signature the
    health-consuming stack shares (gateway/replica.py, the gang
    supervisor, fleet/supply.py ``ChipLedger``), returning ``{chip:
    reason}``.  Each poll consults the plan once per chip in chip order
    (verb ``HEALTH_VERB``, kind ``CHIP_KIND``, name = the decimal
    index), so the decision sequence is a pure function of the poll
    sequence.  Decisions LATCH: a down-kind error marks the chip
    unhealthy until a ``heal`` decision clears it.  ``base`` composes a
    real backend's ``health()`` view under the scripted overrides.
    """

    def __init__(self, plan: FaultPlan, chips, base=None):
        self.plan = plan
        self.chips = [int(c) for c in chips]
        self.base = base
        self._down: dict[int, str] = {}

    def __call__(self) -> dict[int, str]:
        for chip in self.chips:
            d = self.plan.decide(HEALTH_VERB, CHIP_KIND, str(chip))
            if d is None or not d.error:
                continue
            if d.error == HEAL:
                self._down.pop(chip, None)
            else:
                self._down[chip] = f"injected {d.error}"
        out = dict(self.base() if self.base is not None else {})
        out.update(self._down)
        return out


# --------------------------------------------------------------------------
# process-level plan: crash windows inside a process
# --------------------------------------------------------------------------

#: named crash points of the driver's claim checkpoint
CRASH_CHECKPOINT_TMP_WRITTEN = "checkpoint.tmp-written"
CRASH_CHECKPOINT_ROTATED = "checkpoint.rotated"
CRASH_CHECKPOINT_SAVED = "checkpoint.saved"
#: sharded workload checkpoints (parallel/resharding.py): between the
#: last shard file and the manifest commit, and just after the commit
CRASH_RESHARD_SHARDS_WRITTEN = "reshard.shards-written"
CRASH_RESHARD_COMMITTED = "reshard.manifest-committed"
#: monolithic workload checkpoints (models/checkpoint.py): with the
#: write in flight (before the rename), and after the rename but before
#: the integrity sidecar lands
CRASH_TRAIN_CKPT_SAVING = "train_ckpt.saving"
CRASH_TRAIN_CKPT_COMMITTED = "train_ckpt.committed"
#: durable outcome journal (gateway/outcome_store.py): between the
#: buffered append reaching the OS (flush) and the fsync that commits
#: it, and just after the commit
CRASH_OUTCOME_APPENDED = "outcome.appended"
CRASH_OUTCOME_COMMITTED = "outcome.committed"

FAULT_PLAN_ENV = "TPU_DRA_FAULT_PLAN"

_process_plan: FaultPlan | None = None


def install_process_plan(plan: FaultPlan | None) -> None:
    """Arm (or disarm, with None) crashpoints process-wide."""
    global _process_plan
    _process_plan = plan


def load_plan_from_env() -> FaultPlan | None:
    """Plan from the JSON file named by ``TPU_DRA_FAULT_PLAN``: how a
    parent scripts faults into a subprocess."""
    path = os.environ.get(FAULT_PLAN_ENV, "")
    if not path:
        return None
    return FaultPlan.from_json(Path(path).read_text())


def crashpoint(point: str) -> None:
    """Die here if the process plan says so; no-op otherwise."""
    plan = _process_plan
    if plan is None:
        return
    decision = plan.decide(point)
    if decision is None:
        return
    if decision.latency_s > 0:
        time.sleep(decision.latency_s)
    if decision.error == "crash":
        log.warning("fault plan: crashing process at crashpoint %s", point)
        os._exit(CRASH_EXIT_CODE)


# --------------------------------------------------------------------------
# disk corruption: deterministic damage to checkpoint bytes on disk
# --------------------------------------------------------------------------

#: what the crucible's shard-corruption events do to a named file:
#: silent media corruption (bitflip) and a torn or short write that
#: slipped past the commit discipline (truncate)
CORRUPT_BITFLIP = "bitflip"
CORRUPT_TRUNCATE = "truncate"
CORRUPT_KINDS = (CORRUPT_BITFLIP, CORRUPT_TRUNCATE)


def corrupt_file(path, kind: str, seed: int = 0) -> str:
    """Deterministically damage ``path`` in place; returns a one-line
    description for repro logs.  ``bitflip`` flips one seeded bit (the
    reference's ``random.Random(seed)`` draws, so the same byte and bit
    as the JAX package's); ``truncate`` cuts the file to half its
    length (min 1 byte: a SHORT file, not an absent one)."""
    p = Path(path)
    data = bytearray(p.read_bytes())
    if not data:
        raise ValueError(f"refusing to corrupt empty file {p}")
    if kind == CORRUPT_BITFLIP:
        rng = random.Random(seed)
        i = rng.randrange(len(data))
        data[i] ^= 1 << rng.randrange(8)
        p.write_bytes(bytes(data))
        return f"bitflip byte {i} of {p.name}"
    if kind == CORRUPT_TRUNCATE:
        keep = max(len(data) // 2, 1)
        p.write_bytes(bytes(data[:keep]))
        return f"truncate {p.name} {len(data)}->{keep} bytes"
    raise ValueError(f"unknown corruption kind {kind!r}")


__all__ = ["CHIP_KIND", "CORRUPT_BITFLIP", "CORRUPT_KINDS",
           "CORRUPT_TRUNCATE", "CRASH_CHECKPOINT_ROTATED",
           "CRASH_CHECKPOINT_SAVED", "CRASH_CHECKPOINT_TMP_WRITTEN",
           "CRASH_EXIT_CODE", "CRASH_OUTCOME_APPENDED",
           "CRASH_OUTCOME_COMMITTED", "CRASH_RESHARD_COMMITTED",
           "CRASH_RESHARD_SHARDS_WRITTEN", "CRASH_TRAIN_CKPT_COMMITTED",
           "CRASH_TRAIN_CKPT_SAVING", "Decision", "ERROR_KINDS",
           "FAULT_PLAN_ENV", "FaultPlan", "FaultRule",
           "FaultyClusterClient", "GANG_VERB", "GANG_WORKER_KIND", "HEAL",
           "HEALTH_VERB", "PUMP_KIND", "PUMP_VERB", "ScriptedChipHealth",
           "VERBS", "corrupt_file", "crashpoint", "install_process_plan",
           "load_plan_from_env"]
