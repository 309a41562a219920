"""Deterministic fault injection: the part the multi-process gateway
and the gang supervisor use.

The port's copy of the plan half of ``k8s_dra_driver_tpu/cluster/
faults.py``: ``FaultRule``, ``Decision`` and ``FaultPlan`` with the
plan's JSON form, the pump-kill and gang-worker target names, and the
process-level crashpoints armed through ``TPU_DRA_FAULT_PLAN`` (the
outcome journal's and the two checkpoint formats').  The environment
variable and the plan JSON are the reference's, so a plan written by
either package loads in the other.  The cluster-client wrapper, the
scripted chip-health source and the disk-corruption helpers are not
ported here.

Determinism contract: a plan is a pure function of (seed, rules, call
sequence).  Rule matching consumes per-rule counters in call order and
probabilistic rules draw from one seeded RNG, so replaying the same
call sequence against an identical plan yields the identical injection
log.

Plan JSON schema (one rule per dict, evaluated in order, first match
wins)::

    {"seed": 7, "rules": [
      {"verb": "pump",          # a client verb, a crashpoint name,
                                #   "pump", "health" or "*"
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

log = logging.getLogger(__name__)

#: exit code a scripted crash dies with, distinguishable from real
#: failures in subprocess tests
CRASH_EXIT_CODE = 86

ERROR_KINDS = ("429", "500", "502", "503", "conflict", "notfound",
               "drop", "crash", "hang", "heal", "")

#: gang-worker fault targets (parallel/supervisor.py): one decision per
#: (worker, step), verb "gang", kind "Worker", name = the worker's gang
#: name.  ``error: "crash"`` kills the worker (in-band gang death);
#: ``error: "hang"`` wedges it for ``latency_s`` while its peers block
#: in the collective.
GANG_VERB = "gang"
GANG_WORKER_KIND = "Worker"

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


# --------------------------------------------------------------------------
# process-level plan: crash windows inside a process
# --------------------------------------------------------------------------

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


__all__ = ["CRASH_EXIT_CODE", "CRASH_OUTCOME_APPENDED",
           "CRASH_OUTCOME_COMMITTED", "CRASH_RESHARD_COMMITTED",
           "CRASH_RESHARD_SHARDS_WRITTEN", "CRASH_TRAIN_CKPT_COMMITTED",
           "CRASH_TRAIN_CKPT_SAVING", "Decision", "ERROR_KINDS",
           "FAULT_PLAN_ENV", "FaultPlan", "FaultRule", "GANG_VERB",
           "GANG_WORKER_KIND", "PUMP_KIND", "PUMP_VERB", "crashpoint",
           "install_process_plan", "load_plan_from_env"]
