"""The port's crucible violation workflow (k8s_dra_driver_tpu_torch/
cluster/crucible.py ``investigate``: soak, ddmin, repro, replay) on the
CPU: the twin of tests/test_crucible.py::
test_broken_invariant_minimizes_and_replays with the JAX test's own
assertions, plus the hooks a fleet simulator passes to ``minimize``
(``check=`` and ``soak=``).  A file of its own for time: the workflow
runs the rig about a dozen times."""

import json
from pathlib import Path

import pytest

from k8s_dra_driver_tpu_torch.cluster import crucible as cru
from k8s_dra_driver_tpu_torch.cluster.crucible import FaultEvent, Schedule

pytestmark = pytest.mark.timeout_s(600)

EVENTS = [
    FaultEvent(id="warm", kind="burst", at_cycle=1, n=4, prompt_seed=41),
    FaultEvent(id="kill-decode", kind="replica_kill", at_cycle=3,
               replica_glob="d*"),
    FaultEvent(id="decoy-kill-nothing", kind="replica_kill",
               at_cycle=5, replica_glob="zz*"),
    FaultEvent(id="decoy-burst", kind="burst", at_cycle=6, n=2,
               prompt_seed=77),
]


@pytest.mark.faults
def test_broken_invariant_minimizes_and_replays(tmp_path, monkeypatch):
    """Break a real invariant on purpose (drain victims silently
    dropped instead of requeued) and run the whole forensic workflow:
    the soak flags it, ddmin strips the two decoy events, the repro
    file replays to the same failure, and the confirming replay ships
    flight-recorder dumps."""
    from k8s_dra_driver_tpu_torch.gateway.admission import AdmissionQueue
    monkeypatch.setattr(AdmissionQueue, "requeue",
                        lambda self, g: None)
    sched = Schedule(seed=11, cycles=14,
                     events=[e.fresh() for e in EVENTS])
    out = cru.investigate(sched, tmp_path, max_runs=10, device="cpu")
    assert out["result"].violations, (
        "dropped requeues must violate conservation/exactly-once")
    assert {e.id for e in out["minimized"].events} \
        == {"warm", "kill-decode"}
    repro = Path(out["repro"])
    assert repro.exists()
    payload = json.loads(repro.read_text())
    assert payload["format"] == cru.REPRO_FORMAT
    assert payload["violations"]
    assert out["confirmed"] is True, "repro did not re-fail on replay"
    dumps = list((tmp_path / "confirm" / "flightrec").glob(
        "flightrec-*.json"))
    assert dumps, "confirming replay shipped no flight-recorder dump"
    monkeypatch.undo()
    clean, _ = cru.replay(repro, tmp_path / "clean", device="cpu")
    assert not clean.violations


def test_minimize_takes_check_and_soak_hooks(tmp_path):
    """ddmin over a stand-in soak (no rig): a schedule 'fails' while it
    holds both culprits, so the complement reduction ends on exactly
    them; ``check`` decides failure on the stand-in's result and every
    probe gets a fresh workdir and fresh events."""
    probes = []

    class Result:
        def __init__(self, ids):
            self.ids = ids
            self.violations = []

    def soak(schedule, workdir, **kw):
        assert all(e.fired_cycle is None for e in schedule.events)
        probes.append((Path(workdir).name, [e.id for e in schedule.events]))
        return Result({e.id for e in schedule.events}), None

    events = [FaultEvent(id=f"e{i}", kind="burst", at_cycle=i + 1, n=1)
              for i in range(8)]
    events[2].fired_cycle = 3                 # runtime state is stripped
    sched = Schedule(seed=5, cycles=20, events=events)
    culprits = {"e2", "e5"}
    got, runs = cru.minimize(sched, tmp_path, max_runs=30, soak=soak,
                             check=lambda res: culprits <= res.ids)
    assert {e.id for e in got.events} == culprits
    assert runs == len(probes) <= 30
    assert [p for p, _ in probes] == [f"probe-{i:03d}"
                                      for i in range(1, runs + 1)]
    assert got.seed == 5 and got.cycles == 20
    # the probe budget bounds the search
    probes.clear()
    _, runs = cru.minimize(sched, tmp_path / "b", max_runs=2, soak=soak,
                           check=lambda res: culprits <= res.ids)
    assert runs == 2


def test_investigate_on_a_clean_run_stops_after_the_soak(tmp_path):
    calls = []

    def soak(schedule, workdir, **kw):
        calls.append(Path(workdir).name)
        return cru.CrucibleResult(
            cycles=schedule.cycles, survived_cycles=schedule.cycles,
            violations=[], overlap_hits=0, fault_kinds_fired=[],
            compound_mttr_ms=0.0, submitted=0, finished=0,
            operator_repairs=0, gang_failures=[]), None

    out = cru.investigate(Schedule(seed=1, cycles=3, events=[]), tmp_path,
                          soak=soak)
    assert calls == ["soak"]
    assert out["result"].ok()
    assert out["minimized"] is None and out["confirmed"] is None
