"""The crucible's seam over the port's fleet simulator: the fault
schedule, the invariant checkers and the ddmin minimizer of
k8s_dra_driver_tpu_torch/cluster/crucible.py run unchanged against
k8s_dra_driver_tpu_torch/sim/ through ``soak=``.

The twins of tests/test_sim_crucible.py (roster coverage, fidelity
no-ops, minimization, deterministic replay, the one-call investigate
workflow), then parity with the JAX package: ddmin's minimized events
and run count, repro files written by either package replayed by the
other, and ``fleet_sim_probe`` at a small size equal in every field
that is not a wall time.
"""

import dataclasses
import json

import pytest

from k8s_dra_driver_tpu.cluster import crucible as jcru
from k8s_dra_driver_tpu.fleet import tenancy as jten
from k8s_dra_driver_tpu.sim import fleet as jfleet
from k8s_dra_driver_tpu.sim import probe as jprobe
from k8s_dra_driver_tpu.sim import rig as jrig
from k8s_dra_driver_tpu_torch.cluster import crucible
from k8s_dra_driver_tpu_torch.cluster.crucible import FaultEvent, Schedule
from k8s_dra_driver_tpu_torch.fleet.tenancy import MtConfig
from k8s_dra_driver_tpu_torch.sim import fleet as tfleet
from k8s_dra_driver_tpu_torch.sim import probe as tprobe
from k8s_dra_driver_tpu_torch.sim.fleet import SimConfig
from k8s_dra_driver_tpu_torch.sim.rig import (NOOP_KINDS,
                                              default_sim_schedule,
                                              run_sim_soak, sim_soak_for)


def _starved(res) -> bool:
    return any("starvation" in m
               for _, msgs in res.violations for m in msgs)


def _noisy_starvation_schedule(cls=Schedule, event=FaultEvent):
    """The burst that wedges the pre-fix arbiter, buried in decoy
    faults ddmin must throw away."""
    return cls(seed=7, cycles=30, events=[
        event(id="gang-chip", kind="chip_kill", at_cycle=1, chip=1),
        event(id="spike-wave", kind="burst", at_cycle=2, n=24),
        event(id="bitflip", kind="shard_bitflip", at_cycle=4),
        event(id="tear", kind="gen_tear", at_cycle=6),
        event(id="kv", kind="kv_exhaust", at_cycle=8),
    ])


@pytest.fixture()
def prefix_soak():
    """The soak over the repro fleet with the drain fix DISABLED: the
    configuration the pathology lives in."""
    return sim_soak_for(SimConfig.repro(
        mt_config=MtConfig(domain_aware_drain=False)))


@pytest.fixture()
def jax_prefix_soak():
    return jrig.sim_soak_for(jfleet.SimConfig.repro(
        mt_config=jten.MtConfig(domain_aware_drain=False)))


# -- twins of tests/test_sim_crucible.py -----------------------------------

class TestSoakContract:
    def test_default_schedule_survives_and_fires_every_kind(self, tmp_path):
        res, _ = run_sim_soak(default_sim_schedule(7, cycles=60), tmp_path,
                              config=SimConfig.tiny())
        assert res.ok(), res.violations
        assert res.survived_cycles == 60
        assert res.fault_kinds_fired == sorted(
            crucible.FAULT_KIND_REGISTRY)
        assert res.overlap_hits >= 1
        assert res.finished > 0

    def test_sim_schedule_covers_the_registry(self):
        sched = default_sim_schedule(7, cycles=60)
        assert {e.kind for e in sched.events} == set(
            crucible.FAULT_KIND_REGISTRY)

    def test_noop_kinds_are_logged_not_modeled(self, tmp_path):
        _, fleet = run_sim_soak(default_sim_schedule(7, cycles=60),
                                tmp_path, config=SimConfig.tiny())
        logged = {k for _, k, i in fleet.journal
                  if isinstance(i, dict) and i.get("noop")}
        assert logged == {f"fault.{k}" for k in NOOP_KINDS}

    def test_crucible_result_shape_feeds_minimize(self, tmp_path):
        res, _ = run_sim_soak(default_sim_schedule(7, cycles=20), tmp_path,
                              config=SimConfig.tiny())
        assert isinstance(res, crucible.CrucibleResult)
        assert res.ok() == (not res.violations and not res.gang_failures)


class TestMinimizeThroughSeam:
    def test_ddmin_reduces_to_the_single_burst(self, tmp_path, prefix_soak):
        minimized, runs = crucible.minimize(
            _noisy_starvation_schedule(), tmp_path, soak=prefix_soak,
            check=_starved)
        assert len(minimized.events) == 1
        assert minimized.events[0].kind == "burst"
        assert runs <= 16

    def test_minimized_repro_replays_deterministically(self, tmp_path,
                                                       prefix_soak):
        minimized, _ = crucible.minimize(
            _noisy_starvation_schedule(), tmp_path / "ddmin",
            soak=prefix_soak, check=_starved)
        min_res, _ = prefix_soak(minimized, tmp_path / "m")
        repro = crucible.write_repro(tmp_path / "repro.json", minimized,
                                     min_res)
        r1, f1 = crucible.replay(repro, tmp_path / "r1", soak=prefix_soak)
        r2, f2 = crucible.replay(repro, tmp_path / "r2", soak=prefix_soak)
        assert _starved(r1) and _starved(r2)
        assert f1.journal_digest() == f2.journal_digest()
        assert r1.violations == r2.violations

    def test_repro_file_is_auditable_json(self, tmp_path, prefix_soak):
        minimized, _ = crucible.minimize(
            _noisy_starvation_schedule(), tmp_path / "ddmin",
            soak=prefix_soak, check=_starved)
        min_res, _ = prefix_soak(minimized, tmp_path / "m")
        repro = crucible.write_repro(tmp_path / "repro.json", minimized,
                                     min_res)
        doc = json.loads(repro.read_text())
        assert doc["format"] == crucible.REPRO_FORMAT
        assert any("starvation" in v for _, vs in doc["violations"]
                   for v in vs)


class TestInvestigateThroughSeam:
    def test_one_call_workflow_confirms_the_pathology(self, tmp_path,
                                                      prefix_soak):
        out = crucible.investigate(_noisy_starvation_schedule(), tmp_path,
                                   soak=prefix_soak)
        assert out["confirmed"] is True
        assert len(out["minimized"].events) == 1
        assert out["repro"].exists()
        assert _starved(out["confirm_result"])

    def test_clean_fleet_yields_no_repro(self, tmp_path):
        soak = sim_soak_for(SimConfig.repro())
        out = crucible.investigate(_noisy_starvation_schedule(), tmp_path,
                                   soak=soak)
        assert out["result"].ok()
        assert out["minimized"] is None
        assert out["repro"] is None


def test_soak_takes_exactly_what_minimize_and_replay_pass(tmp_path):
    """``minimize`` calls ``soak(sub, workdir)``, ``replay`` calls
    ``soak(sched, workdir, dump_dir=, drain_cycles=)``: the bound soak
    takes both, and the dump dir receives the journal."""
    soak = sim_soak_for(SimConfig.tiny())
    sched = default_sim_schedule(7, cycles=12)
    res, fleet = soak(sched, tmp_path / "a")
    res2, fleet2 = soak(sched, tmp_path / "b", dump_dir=tmp_path / "dump",
                        drain_cycles=5)
    assert res2.cycles == res.cycles + 5
    dumped = json.loads((tmp_path / "dump" / "journal.json").read_text())
    assert len(dumped) == len(fleet2.journal)


# -- parity with the JAX package -------------------------------------------

def test_minimize_equals_jax(tmp_path, prefix_soak, jax_prefix_soak):
    """ddmin over the two simulators: the same minimized events, the
    same number of probe soaks."""
    tmin, truns = crucible.minimize(_noisy_starvation_schedule(),
                                    tmp_path / "t", soak=prefix_soak,
                                    check=_starved)
    jmin, jruns = jcru.minimize(
        _noisy_starvation_schedule(jcru.Schedule, jcru.FaultEvent),
        tmp_path / "j", soak=jax_prefix_soak, check=_starved)
    assert truns == jruns
    assert tmin.to_json() == jmin.to_json()


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_repro_files_replay_across_packages(tmp_path, writer, prefix_soak,
                                            jax_prefix_soak):
    """A repro written by either package is the same file, and replays
    in the other to the same journal and violations."""
    sched_t = Schedule(seed=7, cycles=30, events=[
        FaultEvent(id="spike-wave", kind="burst", at_cycle=2, n=24)])
    sched_j = jcru.Schedule(seed=7, cycles=30, events=[
        jcru.FaultEvent(id="spike-wave", kind="burst", at_cycle=2, n=24)])
    res_t, _ = prefix_soak(sched_t, tmp_path / "st")
    res_j, _ = jax_prefix_soak(sched_j, tmp_path / "sj")
    path_t = crucible.write_repro(tmp_path / "t.json", sched_t, res_t)
    path_j = jcru.write_repro(tmp_path / "j.json", sched_j, res_j)
    assert path_t.read_text() == path_j.read_text()
    path = path_t if writer == "torch" else path_j
    rt, ft = crucible.replay(path, tmp_path / "rt", soak=prefix_soak)
    rj, fj = jcru.replay(path, tmp_path / "rj", soak=jax_prefix_soak)
    assert _starved(rt) and _starved(rj)
    assert rt.violations == rj.violations
    assert ft.journal_digest() == fj.journal_digest()
    assert ft.journal == fj.journal


#: the probe's readings of the host clock
WALL_KEYS = {"sim_events_per_s", "sim_pathology_repro_ms",
             "sim_soak_wall_s", "probe_wall_s"}


def _small_census(monkeypatch, fleet_mod, tenants: int) -> None:
    """``fleet_sim_probe`` builds ``fleet.SimConfig(...)`` and its
    presets: give them a smaller tenant census (the 1000 replicas and
    64 domains stay)."""
    small = dataclasses.make_dataclass(
        "SimConfig", [("n_tenants", int, tenants)],
        bases=(fleet_mod.SimConfig,))
    monkeypatch.setattr(fleet_mod, "SimConfig", small)


def test_fleet_sim_probe_equals_jax_but_walls(tmp_path, monkeypatch):
    """The probe at a small size (3 cycles of the 1000-replica soak, a
    30-cycle A/B, 1500 tenants in both packages): every field but the
    walls equal to the JAX probe's, the pathology still minimized to
    the one burst and replayed starving."""
    _small_census(monkeypatch, jfleet, 1500)
    _small_census(monkeypatch, tfleet, 1500)
    got = tprobe.fleet_sim_probe(seed=7, cycles=3, ab_cycles=30,
                                 workdir=tmp_path / "t")
    want = jprobe.fleet_sim_probe(seed=7, cycles=3, ab_cycles=30,
                                  workdir=tmp_path / "j")
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in WALL_KEYS} == \
        {k: v for k, v in want.items() if k not in WALL_KEYS}
    assert (got["sim_replicas"], got["sim_tenants"]) == (1000, 1500)
    assert got["sim_invariant_violations"] == 0
    assert got["sim_repro_starved"] is True
    assert got["sim_minimized_events"] == 1
    # spread placement: the fixed order grants, the domain-blind one not
    assert got["ab"]["spread_fixed"]["spike_grant_t"] is not None
    assert got["ab"]["spread_prefix"]["spike_grant_t"] is None
    for k in WALL_KEYS:
        assert got[k] > 0
    assert (tmp_path / "t" / "scale" / "sim_soak.json").read_text() == \
        (tmp_path / "j" / "scale" / "sim_soak.json").read_text()


def test_probe_main_prints_one_json_line(tmp_path, capsys, monkeypatch):
    seen = {}

    def fake(**kw):
        seen.update(kw)
        return {"sim_replicas": 1000}

    monkeypatch.setattr(tprobe, "fleet_sim_probe", fake)
    assert tprobe.main(["--seed", "3", "--cycles", "5", "--ab-cycles", "9",
                        "--workdir", str(tmp_path)]) == 0
    assert json.loads(capsys.readouterr().out) == {"sim_replicas": 1000}
    assert seen == dict(seed=3, cycles=5, ab_cycles=9,
                        workdir=str(tmp_path))
