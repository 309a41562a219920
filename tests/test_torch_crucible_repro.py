"""Crucible repro files cross between the packages in both directions,
and the port's ``crucible_probe`` returns the JAX probe's keys
(k8s_dra_driver_tpu_torch/cluster/crucible.py, cluster/chaosprobe.py).

The repro format and JSON are the reference's: a repro the JAX package
writes (fired cycles included) replays in the port with every event
firing where JAX's did, and the port's writer emits the JAX writer's
bytes, which JAX replays.  One JAX soak writes the JAX repro for the
whole module (the JAX rig's first run compiles for tens of seconds)."""

import json

import pytest

from k8s_dra_driver_tpu.cluster import chaosprobe as jprobe
from k8s_dra_driver_tpu.cluster import crucible as jcru
from k8s_dra_driver_tpu_torch.cluster import chaosprobe as tprobe
from k8s_dra_driver_tpu_torch.cluster import crucible as cru
from k8s_dra_driver_tpu_torch.cluster.crucible import FaultEvent, Schedule

pytestmark = pytest.mark.timeout_s(600)

DEV = "cpu"

#: a short schedule that fails in neither package: a burst, a replica
#: kill and a kv_exhaust wave
CROSS = Schedule(seed=11, cycles=10, events=[
    FaultEvent(id="warm", kind="burst", at_cycle=1, n=4, prompt_seed=41),
    FaultEvent(id="kill-decode", kind="replica_kill", at_cycle=3,
               replica_glob="d*"),
    FaultEvent(id="squeeze", kind="kv_exhaust", at_cycle=4, heal_after=2),
])


def fired(sched):
    return [(e.id, e.fired_cycle, list(e.hit_windows))
            for e in sched.events]


@pytest.fixture(scope="module")
def jax_repro(tmp_path_factory):
    """(path, schedule, result) of a JAX soak of CROSS, written by the
    JAX package's ``write_repro``."""
    tmp = tmp_path_factory.mktemp("jax-repro")
    jsched = jcru.Schedule.from_json(CROSS.to_json())
    jres, _ = jcru.run_soak(jsched, tmp / "soak")
    return jcru.write_repro(tmp / "repro.json", jsched, jres), jsched, jres


@pytest.mark.faults
def test_jax_repro_replays_in_the_port(tmp_path, jax_repro):
    path, jsched, jres = jax_repro
    payload = json.loads(path.read_text())
    assert payload["format"] == cru.REPRO_FORMAT
    assert all(e["fired_cycle"] is not None
               for e in payload["schedule"]["events"])
    res, rig = cru.replay(path, tmp_path / "port", device=DEV)
    assert not res.violations and res.ok()
    assert fired(rig.schedule) == fired(jsched)
    assert res.fault_kinds_fired == jres.fault_kinds_fired
    assert res.overlap_hits == jres.overlap_hits
    assert (res.submitted, res.finished) == (jres.submitted, jres.finished)


@pytest.mark.faults
def test_port_repro_replays_in_jax(tmp_path, jax_repro):
    sched = Schedule.from_json(CROSS.to_json())
    res, _ = cru.run_soak(sched, tmp_path / "port", device=DEV)
    path = cru.write_repro(tmp_path / "port-repro.json", sched, res)
    jpath = jcru.write_repro(
        tmp_path / "jax-repro.json",
        jcru.Schedule.from_json(sched.to_json()), res)
    # the port writes the reference's JSON, byte for byte, and the two
    # packages' runs of one schedule write the same repro
    assert path.read_text() == jpath.read_text()
    assert path.read_text() == jax_repro[0].read_text()
    jres, jrig = jcru.replay(path, tmp_path / "jax")
    assert not jres.violations
    assert fired(jrig.schedule) == fired(sched)
    assert jres.fault_kinds_fired == res.fault_kinds_fired
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"format": "other/1"}))
    for mod in (cru, jcru):
        with pytest.raises(ValueError, match="not a crucible repro"):
            mod.replay(bad, tmp_path / "never")


def test_crucible_probe_returns_the_jax_keys(tmp_path, monkeypatch):
    """Both probes flatten the port's result of one short soak (the
    first two events of the default schedule over four cycles): the
    keys are the JAX probe's, and so is every value but the wall."""
    results = []
    real = cru.run_soak

    def port_soak(sched, workdir, **kw):
        assert kw["device"] == DEV
        sched.events = sched.events[:2]
        sched.cycles = 4
        results.append(real(sched, workdir, **kw))
        return results[-1]

    monkeypatch.setattr(cru, "run_soak", port_soak)
    monkeypatch.setattr(jcru, "run_soak", lambda sched, workdir: results[0])
    t = tprobe.crucible_probe(seed=7, cycles=60, workdir=tmp_path / "t",
                              device=DEV)
    j = jprobe.crucible_probe(seed=7, cycles=60, workdir=tmp_path / "j")
    assert sorted(t) == sorted(j)
    t.pop("cru_wall_s"), j.pop("cru_wall_s")
    assert t == j
    assert t["cru_invariant_violations"] == 0
    assert t["cru_fault_kinds"] == 1 and t["cru_submitted"] == 10
