"""The JAX rig and the port's rig run one compound-fault soak side by
side on the CPU and must agree (k8s_dra_driver_tpu_torch/cluster/
crucible.py against k8s_dra_driver_tpu/cluster/crucible.py).

Both run ``default_schedule(7, cycles=88)``: 88 is the smallest length
of at least 60 at which the soak passes (every kind fires, no violation,
no gang failure) in either package.  Below it the reference's own rig
fails the same way as the port's: at 60-65 the mid gang is left with
no dp width that divides its batch, and at 66-87 the scripted wedge
lands in a fresh formation's warm-up, outlives its stall and raises out
of ``step_once`` (ROADMAP Queue C).

The serving weights cross by ``params_from_jax``; the JAX module's
prompts and oracle cache are replaced, in this test only, by the port's
numpy prompts and a fresh cache.  Compared: every event's fired cycle
and hit windows, the reconciler's ``(t, kind)`` events, each gang's
recoveries and transitions, every uid's outcome status and tokens, and
``ok()``.  Not compared: the gangs' losses (each package initializes
its gangs' weights with its own RNG), and MTTR (wall time)."""

import jax
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.cluster import crucible as jcru
from k8s_dra_driver_tpu.models import transformer as jt
from k8s_dra_driver_tpu_torch.cluster import crucible as cru
from k8s_dra_driver_tpu_torch.models import transformer as tt
from k8s_dra_driver_tpu_torch.models.convert import params_from_jax

pytestmark = pytest.mark.timeout_s(900)

CYCLES = 88


def record(sched, res, rig):
    return dict(
        fired=[(e.id, e.fired_cycle, tuple(e.hit_windows))
               for e in sched.events],
        reconciler=[(t, kind) for t, kind, _ in rig.rec.events],
        gangs={name: dict(
            recoveries=[(r.cause, tuple(r.victims), r.from_dp, r.to_dp,
                         r.restored_step, r.steps_lost)
                        for r in sup.recoveries],
            transitions=list(sup.transitions),
            steps=[s for s, _ in sup.losses])
            for name, sup in rig.sups.items()},
        outcomes={uid: g.status for uid, g in rig.gw.outcomes.items()},
        tokens={uid: np.asarray(f.tokens).tolist()
                for uid, f in rig.gw.results.items()},
        ok=res.ok(), violations=res.violations,
        kinds=res.fault_kinds_fired, overlap_hits=res.overlap_hits,
        submitted=res.submitted, finished=res.finished,
        repairs=res.operator_repairs, gang_failures=res.gang_failures,
        kv_seizures=rig.kv_seizures, adapter_storms=rig.adapter_storms,
        tier_corruptions=rig.tier_corruptions,
        tampered=rig.tampered)


@pytest.mark.faults
def test_jax_and_port_rigs_agree_on_a_compound_soak(tmp_path, monkeypatch):
    jcfg = jcru._cfg()
    jp = jax.tree.map(np.asarray, jt.init_params(jcfg, jax.random.PRNGKey(0)))
    tcfg = tt.TransformerConfig(dtype=torch.float32, **cru.DEFAULT_FIELDS)
    assert all(getattr(tcfg, k) == getattr(jcfg, k)
               for k in cru.DEFAULT_FIELDS)
    monkeypatch.setattr(jcru, "_PARAMS", jp)
    monkeypatch.setattr(jcru, "_ORACLES", {})
    monkeypatch.setattr(jcru, "_prompt", lambda seed, n:
                        cru.prompt_tokens(seed, n, jcfg.vocab))

    jsched = jcru.default_schedule(7, cycles=CYCLES)
    jres, jrig = jcru.run_soak(jsched, tmp_path / "jax")
    tsched = cru.default_schedule(7, cycles=CYCLES)
    tres, trig = cru.run_soak(
        tsched, tmp_path / "torch", device="cpu",
        model=(tcfg, params_from_jax(jp, device="cpu")))
    j = record(jsched, jres, jrig)
    t = record(tsched, tres, trig)

    for key in j:
        assert t[key] == j[key], key
    # what the run is built to show, in both packages
    assert t["ok"] and not t["violations"]
    assert set(t["kinds"]) == set(cru.EVENT_KINDS)
    assert t["overlap_hits"] >= 3
    assert t["submitted"] > 0 and t["finished"] == t["submitted"]
    assert t["repairs"] == 0
    assert all(g["recoveries"] for g in t["gangs"].values())
    assert set(t["tokens"]) == set(t["outcomes"])
    # the serving tenant hi has the highest priority: never a victim
    assert not [info for _, kind, info in trig.rec.events
                if kind.startswith("reclaim") and info.get("tenant") == "hi"]
