"""THE crucible acceptance on the port (k8s_dra_driver_tpu_torch/
cluster/crucible.py): the twin of tests/test_crucible.py::
test_compound_soak_zero_violations with the JAX test's own assertions,
on the CPU in f32 at the reference crucible's model shape.  220 co-loop
cycles of the default schedule: every fault kind fires, at least three
land inside another fault's recovery window, and every checker stays
silent from warm-up to drain.  The same gates hold at 88 cycles, the
length chip_smoke.py's full-width crucible phase runs: the smallest of
at least 60 at which the soak passes (tests/test_torch_crucible_jax.py
says why shorter ones fail, in both packages).  A file of its own: it
holds the longest port tests of the crucible."""

import pytest

from k8s_dra_driver_tpu_torch.cluster import crucible as cru
from k8s_dra_driver_tpu_torch.cluster import invariants as inv

pytestmark = pytest.mark.timeout_s(600)


@pytest.mark.faults
@pytest.mark.parametrize("cycles", [220, 88])
def test_compound_soak_zero_violations(tmp_path, cycles):
    sched = cru.default_schedule(7, cycles=cycles)
    res, rig = cru.run_soak(sched, tmp_path / "soak", device="cpu")
    violations = [f"cycle {c}: {m}" for c, v in res.violations for m in v]
    assert not violations, "soak:\n  " + "\n  ".join(violations)
    assert res.cycles >= cycles and res.survived_cycles == res.cycles
    assert set(res.fault_kinds_fired) == set(cru.EVENT_KINDS)
    assert res.overlap_hits >= 3
    assert res.gang_failures == [] and res.operator_repairs == 0
    assert res.submitted > 0 and res.finished == res.submitted
    assert res.compound_mttr_ms > 0
    for name, sup in rig.sups.items():
        assert sup.recoveries, f"{name}: no recovery exercised"
        assert inv.losses_exactly_once(sup.losses, sup.recoveries) == [], \
            name
    by_id = {e.id: e for e in sched.events}
    for eid in ("mid-chip4-in-reform", "decode-kill-in-handoff",
                "chip0-in-cascade", "chip1-while-parked"):
        assert by_id[eid].fired_cycle is not None, f"{eid} never fired"
        assert by_id[eid].hit_windows, f"{eid} fired outside a window"
    assert rig.burn is not None
    assert rig.burn.cycle >= res.cycles
    assert rig.burn.alerts_total == 0
    # the serving tenant hi has the highest priority: never a victim
    assert not [info for _, kind, info in rig.rec.events
                if kind.startswith("reclaim") and info.get("tenant") == "hi"]
