"""The port's compound-fault crucible (k8s_dra_driver_tpu_torch/cluster/
crucible.py) on the CPU: twins of tests/test_crucible.py with the JAX
tests' own assertions, over the port's engines, gateways, gangs and
reconciler in f32 at the reference crucible's model shape.

The 220-cycle soak twin lives in tests/test_torch_crucible_soak.py, the
ddmin / repro / replay twin in tests/test_torch_crucible_ddmin.py,
repro files crossing between the packages and the probe's keys in
tests/test_torch_crucible_repro.py, and the JAX-vs-port run in
tests/test_torch_crucible_jax.py, each in a file of its own for time.
Here besides the twins: the default schedule's JSON and the fault-kind
registry equal JAX's.

The port's rig takes its model, gang config and device from the
caller; the default model has the reference fields, weights from the
port's ``init_params`` on a generator seeded 0, and numpy prompts
(ROADMAP Queue C, the crucible's divergence)."""

import json

import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.cluster import crucible as jcru
from k8s_dra_driver_tpu_torch.cluster import crucible as cru
from k8s_dra_driver_tpu_torch.cluster import invariants as inv
from k8s_dra_driver_tpu_torch.cluster.crucible import FaultEvent, Schedule
from k8s_dra_driver_tpu_torch.cluster.faults import (FaultPlan, FaultRule,
                                                     ScriptedChipHealth)

pytestmark = pytest.mark.timeout_s(600)

DEV = "cpu"


def assert_no_violations(violations, label="invariants"):
    assert not violations, (
        f"{label}: {len(violations)} violation(s):\n  "
        + "\n  ".join(violations))


def assert_losses_exactly_once(sup, label="gang"):
    assert_no_violations(
        inv.losses_exactly_once(sup.losses, sup.recoveries),
        label=f"losses-exactly-once[{label}]")


def soak_violations(res):
    return [f"cycle {c}: {m}" for c, v in res.violations for m in v]


def model():
    return cru.default_model(DEV)


# -- schedule plumbing ----------------------------------------------------

def test_fault_plan_arm_appends_live():
    plan = FaultPlan(seed=3)
    assert plan.decide("health", "Chip", "0") is None
    plan.arm(FaultRule(verb="health", kind="Chip", name="0",
                       skip=1, times=1, error="drop"))
    assert plan.decide("health", "Chip", "0") is None      # skip
    d = plan.decide("health", "Chip", "0")
    assert d is not None and d.error == "drop"
    assert plan.decide("health", "Chip", "0") is None      # exhausted


def test_schedule_json_roundtrip_and_fresh():
    sched = cru.default_schedule(7, cycles=220)
    back = Schedule.from_json(json.dumps(sched.to_json()))
    assert back.seed == sched.seed and back.cycles == sched.cycles
    assert [e.id for e in back.events] == [e.id for e in sched.events]
    ev = back.events[0]
    ev.fired_cycle, ev.hit_windows = 9, ("reform:mid",)
    fr = ev.fresh()
    assert fr.fired_cycle is None and fr.hit_windows == ()
    assert fr.id == ev.id and fr.kind == ev.kind
    tight = FaultEvent(id="t", kind="burst", at_cycle=1, n=2,
                       slo_s=4.0)
    assert FaultEvent.from_json(tight.to_json()).slo_s == 4.0
    with pytest.raises(ValueError):
        FaultEvent(id="x", kind="nope", at_cycle=1)
    with pytest.raises(ValueError):
        FaultEvent(id="x", kind="burst")        # no trigger at all


@pytest.mark.parametrize("seed,cycles", [(7, 220), (7, 66), (3, 90),
                                         (11, 14)])
def test_default_schedule_and_registry_equal_jax(seed, cycles):
    assert cru.default_schedule(seed, cycles).to_json() == \
        jcru.default_schedule(seed, cycles).to_json()
    assert cru.FAULT_KIND_REGISTRY == jcru.FAULT_KIND_REGISTRY
    assert cru.EVENT_KINDS == jcru.EVENT_KINDS
    assert cru.CORRUPTION_KINDS == jcru.CORRUPTION_KINDS
    assert cru.CASCADE_KINDS == jcru.CASCADE_KINDS
    assert cru.CASCADE_WINDOW_S == jcru.CASCADE_WINDOW_S
    assert cru.REPRO_FORMAT == jcru.REPRO_FORMAT == \
        "tpu-dra-crucible-repro/1"


def test_register_fault_kind_refuses_a_silent_overwrite(monkeypatch):
    monkeypatch.setattr(cru, "FAULT_KIND_REGISTRY",
                        dict(cru.FAULT_KIND_REGISTRY))
    monkeypatch.setattr(cru, "EVENT_KINDS", cru.EVENT_KINDS)
    assert cru.register_fault_kind("burst", "open-loop request wave "
                                   "(load, not a fault)") == "burst"
    with pytest.raises(ValueError, match="different description"):
        cru.register_fault_kind("burst", "something else")
    cru.register_fault_kind("new_kind", "a test-only kind")
    assert cru.EVENT_KINDS[-1] == "new_kind"
    FaultEvent(id="n", kind="new_kind", at_cycle=1)


def test_default_schedule_composes_every_kind():
    sched = cru.default_schedule(7, cycles=220)
    assert {e.kind for e in sched.events} == set(cru.EVENT_KINDS)
    windows = {e.window for e in sched.events if e.window}
    assert {"reform:mid", "handoff:hi", "cascade",
            "parked:lo"} <= windows
    assert all(e.heal_after for e in sched.events
               if e.kind == "chip_kill")


def test_pump_kill_event_arms_process_plan_or_noops():
    assert "pump_kill" in cru.EVENT_KINDS
    rig = object.__new__(cru.CrucibleRig)
    rig._sticky_windows = lambda: set()

    class _ProcGw:
        pump_plan = FaultPlan()

    rig.gw = _ProcGw()
    rig._fire(FaultEvent(id="pk", kind="pump_kill", at_cycle=1,
                         replica_glob="pump1"), 1)
    plan = _ProcGw.pump_plan
    assert plan.decide("pump", "Pump", "pump0") is None   # glob miss
    d = plan.decide("pump", "Pump", "pump1")
    assert d is not None and d.error == "crash"
    assert plan.decide("pump", "Pump", "pump1") is None   # one-shot
    _ProcGw.pump_plan = FaultPlan()
    rig.gw = _ProcGw()
    rig._fire(FaultEvent(id="pk2", kind="pump_kill", at_cycle=1), 1)
    assert _ProcGw.pump_plan.decide("pump", "Pump", "pump7") \
        is not None
    rig.gw = object()
    rig._fire(FaultEvent(id="pk3", kind="pump_kill", at_cycle=1), 1)


def test_model_helpers():
    cfg, params = model()
    assert (cfg.vocab, cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.d_head,
            cfg.d_ff, cfg.max_seq, cfg.kv_heads) == (64, 32, 2, 4, 8, 64,
                                                     48, 2)
    assert cfg.dtype == torch.float32
    assert cru.default_model(DEV)[1] is params           # cached
    np.testing.assert_array_equal(
        cru.prompt_tokens(5, 7, 64),
        np.random.default_rng(5).integers(0, 64, 7))
    assert cru.prompt_tokens(5, 7, 64).dtype == np.int32
    # the host arena holds 256 block slabs at any shape: 1 MiB here
    assert cru.host_tier_bytes(cfg) == 1 << 20
    from k8s_dra_driver_tpu_torch.models import TransformerConfig
    wide = TransformerConfig(vocab=64, d_model=256, n_layers=2, n_heads=4,
                             d_head=64, d_ff=512, max_seq=48, n_kv_heads=2,
                             dtype=torch.float32)
    assert cru.host_tier_bytes(wide) == 256 * 2 * 2 * 16 * 2 * 64 * 4


# -- soaks ----------------------------------------------------------------

@pytest.mark.faults
def test_burn_rate_alert_fires_during_fault_window(tmp_path):
    sched = Schedule(seed=7, cycles=30, events=[
        FaultEvent(id="warm-burst", kind="burst", at_cycle=1, n=6,
                   prompt_seed=11),
        FaultEvent(id="decode-chip-down", kind="chip_kill",
                   at_cycle=3, chip=7, heal_after=8),
        FaultEvent(id="kv-squeeze", kind="kv_exhaust", at_cycle=3,
                   heal_after=6),
        FaultEvent(id="doomed-burst", kind="burst", at_cycle=4, n=8,
                   prompt_seed=23, slo_s=4.0),
    ])
    res, rig = cru.run_soak(sched, tmp_path / "alert",
                            dump_dir=tmp_path / "fr", device=DEV)
    assert_no_violations(soak_violations(res), label="alert-arc")
    assert rig.burn.alerts_total >= 1
    marks = [m for m in rig.flightrec.marks if m["reason"] == "alert"]
    assert marks, "no alert ever reached the flight recorder"
    assert marks[0]["t"] <= 4.0 + 4.0 + rig.burn.fast_window + 4.0
    dump = next(d for d in rig.flightrec.dumps
                if "alert" in d["reasons"])
    rows = dump["digests"]["tpu_gateway_digest_queue_wait_seconds"]
    assert rows and rows[0]["count"] > 0
    assert rows[0]["p99"] is not None
    assert any(p.name.endswith("-alert.json")
               for p in (tmp_path / "fr").glob("flightrec-*.json"))
    alert_events = [e for e in rig.bus.journal_dump()
                    if e.get("topic") == "alert"]
    assert alert_events
    assert res.submitted == 14 and res.finished < res.submitted


@pytest.mark.faults
def test_spec_fleet_survives_kill_and_kv_exhaust(tmp_path):
    sched = Schedule(seed=11, cycles=14, events=[
        FaultEvent(id="warm-burst", kind="burst", at_cycle=1, n=6,
                   prompt_seed=31),
        FaultEvent(id="mid-burst", kind="burst", at_cycle=4, n=6,
                   prompt_seed=47),
        FaultEvent(id="decode-kill", kind="replica_kill", at_cycle=5,
                   replica_glob="d*"),
        FaultEvent(id="kv-squeeze", kind="kv_exhaust", at_cycle=6,
                   heal_after=12),
        FaultEvent(id="tail-burst", kind="burst", at_cycle=8, n=6,
                   prompt_seed=59),
    ])
    res, rig = cru.run_soak(sched, tmp_path / "spec",
                            draft_source="ngram", draft_len=3, device=DEV)
    assert_no_violations(soak_violations(res), label="spec-faults")
    assert res.submitted == 18 and res.finished == res.submitted
    by_id = {e.id: e for e in sched.events}
    assert by_id["decode-kill"].fired_cycle is not None
    assert rig.kv_seizures >= 1
    windows = sum(
        r.engine.stats().get("speculative_windows_total", 0)
        for r in rig.mgr.replicas if r.role != "prefill")
    assert windows > 0, "speculation never engaged under faults"


@pytest.mark.faults
def test_tier_corrupt_arc_falls_back_and_promotes_byte_equal(tmp_path):
    sched = Schedule(seed=23, cycles=16, events=[
        FaultEvent(id="tc-warm", kind="burst", at_cycle=1, n=6,
                   prompt_seed=71),
        FaultEvent(id="tc-press", kind="burst", at_cycle=2, n=6,
                   prompt_seed=83),
        FaultEvent(id="tc-re1", kind="burst", at_cycle=5, n=6,
                   prompt_seed=71),
        FaultEvent(id="tc-re2", kind="burst", at_cycle=7, n=6,
                   prompt_seed=83),
        FaultEvent(id="tc-re3", kind="burst", at_cycle=9, n=6,
                   prompt_seed=71),
        FaultEvent(id="tc-re4", kind="burst", at_cycle=11, n=6,
                   prompt_seed=83),
    ] + [FaultEvent(id=f"tc-flip{c}", kind="tier_corrupt",
                    at_cycle=c, replica_glob="*")
         for c in range(3, 13)])
    res, rig = cru.run_soak(sched, tmp_path / "tier", device=DEV)
    assert_no_violations(soak_violations(res), label="tier-corrupt")
    assert res.submitted == 36 and res.finished == res.submitted
    assert rig.tier_corruptions >= 1
    fallbacks = sum(
        r.engine.stats().get("kv_tier_corrupt_fallbacks_total", 0)
        for r in rig.mgr.replicas)
    promotions = sum(
        r.engine.stats().get("kv_tier_promotions_total", 0)
        for r in rig.mgr.replicas)
    assert fallbacks >= 1, "no promote ever hit the damaged slab"
    assert promotions >= 1, "no healthy slab ever promoted"


# -- the hardened double-fault arcs, one targeted test each ---------------

def _sup(tmp_path, *, dp, batch, plan=None, health_source=None,
         allowed, **kw):
    from k8s_dra_driver_tpu_torch.models.checkpoint import \
        TrainCheckpointer
    from k8s_dra_driver_tpu_torch.parallel.supervisor import (
        ElasticTrainJob, GangSupervisor)
    motif = np.random.default_rng(0).integers(0, 64, 32)
    job = ElasticTrainJob(model()[0], np.tile(motif, 64), batch=batch,
                          seq_len=16, tp=1, device=DEV)
    ckpt = TrainCheckpointer(tmp_path / "ckpt")
    sup = GangSupervisor(
        job, ckpt, coordination_dir=tmp_path / "coord", dp=dp,
        fault_plan=plan, health_source=health_source,
        checkpoint_every=2, step_deadline_s=30.0,
        first_step_deadline_s=240.0,
        placement_exclude=[c for c in range(8) if c not in allowed],
        **kw)
    return sup, ckpt


def _chips(sup):
    return {c for w in sup.workers if w.alive for c in w.chips}


@pytest.mark.faults
def test_chip_death_mid_reform_excludes_unowned_down_chip(tmp_path):
    down = {}
    sup, ckpt = _sup(tmp_path, dp=2, batch=4, allowed=(0, 1, 2),
                     health_source=lambda: dict(down))
    sup.begin(12)
    for _ in range(3):
        sup.step_once()
    assert _chips(sup) == {0, 1}
    down.update({0: "injected dead", 2: "injected dead"})
    while sup.step_once():
        pass
    report = sup.report()
    ckpt.close()
    assert sup.state == "running" or sup._step >= 12
    rec = report.recoveries[-1]
    assert (rec.from_dp, rec.to_dp) == (2, 1)
    assert _chips(sup) == {1}, "reform landed on a just-downed chip"
    assert_losses_exactly_once(sup, "gang")


@pytest.mark.faults
def test_late_down_push_mid_reform_retries_narrower(tmp_path):
    plan = FaultPlan([FaultRule(verb="gang", kind="Worker",
                                name="g0w0", skip=3, times=1,
                                error="crash")])
    sup, ckpt = _sup(tmp_path, dp=4, batch=8, allowed=(0, 1, 2, 3),
                     plan=plan)
    pushed = []

    def late_push(state, info):
        if state == "evict" and not pushed:
            pushed.append(True)
            sup.on_health({1: "late push", 2: "late push"})

    sup.listeners.append(late_push)
    report = sup.run(10)
    ckpt.close()
    assert pushed, "eviction never happened — fault did not fire"
    rec = report.recoveries[-1]
    assert rec.from_dp == 4 and rec.to_dp == 1, (
        "late pushes should force the dp=2 retry down to dp=1")
    assert _chips(sup) == {3}
    assert sup.state == "running" or sup._step >= 10
    assert_losses_exactly_once(sup, "gang")


@pytest.mark.faults
def test_drain_mid_kv_handoff_is_failure_atomic(tmp_path):
    from k8s_dra_driver_tpu_torch.gateway.sharded import ShardedGateway
    from k8s_dra_driver_tpu_torch.models.serving import (Request,
                                                         ServingEngine)
    from k8s_dra_driver_tpu_torch.serving_disagg import (
        DisaggReplicaManager, DisaggRouter, KVMigrator)

    class FlakyMigrator(KVMigrator):
        def __init__(self):
            super().__init__()
            self.failures_left = 1

        def migrate_block(self, block, dest=None):
            if self.failures_left:
                self.failures_left -= 1
                raise RuntimeError("target drained mid-handoff")
            return super().migrate_block(block, dest)

    cfg, params = model()
    mig = FlakyMigrator()
    mgr = DisaggReplicaManager(
        lambda name: ServingEngine(params, cfg, slots=2, prefix_cache=2,
                                   device=DEV),
        prefill_replicas=1, decode_replicas=2, migrator=mig,
        depth_bound=2)
    gw = ShardedGateway(mgr, pumps=1,
                        router_factory=lambda: DisaggRouter(mgr.index),
                        queue_capacity=16)
    subs = []
    for i in range(4):
        req = Request(uid=f"h{i}",
                      prompt=cru.prompt_tokens(50 + i, 4 + i, cfg.vocab),
                      max_new=3)
        gw.submit(req)
        subs.append((f"h{i}", 50 + i, 4 + i))
    gw.run_until_idle(400)
    assert mgr.handoff_failures == 1, (
        "the injected mid-handoff failure never hit the atomic path")
    assert_no_violations(
        inv.exactly_once_terminal(gw, [u for u, _, _ in subs]),
        label="exactly-once")
    oracles = {u: cru._oracle(model(), DEV, s, n, 3) for u, s, n in subs}
    assert_no_violations(inv.byte_equal(gw.results, oracles),
                         label="byte-equal")


@pytest.mark.faults
def test_kv_exhaust_wave_holds_admission_then_recovers(tmp_path):
    events = [
        FaultEvent(id="warm", kind="burst", at_cycle=1, n=6,
                   prompt_seed=100),
        FaultEvent(id="seize", kind="kv_exhaust", at_cycle=3,
                   heal_after=3),
        FaultEvent(id="burst-in-kv-pressure", kind="burst",
                   window="kv_pressure:hi", after_cycle=3, n=4,
                   prompt_seed=200),
    ]
    sched = Schedule(seed=11, cycles=12, events=events)
    res, rig = cru.run_soak(sched, tmp_path / "kv", device=DEV)
    assert_no_violations(soak_violations(res), label="kv-exhaust")
    assert rig.kv_seizures >= 1 and not rig._kv_seized
    by_id = {e.id: e for e in sched.events}
    assert by_id["seize"].fired_cycle is not None
    assert "kv_pressure:hi" in by_id["burst-in-kv-pressure"].hit_windows
    assert res.submitted == 10 and res.finished == res.submitted
    assert res.gang_failures == [] and res.operator_repairs == 0


@pytest.mark.faults
def test_adapter_evict_storm_cold_loads_then_recovers(tmp_path):
    events = [
        FaultEvent(id="warm", kind="burst", at_cycle=1, n=4,
                   prompt_seed=100, adapter="lora-a"),
        FaultEvent(id="storm", kind="adapter_evict_storm",
                   at_cycle=10, replica_glob="d*", heal_after=3),
        FaultEvent(id="burst-in-storm", kind="burst",
                   window="adapter_pressure:hi", after_cycle=10, n=4,
                   prompt_seed=200, adapter="lora-b"),
        FaultEvent(id="reload", kind="burst", at_cycle=15, n=4,
                   prompt_seed=300, adapter="lora-a"),
    ]
    sched = Schedule(seed=11, cycles=20, events=events)
    res, rig = cru.run_soak(sched, tmp_path / "lora", device=DEV)
    assert_no_violations(soak_violations(res), label="adapter-storm")
    assert rig.adapter_storms >= 1 and not rig._adapter_seized
    by_id = {e.id: e for e in sched.events}
    assert by_id["storm"].fired_cycle is not None
    assert ("adapter_pressure:hi"
            in by_id["burst-in-storm"].hit_windows)
    pools = {r.name: r.engine.adapter_pool
             for r in rig.mgr.replicas
             if getattr(r.engine, "adapter_pool", None) is not None}
    d1 = pools["d1"]
    assert not d1.storm_active
    assert d1.evictions_total >= 1
    assert d1.cold_loads_total >= 3
    assert res.submitted == 12 and res.finished == res.submitted
    assert res.gang_failures == [] and res.operator_repairs == 0


@pytest.mark.faults
def test_heal_mid_cascade_fences_foreign_owned_chip(tmp_path):
    from k8s_dra_driver_tpu_torch.fleet.binpack import TopologyBinPacker
    from k8s_dra_driver_tpu_torch.fleet.supply import ChipLedger
    from k8s_dra_driver_tpu_torch.fleet.tenancy import (
        MtConfig, MultiTenantReconciler, ServingTenant, TenantRegistry,
        TenantSpec, TrainingTenant)
    from k8s_dra_driver_tpu_torch.gateway.replica import ReplicaManager
    from k8s_dra_driver_tpu_torch.gateway.sharded import ShardedGateway
    from k8s_dra_driver_tpu_torch.models.serving import ServingEngine

    cfg, params = model()
    plan = FaultPlan(seed=2)
    ledger = ChipLedger(range(6), health_source=ScriptedChipHealth(
        plan, chips=range(6)))
    mgr = ReplicaManager(
        lambda name: ServingEngine(params, cfg, slots=2, device=DEV),
        replicas=1, chip_of=lambda name: 4,
        health_source=ledger.current_unhealthy)
    gw = ShardedGateway(mgr, pumps=1, queue_capacity=16,
                        auto_replace=False, tenant="hi")
    sup, ckpt = _sup(tmp_path, dp=2, batch=4, allowed=(0, 1, 2),
                     health_source=ledger.current_unhealthy)
    registry = TenantRegistry(capacity=6)
    registry.add(TenantSpec("hi", priority=2, quota=4, floor=2),
                 ServingTenant(gw))
    registry.add(TenantSpec("lo", priority=1, quota=3, floor=0),
                 TrainingTenant(sup, target_dp=2))
    rec = MultiTenantReconciler(
        registry, ledger=ledger,
        packer=TopologyBinPacker(ledger, domain_size=2),
        config=MtConfig())
    sup.begin(500)

    def tick():
        rec.tick()
        sup.step_once()
        v = inv.check_cycle(
            supervisors=[("lo", sup)], ledger=ledger,
            records=[("hi", mgr, None), ("lo", None, sup)],
            specs=list(registry), events=rec.events)
        assert_no_violations(v, label="cycle")

    for _ in range(4):
        tick()
    assert _chips(sup) == {0, 1}
    plan.arm(FaultRule(verb="health", kind="Chip", name="0", times=1,
                       error="drop"),
             FaultRule(verb="health", kind="Chip", name="0", skip=3,
                       times=1, error="heal"))
    tick()                                  # eviction + shrink begins
    mgr.add_replica(chip=0)                 # the cascade's grant
    for _ in range(8):
        tick()
    assert 0 not in _chips(sup)
    assert 0 in sup._placement_excluded, (
        "healed-but-foreign chip was readmitted without a fence")
    victim = sorted(_chips(sup))[0]
    plan.arm(FaultRule(verb="health", kind="Chip", name=str(victim),
                       times=1, error="drop"))
    for _ in range(8):
        tick()
    assert 0 not in _chips(sup) and _chips(sup), (
        f"gang reformed onto foreign-owned chip 0: {_chips(sup)}")
    ckpt.close()
    assert_losses_exactly_once(sup, "lo")


@pytest.mark.faults
def test_resize_while_parked_polls_health_first(tmp_path):
    down = {}
    sup, ckpt = _sup(tmp_path, dp=2, batch=4, allowed=(0, 1),
                     health_source=lambda: dict(down))
    sup.begin(12)
    for _ in range(3):
        sup.step_once()
    sup.park()
    sup.step_once()
    assert sup.state == "parked"
    down[0] = "died while parked"           # nobody is polling
    sup.request_width(2)                    # arbiter unparks blind
    sup.step_once()
    assert sup.state == "parked", (
        "infeasible unpark must stay parked, not form on a dead chip")
    sup.request_width(1)
    sup.step_once()
    assert sup.state == "running" and _chips(sup) == {1}
    while sup.step_once():
        pass
    report = sup.report()
    ckpt.close()
    assert [s for s, _ in report.losses] == list(range(1, 13)), (
        "park/unpark through the chip death must stay lossless")
    assert_losses_exactly_once(sup, "gang")


# -- reference behaviour below 88 cycles (ROADMAP Queue C) ----------------

@pytest.mark.faults
def test_short_default_schedules_fail_as_the_reference_does(tmp_path):
    """The default schedule below 88 cycles fails in the reference's rig
    and, reproduced, in the port's: at 60 the mid gang is left with no
    dp width that divides its batch (a gang failure, no violation); at
    66 the scripted wedge lands in a fresh formation's warm-up, whose
    600 s first-step allowance outlives the stall, and the wedge's
    ``_Aborted`` escapes ``step_once``.  A short stall keeps the test
    quick: the wedge raises as soon as it ends."""
    from k8s_dra_driver_tpu_torch.parallel import supervisor as sv
    res, _ = cru.run_soak(cru.default_schedule(7, cycles=60),
                          tmp_path / "60", device=DEV)
    assert res.violations == []
    assert res.gang_failures == [
        "mid: gang unrecoverable: 1 victim(s) leave no dp width that "
        "divides batch 8"]
    assert not res.ok()
    sched = cru.default_schedule(7, cycles=66)
    rig = cru.CrucibleRig(sched, tmp_path / "66", device=DEV,
                          hang_stall_s=0.5)
    with pytest.raises(sv._Aborted):
        for _ in range(sched.cycles):
            rig.run_cycle()
    rig.close()
    hang = next(e for e in sched.events if e.id == "mid-hang-w0")
    assert hang.fired_cycle == 42 and "resize_queued:mid" in hang.hit_windows
