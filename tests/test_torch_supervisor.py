"""Port elastic gang supervisor (k8s_dra_driver_tpu_torch/parallel/
supervisor.py) and its in-process gang, on the CPU in f32.

Two scenarios run on both packages on the same inputs: the kill arc of
tests/test_supervisor.py (dp=4, tp=1, 8 steps, ``g0w2`` crashing after
4 decisions), with the port's gang started from the JAX package's
initial weights — equal transitions, recoveries (MTTR aside) and
contract, and losses within the port's training tolerance — and the
same arc at the reference's default tp=2 through both packages'
sharded checkpointers, whose generations carry the tp layout.  The other
scenarios run on the port alone and are held to the JAX tests' own
assertions (tests/test_supervisor.py, tests/test_model_checkpoint.py,
tests/test_resharding.py's corrupt-generation arc), with the port's
chip numbers: at tp=1 dp row i owns chip i.
"""

import json
import threading
import time
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from invariants import assert_losses_exactly_once

from k8s_dra_driver_tpu.cluster import faults as jfaults
from k8s_dra_driver_tpu.models import transformer as jt
from k8s_dra_driver_tpu.models.checkpoint import \
    TrainCheckpointer as JTrainCheckpointer
from k8s_dra_driver_tpu.parallel import supervisor as jsv
from k8s_dra_driver_tpu_torch.cluster import faults as tfaults
from k8s_dra_driver_tpu_torch.cluster.faults import FaultPlan, FaultRule
from k8s_dra_driver_tpu_torch.models import transformer as tt
from k8s_dra_driver_tpu_torch.models.checkpoint import TrainCheckpointer
from k8s_dra_driver_tpu_torch.models.data import as_global
from k8s_dra_driver_tpu_torch.models.layouts import transformer_rules
from k8s_dra_driver_tpu_torch.parallel import supervisor as sv
from k8s_dra_driver_tpu_torch.parallel.resharding import \
    ShardedCheckpointer
from k8s_dra_driver_tpu_torch.parallel.supervisor import (ElasticTrainJob,
                                                          GangSupervisor)
from k8s_dra_driver_tpu_torch.utils.metrics import RecoveryMetrics

pytestmark = pytest.mark.timeout_s(300)

FIELDS = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
              d_ff=64, max_seq=16)
TCFG = tt.TransformerConfig(dtype=torch.float32, **FIELDS)
JCFG = jt.TransformerConfig(dtype=jnp.float32, **FIELDS)
#: tests/test_torch_train.py's tolerance for port steps against JAX's
LOSS_RTOL = 1e-5
#: JAX's tp=2 gang sums its head and hidden halves apart, the port's
#: in-process gang runs whole tensors: f32 rounding over eight steps
TP_LOSS_RTOL = 1e-4


def corpus():
    return np.tile(np.random.default_rng(0).integers(0, 64, 32), 64)


def _job(batch=8, chips=8, cls=ElasticTrainJob, tp=1):
    return cls(TCFG, corpus(), batch=batch, seq_len=16, chips=chips,
               tp=tp, device="cpu")


def _supervisor(tmp_path, *, dp=4, plan=None, health_source=None,
                checkpoint_every=2, batch=8, chips=8, ckpt=None,
                job_cls=ElasticTrainJob, tp=1, **kw):
    ckpt = ckpt or TrainCheckpointer(tmp_path / "ckpt")
    sup = GangSupervisor(
        _job(batch=batch, chips=chips, cls=job_cls, tp=tp), ckpt,
        coordination_dir=tmp_path / "coord", dp=dp, fault_plan=plan,
        health_source=health_source, checkpoint_every=checkpoint_every,
        step_deadline_s=kw.pop("step_deadline_s", 30.0),
        first_step_deadline_s=kw.pop("first_step_deadline_s", 240.0),
        **kw)
    return sup, ckpt


def kill_plan(plan_cls, rule_cls, name="g0w2", skip=4):
    return plan_cls([rule_cls(verb="gang", kind="Worker", name=name,
                              skip=skip, times=1, error="crash")])


# -- the kill arc on both packages --------------------------------------------

class JaxInitJob(ElasticTrainJob):
    """The port's job started from the JAX package's initial weights
    (``init_params(cfg, PRNGKey(init_seed))``, what the JAX supervisor
    draws), so both packages train the same model."""

    def build(self, dp, exclude_chips=frozenset(), tp=None):
        gang, step, init_state = super().build(dp, exclude_chips, tp)
        host = jax.tree.leaves(jax.tree.map(
            np.asarray, jt.init_params(JCFG, jax.random.PRNGKey(0))))

        def init_from_jax(generator=None):
            params, opt = init_state(generator)
            with torch.no_grad():
                for (_, t), v in zip(tt.named_tensors(params), host):
                    t.copy_(torch.from_numpy(np.array(v)))
            return params, opt

        return gang, step, init_from_jax


def test_kill_arc_equals_jax(tmp_path):
    """tests/test_supervisor.py's kill arc on both packages: a dp shard
    dies after 4 steps, the gang shrinks dp=4→2 and resumes from
    generation 4; equal transitions, recoveries and contract, losses
    within LOSS_RTOL, and the port held to that test's assertions."""
    jsup = jsv.GangSupervisor(
        jsv.ElasticTrainJob(JCFG, corpus(), batch=8, seq_len=16, tp=1),
        JTrainCheckpointer(tmp_path / "jckpt"),
        coordination_dir=tmp_path / "jcoord", dp=4,
        fault_plan=kill_plan(jfaults.FaultPlan, jfaults.FaultRule),
        checkpoint_every=2, step_deadline_s=30.0,
        first_step_deadline_s=240.0)
    jrep = jsup.run(8)
    jsup.ckpt.close()
    sup, ckpt = _supervisor(tmp_path, plan=kill_plan(FaultPlan, FaultRule),
                            job_cls=JaxInitJob)
    report = sup.run(8)
    ckpt.close()

    def recs(r):
        return [(x.cause, x.victims, x.from_dp, x.to_dp, x.restored_step,
                 x.steps_lost) for x in r.recoveries]

    assert report.transitions == jrep.transitions
    assert recs(report) == recs(jrep) == [("dead", ["g0w2"], 4, 2, 4, 0)]
    assert report.contract == jrep.contract
    assert json.loads((tmp_path / "coord" / sv.CONTRACT_FILENAME)
                      .read_text()) == json.loads(
        (tmp_path / "jcoord" / jsv.CONTRACT_FILENAME).read_text())
    assert [s for s, _ in report.losses] == [s for s, _ in jrep.losses] \
        == list(range(1, 9))
    np.testing.assert_allclose([l for _, l in report.losses],
                               [l for _, l in jrep.losses], rtol=LOSS_RTOL)

    rec = report.recoveries[0]
    assert rec.mttr_s > 0
    assert report.transitions == [sv.RUNNING, sv.SUSPECT, sv.EVICT,
                                  sv.REFORM, sv.RESUME, sv.RUNNING]
    assert_losses_exactly_once(report)
    losses = [l for _, l in report.losses]
    assert losses[-1] < min(losses[:4])
    contract = report.contract
    assert contract["num_workers"] == 2 and contract["generation"] == 1
    assert contract["excluded_chips"] == [2]       # dp row 2's chip
    reg = sup.metrics.registry
    assert reg.get_sample_value("tpu_train_restarts_total",
                                {"cause": "dead"}) == 1
    assert reg.get_sample_value("tpu_train_steps_lost_total") <= 2
    assert reg.get_sample_value("tpu_train_recovery_seconds_count") == 1
    assert reg.get_sample_value("tpu_train_dp_width") == 2
    assert reg.get_sample_value("tpu_train_supervisor_state",
                                {"state": sv.RUNNING}) == 1


def test_tp2_kill_arc_equals_jax(tmp_path):
    """The kill arc at the reference's default tp=2 on both packages,
    both saving through their ``ShardedCheckpointer``: equal
    transitions, recoveries and contract (each dp row owning two
    chips), losses within TP_LOSS_RTOL, and the generations written in
    the formation's tp layout — the port's manifests name JAX's shards,
    specs and bounds, parameter for parameter."""
    from k8s_dra_driver_tpu.parallel import resharding as jres
    jsup = jsv.GangSupervisor(
        jsv.ElasticTrainJob(JCFG, corpus(), batch=8, seq_len=16),
        jres.ShardedCheckpointer(tmp_path / "jckpt", keep=8),
        coordination_dir=tmp_path / "jcoord", dp=4,
        fault_plan=kill_plan(jfaults.FaultPlan, jfaults.FaultRule),
        checkpoint_every=2, step_deadline_s=30.0,
        first_step_deadline_s=240.0)
    jrep = jsup.run(8)
    ckpt = ShardedCheckpointer(tmp_path / "ckpt", keep=8,
                               rules=transformer_rules(TCFG))
    sup, _ = _supervisor(tmp_path, plan=kill_plan(FaultPlan, FaultRule),
                         job_cls=JaxInitJob, ckpt=ckpt, tp=2)
    report = sup.run(8)

    def recs(r):
        return [(x.cause, x.victims, x.from_dp, x.to_dp, x.restored_step,
                 x.steps_lost) for x in r.recoveries]

    assert report.transitions == jrep.transitions
    assert recs(report) == recs(jrep) == [("dead", ["g0w2"], 4, 2, 4, 0)]
    assert report.contract == jrep.contract
    assert report.contract["excluded_chips"] == [4, 5]   # row 2's chips
    assert [s for s, _ in report.losses] == [s for s, _ in jrep.losses]
    np.testing.assert_allclose([l for _, l in report.losses],
                               [l for _, l in jrep.losses],
                               rtol=TP_LOSS_RTOL)
    assert_losses_exactly_once(report)
    # generation 0 holds init_state's placement, the rules' on the
    # dp=4 x tp=2 mesh (a stepped JAX state sits where XLA placed the
    # step's outputs instead, so later generations are held by shape)
    jm = ckpt._read_manifest(tmp_path / "jckpt" / "step_00000000")
    tm = ckpt._read_manifest(ckpt.step_path(0))
    assert sorted(tm["leaves"]) == sorted(jm["leaves"])
    for name, ent in jm["leaves"].items():
        if name.startswith("params/"):
            got = tm["leaves"][name]
            assert got["spec"] == ent["spec"], name
            assert ([(sh["file"], sh["bounds"]) for sh in got["shards"]]
                    == [(sh["file"], sh["bounds"])
                        for sh in ent["shards"]]), name
    for step in (4, 8):
        tm = ckpt._read_manifest(ckpt.step_path(step))
        wq = tm["leaves"]["params/layers/0/wq"]["shards"]
        assert [sh["bounds"][1] for sh in wq] == [[0, 2], [2, 4]]


# -- failure arcs (port only, the JAX tests' assertions) ----------------------

def test_elastic_resume_after_injected_hang(tmp_path):
    plan = FaultPlan([FaultRule(verb="gang", kind="Worker", name="g0w1",
                                skip=2, times=1, error="hang",
                                latency_s=60.0)])
    sup, ckpt = _supervisor(tmp_path, plan=plan, step_deadline_s=2.0)
    t0 = time.monotonic()
    report = sup.run(6)
    ckpt.close()
    assert time.monotonic() - t0 < 60
    assert len(report.recoveries) == 1
    rec = report.recoveries[0]
    assert rec.cause == "wedged" and rec.victims == ["g0w1"]
    assert (rec.from_dp, rec.to_dp) == (4, 2)
    assert rec.restored_step == 2 and rec.steps_lost <= 2
    assert sv.SUSPECT in report.transitions
    assert [s for s, _ in report.losses] == list(range(1, 7))
    losses = [l for _, l in report.losses]
    assert losses[-1] < min(losses[:2])
    assert sup.metrics.registry.get_sample_value(
        "tpu_train_restarts_total", {"cause": "wedged"}) == 1


def test_health_down_signal_evicts_like_the_gateway(tmp_path):
    calls = {"n": 0}

    def health_source():
        calls["n"] += 1
        # chip 2 (dp row 2's) fails on the 4th poll
        return {2: "pcie link down"} if calls["n"] >= 4 else {}

    sup, ckpt = _supervisor(tmp_path, health_source=health_source)
    report = sup.run(6)
    ckpt.close()
    assert len(report.recoveries) == 1
    rec = report.recoveries[0]
    assert rec.cause == "health" and rec.victims == ["g0w2"]
    assert rec.to_dp == 2
    assert sup.metrics.registry.get_sample_value(
        "tpu_train_restarts_total", {"cause": "health"}) == 1


def test_attach_subscribes_to_health_monitor_listeners():
    class StubMonitor:
        def __init__(self):
            self.listeners = []

    sup = GangSupervisor.__new__(GangSupervisor)
    sup._unhealthy = {}
    sup._unhealthy_lock = threading.Lock()
    monitor = StubMonitor()
    sup.attach(monitor)
    assert monitor.listeners == [sup.on_health]
    monitor.listeners[0]({3: "gone"})
    assert sup._unhealthy == {3: "gone"}


def test_unrecoverable_gang_fails_explicitly(tmp_path):
    plan = FaultPlan([
        FaultRule(verb="gang", kind="Worker", name="g0w1", skip=1,
                  times=1, error="crash"),
        FaultRule(verb="gang", kind="Worker", name="g1w0", skip=1,
                  times=1, error="crash")])
    sup, ckpt = _supervisor(tmp_path, dp=2, batch=4, plan=plan)
    with pytest.raises(sv.SupervisorError, match="no dp width"):
        sup.run(10)
    ckpt.close()
    assert sup.transitions[-1] == sv.FAILED
    assert len(sup.recoveries) == 1
    assert sup.recoveries[0].to_dp == 1


def test_shrink_rule_is_power_of_two_that_divides_batch(tmp_path):
    sup, ckpt = _supervisor(tmp_path)
    assert [sup._shrunk_dp(n) for n in (1, 2, 3, 4)] == [2, 2, 1, 0]
    sup.dp = 1
    assert sup._shrunk_dp(1) == 0
    ckpt.close()


def test_torn_latest_generation_falls_back_to_previous(tmp_path):
    _, step, init_state = _job().build(2)
    params, opt = init_state(torch.Generator().manual_seed(0))
    ckpt = TrainCheckpointer(tmp_path / "ckpt", keep=3)
    ckpt.save(1, params, opt, extra={"epoch": 0, "step": 1})
    ckpt.save(2, params, opt, extra={"epoch": 0, "step": 2})

    def truncate(step_no):
        for p in (tmp_path / "ckpt" / str(step_no)).rglob("*"):
            if p.is_file():
                p.write_bytes(b"")

    truncate(2)
    p2, o2 = init_state(torch.Generator().manual_seed(7))
    restored, _, at = ckpt.restore(p2, o2)
    assert at == 1
    assert torch.equal(restored["embed"], params["embed"])
    assert ckpt.restore_extra(at) == {"epoch": 0, "step": 1}
    with pytest.raises(Exception):
        ckpt.restore(p2, o2, step=2)
    truncate(1)
    with pytest.raises(FileNotFoundError, match="no restorable"):
        ckpt.restore(p2, o2)
    ckpt.close()


def test_transition_listeners_fire_without_polling():
    sup = GangSupervisor.__new__(GangSupervisor)
    sup.state = sv.RUNNING
    sup.transitions = [sv.RUNNING]
    sup.metrics = RecoveryMetrics()
    sup.dp, sup._step, sup._gen = 4, 7, 1
    seen, seen2 = [], []
    sup.listeners = [
        lambda s, info: seen.append((s, info["dp"], info["step"])),
        lambda s, info: 1 / 0,
        lambda s, info: seen2.append(s)]
    sup._transition(sv.SUSPECT)
    sup._transition(sv.REFORM)
    assert seen == [(sv.SUSPECT, 4, 7), (sv.REFORM, 4, 7)]
    assert seen2 == [sv.SUSPECT, sv.REFORM]
    assert sup.transitions == [sv.RUNNING, sv.SUSPECT, sv.REFORM]
    assert sup.state == sv.REFORM


# -- the external verbs ----------------------------------------------------------

def test_request_width_validates_statically(tmp_path):
    sup, ckpt = _supervisor(tmp_path)
    with pytest.raises(ValueError, match="dp must be"):
        sup.request_width(0)
    with pytest.raises(ValueError, match="does not divide"):
        sup.request_width(3)
    with pytest.raises(ValueError, match="tp must be"):
        sup.request_width(2, tp=0)
    # tp re-aims with the width (the reference's default is 2) ...
    sup.request_width(2, tp=2)
    assert sup._requested == ("width", 2, 2, None)
    job = ElasticTrainJob(TCFG, corpus(), batch=8, seq_len=16,
                          device="cpu")
    assert job.tp == 2
    gang, _, _ = job.build(4)
    assert gang.devices.tolist() == [[0, 1], [2, 3], [4, 5], [6, 7]]
    # ... and a width the slots cannot hold still raises at formation
    with pytest.raises(sv.SupervisorError, match="dp=4 tp=4: need 16"):
        job.build(4, tp=4)
    assert job.tp == 2
    sup.request_width(2)
    sup.request_width(4)
    assert sup._requested == ("width", 4, None, None)
    sup.park()
    assert sup._requested == ("park",)
    sup.request_width(4, exclude=[6, 7])
    assert sup._requested == ("width", 4, None, frozenset({6, 7}))
    ckpt.close()


def test_build_refuses_too_few_slots_with_the_reference_message():
    job = _job(chips=4)
    with pytest.raises(sv.SupervisorError) as err:
        job.build(4, exclude_chips=frozenset({1}))
    assert str(err.value) == ("cannot form dp=4 tp=1: need 4 devices, "
                              "3 survive eviction")
    gang, _, _ = job.build(2, exclude_chips=frozenset({0}))
    assert gang.devices.tolist() == [[1], [2]]
    assert (gang.dp, gang.tp) == (2, 1)


def test_readmit_is_the_heal_twin_of_eviction(tmp_path):
    sup, ckpt = _supervisor(tmp_path)
    sup._dead_chips = {4, 5}
    sup._unhealthy = {4: "pcie link down"}
    sup.readmit([4])
    assert sup._dead_chips == {5} and sup._unhealthy == {}
    ckpt.close()


def test_external_resize_preempt_then_expand(tmp_path):
    sup, ckpt = _supervisor(tmp_path, chips=4)
    sup.begin(8)
    while sup._step < 2:
        sup.step_once()
    sup.request_width(2)
    sup.step_once()
    assert sup.dp == 2
    assert sup.transitions[-4:] == [sv.RUNNING, sv.REFORM, sv.RESUME,
                                    sv.RUNNING]
    while sup._step < 4:
        sup.step_once()
    sup.request_width(4)
    sup.step_once()
    assert sup.dp == 4 and sv.EXPAND in sup.transitions
    # transiently infeasible (dp=8 > 4 slots): dropped, gang intact
    sup.request_width(8)
    sup.step_once()
    assert sup.dp == 4 and sup.state == sv.RUNNING
    while sup.step_once():
        pass
    report = sup.report()
    ckpt.close()
    assert [r.cause for r in report.recoveries] == ["preempt", "expand"]
    assert [(r.from_dp, r.to_dp) for r in report.recoveries] \
        == [(4, 2), (2, 4)]
    assert all(r.steps_lost == 0 for r in report.recoveries)
    assert_losses_exactly_once(report)
    assert [s for s, _ in report.losses] == list(range(1, 9))
    reg = sup.metrics.registry
    for cause in ("preempt", "expand"):
        assert reg.get_sample_value("tpu_train_restarts_total",
                                    {"cause": cause}) == 1
    assert reg.get_sample_value("tpu_train_dp_width") == 4


def test_concurrent_resize_queues_and_coalesces(tmp_path):
    sup, ckpt = _supervisor(tmp_path, dp=2)
    sup.begin(16)
    sup.step_once()
    sup.step_once()
    base = list(sup.transitions)
    steps_before = sup._step
    sup.request_width(2)
    sup.step_once()
    assert sup.transitions == base and sup._step == steps_before + 1
    sup.request_width(1)
    sup.request_width(1)
    sup.step_once()
    assert sup.transitions[len(base):] == [sv.REFORM, sv.RESUME,
                                           sv.RUNNING]
    assert sup.dp == 1
    sup.step_once()
    assert sup.transitions[len(base) + 3:] == []
    issued = []

    def mid_reform_request(state, info):
        if state == sv.REFORM and not issued:
            issued.append(True)
            sup.request_width(1)

    sup.listeners.append(mid_reform_request)
    marker = len(sup.transitions)
    sup.request_width(2)
    sup.step_once()
    assert sup.transitions[marker:] == [sv.EXPAND, sv.REFORM, sv.RESUME,
                                        sv.RUNNING]
    assert sup.dp == 2 and issued == [True]
    sup.step_once()
    assert sup.transitions[marker + 4:] == [sv.REFORM, sv.RESUME,
                                            sv.RUNNING]
    assert sup.dp == 1
    sup.listeners.clear()
    while sup.step_once():
        pass
    report = sup.report()
    ckpt.close()
    assert all(r.steps_lost == 0 for r in report.recoveries)
    assert_losses_exactly_once(report)


def test_park_releases_chips_and_unparks_losslessly(tmp_path):
    sup, ckpt = _supervisor(tmp_path, dp=2)
    sup.begin(10)
    for _ in range(3):
        sup.step_once()
    held = weakref.ref(sup.params["embed"])
    sup.park()
    assert sup.step_once() is True
    assert sup.state == sv.PARKED
    assert sup.dp == 0 and sup.workers == []
    assert sup.params is None and sup.opt is None
    assert held() is None          # the parked gang holds no tensors
    assert sup.contract["parked"] is True
    assert sup.contract["num_workers"] == 0
    reg = sup.metrics.registry
    assert reg.get_sample_value("tpu_train_dp_width") == 0
    assert reg.get_sample_value("tpu_train_restarts_total",
                                {"cause": "park"}) == 1
    before = sup._step
    assert sup.step_once() is True and sup._step == before
    sup.request_width(2)
    sup.step_once()
    assert sup.state == sv.RUNNING and sup.dp == 2
    assert sv.EXPAND in sup.transitions
    while sup.step_once():
        pass
    report = sup.report()
    ckpt.close()
    assert [r.cause for r in report.recoveries] == ["park", "expand"]
    assert [(r.from_dp, r.to_dp) for r in report.recoveries] \
        == [(2, 0), (0, 2)]
    assert all(r.steps_lost == 0 for r in report.recoveries)
    assert_losses_exactly_once(report)
    assert [s for s, _ in report.losses] == list(range(1, 11))


@pytest.mark.parametrize("fmt", ["train", "sharded"])
def test_resize_and_park_at_a_checkpoint_step(tmp_path, fmt):
    """A controlled resize, a park and an unpark that all land on a
    checkpoint step save that step again: the second save keeps the
    first generation, and the arc loses nothing."""
    ckpt = (TrainCheckpointer(tmp_path / "ckpt") if fmt == "train"
            else ShardedCheckpointer(tmp_path / "ckpt", keep=2))
    sup, _ = _supervisor(tmp_path, dp=4, ckpt=ckpt)
    sup.begin(8)
    while sup._step < 2:
        sup.step_once()
    for op in (lambda: sup.request_width(2), sup.park,
               lambda: sup.request_width(4)):
        op()
        sup.step_once()
    assert sup.state == sv.RUNNING and sup.dp == 4
    while sup.step_once():
        pass
    report = sup.report()
    ckpt.close()
    assert [r.cause for r in report.recoveries] == ["preempt", "park",
                                                    "expand"]
    assert [r.restored_step for r in report.recoveries] == [2, 2, 2]
    assert all(r.steps_lost == 0 for r in report.recoveries)
    assert [s for s, _ in report.losses] == list(range(1, 9))


def test_placement_exclusion_fences_the_formation(tmp_path):
    sup, ckpt = _supervisor(tmp_path, dp=1,
                            placement_exclude=[0, 1, 2, 3])
    sup.begin(4)
    sup.step_once()
    chips = {c for w in sup.workers for c in w.chips}
    assert chips <= {4, 5, 6, 7}
    assert sup.contract["placement_excluded"] == [0, 1, 2, 3]
    sup.request_width(1, exclude=[c for c in range(8) if c not in (0, 1)])
    sup.step_once()
    assert {c for w in sup.workers for c in w.chips} == {0}
    sup.readmit([5])
    assert 5 in sup._placement_excluded
    ckpt.close()


# -- the dp rows: placement, not math ------------------------------------------

def test_dp_rows_are_placement_not_math():
    """One step of the gang's row step at dp = 1, 2, 4 against the
    port's single-device step: the same loss and parameters within
    rounding."""
    job = _job()
    b = np.random.default_rng(3).integers(0, 64, (8, 16)).astype(np.int32)
    ref_step, ref_init = tt.make_train_step(TCFG, device="cpu")
    params, opt = ref_init(torch.Generator().manual_seed(0))
    _, _, ref_loss = ref_step(params, opt, b)
    for dp in (1, 2, 4):
        _, step, init_state = job.build(dp)
        p, o = init_state(torch.Generator().manual_seed(0))
        _, _, loss = step(p, o, b)
        np.testing.assert_allclose(float(loss), float(ref_loss),
                                   rtol=1e-6)
        for (_, x), (_, y) in zip(tt.named_tensors(p),
                                  tt.named_tensors(params)):
            torch.testing.assert_close(x, y, rtol=0, atol=3e-6)


def _gang_state(dp):
    _, step, init_state = _job().build(dp)
    params, opt = init_state(torch.Generator().manual_seed(0))
    return step, params, opt


def batches(n, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, (8, 16)).astype(np.int32) for _ in range(n)]


def test_resume_continues_exact_trajectory(tmp_path):
    step, params, opt = _gang_state(2)
    data = batches(5)
    ckpt = TrainCheckpointer(tmp_path / "ckpt")
    for b in data[:3]:
        params, opt, _ = step(params, opt, b)
    ckpt.save(3, params, opt)
    ref = []
    for b in data[3:]:
        params, opt, loss = step(params, opt, b)
        ref.append(float(loss))
    _, params2, opt2 = _gang_state(2)
    torch.nn.init.zeros_(params2["embed"].data)
    params2, opt2, at = ckpt.restore(params2, opt2)
    assert at == 3
    got = []
    for b in data[3:]:
        params2, opt2, loss = step(params2, opt2, b)
        got.append(float(loss))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    ckpt.close()


def test_restore_onto_a_different_width(tmp_path):
    """Written at dp=4, restored at dp=2: one more step equals the
    dp=4 gang's next step."""
    step4, params, opt = _gang_state(4)
    params, opt, _ = step4(params, opt, batches(1)[0])
    ckpt = ShardedCheckpointer(tmp_path / "ckpt")
    ckpt.save(1, params, opt)
    step2, params2, opt2 = _gang_state(2)
    params2, opt2, at = ckpt.restore(params2, opt2)
    assert at == 1
    nxt = batches(2)[1]
    _, _, ref = step4(params, opt, nxt)
    _, _, got = step2(params2, opt2, nxt)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    ckpt.close()


def test_latest_retention_and_missing(tmp_path):
    _, params, opt = _gang_state(2)
    ckpt = TrainCheckpointer(tmp_path / "ckpt", keep=2)
    for s in (1, 2, 3):
        ckpt.save(s, params, opt)
    assert ckpt.latest_step() == 3 and ckpt.all_steps() == [2, 3]
    assert ckpt.restore(params, opt)[2] == 3
    ckpt.close()
    empty = ShardedCheckpointer(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        empty.restore(params, opt)


@pytest.mark.parametrize("damage", ["bitflip", "truncate", "missing"])
def test_corrupt_generation_plus_kill_falls_back_and_resumes(
        damage, tmp_path):
    """tests/test_resharding.py's supervised arc on the port: the newest
    generation is damaged at eviction, a dp worker is killed, and the
    run resumes from the previous generation, every step once."""
    ckpt = ShardedCheckpointer(tmp_path / "ckpt")
    sup, _ = _supervisor(tmp_path, dp=2, batch=4, ckpt=ckpt,
                         plan=kill_plan(FaultPlan, FaultRule, "g0w1", 5))
    hit = {}

    def corrupt_newest(state, info):
        if state != sv.EVICT or hit:
            return
        step = ckpt.latest_step()
        victim = max(ckpt.step_path(step).glob("*.bin"),
                     key=lambda p: p.stat().st_size)
        if damage == "bitflip":
            tfaults.corrupt_file(victim, tfaults.CORRUPT_BITFLIP, seed=1)
        elif damage == "truncate":
            tfaults.corrupt_file(victim, tfaults.CORRUPT_TRUNCATE, seed=1)
        else:
            victim.unlink()
        hit["step"] = step

    sup.listeners.append(corrupt_newest)
    report = sup.run(8)
    assert hit["step"] == 4
    assert len(report.recoveries) == 1
    rec = report.recoveries[0]
    assert rec.cause == "dead" and (rec.from_dp, rec.to_dp) == (2, 1)
    assert rec.restored_step == 2 and rec.steps_lost <= 4
    assert report.steps == 8 and report.transitions[-1] == sv.RUNNING
    assert_losses_exactly_once(report)
    assert all(np.isfinite(l) for _, l in report.losses)


# -- as_global ---------------------------------------------------------------

def test_as_global_without_a_process_mesh(tmp_path):
    b = np.arange(32, dtype=np.int32).reshape(4, 8)
    gang, _, _ = _job().build(2)
    for mesh in (None, gang):
        out = as_global(b, mesh)
        assert isinstance(out, torch.Tensor)
        np.testing.assert_array_equal(out.numpy(), b)


def test_as_global_gathers_the_stripes_over_dp(tmp_path):
    import torch_dist
    b = np.arange(64, dtype=np.int32).reshape(8, 8)
    outs = torch_dist.run_group(torch_dist.as_global_worker, 2, b,
                                out_dir=tmp_path)
    for out in outs:
        np.testing.assert_array_equal(out, b)
