"""The gang half of the port's fleet reconcilers (k8s_dra_driver_tpu_torch/
fleet/reconciler.py, fleet/tenancy.py) run against the port's real gang
supervisor (parallel/supervisor.py), and the fleet probes that drive
them (fleet/probe.py), on the CPU in f32.

Both packages run the same scripts with an injected clock: the 1x1
acceptance of tests/test_fleet.py (a burst preempts the dp=4 gang to
dp=2, a replica lands on the freed chips, calm regrows the gang through
EXPAND) and the tenancy cascade of tests/test_tenancy.py (hi's burst
parks the floor-zero lo gang, then shrinks mid to its floor, and calm
regrows mid and lo in priority order).  The action sequences, the
gangs' recoveries and transitions, the request outcomes and the fleet
metrics must be equal, and the port is held to the JAX tests' own
assertions.  Serving engines on both sides hold the same weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from invariants import assert_losses_exactly_once

from k8s_dra_driver_tpu import fleet as jf
from k8s_dra_driver_tpu import gateway as jg
from k8s_dra_driver_tpu.models import checkpoint as jck
from k8s_dra_driver_tpu.models import serving as js
from k8s_dra_driver_tpu.models import transformer as jt
from k8s_dra_driver_tpu.parallel import supervisor as jsv
from k8s_dra_driver_tpu_torch import fleet as tf
from k8s_dra_driver_tpu_torch import gateway as tg
from k8s_dra_driver_tpu_torch.models import checkpoint as tck
from k8s_dra_driver_tpu_torch.models import serving as ts
from k8s_dra_driver_tpu_torch.models import transformer as tt
from k8s_dra_driver_tpu_torch.models.convert import params_from_jax
from k8s_dra_driver_tpu_torch.parallel import supervisor as tsv

pytestmark = pytest.mark.timeout_s(300)

FIELDS = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
              d_ff=64, max_seq=48, n_kv_heads=2)
JCFG = jt.TransformerConfig(dtype=jnp.float32, **FIELDS)
TCFG = tt.TransformerConfig(dtype=torch.float32, **FIELDS)

#: (fleet, gateway, serving, supervisor, checkpoint, config)
SIDES = {"jax": (jf, jg, js, jsv, jck, JCFG),
         "torch": (tf, tg, ts, tsv, tck, TCFG)}


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(np.asarray,
                      jt.init_params(JCFG, jax.random.PRNGKey(0)))
    return {"jax": jp, "torch": params_from_jax(jp, device="cpu")}


def prompt(seed, n):
    return np.random.default_rng(seed).integers(
        0, FIELDS["vocab"], n).astype(np.int32)


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def samples(metrics) -> list[str]:
    return [ln for ln in metrics.render().decode().splitlines()
            if "_created" not in ln and "seconds" not in ln]


def engine_factory(side, params):
    _, _, srv, _, _, cfg = SIDES[side]
    extra = {} if side == "jax" else {"device": "cpu"}
    return lambda name: srv.ServingEngine(params[side], cfg, slots=2,
                                          **extra)


def gang(side, tmp_path, name, *, dp, batch, **kw):
    _, _, _, sv, ck, cfg = SIDES[side]
    motif = np.random.default_rng(0).integers(0, 64, 32)
    extra = {} if side == "jax" else {"device": "cpu"}
    job = sv.ElasticTrainJob(cfg, np.tile(motif, 64), batch=batch,
                             seq_len=16, tp=1, **extra)
    ckpt = ck.TrainCheckpointer(tmp_path / side / f"ckpt-{name}")
    sup = sv.GangSupervisor(
        job, ckpt, coordination_dir=tmp_path / side / f"coord-{name}",
        dp=dp, checkpoint_every=2, step_deadline_s=120.0,
        first_step_deadline_s=600.0, **kw)
    return sup, ckpt


def gang_record(sup):
    return dict(
        recoveries=[(r.cause, r.victims, r.from_dp, r.to_dp,
                     r.restored_step, r.steps_lost) for r in sup.recoveries],
        transitions=list(sup.transitions),
        steps=[s for s, _ in sup.losses], dp=sup.dp, state=sup.state,
        contract=sup.contract)


# -- 1x1: burst preempts, calm regrows ----------------------------------------

def fleet_acceptance(side, params, tmp_path):
    f, g, srv, sv, _, _ = SIDES[side]
    clock = Clock()
    sup, ckpt = gang(side, tmp_path, "g", dp=4, batch=8)
    mgr = g.ReplicaManager(engine_factory(side, params), replicas=2,
                           chip_of=lambda name: 4 + int(name[1:]),
                           depth_bound=2)
    gw = g.FleetGateway(mgr, queue_capacity=64, clock=clock,
                        auto_replace=False)
    rec = f.FleetReconciler(
        gw, sup, ledger=f.ChipLedger([0, 1, 2, 3, 4, 5]),
        policy=f.FleetPolicy(f.PolicyConfig(
            queue_high=4, up_after=2, down_after=3, regrow_after=3,
            min_replicas=2, max_replicas=3, min_train_dp=2,
            arrival_low_rps=0.5)), clock=clock)
    assert rec.policy.train_target_dp == 4
    sup.begin(10_000)
    live = True

    def pump():
        nonlocal live
        gw.step()
        live = sup.step_once() if live else False
        rec.tick()
        clock.advance(1.0)

    wave1 = [srv.Request(uid=f"a{i}", prompt=prompt(100 + i, 5),
                         max_new=3) for i in range(16)]
    for r in wave1:
        gw.submit(r, slo_s=6.0)
    for _ in range(60):
        pump()
        if not len(gw.queue) and not any(r.in_flight
                                         for r in mgr.replicas):
            break
    violated = sorted(o.uid for o in gw.outcomes.values()
                      if o.status == "shed_expired"
                      or (o.status == "finished"
                          and o.finished_s > o.deadline_s))
    wave2 = [srv.Request(uid=f"b{i}", prompt=prompt(200 + i, 5),
                         max_new=3) for i in range(4)]
    for r in wave2:
        gw.submit(r, slo_s=6.0)
    for _ in range(30):
        pump()
        if all(r.uid in gw.outcomes for r in wave2):
            break
    for _ in range(60):
        pump()
        exp = [r for r in sup.recoveries if r.cause == "expand"]
        if exp and sup.dp == 4 and sup.state == sv.RUNNING \
                and sup._step > exp[0].restored_step:
            break
    ckpt.close()
    return dict(
        events=list(rec.events), violated=violated, gang=gang_record(sup),
        outcomes={u: (o.status, o.replica, o.finished_s <= o.deadline_s
                      if o.status == "finished" else None)
                  for u, o in sorted(gw.outcomes.items())},
        tokens={u: np.asarray(r.tokens).tolist()
                for u, r in sorted(gw.results.items())},
        fleet=samples(rec.metrics), train=samples(sup.metrics)), sup


def test_acceptance_burst_preempts_then_calm_regrows(params, tmp_path):
    got, sup = fleet_acceptance("torch", params, tmp_path)
    want, _ = fleet_acceptance("jax", params, tmp_path)
    assert got == want
    # tests/test_fleet.py's assertions, on the port
    assert got["violated"], "burst never violated the SLO"
    recs = got["gang"]["recoveries"]
    assert [r[0] for r in recs] == ["preempt", "expand"]
    assert [(r[2], r[3]) for r in recs] == [(4, 2), (2, 4)]
    assert all(r[5] == 0 for r in recs)
    ups = [(t, i) for t, k, i in got["events"] if k == "scale_up"]
    pres = [t for t, k, i in got["events"] if k == "preempt"]
    assert len(ups) == 1 and len(pres) == 1 and pres[0] < ups[0][0]
    assert ups[0][1]["chip"] in (2, 3)
    assert any(rep == ups[0][1]["replica"] and st == "finished"
               for st, rep, _ in got["outcomes"].values())
    assert all(got["outcomes"][f"b{i}"][::2] == ("finished", True)
               for i in range(4))
    assert tsv.EXPAND in got["gang"]["transitions"]
    assert got["gang"]["dp"] == 4
    steps = got["gang"]["steps"]
    assert steps == list(range(1, len(steps) + 1)) and len(steps) >= 6
    assert_losses_exactly_once(sup)
    assert len(got["outcomes"]) == 20
    for action in ("up", "preempt", "regrow"):
        assert (f'tpu_fleet_scale_events_total{{action="{action}"}} 1.0'
                in got["fleet"]), action
    assert 'tpu_fleet_chips{owner="training"} 4.0' in got["fleet"]
    assert 'tpu_train_restarts_total{cause="preempt"} 1.0' in got["train"]
    assert 'tpu_train_restarts_total{cause="expand"} 1.0' in got["train"]
    assert "tpu_train_dp_width 4.0" in got["train"]


# -- N x N: the tenancy cascade ----------------------------------------------

def cascade(side, params, tmp_path):
    f, g, srv, sv, _, _ = SIDES[side]
    clock = Clock()
    sup_lo, ck_lo = gang(side, tmp_path, "lo", dp=2, batch=4,
                         placement_exclude=[c for c in range(8)
                                            if c not in (0, 1)])
    sup_mid, ck_mid = gang(side, tmp_path, "mid", dp=4, batch=8,
                           placement_exclude=[c for c in range(8)
                                              if c not in (2, 3, 4, 5)])
    mgr = g.ReplicaManager(engine_factory(side, params), replicas=2,
                           chip_of=lambda name: 6 + int(name[1:]),
                           depth_bound=2)
    gw = g.FleetGateway(mgr, queue_capacity=64, clock=clock,
                        auto_replace=False, tenant="hi")
    ledger = f.ChipLedger(list(range(8)))
    registry = f.TenantRegistry(capacity=8)
    registry.add(f.TenantSpec("hi", priority=3, quota=6, floor=2),
                 f.ServingTenant(gw))
    registry.add(f.TenantSpec("mid", priority=2, quota=4, floor=2),
                 f.TrainingTenant(sup_mid, target_dp=4))
    registry.add(f.TenantSpec("lo", priority=1, quota=2, floor=0),
                 f.TrainingTenant(sup_lo, target_dp=2))
    rec = f.MultiTenantReconciler(
        registry, ledger=ledger,
        packer=f.TopologyBinPacker(ledger, domain_size=2),
        config=f.MtConfig(queue_high=4, up_after=2, down_after=3,
                          regrow_after=3, arrival_low_rps=0.5),
        clock=clock)
    sup_lo.begin(10_000)
    sup_mid.begin(10_000)
    live = {"lo": True, "mid": True}
    held = []

    def pump():
        gw.step()
        for name, sup in (("lo", sup_lo), ("mid", sup_mid)):
            if live[name]:
                live[name] = sup.step_once()
        rec.tick()
        clock.advance(1.0)
        held.append((sup_mid.state, len({c for w in sup_mid.workers
                                         if w.alive for c in w.chips}),
                     len([r for r in mgr.replicas if r.state != "dead"])))

    wave = [srv.Request(uid=f"a{i}", prompt=prompt(100 + i, 5),
                        max_new=3) for i in range(24)]
    for r in wave:
        gw.submit(r, slo_s=120.0)
    rider = [srv.Request(uid=f"b{i}", prompt=prompt(300 + i, 5),
                         max_new=3) for i in range(8)]
    for r in rider:
        gw.submit(r, slo_s=2.0, tenant="batch")
    for _ in range(80):
        pump()
        if (not len(gw.queue)
                and not any(r.in_flight for r in mgr.replicas)
                and sup_lo.state == sv.PARKED and sup_mid.dp == 2):
            break
    for _ in range(120):
        pump()
        exp_mid = [r for r in sup_mid.recoveries if r.cause == "expand"]
        exp_lo = [r for r in sup_lo.recoveries if r.cause == "expand"]
        if (exp_mid and exp_lo and sup_mid.dp == 4 and sup_lo.dp == 2
                and sup_lo.state == sv.RUNNING
                and sup_mid.state == sv.RUNNING
                and sup_lo._step > exp_lo[0].restored_step
                and sup_mid._step > exp_mid[0].restored_step):
            break
    ck_lo.close()
    ck_mid.close()
    return dict(
        events=list(rec.events), held=held,
        lo=gang_record(sup_lo), mid=gang_record(sup_mid),
        outcomes={u: (o.status, o.replica)
                  for u, o in sorted(gw.outcomes.items())},
        fleet=samples(rec.metrics)), (sup_lo, sup_mid)


def test_acceptance_cascade_across_two_tenants(params, tmp_path):
    got, (sup_lo, sup_mid) = cascade("torch", params, tmp_path)
    want, _ = cascade("jax", params, tmp_path)
    assert got == want
    # tests/test_tenancy.py's assertions, on the port
    kinds = [(k, i.get("tenant")) for _, k, i in got["events"]]
    assert kinds.index(("reclaim_park", "lo")) \
        < kinds.index(("reclaim_shrink", "mid"))
    assert ("reclaim_shrink", "lo") not in kinds
    assert got["lo"]["recoveries"][0][0] == "park"
    pre = [r for r in got["mid"]["recoveries"] if r[0] == "preempt"]
    assert len(pre) == 1 and (pre[0][2], pre[0][3]) == (4, 2)
    grants = [i for _, k, i in got["events"] if k == "grant"]
    assert len(grants) >= 3
    chips = {g["chip"] for g in grants}
    assert chips <= {0, 1, 4, 5} and {0, 1} <= chips
    names = {g["replica"] for g in grants}
    assert any(st == "finished" and rep in names
               for st, rep in got["outcomes"].values())
    assert all(got["outcomes"][f"a{i}"][0] == "finished"
               for i in range(24))
    assert all(got["outcomes"][f"b{i}"][0] == "shed_expired"
               for i in range(8))
    exp_mid = [r for r in got["mid"]["recoveries"] if r[0] == "expand"]
    exp_lo = [r for r in got["lo"]["recoveries"] if r[0] == "expand"]
    assert len(exp_mid) == 1 and (exp_mid[0][2], exp_mid[0][3]) == (2, 4)
    assert len(exp_lo) == 1 and (exp_lo[0][2], exp_lo[0][3]) == (0, 2)
    assert tsv.PARKED in got["lo"]["transitions"]
    assert tsv.EXPAND in got["mid"]["transitions"]
    regrows = [i.get("tenant") for _, k, i in got["events"]
               if k == "regrow"]
    assert regrows[:2] == ["mid", "lo"]
    # floors and quota held at every sampled tick
    assert all(state == tsv.PARKED or mid >= 2
               for state, mid, _ in got["held"])
    assert all(2 <= hi <= 6 for _, _, hi in got["held"])
    for name, sup in (("lo", sup_lo), ("mid", sup_mid)):
        assert_losses_exactly_once(sup, name)
        assert all(r.steps_lost == 0 for r in sup.recoveries), name
    for tenant, action in (("lo", "reclaim_park"), ("mid", "reclaim_shrink"),
                           ("mid", "regrow"), ("lo", "regrow")):
        assert (f'tpu_fleet_mt_actions_total{{action="{action}",'
                f'tenant="{tenant}"}} 1.0' in got["fleet"]), (tenant, action)
    assert 'tpu_fleet_tenant_chips{tenant="mid"} 4.0' in got["fleet"]


# -- the packer over a real gang, and the probes ----------------------------

def test_regrow_width_counts_own_chips(tmp_path):
    """tests/test_tenancy.py's regrow-width case with the gang's chips
    synced into the ledger from a running port supervisor (dp=2 on
    chips 0 and 1), on both packages' packers."""
    sup, ckpt = gang("torch", tmp_path, "g", dp=2, batch=8)
    sup.begin(4)
    sup.step_once()
    widths = []
    for f in (jf, tf):
        led = f.ChipLedger(list(range(8)))
        led.owners[6] = f.serving_tag("s", "r0")
        led.owners[7] = f.serving_tag("s", "r1")
        for w in sup.workers:
            for c in w.chips:
                led.owners[c] = f.training_tag("g")
        packer = f.TopologyBinPacker(led, domain_size=2)
        widths.append((packer.regrow_width("g", tp=1, target_dp=8),
                       packer.regrow_width("g", tp=2, target_dp=4)))
    ckpt.close()
    assert widths[0] == widths[1] == (4, 2)


@pytest.mark.parametrize("probe", ["fleet_probe", "multitenant_probe"])
def test_fleet_probes_are_valid_on_the_cpu(probe):
    out = getattr(tf, probe)(device="cpu")
    assert out["valid"], out
    # the reference's defaults: fleet_probe's gang at tp=2
    assert out["tp"] == (2 if probe == "fleet_probe" else 1)
    assert out["recovery_causes"] in (["preempt", "expand"],
                                      ["park", "expand"])
    assert out["steps_lost"] == [0, 0] and out["exactly_once"]


def test_recovery_probe_is_valid_on_the_cpu():
    from k8s_dra_driver_tpu_torch.parallel import recovery_probe
    out = recovery_probe(device="cpu")
    assert out["valid"], out
    assert out["tp"] == 2
    assert [r["cadence"] for r in out["runs"]] == [1, 4]
    assert all(r["dp_from"] == 2 and r["dp_to"] == 1 for r in out["runs"])
    assert out["steps_lost_worst"] <= 4
