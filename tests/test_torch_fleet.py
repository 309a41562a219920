"""Port fleet control loop (k8s_dra_driver_tpu_torch/fleet/: policy,
supply, binpack, reconciler, probe; utils/httpendpoint.py;
``FleetMetrics``) against the JAX package's, on the CPU in f32.

Every scenario is written once and run on both packages: the chip
ledger (tests/test_fleet.py's ``TestChipLedger``, ``from_backend``
over a stub backend on both sides), the hysteresis policy
(``TestFleetPolicy``), the gateway's arrival-rate EWMA, the
reconciler's actuation over stub engines (``TestReconcilerActuation``)
and a 1x1 loop over real engines — a burst under a tight SLO, calm, a
chip fault and its heal, with the burn-rate engine, ``MemWatch`` and a
tracer attached — must give equal action lists, events, ledger views,
greedy streams and rendered ``FleetMetrics`` (all but ``_created``).
The reconciler's ``readmit`` / ``request_width`` go to a stub here;
tests/test_torch_fleet_gang.py runs them against real supervisors.
"""

import threading
from urllib.request import urlopen

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu import fleet as jf
from k8s_dra_driver_tpu import gateway as jg
from k8s_dra_driver_tpu.cluster import bus as jbus
from k8s_dra_driver_tpu.fleet.probe import (
    fragmentation_probe as j_fragmentation_probe)
from k8s_dra_driver_tpu.gateway import burnrate as jburn
from k8s_dra_driver_tpu.models import serving as js
from k8s_dra_driver_tpu.models import transformer as jt
from k8s_dra_driver_tpu.utils import memwatch as jmw
from k8s_dra_driver_tpu.utils import tracing as jtr
from k8s_dra_driver_tpu_torch import fleet as tf
from k8s_dra_driver_tpu_torch import gateway as tg
from k8s_dra_driver_tpu_torch.cluster import bus as tbus
from k8s_dra_driver_tpu_torch.gateway import burnrate as tburn
from k8s_dra_driver_tpu_torch.models import serving as ts
from k8s_dra_driver_tpu_torch.models import transformer as tt
from k8s_dra_driver_tpu_torch.models.convert import params_from_jax
from k8s_dra_driver_tpu_torch.utils import memwatch as tmw
from k8s_dra_driver_tpu_torch.utils import tracing as ttr
from k8s_dra_driver_tpu_torch.utils.httpendpoint import HTTPEndpoint

pytestmark = pytest.mark.timeout_s(180)

FIELDS = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
              d_ff=64, max_seq=48, n_kv_heads=2)
JCFG = jt.TransformerConfig(dtype=jnp.float32, **FIELDS)
TCFG = tt.TransformerConfig(dtype=torch.float32, **FIELDS)

#: the two packages, side by side: (fleet, gateway, serving, bus,
#: burn-rate, memwatch, tracing)
SIDES = {"jax": (jf, jg, js, jbus, jburn, jmw, jtr),
         "torch": (tf, tg, ts, tbus, tburn, tmw, ttr)}


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(np.asarray,
                      jt.init_params(JCFG, jax.random.PRNGKey(0)))
    return {"jax": jp, "torch": params_from_jax(jp, device="cpu")}


def both(scenario, *args):
    """Run ``scenario(side, *args)`` on both packages; the records must
    be equal.  Returns the port's."""
    got = scenario("torch", *args)
    assert got == scenario("jax", *args)
    return got


def samples(metrics) -> list[str]:
    return [ln for ln in metrics.render().decode().splitlines()
            if "_created" not in ln]


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


# -- the chip ledger (tests/test_fleet.py TestChipLedger) ------------------

class _R:
    def __init__(self, name, chip, state="ready"):
        self.name = name
        self.chip = chip
        self.state = state


class _Mgr:
    def __init__(self, replicas):
        self.replicas = replicas


class _W:
    def __init__(self, chips, alive=True):
        self.chips = chips
        self.alive = alive


class _Sup:
    def __init__(self, workers):
        self.workers = workers


def view(led):
    v = led.view()
    return (v.free, v.serving, v.training, v.unhealthy,
            v.largest_free_block)


class TestChipLedger:
    def test_sync_recomputes_ownership_each_call(self):
        def run(side):
            led = SIDES[side][0].ChipLedger([0, 1, 2, 3, 4, 5])
            led.sync(_Mgr([_R("r0", 4), _R("r1", 5, state="dead")]),
                     _Sup([_W((0, 1)), _W((2, 3), alive=False)]))
            return view(led), dict(led.owners)

        (free, serving, training, _, _), _ = both(run)
        assert serving == (4,) and training == (0, 1)
        assert set(free) == {2, 3, 5}

    def test_health_keeps_last_state_and_heals_once(self):
        def run(side):
            state = {"fail": False, "unhealthy": {}}

            def probe():
                if state["fail"]:
                    raise RuntimeError("transport down")
                return dict(state["unhealthy"])

            led = SIDES[side][0].ChipLedger([0, 1], health_source=probe)
            out = []
            state["unhealthy"] = {1: "ecc"}
            led.observe_health()
            out.append(led.current_unhealthy())
            state["fail"] = True
            led.observe_health()
            out.append(led.current_unhealthy())
            state["fail"] = False
            state["unhealthy"] = {}
            led.observe_health()
            out += [led.take_healed(), led.take_healed()]
            led.on_health({"0": "pushed"})
            out.append(led.current_unhealthy())
            return out

        assert both(run) == [{1: "ecc"}, {1: "ecc"}, {1}, set(),
                             {0: "pushed"}]

    def test_serving_takes_from_tail_training_block_from_head(self):
        def run(side):
            led = SIDES[side][0].ChipLedger([0, 1, 2, 3])
            out = [led.take_for_serving(), led.take_for_serving()]
            led.unhealthy = {1: "down"}
            out += [led.take_for_serving(), led.take_for_serving()]
            return out

        assert both(run) == [3, 2, 0, None]

    def test_from_backend_binds_a_stub_backend(self):
        """``from_backend`` is duck-typed: ``enumerate().chips`` with
        ``index``, and ``health(expected=...)`` — a vanished chip reads
        unhealthy through the expected set."""

        class Backend:
            def __init__(self):
                self.present = {0, 1, 2, 3}
                self.bad = {}
                self.expected_seen = []

            def enumerate(self):
                chips = [type("C", (), {"index": i})()
                         for i in (3, 1, 0, 2)]
                return type("T", (), {"chips": chips})()

            def health(self, expected=frozenset()):
                self.expected_seen.append(expected)
                out = dict(self.bad)
                out.update({c: "vanished" for c in expected
                            if c not in self.present})
                return out

        def run(side):
            be = Backend()
            led = SIDES[side][0].ChipLedger.from_backend(be)
            out = [list(led.chips)]
            led.observe_health()
            out.append(led.current_unhealthy())
            be.bad = {2: "hbm uncorrectable ecc"}
            be.present.discard(3)
            led.observe_health()
            out += [led.current_unhealthy(), led.healthy_free(),
                    be.expected_seen[-1]]
            return out

        got = both(run)
        assert got[0] == [0, 1, 2, 3]
        assert set(got[2]) == {2, 3} and got[3] == [0, 1]

    def test_contiguous_available_counts_gang_and_skips_unhealthy(self):
        def run(side):
            led = SIDES[side][0].ChipLedger([0, 1, 2, 3, 4])
            led.sync(_Mgr([_R("r0", 4)]), _Sup([_W((0, 1))]))
            out = [led.contiguous_available(4),
                   led.contiguous_available(5)]
            led.unhealthy = {2: "ecc"}
            out += [led.contiguous_available(4),
                    led.view().largest_free_block]
            return out

        assert both(run) == [True, False, False, 1]

    def test_multi_tenant_tags_and_claims(self):
        def run(side):
            f = SIDES[side][0]
            led = f.ChipLedger([0, 1, 2, 3])
            led.sync_multi([("a", _Mgr([_R("r0", 3)]), None),
                            ("g", None, _Sup([_W((0, 1))]))])
            out = [dict(led.owners),
                   [f.owner_tenant(led.owners[c]) for c in led.chips],
                   f.owner_tenant(None), f.owner_tenant("serving:r0")]
            led.claim(2, f.serving_tag("a", "pending"))
            try:
                led.claim(2, "x")
            except ValueError as e:
                out.append(str(e))
            return out

        got = both(run)
        assert got[1] == ["g", "g", None, "a"]


# -- hysteresis policy (tests/test_fleet.py TestFleetPolicy) ---------------

def kw(**over):
    out = dict(replicas=2, idle_replicas=0, gang_dp=4, gang_tp=1)
    out.update(over)
    return out


def decision(a):
    return None if a is None else (a.kind, a.dp)


class TestFleetPolicy:
    def test_scale_up_needs_sustained_pressure(self):
        def run(side):
            f = SIDES[side][0]
            pol = f.FleetPolicy(f.PolicyConfig(queue_high=4, up_after=2))
            hot = f.DemandSignals(queue_depth=9)
            return [decision(pol.decide(hot, f.ChipLedger([0, 1]), **kw()))
                    for _ in range(3)]

        assert both(run) == [None, ("scale_up", None), None]

    def test_one_calm_tick_breaks_the_streak(self):
        def run(side):
            f = SIDES[side][0]
            pol = f.FleetPolicy(f.PolicyConfig(queue_high=4, up_after=2))
            hot = f.DemandSignals(queue_depth=9)
            mid = f.DemandSignals(queue_depth=2, arrival_rate_rps=99.0)
            return [decision(pol.decide(d, f.ChipLedger([0]), **kw()))
                    for d in (hot, mid, hot)]

        assert both(run) == [None, None, None]

    def test_preempt_only_when_pool_is_dry(self):
        def run(side):
            f = SIDES[side][0]
            pol = f.FleetPolicy(f.PolicyConfig(queue_high=4, up_after=1,
                                               min_train_dp=2))
            hot = f.DemandSignals(queue_depth=9)
            return [decision(pol.decide(hot, f.ChipLedger(c), **k))
                    for c, k in (([0], kw()), ([], kw()),
                                 ([], kw(gang_dp=2)))]

        assert both(run) == [("scale_up", None), ("preempt", 2), None]

    def test_stale_margin_without_queue_is_not_pressure(self):
        def run(side):
            f = SIDES[side][0]
            pol = f.FleetPolicy(f.PolicyConfig(queue_high=4, up_after=1))
            stale = f.DemandSignals(queue_depth=0, arrival_rate_rps=0.0,
                                    slo_margin_ewma_s=-3.0)
            live = f.DemandSignals(queue_depth=1, slo_margin_ewma_s=-3.0)
            return [pol.pressured(stale), pol.is_calm(stale),
                    pol.pressured(live),
                    f.policy.pressured(live, pol.cfg),
                    f.policy.is_calm(live, pol.cfg)]

        assert both(run) == [False, True, True, True, False]

    def test_calm_scales_down_then_regrows(self):
        def run(side):
            f = SIDES[side][0]
            pol = f.FleetPolicy(f.PolicyConfig(queue_high=4, down_after=2,
                                               regrow_after=2,
                                               min_replicas=1),
                                train_target_dp=4)
            calm = f.DemandSignals(queue_depth=0, arrival_rate_rps=0.0)
            led = f.ChipLedger([0, 1, 2, 3, 4])
            led.sync(_Mgr([_R("r0", 4)]), _Sup([_W((0, 1))]))
            k1 = kw(replicas=2, idle_replicas=1, gang_dp=2)
            k2 = kw(replicas=1, idle_replicas=0, gang_dp=2)
            k3 = kw(gang_dp=4, idle_replicas=0, replicas=1)
            return [decision(pol.decide(calm, led, **k))
                    for k in (k1, k1, k2, k2, k3)] + [pol.hot, pol.calm]

        assert both(run)[:5] == [None, ("scale_down", None), None,
                                 ("regrow", 4), None]

    def test_regrow_respects_contiguity(self):
        def run(side):
            f = SIDES[side][0]
            pol = f.FleetPolicy(f.PolicyConfig(regrow_after=1),
                                train_target_dp=4)
            led = f.ChipLedger([0, 1, 2, 3])
            led.sync(_Mgr([_R("r0", 2)]), _Sup([_W((0, 1))]))
            return [decision(pol.decide(f.DemandSignals(), led,
                                        **kw(gang_dp=2))),
                    pol.shrunk_dp(8), pol.shrunk_dp(1),
                    pol.grown_dp(2, 1, led)]

        assert both(run)[0] is None

    def test_streaks_stay_fired_while_the_condition_holds(self):
        def run(side):
            s = SIDES[side][0].Streaks(up_after=2, down_after=3)
            out = []
            for hot, calm in ((1, 0), (1, 0), (1, 0), (0, 1), (0, 0),
                              (0, 1), (0, 1), (0, 1)):
                s.update(bool(hot), bool(calm))
                out.append((s.hot, s.calm, s.hot_fired, s.calm_fired))
            return out

        assert both(run)[2] == (3, 0, True, False)


# -- the gateway's demand signals -----------------------------------------

class _IdleManager:
    replicas: list = []

    def poll_down(self):
        return []

    def heartbeat(self):
        pass

    def counts(self):
        return {}


def test_arrival_rate_ewma_rises_and_decays():
    def run(side):
        f, g, srv = SIDES[side][:3]
        clock = Clock()
        gw = g.FleetGateway(_IdleManager(), queue_capacity=64,
                            clock=clock)
        rates = []
        for step in range(6):
            for i in range(4):
                gw.submit(srv.Request(uid=f"s{step}i{i}",
                                      prompt=np.ones(4, np.int32),
                                      max_new=1))
            clock.advance(1.0)
            gw.step()
            rates.append(gw.arrival_rate_rps)
        for _ in range(12):
            clock.advance(1.0)
            gw.step()
            rates.append(gw.arrival_rate_rps)
        reg = gw.metrics.registry
        d = f.read_demand(gw)
        return (rates, reg.get_sample_value("tpu_gateway_arrival_rate_rps"),
                (d.queue_depth, d.arrival_rate_rps, d.slo_margin_ewma_s))

    rates, sample, demand = both(run)
    assert rates[5] > 2.0 and rates[-1] < 0.5
    assert sample == pytest.approx(rates[-1])
    assert demand[0] == 24


# -- reconciler actuation over stub engines --------------------------------

class _StubEngine:
    slots = 2


class _ScriptSup:
    """Supervisor stub: records the reconciler's verbs."""

    def __init__(self, dp=2, tp=2):
        self.dp = dp
        self.job = type("J", (), {"tp": tp})()
        self.workers = [_W(tuple(range(i * tp, (i + 1) * tp)))
                        for i in range(dp)]
        self.requested = []
        self.readmitted = []
        self.metrics = None

    def request_width(self, dp):
        self.requested.append(dp)

    def readmit(self, chips):
        self.readmitted.append(set(chips))


def rig(side, chips=(0, 1, 2, 3, 4, 5), health=None, **pol):
    f, g = SIDES[side][:2]
    clock = Clock()
    mgr = g.ReplicaManager(lambda name: _StubEngine(), replicas=2,
                           chip_of=lambda name: 4 + int(name[1:]))
    gw = g.FleetGateway(mgr, queue_capacity=64, clock=clock)
    sup = _ScriptSup()
    led = f.ChipLedger(list(chips), health_source=health)
    cfg = f.PolicyConfig(**{**dict(queue_high=4, up_after=1,
                                   down_after=1, regrow_after=1,
                                   min_replicas=1), **pol})
    rec = f.FleetReconciler(gw, sup, ledger=led,
                            policy=f.FleetPolicy(cfg), clock=clock)
    return mgr, gw, sup, led, rec


def record(rec, sup, mgr):
    return (list(rec.events), view(rec.ledger), sup.requested,
            sup.readmitted, [(r.name, r.chip, r.state)
                             for r in mgr.replicas],
            mgr.counts(), samples(rec.metrics))


class TestReconcilerActuation:
    def test_pressure_spends_free_chips_before_preempting(self):
        def run(side):
            out = []
            for chips in ((0, 1, 2, 3, 4, 5, 6), (0, 1, 2, 3, 4, 5)):
                mgr, gw, sup, led, rec = rig(side, chips=chips)
                gw.metrics.queue_depth.set(9)
                out.append((rec.tick(), record(rec, sup, mgr)))
            return out

        (a, ra), (b, rb) = both(run)
        assert a == ["scale_up"] and ra[4][-1][1] == 6 and ra[2] == []
        assert b == ["preempt"] and rb[2] == [1]

    def test_heal_is_forwarded_exactly_once(self):
        def run(side):
            state = {"unhealthy": {3: "ecc"}}
            mgr, gw, sup, led, rec = rig(
                side, health=lambda: dict(state["unhealthy"]))
            out = [rec.tick()]
            state["unhealthy"] = {}
            out += [rec.tick(), rec.tick()]
            return out, record(rec, sup, mgr)

        _, rec_ = both(run)
        assert rec_[3] == [{3}]

    def test_calm_drains_then_retires_then_regrows(self):
        def run(side):
            mgr, gw, sup, led, rec = rig(side)
            sup.dp = 1
            sup.workers = sup.workers[:1]
            rec.policy.train_target_dp = 2
            ticks = [rec.tick(), rec.tick()]
            if "regrow" not in ticks[1]:
                ticks.append(rec.tick())
            return ticks, record(rec, sup, mgr)

        ticks, rec_ = both(run)
        assert ticks[0] == ["scale_down"] and "retired" in ticks[1]
        assert "regrow" in ticks[-1] and rec_[2] == [2]
        assert rec_[5]["retired"] == 1
        text = "\n".join(rec_[6])
        assert 'tpu_fleet_scale_events_total{action="down"} 1.0' in text
        assert 'tpu_fleet_scale_events_total{action="regrow"} 1.0' in text

    def test_dead_replicas_are_reaped_and_counted(self):
        def run(side):
            mgr, gw, sup, led, rec = rig(side)
            mgr.mark_down(mgr.replicas[0])
            rec.tick()
            return record(rec, sup, mgr)

        rec_ = both(run)
        assert rec_[5]["dead"] == 1
        assert any(k == "reap_dead" for _, k, _ in rec_[0])

    def test_bus_demand_ticks_on_the_cached_event(self):
        def run(side):
            f, g, srv, bus_mod = SIDES[side][:4]
            bus = bus_mod.EventBus(seed=0)
            mgr = g.ReplicaManager(lambda name: g.NullEngine(slots=1),
                                   replicas=1, chip_of=lambda name: 3)
            clock = Clock()
            gw = g.FleetGateway(mgr, queue_capacity=64, bus=bus,
                                clock=clock)
            rec = f.FleetReconciler(
                gw, ledger=f.ChipLedger([0, 1, 2, 3]), bus=bus, clock=clock,
                policy=f.FleetPolicy(f.PolicyConfig(queue_high=2,
                                                    up_after=1)))
            for i in range(5):
                gw.submit(srv.Request(uid=f"q{i}",
                                      prompt=np.ones(4, np.int32),
                                      max_new=1))
            gw.step()
            return [rec.tick(), rec._bus_demand.queue_depth,
                    [(e["topic"], e["payload"]) for e in bus.journal_dump()
                     if e["topic"] == "reconciler_tick"]]

        got = both(run)
        assert got[0] == ["scale_up"]


# -- the 1x1 loop over real engines ------------------------------------------

def loop_1x1(side, params):
    """One f32 paged replica at start, ``auto_replace=False``, chips 0-3
    under ``FleetReconciler`` with a scripted clock: a burst of 12
    under a 2 s SLO, calm, chip 3's replica downed by the ledger's
    health view and healed.  The burn-rate engine, ``MemWatch`` and a
    tracer ride on the gateway.  Returns every observable."""
    f, g, srv, bus_mod, burn_mod, mw_mod, tr_mod = SIDES[side]
    clock = Clock()
    health = {}
    ledger = f.ChipLedger([0, 1, 2, 3], health_source=lambda: dict(health))
    healed = []
    take = ledger.take_healed

    def take_healed():
        out = take()
        if out:
            healed.append(sorted(out))
        return out

    ledger.take_healed = take_healed
    cfg, p = (JCFG, params["jax"]) if side == "jax" else (TCFG,
                                                         params["torch"])
    extra = {} if side == "jax" else {"device": "cpu"}
    mgr = g.ReplicaManager(
        lambda name: srv.ServingEngine(p, cfg, slots=2, kv_layout="paged",
                                       kv_blocks=16, **extra),
        replicas=1, health_source=ledger.current_unhealthy,
        chip_of=lambda name: 3, depth_bound=2)
    bus = bus_mod.EventBus(seed=0)
    tracer = tr_mod.Tracer(bus=bus, clock=clock)
    mw = mw_mod.MemWatch(**extra)
    burn = burn_mod.SloBurnEngine(min_samples=1)
    gw = g.FleetGateway(mgr, queue_capacity=64, clock=clock,
                        auto_replace=False, bus=bus, tracer=tracer,
                        burn=burn, memwatch=mw, tenant="t")
    rec = f.FleetReconciler(
        gw, ledger=ledger, clock=clock, tracer=tracer,
        policy=f.FleetPolicy(f.PolicyConfig(
            queue_high=3, up_after=1, down_after=3, min_replicas=1,
            max_replicas=3, arrival_low_rps=0.5)))
    ticks, owners, units, alerts = [], [], [], []
    bus.subscribe("alert", lambda ev: alerts.append(ev.payload))
    reqs = [srv.Request(uid=f"a{i}", prompt=prompt(100 + i, 5 + i % 3),
                        max_new=3) for i in range(12)]
    late = [srv.Request(uid=f"b{i}", prompt=prompt(200 + i, 6), max_new=3)
            for i in range(3)]
    for r in reqs:
        gw.submit(r, slo_s=2.0)
    for cycle in range(60):
        if cycle == 25:
            live = [r for r in mgr.replicas if r.state != "dead"]
            health[live[-1].chip] = "ecc"
            for r in late:
                gw.submit(r, slo_s=60.0)
        if cycle == 32:
            health.clear()
        gw.step()
        units.append((sorted({k.split("/")[1]
                              for k in mw.snapshot()["components"]}),
                      sorted(r.name for r in mgr.replicas
                             if r.state != "dead")))
        ticks.append(rec.tick())
        owners.append((sorted(c for c, o in ledger.owners.items() if o),
                       sorted(r.chip for r in mgr.replicas
                              if r.state != "dead")))
        clock.advance(0.5)
    return dict(
        ticks=ticks, events=list(rec.events), owners=owners, units=units,
        healed=healed, alerts=alerts, burn_total=burn.alerts_total,
        outcomes={u: (o.status, o.replica, o.requeues)
                  for u, o in sorted(gw.outcomes.items())},
        tokens={u: np.asarray(r.tokens).tolist()
                for u, r in sorted(gw.results.items())},
        replicas=[(r.name, r.chip, r.state) for r in mgr.replicas],
        fleet=samples(rec.metrics),
        gateway=[ln for ln in samples(gw.metrics)
                 if "seconds" not in ln])


def test_1x1_loop_equals_jax(params):
    got = loop_1x1("torch", params)
    want = loop_1x1("jax", params)
    units, jax_units = got.pop("units"), want.pop("units")
    assert got == want
    kinds = [k for _, k, _ in got["events"]]
    assert "scale_up" in kinds and "scale_down" in kinds
    assert "retired" in kinds and kinds.count("reap_dead") == 1
    assert got["healed"] == [[2]] or len(got["healed"]) == 1
    assert len(got["outcomes"]) == 15
    assert {s for s, _, _ in got["outcomes"].values()} <= {
        "finished", "shed_expired"}
    assert got["burn_total"] >= 1 and got["alerts"]
    # after every pump step MemWatch names exactly the live replicas;
    # the JAX gateway keeps a retired replica's cells (ROADMAP Queue C
    # item 18)
    assert all(have == live for have, live in units)
    assert any(set(have) > set(live) for have, live in jax_units)
    # the ledger's owners are the live replicas' chips after each tick
    assert all(owned == live for owned, live in got["owners"])


# -- combined exposition over HTTP ---------------------------------------

def test_serve_metrics_combines_fleet_registries():
    """One /metrics serves the reconciler's, the gateway's and the
    supervisor's registries; the body equals the JAX reconciler's but
    for ``_created``.  With a ``MemWatch`` on the gateway the port adds
    its families (ROADMAP Queue C item 17)."""
    from k8s_dra_driver_tpu.utils.metrics import RecoveryMetrics as JRM
    from k8s_dra_driver_tpu_torch.utils.metrics import RecoveryMetrics as TRM

    class Job:
        tp = 1

    bodies = {}
    for side, metrics in (("jax", JRM), ("torch", TRM)):
        f, g = SIDES[side][:2]
        sup = type("Sup", (), {"dp": 2, "job": Job(), "workers": [],
                               "metrics": metrics()})()
        sup.metrics.dp_width.set(2)
        gw = g.FleetGateway(_IdleManager(), queue_capacity=4)
        rec = f.FleetReconciler(gw, sup, ledger=f.ChipLedger([0, 1]))
        rec.tick()
        endpoint = rec.serve_metrics("127.0.0.1:0")
        try:
            bodies[side] = urlopen(f"http://{endpoint.address}/metrics",
                                   timeout=5).read().decode()
        finally:
            endpoint.stop()
    for family in ("tpu_fleet_ticks_total", "tpu_gateway_queue_depth",
                   "tpu_train_dp_width"):
        assert f"# TYPE {family}" in bodies["torch"], family
    assert bodies["torch"].splitlines() == [
        ln for ln in bodies["jax"].splitlines() if "_created" not in ln]

    mw = tmw.MemWatch(device="cpu")
    gw = tg.FleetGateway(_IdleManager(), queue_capacity=4, memwatch=mw)
    rec = tf.FleetReconciler(gw, ledger=tf.ChipLedger([0, 1]))
    endpoint = rec.serve_metrics("127.0.0.1:0")
    try:
        body = urlopen(f"http://{endpoint.address}/metrics",
                       timeout=5).read().decode()
    finally:
        endpoint.stop()
    assert "# TYPE tpu_mem_accounted_frac gauge" in body
    assert body.endswith(mw.render().decode())


def test_http_endpoint_routes():
    class Reg:
        def render(self):
            return b"x 1.0\n"

    endpoint = HTTPEndpoint("127.0.0.1:0", Reg(), extra_metrics=[Reg()],
                            debug_source=lambda: {"b": 2, "a": 1})
    endpoint.start()
    base = f"http://{endpoint.address}"
    try:
        assert urlopen(f"{base}/metrics", timeout=5).read() == \
            b"x 1.0\nx 1.0\n"
        assert urlopen(f"{base}/healthz", timeout=5).read() == b"ok"
        assert urlopen(f"{base}/debugz", timeout=5).read() == \
            b'{"a": 1, "b": 2}'
        assert urlopen(f"{base}/debug/pprof", timeout=5).read() == \
            b"goroutine\nprofile\n"
        stacks = urlopen(f"{base}/debug/pprof/goroutine",
                         timeout=5).read().decode()
        assert threading.current_thread().name in stacks
        prof = urlopen(f"{base}/debug/pprof/profile?seconds=0.1",
                       timeout=5).read().decode()
        assert prof.startswith("# ")
    finally:
        endpoint.stop()


@pytest.mark.parametrize("n_chips,domain_size", [(8, 2), (16, 2), (16, 4)])
def test_fragmentation_probe_equals_jax(n_chips, domain_size):
    got = tf.fragmentation_probe(n_chips, domain_size)
    assert got == j_fragmentation_probe(n_chips, domain_size)
    if (n_chips, domain_size) == (8, 2):
        assert got["packed_regrow"] == 4 and got["naive_regrow"] == 2
