"""Port multi-tenant fleet (k8s_dra_driver_tpu_torch/fleet/tenancy.py and
binpack.py) against the JAX package's, on the CPU in f32.

tests/test_tenancy.py's pure-host classes (``TestTenantRegistry``,
``TestEntitlements``, ``TestBinPacker``, ``TestArbiterCascade``), its
submit, bus-demand and trace-tag cases, and the adapter-quota cases of
tests/test_serving_lora.py run on both packages: the same results, the
same actions, the same events.  A two-tenant cascade over real engines
(a high-priority burst reclaiming from a low tenant whose engines carry
an ``AdapterPool`` over its quota, then calm) must give equal
``MultiTenantReconciler`` events, fair-share errors, outcomes and greedy
streams.  Training tenants wait for the port's supervisor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu import fleet as jf
from k8s_dra_driver_tpu import gateway as jg
from k8s_dra_driver_tpu.cluster import bus as jbus
from k8s_dra_driver_tpu.fleet import tenancy as jten
from k8s_dra_driver_tpu.gateway import loadgen as jload
from k8s_dra_driver_tpu.models import serving as js
from k8s_dra_driver_tpu.models import transformer as jt
from k8s_dra_driver_tpu.serving_lora import pool as jl
from k8s_dra_driver_tpu_torch import fleet as tf
from k8s_dra_driver_tpu_torch import gateway as tg
from k8s_dra_driver_tpu_torch.cluster import bus as tbus
from k8s_dra_driver_tpu_torch.fleet import tenancy as tten
from k8s_dra_driver_tpu_torch.gateway import loadgen as tload
from k8s_dra_driver_tpu_torch.models import serving as ts
from k8s_dra_driver_tpu_torch.models import transformer as tt
from k8s_dra_driver_tpu_torch.models.convert import params_from_jax
from k8s_dra_driver_tpu_torch.serving_lora import (AdapterManifest,
                                                   AdapterPool,
                                                   make_adapter)

pytestmark = pytest.mark.timeout_s(180)

FIELDS = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
              d_ff=64, max_seq=48, n_kv_heads=2)
JCFG = jt.TransformerConfig(dtype=jnp.float32, **FIELDS)
TCFG = tt.TransformerConfig(dtype=torch.float32, **FIELDS)
RANK = 2

#: (fleet, tenancy, gateway, serving, bus, loadgen) per package
SIDES = {"jax": (jf, jten, jg, js, jbus, jload),
         "torch": (tf, tten, tg, ts, tbus, tload)}


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


def action(a):
    return None if a is None else (a.kind, a.tenant, a.beneficiary,
                                   a.chip, a.dp, a.run)


# -- specs + registry --------------------------------------------------------

class TestTenantRegistry:
    @pytest.mark.parametrize("kw", [dict(quota=1, floor=2),
                                    dict(quota=1, share=0.0),
                                    dict(quota=1, adapter_quota_bytes=-1)])
    def test_spec_validation(self, kw):
        msgs = []
        for side in SIDES:
            with pytest.raises(ValueError) as e:
                SIDES[side][1].TenantSpec("x", priority=1, **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]

    def test_floors_must_fit_capacity(self):
        def run(side):
            f = SIDES[side][0]
            reg = f.TenantRegistry(capacity=4)
            reg.add(f.TenantSpec("a", priority=2, quota=4, floor=3),
                    object())
            out = []
            for spec in (f.TenantSpec("b", priority=1, quota=4, floor=2),
                         f.TenantSpec("a", priority=1, quota=1)):
                try:
                    reg.add(spec, object())
                except ValueError as e:
                    out.append(str(e))
            return out, len(reg)

        msgs, n = both(run)
        assert len(msgs) == 2 and n == 1

    def test_priority_ordering(self):
        def run(side):
            f = SIDES[side][0]
            reg = f.TenantRegistry()
            reg.add(f.TenantSpec("lo", priority=1, quota=2), object())
            reg.add(f.TenantSpec("hi", priority=3, quota=2), object())
            reg.add(f.TenantSpec("mid", priority=2, quota=2), object())
            return ([s.name for s in reg.by_priority()],
                    [s.name for s in reg.by_priority(reverse=False)],
                    [s.name for s in reg])

        assert both(run)[0] == ["hi", "mid", "lo"]


def _st(f, spec, kind, chips, wanted, **kw):
    return f.TenantState(spec=spec, kind=kind, chips=frozenset(chips),
                         wanted=wanted, **kw)


def specs(f):
    return (f.TenantSpec("hi", priority=3, quota=6, floor=2),
            f.TenantSpec("mid", priority=2, quota=6, floor=2),
            f.TenantSpec("lo", priority=1, quota=2, floor=0))


class TestEntitlements:
    def test_priority_fill_under_contention(self):
        def run(side):
            f = SIDES[side][0]
            hi, mid, lo = specs(f)
            return f.entitlements([
                _st(f, hi, "serving", {6, 7}, 6, pressured=True),
                _st(f, mid, "training", {2, 3, 4, 5}, 4, gang_dp=4),
                _st(f, lo, "training", {0, 1}, 2, gang_dp=2)], 8)

        assert both(run) == {"hi": 6, "mid": 2, "lo": 0}

    def test_calm_returns_headroom_down_the_classes(self):
        def run(side):
            f = SIDES[side][0]
            hi, mid, lo = specs(f)
            return f.entitlements([
                _st(f, hi, "serving", {6, 7}, 2, calm=True),
                _st(f, mid, "training", {2, 3}, 4, gang_dp=2),
                _st(f, lo, "training", set(), 2, gang_dp=0,
                    parked=True)], 8)

        assert both(run) == {"hi": 2, "mid": 4, "lo": 2}

    def test_share_weights_split_one_class(self):
        def run(side):
            f = SIDES[side][0]
            a = f.TenantSpec("a", priority=1, quota=8, share=2.0)
            b = f.TenantSpec("b", priority=1, quota=8, share=1.0)
            return f.entitlements([
                _st(f, a, "serving", set(), 8, pressured=True),
                _st(f, b, "serving", set(), 8, pressured=True)], 6)

        assert both(run) == {"a": 4, "b": 2}

    def test_quota_caps_entitlement(self):
        def run(side):
            f = SIDES[side][0]
            a = f.TenantSpec("a", priority=2, quota=3)
            b = f.TenantSpec("b", priority=1, quota=8)
            return f.entitlements([
                _st(f, a, "serving", set(), 8, pressured=True),
                _st(f, b, "serving", set(), 8, pressured=True)], 8)

        assert both(run) == {"a": 3, "b": 5}

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_random_states_equal_jax(self, seed):
        def run(side):
            f = SIDES[side][0]
            rng = np.random.default_rng(seed)
            states = []
            for i in range(7):
                quota = int(rng.integers(1, 9))
                spec = f.TenantSpec(f"t{i}", priority=int(rng.integers(0, 3)),
                                    quota=quota,
                                    floor=int(rng.integers(0, 2)),
                                    share=float(rng.choice([0.5, 1, 2])))
                states.append(_st(f, spec, "serving", set(),
                                  int(rng.integers(0, 10)),
                                  pressured=bool(rng.integers(0, 2))))
            return f.entitlements(states, 16)

        both(run)


# -- the bin-packer -----------------------------------------------------------

def packer_rig(side, n=8, domain_size=2):
    f = SIDES[side][0]
    led = f.ChipLedger(list(range(n)))
    return f, led, f.TopologyBinPacker(led, domain_size=domain_size)


def run_of(p):
    return None if p is None else (p.chips, p.domains)


class TestBinPacker:
    def test_no_two_tenants_straddle_a_link_domain(self):
        def run(side):
            f, led, packer = packer_rig(side)
            led.owners[0] = f.training_tag("gang")
            led.owners[3] = f.serving_tag("other", "r0")
            return (packer.place_chip("me"),
                    run_of(packer.place_run(
                        "gang", 2, usable_owner=f.training_tag("gang"))))

        chip, run = both(run)
        assert chip in (4, 5, 6, 7) and run[0] == (0, 1)

    def test_conflict_table_reports_holders(self):
        def run(side):
            f, led, packer = packer_rig(side)
            led.owners[0] = f.training_tag("g")
            led.owners[5] = f.serving_tag("s", "r0")
            return packer.conflict_table()

        assert both(run) == {0: {"g"}, 2: {"s"}}

    def test_place_chip_fills_own_domain_and_avoids_others(self):
        def run(side):
            f, led, packer = packer_rig(side)
            led.owners[0] = led.owners[1] = f.training_tag("gang")
            out = []
            for tenant in ("A", "A", "B"):
                chip = packer.place_chip(tenant)
                led.owners[chip] = f.serving_tag(tenant, f"r{len(out)}")
                out.append((chip, packer.domain_of(chip)))
            return out

        got = both(run)
        assert [c for c, _ in got[:2]] == [7, 6]
        assert got[2][1] not in (0, 3)

    def test_place_run_prefers_extending_own_block(self):
        def run(side):
            f, led, packer = packer_rig(side)
            led.owners[2] = led.owners[3] = f.training_tag("g")
            return run_of(packer.place_run(
                "g", 4, usable_owner=f.training_tag("g")))

        chips, _ = both(run)
        assert {2, 3} <= set(chips) and len(chips) == 4

    def test_place_run_skips_unhealthy_and_conflicted(self):
        def run(side):
            f, led, packer = packer_rig(side)
            led.unhealthy = {1: "ecc"}
            led.owners[5] = f.serving_tag("other", "r0")
            return run_of(packer.place_run("me", 2))

        chips, _ = both(run)
        assert not {1, 4, 5} & set(chips)

    def test_regrow_width_counts_own_chips(self):
        def run(side):
            f, led, packer = packer_rig(side)
            led.owners[0] = led.owners[1] = f.training_tag("g")
            led.owners[6] = f.serving_tag("s", "r0")
            led.owners[7] = f.serving_tag("s", "r1")
            return (packer.regrow_width("g", tp=1, target_dp=8),
                    packer.regrow_width("g", tp=2, target_dp=4),
                    packer.naive_first_fit(3))

        assert both(run)[:2] == (4, 2)


# -- the arbiter -------------------------------------------------------------

def arbiter_rig(side):
    f = SIDES[side][0]
    led = f.ChipLedger(list(range(8)))
    for c in (0, 1):
        led.owners[c] = f.training_tag("lo")
    for c in (2, 3, 4, 5):
        led.owners[c] = f.training_tag("mid")
    led.owners[6] = f.serving_tag("hi", "r0")
    led.owners[7] = f.serving_tag("hi", "r1")
    packer = f.TopologyBinPacker(led, domain_size=2)
    arb = f.FairShareArbiter(up_after=1, down_after=1, regrow_after=1)
    return f, led, packer, arb


def cascade_states(f, hi_chips, mid_chips, lo_chips, *, hot=True,
                   lo_parked=False):
    hi, mid, lo = specs(f)
    return [
        _st(f, hi, "serving", hi_chips, 6 if hot else 2,
            pressured=hot, calm=not hot),
        _st(f, mid, "training", mid_chips, 4, gang_dp=len(mid_chips),
            gang_tp=1),
        _st(f, lo, "training", lo_chips, 2, gang_dp=len(lo_chips),
            gang_tp=1, parked=lo_parked),
    ]


class TestArbiterCascade:
    def test_cascade_is_strict_priority_order(self):
        def run(side):
            f, led, packer, arb = arbiter_rig(side)
            a = arb.decide(cascade_states(f, {6, 7}, {2, 3, 4, 5}, {0, 1}),
                           led, packer)
            for c in (0, 1):
                led.owners[c] = f.serving_tag("hi", "r2")
            b = arb.decide(cascade_states(f, {0, 1, 6, 7}, {2, 3, 4, 5},
                                          set(), lo_parked=True),
                           led, packer)
            return action(a), action(b), dict(arb.entitled)

        a, b, _ = both(run)
        assert a[:3] == ("reclaim_park", "lo", "hi")
        assert (b[0], b[1], b[4]) == ("reclaim_shrink", "mid", 2)

    def test_floored_victims_are_never_taken_below_floor(self):
        def run(side):
            f = SIDES[side][0]
            hi = specs(f)[0]
            mid3 = f.TenantSpec("mid", priority=2, quota=6, floor=3)
            led = f.ChipLedger(list(range(8)))
            led.unhealthy = {0: "ecc", 1: "ecc"}
            for c in (2, 3, 4, 5):
                led.owners[c] = f.training_tag("mid")
            led.owners[6] = f.serving_tag("hi", "r0")
            led.owners[7] = f.serving_tag("hi", "r1")
            packer = f.TopologyBinPacker(led, domain_size=2)
            arb = f.FairShareArbiter(up_after=1, down_after=1,
                                     regrow_after=1)
            return action(arb.decide([
                _st(f, hi, "serving", {6, 7}, 6, pressured=True),
                _st(f, mid3, "training", {2, 3, 4, 5}, 4, gang_dp=4,
                    gang_tp=1)], led, packer))

        assert both(run) is None

    def test_no_preemption_for_equal_or_lower_priority(self):
        def run(side):
            f, led, packer, arb = arbiter_rig(side)
            peer = f.TenantSpec("peer", priority=2, quota=6)
            for c in (0, 1, 6, 7):
                led.owners[c] = f.training_tag("mid")
            return action(arb.decide([
                _st(f, peer, "serving", set(), 6, pressured=True),
                _st(f, specs(f)[1], "training", set(range(8)), 8,
                    gang_dp=8, gang_tp=1)], led, packer))

        assert both(run) is None

    def test_calm_release_then_regrow_in_priority_order(self):
        def run(side):
            f, led, packer, arb = arbiter_rig(side)
            led.owners[0] = led.owners[1] = None
            led.owners[4] = f.serving_tag("hi", "r2")
            led.owners[5] = f.serving_tag("hi", "r3")
            a = arb.decide(cascade_states(f, {4, 5, 6, 7}, {2, 3}, set(),
                                          hot=False, lo_parked=True),
                           led, packer)
            led.owners[4] = led.owners[5] = None
            b = arb.decide(cascade_states(f, {6, 7}, {2, 3}, set(),
                                          hot=False, lo_parked=True),
                           led, packer)
            return action(a), action(b)

        a, b = both(run)
        assert a[:2] == ("release", "hi")
        assert (b[0], b[1], b[4]) == ("regrow", "mid", 4)


# -- per-tenant tagging and the shared bus ----------------------------------

def test_submit_tags_tenant_series_and_refusals():
    def run(side):
        f, _, g, srv = SIDES[side][:4]
        mgr = g.ReplicaManager(lambda name: g.NullEngine(slots=2),
                               replicas=0)
        gw = g.FleetGateway(mgr, queue_capacity=1, tenant="hi")
        a = gw.submit(srv.Request(uid="a", prompt=np.ones(4, np.int32),
                                  max_new=1))
        b = gw.submit(srv.Request(uid="b", prompt=np.ones(4, np.int32),
                                  max_new=1), tenant="other")
        return (a.tenant, b.tenant, b.status,
                gw.metrics.registry.get_sample_value(
                    "tpu_gateway_tenant_requests_total",
                    {"tenant": "other", "outcome": "rejected_full"}))

    assert both(run) == ("hi", "other", "rejected_full", 1.0)


def test_bus_tagged_demand_reaches_the_arbiter():
    def run(side):
        f, _, g, srv, bus_mod = SIDES[side][:5]
        bus = bus_mod.EventBus()
        gws = {}
        registry = f.TenantRegistry(capacity=4)
        for name, prio in (("a", 2), ("b", 1)):
            mgr = g.ReplicaManager(lambda n: g.NullEngine(slots=2),
                                   replicas=0)
            gws[name] = g.FleetGateway(mgr, queue_capacity=8,
                                       tenant=name, bus=bus)
            registry.add(f.TenantSpec(name, priority=prio, quota=2),
                         f.ServingTenant(gws[name]))
        rec = f.MultiTenantReconciler(
            registry, ledger=f.ChipLedger([0, 1, 2, 3]), bus=bus,
            clock=Clock())
        for i in range(5):
            gws["a"].submit(srv.Request(uid=f"q{i}",
                                        prompt=np.ones(4, np.int32),
                                        max_new=1))
        gws["a"].step()
        gws["b"].step()
        depths = (rec._bus_demand["a"]["queue_depth"],
                  rec._bus_demand["b"]["queue_depth"])
        return depths, rec.tick(), dict(rec.arbiter.entitled)

    depths, _, ent = both(run)
    assert depths == (5, 0) and ent["a"] >= 0


def test_trace_fixtures_carry_tenant_tags():
    for name in tload.TRACE_NAMES:
        t = tload.load_trace(name)
        assert len(t["tenants"]) == t["n"]
        assert set(t["tenants"]) <= {"a", "b", "c"}
        assert t["tenants"] == jload.load_trace(name)["tenants"]


# -- adapter-HBM quotas (tests/test_serving_lora.py:392-459) -----------------

def seed_of(name):
    return 1000 + sum(map(ord, name))


def lora_pool(side, n_resident, names, tenant_of):
    if side == "jax":
        pool = jl.AdapterPool(JCFG, RANK, n_resident=n_resident)
        for n in names:
            pool.register(jl.AdapterManifest(
                n, RANK, tenant=tenant_of(n),
                source=jl.make_adapter(JCFG, RANK, seed=seed_of(n),
                                       scale=0.5)))
        return pool
    pool = AdapterPool(TCFG, RANK, n_resident=n_resident, device="cpu")
    for n in names:
        pool.register(AdapterManifest(
            n, RANK, tenant=tenant_of(n),
            source=make_adapter(TCFG, RANK, seed=seed_of(n), scale=0.5)))
    return pool


def engine(side, params, **kw):
    srv = SIDES[side][3]
    if side == "jax":
        return srv.ServingEngine(params["jax"], JCFG, slots=2, **kw)
    return srv.ServingEngine(params["torch"], TCFG, slots=2,
                             device="cpu", **kw)


def quota_rig(side, params, quota_slots=1):
    f, _, g = SIDES[side][:3]
    owner = {"x1": "t-lo", "x2": "t-lo", "y1": "t-hi"}
    pool = lora_pool(side, 3, ["x1", "x2", "y1"], owner.__getitem__)
    mgr = g.ReplicaManager(lambda name: engine(side, params,
                                               adapter_pool=pool),
                           replicas=1)
    gw = g.FleetGateway(mgr, queue_capacity=8)
    for n in ("x1", "x2", "y1"):                 # x1 is coldest
        pool.release(pool.acquire(n))
    registry = f.TenantRegistry(capacity=4)
    registry.add(f.TenantSpec("t-lo", priority=1, quota=2,
                              adapter_quota_bytes=quota_slots
                              * pool.bytes_per_slot),
                 f.ServingTenant(gw))
    registry.add(f.TenantSpec("t-hi", priority=2, quota=2),
                 f.ServingTenant(gw))
    rec = f.MultiTenantReconciler(registry,
                                  ledger=f.ChipLedger([0, 1, 2, 3]),
                                  clock=Clock())
    return rec, pool


def metric_lines(rec):
    return [ln for ln in rec.metrics.render().decode().splitlines()
            if "_created" not in ln]


def test_over_quota_evicts_coldest_before_any_chip_action(params):
    def run(side):
        rec, pool = quota_rig(side, params)
        first = rec.tick()
        out = [first, pool.resident(), pool.evictions_total,
               list(rec.events), metric_lines(rec), pool.bytes_per_slot]
        out += [rec.tick(), metric_lines(rec)]
        return out

    got = both(run)
    assert got[0] == [tten.ADAPTER_EVICT]
    assert got[1] == ("x2", "y1") and got[2] == 1
    ev = [e for e in got[3] if e[1] == tten.ADAPTER_EVICT]
    assert ev and ev[-1][2]["adapters"] == ["x1"]
    bps = got[5]
    assert (f'tpu_fleet_tenant_adapter_bytes{{tenant="t-lo"}} '
            f'{float(2 * bps)}') in got[4]
    assert tten.ADAPTER_EVICT not in got[6]
    assert (f'tpu_fleet_tenant_adapter_bytes{{tenant="t-lo"}} '
            f'{float(bps)}') in got[7]


def test_fully_pinned_over_quota_pool_never_livelocks(params):
    def run(side):
        rec, pool = quota_rig(side, params)
        pins = [pool.acquire("x1"), pool.acquire("x2")]
        out = [rec.tick(), pool.resident()]
        for s in pins:
            pool.release(s)
        out.append(rec.tick())
        return out

    got = both(run)
    assert tten.ADAPTER_EVICT not in got[0]
    assert got[1] == ("x1", "x2", "y1")
    assert got[2] == [tten.ADAPTER_EVICT]


# -- two serving tenants over real engines ---------------------------------

def two_tenants(side, params, lo_new=4):
    """hi (priority 2, floor 1) and lo (priority 1, floor 1) serving
    tenants over chips 0-3, one replica each at start plus one more for
    lo; lo's engines carry one AdapterPool whose cold adapters exceed
    lo's quota.  A hi burst under a tight SLO, then calm.  ``lo_new``
    sets how long lo's replicas stay busy."""
    f, _, g, srv, bus_mod = SIDES[side][:5]
    clock = Clock()
    owner = {"x1": "lo", "x2": "lo", "x3": "lo"}
    pool = lora_pool(side, 3, list(owner), owner.__getitem__)
    for n in owner:
        pool.release(pool.acquire(n))
    chips = {"hi": {"r0": 3}, "lo": {"r0": 0, "r1": 1}}

    def pool_of(tenant, n, extra):
        mgr = g.ReplicaManager(
            lambda name: engine(side, params, kv_layout="paged",
                                kv_blocks=16, **extra),
            replicas=n, chip_of=chips[tenant].get,
            depth_bound=2)
        return g.FleetGateway(mgr, queue_capacity=64, clock=clock,
                              auto_replace=False, tenant=tenant)

    gws = {"hi": pool_of("hi", 1, {}),
           "lo": pool_of("lo", 2, {"adapter_pool": pool})}
    registry = f.TenantRegistry(capacity=4)
    registry.add(f.TenantSpec("hi", priority=2, quota=3, floor=1),
                 f.ServingTenant(gws["hi"]))
    registry.add(f.TenantSpec("lo", priority=1, quota=3, floor=1,
                              adapter_quota_bytes=pool.bytes_per_slot),
                 f.ServingTenant(gws["lo"]))
    ledger = f.ChipLedger([0, 1, 2, 3])
    rec = f.MultiTenantReconciler(
        registry, ledger=ledger,
        packer=f.TopologyBinPacker(ledger, domain_size=1),
        config=f.MtConfig(queue_high=3, up_after=1, down_after=3),
        clock=clock)
    for i in range(10):
        gws["hi"].submit(srv.Request(uid=f"h{i}",
                                     prompt=prompt(300 + i, 6),
                                     max_new=4), slo_s=3.0)
    for i in range(3):
        gws["lo"].submit(srv.Request(uid=f"l{i}",
                                     prompt=prompt(400 + i, 5),
                                     max_new=lo_new), slo_s=60.0)
    held, errs = [], []
    for _ in range(45):
        for gw in gws.values():
            gw.step()
        rec.tick()
        held.append({t: sorted(rec.registry.workload(t).chips())
                     for t in gws})
        errs.append(round(rec.fairshare_error(), 9))
        clock.advance(0.5)
    return dict(
        events=list(rec.events), held=held, errs=errs,
        resident=pool.resident(),
        outcomes={t: {u: (o.status, o.replica)
                      for u, o in sorted(gw.outcomes.items())}
                  for t, gw in gws.items()},
        tokens={t: {u: np.asarray(r.tokens).tolist()
                    for u, r in sorted(gw.results.items())}
                for t, gw in gws.items()},
        metrics=metric_lines(rec))


def test_two_tenant_cascade_equals_jax(params):
    got = both(two_tenants, params)
    kinds = [(k, i.get("tenant")) for _, k, i in got["events"]]
    evicts = [n for n, (k, _) in enumerate(kinds) if k == "adapter_evict"]
    chip_acts = [n for n, (k, _) in enumerate(kinds)
                 if k in ("grant", "reclaim_drain", "release")]
    assert evicts and chip_acts and max(evicts) < min(chip_acts)
    assert ("reclaim_drain", "lo") in kinds and ("grant", "hi") in kinds
    assert ("release", "hi") in kinds
    # never below lo's floor of one chip
    assert all(len(h["lo"]) >= 1 for h in got["held"])
    # exactly once in both tenants
    assert len(got["outcomes"]["hi"]) == 10
    assert len(got["outcomes"]["lo"]) == 3
    assert got["errs"][-1] == 0.0


def test_busy_reclaim_keeps_the_floor(params):
    """ROADMAP Queue C item 19: when lo's replicas are busy, the first
    reclaim drains one that keeps its chip while it finishes its work.
    The JAX arbiter counts that chip held and drains lo's last replica on
    the next tick (lo falls to 0 chips, below its floor of 1); the port
    counts a draining replica as given and waits for it to retire."""
    got = two_tenants("torch", params, lo_new=16)
    want = two_tenants("jax", params, lo_new=16)
    assert min(len(h["lo"]) for h in got["held"]) == 1
    assert min(len(h["lo"]) for h in want["held"]) == 0
    drains = [[i["replica"] for _, k, i in r["events"]
               if k == "reclaim_drain"] for r in (got, want)]
    assert len(drains[0]) == 1 and len(drains[1]) == 2
    for r in (got, want):
        assert len(r["outcomes"]["hi"]) == 10
        assert len(r["outcomes"]["lo"]) == 3
