"""The port's fleet simulator (k8s_dra_driver_tpu_torch/sim/) against the
JAX package's sim/.

The twins of tests/test_sim.py: event-heap semantics (those that
tests/test_torch_sharded.py does not already pin), the replay under a
virtual clock, the bin-packer and entitlement fast-path equivalences
the simulator's scale depends on, O(events) cost, journal determinism
and the drain-starvation pathology pair.  Then parity: the same
journal, reconciler event log and ``journal_digest`` as the JAX
simulator for ``SimConfig.tiny()`` over several seeds, ``repro()`` with
and without the drain fix, and ``contended()`` packed and spread; the
same ``sim_soak.json`` summary.  Last, the one departure (ROADMAP Queue
C item 19): with busy victims the port's reconciler counts a draining
replica as given, and the first reconciler event where the two
packages part is that decision.
"""

import json

import numpy as np
import pytest

from k8s_dra_driver_tpu.cluster import crucible as jcru
from k8s_dra_driver_tpu.fleet import tenancy as jten
from k8s_dra_driver_tpu.sim import fleet as jfleet
from k8s_dra_driver_tpu.sim import rig as jrig
from k8s_dra_driver_tpu_torch.cluster.crucible import FaultEvent, Schedule
from k8s_dra_driver_tpu_torch.fleet.binpack import TopologyBinPacker
from k8s_dra_driver_tpu_torch.fleet.supply import (ChipLedger, serving_tag,
                                                   training_tag)
from k8s_dra_driver_tpu_torch.fleet.tenancy import (MtConfig,
                                                    TenantRegistry,
                                                    TenantSpec, TenantState,
                                                    entitlements)
from k8s_dra_driver_tpu_torch.gateway import loadgen
from k8s_dra_driver_tpu_torch.sim.clock import EventHeap, VirtualClock
from k8s_dra_driver_tpu_torch.sim.fleet import SimConfig, build_fleet
from k8s_dra_driver_tpu_torch.sim.rig import (default_sim_schedule,
                                              run_sim_soak)


# -- event heap (the cases test_torch_sharded.py does not pin) -------------

class TestEventHeap:
    def test_past_schedules_clamp_to_now(self):
        heap, log = EventHeap(), []
        heap.advance_to(5.0)
        heap.at(1.0, log.append, "late")
        assert heap.next_time() == 5.0
        heap.advance_to(5.0)
        assert log == ["late"]

    def test_callbacks_see_their_own_timestamp(self):
        heap, seen = EventHeap(), []
        heap.at(1.5, lambda: seen.append(heap.now))
        heap.at(4.0, lambda: seen.append(heap.now))
        heap.advance_to(10.0)
        assert seen == [1.5, 4.0]
        assert heap.now == 10.0

    def test_callbacks_may_schedule_within_the_advance(self):
        heap, log = EventHeap(), []

        def fire():
            log.append(heap.now)
            if heap.now < 3.0:
                heap.after(1.0, fire)

        heap.at(1.0, fire)
        heap.run(until=10.0)
        assert log == [1.0, 2.0, 3.0]

    def test_run_backstop_raises_on_runaway(self):
        heap = EventHeap()

        def forever():
            heap.after(0.0, forever)

        heap.at(0.0, forever)
        with pytest.raises(RuntimeError, match="exceeded"):
            heap.run(until=1.0, max_events=100)


def test_replay_bit_identical_under_virtual_clock():
    """Two virtual-clock replays of the same trace submit the identical
    timeline: the determinism the simulator's arrivals inherit."""

    class _Manager:
        replicas = ()

    class RecordingGateway:
        manager = _Manager()

        def __init__(self, clock):
            self.clock = clock
            self.log = []

        def submit(self, req, slo_s=None, tenant=None):
            self.log.append((round(self.clock(), 9), req, tenant))

        def step(self):
            pass

        def pending(self):
            return 0

    trace = loadgen.load_trace("heavy_tail")
    runs = []
    for _ in range(2):
        vc = VirtualClock()
        gw = RecordingGateway(vc)
        out = loadgen.replay(gw, trace, offered_x=1.0, base_rps=50.0,
                             make_request=lambda i: f"r{i}",
                             n_requests=40, clock=vc, sleep=vc.sleep)
        runs.append((gw.log, out["submitted"]))
    assert runs[0] == runs[1]
    assert runs[0][1] == 40


# -- bin-packer fast paths against their rescans ---------------------------

def _random_ledger(rng, n_chips, domain_size, tenants):
    ledger = ChipLedger(range(n_chips))
    for c in range(n_chips):
        roll = rng.random()
        if roll < 0.35:
            t = tenants[int(rng.integers(len(tenants)))]
            ledger.owners[c] = (training_tag(t) if rng.random() < 0.3
                                else serving_tag(t, f"{t}-r{c}"))
        elif roll < 0.45:
            ledger.unhealthy[c] = "sim"
    return TopologyBinPacker(ledger, domain_size=domain_size)


def _naive_place_chip(pk, tenant):
    """place_chip with the conflict table and distances rescanned per
    candidate: the O(chips^2) form the hoisted one must match."""
    own = sorted(pk._pos[c] for c in pk._tenant_chips(tenant))
    own_domains = {p // pk.domain_size for p in own}
    others = sorted(pk._pos[c] for c in pk._other_chips(tenant))
    best, best_key = None, None
    for c in pk._free_healthy():
        p = pk._pos[c]
        if pk._conflicts([c], tenant):
            continue
        key = (p // pk.domain_size in own_domains,
               pk._min_dist(p, others),
               -pk._min_dist(p, own) if own else 0,
               p)
        if best_key is None or key > best_key:
            best, best_key = c, key
    return best


def _naive_place_run(pk, tenant, n, usable_owner=None):
    chips = pk.ledger.chips
    own = set(pk._tenant_chips(tenant))
    best, best_key = None, None
    for start in range(len(chips) - n + 1):
        window = chips[start:start + n]
        ok = True
        for c in window:
            owner = pk.ledger.owners.get(c)
            if c in pk.ledger.unhealthy or not (
                    owner is None or (usable_owner is not None
                                      and owner == usable_owner)):
                ok = False
                break
        if not ok or pk._conflicts(window, tenant):
            continue
        remaining = pk._largest_free_run(exclude=set(window))
        key = (sum(1 for c in window if c in own), remaining, -start)
        if best_key is None or key > best_key:
            best, best_key = tuple(window), key
    return best


class TestBinpackEquivalence:
    def test_min_dist_sorted_matches_linear(self):
        rng = np.random.default_rng(11)
        for _ in range(300):
            positions = sorted(rng.integers(0, 200, size=int(
                rng.integers(0, 12))).tolist())
            pos = int(rng.integers(0, 200))
            assert (TopologyBinPacker._min_dist_sorted(pos, positions)
                    == TopologyBinPacker._min_dist(pos, positions))

    def test_place_chip_matches_per_candidate_rescan(self):
        rng = np.random.default_rng(13)
        tenants = ["a", "b", "c"]
        for _ in range(150):
            pk = _random_ledger(rng, int(rng.integers(8, 40)),
                                int(rng.choice([1, 2, 4])), tenants)
            t = tenants[int(rng.integers(len(tenants)))]
            assert pk.place_chip(t) == _naive_place_chip(pk, t)

    def test_place_run_matches_per_window_rescan(self):
        rng = np.random.default_rng(17)
        tenants = ["a", "b", "c"]
        for _ in range(150):
            pk = _random_ledger(rng, int(rng.integers(8, 40)),
                                int(rng.choice([1, 2, 4])), tenants)
            t = tenants[int(rng.integers(len(tenants)))]
            n = int(rng.integers(1, 6))
            use = training_tag(t) if rng.random() < 0.5 else None
            got = pk.place_run(t, n, usable_owner=use)
            want = _naive_place_run(pk, t, n, usable_owner=use)
            assert (got.chips if got else None) == want

    def test_largest_free_run_excluding_matches_rescan(self):
        rng = np.random.default_rng(19)
        for _ in range(300):
            n = int(rng.integers(4, 30))
            free = [bool(rng.random() < 0.6) for _ in range(n)]
            segs = TopologyBinPacker._free_segments(free)
            seg_starts = [s for s, _ in segs]
            seg_ends = [e for _, e in segs]
            pre = [0] * (len(segs) + 1)
            for i, (s, e) in enumerate(segs):
                pre[i + 1] = max(pre[i], e - s + 1)
            suf = [0] * (len(segs) + 1)
            for i in range(len(segs) - 1, -1, -1):
                s, e = segs[i]
                suf[i] = max(suf[i + 1], e - s + 1)
            lo = int(rng.integers(0, n))
            hi = int(rng.integers(lo, n))
            got = TopologyBinPacker._largest_free_run_excluding(
                segs, seg_starts, seg_ends, pre, suf, lo, hi)
            best = run = 0
            for i, ok in enumerate(free):
                if ok and not (lo <= i <= hi):
                    run += 1
                    best = max(best, run)
                else:
                    run = 0
            assert got == best


def _naive_entitlements(states, capacity):
    ent = {s.spec.name: min(s.spec.floor, s.spec.quota) for s in states}
    remaining = capacity - sum(ent.values())
    by_prio = {}
    for s in states:
        by_prio.setdefault(s.spec.priority, []).append(s)
    for prio in sorted(by_prio, reverse=True):
        if remaining <= 0:
            break
        want = {s.spec.name: min(s.wanted, s.spec.quota)
                for s in by_prio[prio]}
        share = {s.spec.name: s.spec.share for s in by_prio[prio]}
        while remaining > 0:
            under = [n for n in want if ent[n] < want[n]]
            if not under:
                break
            name = min(under, key=lambda n: (ent[n] / share[n], n))
            ent[name] += 1
            remaining -= 1
    return ent


def test_entitlement_heap_matches_argmin_rescan():
    rng = np.random.default_rng(23)
    for _ in range(100):
        states = []
        for i in range(int(rng.integers(1, 20))):
            quota = int(rng.integers(1, 12))
            spec = TenantSpec(
                name=f"t{i:02d}", priority=int(rng.integers(1, 4)),
                quota=quota, floor=int(rng.integers(0, quota + 1)),
                share=float(rng.choice([0.5, 1.0, 2.0])))
            states.append(TenantState(
                spec=spec, kind="serving", chips=frozenset(),
                wanted=int(rng.integers(0, 16))))
        capacity = int(rng.integers(0, 64))
        assert (entitlements(states, capacity)
                == _naive_entitlements(states, capacity))


def test_registry_floor_guard_and_cached_order():
    reg = TenantRegistry(capacity=10)
    reg.add(TenantSpec(name="b", priority=2, quota=6, floor=4), object())
    reg.add(TenantSpec(name="a", priority=2, quota=6, floor=4), object())
    with pytest.raises(ValueError, match="exceed"):
        reg.add(TenantSpec(name="c", priority=1, quota=6, floor=3),
                object())
    assert [s.name for s in reg.by_priority(reverse=False)] == ["a", "b"]
    reg.by_priority().clear()
    assert [s.name for s in reg.by_priority(reverse=False)] == ["a", "b"]
    reg.add(TenantSpec(name="0", priority=3, quota=2, floor=2), object())
    assert [s.name for s in reg.by_priority()] == ["0", "b", "a"]


# -- fleet determinism and O(events) ---------------------------------------

class TestFleetScale:
    def test_same_seed_same_journal_digest(self, tmp_path):
        sched = default_sim_schedule(7, cycles=30)
        r1, f1 = run_sim_soak(sched, tmp_path / "a",
                              config=SimConfig.tiny())
        r2, f2 = run_sim_soak(sched, tmp_path / "b",
                              config=SimConfig.tiny())
        assert f1.journal_digest() == f2.journal_digest()
        assert r1.ok() and r2.ok()

    def test_different_seed_different_journal(self, tmp_path):
        sched = default_sim_schedule(7, cycles=30)
        _, f1 = run_sim_soak(sched, tmp_path / "a",
                             config=SimConfig.tiny(seed=7))
        _, f2 = run_sim_soak(sched, tmp_path / "b",
                             config=SimConfig.tiny(seed=8))
        assert f1.journal_digest() != f2.journal_digest()

    def test_idle_hour_pops_zero_events_at_1000_replicas(self):
        """A thousand idle replicas cost nothing to advance past: the
        headline fleet with no arrivals, gangs parked, the residue
        drained, then an hour of virtual time pops zero events."""
        fleet = build_fleet(SimConfig(seed=7, n_requests=0))
        assert sum(len(fleet.gateways[p].manager.replicas)
                   for p in fleet.pool_names) == 1000
        for sup in fleet.sups.values():
            sup.park()
        fleet.heap.run(until=fleet.heap.now + 5.0)
        before = fleet.heap.processed
        fleet.heap.run(until=fleet.heap.now + 3600.0)
        assert fleet.heap.processed == before
        assert fleet.heap.now >= 3605.0

    def test_contended_ab_fragmentation_split(self):
        spread = build_fleet(SimConfig.contended("spread"))
        packed = build_fleet(SimConfig.contended("packed"))
        spread.recon.tick()
        packed.recon.tick()
        fs, fp = spread.fragmentation(), packed.fragmentation()
        assert fs["free_conflicted"] == fs["free"] > 0
        assert fp["straddled_domains"] == 0
        assert fp["free_conflicted"] < fs["free_conflicted"] / 10
        assert fp["largest_free_block"] > fs["largest_free_block"]


def _burst_schedule(cls=Schedule, event=FaultEvent):
    return cls(seed=7, cycles=30, events=[
        event(id="spike-wave", kind="burst", at_cycle=2, n=24)])


def _spike_events(fleet):
    grants = [t for t, k, i in fleet.recon.events
              if k == "grant" and i.get("tenant") == "spike"]
    drains = [i for t, k, i in fleet.recon.events if k == "reclaim_drain"]
    return grants, drains


class TestDrainStarvationRegression:
    """The pathology the thousand-replica soak found, on the 28-chip
    ``SimConfig.repro()`` testbed: domain-blind drains starve the
    high-priority newcomer; the domain-aware order concentrates them."""

    def test_default_config_concentrates_drains_and_grants(self, tmp_path):
        res, fleet = run_sim_soak(_burst_schedule(), tmp_path,
                                  config=SimConfig.repro())
        grants, drains = _spike_events(fleet)
        assert res.ok(), res.violations
        assert grants, "spike tenant never granted under the fix"
        pk = fleet.packer
        assert len({pk.domain_of(d["chip"]) for d in drains}) == 1

    def test_domain_blind_drains_starve_the_spike(self, tmp_path):
        cfg = SimConfig.repro(mt_config=MtConfig(domain_aware_drain=False))
        res, fleet = run_sim_soak(_burst_schedule(), tmp_path, config=cfg)
        grants, drains = _spike_events(fleet)
        assert not grants
        assert drains, "cascade never even started"
        pk = fleet.packer
        assert len({pk.domain_of(d["chip"]) for d in drains}) > 1
        starved = [m for _, msgs in res.violations for m in msgs
                   if "starvation" in m]
        assert starved, res.violations
        assert "spike" in starved[0]


def test_sim_soak_json_lands_with_digest(tmp_path):
    res, fleet = run_sim_soak(default_sim_schedule(7, cycles=20),
                              tmp_path, config=SimConfig.tiny())
    doc = json.loads((tmp_path / "sim_soak.json").read_text())
    assert doc["journal_digest"] == fleet.journal_digest()
    assert doc["events_processed"] == fleet.heap.processed
    assert doc["config"]["n_replicas"] == 12
    assert doc["violations"] == []


# -- parity with the JAX simulator -----------------------------------------

def _configs(maker: str, fix: bool = True, **kw):
    """The same SimConfig in both packages (each its own MtConfig)."""
    jcfg = getattr(jfleet.SimConfig, maker)(
        mt_config=jten.MtConfig(domain_aware_drain=fix), **kw)
    tcfg = getattr(SimConfig, maker)(
        mt_config=MtConfig(domain_aware_drain=fix), **kw)
    return jcfg, tcfg


def _both(tmp_path, jsched, jcfg, tcfg):
    """One soak in each package over the same schedule (the port's read
    from the JAX schedule's JSON)."""
    tsched = Schedule.from_json(json.loads(json.dumps(jsched.to_json())))
    jres, jf = jrig.run_sim_soak(jsched, tmp_path / "jax", config=jcfg)
    tres, tf = run_sim_soak(tsched, tmp_path / "torch", config=tcfg)
    return (jres, jf), (tres, tf)


def _assert_same_run(j, t):
    (jres, jf), (tres, tf) = j, t
    assert tf.journal == jf.journal
    assert tf.recon.events == jf.recon.events
    assert tf.journal_digest() == jf.journal_digest()
    assert tf.heap.processed == jf.heap.processed
    assert tres.violations == jres.violations
    assert tres.survived_cycles == jres.survived_cycles
    assert tres.fault_kinds_fired == jres.fault_kinds_fired
    assert (tres.submitted, tres.finished) == (jres.submitted,
                                               jres.finished)
    assert tres.gang_failures == jres.gang_failures
    assert tres.compound_mttr_ms == jres.compound_mttr_ms


def test_default_sim_schedule_equals_jax():
    for seed, cycles in ((7, 60), (3, 30)):
        assert default_sim_schedule(seed, cycles).to_json() == \
            jrig.default_sim_schedule(seed, cycles).to_json()


def test_sim_config_presets_equal_jax():
    for maker in ("tiny", "repro", "contended"):
        jcfg, tcfg = _configs(maker)
        jd = {k: v for k, v in vars(jcfg).items() if k != "mt_config"}
        td = {k: v for k, v in vars(tcfg).items() if k != "mt_config"}
        assert td == jd
    assert vars(SimConfig()) == vars(jfleet.SimConfig())


@pytest.mark.parametrize("seed", [7, 8, 11])
def test_tiny_journals_equal_jax(tmp_path, seed):
    jcfg, tcfg = _configs("tiny", seed=seed)
    j, t = _both(tmp_path, jrig.default_sim_schedule(seed, cycles=40),
                 jcfg, tcfg)
    _assert_same_run(j, t)
    assert t[0].ok()
    # the soak summaries are the same file, byte for byte
    assert (tmp_path / "torch" / "sim_soak.json").read_text() == \
        (tmp_path / "jax" / "sim_soak.json").read_text()


@pytest.mark.parametrize("fix", [True, False], ids=["fixed", "prefix"])
def test_repro_journals_equal_jax(tmp_path, fix):
    jcfg, tcfg = _configs("repro", fix=fix)
    j, t = _both(tmp_path, _burst_schedule(jcru.Schedule, jcru.FaultEvent),
                 jcfg, tcfg)
    _assert_same_run(j, t)
    assert t[0].ok() is fix


@pytest.mark.parametrize("placement", ["packed", "spread"])
def test_contended_journals_equal_jax(tmp_path, placement):
    """The A/B shape, cut to 8 cycles around one newcomer burst (the
    grant, or the first cascade steps under spread placement)."""
    jcfg, tcfg = _configs("contended", placement=placement,
                          calm_floor=104)
    sched = jcru.Schedule(seed=7, cycles=8, events=[
        jcru.FaultEvent(id="spike-wave", kind="burst", at_cycle=2, n=48)])
    j, t = _both(tmp_path, sched, jcfg, tcfg)
    _assert_same_run(j, t)
    assert any(k in ("grant", "reclaim_drain") for _, k, _ in
               t[1].recon.events)
    assert t[1].fragmentation() == j[1].fragmentation()
    assert (tmp_path / "torch" / "sim_soak.json").read_text() == \
        (tmp_path / "jax" / "sim_soak.json").read_text()


#: pools that serve long requests, so a reclaimed replica drains for
#: many ticks; every pool hot, floors of 2
BUSY_VICTIMS = dict(n_calm_pools=0, hot_floor=2, n_requests=200,
                    service_s=30.0, hot_weights=(0.4, 0.3, 0.3))


def test_busy_victims_part_at_the_floor_repair(tmp_path):
    """ROADMAP Queue C item 19 in the simulator.  A newcomer's burst on
    the repro fleet with busy pools: every reclaimed replica stays
    draining for many ticks.  The JAX reconciler counts it held and
    drains the same pool again each tick, down to 0 replicas, below its
    floor of 2; the port's counts it given.  The runs agree event for
    event up to the first departure, and that departure is the
    repair's decision: JAX drains pool-2 a fourth time, the port
    (pool-2 at its floor once its drains are counted) turns to pool-1."""
    jcfg, tcfg = _configs("repro", **BUSY_VICTIMS)
    sched = jcru.Schedule(seed=7, cycles=40, events=[
        jcru.FaultEvent(id="spike-wave", kind="burst", at_cycle=4, n=24)])
    (_, jf), (_, tf) = _both(tmp_path, sched, jcfg, tcfg)
    ej, et = jf.recon.events, tf.recon.events
    i = next(i for i, (a, b) in enumerate(zip(ej, et)) if a != b)
    assert ej[:i] == et[:i]
    t_jax, kind_jax, info_jax = ej[i]
    _, kind_port, info_port = et[i]
    assert kind_jax == kind_port == "reclaim_drain"
    assert info_jax["tenant"] == "pool-2" != info_port["tenant"]
    prior = [e for e in ej[:i] if e[1] == "reclaim_drain"
             and e[2]["tenant"] == "pool-2"]
    assert len(prior) == 5 - 2          # 5 replicas down to the floor
    # the gateway journals agree up to the departure's tick
    assert [e for e in jf.journal if e[0] < t_jax] == \
        [e for e in tf.journal if e[0] < t_jax]

    def drained(events, pool):
        return sum(1 for _, k, info in events
                   if k == "reclaim_drain" and info["tenant"] == pool)

    assert drained(ej, "pool-2") == 5   # JAX: below the floor, to 0
    assert drained(et, "pool-2") == 3   # port: held at the floor
    assert jf.journal_digest() != tf.journal_digest()
