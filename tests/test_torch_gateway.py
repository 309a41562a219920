"""Port fleet gateway (k8s_dra_driver_tpu_torch/gateway/, cluster/bus.py,
utils/{dispatch,digest,tracing,metrics}.py) against the JAX package's,
on the CPU in f32 at tests/test_gateway.py's config.

The same requests, the same FaultPlan rules and the same injected clock
go through the JAX gateway over JAX engines and the port gateway over
port engines (parameters carried across by ``params_from_jax``); per-uid
outcomes (status, replica, requeues), greedy tokens, ``stats()`` and the
metric samples (all but ``_created``) must agree.  Sampled tokens come
from per-request ``torch.Generator`` streams, which cannot match
``jax.random``: they are held to a port engine of the same slot count
draining the same requests.  Units: the routers on stub occupancy, the
admission queue, the metric types against ``prometheus_client``, the
bus, the digest bank, the dispatch aggregator and the tracer.  The two
repaired engine faults: ``occupancy()["spec_accept_rate"]`` and the
prefix cache's listener events.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from prometheus_client import CollectorRegistry
from prometheus_client import Counter as PCounter
from prometheus_client import Gauge as PGauge
from prometheus_client import Histogram as PHistogram
from prometheus_client import generate_latest

from k8s_dra_driver_tpu import gateway as jg
from k8s_dra_driver_tpu.cluster import bus as jbus
from k8s_dra_driver_tpu.cluster.faults import FaultPlan
from k8s_dra_driver_tpu.gateway import admission as jadm
from k8s_dra_driver_tpu.models import serving as js
from k8s_dra_driver_tpu.models import transformer as jt
from k8s_dra_driver_tpu.utils import digest as jdig
from k8s_dra_driver_tpu.utils import dispatch as jdispatch
from k8s_dra_driver_tpu.utils import metrics as jmet
from k8s_dra_driver_tpu.utils import tracing as jtr
from k8s_dra_driver_tpu_torch import gateway as tg
from k8s_dra_driver_tpu_torch.cluster import bus as tbus
from k8s_dra_driver_tpu_torch.gateway import admission as tadm
from k8s_dra_driver_tpu_torch.models import serving as ts
from k8s_dra_driver_tpu_torch.models import transformer as tt
from k8s_dra_driver_tpu_torch.models.convert import params_from_jax
from k8s_dra_driver_tpu_torch.utils import digest as tdig
from k8s_dra_driver_tpu_torch.utils import dispatch as tdispatch
from k8s_dra_driver_tpu_torch.utils import metrics as tmet
from k8s_dra_driver_tpu_torch.utils import tracing as ttr

pytestmark = pytest.mark.timeout_s(180)

FIELDS = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
              d_ff=64, max_seq=48, n_kv_heads=2)
JCFG = jt.TransformerConfig(dtype=jnp.float32, **FIELDS)
TCFG = tt.TransformerConfig(dtype=torch.float32, **FIELDS)

#: the two packages, side by side: (gateway package, serving module,
#: Request class) — a scenario is written once and run on each
SIDES = {"jax": (jg, js), "torch": (tg, ts)}


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(np.asarray,
                      jt.init_params(JCFG, jax.random.PRNGKey(0)))
    return {"jax": jp, "torch": params_from_jax(jp, device="cpu")}


def engine_factory(side, params, slots=2, **kw):
    _, srv = SIDES[side]
    if side == "jax":
        return lambda name: srv.ServingEngine(params["jax"], JCFG,
                                              slots=slots, **kw)
    return lambda name: srv.ServingEngine(params["torch"], TCFG,
                                          slots=slots, device="cpu", **kw)


def prompt(seed, n):
    return np.random.default_rng(seed).integers(
        0, FIELDS["vocab"], n).astype(np.int32)


def make_req(side, uid, seed, n_prompt, max_new, temperature=0.0):
    return SIDES[side][1].Request(uid=uid, prompt=prompt(seed, n_prompt),
                                  max_new=max_new, temperature=temperature,
                                  seed=seed)


def burst_reqs(side):
    """Three bursts, two prompt-length classes, every third request
    sampled (tests/test_gateway.py's shape, with sampled rows)."""
    bursts, seed = [], 10
    for b, size in enumerate((4, 3, 4)):
        burst = []
        for i in range(size):
            seed += 1
            burst.append(make_req(side, f"b{b}i{i}", seed,
                                  5 + (i % 2) * 3, 3 + (i % 3),
                                  0.7 if i % 3 == 2 else 0.0))
        bursts.append(burst)
    return bursts


def kill_plan(name="r0"):
    return FaultPlan.from_json({"rules": [
        {"verb": "health", "kind": "Replica", "name": name,
         "skip": 1, "times": 1, "error": "drop"}]})


class Clock:
    """Injected gateway clock: every latency sample is the same on both
    sides."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def samples(gw) -> list[str]:
    return [ln for ln in gw.metrics.render().decode().splitlines()
            if "_created" not in ln]


def port_oracle(params, reqs, slots=2, **kw) -> dict:
    """One port engine of the pool's slot count draining ``reqs``."""
    eng = engine_factory("torch", params, slots=slots, **kw)("oracle")
    for r in reqs:
        eng.submit(ts.Request(uid=r.uid, prompt=r.prompt.copy(),
                              max_new=r.max_new,
                              temperature=r.temperature, seed=r.seed))
    return {f.uid: np.asarray(f.tokens) for f in eng.run()}


def hold_pools(params, gws, reqs_by_side, slots=2, **kw):
    """The JAX and port gateways agree: outcomes, greedy tokens,
    ``stats()`` (per-replica dispatch keys, not labels: the port records
    more), metric samples; sampled tokens equal the port oracle."""
    gj, gt = gws["jax"], gws["torch"]
    assert set(gj.outcomes) == set(gt.outcomes)
    for uid, g in gj.outcomes.items():
        h = gt.outcomes[uid]
        assert (g.status, g.replica, g.requeues) == (
            h.status, h.replica, h.requeues), uid
    sj, st = gj.stats(), gt.stats()
    assert set(sj.pop("per_replica_dispatches")) == set(
        st.pop("per_replica_dispatches"))
    assert sj == st
    assert samples(gj) == samples(gt)
    treqs = reqs_by_side["torch"]
    sampled = [r for r in treqs if r.temperature > 0]
    oracle = port_oracle(params, sampled, slots=slots, **kw) \
        if sampled else {}
    for r in treqs:
        if r.uid not in gt.results:
            continue
        got = np.asarray(gt.results[r.uid].tokens)
        want = (oracle[r.uid] if r.temperature > 0
                else np.asarray(gj.results[r.uid].tokens))
        np.testing.assert_array_equal(got, want, err_msg=r.uid)


# -- whole pools, JAX gateway over JAX engines vs port over port engines ---

def kill_mid_stream(side, params):
    clock = Clock()
    gw_pkg = SIDES[side][0]
    mgr = gw_pkg.ReplicaManager(engine_factory(side, params), replicas=2,
                                fault_plan=kill_plan())
    gw = gw_pkg.FleetGateway(mgr, queue_capacity=32, clock=clock)
    bursts = burst_reqs(side)
    for burst in bursts:
        for req in burst:
            assert gw.submit(req, slo_s=120.0).status == "queued"
        gw.step()
        clock.advance(0.25)
    gw.run_until_idle()
    return gw, [r for b in bursts for r in b]


def test_kill_mid_stream_matches_jax(params):
    """The acceptance: two replicas, bursty arrivals, r0 killed by the
    FaultPlan after its first dispatch wave; exactly once, the same
    outcomes, tokens, stats and metric samples as the JAX gateway."""
    gws, reqs = {}, {}
    for side in SIDES:
        gws[side], reqs[side] = kill_mid_stream(side, params)
    hold_pools(params, gws, reqs)
    gt = gws["torch"]
    assert all(g.status == "finished" for g in gt.outcomes.values())
    assert len(gt.outcomes) == len(reqs["torch"])
    st = gt.stats()
    assert st["replicas"]["dead"] == 1 and st["replicas"]["ready"] == 2
    requeued = [g for g in gt.outcomes.values() if g.requeues > 0]
    assert requeued
    text = gt.metrics.render().decode()
    assert re.search(r"tpu_gateway_drains_total 1\.0", text)
    m = re.search(r"tpu_gateway_requeued_total (\d+)\.0", text)
    assert m and int(m.group(1)) == len(requeued)
    m = re.search(r"tpu_gateway_queue_wait_seconds_count (\d+)\.0", text)
    assert int(m.group(1)) == len(reqs["torch"]) + len(requeued)
    m = re.search(r"tpu_gateway_ttft_seconds_count (\d+)\.0", text)
    assert int(m.group(1)) == len(reqs["torch"])


def test_chip_health_signal_drains_the_mapped_replica(params):
    gws, reqs = {}, {}
    for side, (gw_pkg, _) in SIDES.items():
        unhealthy: dict = {}
        clock = Clock()
        mgr = gw_pkg.ReplicaManager(
            engine_factory(side, params), replicas=2,
            health_source=lambda u=unhealthy: u,
            chip_of=lambda name: int(name[1:]))
        gw = gw_pkg.FleetGateway(mgr, queue_capacity=8, clock=clock)
        reqs[side] = [make_req(side, f"u{i}", 30 + i, 5, 4,
                               0.8 if i == 3 else 0.0) for i in range(4)]
        for r in reqs[side]:
            gw.submit(r, slo_s=60.0)
        gw.step()
        unhealthy[0] = "device node vanished"
        clock.advance(1.0)
        gw.run_until_idle()
        assert gw.stats()["replicas"]["dead"] == 1
        assert len(mgr.replicas) == 2
        assert all(r.chip != 0 for r in mgr.replicas)
        gws[side] = gw
    hold_pools(params, gws, reqs)


def test_shed_and_reject_under_overload_match_jax(params):
    gws = {}
    for side, (gw_pkg, _) in SIDES.items():
        clock = Clock()
        mgr = gw_pkg.ReplicaManager(engine_factory(side, params, slots=1),
                                    replicas=1)
        gw = gw_pkg.FleetGateway(mgr, queue_capacity=2, clock=clock)
        recs = [gw.submit(make_req(side, f"u{i}", 40 + i, 5, 3), slo_s=5.0)
                for i in range(4)]
        assert [g.status for g in recs] == ["queued"] * 2 + [
            tadm.REJECTED_FULL] * 2
        clock.advance(10.0)
        done = gw.run_until_idle()
        assert sorted(g.uid for g in done) == ["u0", "u1"]
        assert {g.status for g in done} == {tadm.SHED_EXPIRED}
        gws[side] = gw
    hold_pools(params, gws, {"torch": []})
    text = gws["torch"].metrics.render().decode()
    assert 'outcome="rejected_full"} 2.0' in text
    assert 'outcome="shed_expired"} 2.0' in text
    assert gws["torch"].stats()["outcomes"] == {tadm.SHED_EXPIRED: 2,
                                                tadm.REJECTED_FULL: 2}


@pytest.mark.parametrize("survivor", [False, True],
                         ids=["victim_alone", "survivor_behind"])
def test_expired_victim_requeue_sheds_not_crashes(params, survivor):
    """A drain victim already past its deadline is shed at the queue
    front in the same step (never dispatched dead, the pump never
    crashes), and live work behind it is still placed."""
    gws, reqs = {}, {}
    for side, (gw_pkg, _) in SIDES.items():
        clock = Clock()
        mgr = gw_pkg.ReplicaManager(
            engine_factory(side, params, slots=1 if survivor else 2),
            replicas=1, fault_plan=kill_plan(),
            depth_bound=1 if survivor else None)
        gw = gw_pkg.FleetGateway(mgr, queue_capacity=4, clock=clock)
        reqs[side] = [make_req(side, "victim", 90, 5, 3)]
        if survivor:
            reqs[side].append(make_req(side, "survivor", 92, 5, 3))
        for r, slo in zip(reqs[side], (1.0, 60.0)):
            gw.submit(r, slo_s=slo)
        gw.step()
        assert mgr.replicas[0].in_flight
        clock.advance(5.0)
        done = gw.step()
        assert ("victim", tadm.SHED_EXPIRED) in [(g.uid, g.status)
                                                 for g in done]
        assert gw.outcomes["victim"].requeues == 1
        rest = gw.run_until_idle()
        assert [g.uid for g in rest] == (["survivor"] if survivor else [])
        gws[side] = gw
    hold_pools(params, gws, reqs, slots=1 if survivor else 2)
    text = gws["torch"].metrics.render().decode()
    assert re.search(r"tpu_gateway_requeued_total 1\.0", text)
    assert 'outcome="shed_expired"} 1.0' in text


def test_unrunnable_request_rejected_invalid(params):
    mgr = tg.ReplicaManager(engine_factory("torch", params), replicas=1)
    gw = tg.FleetGateway(mgr, queue_capacity=4)
    gw.submit(ts.Request(uid="big", prompt=prompt(80, 40), max_new=20))
    gw.submit(make_req("torch", "ok", 81, 5, 3))
    done = gw.run_until_idle()
    assert {g.uid: g.status for g in done} == {
        "big": tg.REJECTED_INVALID, "ok": "finished"}


def test_uid_reuse_after_finish_starts_fresh_lifecycle(params):
    gw = tg.FleetGateway(tg.ReplicaManager(engine_factory("torch", params),
                                           replicas=1), queue_capacity=4)
    gw.submit(make_req("torch", "u", 70, 5, 3))
    gw.run_until_idle()
    first = np.asarray(gw.results["u"].tokens).copy()
    assert gw.submit(make_req("torch", "u", 70, 5, 3)).status == "queued"
    gw.run_until_idle()
    np.testing.assert_array_equal(gw.results["u"].tokens, first)
    gw.submit(make_req("torch", "v", 71, 5, 3))
    assert gw.submit(make_req("torch", "v", 72, 5, 3)).status \
        == tg.REJECTED_DUPLICATE
    gw.run_until_idle()


def test_per_replica_dispatch_attribution(params):
    """The port's dispatch counter attributes launches per replica, and
    the per-replica sum equals the global delta over the drain."""
    gw = tg.FleetGateway(tg.ReplicaManager(engine_factory("torch", params),
                                           replicas=2), queue_capacity=8)
    with tdispatch.track() as t:
        for i in range(4):
            gw.submit(make_req("torch", f"u{i}", 60 + i, 5, 3))
        gw.run_until_idle()
    per = gw.stats()["per_replica_dispatches"]
    assert set(per) == {"r0", "r1"}
    assert sum(v["dispatches"] for v in per.values()) == t.dispatches
    assert sum(v["readbacks"] for v in per.values()) == t.readbacks


def test_prefix_affinity_beats_round_robin(params):
    """On a shared-prefix workload affinity routing pays strictly fewer
    fresh prefills than round robin, and the outputs are identical."""
    rng = np.random.default_rng(0)
    pre = rng.integers(0, 64, 8).astype(np.int32)
    protos = [(f"u{i}", np.concatenate(
        [pre, rng.integers(0, 64, 4 + (i % 2)).astype(np.int32)]))
        for i in range(6)]

    def drain(router):
        mgr = tg.ReplicaManager(engine_factory("torch", params,
                                               prefix_cache=2),
                                replicas=2, depth_bound=len(protos))
        gw = tg.FleetGateway(mgr, router=router, queue_capacity=16)
        with tdispatch.track() as t:
            for uid, pr in protos:
                gw.submit(ts.Request(uid=uid, prompt=pr.copy(), max_new=3))
            gw.run_until_idle()
        return (t.by_label.get("prefill_adopt_rows", 0)
                + t.by_label.get("prefill", 0)), gw

    fresh_aff, gw_aff = drain(tg.PrefixAffinityRouter())
    fresh_rr, gw_rr = drain(tg.RoundRobinRouter())
    assert fresh_aff < fresh_rr
    assert len({g.replica for g in gw_aff.outcomes.values()}) < len(
        {g.replica for g in gw_rr.outcomes.values()})
    for uid in gw_aff.results:
        np.testing.assert_array_equal(gw_aff.results[uid].tokens,
                                      gw_rr.results[uid].tokens)


def test_prefix_metrics_fold_matches_jax(params):
    """Prefix hits/misses/bytes arrive through the port cache's
    ``stats_listeners`` and fold into the same samples as JAX's."""
    gws = {}
    for side, (gw_pkg, srv) in SIDES.items():
        rng = np.random.default_rng(0)
        pre = rng.integers(0, 64, 8).astype(np.int32)
        mgr = gw_pkg.ReplicaManager(engine_factory(side, params,
                                                   prefix_cache=2),
                                    replicas=1)
        gw = gw_pkg.FleetGateway(mgr, queue_capacity=16, clock=Clock())
        for i in range(4):
            tail = rng.integers(0, 64, 4).astype(np.int32)
            gw.submit(srv.Request(uid=f"u{i}",
                                  prompt=np.concatenate([pre, tail]),
                                  max_new=2))
        gw.run_until_idle()
        gws[side] = gw
    assert samples(gws["jax"]) == samples(gws["torch"])
    text = gws["torch"].metrics.render().decode()
    hits = float(re.search(r"tpu_gateway_prefix_hits_total (\d+)\.0",
                           text).group(1))
    reused = float(re.search(
        r"tpu_gateway_prefix_bytes_reused_total (\d+)\.0", text).group(1))
    assert hits >= 3 and reused == gws["torch"].manager.replicas[
        0].engine.stats()["prefix_bytes_reused_total"]


def test_traced_pool_emits_jax_span_chain(params):
    """With a tracer, the port gateway emits the JAX gateway's span
    sequence (names, tracks, attrs; one ``spans`` bus event a step)."""
    chains = {}
    for side, (gw_pkg, _) in SIDES.items():
        tr_mod, bus_mod = (jtr, jbus) if side == "jax" else (ttr, tbus)
        clock = Clock()
        bus = bus_mod.EventBus(seed=3)
        tracer = tr_mod.Tracer(bus=bus, clock=clock)
        mgr = gw_pkg.ReplicaManager(engine_factory(side, params),
                                    replicas=2, fault_plan=kill_plan())
        gw = gw_pkg.FleetGateway(mgr, queue_capacity=32, clock=clock,
                                 bus=bus, tracer=tracer)
        for burst in burst_reqs(side):
            for req in burst:
                gw.submit(req, slo_s=120.0)
            gw.step()
            clock.advance(0.25)
        gw.run_until_idle()
        chains[side] = ([{k: v for k, v in s.items()}
                         for s in tracer.spans], bus.journal_topics())
    assert chains["jax"] == chains["torch"]


# -- the engine faults repaired at this seam -------------------------------

@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_occupancy_spec_accept_rate_equals_jax(params, layout):
    """After the same greedy n-gram drain, the port engine's
    ``occupancy()["spec_accept_rate"]`` equals the JAX engine's."""
    kw = dict(draft_source="ngram", draft_len=2)
    if layout == "paged":
        kw.update(kv_layout="paged", kv_block_size=8)
    rates = {}
    for side in SIDES:
        eng = engine_factory(side, params, **kw)("e")
        assert "spec_accept_rate" in eng.occupancy()
        for i in range(4):
            eng.submit(make_req(side, f"u{i}", 70 + i, 5 + i, 6))
        eng.run()
        rates[side] = eng.occupancy()["spec_accept_rate"]
        assert rates[side] == eng.stats()["spec_accept_rate"]
    assert rates["jax"] == rates["torch"]
    plain = engine_factory("torch", params)("p").occupancy()
    assert "spec_accept_rate" not in plain


def test_spec_accept_ewma_folds_into_metrics(params):
    """A speculative pool folds each replica's accept rate into a
    per-replica EWMA and the ``tpu_gateway_spec_accept_rate`` gauge; a
    plain pool folds and exports nothing."""
    mgr = tg.ReplicaManager(engine_factory("torch", params,
                                           draft_source="ngram",
                                           draft_len=2), replicas=2)
    gw = tg.FleetGateway(mgr, queue_capacity=8)
    for i in range(4):
        gw.submit(make_req("torch", f"u{i}", 70 + i, 5, 4))
    assert len(gw.run_until_idle()) == 4
    ewma = gw._spec_accept_ewma
    assert ewma and set(ewma) <= {"r0", "r1"}
    assert all(0.0 <= v <= 1.0 for v in ewma.values())
    text = gw.metrics.render().decode()
    m = re.search(r'tpu_gateway_spec_accept_rate\{replica="r0"\} '
                  r'([0-9.]+)', text)
    assert m and 0.0 <= float(m.group(1)) <= 1.0
    plain = tg.FleetGateway(tg.ReplicaManager(
        engine_factory("torch", params), replicas=2), queue_capacity=8)
    plain.submit(make_req("torch", "p0", 75, 5, 3))
    plain.run_until_idle()
    assert plain._spec_accept_ewma == {}
    assert "tpu_gateway_spec_accept_rate{" not in \
        plain.metrics.render().decode()


def cache_events(cache_cls, entries_of):
    """Drive one insert/lookup/evict/drop sequence through a prefix
    cache; returns its (event, key) and (event, tokens, nbytes)
    streams.  A raising listener rides first on both lists."""
    cache = cache_cls(2)
    ev, st = [], []

    def boom(*_):
        raise RuntimeError("a broken tap")

    cache.listeners += [boom, lambda e, k: ev.append((e, k))]
    cache.stats_listeners += [boom, lambda e, t, n: st.append((e, t, n))]
    a, b, c = prompt(1, 6), prompt(2, 5), prompt(3, 7)
    cache.insert(a, entries_of(a.size))
    cache.longest_prefix(np.concatenate([a, prompt(4, 3)]))
    cache.longest_prefix(prompt(5, 4) + 70)          # a miss
    cache.insert(b, entries_of(b.size))
    cache.insert(a, entries_of(a.size))               # re-insert
    cache.insert(c, entries_of(c.size))               # evicts b
    cache.longest_prefix(np.concatenate([c[:4], prompt(6, 2)]))
    cache.drop(a)
    cache.drop(a)                                     # absent: silent
    return ev, st


def test_prefix_cache_events_equal_jax():
    """The port's contiguous ``PrefixCache`` fires the JAX cache's
    events at the JAX points: the same streams on one sequence."""
    from k8s_dra_driver_tpu.models import decode as jdec
    from k8s_dra_driver_tpu_torch.models import decode as tdec

    ev_j, st_j = cache_events(js.PrefixCache,
                              lambda n: jdec.init_cache(JCFG, 1))
    ev_t, st_t = cache_events(
        ts.PrefixCache, lambda n: tdec.init_cache(TCFG, 1, device="cpu"))
    assert ev_t == ev_j
    assert st_t == st_j
    assert [e for e, _ in ev_t] == ["insert", "insert", "insert",
                                    "insert", "evict", "drop"]
    assert [e for e, _, _ in st_t] == ["hit", "miss", "hit"]


# -- routers on stub occupancy ---------------------------------------------

class StubReplica:
    def __init__(self, name, depth=0, bound=4, peek=0, accept=None,
                 occ=None, residency=None):
        self.name = name
        self.ready = True
        self.depth_bound = bound
        self._depth = depth
        self._peek = peek
        self.accept = accept
        self.extra = dict(occ or {})
        if residency is not None:
            self.prefix_residency = lambda pr: residency

    def occupancy(self):
        occ = {"active": self._depth, "pending": 0, "free_slots": 0,
               "slots": 2, "depth": self._depth, "tokens": {}}
        if self.accept is not None:
            occ["spec_accept_rate"] = self.accept
        occ.update(self.extra)
        return occ

    def prefix_peek(self, prompt):
        return self._peek


PR12 = np.arange(12, dtype=np.int32)

#: name -> (replicas, router name, router kwargs, hints, route calls)
ROUTER_CASES = {
    "affinity_prefers_cached": (
        [dict(name="r0", depth=3, peek=8), dict(name="r1")],
        "PrefixAffinityRouter", {"min_affinity": 4}, {}, 1),
    "cold_spill_least_depth": (
        [dict(name="r0", depth=3), dict(name="r1", depth=1)],
        "PrefixAffinityRouter", {}, {}, 1),
    "burst_follows_history": (
        [dict(name="r0"), dict(name="r1")],
        "PrefixAffinityRouter", {"min_affinity": 4}, {}, 3),
    "depth_bound_affinity": (
        [dict(name="r0", depth=4), dict(name="r1", depth=4)],
        "PrefixAffinityRouter", {}, {}, 1),
    "depth_bound_round_robin": (
        [dict(name="r0", depth=4), dict(name="r1", depth=4)],
        "RoundRobinRouter", {}, {}, 1),
    "depth_bound_least_loaded": (
        [dict(name="r0", depth=4), dict(name="r1", depth=4)],
        "LeastLoadedRouter", {}, {}, 1),
    "round_robin_alternates": (
        [dict(name="r0"), dict(name="r1"), dict(name="r2")],
        "RoundRobinRouter", {}, {}, 5),
    "best_effort_ignores_accept": (
        [dict(name="r0", depth=1), dict(name="r1", depth=1, accept=0.9)],
        "LeastLoadedRouter", {}, {}, 1),
    "slo_tight_prefers_accept": (
        [dict(name="r0", depth=1), dict(name="r1", depth=1, accept=0.9)],
        "LeastLoadedRouter", {}, {"slo_tight": True}, 1),
    "accept_decile_jitter": (
        [dict(name="r0", depth=1, accept=0.88),
         dict(name="r1", depth=1, accept=0.83)],
        "LeastLoadedRouter", {}, {"slo_tight": True}, 1),
    "affinity_spill_accept": (
        [dict(name="r0", depth=1), dict(name="r1", depth=1, accept=0.7)],
        "PrefixAffinityRouter", {"min_affinity": 4},
        {"slo_tight": True}, 1),
    "kv_headroom_gate": (
        [dict(name="r0", occ={"kv_headroom_blocks": 0,
                              "kv_block_size": 8}),
         dict(name="r1", depth=2, occ={"kv_headroom_blocks": 2,
                                       "kv_block_size": 8})],
        "LeastLoadedRouter", {}, {}, 1),
    "kv_headroom_tiebreak": (
        [dict(name="r0", occ={"kv_headroom_blocks": 3,
                              "kv_block_size": 8}),
         dict(name="r1", occ={"kv_headroom_blocks": 9,
                              "kv_block_size": 8})],
        "LeastLoadedRouter", {}, {}, 1),
    "adapter_gate": (
        [dict(name="r0", occ={"adapter_resident": ["b"],
                              "adapter_headroom_slots": 0}),
         dict(name="r1", depth=2, occ={"adapter_resident": [],
                                       "adapter_headroom_slots": 1})],
        "LeastLoadedRouter", {}, {"adapter": "a"}, 1),
    "adapter_resident_wins": (
        [dict(name="r0", occ={"adapter_resident": [],
                              "adapter_headroom_slots": 2}),
         dict(name="r1", occ={"adapter_resident": ["a"],
                              "adapter_headroom_slots": 0})],
        "PrefixAffinityRouter", {}, {"adapter": "a"}, 1),
    "tier_device_beats_host": (
        [dict(name="r0", peek=0, residency=(8, "host")),
         dict(name="r1", peek=8, residency=(8, "device"))],
        "PrefixAffinityRouter", {"min_affinity": 4}, {}, 1),
}


def route_names(pkg, case):
    reps, router_name, rkw, hints, calls = case
    replicas = [StubReplica(**kw) for kw in reps]
    router = getattr(pkg, router_name)(**rkw)
    for k, v in hints.items():
        setattr(router, k, v)
    out = []
    for _ in range(calls):
        pick = router.route(PR12.copy(), replicas)
        out.append((None if pick is None else pick.name,
                    router.last_reason if pick is not None else None))
    return out


@pytest.mark.parametrize("case", sorted(ROUTER_CASES))
def test_router_choices_equal_jax(case):
    want = route_names(jg, ROUTER_CASES[case])
    assert route_names(tg, ROUTER_CASES[case]) == want
    assert want[0][0] is not None or case.startswith("depth_bound")


def test_forget_unbinds_a_drained_replica():
    for pkg in (jg, tg):
        r0, r1 = StubReplica("r0"), StubReplica("r1")
        router = pkg.PrefixAffinityRouter(min_affinity=4)
        assert router.route(PR12, [r0, r1]) is r0
        router.forget("r0")
        r0.ready = False
        assert router.route(PR12.copy(), [r0, r1]) is r1


# -- admission queue --------------------------------------------------------

def admission_trace(adm, srv):
    q = adm.AdmissionQueue(capacity=3)
    log = []

    def req(uid):
        return srv.Request(uid=uid, prompt=np.ones(3, np.int32), max_new=1)

    for uid, t, slo in (("a", 0.0, 9.0), ("b", 1.0, 1.0), ("c", 1.0, None),
                        ("a", 2.0, None), ("d", 2.0, None)):
        try:
            g = q.offer(req(uid), t, slo_s=slo,
                        live_uids=frozenset({"x"}))
            log.append(("ok", uid, g.deadline_s))
        except adm.AdmissionError as e:
            log.append((e.status, uid))
    log.append(("shed", [g.uid for g in q.shed_expired(3.0)]))
    g = q.pop(3.0)
    log.append(("pop", g.uid))
    q.requeue(g)
    log.append(("requeued", q.uids(), g.requeues, g.deadline_s))
    log.append(("steal", q.steal_newest().uid, q.uids()))
    log.append(("expired_pop", q.pop(100.0)))
    return log


def test_admission_queue_equals_jax():
    assert admission_trace(tadm, ts) == admission_trace(jadm, js)


# -- metric types against prometheus_client --------------------------------

def metric_script(Counter, Gauge, Histogram, registry):
    """One update script over every type: labelled and not, escaping,
    negative buckets (no ``_sum``), Go float formatting."""
    c = Counter("a_total", "help \\ c\nmore", ["outcome"], registry=registry)
    c.labels(outcome='x"y\\z\nw').inc()
    c.labels(outcome="ok").inc(2.5)
    d = Counter("b_drains", "help b", registry=registry)
    d.inc(123456789012)
    g = Gauge("g", "help g", ["state", "role"], registry=registry)
    g.labels(state="ready", role="decode").set(3)
    g.labels(role="prefill", state="dead").set(1e-5)
    Gauge("g_empty", "never set", registry=registry)
    h = Histogram("h_seconds", "help h", registry=registry,
                  buckets=(.0005, .001, .5, 1, 30))
    for v in (0.0001, 0.3, 2.0, 1e9):
        h.observe(v)
    m = Histogram("m_seconds", "signed", ["tenant"], registry=registry,
                  buckets=(-30.0, -1.0, 0.0, 1.0))
    m.labels(tenant="t1").observe(-2.0)
    m.labels(tenant="t0").observe(0.5)
    Histogram("never", "no children", ["tenant"], registry=registry,
              buckets=(1,))


def test_metric_types_render_prometheus_samples():
    reg = CollectorRegistry()
    metric_script(PCounter, PGauge, PHistogram, reg)
    want = [ln for ln in generate_latest(reg).decode().splitlines()
            if "_created" not in ln]
    ours = tmet.Registry()
    metric_script(tmet.Counter, tmet.Gauge, tmet.Histogram, ours)
    assert ours.render().decode().splitlines() == want


def test_counter_refuses_negative_and_unlabelled_use():
    reg = tmet.Registry()
    c = tmet.Counter("c", "h", ["x"], registry=reg)
    with pytest.raises(ValueError):
        c.inc()
    with pytest.raises(ValueError):
        c.labels(x="1").inc(-1)
    with pytest.raises(ValueError):
        tmet.Histogram("h", "h", registry=reg, buckets=(2, 1))


def test_gateway_metrics_render_equals_jax():
    """Every family of ``GatewayMetrics`` (names, HELP, labels, buckets)
    renders the JAX registry's samples for the same updates, digest
    summaries included."""
    outs = []
    for mod in (jmet, tmet):
        m = mod.GatewayMetrics()
        bank = (jdig if mod is jmet else tdig).DigestBank(("ttft",))
        for v in (0.01, 0.2, 3.0):
            bank.observe("ttft", v)
        m.add_digest_source(lambda b=bank: b, tenant="t")
        m.requests.labels(outcome="finished_attained").inc()
        m.slo_margin_seconds.observe(-0.3)
        m.kv_migrate_seconds.observe(0.004)
        m.tenant_burn_rate.labels(tenant="t", window="fast").set(2.0)
        m.kv_blocks_free.labels(replica="d1").set(40)
        outs.append([ln for ln in m.render().decode().splitlines()
                     if "_created" not in ln])
    assert outs[0] == outs[1]


# -- bus, digest, dispatch aggregation --------------------------------------

def bus_trace(mod):
    bus = mod.EventBus(seed=5, journal=8)
    seen = []
    bus.subscribe("a", lambda ev: seen.append(("a", ev.payload["n"])))
    bus.subscribe("a", lambda ev: 1 / 0)
    bus.subscribe("b", lambda ev: bus.publish("a", n=-ev.payload["n"]))
    for i in range(6):
        bus.publish("b" if i % 2 else "a", n=i, big=list(range(20)),
                    f=float("nan"))
    delivered = bus.pump()
    return (seen, delivered, bus.errors, bus.journal_topics(),
            bus.journal_dump(limit=3), bus.shuffle(range(10)),
            bus.published_total, bus.delivered_total, bus.topics())


def test_event_bus_equals_jax():
    # NaN payloads summarize to "nan" strings, so the dumps compare
    assert bus_trace(tbus) == bus_trace(jbus)


def test_digest_bank_equals_jax():
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.exponential(0.05, 300),
                           -rng.exponential(1.0, 50), [0.0] * 5])
    out = []
    for mod in (jdig, tdig):
        a, b = mod.DigestBank(("x",)), mod.DigestBank(("x",))
        for i, v in enumerate(vals):
            (a if i % 2 else b).observe("x", float(v))
        merged = mod.DigestBank.merged([a, b])
        out.append((merged.to_json(), merged.snapshot(),
                    [merged.get("x").quantile(q)
                     for q in (0.01, 0.5, 0.99)]))
    assert out[0] == out[1]


def test_dispatch_aggregator_equals_jax():
    snaps = []
    for mod in (jdispatch, tdispatch):
        agg = mod.Aggregator()
        for key, labels in (("r0", {"prefill": 2}), ("r1", {"x": 1}),
                            ("r0", {"prefill": 1, "readback:y": 1})):
            t = mod.Tracked()
            t.dispatches = sum(v for k, v in labels.items()
                               if not k.startswith("readback"))
            t.readbacks = sum(v for k, v in labels.items()
                              if k.startswith("readback"))
            t.by_label = dict(labels)
            agg.add(key, t)
        snaps.append(agg.snapshot())
    assert snaps[0] == snaps[1]
    with tdispatch.track() as t:
        tdispatch.record("probe_label", 3)
    assert t.by_label == {"probe_label": 3} and t.dispatches == 3


# -- replica manager --------------------------------------------------------

class _StubEngine:
    slots = 2


def test_probe_failure_keeps_last_observed_state():
    state = {"fail": False, "unhealthy": {}}

    def probe():
        if state["fail"]:
            raise RuntimeError("probe transport down")
        return dict(state["unhealthy"])

    mgr = tg.ReplicaManager(lambda name: _StubEngine(), replicas=2,
                            health_source=probe,
                            chip_of=lambda name: int(name[1:]))
    assert mgr.poll_down() == []
    state["unhealthy"] = {0: "thermal trip"}
    assert [r.name for r in mgr.poll_down()] == ["r0"]
    state["fail"] = True
    assert [r.name for r in mgr.poll_down()] == ["r0"]
    assert mgr.replicas[1].ready
    state["fail"] = False
    state["unhealthy"] = {}
    assert mgr.poll_down() == []


def test_replace_compacts_dead_replicas_and_leases_cycle():
    events = []

    class Lease:
        def __init__(self, name):
            self.name = name

        def acquire(self):
            events.append(("acquire", self.name))

        def heartbeat(self):
            events.append(("heartbeat", self.name))

        def release(self):
            events.append(("release", self.name))

    mgr = tg.ReplicaManager(lambda name: _StubEngine(), replicas=2,
                            lease_factory=Lease)
    for i in range(3):
        victim = mgr.replicas[0]
        mgr.mark_down(victim)
        mgr.replace(victim)
        assert victim not in mgr.replicas and len(mgr.replicas) == 2
        assert mgr.counts() == {"ready": 2, "draining": 0, "dead": i + 1,
                                "retired": 0, "roles": {"unified": 2}}
    mgr.heartbeat()
    assert events[:2] == [("acquire", "r0"), ("acquire", "r1")]
    assert [e for e in events if e[0] == "release"] == [
        ("release", "r0"), ("release", "r1"), ("release", "r2")]
    assert events[-2:] == [("heartbeat", r.name) for r in mgr.replicas]
