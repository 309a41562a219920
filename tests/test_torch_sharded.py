"""Port in-process sharded gateway (k8s_dra_driver_tpu_torch/gateway/
sharded.py), its load generator (gateway/loadgen.py, sim/clock.py) and
the control-plane ceiling probe (gateway/ctlprobe.py) against the JAX
package's, on the CPU.

The same requests through JAX's ``ShardedGateway`` over JAX engines
and the port's over port engines (weights carried across by
``params_from_jax``, 2 layers at narrow widths, f32), on each package's
``VirtualClock``: the same shard for every prompt, the same door
spills and steals, every request exactly once, and the same token
streams — through a replica killed mid-stream under bursty
trace-replay arrivals (tests/test_control_plane.py's acceptance
scenario) with the same event order.  The trace fixtures are JAX's
files byte for byte and the port's generators reproduce them.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu import gateway as jg
from k8s_dra_driver_tpu.cluster.faults import FaultPlan as JFaultPlan
from k8s_dra_driver_tpu.gateway import ctlprobe as jctl
from k8s_dra_driver_tpu.gateway import loadgen as jlg
from k8s_dra_driver_tpu.models import serving as js
from k8s_dra_driver_tpu.models import transformer as jt
from k8s_dra_driver_tpu_torch import gateway as tg
from k8s_dra_driver_tpu_torch.cluster.faults import FaultPlan as TFaultPlan
from k8s_dra_driver_tpu_torch.gateway import ctlprobe as tctl
from k8s_dra_driver_tpu_torch.gateway import loadgen as tlg
from k8s_dra_driver_tpu_torch.models import serving as ts
from k8s_dra_driver_tpu_torch.models import transformer as tt
from k8s_dra_driver_tpu_torch.models.convert import params_from_jax
from k8s_dra_driver_tpu_torch.sim import clock as tclock

pytestmark = pytest.mark.timeout_s(180)

FIELDS = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
              d_ff=64, max_seq=48, n_kv_heads=2)
JCFG = jt.TransformerConfig(dtype=jnp.float32, **FIELDS)
TCFG = tt.TransformerConfig(dtype=torch.float32, **FIELDS)

#: each package's (gateway package, serving module, load generator,
#: FaultPlan): a scenario is written once and run on both
SIDES = {"jax": (jg, js, jlg, JFaultPlan), "torch": (tg, ts, tlg, TFaultPlan)}


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(np.asarray,
                      jt.init_params(JCFG, jax.random.PRNGKey(0)))
    return {"jax": jp, "torch": params_from_jax(jp, device="cpu")}


def prompt(seed, n):
    return np.random.default_rng(seed).integers(
        0, FIELDS["vocab"], n).astype(np.int32)


def make_req(side, uid, seed, n_prompt, max_new):
    return SIDES[side][1].Request(uid=uid, prompt=prompt(seed, n_prompt),
                                  max_new=max_new)


def real_pool(side, params, replicas=2, slots=2, **kw):
    gw, srv = SIDES[side][:2]
    if side == "jax":
        def factory(name):
            return srv.ServingEngine(params["jax"], JCFG, slots=slots)
    else:
        def factory(name):
            return srv.ServingEngine(params["torch"], TCFG, slots=slots,
                                     device="cpu")
    return gw.ReplicaManager(factory, replicas=replicas, **kw)


def null_pool(side, replicas=2, slots=4):
    gw = SIDES[side][0]
    return gw.ReplicaManager(lambda name: gw.NullEngine(slots=slots),
                             replicas=replicas, depth_bound=slots)


def outcomes(gw) -> dict:
    return {u: (g.status, g.replica, g.requeues)
            for u, g in gw.outcomes.items()}


# -- sharded pump semantics, both packages ---------------------------------

def test_door_spill_equal():
    """A full home shard spills to the least-loaded sibling; the fifth
    request is refused only when the TIER is full."""
    got = {}
    for side, (gw_mod, srv, lg, _) in SIDES.items():
        gw = gw_mod.ShardedGateway(null_pool(side, replicas=1, slots=1),
                                   pumps=2, queue_capacity=2,
                                   clock=lg.VirtualClock(), steal=False,
                                   seed=0)
        pr = np.arange(6, dtype=np.int32)
        recs = [gw.submit(srv.Request(uid=f"s{i}", prompt=pr.copy(),
                                      max_new=1)) for i in range(5)]
        got[side] = ([g.status for g in recs],
                     [p.queue.uids() for p in gw.pumps], gw._shard(pr))
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == ["queued"] * 4 + ["rejected_full"]


def test_work_stealing_equal():
    """All traffic on one shard: the idle pump steals the backlog tail,
    the same steals in both packages, every request finished once."""
    got = {}
    for side, (gw_mod, srv, lg, _) in SIDES.items():
        gw = gw_mod.ShardedGateway(null_pool(side, replicas=2, slots=2),
                                   pumps=2, queue_capacity=16,
                                   clock=lg.VirtualClock(step_cost_s=1e-4),
                                   seed=3)
        pr = np.arange(8, dtype=np.int32)
        for i in range(10):
            gw.submit(srv.Request(uid=f"w{i}", prompt=np.concatenate(
                [pr, np.asarray([i], np.int32)]), max_new=1))
        gw.run_until_idle()
        st = gw.stats()
        m = re.search(r"tpu_gateway_steals_total (\d+)\.0",
                      gw.metrics.render().decode())
        assert int(m.group(1)) == gw.steals_total > 0
        got[side] = (outcomes(gw), gw.steals_total,
                     {k: st[k] for k in ("pumps", "queued", "steps",
                                         "steals", "outcomes",
                                         "replicas")},
                     gw.bus.journal_topics())
    assert got["torch"] == got["jax"]
    assert len(got["torch"][0]) == 10


def burst_replay(side, params, seed, uid, first_seed, n):
    """The acceptance shape: 2 pumps over 2 real replicas, bursty trace
    replay on a virtual clock, r0 downed by the health fault plan while
    its first wave is in flight."""
    gw_mod, srv, lg, plan_cls = SIDES[side]
    plan = plan_cls.from_json({"rules": [
        {"verb": "health", "kind": "Replica", "name": "r0",
         "skip": 2, "times": 1, "error": "drop"}]})
    vc = lg.VirtualClock(step_cost_s=0.0005)
    mgr = real_pool(side, params, replicas=2, fault_plan=plan)
    gw = gw_mod.ShardedGateway(mgr, pumps=2, queue_capacity=32, clock=vc,
                               seed=seed)
    reqs = [make_req(side, f"{uid}{i}", first_seed + i, 5 + (i % 2) * 3,
                     3 + (i % 3)) for i in range(n)]
    lg.replay(gw, lg.load_trace("bursty"), offered_x=4.0,
              base_rps=len(reqs) / 2.0, make_request=lambda i: reqs[i],
              n_requests=len(reqs), slo_s=10_000.0, clock=vc,
              sleep=vc.sleep)
    return gw, mgr, reqs


def test_kill_replica_mid_stream_2_pumps_equal_to_jax(params):
    """A replica killed mid-stream through 2 pumps: exactly once, the
    same shards, outcomes (status, replica, requeues), token streams,
    steals, metric counters and event order as the JAX gateway."""
    got = {}
    for side in SIDES:
        gw, mgr, reqs = burst_replay(side, params, 7, "b", 10, 11)
        assert len(gw.refused) == 0 and len(gw.outcomes) == len(reqs)
        assert all(g.status == "finished" for g in gw.outcomes.values())
        st = gw.stats()
        assert st["replicas"]["dead"] == 1 and st["replicas"]["ready"] == 2
        requeued = [g for g in gw.outcomes.values() if g.requeues > 0]
        assert requeued, "fault fired before anything was in flight"
        live = {r.name for r in mgr.replicas}
        assert all(g.replica in live for g in requeued)
        text = gw.metrics.render().decode()
        assert re.search(r"tpu_gateway_drains_total 1\.0", text)
        m = re.search(r"tpu_gateway_requeued_total (\d+)\.0", text)
        assert m and int(m.group(1)) == len(requeued)
        got[side] = dict(
            shards=[gw._shard(r.prompt) for r in reqs],
            outcomes=outcomes(gw),
            tokens={u: np.asarray(f.tokens).tolist()
                    for u, f in gw.results.items()},
            steals=gw.steals_total, topics=gw.bus.journal_topics(),
            digests=gw.merged_digests().digests["queue_wait"].count)
    assert got["torch"] == got["jax"]
    assert set(got["torch"]["shards"]) == {0, 1}
    assert "drain" in got["torch"]["topics"]


def test_same_seed_identical_event_order_and_outcomes(params):
    """Seeded determinism in the port: the same chaos scenario twice
    gives the identical event sequence and terminal records, and they
    are JAX's."""
    def run(side):
        gw, _, _ = burst_replay(side, params, 11, "d", 30, 9)
        return gw.bus.journal_topics(), sorted(
            (u, g.status, g.replica, g.requeues)
            for u, g in gw.outcomes.items())

    a, b = run("torch"), run("torch")
    assert a == b
    assert "drain" in a[0] and "demand" in a[0]
    assert a == run("jax")


def test_sharded_matches_single_pump_byte_equal(params):
    """Pump count is scheduling, never math."""
    def drain(n_pumps):
        gw = tg.ShardedGateway(real_pool("torch", params, replicas=2),
                               pumps=n_pumps, queue_capacity=16, seed=0)
        for i in range(6):
            gw.submit(make_req("torch", f"m{i}", 50 + i, 5 + (i % 2) * 3,
                               3 + (i % 3)))
        gw.run_until_idle()
        return gw

    one, two = drain(1), drain(2)
    assert set(one.results) == set(two.results) == {f"m{i}"
                                                   for i in range(6)}
    for uid in one.results:
        np.testing.assert_array_equal(one.results[uid].tokens,
                                      two.results[uid].tokens)


# -- null engine and the ceiling probe -------------------------------------

def test_null_engine_equal():
    """The no-op engine's pool-facing contract, step for step."""
    def run(mod, srv):
        eng = mod.NullEngine(slots=2, steps_per_request=2)
        for i in range(3):
            eng.enqueue(srv.Request(uid=f"n{i}", prompt=np.arange(
                3 + i, dtype=np.int32), max_new=1))
        trail = [eng.occupancy()]
        assert eng.cancel("n2") and not eng.cancel("ghost")
        for _ in range(4):
            trail.append([(f.uid, f.tokens.tolist(), f.n_prompt)
                          for f in eng.step()])
            trail.append(eng.occupancy())
        for bad in (srv.Request(uid="e", prompt=np.array([], np.int32),
                                max_new=1),
                    srv.Request(uid="z", prompt=np.ones(2, np.int32),
                                max_new=0)):
            with pytest.raises(ValueError):
                eng.enqueue(bad)
        return trail, eng.prefix_peek(np.ones(3, np.int32))

    assert run(tctl, ts) == run(jctl, js)


#: the ceiling probe's result keys and per-level keys (the JAX probe's)
PROBE_KEYS = {"pump_counts", "replicas", "slots", "requests_per_level",
              "trace", "offered_x", "base_rps", "slo_ms", "levels",
              "admissions_per_s", "routes_per_s", "trace_overhead_x",
              "goodput_flat_x", "valid", "note"}
LEVEL_KEYS = {"pumps", "wall_s", "admissions_per_s", "routes_per_s",
              "steps_per_s", "finished", "shed", "rejected", "steals",
              "goodput_rps", "p99_queue_wait_ms", "accounted"}


def test_control_plane_probe_small():
    """A small ceiling sweep: every level accounted, the JAX probe's
    schema, goodput positive at both pump counts."""
    got = tctl.control_plane_probe(pump_counts=(1, 2), replicas=2, slots=4,
                                   n_requests=64, offered_x=20.0)
    assert set(got) == PROBE_KEYS
    assert all(set(lv) == LEVEL_KEYS for lv in got["levels"])
    assert got["valid"] and all(lv["accounted"] for lv in got["levels"])
    assert [lv["pumps"] for lv in got["levels"]] == [1, 2]
    assert "NO-OP ENGINES" in got["note"]


# -- traces and the open-loop replay ---------------------------------------

def test_trace_fixtures_are_jax_files_and_regenerate(tmp_path):
    """The port's fixtures are JAX's files byte for byte, they equal the
    port's own generators, and ``write_fixtures`` rewrites them
    identically (defaulting to the port's directory)."""
    assert tlg.TRACE_NAMES == jlg.TRACE_NAMES
    assert tlg.TRACE_SCHEMA_KEYS == jlg.TRACE_SCHEMA_KEYS
    assert tlg.TRACE_DIR == (Path(tg.__file__).parent / "traces")
    assert tlg.TRACE_DIR != jlg.TRACE_DIR
    written = tlg.write_fixtures(tmp_path)
    for name, path in zip(tlg.TRACE_NAMES, written):
        ours = (tlg.TRACE_DIR / f"{name}.json").read_bytes()
        assert ours == (jlg.TRACE_DIR / f"{name}.json").read_bytes()
        assert path.read_bytes() == ours
        assert tlg.load_trace(name) == tlg.generate_trace(name) \
            == jlg.load_trace(name)
        t = tlg.load_trace(name)
        assert abs(np.mean(t["interarrivals"]) - 1.0) < 1e-3
    for seed in (1, 2):
        assert tlg.generate_trace("diurnal", n=40, seed=seed) \
            == jlg.generate_trace("diurnal", n=40, seed=seed)
    with pytest.raises(ValueError):
        tlg.generate_trace("nope", seed=1)


def test_replay_is_open_loop():
    """Arrival times come from the trace, not from completions: a
    saturated null pool still receives every submission, and the
    overflow becomes explicit rejections — the same ones as JAX's."""
    got = {}
    for side, (gw_mod, srv, lg, _) in SIDES.items():
        vc = lg.VirtualClock(step_cost_s=0.0001)
        gw = gw_mod.ShardedGateway(null_pool(side, replicas=1, slots=1),
                                   pumps=1, queue_capacity=2, clock=vc,
                                   seed=0)
        n = 32
        reqs = [srv.Request(uid=f"o{i}", prompt=np.arange(
            4, i + 5, dtype=np.int32)[:4], max_new=1) for i in range(n)]
        out = lg.replay(gw, lg.load_trace("bursty"), offered_x=50.0,
                        base_rps=100.0, make_request=lambda i: reqs[i],
                        n_requests=n, slo_s=None, clock=vc, sleep=vc.sleep)
        assert out["submitted"] == n
        assert len(gw.outcomes) + len(gw.refused) == n
        assert len(gw.refused) > 0
        got[side] = (out, sorted(g.uid for g in gw.refused),
                     outcomes(gw))
    assert got["torch"] == got["jax"]


def test_event_heap_orders_and_parks():
    """sim/clock.py's heap: (time, seq) order, same-instant events in
    scheduling order, an idle advance pops nothing."""
    heap = tclock.EventHeap()
    seen = []
    heap.at(2.0, seen.append, "b")
    heap.at(1.0, seen.append, "a")
    heap.at(2.0, seen.append, "c")
    heap.after(5.0, lambda: heap.after(0.0, seen.append, "e"))
    assert heap.advance_to(2.5) == 3 and seen == ["a", "b", "c"]
    assert heap.now == 2.5 and heap.next_time() == 5.0
    assert heap.run() == 2 and seen[-1] == "e"
    assert heap.advance_to(100.0) == 0 and heap.now == 100.0
    assert tlg.VirtualClock is tclock.VirtualClock
