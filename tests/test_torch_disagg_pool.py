"""Port two-role pool (k8s_dra_driver_tpu_torch/serving_disagg/: the KV
migrator, the fleet prefix index, ``DisaggReplicaManager`` and
``DisaggRouter``) against the JAX package's, on the CPU in f32 at
tests/test_disagg.py's config.

The pool scenarios (the two-role acceptance and its prefill-kill twin)
run the same requests, FaultPlan rules and injected clocks through the
JAX pool over JAX engines and the port pool over port engines, the
latter on contiguous and on paged KV: the same per-uid outcomes, greedy
tokens, ``stats()``, migrations and metric samples.  One sample differs
by design: JAX counts a migrated ``KVCache``'s ``pos`` scalar (4 bytes)
among its bytes, the port moves ``pos`` as a Python int and counts the
tensors only.  Sampled tokens are held to a port engine draining the
same requests.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu import gateway as jg
from k8s_dra_driver_tpu import serving_disagg as jd
from k8s_dra_driver_tpu.cluster.faults import FaultPlan
from k8s_dra_driver_tpu.models import serving as js
from k8s_dra_driver_tpu.models import transformer as jt
from k8s_dra_driver_tpu_torch import gateway as tg
from k8s_dra_driver_tpu_torch import serving_disagg as td
from k8s_dra_driver_tpu_torch.gateway.replica import (ROLE_DECODE,
                                                      ROLE_PREFILL,
                                                      ROLE_UNIFIED)
from k8s_dra_driver_tpu_torch.models import serving as ts
from k8s_dra_driver_tpu_torch.models import transformer as tt
from k8s_dra_driver_tpu_torch.models.convert import params_from_jax
from k8s_dra_driver_tpu_torch.models.decode import KVCache
from k8s_dra_driver_tpu_torch.utils import dispatch as tdispatch

pytestmark = pytest.mark.timeout_s(180)

FIELDS = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
              d_ff=64, max_seq=48, n_kv_heads=2)
JCFG = jt.TransformerConfig(dtype=jnp.float32, **FIELDS)
TCFG = tt.TransformerConfig(dtype=torch.float32, **FIELDS)
LAYOUTS = {"contiguous": {}, "paged": dict(kv_layout="paged",
                                           kv_block_size=8)}
#: bytes JAX counts beyond the port a migrated KVCache: its int32 pos
POS_BYTES = 4


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(np.asarray,
                      jt.init_params(JCFG, jax.random.PRNGKey(0)))
    return {"jax": jp, "torch": params_from_jax(jp, device="cpu")}


def engine(side, params, slots=2, prefix_cache=2, **kw):
    if side == "jax":
        return js.ServingEngine(params["jax"], JCFG, slots=slots,
                                prefix_cache=prefix_cache, **kw)
    return ts.ServingEngine(params["torch"], TCFG, slots=slots,
                            prefix_cache=prefix_cache, device="cpu", **kw)


def prompt(seed, n):
    return np.random.default_rng(seed).integers(
        0, FIELDS["vocab"], n).astype(np.int32)


def burst_reqs(srv):
    """Bursty mixed greedy/sampled workload (tests/test_disagg.py's)."""
    bursts, seed = [], 20
    for b, size in enumerate((4, 3, 4)):
        burst = []
        for i in range(size):
            seed += 1
            burst.append(srv.Request(
                uid=f"b{b}i{i}", prompt=prompt(seed, 5 + (i % 2) * 3),
                max_new=3 + (i % 3),
                temperature=0.7 if i % 3 == 2 else 0.0, seed=seed))
        bursts.append(burst)
    return bursts


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def pool_run(side, params, layout="contiguous", kill=False):
    """The two-role pool (1 prefill + 2 decode, ``auto_replace=False``)
    over the bursts; ``kill`` downs p0 by the FaultPlan after its first
    export wave.  Returns (gateway, manager, requests, labels by
    replica)."""
    gw_pkg, d_pkg, srv = ((jg, jd, js) if side == "jax" else (tg, td, ts))
    clock = Clock()
    plan = FaultPlan.from_json({"rules": [
        {"verb": "health", "kind": "Replica", "name": "p0", "skip": 1,
         "times": 1, "error": "drop"}]}) if kill else None
    kw = {} if side == "jax" else LAYOUTS[layout]
    mgr = d_pkg.DisaggReplicaManager(
        lambda name: engine(side, params, **kw),
        prefill_replicas=1, decode_replicas=2, depth_bound=2,
        fault_plan=plan, migrator=d_pkg.KVMigrator(clock=clock))
    gw = gw_pkg.FleetGateway(mgr, router=d_pkg.DisaggRouter(mgr.index),
                             queue_capacity=32, auto_replace=False,
                             clock=clock)
    bursts = burst_reqs(srv)
    for burst in bursts:
        for req in burst:
            assert gw.submit(req, slo_s=300.0).status == "queued"
        gw.step()
        clock.t += 0.5
    gw.run_until_idle()
    per = gw.stats()["per_replica_dispatches"]
    labels = {r.name: (r.role, per.get(r.name, {}).get("by_label", {}))
              for r in mgr.replicas}
    return gw, mgr, [r for b in bursts for r in b], labels


@pytest.fixture(scope="module")
def jax_pools(params):
    return {kill: pool_run("jax", params, kill=kill)
            for kill in (False, True)}


def port_oracle(params, reqs, layout) -> dict:
    eng = engine("torch", params, **LAYOUTS[layout])
    for r in reqs:
        eng.submit(r)
    return {f.uid: np.asarray(f.tokens) for f in eng.run()}


def metric_samples(gw):
    return [ln for ln in gw.metrics.render().decode().splitlines()
            if "_created" not in ln and "kv_bytes_moved" not in ln
            and not ln.startswith("tpu_gateway_kv_blocks")
            and not ln.startswith("tpu_gateway_kv_cow")]


def hold_to_jax(params, jax_run, port_run, layout):
    gj, mj, _, _ = jax_run
    gt, mt, reqs, _ = port_run
    assert set(gj.outcomes) == set(gt.outcomes) == {r.uid for r in reqs}
    for uid, g in gj.outcomes.items():
        h = gt.outcomes[uid]
        assert (g.status, g.replica, g.requeues) == (
            h.status, h.replica, h.requeues), uid
    sj, st = gj.stats(), gt.stats()
    assert set(sj.pop("per_replica_dispatches")) == set(
        st.pop("per_replica_dispatches"))
    assert sj == st
    mig_j, mig_t = mj.migration_stats(), mt.migration_stats()
    assert mig_t["migrations"] == mig_j["migrations"]
    assert mig_t["tokens_moved"] == mig_j["tokens_moved"]
    if layout == "contiguous":
        # the same [1, max_seq] payloads, less JAX's pos scalar
        assert mig_t["bytes_moved"] == (mig_j["bytes_moved"]
                                        - POS_BYTES * mig_j["migrations"])
        assert metric_samples(gj) == metric_samples(gt)
    else:
        # the paged replicas add their block gauges and migrate slabs
        assert [ln for ln in metric_samples(gj) if "kv_" not in ln] == [
            ln for ln in metric_samples(gt) if "kv_" not in ln]
    oracle = port_oracle(params, [r for r in reqs if r.temperature > 0],
                         layout)
    for r in reqs:
        got = np.asarray(gt.results[r.uid].tokens)
        want = (oracle[r.uid] if r.temperature > 0
                else np.asarray(gj.results[r.uid].tokens))
        np.testing.assert_array_equal(got, want, err_msg=r.uid)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_two_role_pool_matches_jax(params, jax_pools, layout):
    """The acceptance: 1 prefill + 2 decode replicas, bursty greedy and
    sampled arrivals; exactly once, every request's KV migrated once,
    no prefill label on a decode replica, no decode label on the
    prefill replica, everything finished on a decode replica; the same
    outcomes, tokens, stats and metric samples as the JAX pool."""
    run = pool_run("torch", params, layout)
    hold_to_jax(params, jax_pools[False], run, layout)
    gw, mgr, reqs, labels = run
    assert mgr.migration_stats()["migrations"] == len(reqs)
    for name, (role, lbls) in labels.items():
        bad = "prefill" if role == ROLE_DECODE else "decode_"
        assert not any(lbl.startswith(bad) for lbl in lbls), (name, lbls)
    assert {g.replica for g in gw.outcomes.values()} <= {
        r.name for r in mgr.replicas if r.role == ROLE_DECODE}
    text = gw.metrics.render().decode()
    m = re.search(r"tpu_gateway_kv_migrations_total (\d+)\.0", text)
    assert m and int(m.group(1)) == len(reqs)
    m = re.search(r"^tpu_gateway_kv_bytes_moved_total (\S+)$", text,
                  re.M)
    assert float(m.group(1)) == mgr.migration_stats()["bytes_moved"]
    assert re.search(r'tpu_gateway_replica_role\{role="decode"\} 2\.0',
                     text)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_prefill_killed_mid_transfer_matches_jax(params, jax_pools,
                                                 layout):
    """The chaos twin: the only prefill replica dies after its first
    export wave; un-adopted blocks die with it, the drain requeues the
    victims, the decode side falls back to local prefill; exactly once,
    the same outcomes, tokens and samples as the JAX pool."""
    run = pool_run("torch", params, layout, kill=True)
    hold_to_jax(params, jax_pools[True], run, layout)
    gw, mgr, reqs, labels = run
    st = gw.stats()
    assert st["replicas"]["dead"] == 1
    assert st["replicas"]["roles"] == {ROLE_DECODE: 2}
    assert any(g.requeues > 0 for g in gw.outcomes.values())
    assert sum(n for role, lbls in labels.values() if role == ROLE_DECODE
               for lbl, n in lbls.items() if lbl.startswith("prefill")) > 0
    assert "p0" not in mgr.index.holders()


def test_spec_pool_draft_labels_attribute_to_decode_only(params):
    """n-gram speculative engines in a two-role pool: every decode
    replica that decoded tallies ``draft_ngram_rows``, the prefill
    replica no ``draft_*`` label; streams equal a speculative port
    engine's, and the greedy ones the plain engine's."""
    kw = dict(draft_source="ngram", draft_len=2)
    mgr = td.DisaggReplicaManager(lambda name: engine("torch", params,
                                                      **kw),
                                  prefill_replicas=1, decode_replicas=2,
                                  depth_bound=2)
    gw = tg.FleetGateway(mgr, router=td.DisaggRouter(mgr.index),
                         queue_capacity=32, auto_replace=False)
    reqs = [ts.Request(uid=f"r{i}", prompt=prompt(80 + i, 5 + (i % 2) * 3),
                       max_new=4 + (i % 3),
                       temperature=0.7 if i % 3 == 2 else 0.0, seed=80 + i)
            for i in range(5)]
    for r in reqs:
        gw.submit(r, slo_s=300.0)
    assert {g.uid for g in gw.run_until_idle()} == {r.uid for r in reqs}
    spec = {}
    eng = engine("torch", params, **kw)
    for r in reqs:
        eng.submit(r)
    spec = {f.uid: np.asarray(f.tokens) for f in eng.run()}
    plain = port_oracle(params, reqs, "contiguous")
    for r in reqs:
        np.testing.assert_array_equal(gw.results[r.uid].tokens,
                                      spec[r.uid])
        if r.temperature == 0:
            np.testing.assert_array_equal(spec[r.uid], plain[r.uid])
    per = gw.stats()["per_replica_dispatches"]
    for r in mgr.replicas:
        labels = per.get(r.name, {}).get("by_label", {})
        drafts = {lbl for lbl in labels if lbl.startswith("draft_")}
        if r.role == ROLE_DECODE:
            if any(lbl.startswith("decode_") for lbl in labels):
                assert "draft_ngram_rows" in drafts, (r.name, labels)
        else:
            assert not drafts, (r.name, labels)


# -- the KV migrator ---------------------------------------------------------

def exported(params, layout="contiguous", temperature=0.0, cfg=TCFG):
    eng = ts.ServingEngine(params["torch"], cfg, slots=2, device="cpu",
                           **LAYOUTS[layout])
    return eng.prefill_export(ts.Request(
        uid="m", prompt=prompt(5, 11), max_new=2, temperature=temperature,
        seed=3))


def leaves(kv) -> list:
    names = (("k", "v") if isinstance(kv, ts.PagedKVSlab)
             else ("k", "v", "k_scale", "v_scale"))
    return [t for n in names for t in (getattr(kv, n) or [])]


@pytest.mark.parametrize("kind", ["contiguous", "int8", "paged"])
def test_migrate_entry_fresh_storage_full_bytes(params, kind):
    """Every leaf lands in fresh storage (no shared ``data_ptr``) with
    equal values, ints ride along, bytes are full-buffer, tokens are
    ``pos``; each event drains exactly once."""
    if kind == "int8":
        cfg = tt.TransformerConfig(dtype=torch.float32,
                                   kv_cache_dtype="int8", **FIELDS)
        blk = exported(params, cfg=cfg)
        assert blk.kv.k_scale is not None
    else:
        blk = exported(params, layout=kind)
    mig = td.KVMigrator()
    moved = mig.migrate_entry(blk.kv)
    src, dst = leaves(blk.kv), leaves(moved)
    assert len(src) == len(dst) > 0
    for a, b in zip(src, dst):
        assert a.data_ptr() != b.data_ptr()
        assert b.device == a.device and b.dtype == a.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert moved.pos == blk.kv.pos == 11
    if kind == "paged":
        assert moved.block_size == blk.kv.block_size == 8
    else:
        assert moved.k[0].shape[1] == FIELDS["max_seq"]
    nbytes = sum(t.numel() * t.element_size() for t in src)
    assert mig.stats() == {"migrations": 1, "bytes_moved": nbytes,
                           "tokens_moved": 11,
                           "wall_s": round(mig.wall_s, 6)}
    assert len(mig.take_events()) == 1 and mig.take_events() == []
    assert mig.last_event == (mig.wall_s, nbytes)
    # a write into the copy never reaches the source
    dst[0].add_(1.0) if dst[0].is_floating_point() else dst[0].add_(1)
    assert not torch.equal(src[0], dst[0])


def test_contiguous_bytes_equal_jax_less_pos(params):
    """The same [1, max_seq] export migrated by each package: JAX counts
    the tensors plus the int32 ``pos`` scalar."""
    jblk = engine("jax", params).prefill_export(
        js.Request(uid="m", prompt=prompt(5, 11), max_new=2))
    jm = jd.KVMigrator()
    jm.migrate_entry(jblk.kv)
    tm = td.KVMigrator()
    tm.migrate_entry(exported(params).kv)
    assert tm.bytes_moved == jm.bytes_moved - POS_BYTES
    assert tm.tokens_moved == jm.tokens_moved


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_migrate_block_clones_carry(params, temperature):
    """A block's carry (the generator state, a CPU byte tensor) is
    cloned where it is; the adopter continues the local stream."""
    blk = exported(params, temperature=temperature)
    moved = td.KVMigrator().migrate_block(blk)
    assert moved.request is blk.request and moved.first == blk.first
    if temperature == 0:
        assert moved.carry is None
    else:
        assert moved.carry.device.type == "cpu"
        assert moved.carry.data_ptr() != blk.carry.data_ptr()
        assert torch.equal(moved.carry, blk.carry)
    dec = engine("torch", params, prefix_cache=0)
    dec.adopt_block(moved)
    got = dec.run()[0].tokens
    ref = engine("torch", params, prefix_cache=0)
    ref.submit(blk.request)
    np.testing.assert_array_equal(got, ref.run()[0].tokens)


def test_shard_and_gather_fns(params):
    kv = exported(params).kv
    shard, gather = td.make_kv_shard_and_gather_fns("cpu")
    a = kv.k[0]
    for out in (shard(a), gather(a)):
        assert out.device.type == "cpu"
        assert out.data_ptr() != a.data_ptr()
        assert torch.equal(out, a)
    assert isinstance(td.KVMigrator().migrate_entry(kv, "cpu"), KVCache)


# -- the fleet prefix index --------------------------------------------------

INDEX_LAYOUTS = {"contiguous": {}, "paged": dict(kv_layout="paged",
                                                 kv_block_size=8),
                 "tiered": dict(kv_layout="paged", kv_block_size=8,
                                kv_host_bytes=1 << 20)}


def index_trace(side, params, layout):
    """Mirror two engines, drive inserts, an LRU eviction and (tiered) a
    demotion flush; returns holders and lookups along the way."""
    d_pkg, srv = (jd, js) if side == "jax" else (td, ts)
    idx = d_pkg.FleetPrefixIndex()
    e0 = engine(side, params, **INDEX_LAYOUTS[layout])
    e1 = engine(side, params, **INDEX_LAYOUTS[layout])
    idx.attach("r0", e0._prefix)
    idx.attach("r1", e1._prefix)
    shared = prompt(10, 8)
    out = []
    for uid, eng, pr in (("a", e0, prompt(7, 6)), ("b", e0, prompt(8, 6)),
                         ("s", e0, shared[:5]), ("l", e1, shared)):
        eng.submit(srv.Request(uid=uid, prompt=pr, max_new=1))
        eng.run()
        out.append(idx.holders())
    probe = np.concatenate([shared, prompt(11, 3)])
    out.append(idx.lookup(probe))
    out.append(idx.lookup(prompt(7, 6)))
    if layout == "tiered":
        e1._prefix.flush()
        out.append(idx.lookup(probe))
        out.append(idx.tier_of("r1", idx.lookup(probe)[2]))
    idx.drop_replica("r1")
    out.append(idx.lookup(probe))
    return out


@pytest.mark.parametrize("layout", sorted(INDEX_LAYOUTS))
def test_index_mirror_and_lookups_equal_jax(params, layout):
    want = index_trace("jax", params, layout)
    got = index_trace("torch", params, layout)
    assert got == want
    if layout == "tiered":
        assert "host" in got


def test_index_lookup_tier_tiebreak_equals_jax():
    pr = prompt(13, 8)
    key6, key7 = tuple(pr[:6].tolist()), tuple(pr[:7].tolist())
    held = {"a": {key6: "disk"}, "b": {key6: "device"},
            "c": {key6: "host", key7[:3]: "device"}}
    outs = []
    for d_pkg in (jd, td):
        idx = d_pkg.FleetPrefixIndex()
        idx._held = {k: dict(v) for k, v in held.items()}
        first = idx.lookup(pr)
        idx._held["d"] = {key7: "disk"}
        outs.append((first, idx.lookup(pr), idx.lookup(pr[:1])))
    assert outs[0] == outs[1]
    assert outs[1][0][1] == "b" and outs[1][1][1] == "d"


class RouterStub:
    def __init__(self, name, role, depth=0):
        self.name, self.role, self.ready = name, role, True
        self.depth_bound, self._depth = 8, depth

    def occupancy(self):
        return {"active": self._depth, "pending": 0}


def disagg_routes(d_pkg):
    idx = d_pkg.FleetPrefixIndex()
    router = d_pkg.DisaggRouter(idx, min_affinity=4)
    pa = RouterStub("p0", ROLE_PREFILL, depth=3)
    pb = RouterStub("p1", ROLE_PREFILL)
    d0 = RouterStub("d0", ROLE_DECODE, depth=1)
    d1 = RouterStub("d1", ROLE_DECODE)
    pr = prompt(13, 8)
    idx._held["p0"] = {tuple(pr[:6].tolist()): "device"}
    idx._held["d1"] = {tuple(pr[:3].tolist()): "device"}
    out = []

    def route():
        pick = router.route(pr, [pa, pb, d0, d1])
        out.append(None if pick is None else (pick.name, router.last_reason))

    route()                         # the busier holder wins on affinity
    pa.ready = False
    route()                         # spill among prefill replicas
    pb.ready = False
    route()                         # decode fallback, least depth
    d0.ready = d1.ready = False
    route()                         # nothing placeable
    router.forget("p0")
    out.append(idx.lookup(pr))
    return out


def test_disagg_router_choices_equal_jax():
    assert disagg_routes(td) == disagg_routes(jd)
    assert disagg_routes(td)[:3] == [("p0", "index_affinity"),
                                     ("p1", "prefill_spill"),
                                     ("d1", "decode_fallback")]


def test_index_hit_migrates_prefix_zero_recompute(params):
    """A prompt another replica already computed fills with no fresh
    prefill: the index fetch migrates the entry and only the suffix
    runs; the block adopted elsewhere gives the one-engine stream."""
    mgr = td.DisaggReplicaManager(lambda name: engine("torch", params),
                                  prefill_replicas=2, decode_replicas=1,
                                  depth_bound=2)
    p0, p1 = [r for r in mgr.replicas if r.role == ROLE_PREFILL]
    pr = prompt(12, 8)
    with tdispatch.track() as t0:
        p0.engine.prefill_export(ts.Request(uid="warm", prompt=pr,
                                            max_new=2))
    assert t0.by_label.get("prefill") == 1
    with tdispatch.track() as t1:
        mgr._fetch_remote_prefix(p1, pr)
        blk = p1.engine.prefill_export(ts.Request(uid="hit", prompt=pr,
                                                  max_new=3))
    assert t1.by_label.get("prefill", 0) == 0
    assert t1.by_label.get("prefill_suffix") == 1
    assert blk.reused_tokens == pr.size - 1
    assert mgr.migration_stats()["migrations"] == 1
    assert p1.engine.stats()["prefix_tokens_reused_total"] == pr.size - 1
    dec = engine("torch", params, prefix_cache=0)
    dec.adopt_block(blk)
    ref = engine("torch", params, prefix_cache=0)
    ref.submit(ts.Request(uid="hit", prompt=pr, max_new=3))
    np.testing.assert_array_equal(dec.run()[0].tokens, ref.run()[0].tokens)


# -- role plumbing -----------------------------------------------------------

class _StubEngine:
    slots = 2


def stub_pool(prefill=1, decode=2):
    return td.DisaggReplicaManager(lambda name: _StubEngine(),
                                   prefill_replicas=prefill,
                                   decode_replicas=decode, depth_bound=2)


def test_counts_carry_roles():
    c = stub_pool().counts()
    assert c["roles"] == {ROLE_PREFILL: 1, ROLE_DECODE: 2}
    assert c["ready"] == 3
    uni = tg.ReplicaManager(lambda name: _StubEngine(), replicas=2)
    assert uni.counts()["roles"] == {ROLE_UNIFIED: 2}


def test_begin_drain_refuses_last_prefill_replica():
    mgr = stub_pool(prefill=2, decode=1)
    pf = [r for r in mgr.replicas if r.role == ROLE_PREFILL]
    assert mgr.begin_drain(pf[0]) is True
    assert mgr.begin_drain(pf[1]) is False and pf[1].ready
    dec = next(r for r in mgr.replicas if r.role == ROLE_DECODE)
    assert mgr.begin_drain(dec) is True


def test_replace_preserves_role_and_scale_up_defaults_to_decode():
    mgr = stub_pool(prefill=1, decode=1)
    victim = next(r for r in mgr.replicas if r.role == ROLE_PREFILL)
    mgr.mark_down(victim)
    fresh = mgr.replace(victim)
    assert fresh.role == ROLE_PREFILL
    assert isinstance(fresh, td.PrefillReplica)
    assert mgr.add_replica().role == ROLE_DECODE
    assert mgr.add_replica(role=ROLE_PREFILL).role == ROLE_PREFILL
    uni = tg.ReplicaManager(lambda name: _StubEngine(), replicas=1)
    assert uni.add_replica().role == ROLE_UNIFIED
