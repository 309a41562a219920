"""Port KV tiers (k8s_dra_driver_tpu_torch/serving_kv/tiers.py and the
paged engine's ``kv_host_bytes`` / ``kv_spill_dir``) against the JAX
package's, on the CPU in f32 at the JAX tests' config.

The store is driven through the same operation sequences in both
packages with synthetic gather/adopt halves (block rows as numpy arrays
for JAX, CPU tensors for the port): counters, residency, listener events
and the host arena's displacement order must match step for step, and
promoted rows must be the demoted bytes.  The disk format is shared: a
slab file written by either package loads in the other (bf16 included:
the JAX side reads it through ml_dtypes, the port through its own dtype
table), and a JAX engine's spill directory is re-adopted by a port
engine and the other way round, the promoted greedy streams equal to
the JAX engine's.  Engine arcs (the promote wave and its dispatch
labels, the residency probe, promotion racing eviction, restart from
disk) run in both packages and must agree token for token.
"""

import random
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.models import serving as js
from k8s_dra_driver_tpu.models import transformer as jt
from k8s_dra_driver_tpu.serving_kv import manager as jm
from k8s_dra_driver_tpu.serving_kv import tiers as jtiers
from k8s_dra_driver_tpu.utils import dispatch as jdispatch
from k8s_dra_driver_tpu_torch.models import serving as ts
from k8s_dra_driver_tpu_torch.models import transformer as tt
from k8s_dra_driver_tpu_torch.models.convert import params_from_jax
from k8s_dra_driver_tpu_torch.serving_kv import manager as tm
from k8s_dra_driver_tpu_torch.serving_kv import tiers as ttiers
from k8s_dra_driver_tpu_torch.serving_kv.tierprobe import serving_tier_probe
from k8s_dra_driver_tpu_torch.utils import dispatch as tdispatch

FIELDS = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
              d_ff=64, max_seq=48, n_kv_heads=2)
JCFG = jt.TransformerConfig(dtype=jnp.float32, **FIELDS)
TCFG = tt.TransformerConfig(dtype=torch.float32, **FIELDS)


def prompt(seed, n):
    return np.random.default_rng(seed).integers(
        0, FIELDS["vocab"], n).astype(np.int32)


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(np.asarray,
                      jt.init_params(JCFG, jax.random.PRNGKey(0)))
    return jp, params_from_jax(jp, device="cpu")


# ---------------------------------------------------------------------
# The store, driven the same way in both packages
# ---------------------------------------------------------------------

class Side:
    """One package's tier module, manager and row type."""

    def __init__(self, name):
        self.name = name
        self.tiers = jtiers if name == "jax" else ttiers
        self.mgr_mod = jm if name == "jax" else tm

    def row(self, a: np.ndarray):
        return a.copy() if self.name == "jax" else torch.from_numpy(a.copy())

    def stack(self, rows):
        return np.stack(rows) if self.name == "jax" else torch.stack(rows)

    def copy(self, a):
        return np.array(a) if self.name == "jax" else a.clone()

    def raw(self, a) -> bytes:
        return (np.ascontiguousarray(a).tobytes() if self.name == "jax"
                else a.contiguous().reshape(-1).view(torch.uint8)
                .numpy().tobytes())


def tiered(side, n_blocks=12, entries=2, bs=4, host_bytes=1 << 20,
           spill_dir=None, dtype=np.float32):
    """A TieredKVStore over a synthetic one-layer pool (block id ->
    (k_row, v_row)) whose gather/adopt move rows through the real
    demote/promote machinery: the engine halves without the engine."""
    mgr = side.mgr_mod.KVBlockManager(n_blocks, bs)
    store = side.tiers.TieredKVStore(entries, mgr, host_bytes=host_bytes,
                                     spill_dir=spill_dir)
    rows: dict[int, tuple] = {}
    events: list = []
    store.listeners.append(lambda ev, key: events.append((ev, len(key))))

    def bind(store, mgr, rows):
        def gather(entry):
            return ([side.stack([rows[b][0] for b in entry.block_ids])],
                    [side.stack([rows[b][1] for b in entry.block_ids])])

        def adopt(slab_k, slab_v):
            ids = mgr.alloc(slab_k[0].shape[0])
            for i, b in enumerate(ids):
                rows[b] = (side.copy(slab_k[0][i]), side.copy(slab_v[0][i]))
            return ids

        store.bind_engine(gather, adopt)

    bind(store, mgr, rows)

    def fill(seed, n_tokens, block_ids=None, cold=True):
        toks = prompt(seed, n_tokens)
        rng = np.random.default_rng(seed)
        ids = block_ids if block_ids is not None \
            else mgr.alloc((n_tokens + bs - 1) // bs)
        for b in ids:
            if b not in rows:
                rows[b] = tuple(side.row(rng.integers(
                    -100, 100, (bs, 2)).astype(dtype)) for _ in range(2))
        store.insert(toks, ids, n_tokens)
        if cold and block_ids is None:
            mgr.free_blocks(ids)
        return toks, ids

    return mgr, store, rows, fill, events, bind


def snapshot(store, keys) -> dict:
    return {"counters": store.tier_counters(),
            "evictions": store.evictions, "hits": store.hits,
            "misses": store.misses,
            "residency": [store.residency_of(tuple(k.tolist()))
                          for k in keys],
            "host_bytes": store.host_arena_bytes(),
            "demoted": store.demoted_counts()}


def probe_of(toks):
    return np.concatenate([toks, prompt(9, 2)])


def scenario(side, name, tmp) -> tuple[list, list]:
    """Run one operation sequence; returns (the trace of snapshots, hit
    results and events, the byte-exactness check of each promotion)."""
    trace, exact = [], []

    def rows_bytes(rows, entry):
        return [side.raw(rows[b][i]) for b in entry.block_ids
                for i in range(2)]

    if name == "round_trip":
        mgr, store, rows, fill, events, _ = tiered(side)
        a, ids_a = fill(1, 8)
        orig = [side.raw(rows[b][i]) for b in ids_a for i in range(2)]
        b, _ = fill(2, 8)
        fill(3, 8)
        trace += [snapshot(store, [a, b]), mgr.refcount(ids_a[0]),
                  store.peek(probe_of(a)), store.residency(probe_of(a))]
        p, entry = store.longest_prefix(probe_of(a))
        trace += [p, snapshot(store, [a, b])]
        exact.append(rows_bytes(rows, entry) == orig)
    elif name == "cow_shared":
        mgr, store, rows, fill, events, _ = tiered(side)
        a, ids_a = fill(1, 8)
        orig = [side.raw(rows[b][i]) for b in ids_a for i in range(2)]
        tail = mgr.alloc(1)
        fill(2, 8, block_ids=[ids_a[0], tail[0]])
        mgr.free_blocks(tail)
        fill(3, 8)
        trace += [snapshot(store, [a]), mgr.refcount(ids_a[0]),
                  mgr.refcount(ids_a[1])]
        p, entry = store.longest_prefix(probe_of(a))
        trace += [p, entry.block_ids[0] != ids_a[0]]
        exact.append(rows_bytes(rows, entry) == orig)
    elif name == "block_race":
        mgr, store, rows, fill, events, _ = tiered(side, n_blocks=5,
                                                   entries=1)
        a, _ = fill(1, 4)
        fill(2, 4)
        hot = mgr.alloc(mgr.free)
        p, entry = store.longest_prefix(probe_of(a))
        trace += [p, entry is None, snapshot(store, [a])]
        mgr.free_blocks(hot)
        p, entry = store.longest_prefix(probe_of(a))
        trace += [p, snapshot(store, [a])]
    elif name == "corrupt_host":
        mgr, store, rows, fill, events, _ = tiered(side, entries=1)
        a, _ = fill(1, 8)
        fill(2, 8)
        trace.append(store.corrupt_slab(random.Random(7))
                     == tuple(a.tolist()))
        p, entry = store.longest_prefix(probe_of(a))
        trace += [p, entry is None, snapshot(store, [a])]
    elif name in ("disk_restart", "int8"):
        spill = tmp / f"{side.name}-{name}"
        int8 = name == "int8"
        mgr, store, rows, fill, events, bind = tiered(
            side, entries=1, host_bytes=20 if int8 else 150,
            spill_dir=spill, dtype=np.int8 if int8 else np.float32)
        n = 4 if int8 else 8
        a, ids_a = fill(1, n)
        orig = [side.raw(rows[b][i]) for b in ids_a for i in range(2)]
        b, _ = fill(2, n)
        fill(3, n)
        trace += [snapshot(store, [a, b]), store.disk_tier_bytes() > 0]
        if int8:
            p, entry = store.longest_prefix(probe_of(a))
            trace += [p, snapshot(store, [a, b])]
            exact.append(rows_bytes(rows, entry) == orig)
        else:
            # restart: a fresh disk-only store over the same directory
            mgr2 = side.mgr_mod.KVBlockManager(12, 4)
            store2 = side.tiers.TieredKVStore(2, mgr2, spill_dir=spill)
            rows2: dict = {}
            bind(store2, mgr2, rows2)
            trace.append(store2.residency_of(tuple(a.tolist())))
            p, entry = store2.longest_prefix(probe_of(a))
            trace += [p, store2.promotions]
            exact.append(rows_bytes(rows2, entry) == orig)
            store2.flush()
            damaged = store2.corrupt_slab(random.Random(3))
            trace.append(damaged == tuple(a.tolist()))
            p, entry = store2.longest_prefix(probe_of(a))
            trace += [entry is None or p < 8, snapshot(store2, [a])]
    elif name == "supersede":
        mgr, store, rows, fill, events, _ = tiered(side)
        a, _ = fill(1, 8)
        b, _ = fill(2, 8)
        fill(3, 8)
        slab_bytes = store.host_arena_bytes()
        fill(1, 8)
        trace += [snapshot(store, [a, b]),
                  store.host_arena_bytes() == slab_bytes]
        store.drop(b)
        trace.append(snapshot(store, [a, b]))
    trace.append(events)
    return trace, exact


SCENARIOS = ["round_trip", "cow_shared", "block_race", "corrupt_host",
             "disk_restart", "int8", "supersede"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_store_matches_jax_store(name, tmp_path):
    """The same operations through both stores: the same counters,
    residency, listener events and byte-exact promotions."""
    want, want_exact = scenario(Side("jax"), name, tmp_path)
    got, exact = scenario(Side("torch"), name, tmp_path)
    assert got == want
    assert all(exact) and exact == want_exact


def test_store_refuses_a_single_tier():
    with pytest.raises(ValueError) as jerr:
        jtiers.TieredKVStore(2, jm.KVBlockManager(4, 4))
    with pytest.raises(ValueError) as terr:
        ttiers.TieredKVStore(2, tm.KVBlockManager(4, 4))
    assert str(terr.value) == str(jerr.value)


def test_host_arena_displacement_order_matches_jax():
    def run(side):
        def slab(seed, nbytes):
            a = np.full((nbytes // 2,), seed, np.uint8)
            a = a if side.name == "jax" else torch.from_numpy(a)
            return side.tiers.HostSlab(
                length=1, k=[a], v=[a],
                crc=side.tiers.slab_checksum([a], [a]))

        arena = side.tiers.HostArena(100)
        out = [[k for k, _ in arena.put((c,), slab(i, n))]
               for i, (c, n) in enumerate([("a", 40), ("b", 40), ("c", 70),
                                           ("d", 200)])]
        return out, arena.used_bytes, ("d",) in arena, list(arena.keys())

    want = run(Side("jax"))
    assert run(Side("torch")) == want
    assert want[0] == [[], [], [("a",), ("b",)], [("d",)]]


# ---------------------------------------------------------------------
# The shared disk format
# ---------------------------------------------------------------------

def np_slab(dtype, seed=0, shape=(2, 4, 2, 8)):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        arrs = [rng.integers(-127, 128, shape).astype(np.int8)
                for _ in range(4)]
    else:
        arrs = [rng.standard_normal(shape).astype(np.float32).astype(dtype)
                for _ in range(4)]
    return arrs[:2], arrs[2:]


def to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_disk_slab_loads_in_both_packages(tmp_path, dtype, writer):
    """A slab file written by one package loads byte-exact in the other
    and in itself: the same file name for a key, the same header, the
    same crc and payload."""
    k, v = np_slab(ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)
    key = tuple(range(7))
    jslab = jtiers.HostSlab(length=7, k=k, v=v,
                            crc=jtiers.slab_checksum(k, v))
    tk, tv = [to_torch(a) for a in k], [to_torch(a) for a in v]
    tslab = ttiers.HostSlab(length=7, k=tk, v=tv,
                            crc=ttiers.slab_checksum(tk, tv))
    assert tslab.crc == jslab.crc and tslab.nbytes == jslab.nbytes
    if writer == "jax":
        jtiers.DiskTier(tmp_path).put(key, jslab)
    else:
        ttiers.DiskTier(tmp_path).put(key, tslab)
    got_j = jtiers.DiskTier(tmp_path).load(key)
    got_t = ttiers.DiskTier(tmp_path).load(key)
    assert got_t.verify() and got_j.verify()
    assert got_t.crc == got_j.crc == jslab.crc
    for a, b in zip(got_t.k + got_t.v, got_j.k + got_j.v):
        assert str(b.dtype) == dtype
        assert a.dtype == getattr(torch, dtype)
        assert (a.reshape(-1).view(torch.uint8).numpy().tobytes()
                == np.ascontiguousarray(b).tobytes())
    assert ttiers.DiskTier(tmp_path).scan() == {key: 7}


def test_damaged_disk_slab_is_corruption(tmp_path):
    k, v = np_slab("int8")
    tk, tv = [to_torch(a) for a in k], [to_torch(a) for a in v]
    disk = ttiers.DiskTier(tmp_path)
    key = (1, 2, 3)
    disk.put(key, ttiers.HostSlab(3, tk, tv, ttiers.slab_checksum(tk, tv)))
    path = disk._path(key)
    blob = bytearray(path.read_bytes())
    blob[-1] ^= 1
    path.write_bytes(bytes(blob))
    with pytest.raises(ttiers.TierCorruption, match="crc mismatch"):
        disk.load(key)


# ---------------------------------------------------------------------
# The tiered engine, JAX and port side by side
# ---------------------------------------------------------------------

def engines(params, side, **kw):
    jp, tp = params
    if side == "jax":
        return js.ServingEngine(jp, JCFG, kv_layout="paged", **kw)
    return ts.ServingEngine(tp, TCFG, kv_layout="paged", device="cpu", **kw)


def request(side, uid, pr, max_new, temp=0.0, seed=0):
    cls = js.Request if side == "jax" else ts.Request
    return cls(uid=uid, prompt=pr, max_new=max_new, temperature=temp,
               seed=seed)


def tokens(done) -> dict:
    return {f.uid: np.asarray(f.tokens) for f in done}


SYS = prompt(99, 21)
WAVE = [("g0", np.concatenate([SYS, prompt(1, 4)]), 0.0, 0),
        ("s1", np.concatenate([SYS, prompt(2, 4)]), 0.8, 11),
        ("g2", np.concatenate([SYS, prompt(3, 4)]), 0.0, 0)]


def promote_wave(params, side):
    """The acceptance arc on one package: a warmed shared prefix is
    flushed (demoted on the tiered engine, destroyed on the recompute
    twin, kept on the all-HBM engine), then a greedy + sampled wave
    rides it back."""
    track = jdispatch.track if side == "jax" else tdispatch.track
    mk = {name: engines(params, side, slots=2, kv_blocks=16, **kw)
          for name, kw in (("tiered", {"kv_host_bytes": 1 << 20}),
                           ("allhbm", {}), ("recompute", {}))}
    for eng in mk.values():
        eng.submit(request(side, "warm", SYS, 1))
        eng.run()
    mk["tiered"]._prefix.flush()
    mk["recompute"]._prefix.flush()

    def wave(eng):
        for uid, pr, temp, seed in WAVE:
            eng.submit(request(side, uid, pr, 5, temp, seed))
        return tokens(eng.run())

    with track() as t_tier:
        got = wave(mk["tiered"])
    with track() as t_rec:
        rec = wave(mk["recompute"])
    return (got, rec, wave(mk["allhbm"]), dict(t_tier.by_label),
            dict(t_rec.by_label), mk["tiered"].stats())


def test_promote_wave_matches_jax(params):
    """Port: the tiered wave byte-equal to the all-HBM engine and the
    recompute twin (greedy and sampled), paying no full prefill and one
    slab adopt; greedy streams and every dispatch label count equal to
    the JAX wave's; the same tier counters."""
    jgot, _, _, jlabels, jrec_labels, jstats = promote_wave(params, "jax")
    got, rec, hbm, labels, rec_labels, stats = promote_wave(params, "torch")
    for uid, _, temp, _ in WAVE:
        np.testing.assert_array_equal(got[uid], hbm[uid], err_msg=uid)
        np.testing.assert_array_equal(got[uid], rec[uid], err_msg=uid)
        if temp == 0.0:
            np.testing.assert_array_equal(got[uid], jgot[uid], err_msg=uid)
    assert labels.get("prefill", 0) == 0
    assert labels.get("paged_slab_adopt", 0) == 1
    assert labels.get("prefill_suffix", 0) >= 3
    assert rec_labels.get("prefill", 0) >= 1
    assert labels == jlabels and rec_labels == jrec_labels
    tier_keys = [k for k in jstats if "tier" in k]
    assert {k: stats[k] for k in tier_keys} == {k: jstats[k]
                                                for k in tier_keys}
    assert stats["kv_tier_promotions_total"] == 1


def test_residency_probe_matches_jax(params):
    out = {}
    for side in ("jax", "torch"):
        eng = engines(params, side, slots=2, kv_blocks=16,
                      kv_host_bytes=1 << 20)
        eng.submit(request(side, "warm", SYS, 1))
        eng.run()
        probe = np.concatenate([SYS, prompt(7, 3)])
        row = [eng.prefix_peek(probe), eng.prefix_residency(probe)]
        eng._prefix.flush()
        row += [eng.prefix_peek(probe), eng.prefix_residency(probe),
                eng.prefix_residency(prompt(55, 8))]
        out[side] = row
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == (21, "device")
    assert out["torch"][3] == (21, "host")


def test_promotion_racing_eviction_matches_jax(params):
    """Promoting one prefix on a tight pool demotes another cold entry
    instead of failing the request; tokens and residency as in JAX."""
    pr_a, pr_b = prompt(61, 20), prompt(62, 20)
    a2 = np.concatenate([pr_a, prompt(63, 3)])
    out = {}
    for side in ("jax", "torch"):
        eng = engines(params, side, slots=1, kv_blocks=5, kv_block_size=16,
                      kv_host_bytes=1 << 20, prefix_cache=4)
        for uid, pr in (("a", pr_a), ("b", pr_b)):
            eng.submit(request(side, uid, pr, 1))
            eng.run()
        st = eng._prefix
        st.evict_until(2)
        row = [st.residency_of(tuple(pr_a.tolist())),
               st.residency_of(tuple(pr_b.tolist()))]
        eng.submit(request(side, "a2", a2, 2))
        done = tokens(eng.run())
        row += [list(done), st.promotions,
                st.residency_of(tuple(pr_b.tolist()))]
        out[side] = (row, done["a2"])
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][0][:2] == ["host", "device"]
    assert out["torch"][0][-2:] == [1, "host"]
    np.testing.assert_array_equal(out["torch"][1], out["jax"][1])


@pytest.mark.parametrize("writer,reader", [("torch", "torch"),
                                           ("jax", "torch"),
                                           ("torch", "jax")])
def test_spill_dir_restart_across_packages(params, tmp_path, writer,
                                           reader):
    """A warm prefix spilled to disk by one package's engine outlives
    it: a fresh engine of either package over the same directory reports
    it on disk, promotes it, and its greedy stream equals the JAX
    engine's without the tier."""
    spill = tmp_path / "kvspill"
    eng = engines(params, writer, slots=2, kv_blocks=16, kv_spill_dir=spill)
    eng.submit(request(writer, "warm", SYS, 1))
    eng.run()
    eng._prefix.flush()
    assert eng._prefix.disk_tier_bytes() > 0
    del eng
    pr = np.concatenate([SYS, prompt(5, 4)])
    eng2 = engines(params, reader, slots=2, kv_blocks=16,
                   kv_spill_dir=spill)
    assert eng2.prefix_residency(pr) == (21, "disk")
    track = jdispatch.track if reader == "jax" else tdispatch.track
    eng2.submit(request(reader, "x", pr, 5))
    with track() as t:
        got = tokens(eng2.run())["x"]
    assert eng2._prefix.promotions == 1
    assert t.by_label.get("prefill", 0) == 0
    plain = engines(params, "jax", slots=2, kv_blocks=16)
    plain.submit(request("jax", "x", pr, 5))
    np.testing.assert_array_equal(got, tokens(plain.run())["x"])
    shutil.rmtree(spill)


def test_tiering_requires_paged_layout_as_jax(params):
    jp, tp = params
    with pytest.raises(ValueError) as jerr:
        js.ServingEngine(jp, JCFG, slots=1, kv_host_bytes=1 << 20)
    with pytest.raises(ValueError) as terr:
        ts.ServingEngine(tp, TCFG, slots=1, kv_host_bytes=1 << 20,
                         device="cpu")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="paged"):
        ts.ServingEngine(tp, TCFG, slots=1, kv_spill_dir="unused",
                         device="cpu")


@pytest.mark.parametrize("kw", [dict(kv_host_bytes=1 << 20),
                                dict(kv_spill_dir="SPILL"), dict()])
def test_stats_keys_match_jax(params, tmp_path, kw):
    kw = {k: (tmp_path / v if v == "SPILL" else v) for k, v in kw.items()}
    keys = {}
    for side in ("jax", "torch"):
        eng = engines(params, side, slots=2, kv_blocks=16, **kw)
        eng.submit(request(side, "warm", SYS, 2))
        eng.run()
        keys[side] = set(eng.stats())
    assert keys["torch"] == keys["jax"]


def test_tier_probe_on_the_cpu():
    """The ported probe at a small size: streams equal to the recompute
    twin's, greedy and sampled, and the churn wave hits through
    promotions."""
    out = serving_tier_probe(prefix_len=32, repeats=2, churn_wave=6,
                             d_model=64, n_layers=2, device="cpu")
    assert out["byte_equal"]
    assert out["tier_hit_frac"] > 0 and out["churn_promotions"] > 0
    assert out["promotions"] == 2
    assert out["tier_promote_ms"] > 0 and out["recompute_ms"] > 0
