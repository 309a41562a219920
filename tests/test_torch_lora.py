"""Port multi-adapter LoRA serving (k8s_dra_driver_tpu_torch/serving_lora/,
the ``lora`` argument of models/decode.py and ``ServingEngine(...,
adapter_pool=...)``) against the JAX package and against itself, on the
CPU in f32 at the JAX tests' config (tests/test_serving_lora.py).

Adapters cross over as the same numpy dicts (``make_adapter`` is held
byte for byte to the JAX function), base weights through
``params_from_jax``.  The pool's ledger and buffers equal the JAX
pool's; the decode functions equal the JAX ones to 1e-5 with the same
``lora`` argument; greedy engine streams equal the JAX engine's token for
token, and every stream (sampled rows too) equals a port oracle engine
serving one adapter with the same slot count.  The card's CUDA graphs
(``FusedBlockGraph``) are held by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.models import decode as jd
from k8s_dra_driver_tpu.models import serving as js
from k8s_dra_driver_tpu.models import transformer as jt
from k8s_dra_driver_tpu.models.layouts import lora_rules
from k8s_dra_driver_tpu.serving_lora import pool as jl
from k8s_dra_driver_tpu.serving_lora.probe import (
    _CHURN_PATTERN as J_CHURN)
from k8s_dra_driver_tpu.utils import dispatch as jdispatch
from k8s_dra_driver_tpu_torch.models import decode as td
from k8s_dra_driver_tpu_torch.models import serving as ts
from k8s_dra_driver_tpu_torch.models import transformer as tt
from k8s_dra_driver_tpu_torch.models.convert import params_from_jax
from k8s_dra_driver_tpu_torch.serving_kv import NULL_BLOCK, BlocksExhausted
from k8s_dra_driver_tpu_torch.serving_lora import (LORA_RULES,
                                                   AdapterManifest,
                                                   AdapterPool,
                                                   adapter_leaves,
                                                   make_adapter)
from k8s_dra_driver_tpu_torch.serving_lora import probe as tprobe
from k8s_dra_driver_tpu_torch.utils import dispatch as tdispatch

FIELDS = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
              d_ff=64, max_seq=48, n_kv_heads=2)
JCFG = jt.TransformerConfig(dtype=jnp.float32, **FIELDS)
TCFG = tt.TransformerConfig(dtype=torch.float32, **FIELDS)
RANK = 2
LOGIT_TOL = 1e-5


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(np.asarray,
                      jt.init_params(JCFG, jax.random.PRNGKey(0)))
    return jp, params_from_jax(jp, device="cpu")


def prompt(seed, n):
    return np.random.default_rng(seed).integers(
        0, FIELDS["vocab"], n).astype(np.int32)


def long(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def seed_of(name):
    """Adapter weights are a pure function of the name, so every pool
    here (engines, oracles, the JAX pools) agrees on what it means."""
    return 1000 + sum(map(ord, name))


def source(name):
    # scale loud enough to flip greedy argmax on this tiny config (the
    # JAX tests' 0.5): a delta path that never engaged would otherwise
    # pass every equality
    return make_adapter(TCFG, RANK, seed=seed_of(name), scale=0.5)


def make_pool(n_resident, names, tenant_of=lambda n: "-",
              dtype=torch.float32):
    cfg = TCFG if dtype == torch.float32 else tt.TransformerConfig(
        dtype=dtype, **FIELDS)
    pool = AdapterPool(cfg, RANK, n_resident=n_resident, device="cpu")
    for n in names:
        pool.register(AdapterManifest(n, RANK, tenant=tenant_of(n),
                                      source=source(n)))
    return pool


def jax_pool(n_resident, names, dtype=jnp.float32):
    cfg = jt.TransformerConfig(dtype=dtype, **FIELDS)
    pool = jl.AdapterPool(cfg, RANK, n_resident=n_resident)
    for n in names:
        pool.register(jl.AdapterManifest(
            n, RANK, source=jl.make_adapter(cfg, RANK, seed=seed_of(n),
                                            scale=0.5)))
    return pool


def assert_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=0,
        atol=LOGIT_TOL * max(1.0, float(np.abs(want).max())))


# ---------------------------------------------------------------------
# The pool
# ---------------------------------------------------------------------

@pytest.mark.parametrize("seed,scale,rank", [(0, 0.05, 2), (1041, 0.5, 2),
                                             (7, 0.05, 16)])
def test_make_adapter_byte_equal_jax(seed, scale, rank):
    """The carrier of every adapter across the two packages: the same
    leaf names, shapes and bytes for a seed."""
    want = jl.make_adapter(JCFG, rank, seed=seed, scale=scale)
    got = make_adapter(TCFG, rank, seed=seed, scale=scale)
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype == np.float32
        assert got[name].tobytes() == want[name].tobytes(), name
    assert list(adapter_leaves(TCFG, rank)) == list(
        jl.adapter_leaves(JCFG, rank))


def test_lora_rules_are_the_jax_patterns():
    assert LORA_RULES == tuple(pat for pat, _ in lora_rules(JCFG))


class TestAdapterPool:
    def test_null_slot_zero_and_base_maps_to_it(self):
        pool = make_pool(2, ["x"])
        assert pool.slot_of(None) == NULL_BLOCK == 0
        for layer in pool.buffers:
            for buf in layer:
                assert not buf[0].any()
        # the null slot is the manager's own pin, never evictable
        assert pool.evictable() == ()
        assert pool.acquire(None) == NULL_BLOCK

    def test_registration_validates_rank_and_shapes(self):
        pool = make_pool(2, [])
        with pytest.raises(ValueError, match="rank"):
            pool.register(AdapterManifest(
                "bad", RANK + 1, source=make_adapter(TCFG, RANK + 1, seed=1)))
        # a malformed leaf fails at its cold load, before any buffer row
        # is touched
        src = make_adapter(TCFG, RANK, seed=2)
        src["layers/1/wo/B"] = src["layers/1/wo/B"][:-1]
        pool.register(AdapterManifest("torn", RANK, source=src))
        before = [b.clone() for layer in pool.buffers for b in layer]
        with pytest.raises(ValueError, match="shape"):
            pool.acquire("torn")
        after = [b for layer in pool.buffers for b in layer]
        assert all(torch.equal(a, b) for a, b in zip(before, after))
        with pytest.raises(KeyError):
            pool.acquire("never-registered")

    def test_lru_eviction_spares_pinned_adapters(self):
        pool = make_pool(2, ["x", "y", "z"])
        pool.release(pool.acquire("x"))          # resident, cold
        sy = pool.acquire("y")                   # resident, pinned
        pool.acquire("z")                        # pressure: evict LRU
        assert pool.resident() == ("y", "z")
        assert pool.evictions_total == 1
        assert pool.cold_loads_total == 3
        with pytest.raises(BlocksExhausted):
            pool.acquire("x")
        pool.release(sy)                         # y cold again
        assert pool.acquire("x") is not None
        assert "y" not in pool.resident()

    def test_headroom_and_can_admit(self):
        pool = make_pool(2, ["x", "y"])
        assert pool.headroom_slots() == 2
        assert pool.can_admit(None)
        assert pool.can_admit("x")
        assert not pool.can_admit("unknown")
        sx, sy = pool.acquire("x"), pool.acquire("y")
        assert pool.headroom_slots() == 0
        assert pool.can_admit("x")               # resident: always
        pool.release(sx)
        assert pool.headroom_slots() == 1        # x evictable now
        pool.release(sy)

    def test_storm_seizes_down_to_one_slot(self):
        pool = make_pool(3, ["x", "y"])
        pool.release(pool.acquire("x"))
        assert pool.seize_to_one() > 0
        assert pool.storm_active
        assert pool.resident() == ()             # cold x evicted
        assert pool.headroom_slots() == 1
        s = pool.acquire("y")                    # the one slot works
        assert not pool.can_admit("x")           # ...and only it
        pool.release(s)
        pool.release_storm()
        assert not pool.storm_active
        assert pool.headroom_slots() == 3

    def test_tenant_accounting_coldest_first(self):
        owner = {"x1": "t-lo", "x2": "t-lo", "y1": "t-hi"}
        pool = make_pool(3, ["x1", "x2", "y1"], tenant_of=owner.__getitem__)
        for n in ("x1", "x2", "y1"):
            pool.release(pool.acquire(n))
        bps = pool.bytes_per_slot
        assert pool.resident_bytes("t-lo") == 2 * bps
        assert pool.resident_bytes("t-hi") == 1 * bps
        assert pool.cold_names("t-lo") == ("x1", "x2")
        s = pool.acquire("x1")                   # pin the coldest
        assert pool.cold_names("t-lo") == ("x2",)
        pool.release(s)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_equals_jax_pool_and_writes_in_place(dtype):
    """The same acquire / release / evict sequence on both pools: the
    same slots, snapshots and byte counts, and buffers equal to the JAX
    pool's bit for bit (the cast to the model dtype included).  Every
    cold load and eviction leaves each buffer at its address: the loads
    write slots in place."""
    names = ["la", "lb", "lc"]
    tpool = make_pool(2, names, dtype=getattr(torch, dtype))
    jpool = jax_pool(2, names, dtype=getattr(jnp, dtype))
    ptrs = [b.data_ptr() for layer in tpool.buffers for b in layer]
    ops = [("acquire", "la"), ("acquire", "lb"), ("release", "la"),
           ("acquire", "lc"), ("release", "lb"), ("acquire", "la"),
           ("evict", "la"), ("release", "lc"), ("evict", "lc"),
           ("acquire", "lb"), ("release", "lb"), ("release", "la")]
    slots = {}
    for op, name in ops:
        if op == "acquire":
            got, want = tpool.acquire(name), jpool.acquire(name)
            assert got == want
            slots[name] = got
        elif op == "release":
            tpool.release(slots[name])
            jpool.release(slots[name])
        else:
            assert tpool.evict(name) == jpool.evict(name)
        assert tpool.snapshot() == jpool.snapshot()
        for tl, jl_ in zip(tpool.buffers, jpool.buffers):
            for tb, jb in zip(tl, jl_):
                np.testing.assert_array_equal(
                    tb.float().numpy(), np.asarray(jb, np.float32))
    assert [b.data_ptr() for layer in tpool.buffers for b in layer] == ptrs
    assert tpool.cold_loads_total == 5 and tpool.evictions_total == 3
    assert tpool.accounted_bytes() == jpool.accounted_bytes()
    assert tpool.bytes_per_slot == jpool.bytes_per_slot


# ---------------------------------------------------------------------
# The decode functions with the same ``lora`` argument
# ---------------------------------------------------------------------

#: per-row pool slot ids of the three rows: an adapter, the null
#: adapter (a base row) and another adapter
ROW_SLOTS = [1, 0, 2]


@pytest.fixture(scope="module")
def pools():
    jpool, tpool = jax_pool(3, ["la", "lb"]), make_pool(3, ["la", "lb"])
    for name in ("la", "lb"):
        assert tpool.acquire(name) == jpool.acquire(name)
    return jpool, tpool


def loras(pools, slots=ROW_SLOTS):
    jpool, tpool = pools
    return ((jnp.asarray(slots, jnp.int32), jpool.buffers),
            (long(slots), tpool.buffers))


def prefilled(jp, tp, toks):
    b = toks.shape[0]
    _, jcache = jd.prefill(jp, jnp.asarray(toks), JCFG,
                           jd.init_cache(JCFG, b))
    _, tcache = td.prefill(tp, long(toks), TCFG,
                           td.init_cache(TCFG, b, device="cpu"))
    return jcache, tcache


def test_decode_step_rows_with_lora_equal_jax(params, pools):
    """Two steps with per-row adapters: logits to 1e-5 of JAX's.  The
    base row equals a step without adapters bit for bit (the null slot
    adds an exact zero), the adapter rows differ from it."""
    jp, tp = params
    jlora, tlora = loras(pools)
    jcache, tcache = prefilled(jp, tp, prompt(1, (3, 6)))
    plain = td.copy_cache(tcache, 0)
    pos = np.full(3, 6)
    for seed in (2, 3):
        nxt = prompt(seed, (3, 1))
        jlog, jcache = jd.decode_step_rows(jp, jnp.asarray(nxt), JCFG, jcache,
                                           jnp.asarray(pos, jnp.int32),
                                           lora=jlora)
        tlog, tcache = td.decode_step_rows(tp, long(nxt), TCFG, tcache,
                                           long(pos), tlora)
        base, plain = td.decode_step_rows(tp, long(nxt), TCFG, plain,
                                          long(pos))
        assert_close(tlog.numpy(), jlog)
        assert torch.equal(tlog[1], base[1])
        assert not torch.allclose(tlog[0], base[0])
        assert not torch.allclose(tlog[2], base[2])
        pos = pos + 1


def test_decode_window_rows_with_lora_equal_jax(params, pools):
    jp, tp = params
    jlora, tlora = loras(pools)
    jcache, tcache = prefilled(jp, tp, prompt(4, (3, 6)))
    for pos, seed in (([6, 6, 6], 5), ([7, 8, 9], 6)):
        win = prompt(seed, (3, 4))
        jlog, jcache = jd.decode_window_rows(
            jp, jnp.asarray(win), JCFG, jcache, jnp.asarray(pos, jnp.int32),
            lora=jlora)
        tlog, tcache = td.decode_window_rows(tp, long(win), TCFG, tcache,
                                             long(pos), tlora)
        assert_close(tlog.numpy(), jlog)


def paged_pair(tcache, tables, n_blocks, bs):
    """JAX and port block pools holding each row's dense rows at its
    table's blocks."""
    pools = []
    for a in tcache.k + tcache.v:
        dense = a.numpy()
        pool = np.zeros((n_blocks, bs) + dense.shape[2:], np.float32)
        for b, row in enumerate(tables):
            for i, blk in enumerate(row):
                pool[blk] = dense[b, i * bs:(i + 1) * bs]
        pools.append(pool)
    n = TCFG.n_layers
    return (jd.KVCache(k=[jnp.asarray(p) for p in pools[:n]],
                       v=[jnp.asarray(p) for p in pools[n:]],
                       pos=jnp.int32(0)),
            td.KVCache(k=[torch.as_tensor(p) for p in pools[:n]],
                       v=[torch.as_tensor(p) for p in pools[n:]]))


@pytest.mark.parametrize("form", ["step", "window"])
def test_paged_rows_with_lora_equal_jax_and_contiguous(params, pools, form):
    """The paged step and window over a shuffled block layout: logits
    to 1e-5 of JAX's paged call and bitwise the port's contiguous call
    with the same adapters."""
    jp, tp = params
    jlora, tlora = loras(pools)
    bs, b = 8, 3
    tw = FIELDS["max_seq"] // bs
    _, tcache = prefilled(jp, tp, prompt(7, (b, 6)))
    tables = (1 + np.random.default_rng(8).permutation(b * tw)).reshape(
        b, tw).astype(np.int32)
    jpaged, tpaged = paged_pair(tcache, tables, b * tw + 1, bs)
    pos = [6, 7, 9]
    toks = prompt(9, (b, 1 if form == "step" else 4))
    jtab, ttab = jnp.asarray(tables), torch.as_tensor(tables)
    jpos = jnp.asarray(pos, jnp.int32)
    if form == "step":
        jlog, _ = jd.paged_decode_step_rows(jp, jnp.asarray(toks), JCFG,
                                            jpaged, jtab, jpos, lora=jlora)
        tlog, _ = td.paged_decode_step_rows(tp, long(toks), TCFG, tpaged,
                                            ttab, long(pos), False, tlora)
        dlog, _ = td.decode_step_rows(tp, long(toks), TCFG, tcache,
                                      long(pos), tlora)
    else:
        jlog, _ = jd.paged_window_rows(jp, jnp.asarray(toks), JCFG, jpaged,
                                       jtab, jpos, lora=jlora)
        tlog, _ = td.paged_window_rows(tp, long(toks), TCFG, tpaged, ttab,
                                       long(pos), tlora)
        dlog, _ = td.decode_window_rows(tp, long(toks), TCFG, tcache,
                                        long(pos), tlora)
    assert_close(tlog.numpy(), jlog)
    assert torch.equal(tlog, dlog)


def block_inputs(jp, tp, seed):
    toks = prompt(seed, (3, 6))
    jlog, jcache = jd.prefill(jp, jnp.asarray(toks), JCFG,
                              jd.init_cache(JCFG, 3))
    _, tcache = td.prefill(tp, long(toks), TCFG,
                           td.init_cache(TCFG, 3, device="cpu"))
    last = np.array(jnp.argmax(jlog[:, -1], axis=-1), np.int32)
    return jcache, tcache, last, np.full(3, 6, np.int32)


def test_decode_fused_rows_with_lora_equal_jax(params, pools):
    """Greedy rows with per-row adapters, budgets 5/3/0 (the last row
    inactive from step 0): packed tokens and counts equal JAX's block,
    and the step-by-step decode with the same adapters."""
    jp, tp = params
    jlora, tlora = loras(pools)
    jcache, tcache, last, pos = block_inputs(jp, tp, 10)
    k, budget, eos = 5, np.asarray([5, 3, 0]), np.full(3, -1)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(3) + 7)
    want, jdone, _, _ = jd.decode_fused_rows(
        jp, jnp.asarray(last), JCFG, jcache, jnp.asarray(pos), k, keys,
        jnp.zeros(3, jnp.float32), jnp.asarray(budget, jnp.int32),
        jnp.asarray(eos, jnp.int32), lora=jlora)
    step_cache = td.copy_cache(tcache, 0)
    got, done, _ = td.decode_fused_rows(
        tp, torch.as_tensor(last), TCFG, tcache, torch.as_tensor(pos), k,
        [torch.Generator() for _ in range(3)], torch.zeros(3),
        torch.as_tensor(budget), torch.as_tensor(eos), 0, 0.0, tlora)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(done) == int(jdone) == 3
    tok, p = long(last), long(pos)
    for j in range(k):
        logits, step_cache = td.decode_step_rows(tp, tok[:, None], TCFG,
                                                 step_cache, p, tlora)
        tok, p = logits.argmax(-1), p + 1
        for row in (0, 1):
            if j < budget[row]:
                assert int(got[row, j]) == int(tok[row])


def test_decode_spec_fused_rows_with_lora_equal_jax(params, pools):
    """The fused speculative block with the n-gram source over
    repetitive contexts: the adapters reach the target window, and the
    packed tokens, counts, accepts and windows equal JAX's."""
    jp, tp = params
    jlora, tlora = loras(pools)
    jcache, tcache, last, pos = block_inputs(jp, tp, 11)
    ctx = np.zeros((3, FIELDS["max_seq"]), np.int32)
    motif = np.tile(np.asarray([5, 9, 2, 7], np.int32), 3)
    ctx[:, :12] = motif
    ctx_len = np.full(3, 12, np.int32)
    k, kd = 3, 2
    budget, eos = np.asarray([8, 5, 6]), np.full(3, -1)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(3) + 7)
    want = jd.decode_spec_fused_rows(
        jp, jnp.asarray(last), JCFG, jcache, jnp.asarray(pos), k, keys,
        jnp.zeros(3, jnp.float32), jnp.asarray(budget, jnp.int32),
        jnp.asarray(eos, jnp.int32), jnp.asarray(ctx), jnp.asarray(ctx_len),
        None, None, None, None, kd, lora=jlora)
    got, done, _ = td.decode_spec_fused_rows(
        tp, torch.as_tensor(last), TCFG, tcache, torch.as_tensor(pos), k,
        [torch.Generator() for _ in range(3)], torch.zeros(3),
        torch.as_tensor(budget), torch.as_tensor(eos),
        torch.as_tensor(ctx), torch.as_tensor(ctx_len), None, None, None,
        None, kd, 0, 0.0, tlora)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want[0]))
    assert int(done) == int(want[1])


def test_lora_none_keeps_the_path_and_its_dispatches(params, pools):
    """``lora=None`` and a lora of null slots only give the same logits
    bit for bit and the same dispatch labels (the argument adds no
    launch site)."""
    _, tp = params
    _, tcache = prefilled(params[0], tp, prompt(12, (3, 6)))
    other = td.copy_cache(tcache, 0)
    nxt, pos = long(prompt(13, (3, 1))), long([6, 6, 6])
    _, tlora = loras(pools, [0, 0, 0])
    with tdispatch.track() as a:
        plain, _ = td.decode_step_rows(tp, nxt, TCFG, tcache, pos)
    with tdispatch.track() as b:
        nulls, _ = td.decode_step_rows(tp, nxt, TCFG, other, pos, tlora)
    assert torch.equal(plain, nulls)
    assert a.by_label == b.by_label == {"decode_step_rows": 1}


# ---------------------------------------------------------------------
# The engine: mixed-adapter batches
# ---------------------------------------------------------------------

ROSTER = [None, "la", "lb", "la", "lc", None, "lb", "lc", "la", "lc", "lb",
          None]
ADAPTERS = ["la", "lb", "lc"]


def roster_reqs(mod):
    return [mod.Request(uid=f"r{i}", prompt=prompt(300 + i, 5 + i % 3),
                        max_new=3 + i % 3, adapter=a,
                        temperature=0.8 if i % 5 == 0 else 0.0, seed=17)
            for i, a in enumerate(ROSTER)]


def drain(eng, reqs):
    for r in reqs:
        eng.submit(r)
    return {f.uid: np.asarray(f.tokens, np.int32) for f in eng.run()}


#: engine variants: the decode paths a mixed batch goes through
VARIANTS = {
    "contiguous": {},
    "paged": dict(kv_layout="paged", kv_block_size=8),
    # 4 blocks of 4 rows hold one 16-token sequence and no more: rows
    # get preempted and rerun
    "paged_preempt": dict(kv_layout="paged", kv_block_size=4, max_seq=16,
                          kv_blocks=5),
    "fused": dict(chain_steps=4),
    "ngram": dict(draft_source="ngram", draft_len=3),
    "ngram_fused": dict(draft_source="ngram", draft_len=3, chain_steps=3),
    "ngram_paged": dict(draft_source="ngram", draft_len=3, kv_layout="paged",
                        kv_block_size=8),
}

POOL_COUNTERS = ("hits_total", "cold_loads_total", "evictions_total")


def oracle_streams(tp, reqs, slots, **kw):
    """Each adapter's (and the base model's) requests alone on a port
    engine of ``slots`` slots whose pool knows only that adapter."""
    out = {}
    for name in [None] + ADAPTERS:
        pool = None if name is None else make_pool(1, [name])
        eng = ts.ServingEngine(tp, TCFG, slots=slots, adapter_pool=pool,
                               device="cpu", **kw)
        out.update(drain(eng, [r for r in reqs if r.adapter == name]))
    return out


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_mixed_batch_equals_oracles_and_jax_engine(params, variant):
    """The decode invariant: greedy and sampled rows of three adapters,
    and base rows beside them, decode in one batch while the working set
    churns through a 2-slot pool.  Every stream equals a one-adapter
    port oracle of the same slot count and kind; every greedy stream
    equals the JAX engine's; the pool's hits, cold loads and evictions
    and the paged counters equal the JAX engine's."""
    jp, tp = params
    kw = VARIANTS[variant]
    jpool, tpool = jax_pool(2, ADAPTERS), make_pool(2, ADAPTERS)
    want = drain(js.ServingEngine(jp, JCFG, slots=4, adapter_pool=jpool,
                                  **kw), roster_reqs(js))
    eng = ts.ServingEngine(tp, TCFG, slots=4, adapter_pool=tpool,
                           device="cpu", **kw)
    reqs = roster_reqs(ts)
    got = drain(eng, reqs)
    assert set(got) == set(want) == {r.uid for r in reqs}
    oracle = oracle_streams(tp, reqs, 4, **kw)
    for r in reqs:
        np.testing.assert_array_equal(got[r.uid], oracle[r.uid],
                                      err_msg=r.uid)
        if r.temperature == 0:
            np.testing.assert_array_equal(got[r.uid], want[r.uid],
                                          err_msg=r.uid)
    for key in POOL_COUNTERS:
        assert getattr(tpool, key) == getattr(jpool, key), key
    assert tpool.cold_loads_total >= 3
    assert tpool.evictions_total >= 1 and tpool.hits_total >= 1
    # every pin dropped at the end: all residents evictable again
    assert tpool.headroom_slots() == 2
    assert not eng._adapter_slot.any()
    if variant == "paged_preempt":
        assert eng.stats()["kv_preemptions_total"] > 0


def test_fused_equals_step_with_adapters(params):
    """Mixed greedy and sampled rows with adapters: the fused block's
    streams equal the step engine's token for token."""
    _, tp = params
    step = drain(ts.ServingEngine(tp, TCFG, slots=4, top_k=20,
                                  adapter_pool=make_pool(2, ADAPTERS),
                                  device="cpu"), roster_reqs(ts))
    fused = drain(ts.ServingEngine(tp, TCFG, slots=4, top_k=20,
                                   chain_steps=3,
                                   adapter_pool=make_pool(2, ADAPTERS),
                                   device="cpu"), roster_reqs(ts))
    for uid in step:
        np.testing.assert_array_equal(fused[uid], step[uid], err_msg=uid)


def test_adapter_delta_actually_engages(params):
    """The null adapter must not alias everything: an adapter's request
    leaves the base model's stream on the same prompt."""
    _, tp = params
    pr = prompt(42, 6)
    base = drain(ts.ServingEngine(tp, TCFG, slots=2, device="cpu"),
                 [ts.Request(uid="b", prompt=pr, max_new=6)])["b"]
    tuned = drain(ts.ServingEngine(tp, TCFG, slots=2, device="cpu",
                                   adapter_pool=make_pool(1, ["la"])),
                  [ts.Request(uid="t", prompt=pr, max_new=6,
                              adapter="la")])["t"]
    assert not np.array_equal(base, tuned)
    # prefill stays base-model: the first generated token agrees
    assert base[6] == tuned[6]


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_adapter_requests_never_seed_prefix_store(params, layout):
    """Decode-written K/V depends on the adapter, so an adapter request's
    finish must not insert its prompt + generated rows into the shared
    prefix store; a follow-up on those rows reuses at most the fill-time
    prompt entry (prefill is base-model)."""
    _, tp = params
    kw = (dict(prefix_cache=4) if layout == "contiguous"
          else dict(kv_layout="paged", kv_block_size=8))
    eng = ts.ServingEngine(tp, TCFG, slots=2, device="cpu",
                           adapter_pool=make_pool(2, ["la"]), **kw)
    pr = prompt(77, 8)
    done = drain(eng, [ts.Request(uid="w", prompt=pr, max_new=4,
                                  adapter="la")])
    follow = done["w"][:-1]
    drain(eng, [ts.Request(uid="f", prompt=follow, max_new=2)])
    assert eng.stats()["prefix_tokens_reused_total"] <= pr.size
    # a base request's finish does seed it
    eng2 = ts.ServingEngine(tp, TCFG, slots=2, device="cpu",
                            adapter_pool=make_pool(2, ["la"]), **kw)
    done = drain(eng2, [ts.Request(uid="w", prompt=pr, max_new=4)])
    drain(eng2, [ts.Request(uid="f", prompt=done["w"][:-1], max_new=2)])
    assert eng2.stats()["prefix_tokens_reused_total"] > pr.size


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_refill_defers_unadmittable_adapter_then_recovers(params, layout):
    """The admission gate: a request whose adapter cannot claim a pool
    slot stays queued (no torn fill, no crash) and fills once a pin
    drops; its stream equals the oracle's."""
    _, tp = params
    kw = {} if layout == "contiguous" else dict(kv_layout="paged",
                                                kv_block_size=8)
    pool = make_pool(1, ["la", "lb"])
    held = pool.acquire("lb")                    # an outside pin
    eng = ts.ServingEngine(tp, TCFG, slots=2, adapter_pool=pool,
                           device="cpu", **kw)
    pr = prompt(88, 5)
    eng.submit(ts.Request(uid="w", prompt=pr, max_new=3, adapter="la"))
    for _ in range(3):
        assert eng.step() == []
    assert eng.pending == 1 and eng.active == 0
    pool.release(held)                           # lb cold now
    [fin] = eng.run()
    want = oracle_streams(tp, [ts.Request(uid="w", prompt=pr, max_new=3,
                                          adapter="la")], 2, **kw)
    np.testing.assert_array_equal(fin.tokens, want["w"])


def test_occupancy_and_stats_report_residency(params):
    _, tp = params
    pool = make_pool(2, ["la"])
    eng = ts.ServingEngine(tp, TCFG, slots=2, adapter_pool=pool,
                           device="cpu")
    occ = eng.occupancy()
    assert occ["adapter_resident"] == []
    assert occ["adapter_pool_slots"] == 2
    assert occ["adapter_free_slots"] == 2
    assert occ["adapter_headroom_slots"] == 2
    eng.submit(ts.Request(uid="w", prompt=prompt(9, 5), max_new=4,
                          adapter="la"))
    eng.step()
    assert eng.occupancy()["adapter_headroom_slots"] == 1   # pinned
    eng.run()
    occ = eng.occupancy()
    assert occ["adapter_resident"] == ["la"]
    assert occ["adapter_free_slots"] == 1
    assert occ["adapter_headroom_slots"] == 2
    st = eng.stats()
    assert (st["adapter_residents"], st["adapter_pool_slots"],
            st["adapter_hits_total"], st["adapter_cold_loads_total"],
            st["adapter_evictions_total"]) == (1, 2, 0, 1, 0)
    assert "adapter_resident" not in ts.ServingEngine(
        tp, TCFG, slots=1, device="cpu").occupancy()


def test_cancel_releases_the_adapter_pin(params):
    _, tp = params
    pool = make_pool(1, ["la", "lb"])
    eng = ts.ServingEngine(tp, TCFG, slots=2, adapter_pool=pool,
                           device="cpu")
    eng.submit(ts.Request(uid="w", prompt=prompt(5, 5), max_new=20,
                          adapter="la"))
    eng.step()
    assert pool.headroom_slots() == 0 and eng._adapter_slot[0] == 1
    assert eng.cancel("w")
    assert pool.evictable() == ("la",)
    assert not eng._adapter_slot.any()
    # the freed pin admits another adapter through the same slot
    [fin] = drain(eng, [ts.Request(uid="x", prompt=prompt(6, 5), max_new=2,
                                   adapter="lb")]).values()
    assert pool.resident() == ("lb",) and pool.evictions_total == 1


def test_intake_and_layout_checks_raise_as_jax(params):
    jp, tp = params
    eng = ts.ServingEngine(tp, TCFG, slots=1, device="cpu")
    with pytest.raises(ValueError, match="no adapter pool"):
        eng.submit(ts.Request(uid="x", prompt=prompt(1, 4), max_new=2,
                              adapter="la"))
    eng = ts.ServingEngine(tp, TCFG, slots=1, device="cpu",
                           adapter_pool=make_pool(1, ["la"]))
    with pytest.raises(ValueError, match="unknown adapter"):
        eng.submit(ts.Request(uid="x", prompt=prompt(1, 4), max_new=2,
                              adapter="lz"))
    other = tt.TransformerConfig(dtype=torch.float32,
                                 **dict(FIELDS, n_layers=1))
    with pytest.raises(ValueError, match="different model shape"):
        ts.ServingEngine(tp, TCFG, slots=1, device="cpu",
                         adapter_pool=AdapterPool(other, RANK, 1,
                                                  device="cpu"))
    with pytest.raises(ValueError, match="different model shape"):
        js.ServingEngine(jp, JCFG, slots=1, adapter_pool=jl.AdapterPool(
            jt.TransformerConfig(dtype=jnp.float32,
                                 **dict(FIELDS, n_layers=1)), RANK, 1))


# ---------------------------------------------------------------------
# Adapter-less serving is untouched by a pool
# ---------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["contiguous", "paged", "fused",
                                     "ngram"])
def test_adapterless_outputs_and_dispatch_counts_unchanged(params, variant):
    """A pool present, every row on the null adapter: not one output
    byte and not one dispatch label's count of adapter-less traffic
    moves, greedy and sampled."""
    _, tp = params
    reqs = [("g0", prompt(60, 5), 6, 0.0), ("g1", prompt(61, 8), 4, 0.0),
            ("s0", prompt(62, 6), 5, 0.9)]

    def run(with_pool):
        pool = make_pool(2, ["la", "lb"]) if with_pool else None
        eng = ts.ServingEngine(tp, TCFG, slots=2, top_k=8, adapter_pool=pool,
                               device="cpu", **VARIANTS[variant])
        with tdispatch.track() as t:
            outs = drain(eng, [ts.Request(uid=u, prompt=p, max_new=n,
                                          temperature=temp, seed=23)
                               for u, p, n, temp in reqs])
        return outs, t

    plain, t0 = run(with_pool=False)
    pooled, t1 = run(with_pool=True)
    assert set(plain) == set(pooled)
    for uid in plain:
        np.testing.assert_array_equal(plain[uid], pooled[uid])
    assert t1.dispatches == t0.dispatches
    assert t1.by_label == t0.by_label


# ---------------------------------------------------------------------
# The probe
# ---------------------------------------------------------------------

def test_lora_probe_is_exact_and_churns_as_jax(params):
    """The port probe on the CPU: the churn wave is byte-equal to its
    oracles, and its hits, cold loads and evictions equal the JAX engine
    serving the same wave pattern (they depend on the schedule only)."""
    jp, _ = params
    out = tprobe.lora_serving_probe(repeats=1, device="cpu")
    assert out["byte_equal"]
    assert tprobe._CHURN_PATTERN == J_CHURN
    jpool = jax_pool(2, ["l-0", "l-1", "l-2"])
    jeng = js.ServingEngine(jp, JCFG, slots=4, adapter_pool=jpool)
    for i in range(out["wave"]):
        jeng.submit(js.Request(uid=f"r{i}", prompt=prompt(100 + i, 8),
                               max_new=8, adapter=J_CHURN[i % len(J_CHURN)]))
    jeng.run()
    assert (out["churn_hits"], out["churn_cold_loads"],
            out["churn_evictions"]) == (jpool.hits_total,
                                        jpool.cold_loads_total,
                                        jpool.evictions_total)
    assert out["lora_resident_hit_frac"] == jpool.hits_total / (
        jpool.hits_total + jpool.cold_loads_total)
    assert 0.0 < out["lora_resident_hit_frac"] < 1.0
    assert out["lora_switch_ms"] > 0 and out["lora_coldload_ms"] > 0
    assert out["device"] == "cpu" and out["dtype"] == "float32"
