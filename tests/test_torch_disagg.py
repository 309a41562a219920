"""Port disaggregated prefill/decode (``prefill_export`` / ``adopt_block``
/ ``export_prefix`` / ``import_prefix`` of
k8s_dra_driver_tpu_torch/models/serving.py and the block slabs of
models/decode.py) against itself and against the JAX package, on the CPU
in f32 at the JAX tests' config (tests/test_disagg.py).

A request exported by one port engine and adopted by another gives the
tokens one engine gives it, greedy and sampled (the generator's state
after the first draw rides in the block), in all four layout pairs.  A
JAX engine's greedy block, carried across by ``kv_from_jax``, adopted
by a port engine gives the JAX engine's tokens.  Every adopt gate raises
the JAX engine's exception with the JAX message.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.models import serving as js
from k8s_dra_driver_tpu.models import transformer as jt
from k8s_dra_driver_tpu.serving_lora import pool as jl
from k8s_dra_driver_tpu.utils import dispatch as jdispatch
from k8s_dra_driver_tpu_torch.models import decode as td
from k8s_dra_driver_tpu_torch.models import serving as ts
from k8s_dra_driver_tpu_torch.models import transformer as tt
from k8s_dra_driver_tpu_torch.models.convert import (kv_from_jax,
                                                     params_from_jax)
from k8s_dra_driver_tpu_torch.serving_lora import (AdapterManifest,
                                                   AdapterPool,
                                                   make_adapter)
from k8s_dra_driver_tpu_torch.utils import dispatch as tdispatch

FIELDS = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
              d_ff=64, max_seq=48, n_kv_heads=2)
JCFG = jt.TransformerConfig(dtype=jnp.float32, **FIELDS)
TCFG = tt.TransformerConfig(dtype=torch.float32, **FIELDS)
RANK = 2

LAYOUTS = {"contiguous": {}, "paged": dict(kv_layout="paged",
                                           kv_block_size=8)}
#: greedy and sampled requests of three lengths (the paged slabs hold
#: 1 and 2 blocks)
REQS = [("g", 7, 5, 0.0, 0), ("s", 9, 6, 0.8, 13), ("t", 12, 4, 0.7, 5),
        ("h", 16, 3, 0.0, 0)]


def prompt(seed, n):
    return np.random.default_rng(seed).integers(
        0, FIELDS["vocab"], n).astype(np.int32)


def reqs(cls=ts.Request):
    return [cls(uid=uid, prompt=prompt(10 + i, n), max_new=m,
                temperature=temp, seed=seed)
            for i, (uid, n, m, temp, seed) in enumerate(REQS)]


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(np.asarray,
                      jt.init_params(JCFG, jax.random.PRNGKey(0)))
    return jp, params_from_jax(jp, device="cpu")


def port(tp, slots=2, **kw):
    return ts.ServingEngine(tp, TCFG, slots=slots, device="cpu", top_k=8,
                            **kw)


def tokens(done) -> dict:
    return {f.uid: np.asarray(f.tokens) for f in done}


def unified(tp, rs, **kw) -> dict:
    eng = port(tp, **kw)
    for r in rs:
        eng.submit(r)
    return tokens(eng.run())


@pytest.mark.parametrize("dst", sorted(LAYOUTS))
@pytest.mark.parametrize("src", sorted(LAYOUTS))
def test_split_requests_equal_one_engine(params, src, dst):
    """Every request exported by a ``src`` engine and adopted, in
    request order as slots free, by a ``dst`` engine equals the unified
    ``dst`` engine's stream, greedy and sampled; the decode side runs no
    prefill."""
    _, tp = params
    want = unified(tp, reqs(), **LAYOUTS[dst])
    exporter = port(tp, prefix_cache=2, **LAYOUTS[src])
    blocks = [exporter.prefill_export(r) for r in reqs()]
    kinds = {type(b.kv) for b in blocks}
    assert kinds == {ts.PagedKVSlab if src == "paged" else td.KVCache}
    assert [b.carry is not None for b in blocks] == [
        r[3] > 0 for r in REQS]
    dec = port(tp, **LAYOUTS[dst])
    got = {}
    pending = list(blocks)
    with tdispatch.track() as t:
        while pending or dec.active:
            while pending and dec.active < dec.slots:
                dec.adopt_block(pending.pop(0))
            got.update(tokens(dec.step()))
    assert set(got) == set(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid], err_msg=uid)
    assert not any(t.by_label.get(k) for k in ("prefill", "prefill_suffix",
                                                "prefill_adopt_rows"))
    assert exporter.stats()["kv_exports_total"] == len(REQS)
    assert dec.stats()["kv_adoptions_total"] == len(REQS)
    if src == "paged":
        # a slab ships exactly the prompt's blocks
        assert [b.kv.k[0].shape[0] for b in blocks] == [1, 2, 2, 2]


def test_fused_engine_adopts_in_place(params):
    """A fused contiguous engine (``chain_steps`` > 1) adopts through
    the in-place slot write: the cache object it was built with stays
    its cache, and the streams equal the unified engine's."""
    _, tp = params
    want = unified(tp, reqs())
    exporter = port(tp, **LAYOUTS["paged"])
    dec = port(tp, slots=4, chain_steps=4)
    cache = dec.cache
    for r in reqs():
        dec.adopt_block(exporter.prefill_export(r))
    got = tokens(dec.run())
    assert dec.cache is cache
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid], err_msg=uid)


def test_prefix_hit_export_reuses_and_stays_exact(params):
    """A second export sharing a prompt prefix computes only its suffix
    (``prefill_suffix``, ``reused_tokens``), on both layouts, and the
    adopted stream is unchanged."""
    _, tp = params
    base = prompt(40, 12)
    first = ts.Request(uid="a", prompt=base, max_new=3)
    second = ts.Request(uid="b", prompt=np.concatenate([base, prompt(41, 3)]),
                        max_new=4)
    want = unified(tp, [second])["b"]
    for layout in LAYOUTS.values():
        exporter = port(tp, prefix_cache=2, **layout)
        exporter.prefill_export(first)
        with tdispatch.track() as t:
            blk = exporter.prefill_export(second)
        assert t.by_label.get("prefill", 0) == 0
        assert t.by_label.get("prefill_suffix") == 1
        assert blk.reused_tokens == base.size
        dec = port(tp)
        dec.adopt_block(blk)
        np.testing.assert_array_equal(tokens(dec.run())["b"], want)


def test_max_new_one_finishes_at_adoption(params):
    _, tp = params
    pr = prompt(4, 6)
    for layout in LAYOUTS.values():
        blk = port(tp, **layout).prefill_export(
            ts.Request(uid="one", prompt=pr, max_new=1))
        dec = port(tp, **layout)
        dec.adopt_block(blk)
        with tdispatch.track() as t:
            out = dec.run()
        assert t.by_label.get("paged_decode_step_rows", 0) == 0
        assert t.by_label.get("decode_step_rows", 0) == 0
        np.testing.assert_array_equal(
            out[0].tokens, td.greedy_generate(
                tp, torch.as_tensor(pr[None], dtype=torch.long), TCFG,
                1)[0].numpy())


def jax_block(jp, layout, req):
    eng = js.ServingEngine(jp, JCFG, slots=2, **LAYOUTS[layout])
    blk = eng.prefill_export(req)
    return blk, eng


@pytest.mark.parametrize("dst", sorted(LAYOUTS))
@pytest.mark.parametrize("src", sorted(LAYOUTS))
def test_jax_block_adopted_by_port(params, src, dst):
    """A JAX engine's greedy block (a dense KVCache or a PagedKVSlab),
    carried across by ``kv_from_jax``, adopted by a port engine: the
    port continues with the JAX engine's tokens."""
    jp, tp = params
    pr = prompt(21, 13)
    jreq = js.Request(uid="x", prompt=pr, max_new=6)
    blk, _ = jax_block(jp, src, jreq)
    jdec = js.ServingEngine(jp, JCFG, slots=2, **LAYOUTS[dst])
    jdec.adopt_block(blk)
    want = np.asarray(jdec.run()[0].tokens)
    kv = kv_from_jax(jax.tree.map(np.asarray, blk.kv), device="cpu")
    assert isinstance(kv, ts.PagedKVSlab if src == "paged" else td.KVCache)
    dec = port(tp, **LAYOUTS[dst])
    dec.adopt_block(ts.KVBlock(
        request=ts.Request(uid="x", prompt=pr, max_new=6), kv=kv,
        first=int(blk.first)))
    np.testing.assert_array_equal(dec.run()[0].tokens, want)


def test_slab_functions_match_jax(params):
    """``paged_slab_from_dense`` / ``paged_dense_from_slab`` /
    ``paged_adopt_slab`` against the JAX functions on the same rows."""
    from k8s_dra_driver_tpu.models import decode as jd
    rng = np.random.default_rng(3)
    dense = [rng.standard_normal((1, 48, 2, 8)).astype(np.float32)
             for _ in range(4)]
    jone = jd.KVCache(k=[jnp.asarray(a) for a in dense[:2]],
                      v=[jnp.asarray(a) for a in dense[2:]],
                      pos=jnp.int32(13))
    tone = td.KVCache(k=[torch.from_numpy(a) for a in dense[:2]],
                      v=[torch.from_numpy(a) for a in dense[2:]], pos=13)
    jk, jv = jd.paged_slab_from_dense(jone, n_blocks=2, block_size=8)
    tk, tv = td.paged_slab_from_dense(tone, 2, 8)
    for a, b in zip(tk + tv, jk + jv):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jd_ = jd.paged_dense_from_slab(jk, jv, 13, max_seq=32)
    td_ = td.paged_dense_from_slab(tk, tv, 13, 32)
    assert td_.pos == int(jd_.pos) == 13
    for a, b in zip(td_.k + td_.v, jd_.k + jd_.v):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ids = [3, 1]
    jpool = jd.init_paged_pool(JCFG, 5, 8)
    tpool = td.init_paged_pool(TCFG, 5, 8, device="cpu")
    jpool = jd.paged_adopt_slab(jpool, jk, jv, jnp.asarray(ids, jnp.int32))
    tpool = td.paged_adopt_slab(tpool, tk, tv, ids)
    for a, b in zip(tpool.k + tpool.v, jpool.k + jpool.v):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------
# The adopt gates, message for message
# ---------------------------------------------------------------------

def gate_case(side, params, gate):
    """Trigger one adopt gate in one package; returns the exception."""
    jp, tp = params
    is_jax = side == "jax"
    Req = js.Request if is_jax else ts.Request

    def eng(slots=2, layout="contiguous", **kw):
        kw = {**LAYOUTS[layout], **kw}
        if is_jax:
            return js.ServingEngine(jp, JCFG, slots=slots, **kw)
        return ts.ServingEngine(tp, TCFG, slots=slots, device="cpu", **kw)

    def pool(n_resident):
        names = ("x", "y")
        if is_jax:
            p = jl.AdapterPool(JCFG, RANK, n_resident=n_resident)
            for n in names:
                p.register(jl.AdapterManifest(n, RANK, source=jl.make_adapter(
                    JCFG, RANK, seed=ord(n), scale=0.5)))
            return p
        p = AdapterPool(TCFG, RANK, n_resident=n_resident, device="cpu")
        for n in names:
            p.register(AdapterManifest(n, RANK, source=make_adapter(
                TCFG, RANK, seed=ord(n), scale=0.5)))
        return p

    pr = prompt(30, 9)
    src_layout = "paged" if gate.startswith("slab") else "contiguous"
    src = eng(layout=src_layout, **({"adapter_pool": pool(2)}
                                    if gate == "adapter" else {}))
    blk = src.prefill_export(Req(uid="a", prompt=pr, max_new=3))
    try:
        if gate == "draft":
            params_, cfg = (jp, JCFG) if is_jax else (tp, TCFG)
            eng(draft_params=params_, draft_cfg=cfg).adopt_block(blk)
        elif gate == "duplicate":
            dec = eng()
            dec.adopt_block(blk)
            dec.adopt_block(blk)
        elif gate == "no_slot":
            dec = eng(slots=1)
            dec.adopt_block(blk)
            dec.adopt_block(src.prefill_export(
                Req(uid="b", prompt=pr, max_new=3)))
        elif gate == "adapter":
            dec = eng(adapter_pool=pool(1))
            dec.adopt_block(src.prefill_export(
                Req(uid="b", prompt=pr, max_new=3, adapter="x")))
            dec.adopt_block(src.prefill_export(
                Req(uid="c", prompt=pr, max_new=3, adapter="y")))
        elif gate == "no_carry":
            sampled = src.prefill_export(Req(uid="s", prompt=pr, max_new=3,
                                             temperature=0.8, seed=1))
            field = "carry_key" if is_jax else "carry"
            eng().adopt_block(dataclasses.replace(sampled, **{field: None}))
        elif gate == "slab_block_size":
            eng(layout="paged", kv_block_size=4).adopt_block(blk)
        elif gate == "slab_block_count":
            longer = dataclasses.replace(
                blk.request, prompt=np.concatenate([pr, pr]))
            eng(layout="paged").adopt_block(
                dataclasses.replace(blk, request=longer))
    except (ValueError, RuntimeError) as e:
        return e
    raise AssertionError(f"{side}: gate {gate} did not raise")


GATES = ["draft", "duplicate", "no_slot", "adapter", "no_carry",
         "slab_block_size", "slab_block_count"]


@pytest.mark.parametrize("gate", GATES)
def test_adopt_gates_raise_as_jax(params, gate):
    want = gate_case("jax", params, gate)
    got = gate_case("torch", params, gate)
    assert type(got) is type(want)
    assert str(got) == str(want)


def test_carry_from_another_device_type_raises(params):
    """A CUDA generator's state (Philox seed and offset, 16 bytes) does
    not fit a CPU generator (mt19937): refused before any state
    changes."""
    _, tp = params
    blk = port(tp).prefill_export(ts.Request(
        uid="s", prompt=prompt(5, 7), max_new=3, temperature=0.8, seed=2))
    assert blk.carry.numel() == torch.Generator().get_state().numel()
    dec = port(tp)
    with pytest.raises(ValueError, match="another device type"):
        dec.adopt_block(dataclasses.replace(
            blk, carry=torch.zeros(16, dtype=torch.uint8)))
    assert dec.active == 0 and dec.stats().get("kv_adoptions_total") is None


def engine_state(eng) -> tuple:
    view = eng.kv_manager.view() if eng._paged else None
    return (eng.active, list(eng._req), list(eng._adapter),
            eng._adapter_slot.tolist(), view, len(eng._prefix._store),
            eng.adapter_pool.snapshot())


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_adapter_adoption_refused_untouched_or_bound(params, layout):
    """An adoption the pool cannot seat is refused with no state
    changed; a seated one binds the slot's adapter, and its stream
    equals the unified engine's for the same request and pool."""
    _, tp = params

    def pool(n_resident):
        p = AdapterPool(TCFG, RANK, n_resident=n_resident, device="cpu")
        for n in ("x", "y"):
            p.register(AdapterManifest(n, RANK, source=make_adapter(
                TCFG, RANK, seed=ord(n), scale=0.5)))
        return p

    rx = ts.Request(uid="bx", prompt=prompt(31, 9), max_new=5, adapter="x")
    ry = ts.Request(uid="cy", prompt=prompt(32, 9), max_new=5, adapter="y")
    src = port(tp, adapter_pool=pool(2))
    bx, by = src.prefill_export(rx), src.prefill_export(ry)
    dec = port(tp, adapter_pool=pool(1), prefix_cache=2, **LAYOUTS[layout])
    slot = dec.adopt_block(bx)
    assert dec._adapter[slot] == "x"
    assert dec._adapter_slot[slot] == dec.adapter_pool.slot_of("x") != 0
    before = engine_state(dec)
    with pytest.raises(RuntimeError, match="no adapter slot"):
        dec.adopt_block(by)
    assert engine_state(dec) == before
    got = tokens(dec.run())["bx"]
    want = unified(tp, [rx], adapter_pool=pool(1), **LAYOUTS[layout])["bx"]
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------
# Prefix export / import
# ---------------------------------------------------------------------

@pytest.mark.parametrize("dst", sorted(LAYOUTS))
@pytest.mark.parametrize("src", sorted(LAYOUTS))
def test_prefix_migrates_and_hits(params, src, dst):
    """``export_prefix`` hands out a remembered entry as a dense [1, S]
    cache (paged engines gather their blocks); ``import_prefix`` lands
    it, and the importer's next fill of a prefixed prompt pays only the
    suffix with an unchanged stream."""
    _, tp = params
    base = prompt(50, 12)
    holder = port(tp, prefix_cache=2, **LAYOUTS[src])
    holder.submit(ts.Request(uid="w", prompt=base, max_new=1))
    holder.run()
    entry = holder.export_prefix(base)
    assert isinstance(entry, td.KVCache) and entry.pos >= base.size
    assert holder.export_prefix(prompt(51, 12)) is None
    importer = port(tp, prefix_cache=2, **LAYOUTS[dst])
    importer.import_prefix(base, entry)
    pr = np.concatenate([base, prompt(52, 4)])
    with tdispatch.track() as t:
        importer.submit(ts.Request(uid="x", prompt=pr, max_new=4))
        got = tokens(importer.run())["x"]
    assert t.by_label.get("prefill", 0) == 0
    assert importer.stats()["prefix_tokens_reused_total"] == base.size
    np.testing.assert_array_equal(
        got, unified(tp, [ts.Request(uid="x", prompt=pr, max_new=4)])["x"])


def test_import_skips_when_blocks_are_exhausted(params):
    """A paged importer whose pool is held by running slots skips the
    import (the fill computes locally); one without a prefix cache
    refuses as the JAX engine does."""
    jp, tp = params
    base = prompt(60, 16)
    entry = port(tp, prefix_cache=2).export_prefix(base)
    assert entry is None
    holder = port(tp, prefix_cache=2)
    holder.submit(ts.Request(uid="w", prompt=base, max_new=1))
    holder.run()
    entry = holder.export_prefix(base)
    importer = port(tp, slots=2, kv_layout="paged", kv_block_size=8,
                    kv_blocks=7)
    for i in range(2):
        importer.submit(ts.Request(uid=f"r{i}", prompt=prompt(70 + i, 16),
                                   max_new=4))
    importer.step()
    assert importer.kv_manager.free < 2
    free = importer.kv_manager.free
    importer.import_prefix(base, entry)
    assert importer.prefix_peek(np.concatenate([base, [1]])) == 0
    assert importer.kv_manager.free == free
    with pytest.raises(ValueError) as jerr:
        js.ServingEngine(jp, JCFG, slots=1).import_prefix(base, None)
    with pytest.raises(ValueError) as terr:
        port(tp, slots=1).import_prefix(base, None)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_stats_keys_match_jax_after_handoff(params, layout):
    jp, tp = params
    pr = prompt(80, 9)
    keys = {}
    for side in ("jax", "torch"):
        if side == "jax":
            src = js.ServingEngine(jp, JCFG, slots=2, **LAYOUTS[layout])
            dec = js.ServingEngine(jp, JCFG, slots=2, **LAYOUTS[layout])
            req = js.Request(uid="a", prompt=pr, max_new=2)
        else:
            src, dec = port(tp, **LAYOUTS[layout]), port(tp, **LAYOUTS[layout])
            req = ts.Request(uid="a", prompt=pr, max_new=2)
        dec.adopt_block(src.prefill_export(req))
        dec.run()
        keys[side] = (set(src.stats()), set(dec.stats()))
    assert keys["torch"] == keys["jax"]
    assert "kv_exports_total" in keys["torch"][0]
    assert "kv_adoptions_total" in keys["torch"][1]


def test_export_labels_match_jax(params):
    """A paged export launches what the JAX export launches, label for
    label (the prefill, the local entry's block write, the slab pack)."""
    jp, tp = params
    pr = prompt(90, 11)
    with jdispatch.track() as jt_:
        js.ServingEngine(jp, JCFG, slots=2, **LAYOUTS["paged"]).prefill_export(
            js.Request(uid="a", prompt=pr, max_new=2))
    with tdispatch.track() as tt_:
        port(tp, **LAYOUTS["paged"]).prefill_export(
            ts.Request(uid="a", prompt=pr, max_new=2))
    assert tt_.by_label == jt_.by_label
    assert tt_.by_label.get("paged_slab_export") == 1
