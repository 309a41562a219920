"""Port KV-cache decoding (k8s_dra_driver_tpu_torch/models/decode.py)
against the JAX package's.

JAX parameters move over with ``params_from_jax``; both packages decode
the same numpy prompts.  Logits agree to atol/rtol 1e-4 in f32
(summation order only); greedy tokens agree exactly.  Sampling streams
cannot match (threefry vs Philox), so ``_filter_logits`` is held to
JAX exactly and ``sample_token`` by distribution.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.models import decode as jd
from k8s_dra_driver_tpu.models import transformer as jt
from k8s_dra_driver_tpu_torch.models import decode as td
from k8s_dra_driver_tpu_torch.models import transformer as tt
from k8s_dra_driver_tpu_torch.models.convert import params_from_jax
from k8s_dra_driver_tpu_torch.utils import dispatch

FIELDS = dict(vocab=80, d_model=32, n_layers=2, n_heads=4, d_head=8,
              d_ff=64, max_seq=48, n_kv_heads=2)
JCFG = jt.TransformerConfig(dtype=jnp.float32, **FIELDS)
TCFG = tt.TransformerConfig(dtype=torch.float32, **FIELDS)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(np.asarray,
                      jt.init_params(JCFG, jax.random.PRNGKey(0)))
    return jp, params_from_jax(jp, device="cpu")


def prompts(seed, b, t):
    return np.random.default_rng(seed).integers(
        0, FIELDS["vocab"], (b, t)).astype(np.int32)


def long(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def test_prefill_and_stepwise_decode_match_jax_and_forward(params):
    jp, tp = params
    toks = prompts(1, 2, 14)
    split = 6
    jcache = jd.init_cache(JCFG, 2)
    jlog, jcache = jd.prefill(jp, jnp.asarray(toks[:, :split]), JCFG,
                              jcache)
    tcache = td.init_cache(TCFG, 2, device="cpu")
    tlog, tcache = td.prefill(tp, long(toks[:, :split]), TCFG, tcache)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    full = tt.forward(tp, long(toks), TCFG)
    np.testing.assert_allclose(tlog.numpy(), full[:, :split].numpy(),
                               **TOL)
    pos = np.full(2, split, np.int32)
    for i in range(split, toks.shape[1]):
        jl, jcache = jd.decode_step_rows(jp, jnp.asarray(toks[:, i:i + 1]),
                                         JCFG, jcache, jnp.asarray(pos))
        tl, tcache = td.decode_step_rows(tp, long(toks[:, i:i + 1]), TCFG,
                                         tcache, torch.as_tensor(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(tl.numpy(), full[:, i].numpy(), **TOL)
        pos += 1


MOE_FIELDS = dict(FIELDS, n_experts=4, top_k=2, moe_dispatch="gmm")


@pytest.mark.parametrize("dispatch", ["gmm", "capacity"])
def test_moe_prefill_and_decode_match_jax_and_forward(dispatch):
    """An MoE config serves with dense dispatch (``_serving_cfg``):
    prefill + stepwise decode logits equal JAX's decode and the port's
    training forward under gmm dispatch (dropless, so the same
    function); a capacity-trained config serves the same way."""
    fields = dict(MOE_FIELDS, moe_dispatch=dispatch)
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **fields)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **fields)
    assert td._serving_cfg(tcfg).moe_dispatch == "dense"
    jp = jax.tree.map(np.asarray, jt.init_params(jcfg,
                                                 jax.random.PRNGKey(2)))
    tp = params_from_jax(jp, device="cpu")
    toks = prompts(12, 2, 12)
    split = 5
    jcache = jd.init_cache(jcfg, 2)
    jlog, jcache = jd.prefill(jp, jnp.asarray(toks[:, :split]), jcfg,
                              jcache)
    tcache = td.init_cache(tcfg, 2, device="cpu")
    tlog, tcache = td.prefill(tp, long(toks[:, :split]), tcfg, tcache)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    full = tt.forward(tp, long(toks), dataclasses.replace(
        tcfg, moe_dispatch="gmm"))
    np.testing.assert_allclose(tlog.numpy(), full[:, :split].numpy(),
                               **TOL)
    pos = np.full(2, split, np.int32)
    for i in range(split, toks.shape[1]):
        jl, jcache = jd.decode_step_rows(jp, jnp.asarray(toks[:, i:i + 1]),
                                         jcfg, jcache, jnp.asarray(pos))
        tl, tcache = td.decode_step_rows(tp, long(toks[:, i:i + 1]), tcfg,
                                         tcache, torch.as_tensor(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(tl.numpy(), full[:, i].numpy(), **TOL)
        pos += 1
    want = np.asarray(jd.greedy_generate(jp, jnp.asarray(toks[:, :6]),
                                         jcfg, 5))
    got = td.greedy_generate(tp, long(toks[:, :6]), tcfg, 5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_per_row_positions_decode_independently(params):
    """Rows at different depths in one decode_step_rows call equal each
    row decoded alone (continuous batching is data, not math)."""
    _, tp = params
    a, b = prompts(2, 1, 9)[0], prompts(3, 1, 5)[0]
    cache = td.init_cache(TCFG, 2, device="cpu")
    for row, p in enumerate((a, b)):
        one = td.init_cache(TCFG, 1, device="cpu")
        _, one = td.prefill(tp, long(p[None]), TCFG, one)
        td.adopt_one_slot(cache, one, row)
    nxt = np.asarray([[7], [11]])
    logits, _ = td.decode_step_rows(tp, long(nxt), TCFG, cache,
                                    torch.as_tensor([9, 5]))
    for row, p in enumerate((a, b)):
        want = tt.forward(tp, long(np.append(p, nxt[row])[None]), TCFG)
        np.testing.assert_allclose(logits[row].numpy(),
                                   want[0, -1].numpy(), **TOL)


@pytest.mark.parametrize("tp_len,n", [(5, 9), (11, 4)])
def test_greedy_generate_equals_jax_exactly(params, tp_len, n):
    jp, tp = params
    toks = prompts(4 + tp_len, 2, tp_len)
    want = np.asarray(jd.greedy_generate(jp, jnp.asarray(toks), JCFG, n))
    got = td.greedy_generate(tp, long(toks), TCFG, n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_windowed_greedy_equals_jax_exactly():
    fields = dict(FIELDS, attention_window=4)
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **fields)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **fields)
    jp = jax.tree.map(np.asarray, jt.init_params(jcfg,
                                                 jax.random.PRNGKey(1)))
    toks = prompts(9, 1, 8)
    want = np.asarray(jd.greedy_generate(jp, jnp.asarray(toks), jcfg, 6))
    got = td.greedy_generate(params_from_jax(jp, device="cpu"), long(toks),
                             tcfg, 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_refuses_overflow(params):
    _, tp = params
    with pytest.raises(ValueError, match="exceeds"):
        td.greedy_generate(tp, long(prompts(5, 1, 40)), TCFG, 9)
    with pytest.raises(ValueError, match="n_tokens"):
        td.greedy_generate(tp, long(prompts(5, 1, 4)), TCFG, 0)


FILTERS = [(1.0, 0, 0.0), (0.7, 5, 0.0), (1.3, 0, 0.8), (0.5, 8, 0.6),
           (1.0, 0, 1.0)]


@pytest.mark.parametrize("temp,top_k,top_p", FILTERS)
def test_filter_logits_equals_jax(temp, top_k, top_p):
    logits = np.random.default_rng(6).standard_normal(
        (3, 40)).astype(np.float32) * 3
    want = np.asarray(jd._filter_logits(jnp.asarray(logits), temp, top_k,
                                        top_p))
    got = td._filter_logits(torch.from_numpy(logits), temp, top_k,
                            top_p).numpy()
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_filter_logits_per_row_temperature_equals_jax():
    logits = np.random.default_rng(7).standard_normal(
        (4, 30)).astype(np.float32)
    temps = np.asarray([0.0, 0.5, 1.0, 2.0], np.float32)
    want = np.asarray(jd._filter_logits(jnp.asarray(logits),
                                        jnp.asarray(temps), 6, 0.9))
    got = td._filter_logits(torch.from_numpy(logits),
                            torch.from_numpy(temps), 6, 0.9).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("temp,top_k,top_p", FILTERS[:4])
def test_sample_token_frequencies_match_filtered_softmax(temp, top_k,
                                                         top_p):
    """Total-variation distance between 20000 draws and
    softmax(_filter_logits) stays under 0.03: for a 12-token vocab the
    expected TV of that many draws is about 0.01."""
    logits = np.random.default_rng(8).standard_normal(12).astype(
        np.float32) * 2
    p = np.asarray(jax.nn.softmax(jd._filter_logits(
        jnp.asarray(logits), temp, top_k, top_p)))
    gen = torch.Generator().manual_seed(0)
    draws = td.sample_token(torch.from_numpy(logits).expand(20000, 12),
                            gen, temp, top_k, top_p).numpy()
    freq = np.bincount(draws, minlength=12) / draws.size
    assert 0.5 * np.abs(freq - p).sum() < 0.03
    assert set(np.nonzero(freq)[0]) <= set(np.nonzero(p > 0)[0])


def test_sample_generate_is_seed_deterministic(params):
    _, tp = params
    toks = long(prompts(10, 2, 6))
    runs = [td.sample_generate(tp, toks, TCFG, 8,
                               torch.Generator().manual_seed(s),
                               temperature=0.9, top_k=10)
            for s in (3, 3, 4)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    with pytest.raises(ValueError, match="top_p"):
        td.sample_generate(tp, toks, TCFG, 2, torch.Generator(),
                           top_p=1.5)


def test_select_next_tokens_rows_are_independent():
    logits = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (3, 20)).astype(np.float32))
    gens = [None, torch.Generator().manual_seed(5), None]
    alone = td.select_next_tokens(logits[1:2], [gens[1]], [0.8])
    gens[1] = torch.Generator().manual_seed(5)
    mixed = td.select_next_tokens(logits, gens, [0.0, 0.8, 0.0])
    assert int(mixed[1]) == int(alone[0])
    assert int(mixed[0]) == int(logits[0].argmax())
    assert int(mixed[2]) == int(logits[2].argmax())


def paged_setup(tp, rng, bs=8):
    """Prefill three rows into a contiguous cache and the same rows into
    a block pool through shuffled, non-contiguous tables."""
    lengths = [5, 12, 17]
    tw = FIELDS["max_seq"] // bs
    cache = td.init_cache(TCFG, 3, device="cpu")
    n_blocks = 3 * tw + 1
    pool = td.init_paged_pool(TCFG, n_blocks, bs, device="cpu")
    perm = rng.permutation(np.arange(1, n_blocks))
    tables = np.zeros((3, tw), np.int32)
    toks = []
    for row, L in enumerate(lengths):
        p = rng.integers(0, FIELDS["vocab"], L).astype(np.int32)
        toks.append(p)
        one = td.init_cache(TCFG, 1, device="cpu")
        _, one = td.prefill(tp, long(p[None]), TCFG, one)
        td.adopt_one_slot(cache, one, row)
        nb = tw                      # reserve the whole row's blocks
        tables[row] = perm[row * tw:row * tw + nb]
        td.paged_adopt_blocks(pool, one, tables[row], 0, nb)
    return lengths, cache, pool, torch.as_tensor(tables), toks


def test_paged_decode_is_bitwise_contiguous_decode(params):
    _, tp = params
    lengths, cache, pool, tables, _ = paged_setup(
        tp, np.random.default_rng(12))
    pos = np.asarray(lengths)
    nxt = long([[3], [4], [5]])
    for _ in range(4):
        want, cache = td.decode_step_rows(tp, nxt, TCFG, cache,
                                          torch.as_tensor(pos))
        got, pool = td.paged_decode_step_rows(tp, nxt, TCFG, pool, tables,
                                              torch.as_tensor(pos))
        assert torch.equal(got, want)
        nxt = want.argmax(-1)[:, None]
        pos = pos + 1


def test_paged_decode_matches_jax(params):
    jp, tp = params
    lengths, _, pool, tables, _ = paged_setup(
        tp, np.random.default_rng(13))
    jpool = jd.KVCache(k=[jnp.asarray(a.numpy()) for a in pool.k],
                       v=[jnp.asarray(a.numpy()) for a in pool.v],
                       pos=jnp.int32(0))
    pos = np.asarray(lengths, np.int32)
    nxt = np.asarray([[9], [1], [2]], np.int32)
    for _ in range(3):
        jl, jpool = jd.paged_decode_step_rows(
            jp, jnp.asarray(nxt), JCFG, jpool, jnp.asarray(tables.numpy()),
            jnp.asarray(pos))
        tl, pool = td.paged_decode_step_rows(tp, long(nxt), TCFG, pool,
                                             tables, torch.as_tensor(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        nxt = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
        pos = pos + 1


def test_paged_block_helpers(params):
    _, tp = params
    lengths, cache, pool, tables, _ = paged_setup(
        tp, np.random.default_rng(14))
    ids = tables[1].numpy()
    entry = td.paged_gather_entry(pool, ids, lengths[1])
    assert entry.pos == lengths[1]
    for a, c in zip(entry.k, cache.k):
        assert torch.equal(a[0, :lengths[1]], c[1, :lengths[1]])
    src, dst = int(ids[0]), 0
    td.paged_copy_block(pool, src, dst)
    assert torch.equal(pool.k[0][dst], pool.k[0][src])
    entry.k[0].zero_()                     # a fresh copy, not a view
    assert pool.k[0][src].abs().sum() > 0


def test_paged_kernel_read_is_single_query(params):
    _, tp = params
    _, _, pool, tables, _ = paged_setup(tp, np.random.default_rng(15))
    with pytest.raises(ValueError, match="single-query"):
        td._paged_rows_forward(tp, long([[1, 2]] * 3), TCFG, pool, tables,
                               torch.as_tensor([5, 5, 5]), True)


def test_prefill_adopt_rows_and_suffix_fill(params):
    """The fused fill paths land the same rows and first tokens as a
    plain prefill, and suffix_fill_adopt leaves its entry intact."""
    _, tp = params
    toks = prompts(16, 2, 7)
    cache = td.init_cache(TCFG, 3, device="cpu")
    with dispatch.track() as t:
        first, cache = td.prefill_adopt_rows(tp, long(toks), TCFG, cache,
                                             [2, 0], [None, None],
                                             [0.0, 0.0])
    assert t.by_label == {"prefill_adopt_rows": 1}
    want = tt.forward(tp, long(toks), TCFG)[:, -1].argmax(-1)
    assert torch.equal(first, want)
    one = td.init_cache(TCFG, 1, device="cpu")
    _, one = td.prefill(tp, long(toks[:1]), TCFG, one)
    assert torch.equal(cache.k[1][2, :7], one.k[1][0, :7])
    entry = td.KVCache(k=[a.clone() for a in one.k],
                       v=[a.clone() for a in one.v], pos=4)
    snapshot = [a.clone() for a in entry.k]
    tok, cache, filled = td.suffix_fill_adopt(
        tp, entry, long(toks[0, 4:]), TCFG, cache, 1, None, 0.0)
    assert int(tok) == int(want[0])
    assert filled.pos == 7
    assert all(torch.equal(a, b) for a, b in zip(entry.k, snapshot))
    assert torch.equal(cache.k[0][1, :7], cache.k[0][2, :7])


# -- weight-only int8 and the int8 KV cache --------------------------------

QFIELDS = dict(vocab=96, d_model=48, n_layers=2, n_heads=4, d_head=12,
               d_ff=96, max_seq=32)
QTOL = dict(atol=2e-4, rtol=2e-4)


def quantized_pair(fields, seed=0):
    """(jcfg, tcfg, JAX quantized tree, the same tree in the port)."""
    from k8s_dra_driver_tpu.models.quant import quantize_params
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **fields)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **fields)
    jq = quantize_params(jt.init_params(jcfg, jax.random.PRNGKey(seed)),
                         jcfg)
    return jcfg, tcfg, jq, params_from_jax(jax.tree.map(np.asarray, jq),
                                           device="cpu")


@pytest.mark.parametrize("fields", [
    QFIELDS, dict(QFIELDS, n_kv_heads=2),
    dict(QFIELDS, n_experts=4, top_k=2)], ids=["dense", "gqa", "moe"])
def test_quantized_decode_matches_quantized_forward_and_jax(fields):
    """On int8 weights, prefill + ``decode_step`` logits equal the
    port's quantized training forward and the JAX package's quantized
    prefill and ``decode_step`` (the einsum route there; K7's plain
    version here, every call having at most 24 rows), within 2e-4 as
    the JAX package's own test holds them."""
    jcfg, tcfg, jq, tq_ = quantized_pair(fields)
    toks = prompts(21, 2, 12)
    want = tt.forward(tq_, long(toks), tcfg)
    jcache = jd.init_cache(jcfg, 2, jcfg.max_seq)
    jlog, jcache = jd.prefill(jq, jnp.asarray(toks[:, :8]), jcfg, jcache)
    tcache = td.init_cache(tcfg, 2, device="cpu")
    tlog, tcache = td.prefill(tq_, long(toks[:, :8]), tcfg, tcache)
    np.testing.assert_allclose(tlog.numpy(), want[:, :8].numpy(), **QTOL)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **QTOL)
    for i in range(8, 12):
        jl, jcache = jd.decode_step(jq, jnp.asarray(toks[:, i:i + 1]),
                                    jcfg, jcache)
        with dispatch.track() as t:
            tl, tcache = td.decode_step(tq_, long(toks[:, i:i + 1]), tcfg,
                                        tcache)
        assert t.by_label == {"decode_step": 1}
        assert tcache.pos == i + 1
        np.testing.assert_allclose(tl.numpy(), want[:, i].numpy(), **QTOL)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **QTOL)


def test_int8_kv_cache_matches_jax_int8_cache():
    """``kv_cache_dtype="int8"``: the same int8 rows and scales as the
    JAX package's cache (a value may land one step apart where the two
    f32 projections straddle a rounding boundary), logits equal within
    the f32 tolerance through prefill and per-row decode, and greedy
    generation equal token for token."""
    fields = dict(FIELDS, kv_cache_dtype="int8")
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **fields)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **fields)
    jp = jax.tree.map(np.asarray, jt.init_params(jcfg,
                                                 jax.random.PRNGKey(0)))
    tp = params_from_jax(jp, device="cpu")
    toks = prompts(22, 2, 13)
    jcache = jd.init_cache(jcfg, 2)
    jlog, jcache = jd.prefill(jp, jnp.asarray(toks[:, :7]), jcfg, jcache)
    tcache = td.init_cache(tcfg, 2, device="cpu")
    assert tcache.k[0].dtype == torch.int8
    assert tuple(tcache.k_scale[0].shape) == (2, FIELDS["max_seq"], 2, 1)
    tlog, tcache = td.prefill(tp, long(toks[:, :7]), tcfg, tcache)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for got, want in zip(tcache.tensors(), jcache.k + jcache.v
                         + jcache.k_scale + jcache.v_scale):
        want = np.asarray(want)
        if want.dtype == np.int8:
            diff = np.abs(got.numpy().astype(int) - want.astype(int))
            assert diff.max() <= 1 and (diff == 0).mean() > 0.99
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-7)
    pos = np.full(2, 7, np.int32)
    for i in range(7, 13):
        jl, jcache = jd.decode_step_rows(jp, jnp.asarray(toks[:, i:i + 1]),
                                         jcfg, jcache, jnp.asarray(pos))
        tl, tcache = td.decode_step_rows(tp, long(toks[:, i:i + 1]), tcfg,
                                         tcache, torch.as_tensor(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        pos += 1
    want = np.asarray(jd.greedy_generate(jp, jnp.asarray(toks[:, :5]),
                                         jcfg, 8))
    got = td.greedy_generate(tp, long(toks[:, :5]), tcfg, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_cache_scales_travel_with_the_rows(params):
    """Every adopt-style copy moves the scales with k/v: fused fills,
    the suffix fill (which leaves its entry intact) and ``copy_cache``;
    a paged pool refuses the int8 cache as the JAX package does."""
    _, tp = params
    cfg8 = dataclasses.replace(TCFG, kv_cache_dtype="int8")
    toks = prompts(23, 2, 7)
    cache = td.init_cache(cfg8, 3, device="cpu")
    first, cache = td.prefill_adopt_rows(tp, long(toks), cfg8, cache,
                                         [2, 0], [None, None], [0.0, 0.0])
    one = td.init_cache(cfg8, 1, device="cpu")
    _, one = td.prefill(tp, long(toks[:1]), cfg8, one)
    for a, b in zip(cache.tensors(), one.tensors()):
        assert torch.equal(a[2, :7], b[0, :7])
    entry = td.copy_cache(one, 4)
    assert entry.pos == 4 and entry.k_scale[0] is not one.k_scale[0]
    snapshot = [a.clone() for a in entry.tensors()]
    tok, cache, filled = td.suffix_fill_adopt(
        tp, entry, long(toks[0, 4:]), cfg8, cache, 1, None, 0.0)
    assert int(tok) == int(first[0])
    assert all(torch.equal(a, b) for a, b in zip(entry.tensors(), snapshot))
    for a, b in zip(cache.tensors(), filled.tensors()):
        assert torch.equal(a[1, :7], b[0, :7])
    with pytest.raises(ValueError, match="int8 cache"):
        td.init_paged_pool(cfg8, 9, 8, device="cpu")
