"""Port fused generation block (``decode_fused_rows``, the engine's
``chain_steps > 1``) against the JAX package's and against the port's
own step-at-a-time path, on the CPU in f32 (the card's captured graphs
are held by ``chip_smoke.py``).

Greedy tokens and per-row counts are exact against the JAX block and
the JAX engine, with early stops (EOS, budget, an inactive row), the
int8 KV cache and a small MoE config.  Sampled rows cannot match JAX's
``jax.random`` streams; they are held token-exact to the port's own
step-at-a-time rows (the same generators, consumed the same way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.models import decode as jd
from k8s_dra_driver_tpu.models import serving as js
from k8s_dra_driver_tpu.models import transformer as jt
from k8s_dra_driver_tpu.utils import dispatch as jdispatch
from k8s_dra_driver_tpu_torch.models import decode as td
from k8s_dra_driver_tpu_torch.models import serving as ts
from k8s_dra_driver_tpu_torch.models import transformer as tt
from k8s_dra_driver_tpu_torch.models.convert import params_from_jax
from k8s_dra_driver_tpu_torch.utils import dispatch as tdispatch

FIELDS = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
              d_ff=64, max_seq=48, n_kv_heads=2)
JCFG = jt.TransformerConfig(dtype=jnp.float32, **FIELDS)
TCFG = tt.TransformerConfig(dtype=torch.float32, **FIELDS)
FILTERS = [(0, 0.0), (8, 0.9)]


def prompt(seed, n):
    return np.random.default_rng(seed).integers(
        0, FIELDS["vocab"], n).astype(np.int32)


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(np.asarray,
                      jt.init_params(JCFG, jax.random.PRNGKey(0)))
    return jp, params_from_jax(jp, device="cpu")


def configs(**extra):
    fields = dict(FIELDS, **extra)
    return (jt.TransformerConfig(dtype=jnp.float32, **fields),
            tt.TransformerConfig(dtype=torch.float32, **fields))


def rows_setup(jp, tp, jcfg, tcfg, b=3, t=6, seed=1):
    """Both packages prefill the same prompts: (JAX cache, port cache,
    last [B], pos [B]); the first tokens agree."""
    toks = np.random.default_rng(seed).integers(
        0, FIELDS["vocab"], (b, t)).astype(np.int32)
    jlog, jcache = jd.prefill(jp, jnp.asarray(toks), jcfg,
                              jd.init_cache(jcfg, b))
    tlog, tcache = td.prefill(tp, torch.as_tensor(toks, dtype=torch.long),
                              tcfg, td.init_cache(tcfg, b, device="cpu"))
    last = np.array(jnp.argmax(jlog[:, -1], axis=-1), np.int32)
    np.testing.assert_array_equal(tlog[:, -1].argmax(-1).numpy(), last)
    return jcache, tcache, last, np.full(b, t, np.int32)


def jax_block(jp, jcfg, jcache, last, pos, k, temps, budget, eos, top_k=0,
              top_p=0.0):
    b = last.shape[0]
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(b) + 7)
    packed, done, _, _ = jd.decode_fused_rows(
        jp, jnp.asarray(last), jcfg, jcache, jnp.asarray(pos), k, keys,
        jnp.asarray(temps, jnp.float32), jnp.asarray(budget, jnp.int32),
        jnp.asarray(eos, jnp.int32), top_k, top_p)
    return np.asarray(packed, np.int32), int(done)


def gens(b, seed=7):
    return [torch.Generator().manual_seed(seed + i) for i in range(b)]


def port_block(tp, tcfg, tcache, last, pos, k, temps, budget, eos,
               top_k=0, top_p=0.0, generators=None):
    generators = generators or gens(last.shape[0])
    packed, done, _ = td.decode_fused_rows(
        tp, torch.as_tensor(last), tcfg, tcache, torch.as_tensor(pos), k,
        generators, torch.as_tensor(np.asarray(temps, np.float32)),
        torch.as_tensor(budget), torch.as_tensor(eos), top_k, top_p)
    return packed.numpy(), int(done)


def step_reference(tp, tcfg, tcache, last, pos, k, temps, generators,
                   top_k=0, top_p=0.0):
    """k steps of the step engine's primitives: decode_step_rows and
    select_next_tokens (generators None for greedy rows)."""
    tok = torch.as_tensor(last, dtype=torch.long)
    pos = torch.as_tensor(pos, dtype=torch.long)
    per_row = [g if t > 0 else None for g, t in zip(generators, temps)]
    out = []
    for _ in range(k):
        logits, tcache = td.decode_step_rows(tp, tok[:, None], tcfg, tcache,
                                             pos)
        tok = td.select_next_tokens(logits, per_row, temps, top_k, top_p)
        out.append(tok.numpy())
        pos = pos + 1
    return np.stack(out, axis=1)


@pytest.mark.parametrize("filters", FILTERS)
def test_fused_rows_equal_jax_greedy(params, filters):
    """All-greedy rows: the packed tokens, counts and rows-finished
    count equal the JAX block's exactly."""
    jp, tp = params
    jcache, tcache, last, pos = rows_setup(jp, tp, JCFG, TCFG)
    k, b = 5, 3
    args = (last, pos, k, np.zeros(b), np.full(b, k), np.full(b, -1))
    want, jdone = jax_block(jp, JCFG, jcache, *args, *filters)
    got, done = port_block(tp, TCFG, tcache, *args, *filters)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, k], np.full(b, k))
    assert done == jdone == b


@pytest.mark.parametrize("filters", FILTERS)
def test_fused_sampled_rows_equal_step_at_a_time(params, filters):
    """Mixed greedy and sampled rows: every row equals k steps of the
    step engine's primitives with the same generators, each sampled
    generator is left where those steps leave it, and the greedy row
    equals the JAX block's."""
    jp, tp = params
    jcache, tcache, last, pos = rows_setup(jp, tp, JCFG, TCFG)
    k, b = 5, 3
    temps = np.asarray([0.0, 0.8, 1.2], np.float32)
    ref_gens = gens(b)
    want = step_reference(tp, TCFG, td.copy_cache(tcache, 0), last, pos, k,
                          temps, ref_gens, *filters)
    fused_gens = gens(b)
    got, done = port_block(tp, TCFG, tcache, last, pos, k, temps,
                           np.full(b, k), np.full(b, -1), *filters,
                           generators=fused_gens)
    np.testing.assert_array_equal(got[:, :k], want)
    assert done == b
    for row in (1, 2):
        assert torch.equal(fused_gens[row].get_state(),
                           ref_gens[row].get_state())
    jwant, _ = jax_block(jp, JCFG, jcache, last, pos, k, temps,
                         np.full(b, k), np.full(b, -1), *filters)
    np.testing.assert_array_equal(got[0], jwant[0])


def early_stop_case(jp, tp, jcfg, tcfg, seed=1):
    """Four rows over a 6-step block: row 0 stops on its EOS at step 3,
    row 1 on a budget of 2, row 2 runs the whole block, row 3 is
    inactive (budget 0).  Returns ((JAX packed, done), (port packed,
    done), k)."""
    k = 6
    jcache, tcache, last, pos = rows_setup(jp, tp, jcfg, tcfg, b=4,
                                           seed=seed)
    free, _ = jax_block(jp, jcfg, jax.tree.map(jnp.copy, jcache), last, pos,
                        k, np.zeros(4), np.full(4, k), np.full(4, -1))
    eos = np.asarray([free[0, 2], -1, -1, -1], np.int32)
    budget = np.asarray([k, 2, k + 5, 0], np.int32)
    args = (last, pos, k, np.zeros(4), budget, eos)
    return (jax_block(jp, jcfg, jcache, *args),
            port_block(tp, tcfg, tcache, *args), k)


def test_fused_rows_stop_early_like_jax(params):
    """EOS (kept, then frozen), a budget stop and an inactive row: the
    whole packed array and the rows-finished count equal JAX's."""
    jp, tp = params
    (want, jdone), (got, done), k = early_stop_case(jp, tp, JCFG, TCFG)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, k], [3, 2, k, 0])
    assert done == jdone == 3


def test_fused_rows_int8_kv_cache_equal_jax(params):
    jp, tp = params
    jcfg, tcfg = configs(kv_cache_dtype="int8")
    (want, jdone), (got, done), _ = early_stop_case(jp, tp, jcfg, tcfg)
    np.testing.assert_array_equal(got, want)
    assert done == jdone


def test_fused_rows_moe_equal_jax():
    """A small MoE config (served with dense dispatch)."""
    jcfg, tcfg = configs(n_experts=4, top_k=2, moe_dispatch="gmm")
    jp = jax.tree.map(np.asarray, jt.init_params(jcfg, jax.random.PRNGKey(1)))
    tp = params_from_jax(jp, device="cpu")
    (want, jdone), (got, done), _ = early_stop_case(jp, tp, jcfg, tcfg,
                                                    seed=3)
    np.testing.assert_array_equal(got, want)
    assert done == jdone


def test_sample_rows_equals_select_next_tokens():
    """The graph-safe sampler draws what the step engine's does, row by
    row, and leaves each sampled generator in the same state."""
    logits = torch.as_tensor(np.random.default_rng(5).normal(
        size=(4, 50)).astype(np.float32))
    temps = np.asarray([0.0, 0.7, 1.3, 0.0], np.float32)
    for top_k, top_p in FILTERS:
        a, b = gens(4, 11), gens(4, 11)
        want = td.select_next_tokens(
            logits, [g if t > 0 else None for g, t in zip(a, temps)], temps,
            top_k, top_p)
        got = td.sample_rows(logits, b, torch.as_tensor(temps), top_k, top_p)
        assert torch.equal(got, want)
        for row in (1, 2):
            assert torch.equal(a[row].get_state(), b[row].get_state())


@pytest.mark.parametrize("k,need,want", [
    (47, 47, 47), (47, 20, 32), (47, 33, 47), (47, 100, 47), (47, 1, 1),
    (47, 0, 1), (5, 3, 4), (5, 5, 5), (2, 1, 1), (2, 9, 2), (16, 9, 16),
])
def test_block_length(k, need, want):
    assert td.block_length(k, need) == want


def test_graph_runner_refuses_a_cpu_cache(params):
    _, tp = params
    with pytest.raises(ValueError, match="runs on the card"):
        td.FusedBlockGraph(tp, TCFG, td.init_cache(TCFG, 2, device="cpu"),
                           gens(2), 4)


# -- the engine (JAX tests/test_serving.py:543-758) -------------------------

MIXED = [("a", 60, 5, 8, 0.0), ("b", 61, 9, 4, 0.0), ("c", 62, 3, 9, 0.9),
         ("d", 63, 7, 6, 0.0), ("e", 64, 6, 5, 1.2)]


def greedy_ref(tp, pr, n, cfg=TCFG):
    return td.greedy_generate(
        tp, torch.as_tensor(pr[None], dtype=torch.long), cfg, n)[0].numpy()


def drain(eng, reqs, request_cls):
    for uid, pr, n, temp, eos in reqs:
        eng.submit(request_cls(uid=uid, prompt=pr, max_new=n,
                               temperature=temp, seed=17, eos_id=eos))
    return {f.uid: np.asarray(f.tokens) for f in eng.run()}


def mixed_reqs(tp, sampled: bool):
    """MIXED with "a" stopping early on an EOS; greedy-only unless
    ``sampled``."""
    pr_a = prompt(60, 5)
    eos = int(greedy_ref(tp, pr_a, 20)[5 + 3])
    return [(uid, prompt(seed, n), m, temp if sampled else 0.0,
             eos if uid == "a" else None)
            for uid, seed, n, m, temp in MIXED]


@pytest.mark.parametrize("chain", [2, 3, 5])
def test_fused_engine_equals_jax_engine(params, chain):
    """Greedy requests with an EOS stop and refills: the tokens and the
    dispatch labels (one ``decode_fused_rows`` and one ``fused_block``
    readback a block) equal the JAX engine's."""
    jp, tp = params
    reqs = mixed_reqs(tp, sampled=False)
    with jdispatch.track() as jt_:
        want = drain(js.ServingEngine(jp, JCFG, slots=2, chain_steps=chain),
                     reqs, js.Request)
    with tdispatch.track() as tt_:
        got = drain(ts.ServingEngine(tp, TCFG, slots=2, chain_steps=chain,
                                     device="cpu"), reqs, ts.Request)
    assert set(got) == set(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid], err_msg=uid)
    assert tt_.by_label == jt_.by_label
    assert tt_.by_label["decode_fused_rows"] > 0


@pytest.mark.parametrize("chain", [2, 3, 5])
def test_fused_engine_equals_step_engine(params, chain):
    """Mixed greedy and sampled requests, an EOS stop, top_k=8: every
    stream equals the port's chain_steps=1 engine's."""
    _, tp = params
    reqs = mixed_reqs(tp, sampled=True)

    def run(chain_steps):
        eng = ts.ServingEngine(tp, TCFG, slots=2, top_k=8,
                               chain_steps=chain_steps, device="cpu")
        return drain(eng, reqs, ts.Request), eng.stats()

    plain, _ = run(1)
    fused, stats = run(chain)
    assert set(fused) == set(plain)
    for uid in plain:
        np.testing.assert_array_equal(fused[uid], plain[uid], err_msg=uid)
    assert 0 < stats["decode_steps_total"] <= sum(m for *_, m, _t in MIXED)


def test_fused_engine_composes_with_prefix_cache(params):
    """A finished conversation is captured under chaining (only its
    first _pos rows are ever read), and the follow-up turn equals the
    unchained engine's."""
    _, tp = params
    turn1 = prompt(70, 6)

    def run(chain_steps):
        eng = ts.ServingEngine(tp, TCFG, slots=2, prefix_cache=4,
                               chain_steps=chain_steps, device="cpu")
        eng.submit(ts.Request(uid="t1", prompt=turn1, max_new=5))
        done = {f.uid: f.tokens for f in eng.run()}
        turn2 = np.concatenate([done["t1"], prompt(71, 3)]).astype(np.int32)
        eng.submit(ts.Request(uid="t2", prompt=turn2, max_new=4))
        done.update({f.uid: f.tokens for f in eng.run()})
        return done, eng.stats()

    plain, _ = run(1)
    chained, stats = run(3)
    for uid in plain:
        np.testing.assert_array_equal(chained[uid], plain[uid])
    assert stats["prefix_hits_total"] >= 1


def test_fused_fill_reuses_shared_prefix_within_round(params):
    """Same-round shared prefixes under chaining: later requests adopt
    the first one's fill, and the outputs are unchanged."""
    _, tp = params
    sys_pre = prompt(110, 9)
    reqs = [(u, np.concatenate([sys_pre, prompt(111 + i, 3 + i)]), 4)
            for i, u in enumerate("abcd")]

    def run(prefix_cache):
        eng = ts.ServingEngine(tp, TCFG, slots=4, chain_steps=3,
                               prefix_cache=prefix_cache, device="cpu")
        for uid, pr, n in reqs:
            eng.submit(ts.Request(uid=uid, prompt=pr, max_new=n))
        return {f.uid: f.tokens for f in eng.run()}, eng.stats()

    plain, _ = run(0)
    cached, stats = run(4)
    for uid, pr, n in reqs:
        np.testing.assert_array_equal(cached[uid], plain[uid], err_msg=uid)
        np.testing.assert_array_equal(plain[uid], greedy_ref(tp, pr, n))
    assert stats["prefix_hits_total"] >= 3


def test_fused_engine_needs_no_scratch_margin(params):
    """Rows stop on the device, so a request that fills the cache
    exactly is accepted and generates its whole budget."""
    _, tp = params
    eng = ts.ServingEngine(tp, TCFG, slots=1, chain_steps=4, device="cpu")
    pr = prompt(72, 30)
    n = FIELDS["max_seq"] - 30
    eng.submit(ts.Request(uid="c", prompt=pr, max_new=n))
    (done,) = eng.run()
    assert done.tokens.size == FIELDS["max_seq"]
    np.testing.assert_array_equal(done.tokens, greedy_ref(tp, pr, n))


def test_fused_staggered_submit_and_cancel(params):
    """Requests arrive mid-drain and an active one is cancelled between
    blocks: no token is lost or duplicated, and every survivor equals
    its greedy reference."""
    _, tp = params
    eng = ts.ServingEngine(tp, TCFG, slots=2, chain_steps=4, device="cpu")
    specs = {i: (prompt(200 + i, 3 + (i % 4)), 3 + (i * 2) % 7)
             for i in range(6)}
    for i in range(3):
        eng.submit(ts.Request(uid=i, prompt=specs[i][0], max_new=specs[i][1]))
    done: dict = {}
    next_uid, steps, cancelled = 3, 0, None
    while eng.active or eng.pending or next_uid < 6:
        for f in eng.step():
            assert f.uid not in done, "duplicate finish"
            done[f.uid] = f.tokens
        steps += 1
        if cancelled is None and steps == 1:
            live = [r.uid for r in eng._req if r is not None]
            if live:
                cancelled = live[0]
                assert eng.cancel(cancelled)
        if next_uid < 6:
            eng.submit(ts.Request(uid=next_uid, prompt=specs[next_uid][0],
                                  max_new=specs[next_uid][1]))
            next_uid += 1
        assert steps < 200
    assert cancelled is not None and cancelled not in done
    assert set(done) == {u for u in specs if u != cancelled}
    for uid in done:
        pr, n = specs[uid]
        np.testing.assert_array_equal(done[uid], greedy_ref(tp, pr, n),
                                      err_msg=f"request {uid}")


@pytest.mark.parametrize("kw,match", [
    (dict(chain_steps=0), "chain_steps must be >= 1"),
    (dict(chain_steps=2, kv_layout="paged"),
     "paged KV does not compose with fused generation blocks"),
], ids=["chain_zero", "paged"])
def test_fused_engine_validation(params, kw, match):
    """The JAX engine's gates, with its messages."""
    jp, tp = params
    with pytest.raises(ValueError, match=match):
        js.ServingEngine(jp, JCFG, slots=1, **kw)
    with pytest.raises(ValueError, match=match):
        ts.ServingEngine(tp, TCFG, slots=1, device="cpu", **kw)


def test_fused_engine_dispatch_amortization_8x(params):
    """The fused engine pays at least 8x fewer host dispatches plus
    readbacks per generated token than the step engine on the same
    drain (the JAX package's gate)."""
    _, tp = params
    prompts = [prompt(40 + i, 5) for i in range(2)]

    def per_token(chain_steps):
        eng = ts.ServingEngine(tp, TCFG, slots=2, chain_steps=chain_steps,
                               device="cpu")
        for i, pr in enumerate(prompts):
            eng.submit(ts.Request(uid=i, prompt=pr, max_new=25))
        with tdispatch.track() as t:
            done = eng.run()
        generated = sum(len(f.tokens) - 5 for f in done)
        assert generated == 2 * 25
        return (t.dispatches + t.readbacks) / generated

    per_step, fused = per_token(1), per_token(24)
    assert per_step >= 8 * fused, (per_step, fused)


def test_fused_int8_weights_engine_equals_jax_engine(params):
    """``quantize_params`` weights (the port's decode products take K7's
    route, its plain version on the CPU) under chaining: the tokens
    equal the JAX engine's."""
    from k8s_dra_driver_tpu.models.quant import quantize_params
    jp, _ = params
    jq = quantize_params(jax.tree.map(jnp.asarray, jp), JCFG)
    tq = params_from_jax(jax.tree.map(np.asarray, jq), device="cpu")
    reqs = [(uid, prompt(seed, n), m, 0.0, None)
            for uid, seed, n, m, _ in MIXED]
    want = drain(js.ServingEngine(jq, JCFG, slots=2, chain_steps=3), reqs,
                 js.Request)
    got = drain(ts.ServingEngine(tq, TCFG, slots=2, chain_steps=3,
                                 device="cpu"), reqs, ts.Request)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid], err_msg=uid)


def test_fused_stream_yields_every_token_then_finished(params):
    _, tp = params
    eng = ts.ServingEngine(tp, TCFG, slots=2, chain_steps=3, device="cpu")
    reqs = {i: (prompt(90 + i, 4 + i), 5 + i) for i in range(3)}
    for i, (pr, n) in reqs.items():
        eng.submit(ts.Request(uid=i, prompt=pr, max_new=n))
    tokens: dict = {}
    finished: dict = {}
    for kind, uid, payload in eng.stream():
        if kind == "token":
            assert uid not in finished
            tokens.setdefault(uid, []).append(payload)
        else:
            finished[uid] = payload
    for i, (pr, n) in reqs.items():
        np.testing.assert_array_equal(finished[i], greedy_ref(tp, pr, n))
        np.testing.assert_array_equal(tokens[i], finished[i][len(pr):])
