"""Port speculative decoding (``k8s_dra_driver_tpu_torch``'s
``models/decode.py`` speculative functions, ``models/speculative.py``
and the engine's ``draft_params`` / ``draft_source``) against the JAX
package's, on the CPU in f32 at the shapes of tests/test_speculative.py.

Greedy paths are exact: proposals, accepts, emitted tokens, iteration
counts, engine streams and the speculative counters equal JAX's, and
greedy speculative streams equal the port's non-speculative ones.
Logits agree to 1e-5.  Sampled rows cannot match JAX's ``jax.random``
streams; they are held to the closed-form target distribution by total
variation (the bounds of tests/test_speculative.py) and token-exact
between the port's step and fused paths.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.models import decode as jd
from k8s_dra_driver_tpu.models import quantize_params as j_quantize
from k8s_dra_driver_tpu.models import serving as js
from k8s_dra_driver_tpu.models import speculative as jspec
from k8s_dra_driver_tpu.models import transformer as jt
from k8s_dra_driver_tpu.utils import dispatch as jdispatch
from k8s_dra_driver_tpu_torch.models import decode as td
from k8s_dra_driver_tpu_torch.models import serving as ts
from k8s_dra_driver_tpu_torch.models import speculative as tspec
from k8s_dra_driver_tpu_torch.models import specprobe as tspec_probe
from k8s_dra_driver_tpu_torch.models import transformer as tt
from k8s_dra_driver_tpu_torch.models.convert import params_from_jax
from k8s_dra_driver_tpu_torch.utils import dispatch as tdispatch

FIELDS = dict(vocab=96, d_model=48, n_layers=2, n_heads=4, d_head=12,
              d_ff=96, max_seq=64)
DRAFT_FIELDS = dict(vocab=96, d_model=24, n_layers=1, n_heads=2, d_head=12,
                    d_ff=48, max_seq=64)
#: f32 agreement with JAX, relative to the compared values' scale:
#: |port - jax| <= 1e-5 x max(1, max|jax|) (logits reach about 3 here)
LOGIT_TOL = 1e-5
FILTERS = [(0, 0.0), (8, 0.9)]


def configs(fields=FIELDS, **extra):
    f = dict(fields, **extra)
    return (jt.TransformerConfig(dtype=jnp.float32, **f),
            tt.TransformerConfig(dtype=torch.float32, **f))


JCFG, TCFG = configs()
JDRAFT, TDRAFT = configs(DRAFT_FIELDS)


def model(jcfg, seed):
    jp = jax.tree.map(np.asarray, jt.init_params(jcfg, jax.random.PRNGKey(
        seed)))
    return jp, params_from_jax(jp, device="cpu")


@pytest.fixture(scope="module")
def target():
    return model(JCFG, 0)


@pytest.fixture(scope="module")
def draft():
    return model(JDRAFT, 1)


def tokens(seed, shape, vocab=FIELDS["vocab"]):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def long(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def prefilled(jp, tp, jcfg, tcfg, toks):
    """Both packages prefill ``toks`` [B, T] into a fresh cache."""
    b = toks.shape[0]
    _, jcache = jd.prefill(jp, jnp.asarray(toks), jcfg,
                           jd.init_cache(jcfg, b))
    _, tcache = td.prefill(tp, long(toks), tcfg,
                           td.init_cache(tcfg, b, device="cpu"))
    return jcache, tcache


def assert_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=0,
        atol=LOGIT_TOL * max(1.0, float(np.abs(want).max())))


def assert_cache_rows(jcache, tcache, rows, pos, t):
    """The K/V rows ``pos[b]..pos[b]+t`` of each row agree."""
    for jk, tk in zip(jcache.k + jcache.v, tcache.k + tcache.v):
        jk = np.asarray(jk)
        for b in rows:
            assert_close(tk[b, pos[b]:pos[b] + t].numpy(),
                         jk[b, pos[b]:pos[b] + t])


# -- the n-gram source --------------------------------------------------

NGRAM_CASES = {
    # 7 at 1 and 4; the last qualifying match (4) wins
    "recency": ([[3, 7, 5, 6, 7, 8, 9, 0]], [7], [7], 2),
    # 7 only at 6: 6 + 2 < 7 fails, no match
    "lookahead_edge": ([[1, 2, 3, 4, 5, 6, 7, 0]], [7], [7], 2),
    # 6 at 5: 5 + 2 < 8 holds exactly at the edge
    "edge_kept": ([[1, 2, 3, 4, 5, 6, 7, 8]], [8], [6], 2),
    "no_match": ([[1, 2, 3, 4, 5, 6, 7, 0]], [7], [9], 2),
    # zero padding past ctx_len never matches a 0
    "padding_inert": ([[0] * 8], [0], [0], 3),
    "padding_after_prompt": ([[4, 0, 5, 0, 0, 0]], [3], [0], 1),
}


@pytest.mark.parametrize("case", sorted(NGRAM_CASES))
def test_ngram_propose_rows_equal_jax(case):
    ctx, ctx_len, last, k = NGRAM_CASES[case]
    want = np.asarray(jd.ngram_propose_rows(
        jnp.asarray(ctx, jnp.int32), jnp.asarray(ctx_len, jnp.int32),
        jnp.asarray(last, jnp.int32), k))
    got = td.ngram_propose_rows(torch.as_tensor(ctx, dtype=torch.int32),
                                torch.as_tensor(ctx_len, dtype=torch.int32),
                                long(last), k)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("want_q", [False, True])
def test_draft_ngram_rows_equal_jax(want_q):
    """Random contexts of repeated short motifs (many matches), ragged
    lengths: proposals and the one-hot q exactly."""
    rng = np.random.default_rng(3)
    ctx = rng.integers(0, 6, (16, 20)).astype(np.int32)
    ctx_len = rng.integers(0, 21, 16).astype(np.int32)
    for b, n in enumerate(ctx_len):
        ctx[b, n:] = 0
    last = rng.integers(0, 6, 16).astype(np.int32)
    jprop, jq = jd.draft_ngram_rows(jnp.asarray(ctx), jnp.asarray(ctx_len),
                                    jnp.asarray(last), 4, 8, want_q)
    with tdispatch.track() as t:
        prop, q = td.draft_ngram_rows(torch.as_tensor(ctx),
                                      torch.as_tensor(ctx_len), long(last),
                                      4, 8, want_q)
    assert t.by_label == {"draft_ngram_rows": 1}
    np.testing.assert_array_equal(prop.numpy(), np.asarray(jprop))
    if want_q:
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    else:
        assert q is None and jq is None


# -- the window forwards -------------------------------------------------

def test_decode_window_rows_equal_jax(target):
    """Two windows at per-row positions (the second as if the rows had
    accepted 0, 1 and 2 drafts): logits to 1e-5 and the written rows."""
    jp, tp = target
    toks = tokens(1, (3, 6))
    jcache, tcache = prefilled(jp, tp, JCFG, TCFG, toks)
    for pos, seed in (([6, 6, 6], 2), ([7, 8, 9], 3)):
        win = tokens(seed, (3, 5))
        jlog, jcache = jd.decode_window_rows(jp, jnp.asarray(win), JCFG,
                                             jcache, jnp.asarray(pos,
                                                                 jnp.int32))
        tlog, tcache = td.decode_window_rows(tp, long(win), TCFG, tcache,
                                             long(pos))
        assert_close(tlog.numpy(), jlog)
        assert_cache_rows(jcache, tcache, range(3), pos, 5)


def paged_from_dense(dense_layers, tables, n_blocks, bs):
    """A pool holding each row's dense rows at its table's blocks."""
    pool = np.zeros((n_blocks, bs) + dense_layers.shape[2:], np.float32)
    for b, row in enumerate(tables):
        for i, blk in enumerate(row):
            pool[blk] = dense_layers[b, i * bs:(i + 1) * bs]
    return pool


def test_paged_window_rows_equal_jax_and_contiguous(target):
    """The paged window over a shuffled block layout: logits equal the
    contiguous window's bitwise in the port and JAX's paged window's to
    1e-5, and the written rows land in the right blocks."""
    jp, tp = target
    bs, b = 8, 3
    tw = FIELDS["max_seq"] // bs
    toks = tokens(4, (b, 6))
    jcache, tcache = prefilled(jp, tp, JCFG, TCFG, toks)
    ids = 1 + np.random.default_rng(5).permutation(b * tw)
    tables = ids.reshape(b, tw).astype(np.int32)
    n_blocks = b * tw + 1
    pools = [paged_from_dense(a.numpy(), tables, n_blocks, bs)
             for a in tcache.k + tcache.v]
    n = TCFG.n_layers
    tpool = td.KVCache(k=[torch.as_tensor(p) for p in pools[:n]],
                       v=[torch.as_tensor(p) for p in pools[n:]])
    jpool = jd.KVCache(k=[jnp.asarray(p) for p in pools[:n]],
                       v=[jnp.asarray(p) for p in pools[n:]],
                       pos=jnp.int32(0))
    pos, win = [6, 7, 9], tokens(6, (b, 5))
    dlog, tcache = td.decode_window_rows(tp, long(win), TCFG, tcache,
                                         long(pos))
    with tdispatch.track() as t:
        plog, tpool = td.paged_window_rows(tp, long(win), TCFG, tpool,
                                           torch.as_tensor(tables),
                                           long(pos))
    assert t.by_label == {"paged_window_rows": 1}
    assert torch.equal(plog, dlog)
    jlog, jpool = jd.paged_window_rows(jp, jnp.asarray(win), JCFG, jpool,
                                       jnp.asarray(tables),
                                       jnp.asarray(pos, jnp.int32))
    assert_close(plog.numpy(), jlog)
    for pa, dense in zip(tpool.k + tpool.v, tcache.k + tcache.v):
        got = td._paged_dense(pa, torch.as_tensor(tables))
        for r in range(b):
            assert torch.equal(got[r, pos[r]:pos[r] + 5],
                               dense[r, pos[r]:pos[r] + 5])


# -- the draft model -----------------------------------------------------

def draft_setup(draft, seed=7):
    jdp, tdp = draft
    toks = tokens(seed, (4, 7))
    jcache, tcache = prefilled(jdp, tdp, JDRAFT, TDRAFT, toks)
    last = tokens(seed + 1, 4)
    pos = np.array([7, 7, 7, 7], np.int32)
    return jdp, tdp, jcache, tcache, last, pos


def test_draft_propose_rows_equal_jax(draft):
    """k + 1 greedy steps: the proposals exactly, the k + 1 written
    rows to 1e-5."""
    jdp, tdp, jcache, tcache, last, pos = draft_setup(draft)
    k = 4
    jprop, jcache = jd.draft_propose_rows(jdp, jnp.asarray(last), JDRAFT,
                                          jcache, jnp.asarray(pos), k)
    prop, tcache = td.draft_propose_rows(tdp, long(last), TDRAFT, tcache,
                                         long(pos), k)
    np.testing.assert_array_equal(prop.numpy(), np.asarray(jprop))
    assert_cache_rows(jcache, tcache, range(4), pos, k + 1)


def test_draft_sample_rows_greedy_equals_propose(draft):
    """At temperature 0 the sampled draft is the greedy draft, whatever
    the generators hold."""
    _, tdp, _, tcache, last, pos = draft_setup(draft)
    want, _ = td.draft_propose_rows(tdp, long(last), TDRAFT,
                                    td.copy_cache(tcache, 0), long(pos), 3)
    gens = [torch.Generator().manual_seed(i) for i in range(4)]
    got, q, _ = td.draft_sample_rows(tdp, long(last), TDRAFT, tcache,
                                     long(pos), 3, gens, torch.zeros(4))
    assert torch.equal(got, want)
    assert q.shape == (4, 3, TDRAFT.vocab)


@pytest.mark.parametrize("filters", FILTERS)
def test_draft_sample_rows_q_equal_jax(draft, filters):
    """q_probs of mixed greedy and sampled rows against JAX's filtered
    softmax of the draft fed the same proposals teacher-forced (one JAX
    window over [last, proposals[:-1]]), to 1e-5."""
    top_k, top_p = filters
    jdp, tdp, jcache, tcache, last, pos = draft_setup(draft)
    k = 4
    temps = np.asarray([0.0, 0.7, 1.0, 1.3], np.float32)
    gens = [torch.Generator().manual_seed(50 + i) for i in range(4)]
    prop, q, _ = td.draft_sample_rows(tdp, long(last), TDRAFT, tcache,
                                      long(pos), k, gens,
                                      torch.as_tensor(temps), top_k, top_p)
    window = np.concatenate([last[:, None], prop.numpy()[:, :k - 1]], 1)
    jlog, _ = jd.decode_window_rows(jdp, jnp.asarray(window, jnp.int32),
                                    JDRAFT, jcache, jnp.asarray(pos))
    want = jax.nn.softmax(jd._filter_logits(
        jlog, jnp.asarray(temps)[:, None], top_k, top_p), axis=-1)
    assert_close(q.numpy(), want)
    # each proposal lies in its own distribution's support
    assert bool((q.gather(-1, prop[..., None]) > 0).all())


# -- the accept ----------------------------------------------------------

def test_spec_accept_rows_greedy_equal_jax():
    """Greedy rows: emit and accepts equal JAX's exactly, on proposals
    that match the argmax for a random prefix of each row."""
    rows, k, v = 64, 4, 12
    rng = np.random.default_rng(8)
    logits = rng.normal(size=(rows, k + 1, v)).astype(np.float32)
    props = logits[:, :k].argmax(-1).astype(np.int32)
    cut = rng.integers(0, k + 1, rows)
    for r in range(rows):
        props[r, cut[r]:] = (props[r, cut[r]:] + 1 + rng.integers(
            0, v - 1, k - cut[r])) % v
    q = np.full((rows, k, v), 1.0 / v, np.float32)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(rows))
    jemit, ja, _ = jd.spec_accept_rows(
        jnp.asarray(logits), jnp.asarray(props), jnp.asarray(q), keys,
        jnp.zeros(rows, jnp.float32))
    gens = [torch.Generator().manual_seed(r) for r in range(rows)]
    emit, a = td.spec_accept_rows(torch.as_tensor(logits), long(props),
                                  torch.as_tensor(q), gens,
                                  torch.zeros(rows))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(a.numpy(), cut)
    for r in range(rows):
        np.testing.assert_array_equal(emit[r, :cut[r] + 1].numpy(),
                                      np.asarray(jemit)[r, :cut[r] + 1])


class TestRejectionSampling:
    """The Leviathan/Chen guarantee of the port's ``spec_accept_rows``:
    emitted tokens follow the filtered target distribution, pinned on a
    small vocab over many rows with fixed per-position logits (the
    fixtures of tests/test_speculative.py, drawn with numpy)."""

    V, K, ROWS = 8, 2, 16384

    def _fixtures(self, temp=0.9, top_k=0, top_p=0.0, draft_logits=None):
        rng = np.random.default_rng(3)
        tl = rng.normal(size=(self.K + 1, self.V)).astype(np.float32)
        dl = (rng.normal(size=(self.K, self.V)).astype(np.float32)
              if draft_logits is None else draft_logits(tl))
        p = torch.softmax(td._filter_logits(torch.as_tensor(tl), temp, top_k,
                                            top_p), -1)
        q = torch.softmax(td._filter_logits(torch.as_tensor(dl), temp, top_k,
                                            top_p), -1)
        # the closed form agrees with the JAX package's filter
        for logits, probs in ((tl, p), (dl, q)):
            want = jax.nn.softmax(jd._filter_logits(
                jnp.asarray(logits), temp, top_k, top_p), -1)
            np.testing.assert_allclose(probs.numpy(), np.asarray(want),
                                       atol=1e-6, rtol=0)
        # each row draws its window from q: inverse CDF per position
        u = np.random.default_rng(4).random((self.ROWS, self.K))
        cdf = np.cumsum(q.double().numpy(), axis=-1)
        props = np.stack([np.minimum(np.searchsorted(cdf[i], u[:, i],
                                                     side="right"),
                                     self.V - 1) for i in range(self.K)], 1)
        return tl, p.numpy(), q, props

    def _accept(self, tl, q, props, temp=0.9, top_k=0, top_p=0.0):
        logits = torch.as_tensor(tl)[None].expand(self.ROWS, -1, -1)
        q_probs = q[None].expand(self.ROWS, -1, -1)
        gens = [torch.Generator().manual_seed(r) for r in range(self.ROWS)]
        return td.spec_accept_rows(logits, long(props), q_probs, gens,
                                   torch.full((self.ROWS,), temp),
                                   top_k, top_p)

    @staticmethod
    def _tv(toks, want, v):
        emp = np.bincount(np.asarray(toks), minlength=v) / len(toks)
        return 0.5 * np.abs(emp - np.asarray(want)).sum()

    @pytest.mark.parametrize("filters", [(0, 0.0), (4, 0.0), (0, 0.8)])
    def test_first_emitted_token_follows_target(self, filters):
        top_k, top_p = filters
        tl, p, q, props = self._fixtures(top_k=top_k, top_p=top_p)
        emit, _ = self._accept(tl, q, props, top_k=top_k, top_p=top_p)
        assert self._tv(emit[:, 0].numpy(), p[0], self.V) < 0.03

    def test_bonus_token_follows_target_tail(self):
        """Full-accept rows draw their bonus from p_K.  Their share is
        the closed form prod_i sum_x min(p_i(x), q_i(x)) (each position
        accepts with probability 1 - TV(p_i, q_i), independently here),
        and there are enough of them to test the bonus on."""
        tl, p, q, props = self._fixtures()
        emit, a = self._accept(tl, q, props)
        full = a.numpy() == self.K
        share = np.prod(np.minimum(p[:self.K], q.numpy()).sum(-1))
        assert abs(full.mean() - share) < 0.01, (full.mean(), share)
        assert full.sum() > 1000
        assert self._tv(emit.numpy()[full, self.K], p[self.K], self.V) < 0.05

    def test_perfect_draft_accepts_everything(self):
        """q == p at every drafted position (the draft's logits are the
        target's first K rows): every row accepts fully."""
        tl, _, q, props = self._fixtures(
            draft_logits=lambda tl: tl[:self.K].copy())
        _, a = self._accept(tl, q, props)
        assert int(a.min()) == self.K


# -- the standalone loops -------------------------------------------------

def generate_pair(jp, tp, jcfg, tcfg, prompt, n, draft_len, jdraft=None,
                  tdraft=None, jdcfg=None, tdcfg=None):
    """(JAX (tokens, iterations), port (tokens, iterations)) of one
    speculative generation; the n-gram loop when no draft is given."""
    if jdraft is None:
        jout = jspec.ngram_speculative_generate(
            jp, jnp.asarray(prompt), jcfg, n, draft_len=draft_len)
        tout = tspec.ngram_speculative_generate(tp, long(prompt), tcfg, n,
                                                draft_len=draft_len)
    else:
        jout = jspec.speculative_generate(jp, jdraft, jnp.asarray(prompt),
                                          jcfg, jdcfg, n,
                                          draft_len=draft_len)
        tout = tspec.speculative_generate(tp, tdraft, long(prompt), tcfg,
                                          tdcfg, n, draft_len=draft_len)
    return ((np.asarray(jout[0]), int(jout[1])),
            (tout[0].numpy(), tout[1]))


def assert_generate_equal(jp, tp, jcfg, tcfg, prompt, n, draft_len, **kw):
    (jtok, jit), (ttok, tit) = generate_pair(jp, tp, jcfg, tcfg, prompt, n,
                                             draft_len, **kw)
    np.testing.assert_array_equal(ttok, jtok)
    assert tit == jit
    want = td.greedy_generate(tp, long(prompt), tcfg, n).numpy()
    np.testing.assert_array_equal(ttok, want)
    return tit


@pytest.mark.parametrize("draft_len", [1, 3, 4])
def test_speculative_generate_equal_jax(target, draft, draft_len):
    jp, tp = target
    jdp, tdp = draft
    assert_generate_equal(jp, tp, JCFG, TCFG, tokens(9, (2, 8)), 16,
                          draft_len, jdraft=jdp, tdraft=tdp, jdcfg=JDRAFT,
                          tdcfg=TDRAFT)


@pytest.mark.parametrize("variant", [dict(n_kv_heads=2),
                                     dict(n_experts=4, top_k=2),
                                     dict(kv_cache_dtype="int8"),
                                     "quantized"],
                         ids=["gqa", "moe", "kv8", "quantized"])
def test_speculative_generate_variants_equal_jax(draft, variant):
    if variant == "quantized":
        jcfg, tcfg = JCFG, TCFG
        jp = j_quantize(jax.tree.map(jnp.asarray, model(JCFG, 0)[0]), jcfg)
        jp = jax.tree.map(np.asarray, jp)
        tp = params_from_jax(jp, device="cpu")
    else:
        jcfg, tcfg = configs(**variant)
        jp, tp = model(jcfg, 0)
    jdp, tdp = draft
    assert_generate_equal(jp, tp, jcfg, tcfg, tokens(10, (2, 8)), 12, 3,
                          jdraft=jdp, tdraft=tdp, jdcfg=JDRAFT, tdcfg=TDRAFT)


def test_perfect_draft_and_lockstep_equal_jax(target):
    """Draft == target (every proposal accepted: at most ceil(n /
    (draft_len + 1)) + 1 iterations), over 4 rows in lockstep."""
    jp, tp = target
    iters = assert_generate_equal(jp, tp, JCFG, TCFG, tokens(11, (4, 8)),
                                  20, 4, jdraft=jp, tdraft=tp, jdcfg=JCFG,
                                  tdcfg=TCFG)
    assert iters <= -(-20 // 5) + 1


@pytest.mark.parametrize("prompt", ["repetitive", "random"])
def test_ngram_speculative_generate_equal_jax(target, prompt):
    jp, tp = target
    pr = (np.tile(np.asarray([[5, 9, 2]], np.int32), (1, 4))
          if prompt == "repetitive" else tokens(12, (2, 10)))
    iters = assert_generate_equal(jp, tp, JCFG, TCFG, pr, 14, 3)
    assert 1 <= iters <= 14


def test_generate_validation_equals_jax(target, draft):
    jp, tp = target
    jdp, tdp = draft
    bad = dataclasses.replace(TDRAFT, vocab=128)
    cases = [
        (dict(n_tokens=60, draft_len=4), "exceeds"),
        (dict(n_tokens=0, draft_len=4), "n_tokens"),
        (dict(n_tokens=4, draft_len=0), "draft_len"),
    ]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            jspec.speculative_generate(jp, jdp, jnp.asarray(tokens(1, (2, 8))),
                                       JCFG, JDRAFT, **kw)
        with pytest.raises(ValueError, match=match):
            tspec.speculative_generate(tp, tdp, long(tokens(1, (2, 8))),
                                       TCFG, TDRAFT, **kw)
        with pytest.raises(ValueError, match=match):
            tspec.ngram_speculative_generate(tp, long(tokens(1, (2, 8))),
                                             TCFG, **kw)
    with pytest.raises(ValueError, match="vocab"):
        tspec.speculative_generate(tp, tdp, long(tokens(1, (2, 8))), TCFG,
                                   bad, 4)


# -- the engine -----------------------------------------------------------

# six requests over three slots: repetitive prompts (the lookup lands)
# and random ones; one stops at an EOS it emits, and the last extends
# the first's prompt (a prefix-cache hit when the cache is on)
ENGINE_REQS = [("rep", np.tile(np.asarray([5, 9, 2], np.int32), 4), 9),
               ("rnd", tokens(20, 10), 7),
               ("rep2", np.tile(np.asarray([7, 1, 3, 8], np.int32), 3), 12),
               ("rnd2", tokens(21, 6), 5),
               ("rep3", np.tile(np.asarray([4, 4, 6], np.int32), 4), 10),
               ("rep4", np.tile(np.asarray([5, 9, 2], np.int32), 5), 6)]
EOS = {"rep2": 61}


def drain(mod, params, cfg, track, reqs=ENGINE_REQS, sampled=(), **kw):
    eng = mod.ServingEngine(params, cfg, slots=3, **kw)
    with track() as t:
        for i, (uid, pr, n) in enumerate(reqs):
            eng.submit(mod.Request(uid=uid, prompt=pr, max_new=n,
                                   eos_id=EOS.get(uid),
                                   temperature=0.9 if uid in sampled else 0,
                                   seed=100 + i))
        out = {f.uid: np.asarray(f.tokens) for f in eng.run()}
    return out, eng.stats(), t.by_label


SPEC_COUNTERS = ("speculative_windows_total", "speculative_drafts_total",
                 "speculative_accepted_total", "kv_spec_trims_total",
                 "decode_steps_total")
SPEC_LABELS = ("decode_window_rows", "paged_window_rows",
               "decode_spec_fused_rows", "draft_ngram_rows",
               "draft_propose_rows", "draft_prefill", "readback:spec_window",
               "readback:fused_spec_block")


@pytest.fixture(scope="module")
def plain_streams(target):
    _, tp = target
    return drain(ts, tp, TCFG, tdispatch.track, device="cpu")[0]


@pytest.mark.parametrize("source,layout,chain", [
    ("ngram", "contiguous", 1), ("ngram", "contiguous", 4),
    ("ngram", "paged", 1), ("model", "contiguous", 1),
    ("model", "contiguous", 4), ("self", "contiguous", 4),
    ("ngram", "prefix_cache", 1), ("model", "prefix_cache", 1),
    ("model", "prefill_chunk", 1)])
def test_engine_equals_jax_engine(target, draft, plain_streams, source,
                                  layout, chain):
    """Greedy drains: streams byte-equal to the JAX engine's and to the
    port's non-speculative engine's; the speculative counters and the
    window / draft dispatch counts equal the JAX engine's.  Besides the
    layouts: a prefix cache (fills through the fused round's hits) and
    chunked prefill (the draft fills in the same chunks)."""
    jp, tp = target
    kw = dict(draft_len=3, chain_steps=chain)
    if layout == "paged":
        kw.update(kv_layout="paged", kv_block_size=8)
    elif layout == "prefix_cache":
        kw.update(prefix_cache=4)
    elif layout == "prefill_chunk":
        kw.update(prefill_chunk=4)
    jkw, tkw = dict(kw), dict(kw)
    if source == "ngram":
        jkw["draft_source"] = tkw["draft_source"] = "ngram"
    elif source == "model":
        jkw.update(draft_params=draft[0], draft_cfg=JDRAFT)
        tkw.update(draft_params=draft[1], draft_cfg=TDRAFT)
    else:
        jkw.update(draft_params=jp, draft_cfg=JCFG, draft_len=4)
        tkw.update(draft_params=tp, draft_cfg=TCFG, draft_len=4)
    jout, jstats, jlabels = drain(js, jp, JCFG, jdispatch.track, **jkw)
    out, stats, labels = drain(ts, tp, TCFG, tdispatch.track, device="cpu",
                               **tkw)
    assert set(out) == set(jout) == set(plain_streams)
    for uid in out:
        np.testing.assert_array_equal(out[uid], jout[uid], err_msg=uid)
        np.testing.assert_array_equal(out[uid], plain_streams[uid],
                                      err_msg=uid)
    for key in SPEC_COUNTERS:
        assert stats.get(key) == jstats.get(key), key
    for label in SPEC_LABELS:
        assert labels.get(label) == jlabels.get(label), label
    assert stats["speculative_windows_total"] > 0
    if layout == "paged":
        assert stats["kv_spec_trims_total"] > 0
    if layout == "prefix_cache":
        assert stats["prefix_hits_total"] == jstats["prefix_hits_total"] > 0
    if source == "self":
        assert stats["spec_accept_rate"] > 0.5


@pytest.mark.parametrize("source", ["ngram", "model"])
def test_fused_equals_step_on_sampled_rows(target, draft, source):
    """Mixed greedy and sampled rows: the fused speculative engine's
    streams equal the step engine's token for token (the same window
    body, drafts and generators, consumed the same way a window)."""
    _, tp = target
    kw = (dict(draft_source="ngram") if source == "ngram"
          else dict(draft_params=draft[1], draft_cfg=TDRAFT))
    sampled = ("rep", "rnd2", "rep3")
    step = drain(ts, tp, TCFG, tdispatch.track, sampled=sampled,
                 device="cpu", draft_len=3, top_k=20, **kw)[0]
    fused = drain(ts, tp, TCFG, tdispatch.track, sampled=sampled,
                  device="cpu", draft_len=3, top_k=20, chain_steps=3,
                  **kw)[0]
    for uid in step:
        np.testing.assert_array_equal(fused[uid], step[uid], err_msg=uid)


TINY = dict(vocab=8, d_model=16, n_layers=1, n_heads=2, d_head=8, d_ff=32,
            max_seq=16)


@pytest.mark.parametrize("chain", [1, 2])
def test_sampled_engine_follows_target(chain):
    """Distribution parity through the engine (after
    tests/test_speculative.py:337-368): 1024 two-token sampled requests
    on a repeated-bigram prompt (the lookup proposes real drafts).  The
    first token (the fill's draw) follows p(. | prompt); the second, the
    first window's accept, follows the marginal sum_t p(t) p(. | prompt,
    t), both within TV 0.06."""
    jcfg, tcfg = configs(TINY)
    _, tp = model(jcfg, 2)
    pr = np.asarray([3, 5, 3, 5, 3, 5, 3], np.int32)
    with torch.no_grad():
        full = tt.forward(tp, long(np.concatenate(
            [np.tile(pr, (8, 1)), np.arange(8)[:, None]], 1)), tcfg)
    probs = torch.softmax(full.double(), -1).numpy()
    p0 = probs[0, pr.size - 1]
    p1 = p0 @ probs[:, pr.size]
    n = 1024
    eng = ts.ServingEngine(tp, tcfg, slots=8, draft_source="ngram",
                           draft_len=2, chain_steps=chain, device="cpu")
    for i in range(n):
        eng.submit(ts.Request(uid=i, prompt=pr, max_new=2, temperature=1.0,
                              seed=i))
    done = eng.run()
    assert eng.stats()["speculative_windows_total"] > 0
    toks = np.array([f.tokens[pr.size:] for f in done])
    for j, want in enumerate((p0, p1)):
        emp = np.bincount(toks[:, j], minlength=8) / n
        tv = 0.5 * np.abs(emp - want).sum()
        assert tv < 0.06, (j, tv, emp.round(3), want.round(3))


@pytest.mark.parametrize("kw,chain,margin", [
    (dict(draft_source="ngram"), 1, 4), (dict(draft_source="ngram"), 3, 5),
    (dict(draft_source="ngram", kv_layout="paged", kv_block_size=8), 1, 4),
    ("model", 1, 4), ("model", 3, 5)])
def test_capacity_margin_equals_jax(target, draft, kw, chain, margin):
    """The intake reserves draft_len rows (draft_len + 1 fused): the
    same requests pass and fail as in the JAX engine, with its
    message."""
    jp, tp = target
    if kw == "model":
        jkw = dict(draft_params=draft[0], draft_cfg=JDRAFT)
        tkw = dict(draft_params=draft[1], draft_cfg=TDRAFT)
    else:
        jkw = tkw = kw
    jeng = js.ServingEngine(jp, JCFG, slots=2, draft_len=4,
                            chain_steps=chain, **jkw)
    teng = ts.ServingEngine(tp, TCFG, slots=2, draft_len=4,
                            chain_steps=chain, device="cpu", **tkw)
    limit = FIELDS["max_seq"] - 10 - margin
    for eng, mod in ((jeng, js), (teng, ts)):
        eng.submit(mod.Request(uid="fits", prompt=tokens(1, 10),
                               max_new=limit))
        with pytest.raises(ValueError,
                           match=rf"scratch margin \({margin}\) exceeds"):
            eng.submit(mod.Request(uid="over", prompt=tokens(1, 10),
                                   max_new=limit + 1))


def test_spec_decode_probe_is_exact():
    """The ported probe on the CPU: the speculative engine and its plain
    twin both emit the closed-form ramp, every draft is accepted, and
    44 tokens a request take ceil(44 / 9) = 5 windows."""
    out = tspec_probe.spec_decode_probe(repeats=1, device="cpu")
    assert out["byte_equal"]
    assert out["spec_accept_rate"] == 1.0
    assert out["spec_windows"] == 5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_induction_params_ramp(dtype):
    """The probe's weights make the greedy next token (last + 1) mod
    vocab for every token, in bf16 too (the closed form JAX's
    ``_induction_params`` builds)."""
    cfg = tspec_probe.probe_config(dtype)
    params = tspec_probe._induction_params(cfg, device="cpu")
    toks = torch.arange(cfg.vocab)[:, None]
    with torch.no_grad():
        got = tt.forward(params, toks, cfg)[:, 0].argmax(-1)
    assert torch.equal(got, (toks[:, 0] + 1) % cfg.vocab)
