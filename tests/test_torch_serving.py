"""Port serving engine (k8s_dra_driver_tpu_torch/models/serving.py)
against the JAX engine and against itself.

Greedy token streams are exact: the port engine equals the JAX engine
on one mixed-length mix in both KV layouts (one JAX engine run per
layout, to bound JAX compile time), and equals the port's own
``greedy_generate`` under every scheduling option.  Sampled streams
cannot match JAX's (threefry vs Philox); they are held token-exact
within the port: the same seed gives the same tokens whatever the
batch, layout or preemption.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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

# six requests, three prompt lengths, over three slots
MIX = [("a", 5, 6), ("b", 9, 4), ("c", 5, 8), ("d", 12, 5), ("e", 9, 7),
       ("f", 12, 3)]


def prompt(seed, n):
    return np.random.default_rng(seed).integers(
        0, FIELDS["vocab"], n).astype(np.int32)


def mix():
    return [(uid, prompt(100 + i, n), m)
            for i, (uid, n, m) in enumerate(MIX)]


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(np.asarray,
                      jt.init_params(JCFG, jax.random.PRNGKey(0)))
    return jp, params_from_jax(jp, device="cpu")


def drain(eng, reqs, request_cls=ts.Request):
    for uid, pr, m, *rest in reqs:
        temp, seed = rest if rest else (0.0, 0)
        eng.submit(request_cls(uid=uid, prompt=pr, max_new=m,
                               temperature=temp, seed=seed))
    return {f.uid: f.tokens for f in eng.run()}


def port_engine(tp, **kw):
    return ts.ServingEngine(tp, TCFG, slots=3, device="cpu", **kw)


def greedy_ref(tp, pr, n):
    return td.greedy_generate(
        tp, torch.as_tensor(pr[None], dtype=torch.long), TCFG, n
    )[0].numpy()


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_engine_equals_jax_engine(params, layout):
    """Same requests, same slots, same scheduling: identical tokens and
    the same per-label launch and readback counts."""
    jp, tp = params
    kw = {} if layout == "contiguous" else dict(kv_layout="paged",
                                                kv_block_size=8)
    with jdispatch.track() as jt_:
        want = drain(js.ServingEngine(jp, JCFG, slots=3, **kw), mix(),
                     js.Request)
    with tdispatch.track() as tt_:
        got = drain(port_engine(tp, **kw), mix())
    assert set(got) == set(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]),
                                      err_msg=f"request {uid}")
    assert tt_.by_label == jt_.by_label


MOE_FIELDS = dict(FIELDS, n_experts=4, top_k=2, moe_dispatch="gmm")


@pytest.fixture(scope="module")
def moe_params():
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **MOE_FIELDS)
    jp = jax.tree.map(np.asarray,
                      jt.init_params(jcfg, jax.random.PRNGKey(1)))
    return jcfg, jp, params_from_jax(jp, device="cpu")


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_moe_engine_equals_jax_engine(moe_params, layout):
    """An MoE config (gmm-trained, served with dense dispatch): the port
    engine's greedy tokens equal the JAX engine's and the port's own
    ``greedy_generate``."""
    jcfg, jp, tp = moe_params
    tcfg = tt.TransformerConfig(dtype=torch.float32, **MOE_FIELDS)
    kw = {} if layout == "contiguous" else dict(kv_layout="paged",
                                                kv_block_size=8)
    reqs = mix()[:4]
    want = drain(js.ServingEngine(jp, jcfg, slots=3, **kw), reqs,
                 js.Request)
    got = drain(ts.ServingEngine(tp, tcfg, slots=3, device="cpu", **kw),
                reqs)
    assert set(got) == set(want)
    for uid, pr, m in reqs:
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]),
                                      err_msg=f"request {uid}")
        ref = td.greedy_generate(
            tp, torch.as_tensor(pr[None], dtype=torch.long), tcfg, m)[0]
        np.testing.assert_array_equal(got[uid], ref.numpy())


@pytest.mark.parametrize("kw", [
    dict(),
    dict(prefix_cache=4),
    dict(prefill_chunk=4),
    dict(prefill_chunk=5, prefix_cache=2),
    dict(kv_layout="paged", kv_block_size=8),
    dict(kv_layout="paged", kv_block_size=4, prefill_chunk=3),
], ids=["plain", "prefix", "chunk", "chunk_prefix", "paged",
        "paged_chunk"])
def test_engine_equals_greedy_generate(params, kw):
    _, tp = params
    got = drain(port_engine(tp, **kw), mix())
    for uid, pr, m in mix():
        np.testing.assert_array_equal(got[uid], greedy_ref(tp, pr, m),
                                      err_msg=f"request {uid}")


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_shared_prefix_hits_stay_exact(params, layout):
    """A shared system prompt is reused (hits counted) and the streams
    still equal greedy generation."""
    _, tp = params
    sys_p = prompt(7, 10)
    reqs = [(f"s{i}", np.concatenate([sys_p, prompt(20 + i, 3 + i)]), 5)
            for i in range(5)]
    kw = (dict(prefix_cache=4) if layout == "contiguous"
          else dict(kv_layout="paged", kv_block_size=4))
    eng = port_engine(tp, **kw)
    got = drain(eng, reqs)
    assert eng.stats()["prefix_hits_total"] >= 1
    for uid, pr, m in reqs:
        np.testing.assert_array_equal(got[uid], greedy_ref(tp, pr, m))


def test_paged_preemption_is_byte_equal(params):
    """A pool too small for every slot's worst case preempts and
    reruns, and every stream — greedy and sampled — equals the
    unpressured run."""
    _, tp = params
    reqs = [(uid, pr, m + 20, 0.9 if uid in "ce" else 0.0, 7)
            for uid, pr, m in mix()]
    roomy = drain(port_engine(tp, kv_layout="paged", kv_block_size=4,
                              top_k=8), reqs)
    eng = port_engine(tp, kv_layout="paged", kv_block_size=4, top_k=8,
                      kv_blocks=14)
    tight = drain(eng, reqs)
    assert eng.stats()["kv_preemptions_total"] >= 1
    assert set(tight) == set(roomy)
    for uid in roomy:
        np.testing.assert_array_equal(tight[uid], roomy[uid],
                                      err_msg=f"request {uid}")


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_sampled_request_same_alone_and_mixed(params, layout):
    _, tp = params
    kw = {} if layout == "contiguous" else dict(kv_layout="paged",
                                                kv_block_size=8)
    target = ("z", prompt(50, 7), 9, 0.8, 1234)
    alone = drain(port_engine(tp, top_k=10, **kw), [target])
    others = [(uid, pr, m, 1.1 if uid == "b" else 0.0, 5)
              for uid, pr, m in mix()]
    mixed = drain(port_engine(tp, top_k=10, **kw), others[:3] + [target]
                  + others[3:])
    np.testing.assert_array_equal(alone["z"], mixed["z"])
    other_seed = drain(port_engine(tp, top_k=10, **kw),
                       [target[:4] + (99,)])
    assert not np.array_equal(alone["z"], other_seed["z"])


def test_sampled_rows_agree_across_layouts(params):
    _, tp = params
    reqs = [(uid, pr, m, 0.7 if uid in "bd" else 0.0, 3)
            for uid, pr, m in mix()]
    dense = drain(port_engine(tp, top_p=0.9), reqs)
    paged = drain(port_engine(tp, top_p=0.9, kv_layout="paged",
                              kv_block_size=8), reqs)
    for uid in dense:
        np.testing.assert_array_equal(dense[uid], paged[uid])


#: the JAX engine's speculative composition gates, one case each; "P"
#: stands for the package's own params and "C" for its config
DRAFT_GATES = {
    "paged_draft_model": dict(kv_layout="paged", kv_block_size=8,
                              draft_params="P", draft_cfg="C"),
    "params_without_cfg": dict(draft_params="P"),
    "cfg_without_params": dict(draft_cfg="C"),
    "draft_len_model": dict(draft_params="P", draft_cfg="C", draft_len=0),
    "unknown_source": dict(draft_source="eagle"),
    "model_without_params": dict(draft_source="model"),
    "ngram_with_params": dict(draft_source="ngram", draft_params="P",
                              draft_cfg="C"),
    "draft_len_ngram": dict(draft_source="ngram", draft_len=0),
}


@pytest.mark.parametrize("gate", sorted(DRAFT_GATES))
def test_draft_gates_raise_as_jax(params, gate):
    """Each speculative composition gate raises ValueError in the port
    with the JAX engine's message."""
    jp, tp = params

    def kwargs(p, cfg):
        return {k: {"P": p, "C": cfg}[v] if k in ("draft_params",
                                                  "draft_cfg") else v
                for k, v in DRAFT_GATES[gate].items()}

    with pytest.raises(ValueError) as jerr:
        js.ServingEngine(jp, JCFG, slots=3, **kwargs(jp, JCFG))
    with pytest.raises(ValueError) as terr:
        port_engine(tp, **kwargs(tp, TCFG))
    assert str(terr.value) == str(jerr.value)


def test_ctor_and_intake_validation(params):
    jp, tp = params
    with pytest.raises(ValueError, match="unknown kv_layout"):
        port_engine(tp, kv_layout="blocked")
    with pytest.raises(ValueError, match="not a multiple"):
        port_engine(tp, kv_layout="paged", kv_block_size=13)
    with pytest.raises(ValueError, match="cannot hold"):
        port_engine(tp, kv_layout="paged", kv_blocks=3)
    with pytest.raises(ValueError, match="windowed"):
        ts.ServingEngine(tp, tt.TransformerConfig(
            dtype=torch.float32, attention_window=8, **FIELDS), slots=1,
            kv_layout="paged", device="cpu")
    with pytest.raises(ValueError, match="top_p"):
        port_engine(tp, top_p=2.0)
    eng = port_engine(tp)
    with pytest.raises(ValueError, match="exceeds"):
        eng.submit(ts.Request(uid="x", prompt=prompt(1, 40), max_new=20))
    with pytest.raises(ValueError, match="max_new"):
        eng.submit(ts.Request(uid="x", prompt=prompt(1, 4), max_new=0))
    with pytest.raises(ValueError, match="adapter"):
        eng.submit(ts.Request(uid="x", prompt=prompt(1, 4), max_new=2,
                              adapter="french"))
    eng.submit(ts.Request(uid="x", prompt=prompt(1, 4), max_new=2))
    with pytest.raises(ValueError, match="already in flight"):
        eng.submit(ts.Request(uid="x", prompt=prompt(2, 4), max_new=2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ts.ServingEngine(tp, TCFG, slots=1)


def test_eos_cancel_stream_and_counters(params):
    _, tp = params
    pr = prompt(60, 6)
    ref = greedy_ref(tp, pr, 10)
    eos = int(ref[6 + 2])
    stop = 6 + list(ref[6:]).index(eos) + 1     # first eos, kept
    eng = port_engine(tp, kv_layout="paged", kv_block_size=4)
    eng.submit(ts.Request(uid="e", prompt=pr, max_new=10, eos_id=eos))
    eng.submit(ts.Request(uid="q", prompt=prompt(61, 5), max_new=8))
    eng.submit(ts.Request(uid="k", prompt=prompt(62, 5), max_new=8))
    eng.submit(ts.Request(uid="late", prompt=prompt(63, 5), max_new=3))
    assert eng.cancel("late")
    events = []
    for ev in eng.stream():
        events.append(ev)
        if ev[:2] == ("token", "k") and eng.occupancy()["tokens"].get(
                "k", 0) >= 2:
            eng.cancel("k")
    finished = {uid: toks for kind, uid, toks in events
                if kind == "finished"}
    assert set(finished) == {"e", "q"}
    np.testing.assert_array_equal(finished["e"], ref[:stop])
    streamed = [t for kind, uid, t in events if kind == "token"
                and uid == "q"]
    np.testing.assert_array_equal(streamed, finished["q"][5:])
    stats = eng.stats()
    assert stats["finished_total"] == 2
    assert stats["cancelled_total"] == 2
    assert stats["kv_blocks_used"] >= 0
    occ = eng.occupancy()
    assert occ["active"] == 0 and occ["pending"] == 0
    assert occ["kv_free_blocks"] + occ["kv_headroom_blocks"] >= 0


def test_prefix_peek_and_multi_turn_capture(params):
    """A finished conversation is captured: its follow-up turn adopts
    prompt + generated rows and still equals greedy generation."""
    _, tp = params
    eng = port_engine(tp, prefix_cache=2)
    first = drain(eng, [("t1", prompt(70, 8), 5)])["t1"]
    follow = np.concatenate([first, prompt(71, 4)])
    assert eng.prefix_peek(follow) == len(first) - 1
    got = drain(eng, [("t2", follow, 4)])["t2"]
    np.testing.assert_array_equal(got, greedy_ref(tp, follow, 4))
    assert eng.stats()["prefix_tokens_reused_total"] >= len(first) - 1


# -- weight-only int8 and the int8 KV cache --------------------------------

@pytest.fixture(scope="module")
def int8_params(params):
    """The JAX package's quantization of the module's weights, and the
    same int8 tree carried into the port."""
    from k8s_dra_driver_tpu.models.quant import quantize_params
    jp, _ = params
    jq = quantize_params(jax.tree.map(jnp.asarray, jp), JCFG)
    return jq, params_from_jax(jax.tree.map(np.asarray, jq), device="cpu")


def test_int8_weights_engine_equals_jax_engine(int8_params):
    """Weight-only int8 params in both engines: identical tokens (the
    port's decode projections take K7's route, its plain version on the
    CPU; the JAX engine's take the einsum) and the same dispatch
    labels; the paged port engine (K2 and K7a on the card) gives the
    same tokens again."""
    jq, tq_ = int8_params
    with jdispatch.track() as jt_:
        want = drain(js.ServingEngine(jq, JCFG, slots=3), mix(), js.Request)
    with tdispatch.track() as tt_:
        got = drain(port_engine(tq_), mix())
    paged = drain(port_engine(tq_, kv_layout="paged", kv_block_size=8),
                  mix())
    assert set(got) == set(want) == set(paged)
    for uid in want:
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]),
                                      err_msg=f"request {uid}")
        np.testing.assert_array_equal(paged[uid], got[uid])
    assert tt_.by_label == jt_.by_label


def test_int8_kv_prefix_engine_equals_jax_engine(params):
    """The int8 KV cache with the prefix cache on: scales ride with the
    adopted rows (hits and multi-turn captures), and the tokens equal
    the JAX engine's and the port's own uncached engine's."""
    jp, tp = params
    fields = dict(FIELDS, kv_cache_dtype="int8")
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **fields)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **fields)
    pre = prompt(41, 8)
    reqs = [(uid, np.concatenate([pre, prompt(42 + i, 3 + i)]), 4)
            for i, uid in enumerate("abcd")]
    want = drain(js.ServingEngine(jp, jcfg, slots=2, prefix_cache=2),
                 reqs, js.Request)
    eng = ts.ServingEngine(tp, tcfg, slots=2, prefix_cache=2, device="cpu")
    got = drain(eng, reqs)
    assert eng.stats()["prefix_hits_total"] >= 1
    assert eng._prefix.bytes_per_token == 2 * 2 * 2 * (8 + 4)
    plain = drain(ts.ServingEngine(tp, tcfg, slots=2, device="cpu"), reqs)
    for uid, pr, m in reqs:
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]),
                                      err_msg=f"request {uid}")
        np.testing.assert_array_equal(got[uid], plain[uid])
        ref = td.greedy_generate(
            tp, torch.as_tensor(pr[None], dtype=torch.long), tcfg, m)[0]
        np.testing.assert_array_equal(got[uid], ref.numpy())


def test_paged_int8_kv_is_refused(params):
    _, tp = params
    cfg8 = tt.TransformerConfig(dtype=torch.float32, kv_cache_dtype="int8",
                                **FIELDS)
    with pytest.raises(ValueError, match="int8 cache"):
        ts.ServingEngine(tp, cfg8, slots=1, kv_layout="paged",
                         device="cpu")
