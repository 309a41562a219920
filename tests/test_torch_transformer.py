"""Port transformer (k8s_dra_driver_tpu_torch/models/transformer.py and
convert.py) against the JAX package's.

JAX's parameters, turned into numpy and moved over with
``params_from_jax``, go through both ``forward`` functions on the same
tokens.  f32 logits agree to atol/rtol 1e-4: both sides compute the
same einsums in f32 and differ only in summation order.  In bf16 the
elementwise pieces (rotary, rms_norm) agree to 2e-2 — one bf16 ulp at
magnitude 2 is 1.6e-2, and the two frameworks round at different
points inside each expression.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.models import transformer as jt
from k8s_dra_driver_tpu_torch.models import transformer as tt
from k8s_dra_driver_tpu_torch.models.convert import params_from_jax

BASE = dict(vocab=96, d_model=48, n_layers=2, n_heads=4, d_head=12,
            d_ff=96, max_seq=64)


def configs(dtype_jax=jnp.float32, dtype_torch=torch.float32, **kw):
    fields = dict(BASE, **kw)
    return (jt.TransformerConfig(dtype=dtype_jax, **fields),
            tt.TransformerConfig(dtype=dtype_torch, **fields))


def jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray,
                        jt.init_params(cfg, jax.random.PRNGKey(seed)))


def tokens(seed, b, t, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


def test_params_from_jax_round_trip_f32():
    jcfg, _ = configs(n_kv_heads=2)
    jp = jax_params(jcfg)
    tp = params_from_jax(jp, device="cpu")
    assert set(tp) == set(jp)
    assert len(tp["layers"]) == len(jp["layers"])
    for name in ("embed", "unembed", "ln_f"):
        np.testing.assert_array_equal(tp[name].numpy(), jp[name])
    for tl, jl in zip(tp["layers"], jp["layers"]):
        assert set(tl) == set(jl)
        for name in jl:
            assert tl[name].dtype == torch.float32
            np.testing.assert_array_equal(tl[name].numpy(), jl[name])


def test_params_from_jax_bf16_is_lossless():
    jcfg, _ = configs(dtype_jax=jnp.bfloat16, n_kv_heads=2)
    jp = jax_params(jcfg)
    tp = params_from_jax(jp, device="cpu")
    for tl, jl in zip(tp["layers"], jp["layers"]):
        for name in jl:
            assert tl[name].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                tl[name].view(torch.int16).numpy(),
                jl[name].view(np.int16))
    up = params_from_jax(jp, device="cpu", dtype=torch.float32)
    np.testing.assert_array_equal(up["embed"].numpy(),
                                  jp["embed"].astype(np.float32))


def test_init_params_layout_matches_jax():
    jcfg, tcfg = configs(n_kv_heads=2)
    jp = jax_params(jcfg)
    tp = tt.init_params(tcfg, torch.Generator().manual_seed(0),
                        device="cpu")
    for name in ("embed", "unembed", "ln_f"):
        assert tuple(tp[name].shape) == jp[name].shape
    for tl, jl in zip(tp["layers"], jp["layers"]):
        assert {k: tuple(v.shape) for k, v in tl.items()} == \
            {k: v.shape for k, v in jl.items()}
    again = tt.init_params(tcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert torch.equal(again["layers"][1]["wq"], tp["layers"][1]["wq"])


FORWARD_CASES = {
    "dense": dict(),
    "gqa": dict(n_kv_heads=2),
    "mqa_windowed": dict(n_kv_heads=1, attention_window=5),
    "gqa_rope_theta": dict(n_kv_heads=2, rope_theta=500000.0),
}


@pytest.mark.parametrize("name", sorted(FORWARD_CASES))
def test_forward_logits_match_jax(name):
    jcfg, tcfg = configs(**FORWARD_CASES[name])
    jp = jax_params(jcfg, seed=3)
    toks = tokens(4, 2, 20, jcfg.vocab)
    want = np.asarray(jt.forward(jp, jnp.asarray(toks), jcfg))
    got = tt.forward(params_from_jax(jp, device="cpu"),
                     torch.from_numpy(toks).long(), tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("window", [0, 6])
def test_forward_segmented_matches_jax(window):
    jcfg, tcfg = configs(n_kv_heads=2, attention_window=window)
    jp = jax_params(jcfg, seed=5)
    toks = tokens(6, 2, 24, jcfg.vocab)
    seg = np.cumsum(np.random.default_rng(7).integers(0, 6, (2, 24)) == 0,
                    axis=1).astype(np.int32)
    want = np.asarray(jt.forward(jp, jnp.asarray(toks), jcfg,
                                 segment_ids=jnp.asarray(seg)))
    got = tt.forward(params_from_jax(jp, device="cpu"),
                     torch.from_numpy(toks).long(), tcfg,
                     segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


DTYPES = {"f32": (jnp.float32, torch.float32, 1e-6),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def as_np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("per_row", [False, True])
def test_rotary_matches_jax(dt, per_row):
    jd, td, tol = DTYPES[dt]
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = (rng.integers(0, 500, (2, 7)) if per_row
           else np.arange(7) + 11).astype(np.int32)
    want = jt.rotary(jnp.asarray(x, jd), jnp.asarray(pos), 10000.0)
    got = tt.rotary(torch.from_numpy(x).to(td), torch.from_numpy(pos),
                    10000.0)
    assert got.dtype == td
    np.testing.assert_allclose(as_np(got), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_rms_norm_matches_jax(dt):
    jd, td, tol = DTYPES[dt]
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((3, 5, 32)) * 3).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    want = jt.rms_norm(jnp.asarray(x, jd), jnp.asarray(w, jd))
    got = tt.rms_norm(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td))
    assert got.dtype == td
    np.testing.assert_allclose(as_np(got), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    layer = {"w_in": torch.eye(101), "w_out": torch.eye(101)}
    got = tt._dense_mlp(torch.from_numpy(x)[None, None], layer)[0, 0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


CONFIG_ERRORS = {
    "seq_parallel": dict(seq_parallel="tree"),
    "kv_heads": dict(n_heads=4, n_kv_heads=3),
    "window": dict(attention_window=-1),
    "moe_dispatch": dict(moe_dispatch="sparse"),
    "capacity": dict(capacity_factor=0.0),
    "aux": dict(aux_loss_weight=-1.0),
    "kv_dtype": dict(kv_cache_dtype="fp8"),
    "pp": dict(pp_stages=0),
    "pp_split": dict(n_layers=3, pp_stages=2),
}


@pytest.mark.parametrize("name", sorted(CONFIG_ERRORS))
def test_config_validation_matches_jax(name):
    kw = CONFIG_ERRORS[name]
    with pytest.raises(ValueError) as jerr:
        jt.TransformerConfig(**kw)
    with pytest.raises(ValueError) as terr:
        tt.TransformerConfig(**kw)
    assert str(terr.value) == str(jerr.value)


def test_config_fields_match_jax():
    jf = [f.name for f in dataclasses.fields(jt.TransformerConfig)]
    tf = [f.name for f in dataclasses.fields(tt.TransformerConfig)]
    assert tf == jf


def test_moe_and_missing_card_are_refused():
    """MoE configs build (the JAX layout, key for key), and so do
    pipelined configs: ``init_params`` gives the layers list, as JAX's
    does, and their staged form runs the sequential path without a
    mesh, equal to the layers list (JAX's ``mesh=None`` path)."""
    jcfg, tcfg = configs(n_experts=4)
    tp = tt.init_params(tcfg, torch.Generator().manual_seed(0),
                        device="cpu")
    for layer in tp["layers"]:
        assert {k: tuple(v.shape) for k, v in layer.items()} == \
            jt._layer_shapes(jcfg)
    assert tp["layers"][0]["w_in"].shape == (4, 48, 96)
    for kw in (dict(n_experts=4, pp_stages=2), dict(pp_stages=2)):
        jpiped, piped = configs(**kw)
        params = tt.init_params(piped, device="cpu")
        assert [{k: tuple(v.shape) for k, v in layer.items()}
                for layer in params["layers"]] == \
            [jt._layer_shapes(jpiped)] * piped.n_layers
        toks = torch.zeros((1, 4), dtype=torch.long)
        assert torch.equal(
            tt.forward(tt.stage_params(params, piped), toks, piped),
            tt.forward(params, toks, piped))
    if not torch.cuda.is_available():
        _, dense = configs()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tt.init_params(dense)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            params_from_jax({"embed": np.zeros((2, 2), np.float32)})
