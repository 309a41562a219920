"""K1's block entry in the port (k8s_dra_driver_tpu_torch/ops/
flash_attention.py ``flash_block_attention``) against the JAX package's
``flash_block_attention`` in interpret mode.

The block entry runs q against one K/V block at absolute offsets (a
ring hop) and returns the unnormalized statistics ``(o, m, l)``.  On
CPU tensors it is the plain version ``flash_block_attention_reference``,
which rounds where the TPU kernel ``_flash_kernel`` rounds.  Rows that
see no key of the block must come out as m = -1e30, l = 0, o = 0 in
both, exactly: ``merge_flash_stats`` relies on it.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("k8s_dra_driver_tpu.ops.flash_attention")

# f32: the plain version folds the scale into q as the TPU kernel does;
# summation order alone parts them, relative to max(1, max|JAX|)
F32_TOL = 1e-5
# bf16, as tests/test_torch_flash_fwd.py holds the normalized entry
BF16_TOL = 2e-4
NEG = -1e30

# (Tq, Tk, q_offset, k_offset): the full block below the diagonal, the
# diagonal, a block wholly above it, a window that crosses the block,
# Tq != Tk at ragged lengths; GQA throughout, MQA and D=128 once.  Each
# case has a twin (``twin`` names it) at one of the small head dims the
# kernels take (8, 16, 32: the JAX package's probe models)
CASES = {
    "full": dict(tq=128, tk=128, q_off=128, k_off=0),
    "diagonal": dict(tq=128, tk=128, q_off=0, k_off=0),
    "masked": dict(tq=128, tk=128, q_off=0, k_off=128),
    "window_crossing": dict(tq=128, tk=128, q_off=64, k_off=0, window=40),
    "ragged_tq_ne_tk": dict(tq=192, tk=320, q_off=300, k_off=100),
    "segments": dict(tq=192, tk=320, q_off=300, k_off=100, seg=True),
    "segments_non_causal": dict(tq=128, tk=128, q_off=0, k_off=128,
                                seg=True, causal=False),
    "d128_mqa_window": dict(tq=96, tk=96, q_off=96, k_off=0, window=50,
                            d=128, h_kv=1),
}
for _base, _d in (("full", 8), ("diagonal", 16), ("masked", 32),
                  ("window_crossing", 32), ("ragged_tq_ne_tk", 8),
                  ("segments", 16), ("segments_non_causal", 8),
                  ("d128_mqa_window", 16)):
    CASES[f"{_base.removeprefix('d128_')}_d{_d}"] = dict(
        CASES[_base], d=_d, twin=_base)


def case(name, seed=0, grid=False):
    """Inputs of one case from numpy: q/k/v and the two segment id
    blocks cut from one sequence's ids at the offsets.  ``grid`` puts q
    and k on multiples of 1/4 in [-3/4, 3/4]: q scaled and rounded to
    bf16 keeps 8 significant bits, each product of it with k is exact,
    and a sum of D of them needs fewer than f32's 24 bits, so every
    score is exact in f32 whatever the summation order."""
    c = dict(dict(d=64, h_kv=2, window=None, seg=False, causal=True),
             **CASES[name])
    c.pop("twin", None)
    rng = np.random.default_rng(seed)
    b, h, d = 2, 4, c["d"]
    tq, tk = c["tq"], c["tk"]
    if grid:
        q = rng.integers(-3, 4, (b, tq, h, d)).astype(np.float32) / 4
        k = rng.integers(-3, 4, (b, tk, c["h_kv"], d)).astype(np.float32) / 4
    else:
        q = rng.standard_normal((b, tq, h, d), np.float32)
        k = rng.standard_normal((b, tk, c["h_kv"], d), np.float32)
    v = rng.standard_normal((b, tk, c["h_kv"], d), np.float32)
    qs = ks = None
    if c["seg"]:
        n = max(c["q_off"] + tq, c["k_off"] + tk)
        ids = np.cumsum(rng.integers(0, 40, (b, n)) == 0,
                        axis=1).astype(np.int32)
        qs = ids[:, c["q_off"]:c["q_off"] + tq]
        ks = ids[:, c["k_off"]:c["k_off"] + tk]
    return c, (q, k, v), (qs, ks)


def jax_block(c, arrays, segs, dtype, block_k=128):
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in arrays)
    qs, ks = (None if s is None else jnp.asarray(s) for s in segs)
    o, m, l = jfa.flash_block_attention(
        jq, jk, jv, c["q_off"], c["k_off"], causal=c["causal"],
        window=c["window"], block_q=64, block_k=block_k, interpret=True,
        q_segments=qs, k_segments=ks)
    return tuple(np.array(x, np.float32) for x in (o, m, l))


def port_block(c, arrays, segs, dtype, fn=tfa.flash_block_attention, **kw):
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in arrays)
    qs, ks = (None if s is None else torch.from_numpy(s) for s in segs)
    return fn(tq, tk, tv, c["q_off"], c["k_off"], causal=c["causal"],
              window=c["window"], q_segments=qs, k_segments=ks, **kw)


def relative_error(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if got.size == 0:
        return 0.0
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def assert_stats_close(got, want, tol):
    """o, m, l against JAX's: rows JAX leaves empty (l = 0) must be
    m = -1e30, l = 0, o = 0 exactly; elsewhere o and l within ``tol``
    of max(1, max|JAX|), m within ``tol`` of max(1, max|m|)."""
    o, m, l = (x.numpy() for x in got)
    jo, jm, jl = want
    assert o.dtype == m.dtype == l.dtype == np.float32
    assert o.shape == jo.shape and m.shape == jm.shape == l.shape
    dead = jl == 0
    assert np.array_equal(l == 0, dead)
    assert (m[dead] == NEG).all() and (jm[dead] == NEG).all()
    dead_rows = dead.transpose(0, 2, 1)
    assert (o[dead_rows] == 0).all()
    assert relative_error(o, jo) <= tol
    assert relative_error(l, jl) <= tol
    assert relative_error(m[~dead], jm[~dead]) <= tol
    return dead


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_entry_matches_jax_in_f32(name):
    c, arrays, segs = case(name)
    want = jax_block(c, arrays, segs, jnp.float32)
    got = port_block(c, arrays, segs, torch.float32)
    dead = assert_stats_close(got, want, F32_TOL)
    base = CASES[name].get("twin", name)
    if base == "masked":
        assert dead.all()
    if base in ("full", "diagonal", "ragged_tq_ne_tk"):
        assert not dead.any()


@pytest.mark.parametrize("name,block_k", [
    ("full", 128), ("diagonal", 128), ("window_crossing", 128),
    ("segments", 128), ("ragged_tq_ne_tk", 256), ("d128_mqa_window", 128),
    ("full_d8", 128), ("diagonal_d16", 128), ("window_crossing_d32", 128),
    ("segments_d16", 128), ("ragged_tq_ne_tk_d8", 256),
    ("mqa_window_d16", 128)])
def test_block_reference_matches_jax_pallas_in_bf16(name, block_k):
    """bf16 against the interpreted Pallas kernel with the same key
    partition (``block_k``): the roundings of q and p where the TPU
    kernel makes them.  q and k lie on a coarse grid, so every score is
    exact in f32 in any summation order: p then meets its bf16 rounding
    with the same f32 value in both, and only the f32 sums of l and p.v
    part them.  The f32 oracle (nothing rounded) misses by more than the
    tolerance, so the test sees the roundings."""
    c, arrays, segs = case(name, seed=1, grid=True)
    want = jax_block(c, arrays, segs, jnp.bfloat16, block_k)
    got = port_block(c, arrays, segs, torch.bfloat16,
                     fn=tfa.flash_block_attention_reference,
                     block_k=block_k)
    assert_stats_close(got, want, BF16_TOL)
    jo, jm, jl = want
    want_out, want_lse = (x.numpy() for x in tfa.normalize_flash_stats(
        torch.from_numpy(jo), torch.from_numpy(jm), torch.from_numpy(jl)))
    out, lse = tfa.normalize_flash_stats(*got)
    live = jl > 0
    assert relative_error(out.numpy(), want_out) <= BF16_TOL
    assert relative_error(lse.numpy()[live], want_lse[live]) <= BF16_TOL
    rounded = [torch.from_numpy(a).to(torch.bfloat16).float().numpy()
               for a in arrays]
    oracle = port_block(c, rounded, segs, torch.float32,
                        fn=tfa.flash_block_attention_reference)
    assert relative_error(tfa.normalize_flash_stats(*oracle)[0].numpy(),
                          want_out) > BF16_TOL


def test_block_entry_default_route_on_cpu_is_the_plain_version():
    """On CPU tensors the wrapper is its plain version, bit for bit, and
    counts no launch."""
    c, arrays, segs = case("segments", seed=2)
    before = (tfa.block_launches, tfa.block_tc_launches, tfa.launches)
    got = port_block(c, arrays, segs, torch.bfloat16)
    ref = port_block(c, arrays, segs, torch.bfloat16,
                     fn=tfa.flash_block_attention_reference)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert (tfa.block_launches, tfa.block_tc_launches,
            tfa.launches) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_normalized_plain_version_is_the_block_entry_at_zero_offsets(dtype):
    """``flash_forward_reference`` is the block entry's special case
    (offsets 0, Tq = Tk, one segment array) normalized, bit for bit."""
    c, arrays, segs = case("d128_mqa_window", seed=3)
    q, k, v = (torch.from_numpy(a[:, :96]).to(dtype) for a in arrays)
    seg = torch.from_numpy(np.cumsum(np.random.default_rng(3).integers(
        0, 20, (2, 96)) == 0, axis=1).astype(np.int32))
    out, lse = tfa.flash_forward_reference(q, k, v, window=30,
                                           segment_ids=seg,
                                           out_dtype=torch.float32)
    stats = tfa.flash_block_attention_reference(
        q, k, v, 0, 0, window=30, q_segments=seg, k_segments=seg)
    b_out, b_lse = tfa.normalize_flash_stats(*stats)
    assert torch.equal(out, b_out) and torch.equal(lse, b_lse)


def test_merge_flash_stats_matches_jax():
    """The cross-block merge on statistics with empty rows on either
    side (m = -1e30, l = 0, o = 0)."""
    rng = np.random.default_rng(4)
    b, t, h, d = 2, 24, 4, 16
    parts = []
    for _ in range(2):
        o = rng.standard_normal((b, t, h, d), np.float32)
        m = rng.standard_normal((b, h, t), np.float32)
        l = rng.uniform(0.5, 3.0, (b, h, t)).astype(np.float32)
        dead = rng.random((b, h, t)) < 0.3
        m[dead], l[dead] = NEG, 0.0
        o[dead.transpose(0, 2, 1)] = 0.0
        parts.append((o, m, l))
    want = jfa.merge_flash_stats(*(jnp.asarray(x) for p in parts
                                   for x in p))
    got = tfa.merge_flash_stats(*(torch.from_numpy(x) for p in parts
                                  for x in p))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("window,seg", [(None, False), (70, True)])
def test_merged_hops_equal_the_normalized_forward(window, seg):
    """A sequence cut into S = 4 key blocks: the block entry on each
    block at its offset, merged with ``merge_flash_stats`` and
    normalized, is the normalized forward of the whole sequence (f32,
    summation order only)."""
    rng = np.random.default_rng(5)
    b, t, h, h_kv, d, s = 2, 256, 4, 2, 64, 4
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (b, t, n, d), np.float32)) for n in (h, h_kv, h_kv))
    ids = (torch.from_numpy(np.cumsum(rng.integers(0, 50, (b, t)) == 0,
                                      axis=1).astype(np.int32))
           if seg else None)
    want, want_lse = tfa.flash_forward_reference(q, k, v, window=window,
                                                 segment_ids=ids)
    tl = t // s
    for qi in range(s):
        qb = q[:, qi * tl:(qi + 1) * tl]
        qs = None if ids is None else ids[:, qi * tl:(qi + 1) * tl]
        acc = None
        for ki in range(s):
            sl = slice(ki * tl, (ki + 1) * tl)
            stats = tfa.flash_block_attention(
                qb, k[:, sl], v[:, sl], qi * tl, ki * tl, window=window,
                q_segments=qs, k_segments=None if ids is None else
                ids[:, sl])
            acc = stats if acc is None else tfa.merge_flash_stats(*acc,
                                                                  *stats)
        out, lse = tfa.normalize_flash_stats(*acc)
        assert relative_error(out.numpy(), want[:, qi * tl:(qi + 1)
                                                * tl].numpy()) <= 1e-6
        assert relative_error(lse.numpy(), want_lse[..., qi * tl:(qi + 1)
                                                    * tl].numpy()) <= 1e-6


def test_block_entry_validates_as_jax_does():
    q = torch.zeros((1, 8, 4, 64))
    k = torch.zeros((1, 16, 2, 64))
    seg = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="window requires causal"):
        tfa.flash_block_attention(q, k, k, 0, 0, causal=False, window=4)
    with pytest.raises(ValueError, match="window requires causal"):
        tfa.flash_block_attention(q, k, k, 0, 0, window=0)
    with pytest.raises(ValueError, match="given together"):
        tfa.flash_block_attention(q, k, k, 0, 0, q_segments=seg)
    with pytest.raises(ValueError, match="not a multiple of kv heads"):
        tfa.flash_block_attention(q, torch.zeros((1, 16, 3, 64)),
                                  torch.zeros((1, 16, 3, 64)), 0, 0)
    with pytest.raises(ValueError, match="k_segments"):
        tfa.flash_block_attention(q, k, k, 0, 0, q_segments=seg,
                                  k_segments=seg)
