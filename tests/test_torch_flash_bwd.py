"""Port flash backward (k8s_dra_driver_tpu_torch/ops/flash_attention.py)
against the JAX package's.

The same numpy inputs go through the JAX functions and their ports:
``attention_block_grads`` (the plain version K3 and K4 are held against
on the card), the Pallas ``flash_block_grads`` in interpret mode, and
the gradients of ``flash_attention`` (JAX: ``jax.grad`` through its
custom VJP, whose backward runs the interpreted Pallas kernels; port:
its ``torch.autograd.Function``, which on CPU tensors runs the plain
version).  f32 there: the tolerance (1e-5) covers summation order only.

In bf16 the kernels' plain version is ``flash_block_grads_reference``,
which rounds p and ds to bf16 before the second products as the TPU
kernels do; it is held to the interpreted Pallas kernels in bf16, and
to ``attention_block_grads`` bit for bit in f32.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("k8s_dra_driver_tpu.ops.flash_attention")

ATOL = RTOL = 1e-5
#: the small head dims the kernels take beside 64 and 128 (the JAX
#: package's probe models); the block cases below run at 16 and, where
#: a test is parametrised over them, at each
SMALL_DIMS = (8, 16, 32)

# tq/tk, heads, block offsets (ring hops), masks
BLOCK_CASES = {
    "causal_mha": dict(tq=24, tk=24, h=4, h_kv=4),
    "causal_gqa": dict(tq=24, tk=24, h=4, h_kv=2),
    "window_mqa": dict(tq=24, tk=24, h=4, h_kv=1, window=5),
    "segments_gqa": dict(tq=24, tk=24, h=4, h_kv=2, seg=True),
    "window_segments": dict(tq=24, tk=24, h=4, h_kv=2, window=7, seg=True),
    "ring_later_q": dict(tq=16, tk=24, h=4, h_kv=2, q_off=24, k_off=8),
    "ring_window_valid_end": dict(tq=16, tk=24, h=4, h_kv=2, q_off=20,
                                  k_off=4, window=9, k_end=22),
    "ring_all_masked": dict(tq=8, tk=16, h=2, h_kv=1, q_off=0, k_off=40),
    "noncausal_segments_valid_end": dict(tq=20, tk=16, h=2, h_kv=1,
                                         causal=False, seg=True, k_end=11),
}


def block_case(name, seed=0, d=16, b=2):
    c = dict(dict(q_off=0, k_off=0, causal=True, window=None, seg=False,
                  k_end=None), **BLOCK_CASES[name])
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, c["tq"], c["h"], d), np.float32)
    do = rng.standard_normal((b, c["tq"], c["h"], d), np.float32)
    k = rng.standard_normal((b, c["tk"], c["h_kv"], d), np.float32)
    v = rng.standard_normal((b, c["tk"], c["h_kv"], d), np.float32)
    lse = (rng.standard_normal((b, c["h"], c["tq"])) + 2).astype(np.float32)
    delta = rng.standard_normal((b, c["h"], c["tq"])).astype(np.float32)
    qs = ks = None
    if c["seg"]:
        qs = np.cumsum(rng.integers(0, 4, (b, c["tq"])) == 0,
                       axis=1).astype(np.int32)
        ks = np.cumsum(rng.integers(0, 4, (b, c["tk"])) == 0,
                       axis=1).astype(np.int32)
    return c, (q, k, v, do, delta, lse), qs, ks


def t_(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def j_(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("name,d", [(n, 16) for n in sorted(BLOCK_CASES)]
                         + [("causal_gqa", 8), ("window_mqa", 32),
                            ("ring_window_valid_end", 8),
                            ("noncausal_segments_valid_end", 32)])
def test_attention_block_grads_matches_jax(name, d):
    c, arrays, qs, ks = block_case(name, d=d)
    scale = d ** -0.5
    kw = dict(k_valid_end=c["k_end"], window=c["window"])
    want = jfa.attention_block_grads(
        *map(j_, arrays), c["q_off"], c["k_off"], c["causal"], scale,
        q_segments=j_(qs), k_segments=j_(ks), **kw)
    got = tfa.attention_block_grads(
        *map(t_, arrays), c["q_off"], c["k_off"], c["causal"], scale,
        q_segments=t_(qs), k_segments=t_(ks), **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL)
    # the CPU wrapper takes the plain version, launching nothing
    before = (tfa.dq_launches, tfa.dkv_launches)
    wrapped = tfa.flash_block_grads(
        *map(t_, arrays), c["q_off"], c["k_off"], causal=c["causal"],
        q_segments=t_(qs), k_segments=t_(ks), **kw)
    assert (tfa.dq_launches, tfa.dkv_launches) == before
    for g, w in zip(wrapped, got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    dq = tfa.flash_bwd_dq(*map(t_, arrays), c["q_off"], c["k_off"],
                          causal=c["causal"], q_segments=t_(qs),
                          k_segments=t_(ks), **kw)
    dk, dv = tfa.flash_bwd_dkv(*map(t_, arrays), c["q_off"], c["k_off"],
                               causal=c["causal"], q_segments=t_(qs),
                               k_segments=t_(ks), **kw)
    for g, w in zip((dq, dk, dv), got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert (tfa.dq_launches, tfa.dkv_launches) == before


@pytest.mark.parametrize("name,d", [
    ("causal_gqa", 16), ("window_mqa", 16), ("segments_gqa", 16),
    ("ring_later_q", 16), ("causal_gqa", 8), ("ring_later_q", 32)])
def test_block_grads_match_jax_pallas_interpret(name, d):
    """The Pallas K3/K4 themselves (interpret mode) against the port's
    plain version, on blocks they take (no valid-key end)."""
    c, arrays, qs, ks = block_case(name, seed=1, d=d)
    want = jfa.flash_block_grads(
        *map(j_, arrays), c["q_off"], c["k_off"], causal=c["causal"],
        window=c["window"], interpret=True, q_segments=j_(qs),
        k_segments=j_(ks))
    got = tfa.flash_block_grads(
        *map(t_, arrays), c["q_off"], c["k_off"], causal=c["causal"],
        window=c["window"], q_segments=t_(qs), k_segments=t_(ks))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL)


def qkv(seed, b, t, h, h_kv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, h, d), np.float32),
            rng.standard_normal((b, t, h_kv, d), np.float32),
            rng.standard_normal((b, t, h_kv, d), np.float32),
            rng.standard_normal((b, t, h, d), np.float32))


GRAD_CASES = {
    "causal_gqa": dict(h=4, h_kv=2, window=None, seg=False),
    "mqa_window": dict(h=4, h_kv=1, window=5, seg=False),
    "gqa_segments": dict(h=4, h_kv=2, window=None, seg=True),
    "window_segments": dict(h=4, h_kv=2, window=7, seg=True),
}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_flash_attention_grads_match_jax(name):
    """q, k, v gradients of the port's autograd Function against
    ``jax.grad`` of the JAX ``flash_attention`` (custom VJP, Pallas
    backward interpreted), for a weighted sum of the output."""
    c = GRAD_CASES[name]
    q, k, v, w = qkv(2, 2, 40, c["h"], c["h_kv"], 16)
    seg = None
    if c["seg"]:
        seg = np.cumsum(np.random.default_rng(3).integers(0, 5, (2, 40))
                        == 0, axis=1).astype(np.int32)

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=True, window=c["window"],
                                  interpret=True, segment_ids=j_(seg))
        return jnp.sum(out * jnp.asarray(w))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (t_(a).requires_grad_() for a in (q, k, v))
    before = (tfa.launches, tfa.dq_launches, tfa.dkv_launches)
    out = tfa.flash_attention(tq, tk, tv, causal=True, window=c["window"],
                              segment_ids=t_(seg))
    got = torch.autograd.grad((out * t_(w)).sum(), (tq, tk, tv))
    assert (tfa.launches, tfa.dq_launches, tfa.dkv_launches) == before
    for g, ww in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(ww), atol=ATOL,
                                   rtol=RTOL)


def test_attention_delta_and_normalize_match_jax():
    rng = np.random.default_rng(4)
    do = rng.standard_normal((2, 12, 3, 8), np.float32)
    o = rng.standard_normal((2, 12, 3, 8), np.float32)
    np.testing.assert_allclose(
        tfa.attention_delta(t_(do), t_(o)).numpy(),
        np.asarray(jfa.attention_delta(j_(do), j_(o))), atol=ATOL,
        rtol=RTOL)
    m = rng.standard_normal((2, 3, 12)).astype(np.float32)
    l = rng.uniform(0, 3, (2, 3, 12)).astype(np.float32)
    l[0, 0, :4] = 0.0                     # empty rows: the l-clamp
    got = tfa.normalize_flash_stats(t_(o), t_(m), t_(l))
    want = jfa.normalize_flash_stats(j_(o), j_(m), j_(l))
    for g, ww in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(ww), atol=ATOL,
                                   rtol=RTOL)


def test_backward_of_the_forward_matches_dense_autograd():
    """flash_backward from a saved (out, lse) equals autograd through
    the dense attention: the Function and its forward agree on lse."""
    q, k, v, w = qkv(6, 1, 20, 4, 2, 16)
    tq, tk, tv = (t_(a).requires_grad_() for a in (q, k, v))
    out, lse = tfa.flash_forward(tq.detach(), tk.detach(), tv.detach(),
                                 window=6)
    got = tfa.flash_backward(tq.detach(), tk.detach(), tv.detach(), out,
                             lse, t_(w), window=6)
    ref = tfa.flash_attention_reference(tq, tk, tv, window=6)
    want = torch.autograd.grad((ref * t_(w)).sum(), (tq, tk, tv))
    for g, ww in zip(got, want):
        torch.testing.assert_close(g, ww, atol=ATOL, rtol=RTOL)


BAD = {
    "do_shape": (lambda a: (a[0], a[1], a[2], a[3][:, :-1], a[4], a[5]),
                 "do"),
    "lse_dtype": (lambda a: (*a[:5], a[5].double()), "lse must be float32"),
    "delta_shape": (lambda a: (*a[:4], a[4][:, :1], a[5]),
                    "delta must be"),
    "heads": (lambda a: (a[0][:, :, :3], a[1], a[2], a[3][:, :, :3],
                         a[4][:, :3], a[5][:, :3]), "not a multiple"),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_flash_block_grads_validation(name):
    bad, match = BAD[name]
    _, arrays, _, _ = block_case("causal_gqa")
    with pytest.raises(ValueError, match=match):
        tfa.flash_block_grads(*bad([t_(a) for a in arrays]))


def test_flash_block_grads_refuses_half_segments_and_bad_window():
    _, arrays, _, _ = block_case("causal_gqa")
    args = [t_(a) for a in arrays]
    seg = torch.zeros((2, 24), dtype=torch.int32)
    with pytest.raises(ValueError, match="together"):
        tfa.flash_block_grads(*args, q_segments=seg)
    with pytest.raises(ValueError, match="window requires causal"):
        tfa.flash_block_grads(*args, causal=False, window=4)


def test_backward_wrappers_refuse_devices_other_than_cuda_and_cpu():
    q = torch.empty((1, 8, 2, 64), device="meta")
    k = torch.empty((1, 8, 1, 64), device="meta")
    stats = torch.empty((1, 2, 8), device="meta")
    for fn in (tfa.flash_block_grads, tfa.flash_bwd_dq, tfa.flash_bwd_dkv):
        with pytest.raises(ValueError, match="cuda or cpu"):
            fn(q, k, k, q, stats, stats)


@pytest.mark.parametrize("d,dtype,match", [
    (24, torch.float32, "head dims"),
    (64, torch.float16, "float32 or bfloat16"),
])
def test_kernel_arguments_refuse_what_the_kernels_do_not_take(d, dtype,
                                                              match):
    """The checks the card path runs before a launch: head dims other
    than 8/16/32/64/128 and dtypes other than f32/bf16 raise, no
    fallback."""
    q = torch.zeros((1, 8, 2, d), dtype=dtype)
    k = torch.zeros((1, 8, 1, d), dtype=dtype)
    stats = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match=match):
        tfa._bwd_launch_args(q, k, k, q, stats, stats, 0, 0, True, 0.1,
                             None, None, None, None)


# flash_block_grads_reference against the interpreted Pallas kernels in
# bf16, relative to max(1, max|ref|): both sum exact products of the
# same bf16 operands in f32, in another order, so an entry of p or ds
# may round to the neighbouring bf16 value (2^-8 of it) in one and not
# the other; 1e-3 holds a few such flips.
BF16_TOL = 1e-3
# the f32 oracle against the same kernels in bf16: p and ds rounded to
# bf16 before the second products part them by about 2e-3 of the
# largest entry; chip_smoke.py holds the card's bf16 K3/K4 to 1e-2
# (BWD_BF16_ORACLE_TOL)
BF16_ORACLE_TOL = 1e-2


def bf16_block(name, seed=1, d=64):
    c, arrays, qs, ks = block_case(name, seed=seed, d=d)
    return c, list(arrays[:4]), list(arrays[4:]), qs, ks


def relative_error(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("name,d", [
    ("causal_gqa", 64), ("window_mqa", 64), ("segments_gqa", 64),
    ("ring_later_q", 64), ("causal_gqa", 8), ("window_mqa", 16),
    ("segments_gqa", 32), ("ring_later_q", 8)])
def test_rounding_reference_matches_jax_pallas_in_bf16(name, d):
    """The plain version the tensor-core K3/K4 are held against, on
    bf16 inputs, against the Pallas kernels (interpret mode) on the same
    inputs; the f32 oracle stays within the card's oracle gate of
    both.  At D = 64 and at each small head dim."""
    c, operands, (delta, lse), qs, ks = bf16_block(name, d=d)
    j_ops = [jnp.asarray(a).astype(jnp.bfloat16) for a in operands]
    t_ops = [t_(a).to(torch.bfloat16) for a in operands]
    scale = d ** -0.5
    want = jfa.flash_block_grads(
        *j_ops, j_(delta), j_(lse), c["q_off"], c["k_off"],
        causal=c["causal"], window=c["window"], interpret=True,
        q_segments=j_(qs), k_segments=j_(ks))
    args = (*t_ops, t_(delta), t_(lse), c["q_off"], c["k_off"],
            c["causal"], scale)
    kw = dict(window=c["window"], q_segments=t_(qs), k_segments=t_(ks))
    got = tfa.flash_block_grads_reference(*args, **kw)
    oracle = tfa.attention_block_grads(*args, **kw)
    for g, w, o in zip(got, want, oracle):
        assert g.dtype == torch.float32
        assert relative_error(g.numpy(), w) <= BF16_TOL
        assert relative_error(o.numpy(), w) <= BF16_ORACLE_TOL


@pytest.mark.parametrize("d", SMALL_DIMS)
@pytest.mark.parametrize("name", sorted(BLOCK_CASES))
def test_rounding_reference_equals_oracle_in_f32(name, d):
    """In f32 the rounding does nothing: bit for bit the oracle."""
    c, arrays, qs, ks = block_case(name, d=d)
    args = (*map(t_, arrays), c["q_off"], c["k_off"], c["causal"],
            d ** -0.5)
    kw = dict(k_valid_end=c["k_end"], window=c["window"],
              q_segments=t_(qs), k_segments=t_(ks))
    got = tfa.flash_block_grads_reference(*args, **kw)
    want = tfa.attention_block_grads(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_wrappers_take_the_rounding_reference(dtype):
    """On CPU tensors the three wrappers return the plain version's
    result and launch nothing, on either route's dtype."""
    c, operands, (delta, lse), qs, ks = bf16_block("window_segments")
    ops = [t_(a).to(dtype) for a in operands]
    kw = dict(window=c["window"], q_segments=t_(qs), k_segments=t_(ks))
    want = tfa.flash_block_grads_reference(
        *ops, t_(delta), t_(lse), 0, 0, True, 64 ** -0.5, **kw)
    before = (tfa.dq_launches, tfa.dkv_launches, tfa.dq_tc_launches,
              tfa.dkv_tc_launches)
    args = (*ops, t_(delta), t_(lse))
    both = tfa.flash_block_grads(*args, **kw)
    dq = tfa.flash_bwd_dq(*args, **kw)
    dk, dv = tfa.flash_bwd_dkv(*args, **kw)
    assert (tfa.dq_launches, tfa.dkv_launches, tfa.dq_tc_launches,
            tfa.dkv_tc_launches) == before
    for got in (both, (dq, dk, dv)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    if dtype == torch.bfloat16:   # the rounding is there to see
        oracle = tfa.attention_block_grads(
            *ops, t_(delta), t_(lse), 0, 0, True, 64 ** -0.5, **kw)
        assert not all(torch.equal(g, w) for g, w in zip(oracle, want))


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "tensor_cores"),
    (torch.bfloat16, 128, "tensor_cores"),
    (torch.float32, 64, "cuda_cores"),
    (torch.float32, 128, "cuda_cores"),
] + [(torch.bfloat16, d, "tensor_cores") for d in SMALL_DIMS]
  + [(torch.float32, d, "cuda_cores") for d in SMALL_DIMS])
def test_route_picker_sends_each_dtype_to_its_kernels(dtype, d, route):
    assert tfa.bwd_route(dtype, d) == route


@pytest.mark.parametrize("dtype,d,match", [
    (torch.float16, 64, "float32 or bfloat16"),
    (torch.float64, 128, "float32 or bfloat16"),
    (torch.bfloat16, 24, "head dims"),
    (torch.bfloat16, 256, "head dims"),
    (torch.float32, 96, "head dims"),
])
def test_route_picker_refuses_what_no_route_takes(dtype, d, match):
    with pytest.raises(ValueError, match=match):
        tfa.bwd_route(dtype, d)
