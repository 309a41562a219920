"""Port flash backward (k8s_dra_driver_tpu_torch/ops/flash_attention.py)
against the JAX package's.

The same numpy inputs go through the JAX functions and their ports:
``attention_block_grads`` (the plain version K3 and K4 are held against
on the card), the Pallas ``flash_block_grads`` in interpret mode, and
the gradients of ``flash_attention`` (JAX: ``jax.grad`` through its
custom VJP, whose backward runs the interpreted Pallas kernels; port:
its ``torch.autograd.Function``, which on CPU tensors runs the plain
version).  f32 throughout: the tolerance (1e-5) covers summation order
only.
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


@pytest.mark.parametrize("name", sorted(BLOCK_CASES))
def test_attention_block_grads_matches_jax(name):
    c, arrays, qs, ks = block_case(name)
    scale = 16 ** -0.5
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


@pytest.mark.parametrize("name", ["causal_gqa", "window_mqa",
                                  "segments_gqa", "ring_later_q"])
def test_block_grads_match_jax_pallas_interpret(name):
    """The Pallas K3/K4 themselves (interpret mode) against the port's
    plain version, on blocks they take (no valid-key end)."""
    c, arrays, qs, ks = block_case(name, seed=1)
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
    (16, torch.float32, "head dims"),
    (64, torch.float16, "float32 or bfloat16"),
])
def test_kernel_arguments_refuse_what_the_kernels_do_not_take(d, dtype,
                                                              match):
    """The checks the card path runs before a launch: head dims other
    than 64/128 and dtypes other than f32/bf16 raise, no fallback."""
    q = torch.zeros((1, 8, 2, d), dtype=dtype)
    k = torch.zeros((1, 8, 1, d), dtype=dtype)
    stats = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match=match):
        tfa._bwd_launch_args(q, k, k, q, stats, stats, 0, 0, True, 0.1,
                             None, None, None, None)
