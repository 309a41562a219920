"""Port flash forward (k8s_dra_driver_tpu_torch/ops/flash_attention.py)
against the JAX package's.

K1's plain version ``flash_forward_reference`` rounds where the TPU
kernel ``_flash_kernel`` rounds: q is scaled in f32 and rounded to its
dtype, and each key block's p is rounded to v's dtype before p.v,
against the running max of the same key partition.  In bf16 it is held
to JAX's ``flash_block_attention`` in interpret mode with the same
``block_k``, on the normalized output before its final cast; in f32 to
the f32 oracle ``attention_forward``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("k8s_dra_driver_tpu.ops.flash_attention")

# the rounding plain version against the interpreted Pallas kernel in
# bf16, relative to max(1, max|ref|): both sum exact products of the
# same bf16 operands in f32 in another order, so an entry of p may
# round to the neighbouring bf16 value in one and not the other; the
# version without the kernel's roundings misses by 6.9e-4 to 1.7e-3
BF16_TOL = 2e-4
# the rounding plain version against the f32 oracle in f32: the scale
# folded into q and the blocked softmax part them by a few units in the
# last place
F32_TOL = 1e-6

# T <= block_k (one key block) and T > block_k (several, the last one
# ragged); GQA throughout, segments, a window at T <= block_k.  Each
# D = 64/128 case has a twin at one of the small head dims the kernels
# take (8, 16, 32: the JAX package's probe models), each small D three
# of the shapes
CASES = {
    "d64_one_block": dict(d=64, t=96, block_k=128),
    "d128_one_block": dict(d=128, t=96, block_k=128),
    "d64_three_blocks": dict(d=64, t=320, block_k=128),
    "d128_two_blocks_bk256": dict(d=128, t=384, block_k=256),
    "d64_mqa_two_blocks": dict(d=64, t=256, block_k=128, h_kv=1),
    "d64_segments": dict(d=64, t=256, block_k=128, seg=True),
    "d128_segments_one_block": dict(d=128, t=112, block_k=128, seg=True),
    "d64_window": dict(d=64, t=128, block_k=128, window=32),
    "d128_window_segments": dict(d=128, t=80, block_k=128, window=17,
                                 seg=True),
    "d8_one_block": dict(d=8, t=96, block_k=128),
    "d32_one_block": dict(d=32, t=96, block_k=128),
    "d16_three_blocks": dict(d=16, t=320, block_k=128),
    "d32_two_blocks_bk256": dict(d=32, t=384, block_k=256),
    "d8_mqa_two_blocks": dict(d=8, t=256, block_k=128, h_kv=1),
    "d16_segments": dict(d=16, t=256, block_k=128, seg=True),
    "d32_segments_one_block": dict(d=32, t=112, block_k=128, seg=True),
    "d8_window": dict(d=8, t=128, block_k=128, window=32),
    "d16_window_segments": dict(d=16, t=80, block_k=128, window=17,
                                seg=True),
}
#: the small head dims, beside the cases' own 64 and 128
SMALL_DIMS = (8, 16, 32)


def case(name, seed=0, b=1, h=4, d=None):
    """One case's inputs from numpy; ``d`` replaces its head dim."""
    c = dict(dict(h_kv=2, window=None, seg=False), **CASES[name])
    if d is not None:
        c["d"] = d
    rng = np.random.default_rng(seed)
    t, d = c["t"], c["d"]
    q = rng.standard_normal((b, t, h, d), np.float32)
    k = rng.standard_normal((b, t, c["h_kv"], d), np.float32)
    v = rng.standard_normal((b, t, c["h_kv"], d), np.float32)
    seg = None
    if c["seg"]:
        seg = np.cumsum(rng.integers(0, 24, (b, t)) == 0,
                        axis=1).astype(np.int32)
    return c, (q, k, v), seg


def relative_error(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def t_(a, dtype=torch.float32):
    if a is None:
        return None
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


@pytest.mark.parametrize("name", sorted(CASES))
def test_rounding_reference_matches_jax_pallas_in_bf16(name):
    """bf16: the port's plain version against the Pallas kernel in
    interpret mode, both on the f32 output before the final cast and
    the lse; the f32 oracle misses the kernel by more than the
    tolerance, so the test sees the roundings."""
    c, arrays, seg = case(name)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrays)
    jseg = None if seg is None else jnp.asarray(seg)
    o, m, l = jfa.flash_block_attention(
        jq, jk, jv, 0, 0, causal=True, block_q=128,
        block_k=c["block_k"], window=c["window"], interpret=True,
        q_segments=jseg, k_segments=jseg)
    want, want_lse = jfa.normalize_flash_stats(o, m, l)
    tq, tk, tv = (t_(a, torch.bfloat16) for a in arrays)
    kw = dict(causal=True, window=c["window"], segment_ids=t_(seg,
                                                              torch.int32))
    got, lse = tfa.flash_forward_reference(
        tq, tk, tv, block_k=c["block_k"], out_dtype=torch.float32, **kw)
    assert got.dtype == torch.float32 and lse.dtype == torch.float32
    assert relative_error(got.numpy(), want) <= BF16_TOL
    assert relative_error(lse.numpy(), want_lse) <= BF16_TOL
    oracle = tfa.attention_forward(tq.float(), tk.float(), tv.float(),
                                   **kw)[0]
    assert relative_error(oracle.numpy(), want) > BF16_TOL
    bf16, bf16_lse = tfa.flash_forward_reference(
        tq, tk, tv, block_k=c["block_k"], **kw)
    assert bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, got.to(torch.bfloat16))
    assert torch.equal(bf16_lse, lse)


@pytest.mark.parametrize("d", (None,) + SMALL_DIMS)
@pytest.mark.parametrize("block_k", [16, 128, 1000])
@pytest.mark.parametrize("name", ["d64_three_blocks", "d64_segments",
                                  "d128_window_segments"])
def test_rounding_reference_is_the_oracle_in_f32(name, block_k, d):
    """f32: every rounding is a no-op, so whatever the key partition the
    plain version is the f32 oracle to a few units in the last place
    (at the case's head dim and at each small one)."""
    c, arrays, seg = case(name, seed=1, d=d)
    tq, tk, tv = (t_(a) for a in arrays)
    kw = dict(causal=True, window=c["window"], segment_ids=t_(seg,
                                                              torch.int32))
    got, lse = tfa.flash_forward_reference(tq, tk, tv, block_k=block_k,
                                           **kw)
    want, want_lse = tfa.attention_forward(tq, tk, tv, **kw)
    assert got.dtype == torch.float32
    assert relative_error(got.numpy(), want.numpy()) <= F32_TOL
    assert relative_error(lse.numpy(), want_lse.numpy()) <= F32_TOL


def test_key_partition_moves_the_bf16_rounding():
    """p is rounded against the running max of the walked partition: a
    partition other than the kernel's gives another bf16 result."""
    c, arrays, _ = case("d64_three_blocks", seed=2)
    tq, tk, tv = (t_(a, torch.bfloat16) for a in arrays)
    outs = [tfa.flash_forward_reference(tq, tk, tv, block_k=bk,
                                        out_dtype=torch.float32)[0]
            for bk in (tfa.FWD_BLOCK_K, tfa.FWD_BLOCK_K // 2)]
    assert not torch.equal(*outs)
    assert relative_error(outs[0].numpy(), outs[1].numpy()) < 1e-2


@pytest.mark.parametrize("d", (64,) + SMALL_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_flash_forward_takes_the_rounding_reference(dtype, d):
    """On CPU tensors flash_forward and flash_attention return the plain
    version's result with the kernel's key tile and launch nothing."""
    c, arrays, seg = case("d64_segments", seed=3, d=d)
    tq, tk, tv = (t_(a, dtype) for a in arrays)
    kw = dict(window=None, segment_ids=t_(seg, torch.int32))
    want, want_lse = tfa.flash_forward_reference(tq, tk, tv, **kw)
    before = (tfa.launches, tfa.tc_launches)
    got, lse = tfa.flash_forward(tq, tk, tv, **kw)
    full = tfa.flash_forward(tq, tk, tv, out_dtype=torch.float32, **kw)[0]
    normalized = tfa.flash_attention(tq, tk, tv, **kw)
    assert (tfa.launches, tfa.tc_launches) == before
    assert got.dtype == dtype and full.dtype == torch.float32
    assert torch.equal(got, want) and torch.equal(lse, want_lse)
    assert torch.equal(normalized, want)
    assert torch.equal(full.to(dtype), want)
    assert torch.equal(want, tfa.flash_forward_reference(
        tq, tk, tv, block_k=tfa.FWD_BLOCK_K, **kw)[0])


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "tensor_cores"),
    (torch.bfloat16, 128, "tensor_cores"),
    (torch.float32, 64, "cuda_cores"),
    (torch.float32, 128, "cuda_cores"),
] + [(torch.bfloat16, d, "tensor_cores") for d in SMALL_DIMS]
  + [(torch.float32, d, "cuda_cores") for d in SMALL_DIMS])
def test_route_picker_sends_each_dtype_to_its_kernel(dtype, d, route):
    assert tfa.fwd_route(dtype, d) == route
    assert tfa._KERNEL_HEAD_DIMS == (8, 16, 32, 64, 128)


@pytest.mark.parametrize("dtype,d,match", [
    (torch.float16, 64, "float32 or bfloat16"),
    (torch.float64, 128, "float32 or bfloat16"),
    (torch.bfloat16, 24, "head dims"),
    (torch.bfloat16, 256, "head dims"),
    (torch.float32, 96, "head dims"),
])
def test_route_picker_refuses_what_no_route_takes(dtype, d, match):
    with pytest.raises(ValueError, match=match):
        tfa.fwd_route(dtype, d)


@pytest.mark.parametrize("dtype,d,out_dtype,match", [
    (torch.float16, 64, None, "float32 or bfloat16"),
    (torch.bfloat16, 96, None, "head dims"),
    (torch.float32, 64, torch.bfloat16, "writes q's dtype, not"),
    (torch.bfloat16, 64, torch.float16, "or float32, not"),
])
def test_kernel_launch_refuses_what_the_kernels_do_not_take(dtype, d,
                                                            out_dtype,
                                                            match):
    """The checks the card path runs before a launch raise, with no
    fallback, and count nothing."""
    q = torch.zeros((1, 8, 2, d), dtype=dtype)
    k = torch.zeros((1, 8, 1, d), dtype=dtype)
    before = (tfa.launches, tfa.tc_launches)
    with pytest.raises(ValueError, match=match):
        tfa._launch(q, k, k, True, 0.125, None, None, out_dtype or dtype)
    assert (tfa.launches, tfa.tc_launches) == before


def test_plain_version_refuses_an_empty_key_block():
    _, arrays, _ = case("d64_one_block")
    with pytest.raises(ValueError, match="block_k"):
        tfa.flash_forward_reference(*(t_(a) for a in arrays), block_k=0)
