"""Port grouped matmul (k8s_dra_driver_tpu_torch/ops/gmm.py) against the
JAX package's ``ops/gmm.py``.

The same numpy inputs go through the JAX ``gmm`` (its Pallas kernels in
interpret mode on the CPU) and the port's ``gmm`` (its plain versions,
since the tensors lie on the CPU).  Outputs agree to 2e-5 and the
gradients (against ``jax.grad``) to 2e-4, the tolerances of
``tests/test_gmm.py``: both sides run f32 products and differ only in
summation order.  Expert ids per block and empty experts' zero dw are
exact.  The CUDA kernels K5/K6 cannot run here; ``chip_smoke.py`` holds
them against these plain versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.ops import gmm as jg
from k8s_dra_driver_tpu_torch.ops import gmm as tg

BM = 128
K_DIM, N_DIM = 96, 160
TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)

# group sizes (multiples of BM) and the static row count M >= their sum
LAYOUTS = {
    "even": ([BM, BM, BM, BM], 4 * BM),
    "with-empty": ([2 * BM, 0, BM, BM], 4 * BM),
    "one-hot": ([0, 0, 4 * BM, 0], 4 * BM),
    "dead-tail": ([BM, 0, 2 * BM, 0], 6 * BM),
    "all-dead": ([0, 0, 0, 0], 2 * BM),
}


def setup(groups, m, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, K_DIM)).astype(np.float32)
    live = int(sum(groups))
    x[live:] = 0.0          # the routing layer's padding rows are zero
    w = rng.standard_normal((len(groups), K_DIM, N_DIM)).astype(np.float32)
    return x, w, np.asarray(groups, np.int32)


def t(a, **kw):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(
        kw.get("grad", False))


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_block_experts_equal_jax(name):
    groups, m = LAYOUTS[name]
    gs = np.asarray(groups, np.int32)
    want = np.asarray(jg._block_experts(jnp.asarray(gs), m // BM, BM))
    got = tg._block_experts(torch.from_numpy(gs), m // BM, BM)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(tg._live_blocks(torch.from_numpy(gs), BM)) == \
        int(gs.sum()) // BM


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_gmm_equals_jax(name):
    groups, m = LAYOUTS[name]
    x, w, gs = setup(groups, m)
    want = np.asarray(jg.gmm(jnp.asarray(x), jnp.asarray(w),
                             jnp.asarray(gs), BM))
    got = tg.gmm(t(x), t(w), t(gs), BM)
    assert got.dtype == torch.float32 and got.shape == (m, N_DIM)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    live = int(gs.sum())
    assert torch.count_nonzero(got[live:]) == 0


@pytest.mark.parametrize("name", ["with-empty", "dead-tail"])
def test_transposed_read_equals_jax_swapaxes(name):
    """dx's form: w stored [E, N, K] and read transposed equals the JAX
    ``gmm`` on the swapped experts, with K and N in both orders."""
    groups, m = LAYOUTS[name]
    x, w, gs = setup(groups, m, seed=1)
    dy = np.random.default_rng(2).standard_normal(
        (m, N_DIM)).astype(np.float32)
    want = np.asarray(jg.gmm(jnp.asarray(dy),
                             jnp.swapaxes(jnp.asarray(w), 1, 2),
                             jnp.asarray(gs), BM))
    got = tg.gmm_forward(t(dy), t(w), t(gs), BM, transpose_w=True)
    assert got.shape == (m, K_DIM)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    again = tg.gmm_forward(t(dy), t(np.swapaxes(w, 1, 2)), t(gs), BM)
    np.testing.assert_array_equal(got.numpy(), again.numpy())


@pytest.mark.parametrize("name", ["even", "with-empty", "dead-tail"])
def test_grads_equal_jax_grad(name):
    groups, m = LAYOUTS[name]
    x, w, gs = setup(groups, m, seed=3)
    probe = np.random.default_rng(4).standard_normal(
        (m, N_DIM)).astype(np.float32)

    def loss(x, w):
        return jnp.sum(jg.gmm(x, w, jnp.asarray(gs), BM) * probe)

    jdx, jdw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                              jnp.asarray(w))
    tx, tw = t(x, grad=True), t(w, grad=True)
    (tg.gmm(tx, tw, t(gs), BM) * t(probe)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx),
                               **GRAD_TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw),
                               **GRAD_TOL)


def test_dw_of_an_empty_expert_is_exactly_zero():
    groups, m = LAYOUTS["dead-tail"]
    x, _, gs = setup(groups, m, seed=5)
    dy = np.random.default_rng(6).standard_normal(
        (m, N_DIM)).astype(np.float32)
    dw = tg.gmm_dw(t(x), t(dy), t(gs), BM)
    assert dw.dtype == torch.float32 and dw.shape == (4, K_DIM, N_DIM)
    for e in np.flatnonzero(gs == 0):
        assert torch.count_nonzero(dw[e]) == 0
    # a live expert's dw is x_e^T dy_e over its own rows only
    np.testing.assert_allclose(dw[2].numpy(), x[BM:3 * BM].T @ dy[BM:3 * BM],
                               rtol=1e-5, atol=1e-4)


def test_dw_equals_jax_gmm_dw():
    groups, m = LAYOUTS["with-empty"]
    x, _, gs = setup(groups, m, seed=7)
    dy = np.random.default_rng(8).standard_normal(
        (m, N_DIM)).astype(np.float32)
    want = np.asarray(jg._gmm_dw(jnp.asarray(x), jnp.asarray(dy),
                                 jnp.asarray(gs), block_m=BM))
    got = tg.gmm_dw(t(x), t(dy), t(gs), BM)
    np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL)


def test_bf16_rounds_like_jax():
    """bf16 inputs: f32 sums, output rounded to bf16 — one bf16 step
    (2^-8 relative) at most between the two packages."""
    groups, m = LAYOUTS["with-empty"]
    x, w, gs = setup(groups, m, seed=9)
    want = np.asarray(jg.gmm(jnp.asarray(x, jnp.bfloat16),
                             jnp.asarray(w, jnp.bfloat16),
                             jnp.asarray(gs), BM), np.float32)
    got = tg.gmm(t(x).to(torch.bfloat16), t(w).to(torch.bfloat16), t(gs),
                 BM)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               rtol=2 ** -7, atol=2 ** -7)


def test_unaligned_rows_raise_as_in_jax():
    groups, m = LAYOUTS["even"]
    x, w, gs = setup(groups, m)
    with pytest.raises(ValueError, match="block_m") as jerr:
        jg.gmm(jnp.asarray(x[:-1]), jnp.asarray(w), jnp.asarray(gs), BM)
    with pytest.raises(ValueError, match="block_m") as terr:
        tg.gmm(t(x[:-1]), t(w), t(gs), BM)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="block_m"):
        tg.gmm_dw(t(x[:-1]), t(x[:-1]), t(gs), BM)


@pytest.mark.parametrize("bad,match", [
    (dict(x_dtype=torch.float16), "float32 or bfloat16"),
    (dict(w_dtype=torch.bfloat16), "w is torch.bfloat16"),
    (dict(block_m=96), "multiple of 64"),
    (dict(transposed=True), "contiguous"),
])
def test_kernel_arguments_are_checked(bad, match):
    """What the kernels refuse is refused before any launch."""
    x = torch.zeros((192, 64), dtype=bad.get("x_dtype", torch.float32))
    w = torch.zeros((2, 64, 32), dtype=bad.get("w_dtype", x.dtype))
    if bad.get("transposed"):
        w = torch.zeros((2, 32, 64)).transpose(1, 2)
    with pytest.raises(ValueError, match=match):
        tg._kernel_args(x, {"w": w}, torch.tensor([96, 96]),
                        bad.get("block_m", 64), "gmm")


def test_shape_checks_and_foreign_devices():
    x = torch.zeros((128, 8))
    with pytest.raises(ValueError, match="does not match"):
        tg.gmm_forward(x, torch.zeros((2, 9, 4)), torch.tensor([128, 0]))
    with pytest.raises(ValueError, match="group_sizes"):
        tg.gmm_forward(x, torch.zeros((2, 8, 4)), torch.tensor([128]))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tg.gmm_forward(x.to("meta"), torch.zeros((2, 8, 4), device="meta"),
                       torch.tensor([128, 0], device="meta"))


def test_picker_fits_the_kernel_tile_and_counters_start_at_zero():
    for shape in ((512, 4096, 16), (4096, 512, 16), (64, 128, 4)):
        bm = tg.pick_gmm_blocks(*shape, rows=32)["block_m"]
        assert bm % tg.TILE_M == 0
    assert set(tg.launches) == {"gmm", "gmm_dw"}
    before = dict(tg.launches)
    groups, m = LAYOUTS["even"]
    x, w, gs = setup(groups, m)
    tx, tw = t(x, grad=True), t(w, grad=True)
    tg.gmm(tx, tw, t(gs), BM).sum().backward()
    assert tg.launches == before         # CPU calls never count


@pytest.mark.parametrize("dtype,route", [
    (torch.bfloat16, "tensor_cores"),
    (torch.float32, "cuda_cores"),
])
def test_route_picker_sends_each_dtype_to_its_kernel(dtype, route):
    assert tg.gmm_route(dtype) == route


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64,
                                   torch.int8])
def test_route_picker_refuses_what_no_route_takes(dtype):
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tg.gmm_route(dtype)


# (K, N, block_m, transpose_w) the tensor-core K5 refuses: K or N not a
# whole tile, block_m other than its 128-row tile
TC_REFUSED = {
    "k_not_64": (96, 256, 128, False, "K a multiple of 64"),
    "n_not_128": (128, 192, 128, False, "N of 128"),
    "n_not_128_transposed": (128, 64, 128, True, "N of 128"),
    "block_m_64": (128, 256, 64, False, "block_m 128"),
    "block_m_256": (128, 256, 256, False, "block_m 128"),
}


@pytest.mark.parametrize("name", sorted(TC_REFUSED))
def test_tensor_core_arguments_are_checked(name):
    """What the tensor-core K5 refuses is refused before any launch,
    with no fallback to the CUDA-core route, and counts nothing."""
    k_dim, n_dim, bm, tr, match = TC_REFUSED[name]
    x = torch.zeros((512, k_dim), dtype=torch.bfloat16)
    shape = (2, n_dim, k_dim) if tr else (2, k_dim, n_dim)
    w = torch.zeros(shape, dtype=torch.bfloat16)
    before = (dict(tg.launches), tg.tc_launches)
    with pytest.raises(ValueError, match=match):
        tg._launch_gmm(x, w, torch.tensor([256, 256]), bm, tr, n_dim)
    assert (tg.launches, tg.tc_launches) == before


@pytest.mark.parametrize("x_dtype,w_dtype", [
    (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16),
])
def test_tensor_core_checker_refuses_mixed_dtypes(x_dtype, w_dtype):
    x = torch.zeros((256, 128), dtype=x_dtype)
    w = torch.zeros((2, 128, 128), dtype=w_dtype)
    with pytest.raises(ValueError, match="bfloat16 x and w"):
        tg._tc_args(x, w, tg.TC_BLOCK_M, 128)
    with pytest.raises(ValueError, match="w is"):
        tg._launch_gmm(x, w, torch.tensor([128, 128]), tg.TC_BLOCK_M,
                       False, 128)


@pytest.mark.parametrize("transpose_w", [False, True])
@pytest.mark.parametrize("name", ["with-empty", "dead-tail"])
def test_bf16_at_the_tensor_core_tiles_equals_jax(name, transpose_w):
    """bf16 at shapes the tensor-core K5 takes (K 128, N 256, block_m
    128), both orientations: the plain version it is held against sums
    in f32 and rounds once, as the JAX kernels do, so the two packages
    part by at most one bf16 step."""
    groups, m = LAYOUTS[name]
    rng = np.random.default_rng(11)
    x = rng.standard_normal((m, 128)).astype(np.float32)
    x[int(sum(groups)):] = 0.0
    w = rng.standard_normal((len(groups), 128, 256)).astype(np.float32)
    w_call = np.swapaxes(w, 1, 2) if transpose_w else w
    gs = np.asarray(groups, np.int32)
    want = np.asarray(jg.gmm(jnp.asarray(x, jnp.bfloat16),
                             jnp.asarray(w, jnp.bfloat16),
                             jnp.asarray(gs), BM), np.float32)
    tg._tc_args(t(x).to(torch.bfloat16), t(w_call).to(torch.bfloat16),
                BM, 256)
    got = tg.gmm_forward(t(x).to(torch.bfloat16),
                         t(w_call).to(torch.bfloat16), t(gs), BM,
                         transpose_w=transpose_w)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               rtol=2 ** -7, atol=2 ** -7)
    assert not got[int(sum(groups)):].any()


# ---------------------------------------------------------------------------
# K6 routes: bf16 on the tensor cores (csrc/gmm_dw_sm90.cu), f32 on the
# CUDA cores (csrc/gmm.cu)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,route", [
    (torch.bfloat16, "tensor_cores"),
    (torch.float32, "cuda_cores"),
])
def test_dw_route_sends_each_dtype_to_its_kernel(dtype, route):
    assert tg.dw_route(dtype) == route


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64,
                                   torch.int8])
def test_dw_route_refuses_what_no_route_takes(dtype):
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tg.dw_route(dtype)


# (K, N, block_m) the tensor-core K6 refuses: K or N not a whole
# 128-column tile, block_m other than 128
TC_DW_REFUSED = {
    "k_not_128": (192, 256, 128, "K and N multiples of 128"),
    "n_not_128": (128, 320, 128, "K and N multiples of 128"),
    "block_m_64": (128, 256, 64, "block_m 128"),
    "block_m_256": (128, 256, 256, "block_m 128"),
}


@pytest.mark.parametrize("name", sorted(TC_DW_REFUSED))
def test_tensor_core_dw_arguments_are_checked(name):
    """What the tensor-core K6 refuses is refused before any launch,
    with no fallback to the CUDA-core route, and counts nothing."""
    k_dim, n_dim, bm, match = TC_DW_REFUSED[name]
    x = torch.zeros((512, k_dim), dtype=torch.bfloat16)
    dy = torch.zeros((512, n_dim), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        tg._tc_dw_args(x, dy, bm)
    before = (dict(tg.launches), tg.dw_tc_launches)
    with pytest.raises(ValueError, match=match):
        tg._launch_dw(x, dy, torch.tensor([256, 256]), bm, torch.float32)
    assert (tg.launches, tg.dw_tc_launches) == before


@pytest.mark.parametrize("x_dtype,dy_dtype", [
    (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16),
])
def test_tensor_core_dw_checker_refuses_mixed_dtypes(x_dtype, dy_dtype):
    x = torch.zeros((256, 128), dtype=x_dtype)
    dy = torch.zeros((256, 128), dtype=dy_dtype)
    with pytest.raises(ValueError, match="bfloat16 x and dy"):
        tg._tc_dw_args(x, dy, tg.TC_BLOCK_M)
    with pytest.raises(ValueError, match="dy is"):
        tg._launch_dw(x, dy, torch.tensor([128, 128]), tg.TC_BLOCK_M,
                      torch.float32)


# group sizes at the tensor-core K6's tiles (E = 4, block_m 128)
DW_TC_LAYOUTS = {
    "hot-expert": ([0, 6 * BM, 0, 0], 6 * BM),
    "empty-experts": ([2 * BM, 0, 0, 2 * BM], 4 * BM),
    "dead-tail": ([BM, BM, 0, BM], 6 * BM),
}


@pytest.mark.parametrize("k_dim,n_dim", [(128, 128), (128, 256),
                                         (256, 128)])
@pytest.mark.parametrize("name", sorted(DW_TC_LAYOUTS))
def test_dw_reference_in_bf16_equals_jax_at_tensor_core_tiles(name, k_dim,
                                                              n_dim):
    """bf16 x and dy at shapes the tensor-core K6 takes: the plain
    version it is held against on the card equals the interpreted
    Pallas ``_gmm_dw`` (bf16 products exact in f32, f32 sums in another
    order) within 1e-5 of max(1, max|ref|); empty experts exact zeros;
    its bf16 output (the backward's) is its f32 output rounded."""
    groups, m = DW_TC_LAYOUTS[name]
    rng = np.random.default_rng(13)
    live = int(sum(groups))
    x = rng.standard_normal((m, k_dim)).astype(np.float32)
    dy = rng.standard_normal((m, n_dim)).astype(np.float32)
    x[live:] = 0.0
    dy[live:] = rng.standard_normal((m - live, n_dim))  # dead rows unread
    gs = np.asarray(groups, np.int32)
    xb, dyb = t(x).to(torch.bfloat16), t(dy).to(torch.bfloat16)
    tg._tc_dw_args(xb, dyb, BM)
    want = np.asarray(jg._gmm_dw(jnp.asarray(x, jnp.bfloat16),
                                 jnp.asarray(dy, jnp.bfloat16),
                                 jnp.asarray(gs), block_m=BM,
                                 interpret=True))
    got = tg.gmm_dw(xb, dyb, t(gs), BM)
    assert got.dtype == torch.float32
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale
    for e in np.flatnonzero(gs == 0):
        assert torch.count_nonzero(got[e]) == 0
    direct = tg.gmm_dw(xb, dyb, t(gs), BM, out_dtype=torch.bfloat16)
    assert torch.equal(direct, got.to(torch.bfloat16))


def test_backward_dw_takes_w_dtype_directly():
    """The backward asks K6 for w's dtype: in bf16 its dw is the f32
    plain dw rounded once."""
    groups, m = DW_TC_LAYOUTS["dead-tail"]
    rng = np.random.default_rng(14)
    x = t(rng.standard_normal((m, 128)).astype(np.float32)).to(
        torch.bfloat16).requires_grad_(True)
    w = t(rng.standard_normal((4, 128, 128)).astype(np.float32)).to(
        torch.bfloat16).requires_grad_(True)
    gs = t(np.asarray(groups, np.int32))
    probe = torch.from_numpy(rng.standard_normal((m, 128)).astype(
        np.float32)).to(torch.bfloat16)
    (tg.gmm(x, w, gs, BM).float() * probe.float()).sum().backward()
    dy = probe  # d(sum(out * probe)) / d out, cast to out's dtype
    want = tg.gmm_dw_reference(x.detach(), dy, gs, BM).to(torch.bfloat16)
    assert w.grad.dtype == torch.bfloat16
    assert torch.equal(w.grad, want)
