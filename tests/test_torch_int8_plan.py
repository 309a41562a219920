"""K7's routes and split-K planner (k8s_dra_driver_tpu_torch/models/quant.py
``int8_route``, ``int8_plan``) and the split sum the kernel computes,
against the JAX package's models/quant.py.

On the card K7 (``csrc/int8_matmul_sm90.cu``) cuts K into the planner's
chunks, writes each chunk's f32 product as a partial tile, and a second
pass adds the partials in slice order, applies the per-channel scale and
rounds once to x's dtype.  The kernel cannot run here; this file holds
the planner's arithmetic for every shape ``chip_smoke.py`` checks, and a
numpy emulation of the split sum against JAX's interpreted
``int8_matmul`` and ``int8_bmm`` (1e-2 of max(1, max|ref|) in bf16: one
rounding of the output, 1e-5 in f32: another order of f32 sums).
``chip_smoke.py`` holds the kernel to its plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from k8s_dra_driver_tpu.models import quant as jq
from k8s_dra_driver_tpu_torch.models import quant as tq

SMS = 132
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
DTYPES = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


@pytest.mark.parametrize("dtype,route", [
    (torch.bfloat16, "tensor_cores"),
    (torch.float32, "cuda_cores"),
])
def test_int8_route_sends_each_dtype_to_its_kernel(dtype, route):
    assert tq.int8_route(dtype) == route


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64,
                                   torch.int8])
def test_int8_route_refuses_what_no_route_takes(dtype):
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tq.int8_route(dtype)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tq.int8_plan(1, 8, 1024, 1024, dtype)


def _cases():
    out = []
    for kind, m, k, n, label in chip_smoke.int8_cases():
        g = 16 if kind == "K7b" else 1
        for dtype in (torch.bfloat16, torch.float32):
            out.append(pytest.param(g, m, k, n, dtype,
                                    id=f"{kind}-{m}x{k}x{n}-{label}-"
                                       f"{str(dtype)[6:]}"))
    return out


@pytest.mark.parametrize("g,m,k,n,dtype", _cases())
def test_plan_covers_k_and_fills_the_card(g, m, k, n, dtype):
    plan = tq.int8_plan(g, m, k, n, dtype)
    steps = -(-k // tq.INT8_K_STEP)
    tiles = g * -(-m // plan.m_tile) * -(-n // plan.n_tile)
    # chunks of whole k steps cover K exactly once, the last one ragged
    assert plan.k_chunk % tq.INT8_K_STEP == 0
    assert (plan.splits - 1) * plan.k_chunk < k <= plan.splits * plan.k_chunk
    assert plan.blocks == tiles * plan.splits
    assert plan.m_tile == tq.INT8_TILE_M[tq.int8_route(dtype)]
    if tiles >= SMS:
        assert plan.splits == 1     # the n tiles alone fill the card
    else:
        # two waves of blocks, or one k step a chunk where K is short
        assert plan.blocks >= 2 * SMS or plan.splits == steps
    if (m, k, n) == (8, 1024, 32000):
        assert plan.splits == 1     # the 154M unembedding
    # the deep register ring: bf16 grids that fit at three blocks an SM
    # and whose warps walk at least three k16 steps
    deep = (dtype == torch.bfloat16 and plan.blocks <= 3 * SMS
            and plan.k_chunk >= 3 * tq.INT8_K_STEP)
    assert plan.ring == (3 if deep else 2)


def test_ragged_case_splits_with_ragged_edges():
    """chip_smoke's ragged case runs on a split plan whose last chunk is
    short and whose N is no multiple of the 16 columns a lane loads."""
    plan = tq.int8_plan(1, 5, 1000, 333, torch.bfloat16)
    assert plan.splits > 1 and 1000 % plan.k_chunk and 333 % 16


def split_sum(x, q, scale, dtype):
    """The kernel's arithmetic in numpy: [G, M, K] x [G, K, N] int8, K
    cut by the planner, each chunk's product in f32, the partials added
    in slice order, times the scale, rounded once.  Returns (f32 before
    the rounding, the output in ``dtype``)."""
    g, m, k = x.shape
    n = q.shape[2]
    plan = tq.int8_plan(g, m, k, n, dtype)
    xf = torch.from_numpy(x).to(dtype).float().numpy()
    total = np.zeros((g, m, n), np.float32)
    for s in range(plan.splits):
        lo, hi = s * plan.k_chunk, min(k, (s + 1) * plan.k_chunk)
        part = np.einsum("gmk,gkn->gmn", xf[:, :, lo:hi],
                         q[:, lo:hi].astype(np.float32)).astype(np.float32)
        total = (total + part).astype(np.float32)
    f32 = (total * scale.reshape(g, 1, n)).astype(np.float32)
    return f32, torch.from_numpy(f32).to(dtype)


# (G, M, K, N): split and unsplit plans, ragged K and N, one row
SHAPES = [(1, 5, 1000, 333), (1, 8, 512, 256), (1, 1, 200, 130),
          (1, 20, 130, 260), (3, 5, 300, 130), (4, 8, 128, 384)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g,m,k,n", SHAPES)
def test_split_sum_equals_interpreted_pallas(g, m, k, n, dtype):
    rng = np.random.default_rng(g * 1000 + m + k + n)
    x = rng.standard_normal((g, m, k)).astype(np.float32)
    w = rng.standard_normal((g, k, n)).astype(np.float32)
    qt = jq.quantize(jnp.asarray(w), (1,))
    q, scale = np.array(qt.q), np.array(qt.scale)
    jx = jnp.asarray(x, DTYPES[dtype])
    if g == 1:
        want = jq.int8_matmul(jx[0], qt.q[0], qt.scale[0],
                              interpret=True)[None]
    else:
        want = jq.int8_bmm(jx, qt.q, qt.scale, interpret=True)
    want = np.asarray(want, np.float32)
    f32, got = split_sum(x, q, scale, dtype)
    assert got.dtype == dtype
    ref = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.float().numpy() - want).max()) <= \
        TOL[dtype] * ref
    # the output is the f32 sum rounded once, and equals the plain
    # version the card holds the kernel to
    assert torch.equal(got, torch.from_numpy(f32).to(dtype))
    plain = tq.int8_bmm_reference(torch.from_numpy(x).to(dtype),
                                  torch.from_numpy(q),
                                  torch.from_numpy(scale))
    assert float((plain.float() - got.float()).abs().max()) <= \
        TOL[dtype] * ref


def test_launch_refuses_other_dtypes_before_any_launch():
    x = torch.zeros((1, 4, 64), dtype=torch.float16)
    q = torch.zeros((1, 64, 32), dtype=torch.int8)
    before = (dict(tq.launches), tq.tc_launches)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tq._launch(x, q, torch.ones((1, 32)), torch.empty((1, 4, 32)),
                   "int8_bmm")
    assert (tq.launches, tq.tc_launches) == before
