"""K2's planner and split-and-merge algorithm
(k8s_dra_driver_tpu_torch/ops/paged_attention.py ``paged_plan``,
``paged_attention_split``, ``merge_partials``) against the JAX package.

On the card K2 (``csrc/paged_decode.cu``) cuts each row's table into the
planner's spans of whole pages, one block per (split, row, head group);
each live block keeps an f32 partial softmax state (o unnormalized, m,
l) over its span and the last block of a row folds the partials in
split order.  The kernel cannot run here: this file holds the plan's
arithmetic, and the same algorithm in plain PyTorch against JAX's
interpreted Pallas kernel at 2e-4 (the JAX kernel test's bound) and
against ``paged_attention_reference`` at 1e-5 (another order of f32
sums).  ``chip_smoke.py`` holds the kernel to its plain version on the
card.
"""

import importlib
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from k8s_dra_driver_tpu_torch.ops import _build
from k8s_dra_driver_tpu_torch.ops import paged_attention as tpa

jfa = importlib.import_module("k8s_dra_driver_tpu.ops.flash_attention")
jpa = importlib.import_module("k8s_dra_driver_tpu.ops.paged_attention")

ATOL = 1e-5
SMS = 132
DTYPES = (torch.bfloat16, torch.float32)
#: the small head dims the kernel takes beside 64 and 128 (the JAX
#: package's probe models)
SMALL_DIMS = (8, 16, 32)


def min_span_pages(d, bs, dtype):
    """The shortest span the planner gives: one chunk (2 KB of K, at
    most 32 tokens: one a lane) for each of the block's 4 warps."""
    es = torch.tensor([], dtype=dtype).element_size()
    return -(-4 * min(2048 // (d * es), 32) // bs)


PLAN_SHAPES = [
    # (b, h_kv, group, d, bs, n_pages)
    (8, 4, 4, 64, 16, 128),       # the 154M's paged step
    (8, 4, 4, 128, 16, 128),      # the 660M's head
    (1, 4, 4, 64, 16, 128),       # one 2048-token row
    (1, 1, 1, 64, 16, 128),
    (2, 2, 2, 64, 4, 33),         # two heads a block, ragged last span
    (3, 3, 6, 128, 5, 7),
    (4, 8, 1, 64, 16, 2048),
    (33, 4, 4, 64, 16, 128),      # 132 (row, head) blocks: one split
    (64, 8, 2, 128, 16, 64),
    (1, 1, 3, 64, 16, 1),         # one page
    (6, 4, 2, 16, 16, 3),         # the paged-KV probe's step (D=16)
    (2, 2, 2, 8, 8, 6),           # the crucible's paged replica (D=8)
    (1, 4, 2, 8, 16, 128),
    (8, 8, 1, 32, 16, 8),         # the tier probe's engine (D=32)
    (1, 1, 1, 16, 4, 33),
]


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("b,h_kv,group,d,bs,n_pages", PLAN_SHAPES)
def test_plan_covers_the_table_once_in_whole_pages(b, h_kv, group, d, bs,
                                                    n_pages, dtype):
    plan = tpa.paged_plan(b, h_kv, group, d, bs, n_pages, dtype)
    # the most heads of one KV head a block takes: 4, 2 or 1
    assert plan.heads_per_block == next(k for k in (4, 2, 1)
                                        if group % k == 0)
    assert 1 <= plan.pages_per_split <= n_pages
    assert ((plan.splits - 1) * plan.pages_per_split < n_pages
            <= plan.splits * plan.pages_per_split)
    rows = b * h_kv * group // plan.heads_per_block
    assert plan.blocks == rows * plan.splits
    assert plan.blocks <= 2**31 - 1          # a 1-D grid's limit
    if rows >= SMS:
        assert plan.splits == 1
    else:
        # two waves of blocks, unless spans would be shorter than a
        # chunk a warp (or than the table)
        assert (plan.blocks >= 2 * SMS or plan.pages_per_split
                == min(n_pages, min_span_pages(d, bs, dtype)))


@pytest.mark.parametrize("b,h_kv", [(33, 4), (64, 4), (132, 1), (256, 8)])
def test_plan_keeps_one_split_when_rows_fill_the_card(b, h_kv):
    plan = tpa.paged_plan(b, h_kv, 4, 64, 16, 128, torch.bfloat16)
    assert plan.splits == 1 and plan.pages_per_split == 128


@pytest.mark.parametrize("d,dtype", [(64, torch.bfloat16),
                                     (128, torch.bfloat16),
                                     (64, torch.float32)]
                         + [(d, dt) for d in SMALL_DIMS for dt in DTYPES])
def test_plan_splits_a_long_single_row(d, dtype):
    plan = tpa.paged_plan(1, 4, 4, d, 16, 2048 // 16, dtype)
    assert plan.splits >= 8
    assert plan.pages_per_split == min_span_pages(d, 16, dtype)


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tpa.paged_plan(8, 4, 4, 64, 16, 128, torch.float16)


def paged_case(seed, b, h, h_kv, d, bs, n_pages, lengths):
    """Random pool and shuffled block tables whose slots past each
    row's length point at the null block 0."""
    rng = np.random.default_rng(seed)
    nb = b * n_pages + 1
    k_pool = rng.standard_normal((nb, bs, h_kv, d), np.float32)
    v_pool = rng.standard_normal((nb, bs, h_kv, d), np.float32)
    q = rng.standard_normal((b, h, d), np.float32)
    perm = rng.permutation(nb - 1) + 1
    tables = perm[:b * n_pages].reshape(b, n_pages).astype(np.int32)
    lengths = np.asarray(lengths, np.int32)
    for i in range(b):
        tables[i, -(-int(lengths[i]) // bs):] = 0
    return q, k_pool, v_pool, tables, lengths


def plan_of(pages_per_split, b, h, h_kv, n_pages):
    group = h // h_kv
    heads = next(k for k in (4, 2, 1) if group % k == 0)
    splits = -(-n_pages // pages_per_split)
    return tpa.PagedPlan(heads, pages_per_split, splits,
                         b * h // heads * splits)


# b=4, bs=4, n_pages=8 (32 keys a row); spans of 8 (one split), 4 (two),
# 3 (three, the last ragged) and 1 (eight) pages.  The lengths hold one
# key, ends on a span's end (the next span empty: 12 at spans of 3, 16
# at spans of 4, 8 at every span but 3), rows whose later spans are all
# empty, full rows, and null-block tails.
SPLIT_CASES = {
    "one_split": (8, [1, 12, 8, 32]),
    "two_splits": (4, [16, 5, 1, 32]),
    "ragged_splits": (3, [12, 24, 13, 32]),
    "many_splits": (1, [1, 4, 17, 32]),
}


@pytest.mark.parametrize("d", SMALL_DIMS)
@pytest.mark.parametrize("h,h_kv", [(8, 2), (4, 4), (6, 3)],
                         ids=["gqa4", "mha", "gqa2"])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_and_merge_matches_jax(name, h, h_kv, d):
    pages, lengths = SPLIT_CASES[name]
    b, bs, n_pages = 4, 4, 8
    plan = plan_of(pages, b, h, h_kv, n_pages)
    case = paged_case(len(name) * 13 + h, b, h, h_kv, d, bs, n_pages,
                      lengths)
    args = [jnp.asarray(a) for a in case]
    want_kernel = jpa.paged_attention(*args, interpret=True)
    tensors = [torch.from_numpy(a) for a in case]
    got = tpa.paged_attention_split(*tensors, plan)
    ref = tpa.paged_attention_reference(*tensors)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel),
                               atol=2e-4)  # the JAX kernel test's bound
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL)


@pytest.mark.parametrize("d", (64,) + SMALL_DIMS)
@pytest.mark.parametrize("pages", [1, 2, 5, 15])
def test_split_and_merge_on_the_planners_spans(pages, d):
    """The planner's own plan and hand-made ones at the serving step's
    widths (16 heads, 4 KV heads, D=64 and the small dims, bs=16),
    lengths 1 to 120."""
    b, h, h_kv, bs, n_pages = 4, 16, 4, 16, 16
    case = paged_case(pages, b, h, h_kv, d, bs, n_pages, [1, 16, 80, 120])
    tensors = [torch.from_numpy(a) for a in case]
    ref = tpa.paged_attention_reference(*tensors)
    for plan in (plan_of(pages, b, h, h_kv, n_pages),
                 tpa.paged_plan(b, h_kv, h // h_kv, d, bs, n_pages,
                                torch.float32)):
        got = tpa.paged_attention_split(*tensors, plan)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL)


@pytest.mark.parametrize("d", (64,) + SMALL_DIMS)
def test_split_and_merge_rounds_bf16_once(d):
    """bf16 q and pools: f32 partials, one rounding of the output; the
    reference rounds once too, so the two stay within one bf16 step."""
    b, h, h_kv, bs, n_pages = 2, 8, 2, 16, 8
    case = paged_case(5, b, h, h_kv, d, bs, n_pages, [17, 128])
    tensors = [torch.from_numpy(a).to(torch.bfloat16) if a.dtype ==
               np.float32 else torch.from_numpy(a) for a in case]
    plan = plan_of(2, b, h, h_kv, n_pages)
    got = tpa.paged_attention_split(*tensors, plan)
    ref = tpa.paged_attention_reference(*tensors)
    assert got.dtype == torch.bfloat16
    scale = max(1.0, ref.float().abs().max().item())
    assert (got.float() - ref.float()).abs().max().item() <= 2**-7 * scale


def stats(rng, shape, d, empty):
    """A partial (o [B, Tq, H, D], m, l [B, H, Tq]) with the entries
    marked ``empty`` holding the empty state."""
    m = rng.standard_normal(shape).astype(np.float32) * 3
    l = rng.uniform(0.5, 4.0, shape).astype(np.float32)
    o = rng.standard_normal(shape + (d,)).astype(np.float32)
    m[empty], l[empty], o[empty] = -np.inf, 0.0, 0.0
    return o.transpose(0, 2, 1, 3), m, l


def torch_merge(a, b):
    """merge_partials on JAX's layout: o [B,Tq,H,D], m/l [B,H,Tq]."""
    (o, m, l), (o2, m2, l2) = a, b
    to = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    got = tpa.merge_partials(to(o.transpose(0, 2, 1, 3)), to(m), to(l),
                             to(o2.transpose(0, 2, 1, 3)), to(m2), to(l2))
    return (got[0].numpy().transpose(0, 2, 1, 3), got[1].numpy(),
            got[2].numpy())


@pytest.mark.parametrize("seed", range(3))
def test_merge_partials_matches_jax_where_one_side_is_finite(seed):
    rng = np.random.default_rng(seed)
    shape, d = (2, 3, 5), 8
    # each side empty at a quarter of the entries, never both
    side = rng.integers(0, 4, shape)
    a = stats(rng, shape, d, side == 0)
    b = stats(rng, shape, d, side == 1)
    want = jfa.merge_flash_stats(*[jnp.asarray(x) for x in a + b])
    got = torch_merge(a, b)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("empty_first", [True, False])
def test_merge_partials_returns_the_other_side_when_one_is_empty(
        empty_first):
    rng = np.random.default_rng(7)
    shape, d = (2, 3, 5), 8
    full = stats(rng, shape, d, np.zeros(shape, bool))
    empty = stats(rng, shape, d, np.ones(shape, bool))
    got = torch_merge(empty, full) if empty_first else torch_merge(full,
                                                                   empty)
    for g, w in zip(got, full):
        assert np.array_equal(g, w)          # bit for bit


def test_merge_partials_keeps_two_empty_sides_empty():
    rng = np.random.default_rng(8)
    shape, d = (1, 2, 3), 4
    empty = stats(rng, shape, d, np.ones(shape, bool))
    o, m, l = torch_merge(empty, empty)
    assert not np.isnan(o).any() and not np.isnan(l).any()
    assert (m == -np.inf).all() and (l == 0).all() and (o == 0).all()


def test_chip_smoke_cases_reach_the_merge_and_span_ends():
    """The card's K2 cases hold rows over several splits (the last-block
    merge), rows ending exactly on a span's end, and rows of one key."""
    multi, on_end, one_key = 0, 0, 0
    for _, lengths, d, dtype in chip_smoke.paged_cases(tpa):
        plan = tpa.paged_plan(len(lengths), 4, 4, d, 16, 128, dtype)
        span = plan.pages_per_split * 16
        multi += sum(-(-n // span) > 1 for n in lengths)
        on_end += sum(n % span == 0 and n < 2048 for n in lengths)
        one_key += sum(n == 1 for n in lengths)
    assert multi and on_end and one_key


def test_paged_signature_matches_the_c_entry():
    """The ctypes argument list of ``paged_decode`` follows the C
    prototype: pointers, then ints, the scale, the dtype, the stream."""
    src = (_build._CSRC / "paged_decode.cu").read_text()
    proto = re.search(r'extern "C" int paged_decode\((.*?)\)', src,
                      re.S).group(1)
    kinds = []
    for arg in proto.split(","):
        arg = arg.strip()
        kinds.append(_build._VP if "*" in arg else
                     _build._F if arg.startswith("float") else _build._I)
    assert kinds == _build._SIGNATURES["paged_decode"]


@pytest.mark.parametrize("d", (64,) + SMALL_DIMS)
def test_cpu_calls_take_the_reference_and_never_launch(d):
    case = paged_case(3, 2, 8, 2, d, 16, 4, [5, 64])
    tensors = [torch.from_numpy(a) for a in case]
    before = tpa.launches
    got = tpa.paged_attention(*tensors)
    assert tpa.launches == before
    assert torch.equal(got, tpa.paged_attention_reference(*tensors))
    assert math.isfinite(got.abs().max().item())
