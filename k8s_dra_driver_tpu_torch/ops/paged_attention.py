"""Paged-attention decode: the Hopper kernel K2 and its plain versions.

``paged_attention`` is the port of
``k8s_dra_driver_tpu/ops/paged_attention.py:paged_attention``: one
query token per row against the K/V pages its block table names.  On
a CUDA tensor it launches the hand-written kernel
``csrc/paged_decode.cu``, which replaces the TPU kernel
``_paged_decode_kernel`` (launched there by ``_paged_attention_call``);
on a CPU tensor it takes ``paged_attention_reference``, the block
gather + the exact ``models/decode._cached_attention`` masked-softmax
math, which keeps the paged engine bitwise equal to the contiguous one
on the CPU.

The kernel is memory-bound: its least time is the valid K/V bytes of
the step over the card's memory rate (see its source note).  It splits
each row's pages across blocks as :func:`paged_plan` says and merges
the partial softmax states in split order; ``paged_attention_split``
is that algorithm in plain PyTorch, and ``merge_partials`` its merge.

The kernel takes head dims 8, 16, 32, 64 and 128 (the JAX kernel
takes any, padding D to 128 lanes); its plan comes from
:func:`pick_decode_params`, through the autotune table
(``ops/autotune.py``), falling back to :func:`paged_plan`.

``launches`` counts kernel launches (CPU calls never count): one per
call, the merge included; ``dim_launches`` counts them again by
``("paged_decode", dtype, head dim)``.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from . import _build, autotune
from .ring_attention import _NEG_INF

#: kernel launches made by :func:`paged_attention` on CUDA tensors
launches = 0
#: the same launches by ("paged_decode", dtype name, head dim)
dim_launches: dict = {}

#: the head dims the kernel takes (the JAX kernel takes any)
_KERNEL_HEAD_DIMS = (8, 16, 32, 64, 128)
_SMS = 132
#: blocks a call aims for: about two waves on the card's SMs
_TARGET_BLOCKS = 2 * _SMS
#: the kernel's warps per block, K (or V) bytes of one warp's chunk,
#: and the most tokens a chunk holds (one a lane of a warp)
_WARPS = 4
_CHUNK_BYTES = 2048
_CHUNK_TOKENS = 32
_MAX_BLOCKS = 2**31 - 1


class PagedPlan(NamedTuple):
    """K2's grid for one call: query heads of one KV head a block, each
    row's table cut into ``splits`` spans of ``pages_per_split`` whole
    pages, and the blocks (splits x rows x head groups)."""

    heads_per_block: int
    pages_per_split: int
    splits: int
    blocks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def paged_plan(b: int, h_kv: int, group: int, d: int, bs: int,
               n_pages: int, dtype=torch.bfloat16) -> PagedPlan:
    """How K2 cuts a call with ``b`` rows, ``h_kv`` KV heads of
    ``group`` query heads, head dim ``d``, pages of ``bs`` tokens and
    tables ``n_pages`` wide, from shapes alone (the lengths stay on the
    card).  A block takes 4, 2 or 1 query heads of one KV head (the
    most that divides ``group``).  With at least one (row, head group)
    block an SM the table stays whole (one split); else it is cut into
    spans of whole pages for about two waves of blocks, no span shorter
    than one chunk for each of the block's warps.  The spans cover the
    table exactly once; the last may be shorter."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the paged kernel takes float32 or bfloat16, "
                         f"got {dtype}")
    heads = next(k for k in (4, 2, 1) if group % k == 0)
    rows = b * h_kv * (group // heads)
    per = n_pages
    if rows < _SMS:
        es = torch.tensor([], dtype=dtype).element_size()
        chunk = min(_CHUNK_BYTES // (d * es),     # tokens a warp's chunk
                    _CHUNK_TOKENS)
        per = max(_cdiv(n_pages, _cdiv(_TARGET_BLOCKS, rows)),
                  _cdiv(_WARPS * chunk, bs))
        per = min(per, n_pages)
    splits = _cdiv(n_pages, per)
    blocks = rows * splits
    if blocks > _MAX_BLOCKS:
        raise ValueError(f"the paged kernel's grid of {blocks} blocks "
                         f"passes CUDA's limit")
    return PagedPlan(heads, per, splits, blocks)


def _tuned_plan(params: dict, b: int, h_kv: int, group: int,
                n_pages: int, key: str) -> PagedPlan:
    """The plan of a table entry ``{"heads_per_block",
    "pages_per_split"}`` for this shape; raises ``ValueError`` naming
    ``key`` for an entry the kernel cannot take
    (``csrc/paged_decode.cu`` refuses the same plans)."""
    try:
        heads = int(params["heads_per_block"])
        per = int(params["pages_per_split"])
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"autotune entry {key}: want integer "
                         f"heads_per_block and pages_per_split, got "
                         f"{params}") from e
    if heads not in (1, 2, 4) or group % heads:
        raise ValueError(f"autotune entry {key}: heads_per_block {heads} "
                         f"is not 1, 2 or 4 dividing the group {group}")
    if not 1 <= per <= n_pages:
        raise ValueError(f"autotune entry {key}: pages_per_split {per} is "
                         f"not in [1, {n_pages}]")
    splits = _cdiv(n_pages, per)
    blocks = b * h_kv * (group // heads) * splits
    if blocks > _MAX_BLOCKS:
        raise ValueError(f"autotune entry {key}: a grid of {blocks} "
                         f"blocks passes CUDA's limit")
    return PagedPlan(heads, per, splits, blocks)


def pick_decode_params(b: int, h_kv: int, group: int, d: int, bs: int,
                       n_pages: int, dtype=torch.bfloat16) -> dict:
    """K2's plan at a shape, as a dict of :class:`PagedPlan`'s fields:
    from the autotune table (``ops/autotune.py``; kernel
    ``"paged_decode"``, the JAX package's shape key ``b,bs,d,g,hkv,nb``),
    whose entries tune ``heads_per_block`` and ``pages_per_split``,
    falling back to :func:`paged_plan`.  Host-only and cached per shape
    on the table; the kernel's launch takes its plan from here.  The
    port's counterpart of the JAX ``pick_decode_params``, whose only
    tunable is the Pallas grid's dimension semantics."""
    tuner = autotune.get_autotuner()

    def build() -> PagedPlan:
        key = autotune.shape_key(b=b, hkv=h_kv, g=group, d=d, bs=bs,
                                 nb=n_pages)
        choice = tuner.pick("paged_decode", key, dtype, default={})
        if choice.source == "default":
            return paged_plan(b, h_kv, group, d, bs, n_pages, dtype)
        return _tuned_plan(choice.params, b, h_kv, group, n_pages,
                           autotune.table_key("paged_decode", key, dtype,
                                              autotune.backend_key()))

    return tuner.memo(("paged_decode", b, h_kv, group, d, bs, n_pages,
                       dtype), build)._asdict()


def merge_partials(o, m, l, o2, m2, l2):
    """Fold the softmax partial ``(o2, m2, l2)`` into ``(o, m, l)``: ``o``
    unnormalized ``[..., D]``, ``m`` the running max and ``l`` the sum
    ``[...]``, all f32.  An empty partial (m = -inf, l = o = 0) leaves
    the other side unchanged, and two empty ones stay empty (no NaN);
    the kernel folds its warps and its splits the same way."""
    m_new = torch.maximum(m, m2)
    safe = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
    ca, cb = torch.exp(m - safe), torch.exp(m2 - safe)
    return (o * ca[..., None] + o2 * cb[..., None], m_new,
            l * ca + l2 * cb)


def _validate(q, k_pool, v_pool, tables, lengths):
    if q.ndim != 3:
        raise ValueError(f"q must be [B, H, D], got {tuple(q.shape)}")
    if k_pool.ndim != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"pools must be matching [n_blocks, block_size, H_kv, D], "
            f"got {tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    b, h, d = q.shape
    nb, bs, h_kv, dk = k_pool.shape
    if dk != d:
        raise ValueError(f"head dim mismatch: q {d} vs pool {dk}")
    if h % h_kv:
        raise ValueError(f"query heads {h} not a multiple of kv heads "
                         f"{h_kv}")
    if tables.shape[0] != b or tables.ndim != 2:
        raise ValueError(f"tables must be [B, n] int32, got "
                         f"{tuple(tables.shape)}")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths must be [B], got "
                         f"{tuple(lengths.shape)}")
    return b, h, d, bs, h_kv, h // h_kv


def paged_attention_reference(q, k_pool, v_pool, tables, lengths,
                              scale: float | None = None):
    """Dense oracle: block-gathered view + the exact
    ``_cached_attention`` masked-softmax math (same einsum order and
    dtypes).

    q ``[B, H, D]``; pools ``[n_blocks, bs, H_kv, D]``; tables
    ``[B, n]``; ``lengths`` [B] = valid keys per row.  Returns
    ``[B, H, D]``."""
    b, h, d, bs, h_kv, group = _validate(q, k_pool, v_pool, tables,
                                         lengths)
    if scale is None:
        scale = d ** -0.5
    n = tables.shape[1]
    idx = tables.long()
    k_cache = k_pool[idx].reshape(b, n * bs, h_kv, d)
    v_cache = v_pool[idx].reshape(b, n * bs, h_kv, d)
    key_pos = torch.arange(n * bs, device=q.device)
    # junk gathered rows (partial tails, null-block pages) are masked
    # to exact softmax zeros, so the gather is value-transparent
    mask = key_pos[None, None, :] < lengths.long()[:, None, None]
    qg = q[:, None].reshape(b, 1, h_kv, group, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k_cache.float()) * scale
    scores = scores.masked_fill(~mask[:, None, None], _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v_cache.float())
    return o.reshape(b, 1, h, d).to(q.dtype)[:, 0]


def paged_attention_split(q, k_pool, v_pool, tables, lengths,
                          plan: PagedPlan, scale: float | None = None):
    """The kernel's split-and-merge algorithm in plain PyTorch: each
    span of ``plan.pages_per_split`` pages gives an f32 partial
    (o unnormalized, m, l) per query head, over its valid keys only
    (a span past the row's length is empty), and :func:`merge_partials`
    folds them in split order.  Only the normalized output is rounded
    to q's dtype.  Same arguments and result as
    :func:`paged_attention_reference`."""
    b, h, d, bs, h_kv, group = _validate(q, k_pool, v_pool, tables,
                                         lengths)
    if scale is None:
        scale = d ** -0.5
    n = tables.shape[1]
    k_cache = k_pool[tables.long()].reshape(b, n * bs, h_kv, d).float()
    v_cache = v_pool[tables.long()].reshape(b, n * bs, h_kv, d).float()
    qg = q.float().reshape(b, h_kv, group, d)
    lens = lengths.long().clamp(max=n * bs)
    span = plan.pages_per_split * bs
    o = torch.zeros((b, h_kv, group, d), dtype=torch.float32,
                    device=q.device)
    m = torch.full((b, h_kv, group), -math.inf, device=q.device)
    l = torch.zeros((b, h_kv, group), device=q.device)
    for s in range(plan.splits):
        lo, hi = s * span, min((s + 1) * span, n * bs)
        scores = torch.einsum("bhgd,bkhd->bhgk", qg,
                              k_cache[:, lo:hi]) * scale
        pos = torch.arange(lo, hi, device=q.device)
        valid = pos[None, :] < lens[:, None]
        scores = scores.masked_fill(~valid[:, None, None], -math.inf)
        m_s = scores.amax(-1)
        safe = torch.where(m_s == -math.inf, torch.zeros_like(m_s), m_s)
        p = torch.exp(scores - safe[..., None])
        o_s = torch.einsum("bhgk,bkhd->bhgd", p, v_cache[:, lo:hi])
        o, m, l = merge_partials(o, m, l, o_s, m_s, p.sum(-1))
    out = torch.where(l[..., None] > 0, o / l.clamp(min=1e-30)[..., None],
                      torch.zeros_like(o))
    return out.reshape(b, h, d).to(q.dtype)


#: per (device, stream): the merge's f32 workspace and the (row, head
#: group) arrival counters, grown on demand; every launch leaves the
#: counters 0, and launches on one stream run in order
_buffers: dict = {}


def _buffers_for(device, stream: int, n_ws: int, n_ctr: int):
    ws, ctr = _buffers.get((device.index, stream), (None, None))
    if ws is None or ws.numel() < n_ws:
        ws = torch.empty(n_ws, dtype=torch.float32, device=device)
    if ctr is None or ctr.numel() < n_ctr:
        ctr = torch.zeros(n_ctr, dtype=torch.int32, device=device)
    _buffers[(device.index, stream)] = (ws, ctr)
    return ws, ctr


def _launch(q, k_pool, v_pool, tables, lengths, scale):
    global launches
    b, h, d = q.shape
    _, bs, h_kv, _ = k_pool.shape
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"the paged kernel takes head dims "
                         f"{_KERNEL_HEAD_DIMS}, got {d}")
    code = _build.DTYPE_CODES.get(str(q.dtype).removeprefix("torch."))
    if code is None or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"the paged kernel takes float32 or bfloat16 "
                         f"q and pools of one dtype, got {q.dtype} / "
                         f"{k_pool.dtype} / {v_pool.dtype}")
    for name, x in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("lengths", lengths)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != q.device:
            raise ValueError(f"{name} must be on q's device")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("the pools must be 16-byte aligned (the kernel "
                         "copies 16 bytes at a time)")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("tables and lengths must be int32")
    n_pages = tables.shape[1]
    plan = PagedPlan(**pick_decode_params(b, h_kv, h // h_kv, d, bs,
                                          n_pages, q.dtype))
    out = torch.empty_like(q)
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ws = ctr = None
        if plan.splits > 1:
            # the partials (o, m, l) of every (row, head, split), and
            # the counters that elect each (row, head group)'s merge
            ws, ctr = _buffers_for(q.device, stream,
                                   b * h * plan.splits * (d + 2),
                                   b * h // plan.heads_per_block)
        rc = lib.paged_decode(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if ctr is None else ctr.data_ptr(),
            b, h, h_kv, d, bs, n_pages, plan.heads_per_block,
            plan.pages_per_split, plan.splits, float(scale), code, stream)
    _build.check(rc, "paged_decode")
    launches += 1
    key = ("paged_decode", str(q.dtype).removeprefix("torch."), d)
    dim_launches[key] = dim_launches.get(key, 0) + 1
    return out


def paged_attention(q, k_pool, v_pool, tables, lengths, *,
                    scale: float | None = None):
    """Block-table paged decode attention (validating entry).

    q ``[B, H, D]`` (one query token per row); ``k_pool``/``v_pool``
    ``[n_blocks, block_size, H_kv, D]``; ``tables`` ``[B, n]`` int32
    physical block ids per row (unused tail slots point at the null
    block 0); ``lengths`` ``[B]`` int32 valid keys per row (>= 1).
    Returns ``[B, H, D]``.  The kernel on CUDA tensors, the plain
    version on CPU tensors.  Table entries and lengths are trusted:
    checking them against the pool would cost a device sync."""
    _validate(q, k_pool, v_pool, tables, lengths)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, tables,
                                         lengths, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch(q, k_pool, v_pool, tables, lengths, scale)


__all__ = ["PagedPlan", "merge_partials", "paged_attention",
           "paged_attention_reference", "paged_attention_split",
           "paged_plan", "pick_decode_params"]
