"""Paged-attention decode: the Hopper kernel K2 and its plain version.

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
the step over the card's memory rate (see its source note).

``launches`` counts kernel launches (CPU calls never count).
"""

from __future__ import annotations

import torch

from . import _build
from .ring_attention import _NEG_INF

#: kernel launches made by :func:`paged_attention` on CUDA tensors
launches = 0

_KERNEL_HEAD_DIMS = (64, 128)


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
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("tables and lengths must be int32")
    out = torch.empty_like(q)
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_decode(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            b, h, h_kv, d, bs, tables.shape[1], float(scale), code,
            stream)
    _build.check(rc, "paged_decode")
    launches += 1
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


__all__ = ["paged_attention", "paged_attention_reference"]
