"""Ulysses-style all-to-all sequence parallelism for attention.

The port of ``k8s_dra_driver_tpu/ops/ulysses_attention.py``, the
second context-parallel strategy next to the ring
(``ops/ring_attention.py``): two all-to-alls reshard this rank's
``[B, T/S, H, D]`` sequence shard to ``[B, T, H/S, D]`` (the full
sequence, a subset of heads), the normalized flash attention runs
locally over the whole sequence (K1 forward, K3/K4 backward on the
card), and the reverse all-to-all brings the output back to the
sequence shard.  An all-to-all is linear and its transpose is the
reverse all-to-all, so each reshard is a ``torch.autograd.Function``
whose backward is the other one.

GQA: K/V heads reshard the same way, so the local K/V head count must
also divide by the sp size (the JAX constraint).

As in ``ring_attention``, the port's entry takes each rank's local
shard, not global arrays under ``shard_map``.
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention
from .ring_attention import kv_group


def _seq_to_heads(x, mesh, axis):
    """[B, T/S, h, D] -> [B, T, h/S, D]: head chunk j to coordinate j,
    sequence shards concatenated in coordinate order."""
    s = mesh.size(axis)
    b, tl, h, d = x.shape
    chunks = x.reshape(b, tl, s, h // s, d).permute(2, 0, 1, 3, 4)
    got = mesh.all_to_all(chunks, axis)            # [S (source), B, tl, ..]
    return got.permute(1, 0, 2, 3, 4).reshape(b, s * tl, h // s, d)


def _heads_to_seq(x, mesh, axis):
    """[B, T, h/S, D] -> [B, T/S, h, D]: the inverse of
    :func:`_seq_to_heads`."""
    s = mesh.size(axis)
    b, t, hs, d = x.shape
    chunks = x.reshape(b, s, t // s, hs, d).permute(1, 0, 2, 3, 4)
    got = mesh.all_to_all(chunks, axis)            # [S (source), B, T/S, ..]
    return got.permute(1, 2, 0, 3, 4).reshape(b, t // s, s * hs, d)


class _Reshard(torch.autograd.Function):
    """Sequence shard -> head shard (``to_heads``) or back; the backward
    is the opposite reshard of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis, to_heads):
        ctx.args = (mesh, axis, to_heads)
        fn = _seq_to_heads if to_heads else _heads_to_seq
        return fn(x, mesh, axis).contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, axis, to_heads = ctx.args
        fn = _heads_to_seq if to_heads else _seq_to_heads
        return fn(g, mesh, axis), None, None, None


def ulysses_attention(q, k, v, mesh, *, axis_name: str = "sp",
                      causal: bool = True, scale: float | None = None,
                      window: int | None = None, segment_ids=None):
    """Exact attention with the sequence sharded over ``axis_name`` via
    head/sequence all-to-all resharding (drop-in for
    ``ring_attention``: the same local shards in and out).

    q ``[B_local, T/S, H, D]``, k/v ``[B_local, T/S, H_kv, D]``; both H
    and H_kv must divide by the ``axis_name`` size.
    ``window``/``segment_ids`` (``[B_local, T/S]``, gathered along the
    axis) mask the local attention as the single-device kernels do.
    On CUDA tensors the local attention is ``flash_attention`` (K1,
    K3/K4); on CPU tensors the same function's plain versions."""
    sp = mesh.size(axis_name)
    h, h_kv = q.shape[2], k.shape[2]
    kv_group(h, h_kv)
    for name, heads in (("query", h), ("kv", h_kv)):
        if heads % sp:
            raise ValueError(
                f"ulysses needs local {name} head count {heads} "
                f"divisible by {axis_name}={sp}; use ring_attention "
                f"for seq-parallel sizes beyond the head count")
    if sp > 1:
        q, k, v = (_Reshard.apply(x, mesh, axis_name, True)
                   for x in (q, k, v))
        if segment_ids is not None:
            segment_ids = mesh.all_gather(segment_ids, axis_name,
                                          dim=1).contiguous()
    o = flash_attention(q, k, v, causal=causal, scale=scale,
                        window=window, segment_ids=segment_ids)
    return _Reshard.apply(o, mesh, axis_name, False) if sp > 1 else o


__all__ = ["ulysses_attention"]
