"""Ring attention: sequence-parallel exact attention over the mesh's
``sp`` axis, and the dense attention oracle.

The port of ``k8s_dra_driver_tpu/ops/ring_attention.py``.  Each rank
of an ``sp`` line holds one sequence shard of q, k and v; the K/V
blocks travel around the ring (rank i receives rank i + 1's block each
hop, as the JAX ``_ring_perm``), and each hop runs K1's block entry
(``flash_block_attention``: q against the visiting block at absolute
offsets) and folds its statistics with ``merge_flash_stats``.  Hops
wholly above the causal diagonal or behind the sliding window are
skipped (:func:`_hop_contributes`) and still rotate.

The backward is one ``torch.autograd.Function``: a second ring in which
the (k, v, dk, dv) quartet rotates, each hop running K3/K4
(``flash_block_grads``) against the visiting block from the saved
output and log-sum-exp; after S hops the dk/dv accumulators are home,
complete.  Skipped hops add nothing.

The port's entry takes each rank's **local** shard ``[B_local, T/S, H,
D]``, as torch.distributed code does; the JAX entry takes global arrays
under ``shard_map``.  On CUDA tensors every hop runs the kernels, on
CPU tensors their plain versions.  Hops travel by
``batch_isend_irecv`` on the sp group (``parallel/mesh.py``); the next
hop's blocks are in flight while this hop computes.  Each hop waits at
most the sp group's timeout, the mesh's deadline (``ProcessMesh.
timeout``): a peer that died or stopped raises ``MeshPeerError`` on its
neighbours.

``attention_reference`` is the O(T^2) single-device attention every
fused path is held against, and the transformer's off-card attention
path.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def kv_group(h: int, h_kv: int) -> int:
    """Query heads per K/V head for grouped-query attention; validates
    divisibility."""
    if h % h_kv:
        raise ValueError(f"query heads {h} not a multiple of kv heads "
                         f"{h_kv}")
    return h // h_kv


def attention_mask(t: int, causal: bool, window, segment_ids,
                   device) -> torch.Tensor:
    """[1|B, T, T] bool: True where query row may see key column —
    causal, sliding ``window`` (self included) and segment equality,
    the masks every attention path in the port shares."""
    mask = torch.ones((1, t, t), dtype=torch.bool, device=device)
    if causal:
        mask = mask & torch.ones((t, t), dtype=torch.bool,
                                 device=device).tril()[None]
        if window is not None:
            mask = mask & torch.ones((t, t), dtype=torch.bool,
                                     device=device).triu(
                                         -(window - 1))[None]
    if segment_ids is not None:
        mask = mask & (segment_ids[:, :, None] == segment_ids[:, None, :])
    return mask


def attention_reference(q, k, v, *, causal=True, scale=None,
                        window=None, segment_ids=None):
    """Naive O(T^2) single-device attention, for correctness checks.

    q ``[B, T, H, D]``; k/v ``[B, T, H_kv, D]`` with H a multiple of
    H_kv (the group's heads are broadcast by repeat — query head h
    reads K/V head h // group).  ``window``: sliding-window attention,
    each query sees its ``window`` most recent positions (self
    included); requires ``causal``.  ``segment_ids`` [B, T]: queries
    attend only within their own segment.  Scores and softmax in f32,
    masked with -1e30; returns q's dtype.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if window is not None and (not causal or window < 1):
        raise ValueError("window requires causal attention and >= 1")
    group = kv_group(q.shape[2], k.shape[2])
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal or segment_ids is not None:
        mask = attention_mask(q.shape[1], causal, window, segment_ids,
                              q.device)
        scores = scores.masked_fill(~mask[:, None], _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _hop_contributes(q_offset: int, k_offset: int, t_local: int,
                     causal: bool, window: int | None) -> bool:
    """Whether a visiting K/V block can contribute anything to this
    shard's queries: hops entirely above the causal diagonal or entirely
    behind the sliding window are all-masked and skipped."""
    run = (q_offset + t_local - 1 >= k_offset) if causal else True
    if window is not None:
        # newest visiting key vs oldest in-window position of the
        # oldest local query
        run &= q_offset - (k_offset + t_local - 1) < window
    return run


def _ring_perm(ring_size: int) -> list[tuple[int, int]]:
    # device i receives the block of device (i+1) each step, so after
    # `step` hops it holds block (i + step) % S.
    return [(j, (j - 1) % ring_size) for j in range(ring_size)]


def _ring_peers(idx: int, ring_size: int) -> tuple[int, int]:
    """(send_to, recv_from) of ring position ``idx`` under
    :func:`_ring_perm`."""
    perm = _ring_perm(ring_size)
    send_to = perm[idx][1]
    recv_from = next(src for src, dst in perm if dst == idx)
    return send_to, recv_from


def _hop_segments(seg_all, k_offset: int, t_local: int):
    if seg_all is None:
        return None
    return seg_all[:, k_offset:k_offset + t_local].contiguous()


def _ring_forward(q, k, v, seg, seg_all, mesh, axis, causal, scale,
                  window):
    """Forward ring pass: ``(out [B, Tq, H, D] q.dtype, lse [B, H,
    Tq])``."""
    # imported here: flash_attention imports this module's masks
    from .flash_attention import (flash_block_attention, merge_flash_stats,
                                  normalize_flash_stats)
    ring, idx = mesh.size(axis), mesh.index(axis)
    send_to, recv_from = _ring_peers(idx, ring)
    b, t_local, h, d = q.shape
    q_offset = idx * t_local
    o = torch.zeros((b, t_local, h, d), dtype=torch.float32,
                    device=q.device)
    m = torch.full((b, h, t_local), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    k_blk, v_blk = k, v
    for step in range(ring):
        pending = (mesh.exchange_start([k_blk, v_blk], axis, send_to,
                                       recv_from)
                   if step < ring - 1 else None)
        k_offset = ((idx + step) % ring) * t_local
        if _hop_contributes(q_offset, k_offset, t_local, causal, window):
            stats = flash_block_attention(
                q, k_blk, v_blk, q_offset, k_offset, causal=causal,
                scale=scale, window=window, q_segments=seg,
                k_segments=_hop_segments(seg_all, k_offset, t_local))
            o, m, l = merge_flash_stats(o, m, l, *stats)
        if pending is not None:
            # deadline: the sp group's timeout bounds the hop (mesh.py)
            k_blk, v_blk = pending.wait()
    out, lse = normalize_flash_stats(o, m, l)
    return out.to(q.dtype), lse


def _ring_backward(q, k, v, seg, seg_all, out, lse, do, mesh, axis, causal,
                   scale, window):
    """Backward ring pass: f32 ``(dq, dk, dv)`` of this shard."""
    from .flash_attention import attention_delta, flash_block_grads
    ring, idx = mesh.size(axis), mesh.index(axis)
    send_to, recv_from = _ring_peers(idx, ring)
    t_local = q.shape[1]
    q_offset = idx * t_local
    do = do.contiguous()
    delta = attention_delta(do, out)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    k_blk, v_blk = k, v
    for step in range(ring):
        k_offset = ((idx + step) % ring) * t_local
        if _hop_contributes(q_offset, k_offset, t_local, causal, window):
            dq_c, dk_c, dv_c = flash_block_grads(
                q, k_blk, v_blk, do, delta, lse, q_offset, k_offset,
                causal=causal, scale=scale, window=window, q_segments=seg,
                k_segments=_hop_segments(seg_all, k_offset, t_local))
            dq += dq_c
            dk += dk_c
            dv += dv_c
        # the quartet rotates together; after the last hop only the
        # accumulators travel, home to the block's owner
        moving = [dk, dv] if step == ring - 1 else [k_blk, v_blk, dk, dv]
        # deadline: the sp group's timeout bounds the hop (mesh.py)
        moved = mesh.exchange_start(moving, axis, send_to,
                                    recv_from).wait()
        if step == ring - 1:
            dk, dv = moved
        else:
            k_blk, v_blk, dk, dv = moved
    return dq, dk, dv


class _RingAttention(torch.autograd.Function):
    """The custom VJP of the JAX ``_ring_attention_local``: the forward
    saves q, k, v, the output and the log-sum-exp; the backward is the
    second ring."""

    @staticmethod
    def forward(ctx, q, k, v, seg, mesh, axis, causal, scale, window):
        seg_all = None if seg is None else mesh.all_gather(seg, axis, dim=1)
        out, lse = _ring_forward(q, k, v, seg, seg_all, mesh, axis, causal,
                                 scale, window)
        ctx.save_for_backward(q, k, v, seg, seg_all, out, lse)
        ctx.args = (mesh, axis, causal, scale, window)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, seg_all, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, seg, seg_all, out, lse, do,
                                    *ctx.args)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None,
                None, None, None, None, None)


def ring_attention(q, k, v, mesh, *, axis_name: str = "sp",
                   causal: bool = True, scale: float | None = None,
                   segment_ids=None, window: int | None = None):
    """Exact attention with the sequence sharded over ``axis_name``.

    q ``[B_local, T/S, H, D]``, k/v ``[B_local, T/S, H_kv, D]``: this
    rank's shard, the S shards of an sp line in coordinate order (shard
    i holds positions ``[i T/S, (i+1) T/S)``); returns this shard's
    output in q's dtype, differentiable in q, k and v.  ``mesh`` is a
    ``parallel.mesh.ProcessMesh``.  ``segment_ids`` ``[B_local, T/S]``
    (int32 on the card) adds packed-sequence masking: the ids are
    all-gathered once and the visiting block's sliced per hop.
    ``window`` adds sliding-window masking by absolute position.

    The JAX entry's ``batch_axes``/``head_axis``/``use_flash`` have no
    counterpart: the batch is already this rank's, heads are not
    sharded (tp is not ported yet), and the device of the tensors picks
    kernels or plain versions."""
    if window is not None and (not causal or window < 1):
        raise ValueError("window requires causal attention and >= 1")
    kv_group(q.shape[2], k.shape[2])
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _RingAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), segment_ids, mesh,
                                axis_name, causal, scale, window)


__all__ = ["attention_mask", "attention_reference", "kv_group",
           "ring_attention"]
