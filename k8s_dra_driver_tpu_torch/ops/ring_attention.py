"""The dense attention oracle.

Only ``attention_reference`` (``k8s_dra_driver_tpu/ops/ring_attention.py``)
is ported so far: the O(T^2) single-device attention every fused path
is held against, and the transformer's off-card attention path.  The
ring (context-parallel) schedule comes with the parallelism slice.
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


__all__ = ["attention_mask", "attention_reference", "kv_group"]
