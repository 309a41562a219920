"""Flash-attention forward: the Hopper kernel K1 and its plain version.

``flash_attention`` is the port of
``k8s_dra_driver_tpu/ops/flash_attention.py:flash_attention`` (the
normalized forward through ``_flash_forward``).  On a CUDA tensor it
launches the hand-written kernel ``csrc/flash_fwd.cu``, which replaces
the TPU kernel ``_flash_kernel`` (launched there by
``_flash_block_attention``); on a CPU tensor it takes the plain
PyTorch version ``flash_forward_reference`` in this module.  There is
no other path: an unsupported shape or dtype on the card raises.

The kernel is bounded by tensor-core flops at long T (it runs f32 FMA
on the CUDA cores today, see its source note) and by launch latency at
the serving path's short prompts.  No backward yet: the JAX custom VJP
backward kernels come with the training slice.

``launches`` counts kernel launches (CPU calls never count).
"""

from __future__ import annotations

import torch

from . import _build
from .ring_attention import _NEG_INF, attention_mask, kv_group

#: kernel launches made by :func:`flash_forward` on CUDA tensors
launches = 0

_KERNEL_HEAD_DIMS = (64, 128)


def _validate(q, k, v, causal, window, segment_ids):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(
            f"q must be [B, T, H, D] and k/v matching [B, T, H_kv, D], "
            f"got {tuple(q.shape)} / {tuple(k.shape)} / {tuple(v.shape)}")
    b, t, h, d = q.shape
    if k.shape[0] != b or k.shape[1] != t or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    kv_group(h, k.shape[2])
    if window is not None and (not causal or window < 1):
        raise ValueError("window requires causal attention and >= 1")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if segment_ids is not None:
        if tuple(segment_ids.shape) != (b, t):
            raise ValueError(f"segment_ids must be [B, T] = {(b, t)}, "
                             f"got {tuple(segment_ids.shape)}")
        if segment_ids.device != q.device:
            raise ValueError("segment_ids must be on q's device")


def flash_forward_reference(q, k, v, *, causal=True, scale=None,
                            window=None, segment_ids=None):
    """Plain PyTorch version of the kernel: ``(out, lse)`` with out
    ``[B, T, H, D]`` in q's dtype and lse ``[B, H, T]`` f32.  Scores,
    masking (-1e30) and softmax in f32; GQA by repeat."""
    _validate(q, k, v, causal, window, segment_ids)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    group = kv_group(q.shape[2], k.shape[2])
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    mask = attention_mask(q.shape[1], causal, window, segment_ids,
                          q.device)
    s = s.masked_fill(~mask[:, None], _NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
    return out, lse


def flash_attention_reference(q, k, v, *, causal=True, scale=None,
                              window=None, segment_ids=None):
    """The normalized output of :func:`flash_forward_reference`."""
    return flash_forward_reference(q, k, v, causal=causal, scale=scale,
                                   window=window,
                                   segment_ids=segment_ids)[0]


def _launch(q, k, v, causal, scale, window, segment_ids):
    global launches
    b, t, h, d = q.shape
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head dims "
                         f"{_KERNEL_HEAD_DIMS}, got {d}")
    code = _build.DTYPE_CODES.get(str(q.dtype).removeprefix("torch."))
    if code is None:
        raise ValueError(f"the flash kernel takes float32 or bfloat16, "
                         f"got {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if segment_ids is not None and (segment_ids.dtype != torch.int32
                                    or not segment_ids.is_contiguous()):
        raise ValueError("segment_ids must be contiguous int32")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            segment_ids.data_ptr() if segment_ids is not None else None,
            out.data_ptr(), lse.data_ptr(), b, t, h, k.shape[2], d,
            int(causal), int(window or 0), float(scale), code, stream)
    _build.check(rc, "flash_fwd")
    launches += 1
    return out, lse


def flash_forward(q, k, v, *, causal=True, scale=None, window=None,
                  segment_ids=None):
    """``(out, lse)``: the kernel on CUDA tensors, the plain version on
    CPU tensors.  q ``[B, T, H, D]``, k/v ``[B, T, H_kv, D]``
    (float32 or bfloat16, contiguous on the card, D in {64, 128}),
    ``segment_ids`` [B, T] int32."""
    _validate(q, k, v, causal, window, segment_ids)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, causal=causal,
                                       scale=scale, window=window,
                                       segment_ids=segment_ids)
    if q.device.type != "cuda":
        raise ValueError(f"flash_forward runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch(q, k, v, causal, scale, window, segment_ids)


def flash_attention(q, k, v, *, causal=True, scale=None, window=None,
                    segment_ids=None):
    """Single-device flash attention, normalized (forward only):
    ``[B, T, H, D]`` in q's dtype.  Same masks as
    ``attention_reference``: causal, sliding ``window``,
    ``segment_ids`` packing, GQA by K/V head index."""
    return flash_forward(q, k, v, causal=causal, scale=scale,
                         window=window, segment_ids=segment_ids)[0]


__all__ = ["flash_attention", "flash_attention_reference",
           "flash_forward", "flash_forward_reference"]
