"""KV handoff over the wire: serialize + reshard-on-receive.

The port of ``k8s_dra_driver_tpu/serving_disagg/wirekv.py``, the
process-boundary twin of migrate.py: when prefill and decode pumps
live in DIFFERENT OS processes (gateway/procpump.py) there is no
shared device memory to copy across, so a prompt's K/V state crosses
as host bytes.  The gather half of ``make_kv_shard_and_gather_fns``
pulls every leaf to the host for the frame (gateway/wire.py array
codec: f32 leaves under the reference's ``"<f4"`` tag, bf16 leaves as
their raw 16-bit patterns under ``"bfloat16"``), and the receive side
is the shard half: every leaf lands in FRESH storage on the receiver's
device, and a paged slab is RE-CHUNKED to the receiver's block size
first (the sender's pool geometry never leaks into the receiver's).

The frame keeps the reference's keys.  ``"carry_key"`` holds the
port's ``KVBlock.carry`` (a sampled request's generator state, a
uint8 array) or None; it decodes to a CPU tensor, where generator
states are set from.  A frame whose carry is the reference's PRNG key
(uint32[2]) decodes, and the adopting engine refuses it with its
generator-state gate.

Costs stay honest: the encoded frame carries exactly the slab's block
rows (ceil(pos/bs)·bs per layer), and :func:`frame_bytes` reports the
frame's real size, base64 expansion included.
"""

from __future__ import annotations

import numpy as np
import torch

from ..gateway.wire import (decode_array, decode_request, encode_array,
                            encode_request)
from ..models.decode import KVCache
from ..models.serving import KVBlock, PagedKVSlab
from ..utils.device import resolve_device
from .migrate import make_kv_shard_and_gather_fns


def _gather_list(leaves) -> list:
    _, gather_fn = make_kv_shard_and_gather_fns()
    return [gather_fn(leaf) for leaf in leaves]


def _tensor(a) -> torch.Tensor:
    """A decoded leaf as a CPU tensor (bf16 leaves already are)."""
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(a)


def encode_paged_slab(slab: PagedKVSlab) -> dict:
    """A :class:`~..models.serving.PagedKVSlab` as host bytes: per-
    layer block tensors [n_blocks, bs, H_kv, D], ``pos`` valid rows."""
    return {"kind": "paged_slab",
            "k": [encode_array(a) for a in _gather_list(slab.k)],
            "v": [encode_array(a) for a in _gather_list(slab.v)],
            "pos": int(slab.pos),
            "block_size": slab.block_size}


def _rechunk(blocks: torch.Tensor, pos: int, bs_out: int) -> torch.Tensor:
    """[n_in, bs_in, H, D] -> [ceil(pos/bs_out), bs_out, H, D]: keep
    the ``pos`` valid rows, re-pad to the receiver's block geometry."""
    n_in, bs_in, h, d = blocks.shape
    rows = blocks.reshape(n_in * bs_in, h, d)[:pos]
    n_out = max(-(-pos // bs_out), 1)
    out = blocks.new_zeros((n_out * bs_out, h, d))
    out[:pos] = rows
    return out.reshape(n_out, bs_out, h, d)


def decode_paged_slab(d: dict, block_size: int | None = None,
                      dest="cuda") -> PagedKVSlab:
    """Reconstruct a slab IN THE RECEIVER'S GEOMETRY: ``block_size``
    is the receiving pool's (None = keep the sender's), ``dest`` the
    receiving device.  Re-chunking happens on the host — the bytes are
    host-resident already — then each layer lands on the device once,
    in fresh storage."""
    shard_fn, _ = make_kv_shard_and_gather_fns(resolve_device(dest))
    pos = int(d["pos"])
    bs_in = int(d["block_size"])
    bs_out = block_size or bs_in
    k, v = [], []
    for enc_k, enc_v in zip(d["k"], d["v"]):
        hk, hv = _tensor(decode_array(enc_k)), _tensor(decode_array(enc_v))
        if bs_out != bs_in:
            hk = _rechunk(hk, pos, bs_out)
            hv = _rechunk(hv, pos, bs_out)
        k.append(shard_fn(hk))
        v.append(shard_fn(hv))
    return PagedKVSlab(k=k, v=v, pos=pos, block_size=bs_out)


def encode_kv_block(block: KVBlock) -> dict:
    """A :class:`~..models.serving.KVBlock` with a dense [1, S] cache as
    host bytes — cache leaves, the carried generator state, and the
    request itself, so an adopting decode process continues exactly
    where the exporter's fill left off.  A paged export's slab travels
    through :func:`encode_paged_slab`."""
    kv = block.kv
    if isinstance(kv, PagedKVSlab):
        raise TypeError("encode_kv_block ships a dense [1, S] cache; "
                        "encode a paged export's slab with "
                        "encode_paged_slab")
    enc = {"kind": "kv_block",
           "request": encode_request(block.request),
           "k": [encode_array(a) for a in _gather_list(kv.k)],
           "v": [encode_array(a) for a in _gather_list(kv.v)],
           "pos": int(kv.pos),
           "first": int(block.first),
           "reused_tokens": int(block.reused_tokens),
           "carry_key": (None if block.carry is None
                         else encode_array(block.carry)),
           }
    if kv.k_scale is not None:
        enc["k_scale"] = [encode_array(a)
                          for a in _gather_list(kv.k_scale)]
        enc["v_scale"] = [encode_array(a)
                          for a in _gather_list(kv.v_scale)]
    return enc


def decode_kv_block(d: dict, dest="cuda") -> KVBlock:
    """Reconstruct the block with its cache on ``dest`` (fresh
    storage) and its carry on the CPU."""
    shard_fn, _ = make_kv_shard_and_gather_fns(resolve_device(dest))

    def land(encs):
        return [shard_fn(_tensor(decode_array(e))) for e in encs]

    kv = KVCache(
        k=land(d["k"]), v=land(d["v"]), pos=int(d["pos"]),
        k_scale=land(d["k_scale"]) if "k_scale" in d else None,
        v_scale=land(d["v_scale"]) if "v_scale" in d else None)
    carry = d.get("carry_key")
    if carry is not None:
        carry = _tensor(np.ascontiguousarray(decode_array(carry)))
    return KVBlock(request=decode_request(d["request"]), kv=kv,
                   first=int(d["first"]), carry=carry,
                   reused_tokens=int(d["reused_tokens"]))


def frame_bytes(d: dict) -> int:
    """The frame's payload size — the honest wire cost, base64
    expansion included, because those are the bytes that moved."""
    total = 0

    def walk(x):
        nonlocal total
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, list):
            for v in x:
                walk(v)
        elif isinstance(x, str):
            total += len(x)
        elif x is not None:
            total += 8
    walk(d)
    return total


__all__ = ["decode_kv_block", "decode_paged_slab", "encode_kv_block",
           "encode_paged_slab", "frame_bytes"]
