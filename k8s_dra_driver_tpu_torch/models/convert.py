"""Parameters from the JAX package into the port.

``params_from_jax`` takes the JAX package's parameter pytree with its
leaves already turned into numpy arrays (``jax.device_get`` or
``np.asarray`` on each leaf, done by the caller — this module never
imports JAX) and returns the port's tensors under the same keys:
``embed``, ``unembed``, ``ln_f`` and ``layers[i][name]``.

bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` rejects; they are moved losslessly through their
16-bit pattern (view as int16, then as ``torch.bfloat16``).

A quantized tree (the JAX package's ``quantize_params``) carries
``QTensor`` leaves: any object with ``q`` and ``scale`` attributes
(the JAX class is never imported) becomes the port's ``QTensor``, its
int8 values and f32 scales moved as they are, whatever ``dtype`` says.

``kv_from_jax`` carries K/V state across the same way: a JAX
``KVCache`` or ``PagedKVSlab`` (a prefill export's payload) with numpy
leaves becomes the port's ``KVCache`` or ``PagedKVSlab``, which a port
engine's ``adopt_block`` or ``import_prefix`` takes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .decode import KVCache
from .quant import QTensor
from .serving import PagedKVSlab


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """One numpy leaf -> a CPU tensor of the same dtype (bf16 by bit
    pattern).  The tensor owns a copy: the source may be a read-only
    view of a device buffer."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree, device="cuda", dtype=None):
    """JAX-layout parameter tree (dicts, lists, numpy leaves) -> the
    same tree of tensors on ``device``, cast to ``dtype`` if given
    (``QTensor`` leaves keep their int8 values and f32 scales)."""
    dev = resolve_device(device)

    def leaf(a):
        return tensor_from_numpy(np.asarray(a)).to(dev)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        if hasattr(node, "q") and hasattr(node, "scale"):
            return QTensor(q=leaf(node.q), scale=leaf(node.scale))
        t = leaf(node)
        return t if dtype is None else t.to(dtype)

    return conv(tree)


def kv_from_jax(kv, device="cuda"):
    """A JAX ``KVCache`` (k, v, pos and the int8 cache's scales) or
    ``PagedKVSlab`` (k, v, pos, block_size) whose leaves are numpy
    arrays -> the port's ``KVCache`` / ``PagedKVSlab`` with its tensors
    on ``device``.  Told apart by ``block_size``; the JAX classes are
    never imported."""
    dev = resolve_device(device)

    def leaves(lst):
        return (None if lst is None else
                [tensor_from_numpy(np.asarray(a)).to(dev) for a in lst])

    if hasattr(kv, "block_size"):
        return PagedKVSlab(k=leaves(kv.k), v=leaves(kv.v), pos=int(kv.pos),
                           block_size=int(kv.block_size))
    return KVCache(k=leaves(kv.k), v=leaves(kv.v), pos=int(kv.pos),
                   k_scale=leaves(getattr(kv, "k_scale", None)),
                   v_scale=leaves(getattr(kv, "v_scale", None)))


__all__ = ["kv_from_jax", "params_from_jax", "tensor_from_numpy"]
