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
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .quant import QTensor


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


__all__ = ["params_from_jax", "tensor_from_numpy"]
