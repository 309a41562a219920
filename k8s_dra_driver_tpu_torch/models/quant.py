"""Weight-typed einsum and embedding lookup.

Only the unquantized halves of ``k8s_dra_driver_tpu/models/quant.py``
``ein`` and ``take_rows`` are ported so far: ``QTensor`` and the int8
path (with its kernel) come with a later slice.  Every forward path
calls these two, so the int8 dispatch can land here without touching
the model code.
"""

from __future__ import annotations

import torch


def ein(spec: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(spec, x, w)``: the large projections stay plain
    matmuls, as the JAX package left them to XLA."""
    return torch.einsum(spec, x, w)


def take_rows(table: torch.Tensor, tokens: torch.Tensor, dtype=None):
    """Embedding lookup: ``table[tokens]``, cast to ``dtype`` if
    given."""
    out = table[tokens]
    return out.to(dtype) if dtype is not None else out


__all__ = ["ein", "take_rows"]
