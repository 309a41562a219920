"""Device resolution for the port's entry points.

Entry points default to the card.  They run on the CPU only when the
caller asks for it, and never fall back to it: a missing card is an
error, not a slower run.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` (str or ``torch.device``) -> ``torch.device`` with
    an explicit index for CUDA (``"cuda"`` -> the current card), so
    devices compare equal to tensors' ``.device``; raises when a CUDA
    device is asked for and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_card(x: torch.Tensor, name: str) -> bool:
    """Whether kernel wrapper ``name`` launches its kernel on ``x``:
    True for a CUDA tensor, False for a CPU one (the plain version);
    raises for any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    return True
