"""Device policy of the port: the caller's device, or the card.

Every entry point of ``repro_torch`` takes ``device=None``, which means
``"cuda"``.  Without a card that raises: the CPU is used only when the
caller asks for it (``device="cpu"``), as the tests do.  Nothing on the
main path moves work to the CPU on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card; raise if the card is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the card by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
