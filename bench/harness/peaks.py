"""Published peaks of the chip, the denominators of every roofline share.

NVIDIA H100 SXM (the data sheet's dense rates, no sparsity, at the full
700 W power limit): bf16 989 TFLOP/s on the tensor cores, TF32 495, f32 67
outside them, HBM3 3.35 TB/s.  An f32-accurate product on the tensor cores
takes three TF32 products (a = hi + lo), so its peak is a third of TF32's.
"""
from __future__ import annotations

H100_SXM = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12,
            "f32_tc": 495e12 / 3, "hbm_bytes": 3.35e12}


def for_device(kind: str) -> dict | None:
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``),
    or None for a card the table lacks (its shares are then not reported)."""
    return H100_SXM if "H100" in kind else None


def bound_s(n_bytes: float, n_ops: float, ops_per_s: float,
            peaks: dict) -> float:
    """The least time the chip could take: the larger of the bytes over
    HBM's rate and the operations over their peak."""
    return max(n_bytes / peaks["hbm_bytes"], n_ops / ops_per_s)
