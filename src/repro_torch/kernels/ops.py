"""Entry points for the hand kernels, dispatched on the tensor's device.

A CUDA tensor launches the hand kernel (or the launch raises); a CPU
tensor runs the kernel's plain PyTorch version.  There is no other switch
and no fallback from one to the other.

Each kernel counts its launches (``launch_counts``), so a run can show
that its main path went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import rbf, ref, solver
from repro_torch.kernels import ssd as _ssd

COUNTERS = (rbf.LAUNCHES, solver.LAUNCHES, _flash.LAUNCHES, _flash.LAUNCHES_TC,
            _flash.LAUNCHES_F32, _ssd.LAUNCHES)


def reset_launches() -> None:
    for c in COUNTERS:
        c.count = 0


def launch_counts() -> dict[str, int]:
    return {c.name: c.count for c in COUNTERS}


def _on_card(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for tensors on {t.device}")


def rbf_matrix(x: torch.Tensor, sv: torch.Tensor, gamma: torch.Tensor,
               kind: str = "rbf", n_slope: float = 1.38,
               v_t: float = 0.02585, v_scale: float = 0.5) -> torch.Tensor:
    """Kernel matrices of a bank: ``x (n, d)`` against ``sv (P, m, d)`` with
    ``gamma (P,)`` -> ``(P, n, m)`` (K1)."""
    fn = rbf.kernel_matrix_cuda if _on_card(x) else rbf.kernel_matrix_plain
    return fn(x, sv, gamma, kind=kind, n_slope=n_slope, v_t=v_t,
              v_scale=v_scale)


def solve_lanes(x: torch.Tensor, y: torch.Tensor, c_box: torch.Tensor,
                gamma: torch.Tensor, kind: str = "rbf", n_epochs: int = 200,
                n_slope: float = 1.38, v_t: float = 0.02585,
                v_scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused dual ascent over (pair, gamma, C-lane) solver lanes with Gram
    rows recomputed from x -> ``(alpha, f)``, each (P, G, L, n) (K2)."""
    fn = solver.solve_lanes_cuda if _on_card(x) else ref.solve_lanes
    return fn(x, y, c_box, gamma, kind=kind, n_epochs=n_epochs,
              n_slope=n_slope, v_t=v_t, v_scale=v_scale)


def solve_lanes_gram(kp: torch.Tensor, y: torch.Tensor, c_box: torch.Tensor,
                     n_epochs: int = 200) -> tuple[torch.Tensor, torch.Tensor]:
    """The same lanes on stored Grams ``kp (P, G, n, n)`` (K2, Gram-input
    mode) -> ``(alpha, f)``, each (P, G, L, n)."""
    fn = solver.solve_lanes_gram_cuda if _on_card(kp) else ref.solve_lanes_gram
    return fn(kp, y, c_box, n_epochs=n_epochs)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Online-softmax GQA attention ``q (b, hq, sq, dh)`` against ``k, v
    (b, hkv, skv, dh)`` with causal / sliding-window masks (K3)."""
    fn = _flash.flash_attention_cuda if _on_card(q) else ref.flash_attention
    return fn(q, k, v, causal=causal, window=window, q_offset=q_offset)


def ssd_scan(x: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
             cmat: torch.Tensor, chunk: int = 128
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked Mamba2 SSD scan in the model's layout -> ``(y (b, s, nh, dh),
    final_state (b, nh, dh, ds))`` (K4)."""
    fn = _ssd.ssd_scan_cuda if _on_card(x) else ref.ssd_scan
    return fn(x, a, bmat, cmat, chunk=chunk)
