"""Entry points for the hand kernels, dispatched on the tensor's device.

A CUDA tensor launches the hand kernel (or the launch raises); a CPU
tensor runs the kernel's plain PyTorch version.  There is no other switch
and no fallback from one to the other.

Each kernel counts its launches (``launch_counts``), so a run can show
that its main path went through the kernels.  One count is not a launch:
``ssd_scan_backward`` counts ``SSDScan``'s backward passes on either
device, so a CPU run can show that its gradient went through them.

Gradients: attention (K3) is differentiated by ``FlashAttention``, whose
backward is K3-bwd on the card and its plain twin on the CPU; the SSD scan
(K4) by ``SSDScan``, whose backward is K4-bwd on the card and its plain
twin on the CPU.  So every family, ssm and hybrid included, trains on the
card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import flash_attention_bwd as _flash_bwd
from repro_torch.kernels import rbf, ref, solver
from repro_torch.kernels import ssd as _ssd
from repro_torch.kernels import ssd_bwd as _ssd_bwd
from repro_torch.kernels.build import LaunchCounter

#: ``SSDScan.backward`` calls on either device (not a kernel launch).
SSD_BACKWARDS = LaunchCounter("ssd_scan_backward")

COUNTERS = (rbf.LAUNCHES, solver.LAUNCHES, _flash.LAUNCHES, _flash.LAUNCHES_TC,
            _flash.LAUNCHES_F32, _ssd.LAUNCHES, _flash_bwd.LAUNCHES,
            _flash_bwd.LAUNCHES_TC, _flash_bwd.LAUNCHES_F32,
            _ssd_bwd.LAUNCHES, SSD_BACKWARDS)


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


class FlashAttention(torch.autograd.Function):
    """K3 with its gradient, on either device: the forward runs K3 (or its
    plain version on the CPU) and keeps q, k, v, the output and the row
    log-sum-exp; the backward runs K3-bwd (or its plain twin on the CPU)
    on them, so the CPU tests exercise the wiring the card runs."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        fn = _flash.flash_attention_cuda if _on_card(q) \
            else ref.flash_attention
        out, lse = fn(q, k, v, causal=causal, window=window,
                      q_offset=q_offset, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, q_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        fn = _flash_bwd.flash_attention_bwd_cuda if _on_card(q) \
            else ref.flash_attention_bwd
        dq, dk, dv = fn(q, k, v, out, lse, do.contiguous(), *ctx.mask)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Online-softmax GQA attention ``q (b, hq, sq, dh)`` against ``k, v
    (b, hkv, skv, dh)`` with causal / sliding-window masks (K3), through
    ``FlashAttention`` when an input requires a gradient."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, q_offset)
    fn = _flash.flash_attention_cuda if _on_card(q) else ref.flash_attention
    return fn(q, k, v, causal=causal, window=window, q_offset=q_offset)


class SSDScan(torch.autograd.Function):
    """K4 with its gradient, on either device: the forward runs K4 (or its
    plain version on the CPU) and keeps the inputs, each chunk's cumsum and
    entering state (K4's scratch; their plain twins on the CPU) and the
    final state; the backward runs K4-bwd (or its plain twin on the CPU) on
    them, so the CPU tests exercise the wiring the card runs.  A final
    state that gets no gradient passes ``None`` (zero) to the backward."""

    @staticmethod
    def forward(ctx, x, a, bmat, cmat, chunk):
        fn = _ssd.ssd_passes_cuda if _on_card(x) else ref.ssd_passes
        y, s_fin, cum, s_prev = fn(x, a, bmat, cmat, chunk)
        ctx.save_for_backward(x, a, bmat, cmat, cum, s_prev, s_fin)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, s_fin

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, a, bmat, cmat, cum, s_prev, s_fin = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if dfinal is not None:
            dfinal = dfinal.contiguous()
        fn = _ssd_bwd.ssd_scan_bwd_cuda if _on_card(x) else ref.ssd_scan_bwd
        dx, da, db, dc = fn(x, a, bmat, cmat, cum, s_prev, s_fin, dy, dfinal,
                            ctx.chunk)
        SSD_BACKWARDS.count += 1
        return dx, da, db, dc, None


def ssd_scan(x: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
             cmat: torch.Tensor, chunk: int = 128
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked Mamba2 SSD scan in the model's layout -> ``(y (b, s, nh, dh),
    final_state (b, nh, dh, ds))`` (K4), through ``SSDScan`` when an input
    requires a gradient."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, a, bmat, cmat)):
        return SSDScan.apply(x, a, bmat, cmat, chunk)
    fn = _ssd.ssd_scan_cuda if _on_card(x) else ref.ssd_scan
    return fn(x, a, bmat, cmat, chunk=chunk)
