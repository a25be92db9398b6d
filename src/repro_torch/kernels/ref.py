"""Plain PyTorch versions of the SVM kernels (the ``ref.py`` contract).

Counterparts of ``repro.kernels.ref``: simple, obviously-correct functions
that the CPU tests hold the port to, and that ``chip_smoke.py`` holds the
hand kernels to on the card.  They are what a wrapper runs for a tensor on
the CPU; nothing on the main path runs them for a CUDA tensor.

Batch dimensions are written out instead of ``vmap``: leading dimensions
broadcast, and the solver is vectorised over lanes and loops only over
coordinates.
"""
from __future__ import annotations

import torch


#: Coordinate-block size of the blocked solver; the hand kernel's block
#: (``kBlock`` in ``csrc/solver.cu``) is the same constant.
SOLVER_BLOCK = 16


def _g(gamma, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(gamma, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# RBF / sech2 kernel matrices (the paper's hot loop)
# ---------------------------------------------------------------------------


def rbf_matrix(x: torch.Tensor, z: torch.Tensor, gamma) -> torch.Tensor:
    """K[..., i, j] = exp(-gamma * ||x_i - z_j||^2).

    ``x (..., n, d)``, ``z (..., m, d)``, ``gamma`` a scalar or a tensor of
    the batch shape.
    """
    d2 = (torch.sum(x * x, -1)[..., :, None]
          + torch.sum(z * z, -1)[..., None, :]
          - 2.0 * (x @ z.transpose(-1, -2)))
    g = _g(gamma, x)[..., None, None]
    return torch.exp(-g * torch.clamp(d2, min=0.0))


def sech2_matrix(x: torch.Tensor, z: torch.Tensor, gamma,
                 n_slope: float = 1.38, v_t: float = 0.02585,
                 v_scale: float = 0.5) -> torch.Tensor:
    """Hardware separable kernel (Eq. 6): product of per-dim sech2 cells."""
    gamma0 = 1.0 / (4.0 * n_slope**2 * v_t**2) * v_scale**2
    s = torch.sqrt(_g(gamma, x) / gamma0)[..., None, None, None]
    dv = v_scale * s * (x[..., :, None, :] - z[..., None, :, :]) \
        / (n_slope * v_t)
    cell = 4.0 / ((1.0 + torch.exp(-dv)) * (1.0 + torch.exp(dv)))
    return torch.prod(cell, dim=-1)


# ---------------------------------------------------------------------------
# Dual coordinate ascent over solver lanes (the training hot loop)
# ---------------------------------------------------------------------------


def dual_ascent_blocked(kp: torch.Tensor, y: torch.Tensor,
                        c_box: torch.Tensor, n_epochs: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocked Gauss-Seidel dual ascent on materialized Grams ``K' = K + 1``.

    ``kp (..., n, n)``, ``y (..., n)`` and the lanes' boxes
    ``c_box (..., L, n)``; the leading dimensions broadcast.  The update
    sequence is that of ``repro.core.trainer.dual_coordinate_ascent_blocked``:
    per block of ``SOLVER_BLOCK`` coordinates, fresh margins from all columns
    (``rows @ (alpha * y)``), then Gauss-Seidel inside the block.  Returns
    ``(alpha, f)``, each ``(..., L, n)``, with the final margins
    ``f = K' @ (alpha * y)``.
    """
    n = kp.shape[-1]
    block = min(SOLVER_BLOCK, n)
    n_pad = -(-n // block) * block
    if n_pad != n:
        pad = n_pad - n
        kp = torch.nn.functional.pad(kp, (0, pad, 0, pad))
        y = torch.nn.functional.pad(y, (0, pad), value=1.0)
        c_box = torch.nn.functional.pad(c_box, (0, pad))
    y = y[..., None, :]                                    # (..., 1, n)
    kpt = kp.transpose(-1, -2)
    qdiag = torch.clamp(torch.diagonal(kp, dim1=-2, dim2=-1), min=1e-12)
    lanes = torch.broadcast_shapes(kp.shape[:-2] + (1,), y.shape[:-1],
                                   c_box.shape[:-1])
    alpha = torch.zeros(lanes + (n_pad,), dtype=kp.dtype, device=kp.device)

    def flat(t):  # (..., blk) -> (blk, lanes): a contiguous copy
        return t.expand(lanes + t.shape[-1:]).reshape(-1, t.shape[-1]).T \
            .clone(memory_format=torch.contiguous_format)

    for _ in range(int(n_epochs)):
        for j0 in range(0, n_pad, block):
            sl = slice(j0, j0 + block)
            fb = flat((alpha * y) @ kpt[..., :, sl])       # fresh margins
            kbb = kp[..., None, sl, sl]                    # [.., r, i]
            kcol = kbb.expand(lanes + kbb.shape[-2:]).reshape(
                -1, block, block).permute(2, 1, 0).contiguous()  # [i, r, l]
            ab, yb = flat(alpha[..., sl]), flat(y[..., sl])
            cb, qb = flat(c_box[..., sl]), flat(qdiag[..., None, sl])
            for i in range(block):
                g = 1.0 - yb[i] * fb[i]
                a_new = torch.minimum(
                    torch.clamp(ab[i] + g / qb[i], min=0.0), cb[i])
                fb += ((a_new - ab[i]) * yb[i]) * kcol[i]
                ab[i] = a_new
            alpha[..., sl] = ab.T.reshape(lanes + (block,))
    f = (alpha * y) @ kpt
    return alpha[..., :n], f[..., :n]


def lane_grams(x: torch.Tensor, gamma: torch.Tensor, kind: str,
               n_slope: float = 1.38, v_t: float = 0.02585,
               v_scale: float = 1.0) -> torch.Tensor:
    """Per-(pair, gamma) Gram with the bias folded in: ``(P, G, n, n)``."""
    xg = x[:, None]                                        # (P, 1, n, d)
    if kind == "linear":
        k = (x @ x.transpose(-1, -2))[:, None].expand(
            -1, gamma.shape[1], -1, -1)
    elif kind == "rbf":
        k = rbf_matrix(xg, xg, gamma)
    elif kind == "sech2":
        k = sech2_matrix(xg, xg, gamma, n_slope, v_t, v_scale)
    else:
        raise ValueError(f"no lanes oracle for kernel kind {kind!r}")
    return k + 1.0


def solve_lanes(x: torch.Tensor, y: torch.Tensor, c_box: torch.Tensor,
                gamma: torch.Tensor, kind: str = "rbf", n_epochs: int = 200,
                n_slope: float = 1.38, v_t: float = 0.02585,
                v_scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Lanes oracle: materialized per-(pair, gamma) Gram + the blocked
    update sequence over ``(P, G, L)``.  ``x (P, n, d)``, ``y (P, n)``,
    ``c_box (P, L, n)``, ``gamma (P, G)``; returns ``(alpha, f)``, each
    ``(P, G, L, n)``."""
    kp = lane_grams(x, gamma, kind, n_slope, v_t, v_scale)
    return solve_lanes_gram(kp, y, c_box, n_epochs)


def solve_lanes_gram(kp: torch.Tensor, y: torch.Tensor, c_box: torch.Tensor,
                     n_epochs: int = 200) -> tuple[torch.Tensor, torch.Tensor]:
    """The same lanes on stored Grams ``kp (P, G, n, n)`` (bias folded in):
    the plain version of the solver's Gram-input mode."""
    return dual_ascent_blocked(kp, y[:, None], c_box[:, None], n_epochs)
