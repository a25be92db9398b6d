"""Kernel functions for the mixed-kernel SVM (paper Eq. 2-6), on tensors.

The port of ``repro.core.kernels``.  Three kernel families:

  * linear      — K(x, z) = x.z                              (digital domain)
  * rbf         — K(x, z) = exp(-gamma ||x - z||^2)          (ideal Gaussian)
  * sech2 (hw)  — the hardware transfer of the cascaded subthreshold
                  differential pairs, Eq. (4), with x = dv / (n * V_T).

Distances use ``||x||^2 + ||z||^2 - 2 x.z`` (matmul-dominant); the hand
kernel in ``repro_torch.kernels.rbf`` computes the same form.  Every
function computes on the device of its inputs.
"""
from __future__ import annotations

import numpy as np
import torch

# Thermal voltage at 300 K (V) and typical IGZO subthreshold slope factor.
V_T: float = 0.02585
N_SLOPE: float = 1.38


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def pairwise_sq_dists(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """||x_i - z_j||^2 for x:(n,d), z:(m,d) -> (n,m), matmul-dominant form."""
    xx = torch.sum(x * x, dim=-1)[:, None]
    zz = torch.sum(z * z, dim=-1)[None, :]
    xz = x @ z.T
    return torch.clamp(xx + zz - 2.0 * xz, min=0.0)


def linear_kernel(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """K(x, z) = x.z  (paper Sec. II-A)."""
    return x @ z.T


def rbf_kernel(x: torch.Tensor, z: torch.Tensor, gamma) -> torch.Tensor:
    """Ideal Gaussian RBF kernel, Eq. (2)."""
    return torch.exp(-_scalar(gamma, x) * pairwise_sq_dists(x, z))


def gamma_subthreshold(n: float = N_SLOPE, v_t: float = V_T) -> float:
    """gamma0 of the un-scaled hardware cell, Eq. (5): 1 / (4 n^2 V_T^2)."""
    return 1.0 / (4.0 * n * n * v_t * v_t)


def sech2_cell(dv: torch.Tensor, n: float = N_SLOPE,
               v_t: float = V_T) -> torch.Tensor:
    """Single-dimension hardware Gaussian cell transfer, Eq. (4), with
    ``sech2_cell(0) == 1`` (see the reference for the normalisation)."""
    x = dv / (n * v_t)
    return 4.0 / ((1.0 + torch.exp(-x)) * (1.0 + torch.exp(x)))


def sech2_kernel(x: torch.Tensor, z: torch.Tensor, gamma,
                 v_scale: float = 1.0, n: float = N_SLOPE,
                 v_t: float = V_T) -> torch.Tensor:
    """Hardware separable kernel, Eq. (6) + input scaling of Eq. (8)."""
    gamma0_feat = gamma_subthreshold(n, v_t) * v_scale * v_scale
    s = torch.sqrt(_scalar(gamma, x) / gamma0_feat)
    dv = v_scale * (x[:, None, :] - z[None, :, :]) * s
    return torch.prod(sech2_cell(dv, n, v_t), dim=-1)


# ---------------------------------------------------------------------------
# Interpolation of measured transfer curves
# ---------------------------------------------------------------------------


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor,
           left=None, right=None) -> torch.Tensor:
    """``jnp.interp`` on tensors: the bracketing segment by binary search,
    then ``fp[i-1] + (delta / dx) * df``, clamped to ``left``/``right``
    outside the grid."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True),
                    1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0] if left is None else left, f)
    return torch.where(x > xp[-1], fp[-1] if right is None else right, f)


def _grid_is_uniform(grid, rel_tol: float = 1e-3) -> bool:
    """True when ``grid`` is a cast linspace (the DC-sweep abscissa)."""
    steps = np.diff(np.asarray(grid, np.float64))
    if steps.size == 0 or np.any(steps <= 0):
        return False
    mean = steps.mean()
    return bool(np.max(np.abs(steps - mean)) <= rel_tol * abs(mean))


def _uniform_interp(v, curve, lo, hi, left, right, inv_step):
    """``interp`` on a uniform ascending grid: O(1) bin location.

    The segment index and fraction come from one multiply
    ``u = (v - lo) * inv_step``; out-of-range queries clamp to
    ``left``/``right``.  Tracks ``interp`` to ~1e-6.
    """
    n_seg = curve.shape[0] - 1
    # The step rounded to f32 and passed as a Python scalar: the same f32
    # product as a 0-d f32 tensor, without that tensor's blocking host ->
    # device copy (a sync on a card) at every call.
    u = (v - lo) * float(np.float32(inv_step))
    i = torch.clamp(torch.floor(u).to(torch.int32), 0, n_seg - 1).long()
    t = u - i.to(torch.float32)
    f0 = curve[i]
    f1 = curve[i + 1]
    f = f0 + t * (f1 - f0)
    f = torch.where(v < lo, left, f)
    return torch.where(v > hi, right, f)


def measured_cell(v, grid, curve, left, right, uniform: bool, inv_step):
    """ONE measured-transfer-curve cell evaluation, shared by every consumer
    of a calibrated analog sweep (compiled machine and hardware-in-the-loop
    training): the O(1) uniform path for a linspace abscissa, ``interp``
    otherwise."""
    if uniform:
        return _uniform_interp(v, curve, grid[0], grid[-1], left, right,
                               inv_step)
    return interp(v, grid, curve, left=left, right=right)


def _grid_fast_path(grid) -> dict:
    """{'uniform_grid': bool, 'inv_step': float} for a sweep abscissa."""
    if grid is None:
        return {"uniform_grid": False, "inv_step": 0.0}
    g = np.asarray(grid.cpu() if isinstance(grid, torch.Tensor) else grid,
                   np.float64)
    if not _grid_is_uniform(g):
        return {"uniform_grid": False, "inv_step": 0.0}
    return {"uniform_grid": True,
            "inv_step": float((g.shape[0] - 1) / (g[-1] - g[0]))}


def kernel_matrix(kind, x: torch.Tensor, z: torch.Tensor,
                  gamma=1.0) -> torch.Tensor:
    """Dispatch on kernel kind; ``kind`` may also be a callable
    (x, z, gamma) -> K, e.g. the calibrated analog behavioral model for
    hardware-in-the-loop training."""
    if callable(kind):
        return kind(x, z, gamma)
    if kind == "linear":
        return linear_kernel(x, z)
    if kind == "rbf":
        return rbf_kernel(x, z, gamma)
    if kind == "sech2":
        return sech2_kernel(x, z, gamma)
    raise ValueError(f"unknown kernel kind: {kind!r}")
