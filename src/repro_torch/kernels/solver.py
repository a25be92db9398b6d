"""K2: the fused dual-coordinate-ascent solver over lanes, hand-written in
CUDA C++ for Hopper (``csrc/solver.cu``, tile bodies shared with K1 from
``csrc/tiles.cuh``).

Replaces the Pallas TPU kernel
``repro/kernels/solver.py::dual_ascent_lanes_pallas`` (body
``_solver_kernel``).  A lane is one (pair, gamma, C x fold) cell of the
grid (P, G, L); it runs on one warp, and the lanes of one (pair, gamma)
share a CTA, whose (16, n) slabs of K' = K + 1 are computed once per
coordinate block into shared memory (from x by the tile bodies, so no Gram
matrix is stored) and read by every lane.  The host splits each cell's
lanes over as many CTAs as fill the SMs once.  Outputs are ``alpha`` and
the final margins ``f = K'(alpha * y)``, each ``(P, G, L, n)``.  The update
order is that of the oracle
``repro/core/trainer.py::dual_coordinate_ascent_blocked``; labels are +-1.

A Gram-input mode (``solve_lanes_gram_cuda``) runs the same update
sequence on stored Grams ``(P, G, n, n)``: the hardware measured-curve
kernel of hardware-in-the-loop training has no tile body.

What bounds it on the card: each lane is a serial chain of
``n_epochs * n`` dependent coordinate updates with a margin pass over all
n columns per block of ``ref.SOLVER_BLOCK`` = 16 coordinates; lanes, not
coordinates, fill the 132 SMs.

Beside it: the plain versions (``ref.solve_lanes`` /
``ref.solve_lanes_gram``) and the launch counter ``LAUNCHES``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rbf import sech2_consts

KINDS = {"linear": 0, "rbf": 1, "sech2": 2}
GRAM = 3

LAUNCHES = build.LaunchCounter("solver")


def _launch(x, y, c_box, gamma, gram, kind_code, p, g, l, n, d, n_epochs,
            consts) -> tuple[torch.Tensor, torch.Tensor]:
    dev = y.device
    alpha = torch.empty((p, g, l, n), dtype=torch.float32, device=dev)
    f = torch.empty_like(alpha)
    lib = build.library("solver")
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.k2_solve_lanes(
            ptr(x), ptr(y), ptr(c_box), ptr(gamma), ptr(gram),
            alpha.data_ptr(), f.data_ptr(), p, g, l, n, d, kind_code,
            int(n_epochs), *consts, stream)
    build.check(lib, "k2", rc)
    LAUNCHES.count += 1
    return alpha, f


def solve_lanes_cuda(x: torch.Tensor, y: torch.Tensor, c_box: torch.Tensor,
                     gamma: torch.Tensor, kind: str = "rbf",
                     n_epochs: int = 200, n_slope: float = 1.38, v_t: float = 0.02585,
                     v_scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K2 in a tile mode: ``x (P, n, d)``, ``y (P, n)``,
    ``c_box (P, L, n)``, ``gamma (P, G)`` -> ``(alpha, f)`` (P, G, L, n)."""
    if kind not in KINDS:
        raise ValueError(f"no tile body for kernel kind {kind!r}")
    p, n, d = x.shape
    g, l = gamma.shape[1], c_box.shape[1]
    build.check_tensor(x, "x", (p, n, d))
    build.check_tensor(y, "y", (p, n))
    build.check_tensor(c_box, "c_box", (p, l, n))
    build.check_tensor(gamma, "gamma", (p, g))
    return _launch(x, y, c_box, gamma, None, KINDS[kind], p, g, l, n, d,
                   n_epochs, sech2_consts(n_slope, v_t, v_scale))


def solve_lanes_gram_cuda(kp: torch.Tensor, y: torch.Tensor,
                          c_box: torch.Tensor, n_epochs: int = 200
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K2 in Gram-input mode: ``kp (P, G, n, n)`` (bias folded in),
    ``y (P, n)``, ``c_box (P, L, n)`` -> ``(alpha, f)`` (P, G, L, n)."""
    p, g, n, _ = kp.shape
    l = c_box.shape[1]
    build.check_tensor(kp, "kp", (p, g, n, n))
    build.check_tensor(y, "y", (p, n))
    build.check_tensor(c_box, "c_box", (p, l, n))
    return _launch(None, y, c_box, None, kp, GRAM, p, g, l, n, 0, n_epochs,
                   (1.0, 1.0, 1.0))
