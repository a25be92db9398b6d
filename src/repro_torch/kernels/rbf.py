"""K1: the tiled RBF / sech2 kernel matrix of a whole bank, hand-written
in CUDA C++ for Hopper (``csrc/kernel_matrix.cu``, tile bodies in
``csrc/tiles.cuh``).

Replaces the Pallas TPU kernel ``repro/kernels/rbf.py::kernel_matrix_pallas``
(bodies ``_rbf_kernel``/``_sech2_kernel``), which the reference vmaps over
a kernel bank's pairs.  One launch here scores every pair of a bank:
``x (n, d)`` against ``sv (P, m, d)`` with per-pair ``gamma (P,)`` ->
``(P, n, m)``.

What bounds it on the card: at d <= 5 each output costs a few FMAs and
one ``exp`` (rbf) or one ``exp`` per dimension (sech2, in product form),
so both kinds are bound by writing their output; there is no matrix
product worth the tensor cores.  Each thread keeps 4 support
vectors in registers, walks 8 query rows and writes 4 consecutive outputs
per row with one float4 streaming store.  At the main path's shapes (a
deployed bank, a few thousand outputs) the call is its host time, so the
wrapper does no more per call than its checks, one allocation and the
launch.

Beside it: the plain version (``kernel_matrix_plain``, from ``ref.py``) and
the launch counter ``LAUNCHES``.  ``v_scale`` defaults to 0.5 here, as the
reference's entry point does; the compiled machines pass 1.0.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.tracing import LaunchCounter

KINDS = {"rbf": 1, "sech2": 2}

LAUNCHES = LaunchCounter("kernel_matrix")


@functools.lru_cache(maxsize=64)
def sech2_consts(n_slope: float, v_t: float, v_scale: float
                 ) -> tuple[float, float, float]:
    """``(gamma0, v_scale, n_slope * V_T)`` as the f32 kernel receives them."""
    gamma0 = 1.0 / (4.0 * n_slope**2 * v_t**2) * v_scale**2
    return gamma0, v_scale, n_slope * v_t


def kernel_matrix_plain(x: torch.Tensor, sv: torch.Tensor,
                        gamma: torch.Tensor, kind: str = "rbf",
                        n_slope: float = 1.38, v_t: float = 0.02585,
                        v_scale: float = 0.5) -> torch.Tensor:
    """Plain PyTorch version of K1: ``(P, n, m)``."""
    xb = x[None]
    if kind == "rbf":
        return ref.rbf_matrix(xb, sv, gamma)
    if kind == "sech2":
        return ref.sech2_matrix(xb, sv, gamma, n_slope, v_t, v_scale)
    raise ValueError(f"no kernel matrix for kind {kind!r}")


def kernel_matrix_cuda(x: torch.Tensor, sv: torch.Tensor,
                       gamma: torch.Tensor, kind: str = "rbf",
                       n_slope: float = 1.38, v_t: float = 0.02585,
                       v_scale: float = 0.5) -> torch.Tensor:
    """Launch K1 on the current stream: ``(P, n, m)`` f32."""
    code = KINDS.get(kind)
    if code is None:
        raise ValueError(f"no kernel matrix for kind {kind!r}")
    p, m, d = sv.shape
    n = x.shape[0]
    build.check_tensor(x, "x", (n, d))
    build.check_tensor(sv, "sv", (p, m, d))
    build.check_tensor(gamma, "gamma", (p,))
    dev = x.device
    if sv.device != dev or gamma.device != dev:
        raise ValueError("x, sv and gamma must be on one device")
    out = torch.empty((p, n, m), dtype=torch.float32, device=dev)
    lib = build.library("kernel_matrix")
    rc = build.launch(lib.k1_kernel_matrix, dev, x.data_ptr(), sv.data_ptr(),
                      gamma.data_ptr(), out.data_ptr(), p, n, m, d, code,
                      *sech2_consts(n_slope, v_t, v_scale))
    build.check(lib, "k1", rc)
    LAUNCHES.launched((p, n, m, d, code))
    return out
