"""Binary SVM training (paper Sec. II-A), the port of ``repro.core.svm``.

Dual coordinate ascent on the box-constrained dual with the bias folded
into the kernel (K' = K + 1), so every coordinate update is an independent
1-D clip.  A per-sample box ``C_i = 0`` masks a sample out: CV folds and
padded batches train without data-dependent shapes.

Training runs through solver lanes (``kernels.ops``): on the card the
fused hand kernel K2, on the CPU its plain version.  String kinds recompute
Gram rows from x; a callable kernel (hardware-in-the-loop) trains on a
stored Gram through K2's Gram-input mode.

The recovered model is ``f(x) = sum_j a_j y_j (K(x_j, x) + 1)``, so the bias
is ``b = sum_j a_j y_j`` and, for the linear kernel, ``w = sum_j a_j y_j
x_j`` (paper Eq. 3).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import kernels as kern
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class SVMModel:
    """A trained binary SVM. Arrays are host numpy for easy serialization."""

    kind: str  # 'linear' | 'rbf' | 'sech2' | 'hw'
    support_x: np.ndarray  # (m, d)
    support_y: np.ndarray  # (m,) in {-1, +1}
    alpha: np.ndarray  # (m,) > 0
    bias: float
    gamma: float  # only meaningful for RBF-family kernels
    c: float
    # Linear primal view (paper Eq. 3); None for rbf.
    w: Optional[np.ndarray] = None
    # Callable kernel for kind == 'hw' (hardware-in-the-loop training).
    kernel_fn: Optional[object] = dataclasses.field(default=None, compare=False)

    @property
    def n_support(self) -> int:
        return int(self.support_x.shape[0])


# --------------------------------------------------------------------------
# Solver lanes
# --------------------------------------------------------------------------


def callable_grams(kernel, x: torch.Tensor, gammas_pg: torch.Tensor
                   ) -> torch.Tensor:
    """Stored Grams ``(P, G, n, n)`` (bias folded in) of a callable kernel
    taking batched ``x (P, n, d), z (P, m, d), gamma (P,)``."""
    return torch.stack([kernel(x, x, gammas_pg[:, g])
                        for g in range(gammas_pg.shape[1])], dim=1) + 1.0


def solve_lanes(x: torch.Tensor, y: torch.Tensor, c_box: torch.Tensor,
                gammas_pg: torch.Tensor, kind, n_epochs: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(alpha, f)``, each ``(P, G, L, n)``: tile lanes for a kernel name,
    Gram-input lanes for a callable kernel."""
    if isinstance(kind, str):
        return kops.solve_lanes(x, y, c_box, gammas_pg, kind=kind,
                                n_epochs=n_epochs)
    return kops.solve_lanes_gram(callable_grams(kind, x, gammas_pg), y, c_box,
                                 n_epochs=n_epochs)


def cv_lanes_accuracy(
    x: torch.Tensor,           # (P, n, d)
    y: torch.Tensor,           # (P, n)
    fold_masks: torch.Tensor,  # (P, F, n) 1 train / 0 held-out
    valid: torch.Tensor,       # (P, n) 1 real / 0 padding
    gammas_pg: torch.Tensor,   # (P, G)
    cs: torch.Tensor,          # (C,)
    kind,
    n_epochs: int,
) -> torch.Tensor:
    """(P, G, C) mean CV accuracy over solver lanes.

    Lanes are the C-major flattening of (C, fold); the box folds the train
    mask and validity in, and validation reads the solver's margins ``f``
    directly, so no Gram is formed for the string kinds.
    """
    p, n_f, n = fold_masks.shape
    n_c = cs.shape[0]
    m_lanes = fold_masks.repeat(1, n_c, 1)                # (P, C*F, n)
    c_lanes = torch.repeat_interleave(cs, n_f)            # (C*F,)
    c_box = c_lanes[None, :, None] * m_lanes * valid[:, None, :]
    _, f = solve_lanes(x, y, c_box.contiguous(), gammas_pg, kind, n_epochs)
    pred = torch.where(f >= 0.0, 1.0, -1.0)               # (P, G, C*F, n)
    val = (1.0 - m_lanes) * valid[:, None, :]             # (P, C*F, n)
    hit = ((pred == y[:, None, None, :]) * val[:, None]).sum(-1)
    acc = hit / torch.clamp(val.sum(-1), min=1.0)[:, None]
    return _fold_mean(acc.reshape(p, gammas_pg.shape[1], n_c, n_f))


def _fold_mean(acc: torch.Tensor) -> torch.Tensor:
    """Mean over the last (fold) axis as the reference's f32 ``mean``
    lowers: a left-to-right sum times the f32 reciprocal of the count.

    Different folds can hold the same total, and which (gamma, C) cell the
    argmax picks then rests on the rounding of this mean; computing it the
    reference's way makes those picks agree.
    """
    total = acc[..., 0]
    for k in range(1, acc.shape[-1]):
        total = total + acc[..., k]
    return total * torch.tensor(1.0 / acc.shape[-1], dtype=acc.dtype)


def dual_coordinate_ascent(kp: torch.Tensor, y: torch.Tensor,
                           c_box: torch.Tensor,
                           n_epochs: int = 200) -> torch.Tensor:
    """Gauss-Seidel dual coordinate ascent, one coordinate at a time, with
    the full margin vector carried; returns alpha (n,).  The plain
    sequential form; the training paths use the blocked lanes, whose update
    sequence is the same."""
    n = kp.shape[0]
    qdiag = torch.clamp(torch.diagonal(kp), min=1e-12)
    alpha = torch.zeros((n,), dtype=kp.dtype, device=kp.device)
    f = torch.zeros((n,), dtype=kp.dtype, device=kp.device)
    for t in range(int(n_epochs) * n):
        i = t % n
        g = 1.0 - y[i] * f[i]
        a_new = torch.minimum(torch.clamp(alpha[i] + g / qdiag[i], min=0.0),
                              c_box[i])
        f = f + (a_new - alpha[i]) * y[i] * kp[:, i]
        alpha[i] = a_new
    return alpha


def _extract(kind, x: np.ndarray, y: np.ndarray, alpha: np.ndarray,
             gamma: float, c: float, sv_tol: float = 1e-6) -> SVMModel:
    """Support-set extraction (host-side) from a lane's alphas."""
    alpha = np.asarray(alpha[: len(y)])
    sv = alpha > sv_tol
    bias = float(np.sum(alpha[sv] * y[sv]))
    w = None
    if kind == "linear":
        w = np.asarray((alpha[sv] * y[sv]) @ x[sv], np.float64)
    return SVMModel(
        kind=kind if isinstance(kind, str) else "hw",
        support_x=np.asarray(x[sv], np.float64),
        support_y=np.asarray(y[sv], np.float64),
        alpha=np.asarray(alpha[sv], np.float64),
        bias=bias,
        gamma=float(gamma),
        c=float(c),
        w=w,
        kernel_fn=None if isinstance(kind, str) else kind,
    )


def train_binary(
    x: np.ndarray,
    y: np.ndarray,
    kind="linear",
    gamma: float = 1.0,
    c: float = 1.0,
    n_epochs: int = 200,
    sv_tol: float = 1e-6,
    device=None,
) -> SVMModel:
    """Train one binary SVM and extract its support set (host-side).

    ``kind`` may be a callable kernel (hardware-in-the-loop), recorded as
    kind='hw' with the callable kept on the model.
    """
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    xt = torch.as_tensor(np.ascontiguousarray(x), **f32)
    yt = torch.as_tensor(np.ascontiguousarray(y), **f32)
    n = x.shape[0]
    a, _ = solve_lanes(
        xt[None], yt[None],
        torch.full((1, 1, n), float(c), dtype=torch.float32, device=dev),
        torch.full((1, 1), float(gamma), dtype=torch.float32, device=dev),
        kind, n_epochs)
    return _extract(kind, x, y, a[0, 0, 0].cpu().numpy(), gamma, c, sv_tol)


def decision_function(model: SVMModel, x: np.ndarray,
                      device=None) -> np.ndarray:
    """f(x) without the sign (paper Eq. 1)."""
    if model.kind == "linear" and model.w is not None:
        return np.asarray(x, np.float64) @ model.w + model.bias
    dev = resolve_device(device)
    kind = model.kernel_fn if model.kernel_fn is not None else model.kind
    k = kern.kernel_matrix(
        kind, torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32,
                              device=dev),
        torch.as_tensor(model.support_x, dtype=torch.float32, device=dev),
        model.gamma)
    return np.asarray(k.cpu().numpy(), np.float64) \
        @ (model.alpha * model.support_y) + model.bias


def predict(model: SVMModel, x: np.ndarray, device=None) -> np.ndarray:
    """Hard labels in {-1, +1}; zeros break toward +1 (comparator convention)."""
    return np.where(decision_function(model, x, device) >= 0.0, 1.0, -1.0)


def accuracy(model: SVMModel, x: np.ndarray, y: np.ndarray,
             device=None) -> float:
    return float(np.mean(predict(model, x, device) == y))


# --------------------------------------------------------------------------
# Hyper-parameter grids and CV folds
# --------------------------------------------------------------------------


def cv_grid_accuracy(
    x: np.ndarray,
    y: np.ndarray,
    kind,
    gammas: np.ndarray,
    cs: np.ndarray,
    n_folds: int = 5,
    n_epochs: int = 120,
    seed: int = 0,
    device=None,
) -> np.ndarray:
    """(len(gammas), len(cs)) mean CV accuracy — all folds x grid as lanes."""
    dev = resolve_device(device)
    n = x.shape[0]
    rng = np.random.RandomState(seed)
    fold_of = rng.permutation(n) % n_folds
    masks = np.stack([(fold_of != f).astype(np.float32)
                      for f in range(n_folds)])
    f32 = dict(dtype=torch.float32, device=dev)
    acc = cv_lanes_accuracy(
        torch.as_tensor(np.ascontiguousarray(x), **f32)[None],
        torch.as_tensor(np.ascontiguousarray(y), **f32)[None],
        torch.as_tensor(masks, **f32)[None], torch.ones((1, n), **f32),
        torch.as_tensor(np.asarray(gammas), **f32)[None],
        torch.as_tensor(np.asarray(cs), **f32), kind, n_epochs)
    return acc[0].cpu().numpy()


def fit_best(
    x: np.ndarray,
    y: np.ndarray,
    kind,
    gammas: np.ndarray | None = None,
    cs: np.ndarray | None = None,
    n_folds: int = 5,
    n_epochs: int = 200,
    seed: int = 0,
    cv_epochs: int | None = None,
    device=None,
) -> tuple[SVMModel, float]:
    """Grid-search (gamma, C) by CV, refit on the full set. Returns (model, cv_acc).

    ``cv_epochs`` defaults to ``max(60, n_epochs // 2)``; the refit runs the
    full ``n_epochs``.
    """
    if cs is None:
        cs = np.logspace(-1, 3, 7)
    if kind == "linear":
        gammas = np.array([1.0])
    elif gammas is None:
        gammas = np.logspace(-1, 2, 7)
    if cv_epochs is None:
        cv_epochs = max(60, n_epochs // 2)
    acc = cv_grid_accuracy(x, y, kind, gammas, cs, n_folds, int(cv_epochs),
                           seed, device=device)
    gi, ci = np.unravel_index(np.argmax(acc), acc.shape)
    model = train_binary(x, y, kind, float(gammas[gi]), float(cs[ci]),
                         n_epochs, device=device)
    return model, float(acc[gi, ci])
