"""Batched Algorithm-1 training engine, the port of ``repro.core.trainer``.

Algorithm 1 is restructured as a fixed-shape batched program:

1.  **Padding** (``pad_pairs``): every binary subset D_ij is padded to the
    shared ``n_max`` and stacked into ``(P, n_max, d)`` tensors.  Padding
    rows get ``valid = 0``, which zeroes their box (``c_box = c * mask *
    valid``) — alpha stays exactly 0 — and their CV-validation weight.

2.  **One solve per kernel family and phase**: all pairs x CV folds x
    (C, gamma) grid cells of a family are solver lanes of ONE launch of the
    fused solver (``repro_torch.kernels``): grid ``(P, G, C*F)``.  The
    linear and rbf families recompute Gram rows from x; the
    hardware-in-the-loop family (measured-curve kernel, no tile body) runs
    the same solver on stored per-(pair, gamma) Grams.

3.  **Selection as argmax** (``train_pairs``): per family the first
    maximum of the ``(P, G, C)`` CV-accuracy tensor in gamma-major order
    (as ``np.unravel_index(np.argmax(...))``), one full-set refit launch,
    and a host-side extraction of the support sets.

The shard_map and size-sharded layouts of the reference wait for a later
slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import kernels as kern
from repro_torch.core import svm as svm_mod
from repro_torch.core.analog import AnalogRBFModel, CircuitParams
from repro_torch.core.ovo import class_pairs
from repro_torch.core.svm import SVMModel
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops

#: fit_best's hyper-parameter grid defaults (paper Sec. V-A2).
DEFAULT_CS = np.logspace(-1, 3, 7)
DEFAULT_RBF_GAMMAS = np.logspace(-1, 2, 7)


@dataclasses.dataclass
class PairResult:
    """Per-OvO-pair outcome of Algorithm 1 (both candidates kept)."""

    pair: tuple[int, int]
    kernel: str                      # selected kernel kind
    model: SVMModel                  # selected float model
    acc_linear: float                # CV accuracy of the linear candidate
    acc_rbf: float                   # CV accuracy of the RBF candidate
    model_linear: SVMModel           # both candidates kept for baselines
    model_rbf: SVMModel
    # Hardware-aware co-optimized model (measured-curve kernel) for analog
    # deployment; only kept for RBF-assigned pairs unless hw_all.
    model_hw: Optional[SVMModel] = None


def binary_subset(x: np.ndarray, y: np.ndarray, ci: int, cj: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Line 5: D_ij = {(x, y) in D | y in {c_i, c_j}}, labels -> {+1, -1}.

    +1 encodes c_i (the pair's first class) so bit==1 <=> c_i wins.
    """
    mask = (y == ci) | (y == cj)
    yy = np.where(y[mask] == ci, 1.0, -1.0)
    return x[mask], yy


def default_hw(seed: int = 0, params: Optional[CircuitParams] = None,
               offsets=None) -> AnalogRBFModel:
    """The default calibrated analog behavioral model (one fabricated core).

    ``offsets = (gauss (4,), alpha (2,))`` are the core's standard-normal
    mismatch draws.  By default they come from a ``torch.Generator`` seeded
    with ``seed`` (gauss first), so the model is deterministic in
    ``(seed, params)``; pass them in to reproduce another core, e.g. the
    reference's ``jax.random`` draws.
    """
    if offsets is None:
        gen = torch.Generator().manual_seed(int(seed))
        offsets = (torch.randn(4, generator=gen).numpy(),
                   torch.randn(2, generator=gen).numpy())
    gauss, alpha = offsets
    return AnalogRBFModel.from_circuit(
        params if params is not None else CircuitParams(),
        gauss_offsets=gauss, alpha_offsets=alpha)


def hw_gamma_grid(hw: AnalogRBFModel, n: int = 7) -> np.ndarray:
    """Hardware-realizable gamma* grid for the co-optimized training: the
    scaled differential voltage must stay within the cell's usable range
    (s * v_scale * max|dx| <= v_range with max|dx| = 1)."""
    g_cap = hw.gamma0_feature() * (hw.params.v_range / hw.v_scale) ** 2
    return np.logspace(-1.0, np.log10(g_cap), n)


# ---------------------------------------------------------------------------
# Padded pair stack
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PaddedPairs:
    """All OvO binary subsets padded to a shared ``n_max`` and stacked.

    Host arrays (f32): ``x (P, n_max, d)``, ``y (P, n_max)``, ``valid
    (P, n_max)`` (1 real / 0 padding), ``fold_masks (P, F, n_max)`` (1 train
    / 0 held-out, 0 on padding).  ``subsets`` keeps the unpadded float64
    views for the final model extraction.
    """

    pairs: list[tuple[int, int]]
    x: np.ndarray
    y: np.ndarray
    valid: np.ndarray
    fold_masks: np.ndarray
    n_true: list[int]
    subsets: list[tuple[np.ndarray, np.ndarray]]

    @property
    def n_pairs(self) -> int:
        return len(self.pairs)

    @property
    def n_max(self) -> int:
        return int(self.x.shape[1])


def cv_fold_assignment(n: int, n_folds: int, seed: int) -> np.ndarray:
    """Fold id per sample (each pair draws from a fresh ``RandomState(seed)``
    over its own subset size)."""
    rng = np.random.RandomState(seed)
    return rng.permutation(n) % n_folds


def pad_pairs(x_train: np.ndarray, y_train: np.ndarray, n_classes: int,
              n_folds: int = 5, seed: int = 0) -> PaddedPairs:
    """Extract every OvO binary subset and stack them padded to ``n_max``."""
    x_train = np.asarray(x_train)
    y_train = np.asarray(y_train)
    pairs = class_pairs(n_classes)
    subsets = [binary_subset(x_train, y_train, ci, cj) for ci, cj in pairs]
    n_true = [len(yb) for _, yb in subsets]
    n_max = max(n_true)
    p, d = len(pairs), x_train.shape[1]

    x = np.zeros((p, n_max, d), np.float32)
    y = np.ones((p, n_max), np.float32)     # +1 on padding: inert either way
    valid = np.zeros((p, n_max), np.float32)
    masks = np.zeros((p, n_folds, n_max), np.float32)
    for i, (xb, yb) in enumerate(subsets):
        n = n_true[i]
        x[i, :n] = xb
        y[i, :n] = yb
        valid[i, :n] = 1.0
        fold_of = cv_fold_assignment(n, n_folds, seed)
        for f in range(n_folds):
            masks[i, f, :n] = (fold_of != f)
    return PaddedPairs(pairs=pairs, x=x, y=y, valid=valid, fold_masks=masks,
                       n_true=n_true, subsets=subsets)


# ---------------------------------------------------------------------------
# Blocked Gauss-Seidel solver
# ---------------------------------------------------------------------------

def dual_coordinate_ascent_blocked(kp: torch.Tensor, y: torch.Tensor,
                                   c_box: torch.Tensor, n_epochs: int
                                   ) -> torch.Tensor:
    """One lane of the blocked solver on a materialized Gram ``K' (n, n)``.

    Entering each block of ``kernels.ref.SOLVER_BLOCK`` coordinates its
    margins are computed fresh from the current alphas, then Gauss-Seidel
    runs inside the block.
    The same update sequence as the reference oracle; it runs through the
    solver's Gram-input mode (the hand kernel for a CUDA tensor).
    """
    alpha, _ = kops.solve_lanes_gram(kp[None, None], y[None], c_box[None, None],
                                     n_epochs=n_epochs)
    return alpha[0, 0, 0]


# ---------------------------------------------------------------------------
# Hardware-in-the-loop training kernel: uniform-grid fast interpolation
# ---------------------------------------------------------------------------


def _training_kernel(kind, device: torch.device):
    """Resolve the kernel used inside the training lanes.

    A bound ``AnalogRBFModel.kernel_response`` becomes an equivalent
    closure that interpolates the measured transfer curve with the O(1)
    uniform-grid bin location of ``kernels._uniform_interp`` (the DC-sweep
    abscissa is a linspace), accumulating the per-dimension product in
    ``(..., n, m)`` temporaries.  It takes batched ``x (P, n, d)``,
    ``sv (P, m, d)`` and ``gamma (P,)``.
    """
    hw = getattr(kind, "__self__", None)
    if not isinstance(hw, AnalogRBFModel):
        return kind
    fp = kern._grid_fast_path(np.asarray(hw.dv_grid))
    if not fp["uniform_grid"]:
        return kind
    curve = torch.as_tensor(np.asarray(hw.kernel_curve, np.float32),
                            device=device)
    grid = np.asarray(hw.dv_grid, np.float32)
    lo, hi = float(grid[0]), float(grid[-1])
    left = float(hw.kernel_curve[0])
    right = float(hw.kernel_curve[-1])
    inv_step = np.float32(fp["inv_step"])

    def fast_hw_kernel(x, sv, gamma_star):
        s = hw.input_scale(gamma_star)[..., None, None]
        acc = None
        for k in range(x.shape[-1]):
            dv = hw.v_scale * s * (x[..., :, None, k] - sv[..., None, :, k]) \
                + hw.mu
            cell = kern._uniform_interp(dv, curve, lo, hi, left, right,
                                        inv_step)
            acc = cell if acc is None else acc * cell
        return acc

    return fast_hw_kernel


# ---------------------------------------------------------------------------
# Family programs: CV grid, refit
# ---------------------------------------------------------------------------


def _cv_grid_all_pairs(x, y, fold_masks, valid, gammas, cs, kind,
                       n_epochs) -> torch.Tensor:
    """(P, G, C) CV accuracy of every pair: one lanes launch."""
    gammas_pg = gammas[None].expand(x.shape[0], -1).contiguous()
    return svm_mod.cv_lanes_accuracy(x, y, fold_masks, valid, gammas_pg, cs,
                                     kind, n_epochs)


def _refit_all_pairs(x, y, valid, gamma_sel, c_sel, kind,
                     n_epochs) -> torch.Tensor:
    """Full-set refit of every pair at its selected (gamma, C): (P, n)."""
    c_box = (c_sel[:, None] * valid)[:, None, :].contiguous()   # (P, 1, n)
    alpha, _ = svm_mod.solve_lanes(x, y, c_box, gamma_sel[:, None].contiguous(),
                                   kind, n_epochs)
    return alpha[:, 0, 0]


def _family_program(x, y, fold_masks, valid, gammas, cs, kind, cv_epochs,
                    n_epochs):
    """The whole family: CV grid -> argmax -> full refit.

    Returns ``(acc (P, G, C), gi (P,), ci (P,), alpha (P, n))``; the argmax
    is the first maximum over the gamma-major flattened grid.
    """
    n_c = cs.shape[0]
    acc = _cv_grid_all_pairs(x, y, fold_masks, valid, gammas, cs, kind,
                             cv_epochs)
    flat = torch.argmax(acc.reshape(acc.shape[0], -1), dim=1)
    gi, ci = flat // n_c, flat % n_c
    alpha = _refit_all_pairs(x, y, valid, gammas[gi], cs[ci], kind, n_epochs)
    return acc, gi, ci, alpha


# ---------------------------------------------------------------------------
# Selection + model extraction (host-side)
# ---------------------------------------------------------------------------


def _argmax_grid(acc: np.ndarray, gammas: np.ndarray, cs: np.ndarray
                 ) -> tuple[float, float, float]:
    """fit_best's line-8 pick: first flat argmax, gamma-major order."""
    gi, ci = np.unravel_index(np.argmax(acc), acc.shape)
    return float(gammas[gi]), float(cs[ci]), float(acc[gi, ci])


#: Support-set extraction — the tail of ``svm.train_binary``.
_extract_model = svm_mod._extract


def _train_family(padded: PaddedPairs, kind, gammas: np.ndarray,
                  cs: np.ndarray, n_epochs: int, cv_epochs: int,
                  device: torch.device) -> tuple[list[SVMModel], list[float]]:
    """CV-grid + select + refit one family for every pair in ``padded``."""
    f32 = dict(dtype=torch.float32, device=device)
    acc, gi, ci, alphas = _family_program(
        torch.as_tensor(padded.x, **f32), torch.as_tensor(padded.y, **f32),
        torch.as_tensor(padded.fold_masks, **f32),
        torch.as_tensor(padded.valid, **f32),
        torch.as_tensor(np.asarray(gammas), **f32),
        torch.as_tensor(np.asarray(cs), **f32),
        _training_kernel(kind, device), int(cv_epochs), int(n_epochs))
    acc, alphas = acc.cpu().numpy(), alphas.cpu().numpy()
    sel = [(float(gammas[g]), float(cs[c]), float(acc[p, g, c]))
           for p, (g, c) in enumerate(zip(gi.tolist(), ci.tolist()))]
    models = [
        _extract_model(kind, xb, yb, alphas[i], sel[i][0], sel[i][1])
        for i, (xb, yb) in enumerate(padded.subsets)
    ]
    return models, [s[2] for s in sel]


def train_pairs(
    x_train: np.ndarray,
    y_train: np.ndarray,
    n_classes: int,
    hw: Optional[AnalogRBFModel] = None,
    n_epochs: int = 200,
    seed: int = 0,
    tie_margin: float = 0.005,
    cv_epochs: Optional[int] = None,
    n_folds: int = 5,
    hw_all: bool = False,
    device=None,
) -> list[PairResult]:
    """Algorithm 1, batched: two solver launches (CV grid, refit) per family.

    ``cv_epochs`` defaults to ``max(60, n_epochs // 2)``.  The three
    families are linear, rbf and the hardware-in-the-loop family trained
    with ``hw``'s measured-curve kernel on a realizable gamma grid (for
    every pair; ``hw_all`` keeps that candidate for every pair instead of
    only the RBF-selected ones).
    """
    dev = resolve_device(device)
    if hw is None:
        hw = default_hw(seed)
    if cv_epochs is None:
        cv_epochs = max(60, n_epochs // 2)
    padded = pad_pairs(x_train, y_train, n_classes, n_folds=n_folds,
                       seed=seed)
    cs = DEFAULT_CS
    lin_models, lin_accs = _train_family(padded, "linear", np.array([1.0]),
                                         cs, n_epochs, cv_epochs, dev)
    rbf_models, rbf_accs = _train_family(padded, "rbf", DEFAULT_RBF_GAMMAS,
                                         cs, n_epochs, cv_epochs, dev)
    hw_models, _ = _train_family(padded, hw.kernel_response,
                                 hw_gamma_grid(hw), cs, n_epochs, cv_epochs,
                                 dev)

    # Line 8: RBF only when STRICTLY better (beyond the CV-noise margin).
    kinds = ["rbf" if a_r > a_l + tie_margin else "linear"
             for a_l, a_r in zip(lin_accs, rbf_accs)]

    results = []
    for i, pair in enumerate(padded.pairs):
        kind = kinds[i]
        m_hw = hw_models[i] if (hw_all or kind == "rbf") else None
        results.append(PairResult(
            pair=pair, kernel=kind,
            model=m_hw if kind == "rbf" else lin_models[i],
            acc_linear=lin_accs[i], acc_rbf=rbf_accs[i],
            model_linear=lin_models[i], model_rbf=rbf_models[i],
            model_hw=m_hw,
        ))
    return results
