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

The stored Grams of the hardware-in-the-loop family are gated by
:data:`CV_GRID_VMAP_BYTES`: past it the CV grid runs one Gram-input launch
per gamma (``_seq_gamma``), so one gamma's Grams are live at a time.  For
K >= 10 the size-sharded layout (``shard_lane_layout``,
``family_cv_grid_size_sharded``) trims each shard of pairs to its own
largest subset and runs it as its own launch, on its own CUDA stream.

**Scaling out** (``mesh=``): the CV grid optionally splits its flattened
(pair x gamma) cells over a ``launch.mesh.make_trainer_mesh`` mesh
(``_cv_grid_sharded``, axis :data:`PAIRGRID_AXIS`): each device runs its
share as one lanes launch, and no device waits for another.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import kernels as kern
from repro_torch.core import svm as svm_mod
from repro_torch.core.analog import AnalogRBFModel, CircuitParams
from repro_torch.core.ovo import class_pairs
from repro_torch.core.svm import SVMModel
from repro_torch.device import device_key, mesh_device, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import require_axis

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

    def take(self, idx: Sequence[int]) -> "PaddedPairs":
        """Sub-stack along the pair axis (e.g. the RBF-selected pairs)."""
        idx = list(idx)
        return PaddedPairs(
            pairs=[self.pairs[i] for i in idx],
            x=self.x[idx], y=self.y[idx], valid=self.valid[idx],
            fold_masks=self.fold_masks[idx],
            n_true=[self.n_true[i] for i in idx],
            subsets=[self.subsets[i] for i in idx],
        )

    def trim(self) -> "PaddedPairs":
        """Re-pad to this stack's OWN max subset size.

        ``take`` keeps the original global ``n_max``; a size-sharded
        layout (``shard_lane_layout``) trims each shard so its solver
        lanes pay only the shard's padding, not the global tail's.
        Slicing is exact: rows past a pair's ``n_true`` are padding
        (valid 0, y +1, mask 0) whatever the stack width.
        """
        m = max(self.n_true)
        if m == self.n_max:
            return self
        return PaddedPairs(
            pairs=self.pairs, x=self.x[:, :m], y=self.y[:, :m],
            valid=self.valid[:, :m], fold_masks=self.fold_masks[:, :, :m],
            n_true=self.n_true, subsets=self.subsets)


def _pair_tensors(padded: PaddedPairs, device: torch.device):
    """``(x, y, fold_masks, valid)`` of a stack as f32 tensors on
    ``device``."""
    f32 = dict(dtype=torch.float32, device=device)
    return tuple(torch.as_tensor(np.ascontiguousarray(a), **f32)
                 for a in (padded.x, padded.y, padded.fold_masks,
                           padded.valid))


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


#: Gram-footprint gate for the CV grid of a callable (hardware-in-the-loop)
#: kernel: when its stored per-gamma Gram stack (P * G * n_max^2 f32 bytes)
#: would exceed this, the gamma axis runs one Gram-input launch per gamma,
#: so one gamma's Grams are live at a time.  At the scale-out workload
#: (P=66, G=7, n_max=1582) the stack is ~4.6 GB; one gamma's is 660 MB.
#: The string kinds recompute Gram rows inside the solver and never store
#: one.  The reference's limit holds on an 80 GB H100 too: there each of
#: the 7 per-gamma launches already fills the 132 SMs (66 cells x 2 CTAs),
#: the stacked launch runs the same CTAs in 7 waves, and chip_smoke.py's
#: phase 10 measures the full har12 fit as fast either way with ~4 GB more
#: peak memory stacked.
CV_GRID_VMAP_BYTES = 1 << 30


def _seq_gamma(x, gammas) -> bool:
    """The sequential-gamma choice of the CV grid, from shapes alone."""
    p, n = x.shape[0], x.shape[1]
    return p * gammas.shape[0] * n * n * 4 > CV_GRID_VMAP_BYTES


def _cv_grid_all_pairs(x, y, fold_masks, valid, gammas, cs, kind,
                       n_epochs) -> torch.Tensor:
    """(P, G, C) CV accuracy of every pair: one lanes launch, or one per
    gamma for a callable kernel past the Gram gate (the lanes of one gamma
    do not depend on another's, so the results are the same)."""
    gammas_pg = gammas[None].expand(x.shape[0], -1).contiguous()
    if isinstance(kind, str) or not _seq_gamma(x, gammas):
        return svm_mod.cv_lanes_accuracy(x, y, fold_masks, valid, gammas_pg,
                                         cs, kind, n_epochs)
    return torch.cat([
        svm_mod.cv_lanes_accuracy(x, y, fold_masks, valid,
                                  gammas_pg[:, g:g + 1].contiguous(), cs,
                                  kind, n_epochs)
        for g in range(gammas_pg.shape[1])], dim=1)


def _refit_all_pairs(x, y, valid, gamma_sel, c_sel, kind,
                     n_epochs) -> torch.Tensor:
    """Full-set refit of every pair at its selected (gamma, C): (P, n)."""
    c_box = (c_sel[:, None] * valid)[:, None, :].contiguous()   # (P, 1, n)
    alpha, _ = svm_mod.solve_lanes(x, y, c_box, gamma_sel[:, None].contiguous(),
                                   kind, n_epochs)
    return alpha[:, 0, 0]


def family_cv_grid(padded: PaddedPairs, kind, gammas: np.ndarray,
                   cs: np.ndarray, n_epochs: int, device=None,
                   mesh=None) -> np.ndarray:
    """CV-accuracy tensor ``(P, |gammas|, |cs|)`` for one kernel family.

    ``kind`` is a kernel name or a callable (hardware-in-the-loop); the
    grid runs on ``device`` (None: the card), or with a ``mesh`` split
    over the mesh's devices by (pair, gamma) cell (``_cv_grid_sharded``).
    """
    if mesh is not None:
        return _cv_grid_sharded(padded, kind, gammas, cs, n_epochs, mesh)
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    return _cv_grid_all_pairs(
        *_pair_tensors(padded, dev), torch.as_tensor(np.asarray(gammas), **f32),
        torch.as_tensor(np.asarray(cs), **f32), _training_kernel(kind, dev),
        int(n_epochs)).cpu().numpy()


def family_refit(padded: PaddedPairs, kind, gamma_sel: np.ndarray,
                 c_sel: np.ndarray, n_epochs: int, device=None) -> np.ndarray:
    """Full-set solve of every pair at its selected hyper-parameters:
    alphas ``(P, n_max)``."""
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    x, y, _, valid = _pair_tensors(padded, dev)
    return _refit_all_pairs(
        x, y, valid, torch.as_tensor(np.asarray(gamma_sel), **f32),
        torch.as_tensor(np.asarray(c_sel), **f32),
        _training_kernel(kind, dev), int(n_epochs)).cpu().numpy()


# ---------------------------------------------------------------------------
# The mesh leg: the pair x gamma cells across devices
# ---------------------------------------------------------------------------

#: Mesh axis the sharded CV grid distributes over.
PAIRGRID_AXIS = mesh_mod.PAIRGRID_AXIS


def _cv_grid_sharded(padded: PaddedPairs, kind, gammas, cs, n_epochs: int,
                     mesh) -> np.ndarray:
    """The same (P, G, C) CV grid, split over flattened (pair, gamma) cells.

    Each cell is independent, so the cells (pair-major, as the output
    reshapes) are padded with repeats of cell 0 up to a multiple of the
    device count and split into one contiguous share per device.  A share
    runs as the lanes of ``(cells, 1, C*F)`` through the solver (one
    launch on a card; a callable kernel's share in pieces whose stored
    Grams stay under :data:`CV_GRID_VMAP_BYTES`), each device on its own
    stream; the padded outputs are dropped.
    """
    n_dev = require_axis(mesh, PAIRGRID_AXIS, "make_trainer_mesh")
    g_host = np.asarray(gammas, np.float32)
    c_host = np.asarray(cs, np.float32)
    p, g = padded.n_pairs, len(g_host)
    total = p * g

    def rep(a):  # (P, ...) -> (P*G, ...), pair-major like the output
        return np.repeat(a, g, axis=0)

    cells = [rep(padded.x), rep(padded.y), rep(padded.fold_masks),
             rep(padded.valid), np.tile(g_host, p)]
    n_pad = (-total) % n_dev
    if n_pad:
        cells = [np.concatenate([a] + [a[:1]] * n_pad) for a in cells]
    per = (total + n_pad) // n_dev
    n = padded.n_max
    step = per
    if not isinstance(kind, str):
        step = max(1, min(per, CV_GRID_VMAP_BYTES // (n * n * 4)))
    kernels: dict = {}
    pending = []
    for i, dev in enumerate(mesh.devices):
        key = device_key(dev)
        if key not in kernels:
            kernels[key] = _training_kernel(kind, dev)
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(dev))
        f32 = dict(dtype=torch.float32, device=dev)
        parts = []
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            c_dev = torch.as_tensor(c_host, **f32)
            for lo in range(i * per, (i + 1) * per, step):
                hi = min(lo + step, (i + 1) * per)
                xs, ys, fs, vs, gs = (
                    torch.as_tensor(np.ascontiguousarray(a[lo:hi]), **f32)
                    for a in cells)
                parts.append(svm_mod.cv_lanes_accuracy(
                    xs, ys, fs, vs, gs[:, None], c_dev, kernels[key],
                    int(n_epochs))[:, 0, :])
        pending.append((parts, stream))
    out = []
    for parts, stream in pending:
        if stream is not None:
            torch.cuda.current_stream(parts[0].device).wait_stream(stream)
        out.extend(part.cpu().numpy() for part in parts)
    return np.concatenate(out)[:total].reshape(p, g, len(c_host))


# ---------------------------------------------------------------------------
# Size-sharded lane layout: launches padded to their own shard max
# ---------------------------------------------------------------------------


def shard_lane_layout(n_true: Sequence[int], n_shards: int
                      ) -> list[np.ndarray]:
    """Partition pairs into ``<= n_shards`` contiguous size-sorted shards.

    The global-pad layout (`pad_pairs` + one launch) makes every solver
    lane pay ``n_max^2`` work; with the long-tailed subset sizes of a
    K>=10 OvO grid (har12: 198..1582) most of that is padding.  This
    layout sorts pairs by true subset size and chooses shard boundaries
    by dynamic programming to minimize the MAKESPAN of padded work,
    modeling a shard's cost as ``count * shard_max^2`` (the blocked
    solver's dominant term).  Each shard is then trimmed to its own max
    (``PaddedPairs.trim``) and run as its own launch, so the padding
    waste is bounded by the within-shard size spread rather than the
    global one.

    Returns a list of index arrays into the ORIGINAL pair order; their
    concatenation is a permutation of ``range(len(n_true))``.  At
    ``n_shards=1`` this degenerates to one shard at the global max.
    O(n_shards * P^2) — trivial at P=66.
    """
    p = len(n_true)
    if p == 0:
        return []
    n_shards = max(1, min(int(n_shards), p))
    order = np.argsort(np.asarray(n_true), kind="stable")
    sizes = np.asarray(n_true)[order].astype(np.int64)

    def cost(i, j):  # shard = sorted pairs [i, j)
        return int(j - i) * int(sizes[j - 1]) ** 2

    inf = float("inf")
    best = [[inf] * (n_shards + 1) for _ in range(p + 1)]
    cut = [[0] * (n_shards + 1) for _ in range(p + 1)]
    best[0][0] = 0.0
    for j in range(1, p + 1):
        for s in range(1, min(n_shards, j) + 1):
            for i in range(s - 1, j):
                if best[i][s - 1] == inf:
                    continue
                c = max(best[i][s - 1], cost(i, j))
                if c < best[j][s]:
                    best[j][s], cut[j][s] = c, i
    s_best = min(range(1, n_shards + 1), key=lambda s: best[p][s])
    bounds, j = [], p
    for s in range(s_best, 0, -1):
        i = cut[j][s]
        bounds.append((i, j))
        j = i
    bounds.reverse()
    return [order[i:j] for i, j in bounds]


def family_cv_grid_size_sharded(padded: PaddedPairs, kind,
                                gammas: np.ndarray, cs: np.ndarray,
                                n_epochs: int, devices=None) -> np.ndarray:
    """(P, G, C) CV grid via size-sharded launches.

    Pairs are partitioned by subset size (`shard_lane_layout`, one shard
    per entry of ``devices``), each shard is trimmed to its own max and
    runs as its own lanes launch on its device, and the results are
    gathered back into the original pair order.  ``devices`` (None: [the
    card]) may name one card more than once: each shard on a card runs on
    its own CUDA stream, so small shards overlap, and the streams are
    joined before the gather.

    On one card the win is the padded-work saving: har12's size spread
    makes the summed ``count * shard_max^2`` ~3.9x smaller at 8 shards
    than the global pad.
    """
    devs = [resolve_device(d) for d in (devices if devices is not None
                                        else [None])]
    shards = shard_lane_layout(padded.n_true, len(devs))
    g_host = np.asarray(gammas, np.float32)
    c_host = np.asarray(cs, np.float32)
    out = np.empty((padded.n_pairs, len(g_host), len(c_host)), np.float32)
    kernels: dict[torch.device, object] = {}
    pending = []
    for shard_idx, dev in zip(shards, devs):
        sub = padded.take([int(i) for i in shard_idx]).trim()
        if dev not in kernels:
            kernels[dev] = _training_kernel(kind, dev)
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(dev))
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            f32 = dict(dtype=torch.float32, device=dev)
            acc = _cv_grid_all_pairs(
                *_pair_tensors(sub, dev), torch.as_tensor(g_host, **f32),
                torch.as_tensor(c_host, **f32), kernels[dev], int(n_epochs))
        pending.append((shard_idx, acc, stream))
    for shard_idx, acc, stream in pending:
        if stream is not None:
            torch.cuda.current_stream(acc.device).wait_stream(stream)
        out[np.asarray(shard_idx)] = acc.cpu().numpy()
    return out


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
                  device: torch.device, mesh=None
                  ) -> tuple[list[SVMModel], list[float]]:
    """CV-grid + select + refit one family for every pair in ``padded``:
    the grid on ``device`` (or split over ``mesh``), the host-side first
    argmax of each pair's grid, the refit on ``device``."""
    acc = family_cv_grid(padded, kind, gammas, cs, cv_epochs, device=device,
                         mesh=mesh)
    sel = [_argmax_grid(acc[i], gammas, cs) for i in range(padded.n_pairs)]
    alphas = family_refit(
        padded, kind, np.asarray([s[0] for s in sel], np.float32),
        np.asarray([s[1] for s in sel], np.float32), n_epochs, device=device)
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
    mesh=None,
) -> list[PairResult]:
    """Algorithm 1, batched: two solver launches (CV grid, refit) per family.

    ``cv_epochs`` defaults to ``max(60, n_epochs // 2)``.  The three
    families are linear, rbf and the hardware-in-the-loop family trained
    with ``hw``'s measured-curve kernel on a realizable gamma grid (for
    every pair; ``hw_all`` keeps that candidate for every pair instead of
    only the RBF-selected ones).  ``mesh`` (``launch.mesh.
    make_trainer_mesh``) runs the CV grids split over its devices; the
    refits then run on ``device``, by default the mesh's first device.
    """
    dev = mesh_device(device, mesh)
    if hw is None:
        hw = default_hw(seed)
    if cv_epochs is None:
        cv_epochs = max(60, n_epochs // 2)
    padded = pad_pairs(x_train, y_train, n_classes, n_folds=n_folds,
                       seed=seed)
    cs = DEFAULT_CS
    lin_models, lin_accs = _train_family(padded, "linear", np.array([1.0]),
                                         cs, n_epochs, cv_epochs, dev, mesh)
    rbf_models, rbf_accs = _train_family(padded, "rbf", DEFAULT_RBF_GAMMAS,
                                         cs, n_epochs, cv_epochs, dev, mesh)
    hw_models, _ = _train_family(padded, hw.kernel_response,
                                 hw_gamma_grid(hw), cs, n_epochs, cv_epochs,
                                 dev, mesh)

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
