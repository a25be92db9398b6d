"""Batched kernel-assignment design-space exploration (the port of
``repro.core.dse``).

Algorithm 1 realizes ONE point of the co-optimization space (the greedy
``tie_margin`` rule); this module explores the whole space as three
vectorized passes over an ``(S, P)`` boolean assignment matrix:

1. **Bits** — per-pair comparator bits do not depend on the assignment, so
   the ``CandidateMachine`` (``repro_torch.api.compiled``) evaluates both
   candidates of every pair once: ``pair_bits(x) -> (n, P, 2)``.

2. **Accuracy** — every assignment is a bit-recombination: with the packed
   encoder table, an assignment's label codes are

       ``codes[s] = lin_bits @ w  +  ((rbf_bits - lin_bits) * w) @ A[s]``

   (``w = 2^p``), one ``(n, P) x (P, S)`` product for the whole space on
   the device.  The product runs in f32, which is exact here (every code is
   an integer below 2^P <= 4096), and an accuracy is an exact integer count
   times the f32 reciprocal of n — the reference's f32 mean — so card and
   CPU give the same accuracies bit for bit.  Exhaustive ``2^P`` for
   ``P <= 12``; a seeded greedy / flip / annealing portfolio beyond.

3. **Cost** — ``hwcost.assignment_costs`` prices the same matrix in numpy.

``pareto_front`` reduces the points to the accuracy / area / power
non-dominated set; ``SweepResult.select`` picks the deployment.

Monte-Carlo variation: with a ``MonteCarloMachine`` the bit tensor gains a
leading variant axis ``(V, n, P, 2)`` and the same recombination runs over
it (``assignment_accuracies_mc``); each assignment then carries mean / std
/ worst-case accuracy and yield (the fraction of variants meeting an
accuracy floor), ``pareto_front`` gains a robust four-objective mode and
``select(yield_floor=...)`` picks the cheapest design meeting the yield.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import hwcost, mcstream
from repro_torch.core.ovo import build_encoder_table, class_pairs
from repro_torch.device import resolve_device

#: Exhaustive enumeration bound: 2^12 = 4096 assignments, the
#: packed-encoder-table regime of the compiled machine (MAX_TABLE_BITS).
MAX_EXHAUSTIVE_PAIRS = 12

#: Assignment chunk of the votes fallback (P > MAX_EXHAUSTIVE_PAIRS):
#: bounds the (n, CHUNK, P) selected-bits tensor.
VOTES_CHUNK = 256

#: Pair-axis chunk of the streamed votes recombination: bounds the
#: selected-bits temporary at ``(B, n, VOTES_PAIR_CHUNK)`` per assignment.
VOTES_PAIR_CHUNK = 16

#: Default assignment chunk of the Monte-Carlo encoder sweep: bounds the
#: ``(V, n, CHUNK)`` codes tensor.
MC_CHUNK = 512


def assignment_from_kernel_map(kernel_map: Sequence[str]) -> np.ndarray:
    """``['linear'|'rbf', ...] -> (P,) bool`` (True = RBF candidate)."""
    return np.asarray([k == "rbf" for k in kernel_map], bool)


def kernel_map_from_assignment(assignment: np.ndarray) -> list[str]:
    return ["rbf" if a else "linear" for a in np.asarray(assignment, bool)]


def enumerate_assignments(n_pairs: int) -> np.ndarray:
    """All ``2^P`` assignments; row ``s`` has pair ``p`` RBF iff bit ``p``
    of ``s`` is set (little-endian, the encoder bit packing)."""
    if n_pairs > MAX_EXHAUSTIVE_PAIRS:
        raise ValueError(
            f"refusing to enumerate 2^{n_pairs} assignments "
            f"(> 2^{MAX_EXHAUSTIVE_PAIRS}); use the seeded search")
    s = np.arange(1 << n_pairs, dtype=np.int64)
    return ((s[:, None] >> np.arange(n_pairs)) & 1).astype(bool)


# ---------------------------------------------------------------------------
# The recombination programs
# ---------------------------------------------------------------------------


def _mean_hits(hits: torch.Tensor, dim: int) -> torch.Tensor:
    """Fraction of True along ``dim`` as the reference's f32 mean lowers:
    the exact count times the f32 reciprocal of the length."""
    n = hits.shape[dim]
    return hits.sum(dim).to(torch.float32) * float(np.float32(1.0 / n))


def _encoder_accuracy(bits, a, y, table, weights):
    """Accuracy of every assignment through the packed encoder table.

    ``bits (..., n, P, 2)`` int, ``a (S, P)``, ``y (n,)``, ``table
    (2^P,)``, ``weights (P,)`` -> ``(..., S)`` f32.  The linear-candidate
    code is the base; each RBF-assigned pair adds its (rbf - lin) bit delta
    at its encoder weight.  The codes are f32 products of small integers,
    exact in any summation order.
    """
    w = weights.to(torch.float32)
    lin = bits[..., 0].to(torch.float32)
    diff = (bits[..., 1] - bits[..., 0]).to(torch.float32) * w
    codes = (lin @ w)[..., None] + diff @ a.to(torch.float32).T  # (..., n, S)
    labels = table[codes.to(torch.int64)]
    return _mean_hits(labels == y[:, None], dim=-2)


def _votes_accuracy(bits, a, y, vote_a, vote_b):
    """Votes fallback beyond the encoder-table regime: ``bits (n, P, 2)``
    -> ``(S,)``.  Materializes the selected bits ``(n, S, P)``; callers
    chunk the assignment axis.  Argmax keeps the lowest-index tiebreak of
    ``ovo.decide_votes``."""
    sel = torch.where(a[None, :, :] == 1, bits[:, None, :, 1],
                      bits[:, None, :, 0]).to(torch.float32)
    votes = sel @ vote_a + (1.0 - sel) @ vote_b             # (n, S, K)
    labels = torch.argmax(votes, dim=-1)
    return _mean_hits(labels == y[:, None], dim=0)


def _votes_accuracy_paired(bits4, a, y, vote_a, vote_b,
                           p_chunk: int = VOTES_PAIR_CHUNK):
    """Pair-chunked votes recombination: ``bits4 (B, n, P, 2) -> (B, S)``.

    One assignment row at a time, the pair axis is folded ``p_chunk``
    columns at a time into a ``(B, n, K)`` vote accumulator, so the
    temporaries are ``(B, n, p_chunk)`` whatever S and P are.  Argmax keeps
    the lowest-index tiebreak.
    """
    lin = bits4[..., 0].to(torch.float32)
    rbf = bits4[..., 1].to(torch.float32)
    p_total = lin.shape[-1]
    out = []
    for a_row in a:
        votes = None
        for lo in range(0, p_total, p_chunk):
            hi = min(lo + p_chunk, p_total)
            sel = torch.where(a_row[lo:hi] == 1, rbf[..., lo:hi],
                              lin[..., lo:hi])
            v = sel @ vote_a[lo:hi] + (1.0 - sel) @ vote_b[lo:hi]
            votes = v if votes is None else votes + v
        labels = torch.argmax(votes, dim=-1)                # (B, n)
        out.append(_mean_hits(labels == y[None, :], dim=1))
    return torch.stack(out, dim=1)


def _vote_matrices(n_classes: int, device) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    pairs = class_pairs(n_classes)
    a = np.zeros((len(pairs), n_classes), np.float32)
    b = np.zeros((len(pairs), n_classes), np.float32)
    for p, (i, j) in enumerate(pairs):
        a[p, i] = 1
        b[p, j] = 1
    return (torch.as_tensor(a, device=device),
            torch.as_tensor(b, device=device))


def _encoder_consts(n_classes: int, n_pairs: int, device):
    table = torch.as_tensor(build_encoder_table(n_classes), dtype=torch.int64,
                            device=device)
    weights = torch.as_tensor(1 << np.arange(n_pairs), dtype=torch.int64,
                              device=device)
    return table, weights


def _prep(bits, assignments, y, n_pairs_axis: int, device):
    if not isinstance(bits, torch.Tensor):
        bits = torch.from_numpy(np.array(bits, np.int32))
    bits = bits.to(device=device, dtype=torch.int32)
    a = torch.as_tensor(np.atleast_2d(np.asarray(assignments)).astype(
        np.int32), device=device)
    y = torch.as_tensor(np.asarray(y).astype(np.int64), device=device)
    n_pairs = bits.shape[n_pairs_axis]
    if a.shape[1] != n_pairs:
        raise ValueError(
            f"assignments have {a.shape[1]} pairs, bits tensor has {n_pairs}")
    return bits, a, y, n_pairs


def assignment_accuracies(
    bits2,
    assignments: np.ndarray,
    y: np.ndarray,
    n_classes: int,
    max_table_bits: int = MAX_EXHAUSTIVE_PAIRS,
    chunk: Optional[int] = None,
    device=None,
) -> np.ndarray:
    """Validation accuracy of every assignment: ``(S,)`` float64.

    ``bits2`` is the ``(n, P, 2)`` candidate-bit tensor of
    ``CandidateMachine.pair_bits``.  For ``P <= max_table_bits`` the packed
    encoder table scores all assignments at once; beyond that the votes
    fallback runs over ``chunk``-sized assignment chunks (default
    :data:`VOTES_CHUNK`).  ``device`` (None: the card) runs it.
    """
    dev = resolve_device(device)
    bits2, a, y, n_pairs = _prep(bits2, assignments, y, 1, dev)
    if n_pairs <= max_table_bits:
        table, weights = _encoder_consts(n_classes, n_pairs, dev)
        acc = _encoder_accuracy(bits2, a, y, table, weights)
        return acc.cpu().numpy().astype(np.float64)
    if chunk is None:
        chunk = VOTES_CHUNK
    va, vb = _vote_matrices(n_classes, dev)
    out = [_votes_accuracy(bits2, a[lo: lo + chunk], y, va, vb)
           for lo in range(0, a.shape[0], chunk)]
    return torch.cat(out).cpu().numpy().astype(np.float64)


def assignment_accuracies_mc(
    bits3,
    assignments: np.ndarray,
    y: np.ndarray,
    n_classes: int,
    max_table_bits: int = MAX_EXHAUSTIVE_PAIRS,
    mc_chunk: Optional[int] = None,
    device=None,
) -> np.ndarray:
    """Validation accuracy of every (variant, assignment): ``(V, S)`` f64.

    ``bits3`` is the ``(V, n, P, 2)`` bit tensor of
    ``MonteCarloMachine.pair_bits``.  The recombination is batched over the
    variant axis; the assignment axis runs in chunks of ``mc_chunk``
    (default :data:`MC_CHUNK`) to bound the ``(V, n, chunk)`` codes tensor.
    Beyond the encoder regime the pair-chunked votes recombination runs.
    """
    dev = resolve_device(device)
    if np.ndim(bits3) != 4:
        raise ValueError(f"bits3 must be (V, n, P, 2), got "
                         f"{tuple(np.shape(bits3))}")
    bits3, a, y, n_pairs = _prep(bits3, assignments, y, 2, dev)
    if mc_chunk is None:
        mc_chunk = MC_CHUNK
    if mc_chunk < 1:
        raise ValueError(f"mc_chunk must be >= 1, got {mc_chunk}")
    if n_pairs <= max_table_bits:
        table, weights = _encoder_consts(n_classes, n_pairs, dev)
        out = [_encoder_accuracy(bits3, a[lo: lo + mc_chunk], y, table,
                                 weights)
               for lo in range(0, a.shape[0], mc_chunk)]
        return torch.cat(out, dim=1).cpu().numpy().astype(np.float64)
    va, vb = _vote_matrices(n_classes, dev)
    return _votes_accuracy_paired(bits3, a, y, va, vb
                                  ).cpu().numpy().astype(np.float64)


def mc_statistics(
    acc_vs: np.ndarray,
    accuracy_floor: float,
    confidence: float = mcstream.DEFAULT_CONFIDENCE,
    ci: str = "wilson",
) -> dict:
    """Per-assignment robustness statistics over the variant axis.

    ``acc_vs (V, S)`` -> dict of ``(S,)`` arrays: ``mean``, ``std``
    (population), ``worst``, ``yield`` (fraction of variants at or above
    ``accuracy_floor``) and its two-sided binomial bounds ``yield_lo`` /
    ``yield_hi`` at ``confidence`` (``ci``: ``'wilson'`` or
    ``'clopper-pearson'``).
    """
    acc_vs = np.asarray(acc_vs, np.float64)
    p = (acc_vs >= accuracy_floor).mean(axis=0)
    n = acc_vs.shape[0]
    if ci == "clopper-pearson":
        lo, hi = mcstream.clopper_pearson_bounds(p, n, confidence)
    else:
        lo, hi = mcstream.wilson_bounds(p, n, confidence)
    return {
        "mean": acc_vs.mean(axis=0),
        "std": acc_vs.std(axis=0),
        "worst": acc_vs.min(axis=0),
        "yield": p,
        "yield_lo": lo,
        "yield_hi": hi,
        "confidence": float(confidence),
    }


# ---------------------------------------------------------------------------
# Pareto reduction and budget selection
# ---------------------------------------------------------------------------


def pareto_front(
    accuracy: np.ndarray,
    area: np.ndarray,
    power: np.ndarray,
    yield_: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Indices of the non-dominated points (max accuracy, min area /
    power), sorted by ascending area.  A point is dominated if another is
    at least as good on all objectives and strictly better on one.  With
    ``yield_`` (a Monte-Carlo sweep) yield is a fourth maximized objective.

    The points are visited in lexicographic order (accuracy down, then
    area, power, yield), so every dominator of a point comes before it; a
    point is then dominated iff a point of the front found so far or a
    point of its own block dominates it (a dominated dominator is itself
    dominated by a front point).  This costs O(S x front) instead of the
    reference's O(S^2) and returns the same set — which matters for the
    portfolio search, whose archive reaches ~10^5 points at P = 66.
    """
    obj = [-np.asarray(accuracy, np.float64), np.asarray(area, np.float64),
           np.asarray(power, np.float64)]
    if yield_ is not None:
        obj.append(-np.asarray(yield_, np.float64))
    obj = np.stack(obj, axis=1)                      # (S, k), all minimized
    order = np.lexsort(obj.T[::-1])
    keep = np.zeros(obj.shape[0], bool)
    front = np.zeros((0, obj.shape[1]))
    block = 64
    for lo in range(0, order.shape[0], block):
        idx = order[lo: lo + block]
        pts = obj[idx]
        dominated = np.zeros(idx.shape[0], bool)
        for other in (front, pts):
            le = (other[None, :, :] <= pts[:, None, :]).all(axis=2)
            lt = (other[None, :, :] < pts[:, None, :]).any(axis=2)
            dominated |= (le & lt).any(axis=1)
        keep[idx[~dominated]] = True
        front = np.concatenate([front, pts[~dominated]])
    idx = np.flatnonzero(keep)
    return idx[np.argsort(obj[idx, 1], kind="stable")]


@dataclasses.dataclass
class SweepResult:
    """Evaluated design points of one sweep + their Pareto front.

    The Monte-Carlo fields are set only by variation-aware sweeps
    (``DesignSpace.sweep(mc_machine=...)``): ``accuracy`` then holds the
    nominal (zero-offset variant) accuracy, ``accuracy_mc`` the ``(V, S)``
    per-variant matrix and ``acc_mean`` / ``acc_std`` / ``acc_worst`` /
    ``yield_`` its per-assignment statistics.  ``front`` stays the nominal
    three-objective front; ``robust_front`` is the four-objective one.
    """

    assignments: np.ndarray   # (S, P) bool — True: pair on the RBF candidate
    accuracy: np.ndarray      # (S,) validation accuracy
    area: np.ndarray          # (S,) mm^2
    power: np.ndarray         # (S,) mW
    front: np.ndarray         # indices of the non-dominated set, area-sorted
    n_classes: int
    exhaustive: bool          # full 2^P enumeration vs seeded search
    elapsed_s: float
    assignments_per_s: float
    # -- Monte-Carlo robustness (None on nominal sweeps) --------------------
    accuracy_mc: Optional[np.ndarray] = None   # (V, S) per-variant accuracy
    acc_mean: Optional[np.ndarray] = None      # (S,)
    acc_std: Optional[np.ndarray] = None       # (S,)
    acc_worst: Optional[np.ndarray] = None     # (S,)
    yield_: Optional[np.ndarray] = None        # (S,) frac >= accuracy_floor
    yield_lo_: Optional[np.ndarray] = None     # (S,) binomial LCB on yield
    yield_hi_: Optional[np.ndarray] = None     # (S,) binomial UCB on yield
    confidence: Optional[float] = None         # two-sided CI level
    accuracy_floor: Optional[float] = None
    n_variants: Optional[int] = None
    sigma_scale: Optional[float] = None
    mc_key_data: Optional[np.ndarray] = None   # the draws' key data
    robust_front: Optional[np.ndarray] = None  # 4-objective front indices

    @property
    def n_pairs(self) -> int:
        return int(self.assignments.shape[1])

    @property
    def is_monte_carlo(self) -> bool:
        return self.accuracy_mc is not None

    def yield_at(self, accuracy_floor: float) -> np.ndarray:
        """Per-assignment yield against an ad-hoc floor (MC sweeps only)."""
        if not self.is_monte_carlo:
            raise RuntimeError("yield_at requires a Monte-Carlo sweep")
        return (np.asarray(self.accuracy_mc, np.float64)
                >= accuracy_floor).mean(axis=0)

    def kernel_map(self, i: int) -> list[str]:
        return kernel_map_from_assignment(self.assignments[i])

    def find(self, assignment: np.ndarray) -> Optional[int]:
        """Row index of ``assignment`` among the swept points (None if the
        search never visited it)."""
        a = np.asarray(assignment, bool)
        hit = np.flatnonzero((self.assignments == a[None, :]).all(axis=1))
        return int(hit[0]) if hit.size else None

    def domination_margin(self, assignment: np.ndarray) -> float:
        """Accuracy a no-costlier swept design gains over ``assignment``
        (<= 0: the point is undominated)."""
        i = self.find(assignment)
        if i is None:
            raise ValueError("assignment was not visited by this sweep")
        cheaper = (self.area <= self.area[i]) & (self.power <= self.power[i])
        return float(np.max(self.accuracy[cheaper]) - self.accuracy[i])

    def select(
        self,
        area_budget: Optional[float] = None,
        power_budget: Optional[float] = None,
        yield_floor: Optional[float] = None,
        confidence: Optional[float] = None,
    ) -> int:
        """Deployment rule.

        Nominal (``yield_floor=None``): the most accurate Pareto point
        within budget, ties broken toward lower area then lower power.

        Robust (``yield_floor=``, a Monte-Carlo sweep): the cheapest
        budget-feasible point of the robust front whose yield meets the
        floor, ties broken toward lower power then higher mean accuracy.
        ``confidence`` None gates on the point-estimate yield; a float gates
        on the Wilson lower confidence bound at that level.
        """
        if yield_floor is None:
            idx = self.front
            ok = np.ones(idx.shape[0], bool)
            if area_budget is not None:
                ok &= self.area[idx] <= area_budget
            if power_budget is not None:
                ok &= self.power[idx] <= power_budget
            if not ok.any():
                cheapest = idx[np.argmin(self.area[idx])]
                raise ValueError(
                    "no Pareto point meets the budget (cheapest front "
                    f"point: area {self.area[cheapest]:.4f} mm^2, power "
                    f"{self.power[cheapest]:.4f} mW)")
            cand = idx[ok]
            order = np.lexsort((self.power[cand], self.area[cand],
                                -self.accuracy[cand]))
            return int(cand[order[0]])
        if not self.is_monte_carlo:
            raise RuntimeError(
                "select(yield_floor=...) needs a Monte-Carlo sweep: run "
                "DesignSpace.sweep(mc_machine=...) / "
                "est.pareto(..., n_variants=...) first")
        idx = self.robust_front
        if confidence is None:
            gate = self.yield_
        else:
            gate, _ = mcstream.wilson_bounds(
                self.yield_, int(self.n_variants), confidence)
        ok = gate[idx] >= yield_floor
        if area_budget is not None:
            ok &= self.area[idx] <= area_budget
        if power_budget is not None:
            ok &= self.power[idx] <= power_budget
        if not ok.any():
            best = idx[np.argmax(gate[idx])]
            bound = ("yield" if confidence is None
                     else f"yield {confidence:.0%}-LCB")
            raise ValueError(
                f"no robust-front point meets {bound} >= {yield_floor} "
                f"within budget (best available {bound} "
                f"{gate[best]:.3f} from {self.n_variants} variants at "
                f"accuracy floor {self.accuracy_floor}, area "
                f"{self.area[best]:.4f} mm^2)")
        cand = idx[ok]
        order = np.lexsort((-self.acc_mean[cand], self.power[cand],
                            self.area[cand]))
        return int(cand[order[0]])

    def front_points(self, robust: bool = False) -> list[dict]:
        """JSON-friendly view of the front (``robust=True``: the
        four-objective robust front of a Monte-Carlo sweep)."""
        idx = self.robust_front if robust else self.front
        out = []
        for i in idx:
            entry = {
                "kernel_map": self.kernel_map(i),
                "n_rbf": int(self.assignments[i].sum()),
                "accuracy": float(self.accuracy[i]),
                "area_mm2": float(self.area[i]),
                "power_mw": float(self.power[i]),
            }
            if self.is_monte_carlo:
                entry.update(
                    acc_mean=float(self.acc_mean[i]),
                    acc_std=float(self.acc_std[i]),
                    acc_worst=float(self.acc_worst[i]),
                    yield_frac=float(self.yield_[i]),
                )
                if self.yield_lo_ is not None:
                    entry.update(yield_lo=float(self.yield_lo_[i]),
                                 yield_hi=float(self.yield_hi_[i]))
            out.append(entry)
        return out


# ---------------------------------------------------------------------------
# Seeded greedy/flip search (beyond the exhaustive regime)
# ---------------------------------------------------------------------------

#: Assignment chunk of the portfolio search's evaluations.
SEARCH_CHUNK = 64

#: Front-polish cap: at most this many archive-front points get their full
#: Hamming-1 neighborhood evaluated per round.
POLISH_FRONT_CAP = 24


def _search_assignments(
    bits2: np.ndarray,
    y: np.ndarray,
    cost_table: hwcost.PairCostTable,
    n_classes: int,
    seeds: Optional[np.ndarray],
    n_random: int,
    rng_seed: int,
    max_rounds: int,
    n_anneal: int = 8,
    anneal_steps: int = 96,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Seeded search portfolio: greedy/flip + annealing + front polish.

    Three stages over one scalarized objective (accuracy minus ``lam`` x
    normalized cost), all feeding ONE deduplicating archive:

    1. greedy / flip — steepest ascent over single-pair flips from the
       all-linear / all-RBF corners, the caller's seeds and ``n_random``
       random draws, once per lambda of a small ladder;
    2. annealing — ``n_anneal`` Metropolis walkers in lockstep under a
       geometric temperature schedule;
    3. front polish — the archive's Pareto front (at most
       :data:`POLISH_FRONT_CAP` points per round) gets its Hamming-1
       neighborhood evaluated until the front stops growing.

    Deterministic given ``rng_seed`` (numpy ``RandomState``).  Returns
    ``(assignments, accuracies)`` for the whole archive.
    """
    p = bits2.shape[1]
    rng = np.random.RandomState(rng_seed)
    bits_dev = torch.as_tensor(np.asarray(bits2), device=resolve_device(
        device))
    starts = [np.zeros(p, bool), np.ones(p, bool)]
    if seeds is not None:
        starts += [np.asarray(s, bool) for s in np.atleast_2d(seeds)]
    starts += [rng.rand(p) < 0.5 for _ in range(n_random)]

    archive: dict[bytes, float] = {}
    added: list[bytes] = []          # archive keys in insertion order

    def evaluate(batch: np.ndarray) -> np.ndarray:
        fresh = [a for a in batch if a.tobytes() not in archive]
        if fresh:
            accs = assignment_accuracies(bits_dev, np.stack(fresh), y,
                                         n_classes, chunk=SEARCH_CHUNK,
                                         device=bits_dev.device)
            for a, acc in zip(fresh, accs):
                if a.tobytes() not in archive:
                    added.append(a.tobytes())
                archive[a.tobytes()] = float(acc)
        return np.asarray([archive[a.tobytes()] for a in batch])

    # Cost normalization: the corners anchor the scale.
    a_all, p_all = hwcost.assignment_costs(
        cost_table, np.stack([np.zeros(p, bool), np.ones(p, bool)]))
    a_ref = max(a_all.max(), 1e-12)
    p_ref = max(p_all.max(), 1e-12)

    def scores(batch: np.ndarray, lam: float) -> np.ndarray:
        acc = evaluate(batch)
        ar, pw = hwcost.assignment_costs(cost_table, batch)
        return acc - lam * 0.5 * (ar / a_ref + pw / p_ref)

    for lam in (0.0, 0.05, 0.25, 1.0):
        for start in starts:
            cur = np.asarray(start, bool).copy()
            cur_score = float(scores(cur[None, :], lam)[0])
            for _ in range(max_rounds):
                flips = np.repeat(cur[None, :], p, axis=0)
                flips[np.arange(p), np.arange(p)] ^= True
                s = scores(flips, lam)
                best = int(np.argmax(s))
                if s[best] <= cur_score + 1e-12:
                    break
                cur, cur_score = flips[best], float(s[best])

    if n_anneal > 0 and anneal_steps > 0:
        t0, t1 = 2e-2, 1e-3
        for lam in (0.0, 0.25):
            cur = np.stack([starts[i % len(starts)].copy()
                            for i in range(n_anneal)]).astype(bool)
            # Half the walkers restart from fresh random corners so the
            # two lambda passes do not retrace identical trajectories.
            for i in range(n_anneal // 2, n_anneal):
                cur[i] = rng.rand(p) < 0.5
            cur_s = scores(cur, lam)
            for t in range(anneal_steps):
                temp = t0 * (t1 / t0) ** (t / max(anneal_steps - 1, 1))
                flip = rng.randint(0, p, n_anneal)
                prop = cur.copy()
                prop[np.arange(n_anneal), flip] ^= True
                prop_s = scores(prop, lam)
                accept = (prop_s > cur_s) | (
                    rng.rand(n_anneal) < np.exp(
                        np.minimum(prop_s - cur_s, 0.0) / temp))
                cur[accept] = prop[accept]
                cur_s[accept] = prop_s[accept]

    # Adding points never puts a dominated point back on the front, so each
    # round reduces the last front plus the points added since (in archive
    # order, so ties order as over the whole archive).
    expanded: set[bytes] = set()
    keys = list(added)
    for _ in range(16):  # closure bound; each round must expand new points
        pts = np.stack([np.frombuffer(k, bool) for k in keys])
        acc = np.asarray([archive[k] for k in keys])
        ar, pw = hwcost.assignment_costs(cost_table, pts)
        front = pareto_front(acc, ar, pw)
        todo = [i for i in front if keys[i] not in expanded]
        if not todo:
            break
        todo = sorted(todo, key=lambda i: -acc[i])[:POLISH_FRONT_CAP]
        n_before = len(added)
        for i in todo:
            expanded.add(keys[i])
            flips = np.repeat(pts[i][None, :], p, axis=0)
            flips[np.arange(p), np.arange(p)] ^= True
            evaluate(flips)
        on_front = {keys[i] for i in front}
        keys = [k for k in added[:n_before] if k in on_front] \
            + added[n_before:]

    out = np.stack([np.frombuffer(k, bool) for k in archive])
    return out, np.asarray([archive[a.tobytes()] for a in out])


# ---------------------------------------------------------------------------
# The design space
# ---------------------------------------------------------------------------


class DesignSpace:
    """P candidate pairs as one batched design space.

    Couples the assignment-independent bit machine with the vectorized
    cost table; :meth:`sweep` runs both over a whole assignment matrix.
    Build it from per-pair candidates with :meth:`from_candidates`, or from
    any machine with a ``pair_bits(x) -> (n, P, 2)`` method and a table.
    The recombination runs on ``device`` (None: the machine's device, else
    the card).
    """

    def __init__(self, machine, cost_table: hwcost.PairCostTable,
                 n_classes: int, device=None):
        if cost_table.n_pairs != len(class_pairs(n_classes)):
            raise ValueError(
                f"cost table has {cost_table.n_pairs} pairs; "
                f"{n_classes} classes need {len(class_pairs(n_classes))}")
        self.machine = machine
        self.cost_table = cost_table
        self.n_classes = int(n_classes)
        self.n_pairs = cost_table.n_pairs
        self.device = resolve_device(
            device if device is not None else getattr(machine, "device",
                                                      None))

    @classmethod
    def from_candidates(
        cls,
        candidates: Sequence,
        n_classes: int,
        cm: Optional[hwcost.CostModel] = None,
        device=None,
    ) -> "DesignSpace":
        """``candidates``: per-pair ``(linear_clf, rbf_clf)`` deployed
        classifier objects in ``class_pairs`` order."""
        from repro_torch.api.compiled import compile_candidates  # api above core

        cm = cm or hwcost.CostModel()
        machine = compile_candidates(candidates, n_classes, device=device)
        table = hwcost.pair_cost_table(candidates, cm, n_classes=n_classes)
        return cls(machine, table, n_classes)

    def sweep(
        self,
        x_val: np.ndarray,
        y_val: np.ndarray,
        assignments: Optional[np.ndarray] = None,
        max_exhaustive: int = MAX_EXHAUSTIVE_PAIRS,
        seeds: Optional[np.ndarray] = None,
        n_random: int = 16,
        rng_seed: int = 0,
        max_rounds: int = 64,
        n_anneal: int = 8,
        anneal_steps: int = 96,
        mc_machine=None,
        accuracy_floor: Optional[float] = None,
    ) -> SweepResult:
        """Evaluate accuracy + cost over the assignment space.

        With ``assignments=None``: exhaustive ``2^P`` when ``P <=
        max_exhaustive``, else the seeded greedy / flip + annealing
        portfolio (``seeds`` typically the Algorithm-1 assignment;
        ``max_exhaustive=0`` forces the portfolio at small P).

        Monte-Carlo mode: pass an ``mc_machine`` (a ``MonteCarloMachine``
        sampled with ``include_nominal``) and an ``accuracy_floor``; every
        assignment then gets mean / std / worst-case accuracy and yield, and
        the result carries the robust four-objective front (the nominal
        ``accuracy`` column is the zero-offset variant's row).
        """
        t0 = time.perf_counter()
        acc_vs = None
        if mc_machine is not None:
            if accuracy_floor is None:
                raise ValueError(
                    "a Monte-Carlo sweep needs an explicit accuracy_floor "
                    "(the yield spec); pass accuracy_floor=...")
            if not mc_machine.include_nominal:
                raise ValueError(
                    "the MC machine must be sampled with include_nominal "
                    "so the sweep carries the nominal accuracy column")
            bits3 = mc_machine.pair_bits(x_val)
            bits2 = bits3[0]
        else:
            bits2 = self.machine.pair_bits(x_val)
        search_acc = None
        if assignments is not None:
            assignments = np.atleast_2d(np.asarray(assignments, bool))
            exhaustive = False
        elif self.n_pairs <= max_exhaustive:
            assignments = enumerate_assignments(self.n_pairs)
            exhaustive = True
        else:
            assignments, search_acc = _search_assignments(
                bits2, y_val, self.cost_table, self.n_classes,
                seeds, n_random, rng_seed, max_rounds,
                n_anneal=n_anneal, anneal_steps=anneal_steps,
                device=self.device)
            exhaustive = False
        if mc_machine is not None:
            acc_vs = assignment_accuracies_mc(
                bits3, assignments, y_val, self.n_classes,
                device=self.device)
            acc = acc_vs[0]
        elif search_acc is not None:
            acc = search_acc
        else:
            acc = assignment_accuracies(bits2, assignments, y_val,
                                        self.n_classes, device=self.device)
        area, power = hwcost.assignment_costs(self.cost_table, assignments)
        front = pareto_front(acc, area, power)
        elapsed = time.perf_counter() - t0
        result = SweepResult(
            assignments=assignments, accuracy=acc, area=area, power=power,
            front=front, n_classes=self.n_classes, exhaustive=exhaustive,
            elapsed_s=elapsed,
            assignments_per_s=assignments.shape[0] / max(elapsed, 1e-9),
        )
        if acc_vs is not None:
            stats = mc_statistics(acc_vs, accuracy_floor)
            result.accuracy_mc = acc_vs
            result.acc_mean = stats["mean"]
            result.acc_std = stats["std"]
            result.acc_worst = stats["worst"]
            result.yield_ = stats["yield"]
            result.yield_lo_ = stats["yield_lo"]
            result.yield_hi_ = stats["yield_hi"]
            result.confidence = stats["confidence"]
            result.accuracy_floor = float(accuracy_floor)
            result.n_variants = int(mc_machine.n_variants)
            result.sigma_scale = float(mc_machine.sigma_scale)
            result.mc_key_data = mc_machine.key_data
            result.robust_front = pareto_front(
                result.acc_mean, area, power, yield_=result.yield_)
        return result
