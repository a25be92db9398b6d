"""Streaming Monte-Carlo accumulators: flat memory from V = 64 to V = 10^6.

The port of ``repro.core.mcstream``.  A chunk of variants is generated,
scored and folded into fixed-shape state, then its buffers are reused for
the next chunk, so peak memory depends on the chunk size only, never on V.

* :class:`StreamStats` — the accumulator state, all f32 on the device as
  in the reference: counts are exact in f32 up to 2^24 (> 10^6 variants),
  and the moments are centered on the running mean, so the second moment
  stays stable without f64.
* :func:`chunk_aggregates` reduces one ``(B, S)`` accuracy chunk to sums
  relative to the running mean, linear in the variant axis;
  :func:`merge_stream` is Chan's parallel Welford merge of one aggregate
  into the state; :func:`update_stream` is both.  Under a variants mesh
  each device reduces its slice of the chunk and :func:`merge_aggregates`
  joins the slices before the merge.
* Every accumulator is weighted (``w = 1`` for iid / QMC sampling,
  self-normalized importance weights for ``method='is'``); ``finalize``
  reports the effective sample size ``(Σw)² / Σw²``, the n that enters the
  Wilson / Clopper-Pearson yield bounds.
* Invalid slots (the tail chunk's padding) enter with ``valid = 0`` and
  contribute exactly nothing.
* The quantile sketch is a fixed-grid histogram over [0, 1]; with
  ``n_bins = n_val + 1`` it holds the accuracy lattice exactly.

Host side, numpy / scipy as in the reference: the binomial bounds, the
histogram quantiles and the scrambled-Sobol / Latin-hypercube chunk
samplers (:class:`QMCSampler`), seeded from the stored key data.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: Default two-sided confidence level of the yield interval.
DEFAULT_CONFIDENCE = 0.95

#: Histogram-sketch resolution cap (accuracies on n_val <= 1024 samples are
#: resolved exactly).
MAX_HIST_BINS = 1025

_TINY = 1e-30


# ---------------------------------------------------------------------------
# The accumulator state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StreamStats:
    """Fixed-shape running statistics over the variant axis (S columns).

    ``count`` / ``w_sum`` / ``w2_sum`` / ``log_ref`` are scalars (the weight
    stream is shared by all S assignments); ``mean`` / ``m2`` / ``exceed``
    / ``amin`` / ``amax`` are ``(S,)``; ``hist`` is the ``(S, n_bins)``
    sketch.  Every weighted sum is stored relative to ``exp(log_ref)`` (a
    streaming logsumexp, so importance weights hundreds of nats from zero
    neither underflow nor clip); the scale cancels in :func:`finalize`.
    """

    count: torch.Tensor    # () f32 — number of valid variants folded in
    w_sum: torch.Tensor    # () f32 — Σ w over valid variants
    w2_sum: torch.Tensor   # () f32 — Σ w² over valid variants
    mean: torch.Tensor     # (S,) f32 — weighted running mean
    m2: torch.Tensor       # (S,) f32 — weighted Σ w (x - mean)²
    exceed: torch.Tensor   # (S,) f32 — Σ w · [x >= floor]
    amin: torch.Tensor     # (S,) f32 — min accuracy seen (+inf when empty)
    amax: torch.Tensor     # (S,) f32 — max accuracy seen (-inf when empty)
    hist: torch.Tensor     # (S, n_bins) f32 — weighted fixed-grid counts
    log_ref: torch.Tensor  # () f32 — log-scale of every weighted sum


@dataclasses.dataclass
class ChunkAgg:
    """One chunk reduced to mergeable sums (centered on the running mean)."""

    n_c: torch.Tensor      # () f32 — valid rows in the chunk
    w_c: torch.Tensor      # () f32 — Σ w
    w2_c: torch.Tensor     # () f32 — Σ w²
    s1: torch.Tensor       # (S,) f32 — Σ w (x - center)
    s2: torch.Tensor       # (S,) f32 — Σ w (x - center)²
    exceed: torch.Tensor   # (S,) f32
    amin: torch.Tensor     # (S,) f32
    amax: torch.Tensor     # (S,) f32
    hist: torch.Tensor     # (S, n_bins) f32
    log_ref: torch.Tensor  # () f32 — log-scale of this chunk's sums


def hist_bins(n_val: int) -> int:
    """Sketch resolution for ``n_val`` validation rows: the accuracy
    lattice size ``n_val + 1``, capped at :data:`MAX_HIST_BINS`."""
    return min(int(n_val) + 1, MAX_HIST_BINS)


def init_stream(n_assignments: int, n_bins: int, device) -> StreamStats:
    """All-zero state (extrema at +/- inf) for ``S`` assignment columns."""
    s = int(n_assignments)
    f32 = dict(dtype=torch.float32, device=device)
    return StreamStats(
        count=torch.zeros((), **f32), w_sum=torch.zeros((), **f32),
        w2_sum=torch.zeros((), **f32), mean=torch.zeros((s,), **f32),
        m2=torch.zeros((s,), **f32), exceed=torch.zeros((s,), **f32),
        amin=torch.full((s,), float("inf"), **f32),
        amax=torch.full((s,), float("-inf"), **f32),
        hist=torch.zeros((s, int(n_bins)), **f32),
        log_ref=torch.full((), float("-inf"), **f32))


def chunk_aggregates(center: torch.Tensor, acc: torch.Tensor,
                     w: torch.Tensor, valid: torch.Tensor, floor: float,
                     n_bins: int, log_ref=None) -> ChunkAgg:
    """Reduce one accuracy chunk ``acc (B, S)`` to mergeable sums.

    ``w`` / ``valid`` are ``(B,)`` f32; rows with ``valid = 0`` contribute
    exactly nothing.  ``center (S,)`` is the running mean the moments are
    taken around.  ``log_ref`` is the log-scale ``w`` was computed at
    (``None``: absolute weights, scale 0).
    """
    wv = w * valid                                    # (B,)
    dc = acc - center[None, :]                        # (B, S)
    ok = valid[:, None] > 0
    masked_lo = torch.where(ok, acc, float("inf"))
    masked_hi = torch.where(ok, acc, float("-inf"))
    bins = torch.clamp(torch.round(acc * (n_bins - 1)).to(torch.int64),
                       0, n_bins - 1)                 # (B, S)
    s = acc.shape[1]
    cols = torch.arange(s, device=acc.device)[None, :] * n_bins
    hist = torch.zeros(s * n_bins, dtype=torch.float32, device=acc.device)
    hist.index_add_(0, (cols + bins).reshape(-1),
                    wv[:, None].expand(bins.shape).reshape(-1))
    if log_ref is None:
        log_ref = torch.zeros((), dtype=torch.float32, device=acc.device)
    return ChunkAgg(
        n_c=torch.sum(valid), w_c=torch.sum(wv), w2_c=torch.sum(wv * wv),
        s1=wv @ dc, s2=wv @ (dc * dc),
        exceed=wv @ (acc >= floor).to(torch.float32),
        amin=torch.min(masked_lo, dim=0).values,
        amax=torch.max(masked_hi, dim=0).values,
        hist=hist.reshape(s, n_bins),
        log_ref=torch.as_tensor(log_ref, dtype=torch.float32,
                                device=acc.device))


def merge_stream(state: StreamStats, agg: ChunkAgg) -> StreamStats:
    """Chan's parallel merge of one aggregate into the state.

    With ``delta = s1 / w_c`` (the chunk mean minus the running mean) the
    chunk's own M2 is ``s2 - s1 · delta``.  Empty chunks are exact no-ops.
    The merged state lives at the larger log-scale and the other side's
    sums are multiplied down by the ratio; when the scales agree (every
    non-IS method pins them to 0) the factors are the literal 1.0.
    """
    one = torch.ones((), dtype=torch.float32, device=state.mean.device)
    ref = torch.maximum(state.log_ref, agg.log_ref)
    fs = torch.where(state.log_ref == ref, one, torch.exp(state.log_ref - ref))
    fc = torch.where(agg.log_ref == ref, one, torch.exp(agg.log_ref - ref))
    w_old = fs * state.w_sum
    w_c = fc * agg.w_c
    w_new = w_old + w_c
    delta = agg.s1 / torch.clamp(agg.w_c, min=_TINY)       # (S,) scale-free
    m2_chunk = agg.s2 - agg.s1 * delta
    r = w_c / torch.clamp(w_new, min=_TINY)
    return StreamStats(
        count=state.count + agg.n_c,
        w_sum=w_new,
        w2_sum=fs * fs * state.w2_sum + fc * fc * agg.w2_c,
        mean=state.mean + delta * r,
        m2=fs * state.m2 + fc * m2_chunk + delta * delta * w_old * r,
        exceed=fs * state.exceed + fc * agg.exceed,
        amin=torch.minimum(state.amin, agg.amin),
        amax=torch.maximum(state.amax, agg.amax),
        hist=fs * state.hist + fc * agg.hist,
        log_ref=ref)


def merge_aggregates(aggs: list) -> ChunkAgg:
    """The aggregates of one chunk's device slices as one aggregate (all on
    one device): the reference's psum / pmin / pmax over the variants axis.
    Each slice's sums are first scaled to the largest ``log_ref``; where the
    scales agree (every non-IS method) the factor is the literal 1.0, so a
    single slice passes through bit for bit."""
    ref = aggs[0].log_ref
    for a in aggs[1:]:
        ref = torch.maximum(ref, a.log_ref)
    one = torch.ones((), dtype=torch.float32, device=ref.device)
    fs = [torch.where(a.log_ref == ref, one, torch.exp(a.log_ref - ref))
          for a in aggs]

    def total(vals):
        out = vals[0]
        for v in vals[1:]:
            out = out + v
        return out

    amin, amax = aggs[0].amin, aggs[0].amax
    for a in aggs[1:]:
        amin, amax = torch.minimum(amin, a.amin), torch.maximum(amax, a.amax)
    return ChunkAgg(
        n_c=total([a.n_c for a in aggs]),
        w_c=total([f * a.w_c for f, a in zip(fs, aggs)]),
        w2_c=total([f * f * a.w2_c for f, a in zip(fs, aggs)]),
        s1=total([f * a.s1 for f, a in zip(fs, aggs)]),
        s2=total([f * a.s2 for f, a in zip(fs, aggs)]),
        exceed=total([f * a.exceed for f, a in zip(fs, aggs)]),
        amin=amin, amax=amax,
        hist=total([f * a.hist for f, a in zip(fs, aggs)]),
        log_ref=ref)


def update_stream(state: StreamStats, acc: torch.Tensor, w: torch.Tensor,
                  valid: torch.Tensor, floor: float,
                  log_ref=None) -> StreamStats:
    """Single-device chunk update: aggregates + merge."""
    n_bins = state.hist.shape[1]
    return merge_stream(
        state, chunk_aggregates(state.mean, acc, w, valid, floor, n_bins,
                                log_ref=log_ref))


# ---------------------------------------------------------------------------
# Binomial confidence bounds (host side, f64)
# ---------------------------------------------------------------------------


def wilson_bounds(p, n, confidence: float = DEFAULT_CONFIDENCE
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Two-sided Wilson score interval for a binomial proportion; ``n`` may
    be non-integer (the effective sample size of a weighted stream)."""
    p = np.asarray(p, np.float64)
    n = np.maximum(np.asarray(n, np.float64), 1e-12)
    z = float(_norm_ppf(0.5 + confidence / 2.0))
    z2 = z * z
    denom = 1.0 + z2 / n
    center = (p + z2 / (2.0 * n)) / denom
    half = z * np.sqrt(p * (1.0 - p) / n + z2 / (4.0 * n * n)) / denom
    return np.clip(center - half, 0.0, 1.0), np.clip(center + half, 0.0, 1.0)


def clopper_pearson_bounds(p, n, confidence: float = DEFAULT_CONFIDENCE
                           ) -> tuple[np.ndarray, np.ndarray]:
    """Exact (conservative) Clopper-Pearson interval via the beta quantile
    (``scipy.stats.beta``; non-integer ``k = p n`` is supported)."""
    from scipy.stats import beta

    p = np.asarray(p, np.float64)
    n = np.maximum(np.asarray(n, np.float64), 1e-12)
    k = np.clip(p * n, 0.0, n)
    alpha = 1.0 - confidence
    with np.errstate(invalid="ignore"):
        lo = beta.ppf(alpha / 2.0, k, n - k + 1.0)
        hi = beta.ppf(1.0 - alpha / 2.0, k + 1.0, n - k)
    lo = np.where(k <= 0.0, 0.0, lo)
    hi = np.where(k >= n, 1.0, hi)
    return np.clip(np.nan_to_num(lo, nan=0.0), 0.0, 1.0), \
        np.clip(np.nan_to_num(hi, nan=1.0), 0.0, 1.0)


def _norm_ppf(q: float) -> float:
    """Standard-normal quantile (scipy)."""
    from scipy.stats import norm

    return float(norm.ppf(q))


def hist_quantiles(hist, qs) -> np.ndarray:
    """Type-1 quantiles from the fixed-grid sketch: ``hist (S, n_bins)`` ->
    ``(len(qs), S)`` accuracy values on the bin lattice."""
    hist = np.asarray(hist, np.float64)
    qs = np.atleast_1d(np.asarray(qs, np.float64))
    n_bins = hist.shape[1]
    total = np.maximum(hist.sum(axis=1, keepdims=True), 1e-300)
    cdf = np.cumsum(hist, axis=1) / total                   # (S, n_bins)
    out = np.empty((qs.shape[0], hist.shape[0]), np.float64)
    grid = np.arange(n_bins, dtype=np.float64) / (n_bins - 1)
    for i, q in enumerate(qs):
        # Floored above zero so q = 0 returns the minimum (the first bin
        # with any mass), not the empty left tail of the cdf.
        thr = max(min(max(q, 0.0), 1.0) - 1e-12, 1e-300)
        out[i] = grid[np.argmax(cdf >= thr, axis=1)]
    return out


def finalize(state: StreamStats, confidence: float = DEFAULT_CONFIDENCE,
             ci: str = "wilson") -> dict:
    """Weighted sums -> per-assignment statistics dict (host f64).

    Keys mirror ``dse.mc_statistics`` (``mean`` / ``std`` / ``worst`` /
    ``yield``) and add ``best``, ``yield_lo`` / ``yield_hi`` (over the
    effective sample size), ``count``, ``n_eff`` and the interval config.
    """
    w = max(float(state.w_sum), 1e-300)
    w2 = max(float(state.w2_sum), 1e-300)
    count = float(state.count)
    n_eff = w * w / w2 if count > 0 else 0.0
    mean = state.mean.cpu().numpy().astype(np.float64)
    var = np.maximum(state.m2.cpu().numpy().astype(np.float64), 0.0) / w
    p = np.clip(state.exceed.cpu().numpy().astype(np.float64) / w, 0.0, 1.0)
    if ci == "clopper-pearson":
        lo, hi = clopper_pearson_bounds(p, n_eff, confidence)
    elif ci == "wilson":
        lo, hi = wilson_bounds(p, n_eff, confidence)
    else:
        raise ValueError(f"unknown ci method {ci!r}; "
                         "use 'wilson' or 'clopper-pearson'")
    amin = state.amin.cpu().numpy().astype(np.float64)
    amax = state.amax.cpu().numpy().astype(np.float64)
    return {
        "mean": mean,
        "std": np.sqrt(var),
        "worst": np.where(np.isfinite(amin), amin, np.nan),
        "best": np.where(np.isfinite(amax), amax, np.nan),
        "yield": p,
        "yield_lo": lo,
        "yield_hi": hi,
        "count": count,
        "n_eff": n_eff,
        "confidence": float(confidence),
        "ci": ci,
    }


# ---------------------------------------------------------------------------
# Quasi-Monte-Carlo chunk samplers (host side)
# ---------------------------------------------------------------------------

#: scipy's Sobol direction-number table tops out at this dimension.
SOBOL_MAX_DIM = 21201


class QMCSampler:
    """Deterministic uniform chunks over the reduced mismatch space.

    ``method='sobol'``: scrambled Sobol'; draw ``v`` depends only on ``v``
    and on the scramble seed derived from the key data (the reference's
    derivation, so the same key data gives the reference's point set).  A
    chunk that starts where the previous one ended continues the same
    engine; any other start rebuilds it and fast-forwards, so the stream
    is chunk-size invariant either way.

    ``method='stratified'``: a Latin hypercube per chunk, deterministic in
    ``(key, chunk start)`` but not chunk-size invariant.
    """

    def __init__(self, method: str, dim: int, key_data) -> None:
        if method not in ("sobol", "stratified"):
            raise ValueError(f"unknown QMC method {method!r}")
        if dim <= 0:
            raise ValueError("QMC sampling needs at least one mismatch dim")
        if method == "sobol" and dim > SOBOL_MAX_DIM:
            raise ValueError(
                f"mismatch space has {dim} dims > Sobol table limit "
                f"{SOBOL_MAX_DIM}; use method='stratified' or 'iid'")
        self.method = method
        self.dim = int(dim)
        kd = np.asarray(key_data, np.uint32).ravel()
        # Fold the key words into one 63-bit scramble seed.
        seed = 0
        for word in kd.tolist():
            seed = (seed * 1000003 + int(word)) % (2 ** 63 - 1)
        self.seed = int(seed)
        self._engine = None
        self._next = 0

    def chunk(self, start: int, size: int) -> np.ndarray:
        """Uniform ``(size, dim)`` f32 draws for global variants
        ``start .. start + size - 1``."""
        from scipy.stats import qmc

        start, size = int(start), int(size)
        if self.method == "stratified":
            eng = qmc.LatinHypercube(d=self.dim, seed=self.seed + 2 * start + 1)
            return np.asarray(eng.random(size), np.float32)
        if self._engine is None or start != self._next:
            self._engine = qmc.Sobol(d=self.dim, scramble=True, seed=self.seed)
            if start:
                self._engine.fast_forward(start)
        u = self._engine.random(size)
        self._next = start + size
        return np.asarray(u, np.float32)


def uniform_to_normal(u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF transform, clipped away from {0, 1} so the tails stay
    finite in f32."""
    eps = 1e-7
    return torch.special.ndtri(torch.clamp(u, eps, 1.0 - eps))
