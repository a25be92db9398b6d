"""Analog RBF classifier: circuit surrogate + behavioral model (paper III-B, IV-A).

The nominal half of ``repro.core.analog``:

1. ``CircuitParams`` + the ``*_circuit`` functions — the transistor-level
   surrogate standing in for SPICE (subthreshold device equations with
   threshold mismatch, mirror ratio error, finite input range); its DC
   sweeps play the paper's SPICE sweeps.

2. ``AnalogRBFModel`` — the behavioral model of Sec. IV-A: the measured
   transfer curve kept as sampled data, the fitted Gaussian (Eq. 7) giving
   gamma0, widths realised by input scaling (Eq. 8), and the alpha
   multiplier's logistic fit with its inverse mapping (Eq. 9).

``AnalogBinaryClassifier`` deploys a trained RBF-family ``SVMModel`` onto
the hardware model: alpha normalisation, signed accumulation on +/- rails
and a comparator bit.

The fabricated core's mismatch draws (four Gaussian-cell offsets, two
alpha-multiplier offsets) are arguments: ``from_circuit`` takes them
explicitly, and ``repro_torch.core.trainer.default_hw`` draws them from a
seeded ``torch.Generator`` unless the caller passes them in.  The sweeps are
host-side calibration, computed in f32 on the CPU like the reference's
device arrays and kept as numpy.

Monte-Carlo process variation (the variant half): ``VariantSet`` holds the
standard-normal mismatch draws of V fabricated instances of one
classifier, ``variant_transfer_params`` reduces them to the perturbations
of the measured transfers, and the classifier evaluates them in
``decision_mc``.  The reference draws with ``jax.random`` keys, which torch
cannot reproduce; here every sampling function takes the draws explicitly
(a ``VariantSet``) or draws them from an integer ``key`` with a
counter-based generator (:func:`counter_normals`): variant ``v``'s draws
are a pure function of ``(key, v)``, so a stream of variants is the same
whatever its chunking, on either device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.kernels import N_SLOPE, V_T, interp
from repro_torch.core.svm import SVMModel
from repro_torch.device import resolve_device

# --------------------------------------------------------------------------
# Circuit surrogate ("SPICE")
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CircuitParams:
    """Process/bias parameters of the FlexIC subthreshold cells."""

    n: float = N_SLOPE            # subthreshold slope factor
    v_t: float = V_T              # thermal voltage (V)
    i_bias: float = 150e-9        # kernel chain bias current I_in (A)
    v_supply: float = 1.0         # analog supply (V), regulated from 1.5 V
    v_range: float = 0.40         # usable differential input range (V)
    sigma_vth: float = 3.0e-3     # per-device threshold mismatch (V)
    mirror_err: float = 0.02      # readout mirror ratio error (rel.)
    lambda_ds: float = 0.01       # residual V_DS sensitivity (rel.)
    comparator_offset: float = 1.0e-10  # comparator input offset (A)
    comparator_sigma: float = 1.0e-10   # comparator offset mismatch (A, 1-sigma)


def _pair_fraction(x: torch.Tensor) -> torch.Tensor:
    """Subthreshold differential-pair current split: I1/I_tail."""
    return 1.0 / (1.0 + torch.exp(-x))


def _offsets(offsets, n: int) -> torch.Tensor:
    if offsets is None:
        return torch.zeros((n,), dtype=torch.float32)
    return torch.tensor(np.asarray(offsets, np.float32))


def gaussian_cell_circuit(dv: torch.Tensor, p: CircuitParams,
                          offsets=None) -> torch.Tensor:
    """I_out/I_in of one Gaussian cell (Q1..Q6 of Fig. 2) with non-idealities.

    Ideal limit (offsets = 0): Eq. (4),
      I_out/I_in = 1 / ((1+e^-x)(1+e^x)) = (1/4) sech^2(x/2),  x = dv/(n V_T).
    """
    o = _offsets(offsets, 4)
    nvt = p.n * p.v_t
    dvc = torch.clamp(dv, -p.v_range, p.v_range)  # input rails
    x = (dvc - o[0] * p.sigma_vth) / nvt
    x2 = (dvc - o[1] * p.sigma_vth) / nvt
    f1 = _pair_fraction(x)            # (Q1, Q2) pair
    f2 = 1.0 - _pair_fraction(x2)     # cascaded complementary (Q3, Q4) pair
    mirror = 1.0 + o[2] * p.mirror_err        # Q6/Q4 readout ratioing
    vds_mod = 1.0 + o[3] * p.lambda_ds        # weak V_DS dependence
    return f1 * f2 * mirror * vds_mod


def alpha_multiplier_circuit(dva: torch.Tensor, p: CircuitParams,
                             offsets=None) -> torch.Tensor:
    """I_out/I_in of the alpha multiplier: logistic in the control voltage."""
    o = _offsets(offsets, 2)
    nvt = p.n * p.v_t * (1.0 + o[1] * 0.02)
    return 1.0 / (1.0 + torch.exp((dva - o[0] * p.sigma_vth) / nvt))


def sweep_abscissa(lo: float, hi: float, n_points: int) -> np.ndarray:
    """The f32 sweep abscissa ``linspace(lo, hi, n_points)``.

    Computed as the reference's f32 ``linspace`` lowers on its CPU backend:
    ``fma(hi, t, lo * (1 - t))`` with ``t = i / (n - 1)`` in f32 and the end
    point appended, so the calibrated grids agree bit for bit.  The fused
    multiply-add is exact here: the f32 product fits a double, and the sum
    is rounded once to f64 and once to f32.
    """
    div = n_points - 1
    t = (np.arange(div, dtype=np.float32) / np.float32(div)).astype(np.float32)
    lo32, hi32 = np.float32(lo), np.float32(hi)
    head = (np.float32(1.0) - t).astype(np.float32) * lo32
    out = (np.float64(hi32) * t.astype(np.float64)
           + head.astype(np.float64)).astype(np.float32)
    return np.concatenate([out, [hi32]]).astype(np.float32)


def dc_sweep_gaussian(p: CircuitParams, offsets=None, n_points: int = 257
                      ) -> tuple[np.ndarray, np.ndarray]:
    """DC sweep of the Gaussian cell: (dv, I_out/I_in). Plays SPICE's role."""
    dv = sweep_abscissa(-p.v_range, p.v_range, n_points)
    out = gaussian_cell_circuit(torch.as_tensor(dv), p, offsets)
    return dv, out.numpy()


def dc_sweep_alpha(p: CircuitParams, offsets=None, n_points: int = 257
                   ) -> tuple[np.ndarray, np.ndarray]:
    dva = sweep_abscissa(-0.25, 0.25, n_points)
    return dva, alpha_multiplier_circuit(torch.as_tensor(dva), p,
                                         offsets).numpy()


# --------------------------------------------------------------------------
# Monte-Carlo process variation
# --------------------------------------------------------------------------

#: Raw mismatch draws per 1-D Gaussian cell (two pair vth offsets, mirror
#: ratio error, V_DS modulation) and per alpha multiplier (vth offset,
#: slope error) — the offset vectors the circuit surrogate consumes.
N_GAUSS_OFFSETS = 4
N_ALPHA_OFFSETS = 2

_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB


def _signed(u: int) -> int:
    u &= _MASK64
    return u - (1 << 64) if u >> 63 else u


def _lsr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of an int64 tensor."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on int64 tensors (products wrap mod 2^64)."""
    x = x ^ _lsr(x, 30)
    x = x * _signed(_MIX1)
    x = x ^ _lsr(x, 27)
    x = x * _signed(_MIX2)
    return x ^ _lsr(x, 31)


def _mix64_int(x: int) -> int:
    x &= _MASK64
    x = ((x ^ (x >> 30)) * _MIX1) & _MASK64
    x = ((x ^ (x >> 27)) * _MIX2) & _MASK64
    return x ^ (x >> 31)


def stream_key(seed: int, pair: int = 0) -> int:
    """The int64 draw key of ``pair``'s mismatch stream under ``seed``."""
    return _signed(_mix64_int(_mix64_int(int(seed)) + (int(pair) + 1) * _GOLDEN))


def counter_normals(key, v_idx: torch.Tensor, dim: int) -> torch.Tensor:
    """Standard-normal draws ``(B, *key.shape, dim)``, a pure function of
    ``(key, v, j)`` for global variant ``v`` and coordinate ``j``.

    ``key`` is an int or an int64 tensor of stream keys (one per pair);
    ``v_idx (B,)`` holds the global variant indices.  Each draw hashes its
    counter with splitmix64, keeps 23 bits as the odd lattice point
    ``(2k + 1) / 2^24`` of (0, 1) (exact in f32) and maps it through the
    normal quantile.
    """
    dev = v_idx.device
    k = torch.as_tensor(key, dtype=torch.int64, device=dev)
    v = v_idx.to(torch.int64).reshape((-1,) + (1,) * k.dim())
    base = _mix64(k + v * _signed(_GOLDEN))                 # (B, *key)
    j = torch.arange(1, int(dim) + 1, dtype=torch.int64, device=dev)
    h = _mix64(base[..., None] + j * _signed(_MIX2))       # (B, *key, D)
    u = (_lsr(h, 41) * 2 + 1).to(torch.float32) * (2.0 ** -24)
    return torch.special.ndtri(u)


@dataclasses.dataclass(frozen=True)
class VariantSet:
    """Standard-normal mismatch draws for ``V`` instances of one classifier.

    Shapes: ``gauss (V, m, d, 4)`` — per SV x feature Gaussian cell,
    ``alpha (V, m, 2)`` — per-SV alpha multiplier, ``comparator (V,)`` —
    one comparator per instance.  Row 0 is the all-zero nominal instance
    when sampled with ``include_nominal=True``.
    """

    gauss: torch.Tensor
    alpha: torch.Tensor
    comparator: torch.Tensor

    @property
    def n_variants(self) -> int:
        return int(self.gauss.shape[0])

    @property
    def n_support(self) -> int:
        return int(self.gauss.shape[1])

    @property
    def n_features(self) -> int:
        return int(self.gauss.shape[2])


def variant_dim(n_support: int, n_features: int) -> int:
    """Flat mismatch dimension of ONE classifier circuit instance:
    ``m*d`` Gaussian cells x 4 offsets + ``m`` alpha multipliers x 2 + 1
    comparator offset."""
    return (n_support * n_features * N_GAUSS_OFFSETS
            + n_support * N_ALPHA_OFFSETS + 1)


def variant_set_from_flat(z: torch.Tensor, n_support: int, n_features: int,
                          sigma_scale: float = 1.0) -> VariantSet:
    """Reshape flat standard-normal draws ``z (..., D)`` into a
    :class:`VariantSet` with the same leading dims; the layout is
    ``[gauss (m*d*4) | alpha (m*2) | comparator (1)]``."""
    m, d = int(n_support), int(n_features)
    ng = m * d * N_GAUSS_OFFSETS
    na = m * N_ALPHA_OFFSETS
    if z.shape[-1] != ng + na + 1:
        raise ValueError(
            f"flat mismatch block has {z.shape[-1]} dims, expected "
            f"{ng + na + 1} for m={m}, d={d}")
    lead = tuple(z.shape[:-1])
    s = float(np.float32(sigma_scale))
    return VariantSet(
        gauss=s * z[..., :ng].reshape(lead + (m, d, N_GAUSS_OFFSETS)),
        alpha=s * z[..., ng:ng + na].reshape(lead + (m, N_ALPHA_OFFSETS)),
        comparator=s * z[..., ng + na])


def sample_variant_chunk(key: int, v_idx: torch.Tensor, n_support: int,
                         n_features: int,
                         sigma_scale: float = 1.0) -> VariantSet:
    """Mismatch for the global variant indices ``v_idx (B,)`` only: variant
    ``v``'s offsets are a pure function of ``(key, v)``, never of the chunk
    size or position."""
    z = counter_normals(key, v_idx, variant_dim(n_support, n_features))
    return variant_set_from_flat(z, n_support, n_features, sigma_scale)


def sample_variant_offsets(key: int, n_variants: int, n_support: int,
                           n_features: int, include_nominal: bool = True,
                           sigma_scale: float = 1.0,
                           device=None) -> VariantSet:
    """Draw mismatch offsets for ``n_variants`` fabricated instances.

    ``key`` is an integer draw key (``stream_key``); variants ``0 ..
    n_draws - 1`` of its stream are drawn.  ``sigma_scale`` scales every
    process sigma jointly.  With ``include_nominal`` (default) row 0 is the
    zero-offset instance, so ``n_variants - 1`` random instances are drawn.
    ``device`` (None: the card) holds the draws.
    """
    if n_variants < 1 + int(include_nominal):
        raise ValueError(
            f"n_variants={n_variants} too small (include_nominal="
            f"{include_nominal})")
    v = n_variants - 1 if include_nominal else n_variants
    out = sample_variant_chunk(
        key, torch.arange(v, device=resolve_device(device)), n_support,
        n_features, sigma_scale)
    if not include_nominal:
        return out
    return VariantSet(*(torch.cat([torch.zeros_like(a[:1]), a])
                        for a in (out.gauss, out.alpha, out.comparator)))


@dataclasses.dataclass(frozen=True)
class VariantTransferParams:
    """Per-cell perturbations of the measured transfers for ``V`` instances.

    ``shift (V, m, d)`` bell center shift (V), ``gain (V, m, d)`` cell peak
    gain, ``alpha_shift`` / ``alpha_slope (V, m)`` the alpha multiplier's
    control-voltage offset and logistic slope scale, ``comp_offset (V,)``
    the comparator offset in units of I_in.  All-zero draws reduce to shift
    0, gain 1, slope 1 and the nominal comparator offset exactly.
    """

    shift: torch.Tensor
    gain: torch.Tensor
    alpha_shift: torch.Tensor
    alpha_slope: torch.Tensor
    comp_offset: torch.Tensor


def variant_transfer_params(v: VariantSet, p: CircuitParams
                            ) -> VariantTransferParams:
    """Reduce raw mismatch draws to measured-transfer perturbations."""
    nvt = p.n * p.v_t
    g = v.gauss
    shift = (0.5 * (g[..., 0] + g[..., 1])) * p.sigma_vth
    diff = (0.5 * (g[..., 0] - g[..., 1])) * (p.sigma_vth / nvt)
    peak = 4.0 * _pair_fraction(-diff) * (1.0 - _pair_fraction(diff))
    gain = (peak
            * (1.0 + g[..., 2] * p.mirror_err)
            * (1.0 + g[..., 3] * p.lambda_ds))
    alpha_shift = v.alpha[..., 0] * p.sigma_vth
    alpha_slope = 1.0 + v.alpha[..., 1] * 0.02
    # Nominal offset divided in f64 first so variant 0 carries the exact
    # f32 cast of the number the nominal lowering stores.
    comp_offset = (p.comparator_offset / p.i_bias
                   + v.comparator * (p.comparator_sigma / p.i_bias))
    return VariantTransferParams(
        shift=shift, gain=gain, alpha_shift=alpha_shift,
        alpha_slope=alpha_slope, comp_offset=comp_offset)


# --------------------------------------------------------------------------
# Fits (Sec. IV-A): ideal Gaussian (Eq. 7) and logistic (Eq. 9)
# --------------------------------------------------------------------------


def fit_gaussian(dv: np.ndarray, i_out: np.ndarray) -> tuple[float, float, float]:
    """Weighted LS fit of A0 exp(-g0 (dv-mu)^2) -> (A0, gamma0, mu).

    log I = a + b dv + c dv^2 with weights I^2, then gamma0 = -c,
    mu = b/(2 gamma0).
    """
    i = np.clip(np.asarray(i_out, np.float64), 1e-12, None)
    w = i * i
    v = np.asarray(dv, np.float64)
    basis = np.stack([np.ones_like(v), v, v * v], axis=1)
    wb = basis * w[:, None]
    coef = np.linalg.solve(basis.T @ wb, wb.T @ np.log(i))
    a, b, c = coef
    gamma0 = max(-c, 1e-9)
    mu = b / (2.0 * gamma0)
    a0 = float(np.exp(a + gamma0 * mu * mu))
    return a0, float(gamma0), float(mu)


def fit_logistic(dva: np.ndarray, ratio: np.ndarray) -> tuple[float, float]:
    """Fit  dV_alpha = x0 + s * ln(1/ratio - 1)  (Eq. 9) -> (x0, s)."""
    r = np.asarray(ratio, np.float64)
    keep = (r > 1e-4) & (r < 1.0 - 1e-4)
    z = np.log(1.0 / r[keep] - 1.0)
    v = np.asarray(dva, np.float64)[keep]
    s, x0 = np.polyfit(z, v, 1)
    return float(x0), float(s)


# --------------------------------------------------------------------------
# Behavioral model (Sec. IV-A) and hardware-deployed classifier
# --------------------------------------------------------------------------


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.asarray(v, np.float32), device=like.device)


@dataclasses.dataclass(frozen=True)
class AnalogRBFModel:
    """High-level behavioral model of one fabricated analog RBF core."""

    params: CircuitParams
    dv_grid: np.ndarray          # measured sweep abscissa (V)
    kernel_curve: np.ndarray     # measured I_out/I_in, normalised to peak 1
    a0: float                    # fitted Gaussian amplitude (Eq. 7)
    gamma0: float                # fitted gamma0 (1/V^2)
    mu: float                    # fitted center offset (V)
    alpha_x0: float              # logistic fit (Eq. 9)
    alpha_s: float
    dva_grid: np.ndarray         # measured alpha-sweep abscissa (V)
    alpha_curve: np.ndarray      # measured alpha multiplier ratio
    v_scale: float = 0.5         # feature-unit -> volt mapping

    @classmethod
    def from_circuit(cls, p: CircuitParams = CircuitParams(),
                     gauss_offsets=None, alpha_offsets=None,
                     v_scale: float = 0.5) -> "AnalogRBFModel":
        """Calibrate the behavioral model from surrogate-SPICE DC sweeps.

        ``gauss_offsets (4,)`` / ``alpha_offsets (2,)`` are the fabricated
        instance's standard-normal mismatch draws (None: the ideal cell).
        """
        dv, curve = dc_sweep_gaussian(p, gauss_offsets)
        a0, g0, mu = fit_gaussian(dv, curve)
        dva, ratio = dc_sweep_alpha(p, alpha_offsets)
        x0, s = fit_logistic(dva, ratio)
        return cls(
            params=p, dv_grid=dv, kernel_curve=curve / curve.max(),
            a0=a0, gamma0=g0, mu=mu, alpha_x0=x0, alpha_s=s,
            dva_grid=dva, alpha_curve=ratio, v_scale=v_scale,
        )

    # -- kernel ------------------------------------------------------------
    def gamma0_feature(self) -> float:
        """Fitted cell gamma expressed in (normalised-feature)^-2 units."""
        return self.gamma0 * self.v_scale * self.v_scale

    def input_scale(self, gamma_star) -> torch.Tensor:
        """Eq. (8): s_gamma = sqrt(gamma*/gamma0), in f32."""
        g = gamma_star if isinstance(gamma_star, torch.Tensor) else \
            torch.as_tensor(gamma_star, dtype=torch.float32)
        return torch.sqrt(g / self.gamma0_feature())

    def kernel_1d(self, dv_volts: torch.Tensor) -> torch.Tensor:
        """Interpolate the measured transfer curve at ``dv + mu`` (the fitted
        center offset is compensated, as a calibrated core peaks at 0)."""
        return interp(dv_volts + self.mu, _f32(self.dv_grid, dv_volts),
                      _f32(self.kernel_curve, dv_volts),
                      left=float(self.kernel_curve[0]),
                      right=float(self.kernel_curve[-1]))

    def kernel_1d_variants(self, dv_volts: torch.Tensor, shift: torch.Tensor,
                           gain: torch.Tensor) -> torch.Tensor:
        """Per-cell measured transfer under mismatch:
        ``gain * curve(dv + mu - shift)``, broadcasting ``dv`` against the
        per-cell ``shift`` / ``gain``; zero offsets give ``kernel_1d``'s
        arithmetic exactly."""
        return gain * interp(dv_volts + self.mu - shift,
                             _f32(self.dv_grid, dv_volts),
                             _f32(self.kernel_curve, dv_volts),
                             left=float(self.kernel_curve[0]),
                             right=float(self.kernel_curve[-1]))

    def kernel_response_variants(self, x: torch.Tensor, sv: torch.Tensor,
                                 gamma_star, shift: torch.Tensor,
                                 gain: torch.Tensor) -> torch.Tensor:
        """Separable kernel of ``V`` mismatched instances: ``x (n, d)``,
        ``sv (m, d)``, ``shift`` / ``gain (V, m, d)`` -> ``(V, n, m)``."""
        s = self.input_scale(gamma_star)
        dv = self.v_scale * s * (x[:, None, :] - sv[None, :, :])  # (n, m, d)
        k = self.kernel_1d_variants(dv[None], shift[:, None],
                                    gain[:, None])                # (V, n, m, d)
        return torch.prod(k, dim=-1)

    def kernel_response(self, x: torch.Tensor, sv: torch.Tensor,
                        gamma_star) -> torch.Tensor:
        """Separable D-dim kernel (Eq. 6 + Eq. 8): x (..., n, d),
        sv (..., m, d) -> (..., n, m); ``gamma_star`` a scalar or a tensor of
        the batch shape.

        This is the behavioral model and the kernel analog-bound classifiers
        are trained with (hardware-in-the-loop co-optimization).
        """
        s = self.input_scale(gamma_star)
        s = s.to(x.device)[..., None, None, None] if s.dim() else s
        dv = self.v_scale * s * (x[..., :, None, :] - sv[..., None, :, :])
        return torch.prod(self.kernel_1d(dv), dim=-1)

    # -- alpha multiplier ----------------------------------------------------
    def alpha_control_voltage(self, alpha: torch.Tensor) -> torch.Tensor:
        """Software mapping Eq. (9): desired alpha -> control differential."""
        a = torch.clamp(alpha, 1e-4, 1.0 - 1e-4)
        return self.alpha_x0 + self.alpha_s * torch.log(1.0 / a - 1.0)

    def alpha_realized(self, dva: torch.Tensor) -> torch.Tensor:
        """Alpha the circuit realises for a control voltage, interpolated
        from the measured sweep of this fabricated instance."""
        order = np.argsort(self.dva_grid, kind="stable")
        return interp(
            dva, _f32(self.dva_grid[order], dva),
            _f32(self.alpha_curve[order], dva),
            left=float(self.alpha_curve[np.argmin(self.dva_grid)]),
            right=float(self.alpha_curve[np.argmax(self.dva_grid)]))


@dataclasses.dataclass(frozen=True)
class AnalogBinaryClassifier:
    """A trained RBF SVM deployed on the analog hardware model (Sec. III-B)."""

    hw: AnalogRBFModel
    support_x: np.ndarray   # (m, d) hardwired SV bias voltages
    support_y: np.ndarray   # (m,) rail routing
    alpha_hw: np.ndarray    # (m,) normalised to (0, 1)
    bias_hw: float          # constant rail current (units of I_in)
    gamma_star: float

    @classmethod
    def deploy(cls, model: SVMModel, hw: AnalogRBFModel,
               alpha_floor_rel: float = 1.0 / 256.0
               ) -> "AnalogBinaryClassifier":
        """Deploy an RBF-family SVM onto the analog hardware model.

        Support vectors whose normalised dual coefficient falls below the
        alpha-control DAC resolution (``alpha_floor_rel``) are pruned.
        """
        if model.kind not in ("rbf", "sech2", "hw"):
            raise ValueError("only RBF-family classifiers are deployed in analog")
        alpha = np.asarray(model.alpha, np.float64)
        amax = float(alpha.max()) if alpha.size else 1.0
        keep = np.flatnonzero(alpha >= alpha_floor_rel * amax)
        # Positive rescale (sign-invariant): alphas into the multiplier's (0,1).
        scale = amax * 1.05
        return cls(
            hw=hw,
            support_x=model.support_x[keep],
            support_y=model.support_y[keep],
            alpha_hw=alpha[keep] / scale,
            bias_hw=float(model.bias / scale),
            gamma_star=float(model.gamma),
        )

    def rail_currents(self, x: np.ndarray, device=None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """(I_plus, I_minus) per input row, in units of I_in."""
        dev = resolve_device(device)
        f32 = dict(dtype=torch.float32, device=dev)
        k = self.hw.kernel_response(
            torch.as_tensor(np.asarray(x), **f32),
            torch.as_tensor(self.support_x, **f32), self.gamma_star)
        # Alpha path: desired -> control voltage (Eq. 9) -> realised (circuit).
        dva = self.hw.alpha_control_voltage(
            torch.as_tensor(self.alpha_hw, **f32))
        cur = k * self.hw.alpha_realized(dva)[None, :]
        pos = torch.as_tensor(self.support_y > 0, **f32)
        i_plus = cur @ pos + max(self.bias_hw, 0.0)
        i_minus = cur @ (1.0 - pos) + max(-self.bias_hw, 0.0)
        return i_plus, i_minus

    def predict_bits(self, x: np.ndarray, device=None) -> np.ndarray:
        """Comparator output: 1 if the + rail wins (class i of the pair)."""
        i_plus, i_minus = self.rail_currents(x, device)
        off = self.hw.params.comparator_offset / self.hw.params.i_bias
        return ((i_plus - i_minus + off) >= 0.0).to(torch.int32).cpu().numpy()

    # -- Monte-Carlo variation ------------------------------------------------

    def sample_variants(self, key: int, n_variants: int,
                        include_nominal: bool = True,
                        sigma_scale: float = 1.0,
                        device=None) -> VariantSet:
        """Mismatch for ``n_variants`` instances of THIS classifier's circuit
        (its ``m x d`` Gaussian cells, ``m`` alpha multipliers and one
        comparator), drawn from the integer ``key``."""
        return sample_variant_offsets(
            key, n_variants, self.n_support, self.n_features,
            include_nominal=include_nominal, sigma_scale=sigma_scale,
            device=device)

    def decision_mc(self, x: np.ndarray, variants: VariantSet,
                    device=None) -> torch.Tensor:
        """Comparator input ``I+ - I- + offset`` per variant: ``(V, n)``.

        Every instance evaluates its own perturbed Gaussian cells, alpha
        multipliers and comparator; the rails are accumulated per variant
        with the nominal ``(n, m) @ (m,)`` shapes, so the zero-offset row
        reproduces :meth:`rail_currents` exactly.
        """
        dev = resolve_device(device)
        f32 = dict(dtype=torch.float32, device=dev)
        v = VariantSet(*(torch.as_tensor(a, **f32) for a in
                         (variants.gauss, variants.alpha,
                          variants.comparator)))
        t = variant_transfer_params(v, self.hw.params)
        k = self.hw.kernel_response_variants(
            torch.as_tensor(np.asarray(x), **f32),
            torch.as_tensor(self.support_x, **f32), self.gamma_star,
            t.shift, t.gain)                                      # (V, n, m)
        dva = self.hw.alpha_control_voltage(
            torch.as_tensor(self.alpha_hw, **f32))                # (m,)
        a = self.hw.alpha_realized(
            (dva[None, :] - t.alpha_shift) / t.alpha_slope)       # (V, m)
        cur = k * a[:, None, :]
        pos = torch.as_tensor(self.support_y > 0, **f32)
        neg = 1.0 - pos
        bias_p, bias_n = max(self.bias_hw, 0.0), max(-self.bias_hw, 0.0)
        rows = [(cur[i] @ pos + bias_p) - (cur[i] @ neg + bias_n)
                for i in range(cur.shape[0])]
        return torch.stack(rows) + t.comp_offset[:, None]

    def predict_bits_mc(self, x: np.ndarray, variants: VariantSet,
                        device=None) -> np.ndarray:
        """Per-variant comparator bits ``(V, n)`` int32."""
        return (self.decision_mc(x, variants, device) >= 0.0
                ).to(torch.int32).cpu().numpy()

    @property
    def n_support(self) -> int:
        return int(self.support_x.shape[0])

    @property
    def n_features(self) -> int:
        return int(self.support_x.shape[1])
