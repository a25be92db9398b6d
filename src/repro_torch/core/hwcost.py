"""FlexIC area/power cost model (paper Sec. V), the port of ``repro.core.hwcost``.

Two halves, mirroring the paper's mixed-signal split:

* **Digital** — a gate-equivalent (GE) model of the bespoke R-NMOS
  datapaths: constant-coefficient multipliers cost one adder per CSD
  non-zero digit (zero / power-of-two weights are free), ripple adder
  trees, exact exp units for the digital-RBF baseline, the decision
  encoder and per-feature ADCs.  Power is proportional to device count.

* **Analog** — a component-level model built from the Table I device
  geometries: Gaussian cells, alpha multipliers, rail switches, a
  comparator and a layout overhead factor; power is bias current x supply
  per subthreshold branch.

Pure host arithmetic (numpy): the per-classifier primitive
``classifier_cost``, ``system_cost``, its walk over a deployed
``MulticlassSVM``, and the vectorized design-space costing:
``pair_cost_table`` prices every per-pair candidate once and
``assignment_costs`` prices an ``(S, P)`` assignment matrix in one pass.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import quant
from repro_torch.core.analog import AnalogBinaryClassifier
from repro_torch.core.ovo import (
    MAX_TABLE_BITS,
    DigitalLinearClassifier,
    DigitalRBFClassifier,
    MulticlassSVM,
    build_encoder_table,
)

# ---------------------------------------------------------------------------
# Gate-equivalent counts for digital blocks
# ---------------------------------------------------------------------------

FA_GE = 4.5          # full adder in R-NMOS unipolar logic
AND_GE = 1.0
ROM_BIT_GE = 0.25
ADC_GE = 110.0       # 4-bit SAR ADC digital part + comparator/DAC equivalent
EXP_GE = 450.0       # exact fixed-point exp unit (PWL, to-LSB-exact)


def adder_ge(width: int) -> float:
    return FA_GE * max(width, 1)


def adder_tree_ge(n_terms: int, width: int) -> float:
    """Balanced tree of (n_terms-1) ripple adders; width grows by level."""
    if n_terms <= 1:
        return 0.0
    total, level, terms = 0.0, 0, n_terms
    while terms > 1:
        pairs = terms // 2
        total += pairs * adder_ge(width + level)
        terms = terms - pairs
        level += 1
    return total


def const_mult_ge(code: int, in_bits: int, w_bits: int) -> float:
    """Bespoke constant multiplier: (CSD digits - 1) adders; 0/pow2 free."""
    cls = quant.weight_hardware_class(code)
    if cls in ("zero", "pow2"):
        return 0.0
    digits = quant.csd_nonzero_digits(code)
    return max(digits - 1, 1) * adder_ge(in_bits + w_bits)


def array_mult_ge(b1: int, b2: int) -> float:
    """General array multiplier."""
    return AND_GE * b1 * b2 + (b1 - 1) * adder_ge(b2)


def squarer_ge(bits: int) -> float:
    """Dedicated squarer ~ half an array multiplier (symmetry folding)."""
    return 0.55 * array_mult_ge(bits, bits)


def encoder_ge(n_classes: int) -> float:
    """Decision encoder (Fig. 1): 2-level AND-OR from its truth table.

    Past the packed-table regime (P > MAX_TABLE_BITS, i.e. K > 5) the
    hardwired AND-OR plane is unbuildable (2^P minterms); the deployed
    decision logic is then a votes realisation — K population counters
    over each class's K-1 pair bits plus a log2(K)-deep argmax comparator
    tree — costed from the same adder primitives.
    """
    n_in = int(math.comb(n_classes, 2))
    out_bits = max(int(np.ceil(np.log2(max(n_classes, 2)))), 1)
    if n_in > MAX_TABLE_BITS:
        cnt_bits = out_bits  # ceil(log2(K)) >= ceil(log2(K-1+1)) counter width
        counters = n_classes * adder_tree_ge(n_classes - 1, 1)
        argmax = (n_classes - 1) * (
            adder_ge(cnt_bits)             # magnitude comparator ~ subtractor
            + AND_GE * (cnt_bits + out_bits))  # index/count muxes
        return counters + argmax + out_bits * AND_GE
    table = build_encoder_table(n_classes)
    # minterms where each output bit is 1; each minterm = one n_in-input AND.
    literals = 0
    for b in range(out_bits):
        on = int(np.sum((table >> b) & 1))
        literals += min(on, len(table) - on) * n_in
    return literals * AND_GE * 0.5 + out_bits * AND_GE  # crude 2-level logic


# ---------------------------------------------------------------------------
# Per-classifier GE
# ---------------------------------------------------------------------------


def linear_classifier_ge(clf: DigitalLinearClassifier) -> float:
    codes = clf.weight_codes()
    w_codes, b_code = codes[:-1], codes[-1]
    in_b, w_b = clf.input_bits, clf.w_fp.bits
    ge = 0.0
    nonzero_products = 0
    for c in w_codes:
        ge += const_mult_ge(int(c), in_b, w_b)
        if int(c) != 0:
            nonzero_products += 1
    prod_width = in_b + w_b
    ge += adder_tree_ge(nonzero_products, prod_width)
    if int(b_code) != 0:
        ge += adder_ge(prod_width + 2)  # bias addition
    ge += 1.0  # sign = MSB tap + buffer
    return ge


def digital_rbf_classifier_ge(clf: DigitalRBFClassifier) -> float:
    m, d = clf.n_support, clf.n_features
    in_b = clf.input_bits + 1           # signed difference
    sq_b = 2 * clf.input_bits + 1
    ge_sv = (
        d * (adder_ge(in_b) + squarer_ge(in_b))      # (x_d - s_d)^2
        + adder_tree_ge(d, sq_b)                     # sum over dims
        + array_mult_ge(clf.sv_fp.bits, sq_b)        # * gamma (fixed point)
        + EXP_GE                                     # exp(-.)
        + array_mult_ge(clf.coef_fp.bits, clf.sv_fp.bits)  # * alpha_j y_j
    )
    ge = m * ge_sv + adder_tree_ge(m, clf.coef_fp.bits + clf.sv_fp.bits)
    ge += adder_ge(clf.coef_fp.bits + clf.sv_fp.bits + int(np.ceil(np.log2(max(m, 2)))))
    ge += 1.0
    return ge


# ---------------------------------------------------------------------------
# Analog component-level model (Table I geometries)
# ---------------------------------------------------------------------------

# Device areas in um^2 straight from Table I.
_GAUSS_CELL_UM2 = (
    4 * (40.0 * 0.6)      # Q1-Q3, Q6
    + (1.0 * 0.6)         # Q4
    + (20.0 * 1.2)        # Q5
    + (0.6 * 28.5)        # R1 = 10 MOhm
    + (0.6 * 12.2)        # R2 = 4.28 MOhm
)
_ALPHA_MULT_UM2 = 4 * (40.0 * 0.6)   # Q1-Q4
_RAIL_SWITCH_UM2 = 2 * (10.0 * 0.6)  # y_j routing switch


@dataclasses.dataclass
class CostModel:
    """Unit constants; see module docstring for the calibration protocol."""

    # digital units (calibrated on Table II linear column)
    area_per_ge_um2: float = 28.0
    power_per_ge_nw: float = 4.6
    # analog units
    layout_factor: float = 1.6           # wiring/bias-distribution overhead
    i_bias_na: float = 150.0             # per-branch subthreshold bias (nA)
    v_analog: float = 1.0                # analog supply (V)
    branches_per_cell: float = 2.0       # kernel chain + readout branch
    comparator_area_um2: float = 5200.0  # from [34]
    comparator_power_nw: float = 580.0

    # -- digital ------------------------------------------------------------
    def digital(self, ge: float) -> tuple[float, float]:
        """GE -> (area mm^2, power mW)."""
        return (
            ge * self.area_per_ge_um2 * 1e-6,
            ge * self.power_per_ge_nw * 1e-6,
        )

    def adc(self, n_features: int) -> tuple[float, float]:
        return self.digital(n_features * ADC_GE)

    # -- analog -------------------------------------------------------------
    def analog_rbf(self, clf: AnalogBinaryClassifier) -> tuple[float, float]:
        m, d = clf.n_support, clf.n_features
        dev_um2 = m * (d * _GAUSS_CELL_UM2 + _ALPHA_MULT_UM2 + _RAIL_SWITCH_UM2)
        area_mm2 = (dev_um2 * self.layout_factor + self.comparator_area_um2) * 1e-6
        branches = m * (d * self.branches_per_cell + 1.0)  # + alpha multiplier
        power_mw = (
            branches * self.i_bias_na * 1e-9 * self.v_analog * 1e3
            + self.comparator_power_nw * 1e-6
        )
        return area_mm2, power_mw


@dataclasses.dataclass
class SystemCost:
    area_mm2: float
    power_mw: float
    area_analog_mm2: float
    power_analog_mw: float
    area_digital_mm2: float
    power_digital_mw: float

    @property
    def analog_area_frac(self) -> float:
        return self.area_analog_mm2 / self.area_mm2 if self.area_mm2 else 0.0

    @property
    def analog_power_frac(self) -> float:
        return self.power_analog_mw / self.power_mw if self.power_mw else 0.0


def classifier_cost(clf, cm: CostModel) -> tuple[float, float, str]:
    """Pure per-classifier cost primitive: ``(area mm^2, power mW, domain)``.

    ``domain`` is ``'digital'`` (the classifier consumes digitized inputs —
    it forces the per-feature ADC bank to exist) or ``'analog'`` (reads the
    sensor rails directly).
    """
    if isinstance(clf, DigitalLinearClassifier):
        a, p = cm.digital(linear_classifier_ge(clf))
        return a, p, "digital"
    if isinstance(clf, DigitalRBFClassifier):
        a, p = cm.digital(digital_rbf_classifier_ge(clf))
        return a, p, "digital"
    if isinstance(clf, AnalogBinaryClassifier):
        a, p = cm.analog_rbf(clf)
        return a, p, "analog"
    # float adapters — no hardware
    raise TypeError(f"cannot cost a non-deployed classifier: {type(clf)}")


def system_cost(svm: MulticlassSVM, cm: CostModel) -> SystemCost:
    """Total cost of a deployed multiclass SVM incl. encoder and ADCs.

    Walks the object bank once, summing :func:`classifier_cost`, then adds
    the encoder and — only if at least one digital classifier consumes
    digitized inputs — the per-feature ADC bank (analog RBF reads the
    sensor rails directly; that is the point of the mixed-signal
    architecture).
    """
    a_d = p_d = a_a = p_a = 0.0
    needs_adc_features = 0
    for clf in svm.classifiers:
        a, p, domain = classifier_cost(clf, cm)
        if domain == "digital":
            a_d += a; p_d += p
            needs_adc_features = max(needs_adc_features, clf.n_features)
        else:
            a_a += a; p_a += p
    a, p = cm.digital(encoder_ge(svm.n_classes))
    a_d += a; p_d += p
    if needs_adc_features:
        a, p = cm.adc(needs_adc_features)
        a_d += a; p_d += p
    return SystemCost(
        area_mm2=a_d + a_a, power_mw=p_d + p_a,
        area_analog_mm2=a_a, power_analog_mw=p_a,
        area_digital_mm2=a_d, power_digital_mw=p_d,
    )


# ---------------------------------------------------------------------------
# Vectorized assignment costing (the design-space cost path)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PairCostTable:
    """Per-pair candidate costs, priced once for a whole design space.

    Column 0 is the pair's linear-digital candidate, column 1 its
    RBF-analog candidate (each candidate is priced by its actual domain).
    All arrays are ``(P, 2)`` float64.  ``n_features`` is the candidate's
    ADC feature demand: its feature count for digital candidates, 0 for
    analog ones (which read the sensor rails directly).
    """

    area: np.ndarray          # (P, 2) per-candidate area mm^2
    power: np.ndarray         # (P, 2) per-candidate power mW
    n_features: np.ndarray    # (P, 2) ADC feature demand (0 for analog)
    encoder_area: float
    encoder_power: float
    adc_area_per_feature: float
    adc_power_per_feature: float

    @property
    def n_pairs(self) -> int:
        return int(self.area.shape[0])


def _n_classes_from_pairs(n_pairs: int) -> int:
    """Invert P = K(K-1)/2 (raises if P is not a valid pair count)."""
    k = int(round((1.0 + math.sqrt(1.0 + 8.0 * n_pairs)) / 2.0))
    if k * (k - 1) // 2 != n_pairs:
        raise ValueError(f"{n_pairs} is not K(K-1)/2 for any integer K")
    return k


def pair_cost_table(candidates, cm: CostModel,
                    n_classes: int | None = None) -> PairCostTable:
    """Price every per-pair candidate once.

    ``candidates`` is a sequence of ``(linear_clf, rbf_clf)`` deployed
    classifier pairs in ``class_pairs`` order.  The shared system terms
    (decision encoder; ADC per digitized feature) are priced here too, so
    ``assignment_costs`` is pure array arithmetic.
    """
    if n_classes is None:
        n_classes = _n_classes_from_pairs(len(candidates))
    p = len(candidates)
    area = np.zeros((p, 2))
    power = np.zeros((p, 2))
    n_features = np.zeros((p, 2))
    for i, pair_cands in enumerate(candidates):
        for j, clf in enumerate(pair_cands):
            a, pw, domain = classifier_cost(clf, cm)
            area[i, j], power[i, j] = a, pw
            if domain == "digital":
                n_features[i, j] = clf.n_features
    enc_a, enc_p = cm.digital(encoder_ge(n_classes))
    adc_a, adc_p = cm.adc(1)
    return PairCostTable(
        area=area, power=power, n_features=n_features,
        encoder_area=enc_a, encoder_power=enc_p,
        adc_area_per_feature=adc_a, adc_power_per_feature=adc_p,
    )


def assignment_costs(pairs, assignments: np.ndarray,
                     cm: CostModel | None = None
                     ) -> tuple[np.ndarray, np.ndarray]:
    """System cost of ``S`` candidate assignments in one numpy pass.

    ``pairs`` is a :class:`PairCostTable` or a sequence of per-pair
    ``(linear_clf, rbf_clf)`` candidates (then ``cm`` is required).
    ``assignments`` is an ``(S, P)`` boolean matrix (True: pair ``p`` on
    its RBF candidate).  Returns ``(area (S,), power (S,))`` in mm^2 / mW,
    each equal (to f64 round-off) to ``system_cost`` on the object bank
    assembled from the same candidates.
    """
    if not isinstance(pairs, PairCostTable):
        if cm is None:
            raise ValueError(
                "assignment_costs needs a CostModel when given raw "
                "candidate pairs (pass cm=...)")
        pairs = pair_cost_table(pairs, cm)
    t = pairs
    a = np.atleast_2d(np.asarray(assignments, bool))
    if a.shape[1] != t.n_pairs:
        raise ValueError(
            f"assignment matrix has {a.shape[1]} pairs, table has "
            f"{t.n_pairs}")
    sel = a.astype(np.float64)                       # (S, P): 1 -> rbf col
    area = sel @ t.area[:, 1] + (1.0 - sel) @ t.area[:, 0]
    power = sel @ t.power[:, 1] + (1.0 - sel) @ t.power[:, 0]
    # ADC bank: sized by the widest digitized classifier actually selected
    # (system_cost's max over digital classifiers; 0 features -> no ADC).
    nf_sel = np.where(a, t.n_features[:, 1], t.n_features[:, 0])  # (S, P)
    nf = nf_sel.max(axis=1) if t.n_pairs else np.zeros(a.shape[0])
    area = area + t.encoder_area + nf * t.adc_area_per_feature
    power = power + t.encoder_power + nf * t.adc_power_per_feature
    return area, power


# ---------------------------------------------------------------------------
# Calibration against the Table II linear column
# ---------------------------------------------------------------------------

TABLE2_LINEAR = {  # dataset -> (area mm^2, power mW) of the all-linear design
    "balance": (0.024, 0.004),
    "seeds": (0.067, 0.011),
    "vertebral": (0.092, 0.014),
}

TABLE2 = {  # dataset -> design -> (acc %, area mm^2, power mW, rbf, linear)
    "balance": {
        "linear": (92, 0.024, 0.004, 0, 3),
        "rbf": (93, 13.400, 2.230, 3, 0),
        "mixed": (92, 0.062, 0.081, 1, 2),
    },
    "seeds": {
        "linear": (92, 0.067, 0.011, 0, 3),
        "rbf": (95, 7.000, 1.190, 3, 0),
        "mixed": (95, 0.125, 0.092, 1, 2),
    },
    "vertebral": {
        "linear": (69, 0.092, 0.014, 0, 3),
        "rbf": (83, 5.600, 0.960, 3, 0),
        "mixed": (89, 0.108, 0.088, 2, 1),
    },
}


def calibrate_digital(
    linear_systems: dict[str, MulticlassSVM], cm: CostModel | None = None
) -> CostModel:
    """Least-squares fit of (area_per_ge, power_per_ge) on the linear column.

    One multiplicative constant per metric: unit = sum(ref * ge) / sum(ge^2)
    minimises sum_i (ge_i * unit - ref_i)^2 over the three datasets.
    """
    cm = cm or CostModel()
    ges, areas, powers = [], [], []
    for name, sys in linear_systems.items():
        ge = sum(
            linear_classifier_ge(c) for c in sys.classifiers
        ) + encoder_ge(sys.n_classes) + ADC_GE * max(
            c.n_features for c in sys.classifiers
        )
        ref_a, ref_p = TABLE2_LINEAR[name]
        ges.append(ge); areas.append(ref_a); powers.append(ref_p)
    ges = np.asarray(ges)
    area_unit = float(np.sum(np.asarray(areas) * ges) / np.sum(ges * ges)) * 1e6
    power_unit = float(np.sum(np.asarray(powers) * ges) / np.sum(ges * ges)) * 1e6
    return dataclasses.replace(
        cm, area_per_ge_um2=area_unit, power_per_ge_nw=power_unit
    )
