"""CompiledMachine: one batched inference path for an OvO classifier bank.

The port of the nominal half of ``repro.api.compiled``.  ``compile_machine``
lowers any bank of bit-classifiers into padded, stacked tensors grouped
into a few homogeneous banks, and ``CompiledMachine.predict`` evaluates
every pair score, the comparator bits and the decision encoder in one
batched pass on the machine's device:

* ``_LinearBank`` — pairs whose score is an affine form: one matmul
  ``x_q @ W.T + b`` scores them all.
* ``_KernelBank`` — kernel pairs sharing (kind, input quantization,
  transfer curve), support vectors padded to the bank max ``M`` with zero
  coefficients.  The pos/neg rails mirror the analog comparator:
  ``f = (K @ c+ + b+) - (K @ c- + b-) + offset``.

Kernel dispatch: an 'rbf' / 'sech2' bank is scored by the kernel-matrix
hand kernel K1 (``repro_torch.kernels.ops.rbf_matrix``), one launch per
bank on the card, its plain version on the CPU; the ``(M, 2)`` rails
contraction after it is a batched matmul.  The analog 'hw' kind evaluates
the calibrated measured-curve kernel (interpolation + product).

The decision encoder is the packed truth table for P <= 12 pair bits and
vote counting + argmax (lowest-index tiebreak) above.  Saves are the
reference's npz + json format (version 1), read and written alike.  The
DAG decision front and the candidate / Monte-Carlo machines wait for later
slices.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import kernels as kern
from repro_torch.core import quant
from repro_torch.core.analog import AnalogBinaryClassifier
from repro_torch.core.ovo import (
    MAX_TABLE_BITS,
    DigitalLinearClassifier,
    DigitalRBFClassifier,
    MulticlassSVM,
    build_encoder_table,
    class_pairs,
)
from repro_torch.core.svm import SVMModel
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

_FORMAT_VERSION = 1
_FORMAT = "repro.api.CompiledMachine"

#: Decision fronts of this slice (the DAG front waits).
DECIDERS = ("votes",)


# ---------------------------------------------------------------------------
# Per-pair lowering specs (host-side, produced by compile_machine)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _LinearSpec:
    pair: int
    input_bits: int          # 0 = float input, else ADC bits
    w: np.ndarray            # (d,)
    b: float


@dataclasses.dataclass
class _KernelSpec:
    pair: int
    kind: str                # 'rbf' | 'sech2' | 'hw'
    input_bits: int
    sv: np.ndarray           # (m, d)
    coef_pos: np.ndarray     # (m,)
    coef_neg: np.ndarray     # (m,)
    bias_pos: float
    bias_neg: float
    offset: float            # comparator offset (analog), else 0
    gamma: float             # rbf/sech2 width; unused for 'hw'
    scale: float             # 'hw': prefolded v_scale * input_scale(gamma*)
    shift: float = 0.0       # 'hw': fitted center offset mu
    grid: Optional[np.ndarray] = None    # 'hw': measured sweep abscissa (V)
    curve: Optional[np.ndarray] = None   # 'hw': measured transfer, peak 1
    left: float = 0.0        # interp clamp values
    right: float = 0.0


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _hw_scale(hw, gamma: float) -> float:
    """Eq.-8 input scaling prefolded as the behavioral model applies it:
    ``(v_scale * s)`` with the product taken in f32."""
    return float(torch.tensor(hw.v_scale, dtype=torch.float32)
                 * hw.input_scale(torch.tensor(gamma, dtype=torch.float32)))


def _lower_svm_model(idx: int, model: SVMModel) -> _LinearSpec | _KernelSpec:
    """Lower a float SVMModel (a FloatBitClassifier's payload)."""
    if model.kind == "linear" and model.w is not None:
        return _LinearSpec(pair=idx, input_bits=0, w=_f32(model.w),
                           b=float(model.bias))
    coef = _f32(model.alpha * model.support_y)
    base = dict(pair=idx, input_bits=0, sv=_f32(model.support_x),
                coef_pos=coef, coef_neg=np.zeros_like(coef),
                bias_pos=float(model.bias), bias_neg=0.0, offset=0.0)
    if model.kind in ("rbf", "sech2"):
        return _KernelSpec(kind=model.kind, gamma=float(model.gamma),
                           scale=1.0, **base)
    if model.kind == "hw":
        hw = getattr(model.kernel_fn, "__self__", None)
        if hw is None:
            raise TypeError(
                "cannot lower kind='hw' model: kernel_fn is not a bound "
                "AnalogRBFModel.kernel_response method")
        return _KernelSpec(kind="hw", gamma=float(model.gamma),
                           scale=_hw_scale(hw, model.gamma),
                           shift=float(hw.mu), grid=_f32(hw.dv_grid),
                           curve=_f32(hw.kernel_curve),
                           left=float(hw.kernel_curve[0]),
                           right=float(hw.kernel_curve[-1]), **base)
    raise TypeError(f"cannot lower SVMModel of kind {model.kind!r}")


def _lower_classifier(idx: int, clf) -> _LinearSpec | _KernelSpec:
    """Lower one bit-classifier object into its stacked-array spec."""
    if isinstance(clf, DigitalLinearClassifier):
        return _LinearSpec(pair=idx, input_bits=clf.input_bits,
                           w=_f32(clf.w_q), b=float(clf.b_q))
    if isinstance(clf, DigitalRBFClassifier):
        coef = _f32(clf.coef)
        return _KernelSpec(
            pair=idx, kind="rbf", input_bits=clf.input_bits,
            sv=_f32(clf.support_x), coef_pos=coef,
            coef_neg=np.zeros_like(coef), bias_pos=float(clf.bias),
            bias_neg=0.0, offset=0.0, gamma=float(clf.gamma), scale=1.0)
    if isinstance(clf, AnalogBinaryClassifier):
        hw = clf.hw
        # Freeze the alpha path at compile time with the f32 ops the
        # behavioral model runs per call: desired alpha -> control voltage
        # (Eq. 9) -> realised alpha (measured sweep).  Host-side lowering.
        dva = hw.alpha_control_voltage(
            torch.as_tensor(clf.alpha_hw, dtype=torch.float32))
        a = hw.alpha_realized(dva).numpy()
        pos = (clf.support_y > 0)
        return _KernelSpec(
            pair=idx, kind="hw", input_bits=0, sv=_f32(clf.support_x),
            coef_pos=a * pos, coef_neg=a * (~pos),
            bias_pos=float(max(clf.bias_hw, 0.0)),
            bias_neg=float(max(-clf.bias_hw, 0.0)),
            offset=float(hw.params.comparator_offset / hw.params.i_bias),
            gamma=float(clf.gamma_star), scale=_hw_scale(hw, clf.gamma_star),
            shift=float(hw.mu), grid=_f32(hw.dv_grid),
            curve=_f32(hw.kernel_curve), left=float(hw.kernel_curve[0]),
            right=float(hw.kernel_curve[-1]))
    if isinstance(clf, SVMModel):
        return _lower_svm_model(idx, clf)
    model = getattr(clf, "model", None)   # FloatBitClassifier & duck-typed
    if isinstance(model, SVMModel):
        return _lower_svm_model(idx, model)
    raise TypeError(f"cannot lower classifier of type {type(clf).__name__}")


# ---------------------------------------------------------------------------
# Banks: grouped, padded, stacked tensors
# ---------------------------------------------------------------------------


def _t(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


@dataclasses.dataclass
class _LinearBank:
    input_bits: int
    pair_idx: np.ndarray     # (P,)
    w: torch.Tensor          # (P, d)
    b: torch.Tensor          # (P,)

    @classmethod
    def build(cls, specs: list[_LinearSpec], device) -> "_LinearBank":
        return cls(
            input_bits=specs[0].input_bits,
            pair_idx=np.asarray([s.pair for s in specs]),
            w=_t(np.stack([s.w for s in specs]), device),
            b=_t(np.asarray([s.b for s in specs], np.float32), device),
        )


@dataclasses.dataclass
class _KernelBank:
    kind: str
    input_bits: int
    pair_idx: np.ndarray     # (P,)
    sv: torch.Tensor         # (P, M, d), zero-padded to bank max M
    coef_pos: torch.Tensor   # (P, M), 0 on padded slots
    coef_neg: torch.Tensor   # (P, M)
    bias_pos: torch.Tensor   # (P,)
    bias_neg: torch.Tensor   # (P,)
    offset: torch.Tensor     # (P,)
    gamma: torch.Tensor      # (P,)
    scale: torch.Tensor      # (P,)
    shift: torch.Tensor      # (P,) 'hw' center offsets
    grid: Optional[torch.Tensor] = None
    curve: Optional[torch.Tensor] = None
    left: float = 0.0
    right: float = 0.0
    # Uniform-grid fast path for the measured-curve interpolation (derived
    # from `grid` at build/load time, not serialized).
    uniform_grid: bool = False
    inv_step: float = 0.0

    @classmethod
    def build(cls, specs: list[_KernelSpec], device) -> "_KernelBank":
        m_max = max(s.sv.shape[0] for s in specs)

        def pad(a):
            out = np.zeros((m_max,) + a.shape[1:], np.float32)
            out[: a.shape[0]] = a
            return out

        def col(name):
            return _t(np.asarray([getattr(s, name) for s in specs],
                                 np.float32), device)

        s0 = specs[0]
        return cls(
            kind=s0.kind, input_bits=s0.input_bits,
            pair_idx=np.asarray([s.pair for s in specs]),
            sv=_t(np.stack([pad(s.sv) for s in specs]), device),
            coef_pos=_t(np.stack([pad(s.coef_pos) for s in specs]), device),
            coef_neg=_t(np.stack([pad(s.coef_neg) for s in specs]), device),
            bias_pos=col("bias_pos"), bias_neg=col("bias_neg"),
            offset=col("offset"), gamma=col("gamma"), scale=col("scale"),
            shift=col("shift"),
            grid=None if s0.grid is None else _t(s0.grid, device),
            curve=None if s0.curve is None else _t(s0.curve, device),
            left=s0.left, right=s0.right,
            **kern._grid_fast_path(s0.grid),
        )


def _kernel_group_key(s: _KernelSpec):
    curve_key = None
    if s.grid is not None:
        curve_key = (s.grid.shape[0], hash(s.grid.tobytes()),
                     hash(s.curve.tobytes()))
    return (s.kind, s.input_bits, curve_key)


# ---------------------------------------------------------------------------
# Bank evaluation
# ---------------------------------------------------------------------------


def _bank_cell(bank: _KernelBank, dv: torch.Tensor) -> torch.Tensor:
    """The bank's measured 1-D transfer."""
    return kern.measured_cell(dv, bank.grid, bank.curve, bank.left,
                              bank.right, bank.uniform_grid, bank.inv_step)


def _pair_kernel(bank: _KernelBank, xv: torch.Tensor) -> torch.Tensor:
    """``(P, n, M)`` kernel matrices of every pair of the bank.

    'rbf' / 'sech2': one K1 launch (``v_scale=1.0``, feature-unit gamma).
    'hw': the measured-curve kernel, accumulated per dimension in (P, n, M)
    temporaries (the sequential multiply order of a product over d).
    """
    if bank.kind == "hw":
        acc = None
        for k in range(bank.sv.shape[-1]):
            dv = bank.scale[:, None, None] \
                * (xv[None, :, k:k + 1] - bank.sv[:, None, :, k]) \
                + bank.shift[:, None, None]
            k1 = _bank_cell(bank, dv)
            acc = k1 if acc is None else acc * k1
        return acc
    return ops.rbf_matrix(xv, bank.sv, bank.gamma, kind=bank.kind,
                          v_scale=1.0)


def _bank_scores(bank: _KernelBank, xv: torch.Tensor) -> torch.Tensor:
    """(n, P) decision scores for one kernel bank: the (P, n, M) kernel
    tensor feeds one batched (M, 2) contraction for the +/- rails."""
    k = _pair_kernel(bank, xv)
    rails = torch.bmm(k, torch.stack([bank.coef_pos, bank.coef_neg], dim=2))
    scores = (rails[..., 0] + bank.bias_pos[:, None]) \
        - (rails[..., 1] + bank.bias_neg[:, None]) + bank.offset[:, None]
    return scores.T


def _all_scores(x: torch.Tensor, linear_banks, kernel_banks,
                inv_perm: torch.Tensor) -> torch.Tensor:
    """x (n, d) f32 -> scores (n, P) in lowering (pair-index) order.

    Input quantization is computed once per distinct ADC width; the bank
    columns are concatenated and un-permuted back to pair order.
    """
    xq_cache: dict[int, torch.Tensor] = {}

    def xq(bits: int) -> torch.Tensor:
        if bits not in xq_cache:
            xq_cache[bits] = x if bits == 0 else quant.quantize_unit(x, bits)
        return xq_cache[bits]

    cols = [xq(b.input_bits) @ b.w.T + b.b[None, :] for b in linear_banks]
    cols += [_bank_scores(b, xq(b.input_bits)) for b in kernel_banks]
    return torch.cat(cols, dim=1)[:, inv_perm]


def _group_specs(specs: list):
    """Group lowered specs by datapath (the bank partition)."""
    linear_groups: dict[int, list[_LinearSpec]] = {}
    kernel_groups: dict[tuple, list[_KernelSpec]] = {}
    for s in specs:
        if isinstance(s, _LinearSpec):
            linear_groups.setdefault(s.input_bits, []).append(s)
        else:
            kernel_groups.setdefault(_kernel_group_key(s), []).append(s)
    return list(linear_groups.values()), list(kernel_groups.values())


def _build_banks(specs: list, device):
    """Group lowered specs by datapath into padded stacked banks."""
    linear_groups, kernel_groups = _group_specs(specs)
    return ([_LinearBank.build(g, device) for g in linear_groups],
            [_KernelBank.build(g, device) for g in kernel_groups])


def _inverse_perm(linear_banks, kernel_banks, n_total: int) -> np.ndarray:
    """Column order after bank concatenation -> lowering order inversion."""
    order = np.concatenate(
        [b.pair_idx for b in linear_banks]
        + [b.pair_idx for b in kernel_banks]).astype(np.int64)
    if order.shape[0] != n_total:
        raise ValueError(
            f"{order.shape[0]} lowered columns != {n_total} expected")
    inv = np.empty_like(order)
    inv[order] = np.arange(n_total)
    return inv


def _bank_feature_dim(linear_banks, kernel_banks) -> int:
    dims = {int(b.w.shape[1]) for b in linear_banks} | \
        {int(b.sv.shape[2]) for b in kernel_banks}
    if len(dims) > 1:
        raise ValueError(f"inconsistent feature counts across banks: {dims}")
    return dims.pop() if dims else 0


# ---------------------------------------------------------------------------
# Decision encoder: packed truth table or vote counting
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Decider:
    """Pair bits ``(..., P)`` -> class labels ``(...,)``.

    The packed truth table of ``build_encoder_table`` for
    ``P <= MAX_TABLE_BITS``; vote counting + argmax (lowest-index
    tiebreak) beyond it.
    """

    table: Optional[torch.Tensor]        # (2^P,) packed labels, or None
    bit_weights: Optional[torch.Tensor]  # (P,) 1 << arange(P), or None
    vote_a: Optional[torch.Tensor]       # (P, K) votes for class i of pair
    vote_b: Optional[torch.Tensor]       # (P, K) votes for class j of pair

    @classmethod
    def build(cls, n_classes: int, device) -> "_Decider":
        pairs = class_pairs(n_classes)
        n_pairs = len(pairs)
        if n_pairs <= MAX_TABLE_BITS:
            return cls(
                table=_t(build_encoder_table(n_classes), device, torch.int64),
                bit_weights=_t(1 << np.arange(n_pairs), device, torch.int64),
                vote_a=None, vote_b=None)
        a = np.zeros((n_pairs, n_classes), np.int64)
        b = np.zeros((n_pairs, n_classes), np.int64)
        for p, (i, j) in enumerate(pairs):
            a[p, i] = 1
            b[p, j] = 1
        return cls(table=None, bit_weights=None,
                   vote_a=_t(a, device, torch.int64),
                   vote_b=_t(b, device, torch.int64))

    def __call__(self, bits: torch.Tensor) -> torch.Tensor:
        bits = bits.to(torch.int64)
        if self.table is not None:
            return self.table[(bits * self.bit_weights).sum(-1)]
        votes = (bits[..., :, None] * self.vote_a).sum(-2) \
            + ((1 - bits)[..., :, None] * self.vote_b).sum(-2)
        return torch.argmax(votes, dim=-1)


# ---------------------------------------------------------------------------
# The compiled machine
# ---------------------------------------------------------------------------


class CompiledMachine:
    """A bank of OvO bit-classifiers lowered to one batched predict.

    Construct via :func:`compile_machine` (from live classifier objects),
    :meth:`CompiledMachine.load` (from an ``.npz`` + ``.json`` pair) or
    :func:`machine_from_arrays`.
    """

    def __init__(self, n_classes: int, linear_banks: list[_LinearBank],
                 kernel_banks: list[_KernelBank],
                 kernel_map: Optional[list[str]] = None,
                 decider: str = "votes", device=None):
        self.device = resolve_device(device)
        self.n_classes = int(n_classes)
        self._linear_banks = linear_banks
        self._kernel_banks = kernel_banks
        self.n_pairs = sum(len(b.pair_idx) for b in linear_banks) + \
            sum(len(b.pair_idx) for b in kernel_banks)
        expect = len(class_pairs(self.n_classes))
        if self.n_pairs != expect:
            raise ValueError(
                f"{self.n_pairs} lowered pairs for {self.n_classes} classes "
                f"(expected {expect})")
        if decider not in DECIDERS:
            raise ValueError(f"unknown decider {decider!r}; one of {DECIDERS}")
        self.decider = decider
        self.kernel_map = list(kernel_map) if kernel_map is not None else None
        self.n_features = _bank_feature_dim(linear_banks, kernel_banks)
        self._inv_perm = _t(_inverse_perm(linear_banks, kernel_banks,
                                          self.n_pairs), self.device,
                            torch.int64)
        self._decider = _Decider.build(self.n_classes, self.device)

    def describe(self) -> str:
        parts = [f"CompiledMachine(K={self.n_classes}, P={self.n_pairs}, "
                 f"device={self.device})"]
        for b in self._linear_banks:
            parts.append(f"  linear bank: {len(b.pair_idx)} pairs, "
                         f"d={b.w.shape[1]}, input_bits={b.input_bits}")
        for b in self._kernel_banks:
            parts.append(f"  {b.kind} bank: {len(b.pair_idx)} pairs, "
                         f"M={b.sv.shape[1]}, d={b.sv.shape[2]}, "
                         f"input_bits={b.input_bits}")
        return "\n".join(parts)

    # -- the single batched forward pass ------------------------------------

    def forward(self, x: torch.Tensor):
        """x (n, d) f32 on the machine's device -> (scores (n, P),
        bits (n, P), labels (n,))."""
        scores = _all_scores(x, self._linear_banks, self._kernel_banks,
                             self._inv_perm)
        bits = (scores >= 0.0).to(torch.int32)
        return scores, bits, self._decider(bits)

    def _as_input(self, x) -> torch.Tensor:
        x = torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32,
                            device=self.device)
        if x.ndim != 2 or (self.n_features and x.shape[1] != self.n_features):
            raise ValueError(
                f"expected (n, {self.n_features}) inputs, got shape "
                f"{tuple(x.shape)}")
        return x

    def _run(self, x):
        return self.forward(self._as_input(x))

    def decision_scores(self, x: np.ndarray) -> np.ndarray:
        """Raw per-pair decision scores (n, P) — pre-comparator."""
        return self._run(x)[0].cpu().numpy()

    def predict_bits(self, x: np.ndarray) -> np.ndarray:
        """Comparator bits (n, P), pair order of ``class_pairs``."""
        return self._run(x)[1].cpu().numpy()

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Class labels (n,) via the packed encoder table / vote counting."""
        return self._run(x)[2].cpu().numpy()

    def accuracy(self, x: np.ndarray, y: np.ndarray) -> float:
        return float(np.mean(self.predict(x) == np.asarray(y)))

    score = accuracy

    # -- serialization (npz arrays + json structure) -------------------------

    def save(self, path: str) -> None:
        """Write ``<path>.npz`` (arrays) + ``<path>.json`` (structure)."""
        path = _strip_ext(path)
        arrays, meta_banks = _bank_arrays(self._linear_banks,
                                          self._kernel_banks)
        meta = {
            "format": _FORMAT,
            "version": _FORMAT_VERSION,
            "n_classes": self.n_classes,
            "kernel_map": self.kernel_map,
            "decider": self.decider,
            "banks": meta_banks,
        }
        np.savez(path + ".npz", **arrays)
        with open(path + ".json", "w") as f:
            json.dump(meta, f, indent=2)

    @classmethod
    def load(cls, path: str, device=None,
             decider: Optional[str] = None) -> "CompiledMachine":
        path = _strip_ext(path)
        with open(path + ".json") as f:
            meta = json.load(f)
        with np.load(path + ".npz") as npz:
            arrays = {k: npz[k] for k in npz.files}
        return machine_from_arrays(meta, arrays, device=device,
                                   decider=decider)


def machine_from_arrays(meta: dict, arrays: dict, device=None,
                        decider: Optional[str] = None) -> CompiledMachine:
    """A machine from a save's JSON structure and its npz arrays."""
    if meta.get("format") != _FORMAT:
        raise ValueError("not a CompiledMachine save")
    if int(meta.get("version", 0)) > _FORMAT_VERSION:
        raise ValueError(f"CompiledMachine save version {meta['version']}; "
                         f"this build reads up to {_FORMAT_VERSION}")
    dev = resolve_device(device)
    linear_banks, kernel_banks = _banks_from_entries(meta["banks"], arrays,
                                                     dev)
    return CompiledMachine(meta["n_classes"], linear_banks, kernel_banks,
                           kernel_map=meta.get("kernel_map"),
                           decider=decider or meta.get("decider", "votes"),
                           device=dev)


def _strip_ext(path: str) -> str:
    for ext in (".npz", ".json"):
        if path.endswith(ext):
            return path[: -len(ext)]
    return path


def _bank_arrays(linear_banks, kernel_banks, prefix: str = ""
                 ) -> tuple[dict[str, np.ndarray], list[dict]]:
    """Serialize banks to ``{npz key: array}`` + JSON bank entries."""
    arrays: dict[str, np.ndarray] = {}
    meta_banks: list[dict] = []
    for i, b in enumerate(linear_banks):
        bid = f"{prefix}lin{i}"
        arrays[f"{bid}.w"] = b.w.cpu().numpy()
        arrays[f"{bid}.b"] = b.b.cpu().numpy()
        arrays[f"{bid}.pair_idx"] = b.pair_idx
        meta_banks.append({"type": "linear", "id": bid,
                           "input_bits": b.input_bits})
    for i, b in enumerate(kernel_banks):
        bid = f"{prefix}ker{i}"
        for name in ("sv", "coef_pos", "coef_neg", "bias_pos", "bias_neg",
                     "offset", "gamma", "scale", "shift"):
            arrays[f"{bid}.{name}"] = getattr(b, name).cpu().numpy()
        arrays[f"{bid}.pair_idx"] = b.pair_idx
        entry = {"type": "kernel", "id": bid, "kind": b.kind,
                 "input_bits": b.input_bits, "left": b.left,
                 "right": b.right}
        if b.grid is not None:
            arrays[f"{bid}.grid"] = b.grid.cpu().numpy()
            arrays[f"{bid}.curve"] = b.curve.cpu().numpy()
        meta_banks.append(entry)
    return arrays, meta_banks


def _banks_from_entries(entries: list[dict], arrays: dict, device):
    """Rebuild bank lists from JSON bank entries + the npz arrays."""
    linear_banks, kernel_banks = [], []
    for entry in entries:
        bid = entry["id"]

        def arr(name, dtype=torch.float32):
            return _t(arrays[f"{bid}.{name}"], device, dtype)

        if entry["type"] == "linear":
            linear_banks.append(_LinearBank(
                input_bits=int(entry["input_bits"]),
                pair_idx=np.asarray(arrays[f"{bid}.pair_idx"]),
                w=arr("w"), b=arr("b")))
            continue
        grid = arrays.get(f"{bid}.grid")
        kernel_banks.append(_KernelBank(
            kind=entry["kind"], input_bits=int(entry["input_bits"]),
            pair_idx=np.asarray(arrays[f"{bid}.pair_idx"]),
            sv=arr("sv"), coef_pos=arr("coef_pos"), coef_neg=arr("coef_neg"),
            bias_pos=arr("bias_pos"), bias_neg=arr("bias_neg"),
            offset=arr("offset"), gamma=arr("gamma"), scale=arr("scale"),
            shift=arr("shift"),
            grid=None if grid is None else arr("grid"),
            curve=None if grid is None else arr("curve"),
            left=float(entry["left"]), right=float(entry["right"]),
            **kern._grid_fast_path(grid)))
    return linear_banks, kernel_banks


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def compile_machine(machine: MulticlassSVM | Sequence,
                    n_classes: Optional[int] = None,
                    kernel_map: Optional[list[str]] = None,
                    decider: str = "votes",
                    device=None) -> CompiledMachine:
    """Lower a bank of bit-classifiers to a single batched inference path.

    ``machine`` is a :class:`~repro_torch.core.ovo.MulticlassSVM` or a
    plain sequence of per-pair classifiers in ``class_pairs`` order (then
    ``n_classes`` is required).  ``device`` (None: the card) holds the
    banks and runs ``predict``.
    """
    if isinstance(machine, MulticlassSVM):
        classifiers = list(machine.classifiers)
        n_classes = machine.n_classes
        kernel_map = list(machine.kernel_map)
    else:
        classifiers = list(machine)
        if n_classes is None:
            raise ValueError("n_classes is required for a bare classifier list")
    dev = resolve_device(device)
    specs = [_lower_classifier(i, c) for i, c in enumerate(classifiers)]
    linear_banks, kernel_banks = _build_banks(specs, dev)
    return CompiledMachine(n_classes, linear_banks, kernel_banks,
                           kernel_map=kernel_map, decider=decider, device=dev)
