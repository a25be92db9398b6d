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
vote counting + argmax (lowest-index tiebreak) above.  A machine built with
``decider="dag"`` predicts through the DDAG elimination front instead: K-1
steps, each gathering the one pair a sample still has to consult and
scoring it alone (plain torch; K1 scores a shared query block, not a pair
per sample).  Saves are the reference's npz + json format (version 1),
read and written alike, the decider included.

The same lowering serves the kernel-assignment design space
(``repro_torch.core.dse``):

* :class:`CandidateMachine` (:func:`compile_candidates`) lowers BOTH
  candidates of every pair and returns the assignment-independent bit
  tensor ``pair_bits(x) -> (n, P, 2)`` in one batched pass.
* :class:`MonteCarloMachine` (:func:`compile_variants`) evaluates every
  analog candidate under ``V`` sampled mismatch instances: ``(V, n, P,
  2)``, variant 0 the nominal bank's own scores.
* :class:`StreamingMCMachine` (:func:`compile_mc_stream`) draws, scores and
  folds fixed-size chunks of variants into ``mcstream`` accumulators, so
  its memory is flat from V = 64 to V = 10^6.

These paths reach no hand kernel: their RBF candidates are analog 'hw'
banks (plain-torch measured-curve interpolation).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import dse, mcstream, quant
from repro_torch.core import kernels as kern
from repro_torch.core.analog import (
    AnalogBinaryClassifier,
    VariantSet,
    counter_normals,
    stream_key,
    variant_dim,
    variant_set_from_flat,
    variant_transfer_params,
)
from repro_torch.core.ovo import (
    MAX_TABLE_BITS,
    DigitalLinearClassifier,
    DigitalRBFClassifier,
    MulticlassSVM,
    build_encoder_table,
    class_pairs,
    pair_index_matrix,
)
from repro_torch.core.svm import SVMModel
from repro_torch.device import device_key, resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import (
    VARIANTS_AXIS,
    make_variant_mesh,
    require_axis,
)

_FORMAT_VERSION = 1
_FORMAT = "repro.api.CompiledMachine"

#: Decision fronts a machine can be built with.  ``"votes"``: every pair
#: evaluated, encoder table / votes argmax; ``"dag"``: the DDAG elimination
#: front, K-1 pair evaluations per sample, equal to votes wherever a
#: Condorcet winner exists (``repro_torch.core.ovo.decide_dag``).
DECIDERS = ("votes", "dag")


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


def _as_input(x, device, n_features: int) -> torch.Tensor:
    """``x`` as ``(n, n_features)`` f32 on ``device``, or raise."""
    x = torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32,
                        device=device)
    if x.ndim != 2 or (n_features and x.shape[1] != n_features):
        raise ValueError(f"expected (n, {n_features}) inputs, got shape "
                         f"{tuple(x.shape)}")
    return x


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


def _to_device(obj, device: torch.device):
    """A bank (or stream constants) dataclass with every tensor field on
    ``device``; the object itself when nothing moves."""
    moved = {f.name: v.to(device) for f in dataclasses.fields(obj)
             if isinstance(v := getattr(obj, f.name), torch.Tensor)
             and device_key(v.device) != device_key(device)}
    return dataclasses.replace(obj, **moved) if moved else obj


def _device_context(device: torch.device):
    """``device`` as the current card while work is enqueued on it (a
    no-op for the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()


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


def _pair_kernel(bank: _KernelBank, xv: torch.Tensor,
                 vshift: Optional[torch.Tensor] = None,
                 vgain: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(P, n, M)`` kernel matrices of every pair of the bank.

    'rbf' / 'sech2': one K1 launch (``v_scale=1.0``, feature-unit gamma).
    'hw': the measured-curve kernel, accumulated per dimension in (P, n, M)
    temporaries (the sequential multiply order of a product over d).

    ``vshift`` / ``vgain (..., P, M, d)``, when given ('hw' only), evaluate
    Monte-Carlo variants' per-cell perturbed transfers,
    ``gain * curve(dv + mu - vshift)``, into ``(..., P, n, M)``.  A
    zero-offset variant subtracts an exact 0 and multiplies by an exact 1
    around the same interpolation, so its kernel values are the nominal
    ones bit for bit.
    """
    if bank.kind == "hw":
        acc = None
        for k in range(bank.sv.shape[-1]):
            dv = bank.scale[:, None, None] \
                * (xv[None, :, k:k + 1] - bank.sv[:, None, :, k]) \
                + bank.shift[:, None, None]
            if vshift is not None:
                dv = dv - vshift[..., :, None, :, k]
            k1 = _bank_cell(bank, dv)
            if vgain is not None:
                k1 = k1 * vgain[..., :, None, :, k]
            acc = k1 if acc is None else acc * k1
        return acc
    if vshift is not None or vgain is not None:
        raise TypeError(f"variant lanes require the 'hw' measured-curve "
                        f"kind, got {bank.kind!r}")
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
# DAG decision front: O(K) pair evaluations per sample
# ---------------------------------------------------------------------------


def _banks_device(linear_banks, kernel_banks) -> torch.device:
    for b in linear_banks:
        return b.w.device
    for b in kernel_banks:
        return b.sv.device
    raise ValueError("a machine needs at least one bank")


def _dag_row_maps(linear_banks, kernel_banks, n_pairs: int):
    """Host-built global-pair -> bank-row gather maps, one per bank.

    For each bank (linear banks first, then kernel banks — the DAG front
    iterates them in the same order) returns ``(rows, mask)`` on the banks'
    device: ``rows (P,)`` int64 maps a global pair index to the bank row
    holding it (0 where the bank does not own the pair) and ``mask (P,)``
    f32 is 1.0 exactly on the owned pairs.  A sample's per-step score is
    the masked sum over banks, so every pair is scored by precisely the
    datapath that owns it.
    """
    dev = _banks_device(linear_banks, kernel_banks)
    maps = []
    for b in list(linear_banks) + list(kernel_banks):
        rows = np.zeros(n_pairs, np.int64)
        mask = np.zeros(n_pairs, np.float32)
        for r, g in enumerate(np.asarray(b.pair_idx)):
            rows[int(g)] = r
            mask[int(g)] = 1.0
        maps.append((_t(rows, dev, torch.int64), _t(mask, dev)))
    return maps


def _dag_step_plans(linear_banks, kernel_banks, n_classes: int):
    """Static per-step work plans for the DAG gather front.

    At step ``t`` the carried interval satisfies ``hi - lo == K-1-t``, so
    the only pairs a sample can visit are ``{(j, j + K-1-t) : j <= t}``.
    For every bank and step this precomputes:

    * ``None`` — the bank owns no reachable pair: skip it (its masked
      contribution would be an exact ``0.0`` for every sample);
    * ``-1`` (linear banks) — participate, nothing to slice;
    * ``m_t > 0`` (kernel banks) — participate, and slice the support axis
      to the largest support length over the reachable owned pairs: the
      slots up to a pair's last nonzero coefficient.  The slots after it
      (the bank's padding) carry zero coefficients, so dropping them
      removes ``+0.0`` terms from the rails' sums.  The length is not the
      count of nonzero coefficients, as the reference takes it: a
      quantized digital bank can hold a zero coefficient between nonzero
      ones, and slicing to the count would drop real support vectors.
    """
    pairs = class_pairs(n_classes)
    idx = {p: i for i, p in enumerate(pairs)}
    n_lin = len(linear_banks)
    owned = []
    for bi, b in enumerate(list(linear_banks) + list(kernel_banks)):
        if bi < n_lin:
            owned.append({int(g): 0 for g in np.asarray(b.pair_idx)})
        else:
            nz = (np.abs(b.coef_pos.cpu().numpy())
                  + np.abs(b.coef_neg.cpu().numpy())) != 0.0     # (P, M)
            length = np.where(nz.any(axis=1),
                              nz.shape[1] - np.argmax(nz[:, ::-1], axis=1), 0)
            owned.append({int(g): int(mm)
                          for g, mm in zip(np.asarray(b.pair_idx), length)})
    plans = []
    for t in range(n_classes - 1):
        gap = n_classes - 1 - t
        reach = [idx[(j, j + gap)] for j in range(t + 1)]
        plan = []
        for bi, o in enumerate(owned):
            ms = [o[p] for p in reach if p in o]
            if not ms:
                plan.append(None)
            elif bi < n_lin:
                plan.append(-1)
            else:
                plan.append(max(max(ms), 1))
        plans.append(tuple(plan))
    return plans


def _gather_kernel(bank: _KernelBank, xv: torch.Tensor, r: torch.Tensor,
                   m_t: int) -> torch.Tensor:
    """``(n, m_t)`` kernel values of each sample against the support
    vectors of its own pair ``r[i]`` of the bank.

    'hw' runs ``_pair_kernel``'s elementwise arithmetic (the same ops in
    the same order, the product over d taken sequentially), so each value
    equals the dense path's; 'rbf' / 'sech2' run K1's plain version
    (``kernels.ref``): K1 scores one query block against every pair, not
    one pair per sample.
    """
    sv = bank.sv[:, :m_t][r]                                  # (n, m_t, d)
    if bank.kind == "hw":
        scale, shift = bank.scale[r][:, None], bank.shift[r][:, None]
        acc = None
        for k in range(sv.shape[-1]):
            dv = scale * (xv[:, k:k + 1] - sv[:, :, k]) + shift
            k1 = _bank_cell(bank, dv)
            acc = k1 if acc is None else acc * k1
        return acc
    if bank.kind == "rbf":
        return ref.rbf_matrix(xv[:, None, :], sv, bank.gamma[r])[:, 0]
    if bank.kind == "sech2":
        return ref.sech2_matrix(xv[:, None, :], sv, bank.gamma[r],
                                v_scale=1.0)[:, 0]
    raise TypeError(f"no DAG gather for kernel kind {bank.kind!r}")


def _gather_pair_scores(p, linear_banks, kernel_banks, row_maps, xq_cache,
                        plan=None):
    """Decision scores of ONE (per-sample) pair: ``p (n,) -> (n,)``.

    The gather sibling of ``_all_scores``: each sample gathers the
    parameters of the single pair ``p[i]`` from the bank that owns it and
    evaluates that one classifier.  ``plan`` (one entry of
    :func:`_dag_step_plans`) skips banks that own no reachable pair this
    step and slices kernel-bank gathers to the reachable true support
    count.
    """
    total = torch.zeros(p.shape[0], dtype=torch.float32, device=p.device)
    mi = 0
    for bank in linear_banks:
        rows, mask = row_maps[mi]
        step = None if plan is None else plan[mi]
        mi += 1
        if plan is not None and step is None:
            continue
        r = rows[p]
        xv = xq_cache[bank.input_bits]
        s = torch.sum(xv * bank.w[r], dim=-1) + bank.b[r]
        total = total + mask[p] * s
    for bank in kernel_banks:
        rows, mask = row_maps[mi]
        step = None if plan is None else plan[mi]
        mi += 1
        if plan is not None and step is None:
            continue
        m_t = bank.sv.shape[1] if (plan is None or step == -1) else int(step)
        r = rows[p]
        k = _gather_kernel(bank, xq_cache[bank.input_bits], r, m_t)
        coef = torch.stack([bank.coef_pos[:, :m_t][r],
                            bank.coef_neg[:, :m_t][r]], dim=2)  # (n, m_t, 2)
        rails = torch.bmm(k[:, None, :], coef)[:, 0]            # (n, 2)
        s = (rails[:, 0] + bank.bias_pos[r]) \
            - (rails[:, 1] + bank.bias_neg[r]) + bank.offset[r]
        total = total + mask[p] * s
    return total


def _dag_labels(x, n_classes: int, pair_matrix, linear_banks, kernel_banks,
                row_maps, step_plans=None):
    """DDAG elimination front: ``x (n, d) -> labels (n,)`` in O(n*K).

    A loop of K-1 steps carries the per-sample candidate interval
    ``(lo, hi)`` on the device; each step scores pair ``(lo, hi)`` through
    the gather front and eliminates one endpoint (score >= 0: the lower
    class wins, as ``repro_torch.core.ovo.decide_dag`` reads bit 1).  Each
    step runs its own static plan from :func:`_dag_step_plans`.  Nothing
    in the loop reads a device value on the host, so the steps queue
    without a sync.
    """
    xq_cache: dict[int, torch.Tensor] = {}
    for bank in list(linear_banks) + list(kernel_banks):
        bits = bank.input_bits
        if bits not in xq_cache:
            xq_cache[bits] = x if bits == 0 else quant.quantize_unit(x, bits)
    n = x.shape[0]
    lo = torch.zeros(n, dtype=torch.int64, device=x.device)
    hi = torch.full((n,), n_classes - 1, dtype=torch.int64, device=x.device)
    for t in range(n_classes - 1):
        p = pair_matrix[lo, hi]                                 # (n,)
        plan = None if step_plans is None else step_plans[t]
        s = _gather_pair_scores(p, linear_banks, kernel_banks, row_maps,
                                xq_cache, plan)
        win = s >= 0.0                                          # lower wins
        lo = torch.where(win, lo, lo + 1)
        hi = torch.where(win, hi - 1, hi)
    return lo


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
        # The dense votes path stays the oracle behind `predict_votes`,
        # `decision_scores` and `predict_bits`; "dag" adds the O(K) front.
        self._pair_matrix = None
        self._row_maps = None
        self._step_plans = None
        if decider == "dag":
            self._pair_matrix = _t(pair_index_matrix(self.n_classes),
                                   self.device, torch.int64)
            self._row_maps = _dag_row_maps(linear_banks, kernel_banks,
                                           self.n_pairs)
            self._step_plans = _dag_step_plans(linear_banks, kernel_banks,
                                               self.n_classes)

    @property
    def n_linear_pairs(self) -> int:
        return sum(len(b.pair_idx) for b in self._linear_banks)

    @property
    def n_kernel_pairs(self) -> int:
        return sum(len(b.pair_idx) for b in self._kernel_banks)

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

    def _labels_dag(self, x: torch.Tensor) -> torch.Tensor:
        """x (n, d) f32 on the machine's device -> labels (n,) via the O(K)
        DAG front (``decider="dag"``)."""
        return _dag_labels(x, self.n_classes, self._pair_matrix,
                           self._linear_banks, self._kernel_banks,
                           self._row_maps, self._step_plans)

    def to(self, device) -> "CompiledMachine":
        """This machine with its banks on ``device`` (itself if they are
        there already)."""
        dev = resolve_device(device)
        if device_key(dev) == device_key(self.device):
            return self
        return CompiledMachine(
            self.n_classes, [_to_device(b, dev) for b in self._linear_banks],
            [_to_device(b, dev) for b in self._kernel_banks],
            kernel_map=self.kernel_map, decider=self.decider, device=dev)

    def _as_input(self, x) -> torch.Tensor:
        return _as_input(x, self.device, self.n_features)

    def _run(self, x):
        return self.forward(self._as_input(x))

    def decision_scores(self, x: np.ndarray) -> np.ndarray:
        """Raw per-pair decision scores (n, P) — pre-comparator."""
        return self._run(x)[0].cpu().numpy()

    def predict_bits(self, x: np.ndarray) -> np.ndarray:
        """Comparator bits (n, P), pair order of ``class_pairs``."""
        return self._run(x)[1].cpu().numpy()

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Class labels (n,) via the machine's decision front.

        ``decider="votes"`` (default): every pair is evaluated and the
        packed encoder table / vote counting decides.  ``decider="dag"``:
        the DDAG elimination front evaluates K-1 pairs per sample; equal
        to the votes labels wherever the vote winner is unambiguous
        (Condorcet), measured by :meth:`dag_votes_agreement` elsewhere.
        """
        if self.decider == "dag":
            return self._labels_dag(self._as_input(x)).cpu().numpy()
        return self._run(x)[2].cpu().numpy()

    def predict_votes(self, x: np.ndarray) -> np.ndarray:
        """Class labels (n,) via the dense votes path, whatever the
        machine's ``decider`` — the oracle the DAG front is held to."""
        return self._run(x)[2].cpu().numpy()

    def dag_votes_agreement(self, x: np.ndarray) -> float:
        """Fraction of samples where the DAG front and the votes oracle
        agree (requires ``decider="dag"``)."""
        if self.decider != "dag":
            raise ValueError("machine was compiled with decider='votes'")
        return float(np.mean(self.predict(x) == self.predict_votes(x)))

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


# ---------------------------------------------------------------------------
# Candidate machine: the assignment-independent per-pair bit tensor
# ---------------------------------------------------------------------------


def _split_candidates(flat: torch.Tensor, n_pairs: int):
    """(..., 2P) lowering-order columns -> (scores, bits) (..., P, 2)."""
    scores = torch.stack([flat[..., :n_pairs], flat[..., n_pairs:]], dim=-1)
    return scores, (scores >= 0.0).to(torch.int32)


class _PairMachine:
    """The candidate bit API shared by the candidate / Monte-Carlo
    machines (``forward`` returns ``(scores, bits)``)."""

    def pair_scores(self, x: np.ndarray) -> np.ndarray:
        """Raw candidate decision scores (pre-comparator)."""
        x = _as_input(x, self.device, self.n_features)
        return self.forward(x)[0].cpu().numpy()

    def pair_bits(self, x: np.ndarray) -> np.ndarray:
        """Candidate comparator bits in one device pass."""
        return self.forward(_as_input(x, self.device, self.n_features)
                            )[1].cpu().numpy()


class CandidateMachine(_PairMachine):
    """BOTH per-pair candidates lowered into one batched pass.

    Pair ``p``'s linear-digital bit and RBF bit do not change when another
    pair's assignment flips, so this machine lowers the two candidates of
    every pair (``2P`` classifiers) into the banks of
    :class:`CompiledMachine` and evaluates them at once:

        ``pair_bits(x) -> (n, P, 2)`` int32
        (``[..., 0]`` linear-digital candidate, ``[..., 1]`` RBF candidate)

    Any assignment's machine output is then a bit-recombination.
    """

    def __init__(self, n_classes: int, linear_banks, kernel_banks,
                 device=None):
        self.device = resolve_device(device)
        self.n_classes = int(n_classes)
        self.n_pairs = len(class_pairs(self.n_classes))
        self._linear_banks = linear_banks
        self._kernel_banks = kernel_banks
        self.n_features = _bank_feature_dim(linear_banks, kernel_banks)
        # Candidate 0 of pair p is lowering column p, candidate 1 is P + p.
        self._inv_perm = _t(_inverse_perm(linear_banks, kernel_banks,
                                          2 * self.n_pairs), self.device,
                            torch.int64)

    def forward(self, x: torch.Tensor):
        """x (n, d) f32 -> (scores (n, P, 2), bits (n, P, 2))."""
        return _split_candidates(
            _all_scores(x, self._linear_banks, self._kernel_banks,
                        self._inv_perm), self.n_pairs)


def _candidate_specs(candidates: Sequence, n_classes: int) -> list:
    """Lowered specs of every pair's two candidates (pair p: linear at
    column p, RBF at column P + p)."""
    p = len(class_pairs(n_classes))
    if len(candidates) != p:
        raise ValueError(
            f"{len(candidates)} candidate pairs for {n_classes} classes "
            f"(expected {p})")
    specs = []
    for i, (lin_clf, rbf_clf) in enumerate(candidates):
        specs.append(_lower_classifier(i, lin_clf))
        specs.append(_lower_classifier(p + i, rbf_clf))
    return specs


def compile_candidates(candidates: Sequence, n_classes: int,
                       device=None) -> CandidateMachine:
    """Lower per-pair ``(linear_clf, rbf_clf)`` candidates in
    ``class_pairs`` order to one :class:`CandidateMachine` on ``device``
    (None: the card)."""
    dev = resolve_device(device)
    specs = _candidate_specs(candidates, n_classes)
    linear_banks, kernel_banks = _build_banks(specs, dev)
    return CandidateMachine(n_classes, linear_banks, kernel_banks, device=dev)


# ---------------------------------------------------------------------------
# Monte-Carlo machine: the candidate bit tensor under process variation
# ---------------------------------------------------------------------------


def _seed_of(key) -> int:
    """An integer seed, or the reference's raw key data ``[hi, lo]`` (so
    ``[0, seed]``, the data of ``PRNGKey(seed)``), as one integer seed."""
    if isinstance(key, (int, np.integer)):
        return int(key)
    kd = np.asarray(key, np.uint32).ravel()
    if kd.size != 2:
        raise ValueError(f"key must be an int seed or 2 words of key data, "
                         f"got {kd.tolist()}")
    return (int(kd[0]) << 32) | int(kd[1])


def _key_data(key) -> np.ndarray:
    """The seed as the reference's key data ``[hi, lo]`` (uint32)."""
    seed = _seed_of(key) & ((1 << 64) - 1)
    return np.asarray([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


@dataclasses.dataclass
class _VariantSpec:
    """Variant tensors of ONE analog candidate (pre-padding).

    ``shift`` / ``gain (V, m, d)`` perturb the per-cell transfers,
    ``coef_pos`` / ``coef_neg (V, m)`` are the per-variant realised alpha
    coefficients, ``offset (V,)`` the comparator offsets.
    """

    pair: int
    shift: torch.Tensor
    gain: torch.Tensor
    coef_pos: torch.Tensor
    coef_neg: torch.Tensor
    offset: torch.Tensor


def _lower_analog_variants(idx: int, clf: AnalogBinaryClassifier,
                           variants: VariantSet, device) -> _VariantSpec:
    """Reduce one analog classifier's mismatch draws to its variant lanes:
    the alpha path is frozen per variant (desired alpha -> control voltage
    -> mismatched realised alpha, ``(dva - shift) / slope`` on the measured
    sweep), as the nominal lowering freezes it."""
    f32 = dict(dtype=torch.float32, device=device)
    v = VariantSet(*(torch.as_tensor(np.asarray(a) if not isinstance(
        a, torch.Tensor) else a, **f32) for a in
        (variants.gauss, variants.alpha, variants.comparator)))
    t = variant_transfer_params(v, clf.hw.params)
    dva = clf.hw.alpha_control_voltage(torch.as_tensor(clf.alpha_hw, **f32))
    a = clf.hw.alpha_realized((dva[None, :] - t.alpha_shift)
                              / t.alpha_slope)                   # (V, m)
    pos = torch.as_tensor(clf.support_y > 0, device=device)
    return _VariantSpec(pair=idx, shift=t.shift, gain=t.gain,
                        coef_pos=a * pos, coef_neg=a * ~pos,
                        offset=t.comp_offset)


@dataclasses.dataclass
class _BankVariants:
    """Per-bank stacked variant tensors (padded to the bank max M).

    Padded SV slots carry gain 0 AND coefficient 0, so they add an exact 0
    to the rails for every variant.
    """

    shift: torch.Tensor     # (V, P, M, d)
    gain: torch.Tensor      # (V, P, M, d)
    coef_pos: torch.Tensor  # (V, P, M)
    coef_neg: torch.Tensor  # (V, P, M)
    offset: torch.Tensor    # (V, P)

    @classmethod
    def build(cls, vspecs: list[_VariantSpec], m_max: int) -> "_BankVariants":
        def pad(a: torch.Tensor) -> torch.Tensor:
            out = a.new_zeros(a.shape[:1] + (m_max,) + a.shape[2:])
            out[:, : a.shape[1]] = a
            return out

        def stack(name):
            return torch.stack([pad(getattr(s, name)) for s in vspecs], 1)

        return cls(shift=stack("shift"), gain=stack("gain"),
                   coef_pos=stack("coef_pos"), coef_neg=stack("coef_neg"),
                   offset=torch.stack([s.offset for s in vspecs], 1))

    @property
    def n_variants(self) -> int:
        return int(self.shift.shape[0])


def _bank_scores_mc(bank: _KernelBank, bv: _BankVariants, xv: torch.Tensor,
                    include_nominal: bool) -> torch.Tensor:
    """(V, n, P) decision scores of one analog bank under variation.

    With ``include_nominal``, variant 0 does not go through the perturbed
    lanes: it IS the nominal ``_bank_scores`` computation, put in front of
    the ``V - 1`` sampled lanes, so its scores equal the nominal ones
    whatever the batched contraction's summation order.
    """
    if bank.kind != "hw":
        raise TypeError(f"variant lanes require the 'hw' measured-curve "
                        f"kind, got {bank.kind!r}")
    lo = 1 if include_nominal else 0
    k = _pair_kernel(bank, xv, bv.shift[lo:], bv.gain[lo:])  # (V', P, n, M)
    coef = torch.stack([bv.coef_pos[lo:], bv.coef_neg[lo:]], dim=-1)
    rails = torch.matmul(k, coef)                             # (V', P, n, 2)
    var = ((rails[..., 0] + bank.bias_pos[:, None])
           - (rails[..., 1] + bank.bias_neg[:, None])
           + bv.offset[lo:][..., None]).transpose(-1, -2)     # (V', n, P)
    if not include_nominal:
        return var
    return torch.cat([_bank_scores(bank, xv)[None], var], dim=0)


def _all_scores_mc(x: torch.Tensor, linear_banks, kernel_banks,
                   bank_variants, inv_perm: torch.Tensor, n_variants: int,
                   include_nominal: bool) -> torch.Tensor:
    """x (n, d) f32 -> scores (V, n, C) in lowering (pair-index) order.

    Variation-free lanes (linear-digital, digital RBF) are evaluated once
    and broadcast over the variant axis.
    """
    xq_cache: dict[int, torch.Tensor] = {}

    def xq(bits: int) -> torch.Tensor:
        if bits not in xq_cache:
            xq_cache[bits] = x if bits == 0 else quant.quantize_unit(x, bits)
        return xq_cache[bits]

    cols = []
    for bank in linear_banks:
        c = xq(bank.input_bits) @ bank.w.T + bank.b[None, :]
        cols.append(c[None].expand((n_variants,) + c.shape))
    for bank, bv in zip(kernel_banks, bank_variants):
        if bv is None:
            c = _bank_scores(bank, xq(bank.input_bits))
            cols.append(c[None].expand((n_variants,) + c.shape))
        else:
            cols.append(_bank_scores_mc(bank, bv, xq(bank.input_bits),
                                        include_nominal))
    return torch.cat(cols, dim=2)[:, :, inv_perm]


class MonteCarloMachine(_PairMachine):
    """BOTH candidates of every pair under ``V`` mismatch instances:

        ``pair_bits(x) -> (V, n, P, 2)`` int32

    (candidate axis as in :class:`CandidateMachine`, variant axis leading).
    Digital lanes are variation-free and broadcast.  With
    ``include_nominal`` variant 0 is the zero-offset instance, computed by
    the nominal bank path, so its slice equals the ``CandidateMachine``'s
    scores and bits exactly.
    """

    def __init__(self, n_classes: int, linear_banks, kernel_banks,
                 bank_variants, n_variants: int, include_nominal: bool,
                 sigma_scale: float, key_data: Optional[np.ndarray] = None,
                 device=None):
        self.device = resolve_device(device)
        self.n_classes = int(n_classes)
        self.n_pairs = len(class_pairs(self.n_classes))
        self.n_variants = int(n_variants)
        self.include_nominal = bool(include_nominal)
        self.sigma_scale = float(sigma_scale)
        self.key_data = None if key_data is None else np.asarray(key_data)
        self._linear_banks = linear_banks
        self._kernel_banks = kernel_banks
        self._bank_variants = bank_variants
        self.n_features = _bank_feature_dim(linear_banks, kernel_banks)
        self._inv_perm = _t(_inverse_perm(linear_banks, kernel_banks,
                                          2 * self.n_pairs), self.device,
                            torch.int64)

    def forward(self, x: torch.Tensor):
        """x (n, d) f32 -> (scores (V, n, P, 2), bits (V, n, P, 2))."""
        return _split_candidates(_all_scores_mc(
            x, self._linear_banks, self._kernel_banks, self._bank_variants,
            self._inv_perm, self.n_variants, self.include_nominal),
            self.n_pairs)


def _variant_banks(specs: list, variant_of: dict, device):
    """Group specs into banks; each analog bank gets its stacked variants
    (``variant_of``: lowering column -> per-pair variant object)."""
    linear_groups, kernel_groups = _group_specs(specs)
    linear_banks = [_LinearBank.build(g, device) for g in linear_groups]
    kernel_banks, per_bank = [], []
    for g in kernel_groups:
        bank = _KernelBank.build(g, device)
        kernel_banks.append(bank)
        in_group = [s.pair in variant_of for s in g]
        if not any(in_group):
            per_bank.append(None)
            continue
        if not all(in_group):  # cannot happen: 'hw' curves group apart
            raise ValueError(
                "bank mixes variant and variant-free lanes; grouping bug")
        per_bank.append([variant_of[s.pair] for s in g])
    return linear_banks, kernel_banks, per_bank


def compile_variants(
    candidates: Sequence,
    n_classes: int,
    key=0,
    n_variants: int = 64,
    include_nominal: bool = True,
    sigma_scale: float = 1.0,
    draws: Optional[Sequence] = None,
    device=None,
) -> MonteCarloMachine:
    """Lower per-pair candidates + sampled process variation to ONE machine.

    ``candidates`` as :func:`compile_candidates`.  ``key`` is an integer
    seed (or the reference's key data ``[0, seed]``): pair ``i``'s analog
    candidate draws its own stream, ``stream_key(seed, i)``.  ``draws``
    gives the mismatch explicitly instead: one ``VariantSet`` per pair
    (``None`` for non-analog candidates), ``n_variants`` rows each, row 0
    the zero instance when ``include_nominal`` — e.g. the reference's own
    draws (the machine then records no key data).  Non-analog RBF
    candidates are variation-free broadcast lanes.
    """
    dev = resolve_device(device)
    specs = _candidate_specs(candidates, n_classes)
    p = len(candidates)
    seed = _seed_of(key)
    vspecs: dict[int, _VariantSpec] = {}
    for i, (_, rbf_clf) in enumerate(candidates):
        if not isinstance(rbf_clf, AnalogBinaryClassifier):
            continue
        if draws is not None:
            variants = draws[i]
            if int(np.shape(variants.gauss)[0]) != n_variants:
                raise ValueError(f"pair {i}: draws hold "
                                 f"{np.shape(variants.gauss)[0]} variants, "
                                 f"expected {n_variants}")
        else:
            variants = rbf_clf.sample_variants(
                stream_key(seed, i), n_variants,
                include_nominal=include_nominal, sigma_scale=sigma_scale,
                device=dev)
        vspecs[p + i] = _lower_analog_variants(p + i, rbf_clf, variants, dev)
    linear_banks, kernel_banks, per_bank = _variant_banks(specs, vspecs, dev)
    bank_variants = [
        None if vs is None else _BankVariants.build(
            vs, int(bank.sv.shape[1]))
        for bank, vs in zip(kernel_banks, per_bank)]
    return MonteCarloMachine(
        n_classes, linear_banks, kernel_banks, bank_variants,
        n_variants=n_variants, include_nominal=include_nominal,
        sigma_scale=sigma_scale,
        key_data=None if draws is not None else _key_data(key), device=dev)


# ---------------------------------------------------------------------------
# Streaming Monte-Carlo machine: flat-memory variant chunks
# ---------------------------------------------------------------------------

#: Default variant chunk of the streaming engine: larger chunks amortize
#: launch overhead, smaller ones shrink the peak temporaries.
MC_STREAM_CHUNK = 256

#: Assignment-axis chunk of the streamed recombination (bounds the
#: ``(B, n, CHUNK)`` codes tensor).
_RECOMBINE_CHUNK = 512

STREAM_METHODS = ("iid", "sobol", "stratified", "is")


@dataclasses.dataclass
class _StreamBankConst:
    """Per-analog-bank constants for drawing + lowering a variant chunk on
    the bank's padded ``(Pb, M)`` slot grid: the pairs' draw keys, the
    frozen alpha control voltages, rail / validity masks (padded slots have
    both rail masks 0, so their coefficients are exact zeros) and the
    pairs' measured alpha sweeps.  ``u_offset`` / ``u_width`` locate the
    bank in the flat QMC block (padded dims); ``true_dim`` is its unpadded
    mismatch dimension (the D of the importance-sampling log-weights).
    """

    pair_keys: torch.Tensor   # (Pb,) int64 draw keys
    dva: torch.Tensor         # (Pb, M) alpha control voltages, 0 on pads
    pos_mask: torch.Tensor    # (Pb, M) f32: valid slot on the + rail
    neg_mask: torch.Tensor    # (Pb, M) f32: valid slot on the - rail
    slot_valid: torch.Tensor  # (Pb, M) f32: any valid slot
    alpha_grid: torch.Tensor  # (Pb, Ga) ascending measured alpha abscissa
    alpha_curve: torch.Tensor  # (Pb, Ga) measured alpha multiplier
    alpha_left: list          # (Pb,) clamp below the sweep
    alpha_right: list         # (Pb,) clamp above the sweep
    params: object = None     # shared CircuitParams
    u_offset: int = 0
    u_width: int = 0
    true_dim: int = 0


def _recombine_acc(bits4, assignments, y, table, weights,
                   s_chunk: int = _RECOMBINE_CHUNK) -> torch.Tensor:
    """Streamed recombination: ``bits4 (B, n, P, 2) -> acc (B, S)`` f32
    through the packed encoder table, the assignment axis in chunks of
    ``s_chunk`` (codes tensor bounded at ``(B, n, s_chunk)``)."""
    return torch.cat([dse._encoder_accuracy(bits4, assignments[lo:
                                                               lo + s_chunk],
                                            y, table, weights)
                      for lo in range(0, assignments.shape[0], s_chunk)],
                     dim=1)


class StreamingMCMachine:
    """Tail-yield Monte-Carlo at sign-off scale: never more than ONE chunk
    of ``mc_chunk`` variants on the device.

    1. **Generate**: variant ``v``'s mismatch comes from the counter-based
       draws of ``(pair key, v)`` (``method='iid'`` / ``'is'``) or from row
       ``v`` of a scrambled-Sobol / Latin-hypercube point set (``'sobol'``
       / ``'stratified'``, host scipy, inverse-CDF on the device): a pure
       function of the global index, never of the chunking.
    2. **Score**: the chunk's banks run through ``_all_scores_mc`` (digital
       lanes broadcast), then the packed-encoder recombination (or, past
       ``MAX_TABLE_BITS``, the pair-chunked votes) scores every assignment.
    3. **Fold**: the ``(B, S)`` chunk accuracies collapse into the
       :class:`~repro_torch.core.mcstream.StreamStats` accumulators.

    The step's shapes depend on ``mc_chunk`` and the assignment matrix,
    never on V, so peak memory is flat from V = 64 to V = 10^6.  With
    ``method='is'`` draws are widened by ``is_scale`` and carry
    self-normalized importance weights.  ``stream(mesh=...)`` splits each
    chunk over a ``launch.mesh.make_variant_mesh`` mesh: every device draws
    and scores its slice (the draws are functions of the global variant
    index, wherever it lands), and the slices' aggregates merge on the
    mesh's first device, which holds the state.
    """

    def __init__(self, n_classes: int, linear_banks, kernel_banks,
                 stream_consts, method: str, mc_chunk: int,
                 sigma_scale: float, is_scale: float,
                 key_data: Optional[np.ndarray] = None, device=None):
        self.device = resolve_device(device)
        self.n_classes = int(n_classes)
        self.n_pairs = len(class_pairs(self.n_classes))
        if method not in STREAM_METHODS:
            raise ValueError(
                f"unknown sampling method {method!r}; one of "
                f"{STREAM_METHODS}")
        if mc_chunk < 1:
            raise ValueError(f"mc_chunk must be >= 1, got {mc_chunk}")
        self.method = method
        self.mc_chunk = int(mc_chunk)
        self.sigma_scale = float(sigma_scale)
        self.is_scale = float(is_scale)
        self.key_data = None if key_data is None else np.asarray(key_data)
        self._linear_banks = linear_banks
        self._kernel_banks = kernel_banks
        self._stream_consts = stream_consts   # aligned with kernel_banks
        self.n_features = _bank_feature_dim(linear_banks, kernel_banks)
        self._inv_perm = _t(_inverse_perm(linear_banks, kernel_banks,
                                          2 * self.n_pairs), self.device,
                            torch.int64)
        if self.n_pairs <= MAX_TABLE_BITS:
            self._table, self._weights = dse._encoder_consts(
                self.n_classes, self.n_pairs, self.device)
        else:
            self._vote_a, self._vote_b = dse._vote_matrices(
                self.n_classes, self.device)
            self._table = None
        #: Flat mismatch dims over the padded slot grids (the QMC block
        #: width) and over the true circuits (the IS log-weight D).
        self.mismatch_dim = sum(
            c.u_width for c in stream_consts if c is not None)
        self.true_dim = sum(
            c.true_dim for c in stream_consts if c is not None)
        self._sampler = None
        if method in ("sobol", "stratified"):
            self._sampler = mcstream.QMCSampler(
                method, self.mismatch_dim, self.key_data)
        self._replicas: dict = {}

    # -- chunk generation -----------------------------------------------------

    def _bank_chunk(self, bc: _StreamBankConst, bank: _KernelBank,
                    v_idx: torch.Tensor, u: torch.Tensor):
        """Lower ONE analog bank's variant chunk: draws -> _BankVariants,
        plus the masked squared norm of the unscaled standard-normal draws
        ``(B,)`` (what importance-sampling log-weights integrate)."""
        m_max = int(bc.dva.shape[1])
        d = int(bank.sv.shape[2])
        n_pb = int(bc.pair_keys.shape[0])
        if self.method in ("iid", "is"):
            z = counter_normals(bc.pair_keys, v_idx, variant_dim(m_max, d))
        else:
            ub = u[:, bc.u_offset: bc.u_offset + bc.u_width]
            z = mcstream.uniform_to_normal(ub).reshape(
                v_idx.shape[0], n_pb, variant_dim(m_max, d))
        raw = variant_set_from_flat(z, m_max, d, 1.0)
        gz, az, cz = raw.gauss, raw.alpha, raw.comparator
        sumsq = (
            torch.sum(gz * gz * bc.slot_valid[None, :, :, None, None],
                      dim=(1, 2, 3, 4))
            + torch.sum(az * az * bc.slot_valid[None, :, :, None],
                        dim=(1, 2, 3))
            + torch.sum(cz * cz, dim=1))
        s = float(np.float32(self.sigma_scale * (
            self.is_scale if self.method == "is" else 1.0)))
        t = variant_transfer_params(
            VariantSet(gauss=s * gz, alpha=s * az, comparator=s * cz),
            bc.params)                                   # leading (B, Pb)
        # Realised alpha: the frozen-alpha arithmetic of
        # `_lower_analog_variants`, per pair against its measured sweep.
        query = (bc.dva[None] - t.alpha_shift) / t.alpha_slope  # (B, Pb, M)
        a = torch.stack([
            kern.interp(query[:, j], bc.alpha_grid[j], bc.alpha_curve[j],
                        left=bc.alpha_left[j], right=bc.alpha_right[j])
            for j in range(n_pb)], dim=1)                # (B, Pb, M)
        chunk = _BankVariants(
            shift=t.shift, gain=t.gain,
            coef_pos=a * bc.pos_mask[None], coef_neg=a * bc.neg_mask[None],
            offset=t.comp_offset)
        return chunk, sumsq

    def _chunk_banks(self, v_idx: torch.Tensor, u: torch.Tensor):
        """All banks' variant chunks + the chunk's sampling weights (B,)
        and their log-scale."""
        bank_variants = []
        sumsq = torch.zeros(v_idx.shape[0], dtype=torch.float32,
                            device=self.device)
        for bank, bc in zip(self._kernel_banks, self._stream_consts):
            if bc is None:
                bank_variants.append(None)
                continue
            chunk, ss = self._bank_chunk(bc, bank, v_idx, u)
            bank_variants.append(chunk)
            sumsq = sumsq + ss
        if self.method == "is":
            s = self.is_scale
            # Log-weight centered at its mean under the proposal (E[sumsq]
            # = D), materialized relative to the chunk max so every weight
            # sits in (0, 1]; the accumulators carry the scale (log_ref).
            logw = (float(np.float32((s * s - 1.0) / 2.0))
                    * (float(np.float32(self.true_dim)) - sumsq))
            log_ref = torch.max(logw)
            w = torch.exp(logw - log_ref)
        else:
            w = torch.ones(v_idx.shape[0], dtype=torch.float32,
                           device=self.device)
            log_ref = torch.zeros((), dtype=torch.float32, device=self.device)
        return bank_variants, w, log_ref

    def _chunk_bits(self, x, v_idx, u):
        """One chunk's bits ``(B, n, P, 2)``, weights and their log-scale."""
        bank_variants, w, log_ref = self._chunk_banks(v_idx, u)
        flat = _all_scores_mc(x, self._linear_banks, self._kernel_banks,
                              bank_variants, self._inv_perm,
                              int(v_idx.shape[0]), False)   # (B, n, 2P)
        return _split_candidates(flat, self.n_pairs)[1], w, log_ref

    def _chunk_acc(self, x, v_idx, assignments, y, u):
        """One chunk end to end: draws -> scores -> bits -> acc (B, S)."""
        bits, w, log_ref = self._chunk_bits(x, v_idx, u)
        if self._table is not None:
            acc = _recombine_acc(bits, assignments, y, self._table,
                                 self._weights)
        else:
            acc = dse._votes_accuracy_paired(bits, assignments, y,
                                             self._vote_a, self._vote_b)
        return acc, w, log_ref

    # -- the host loop ----------------------------------------------------------

    def _uniforms(self, start: int, b: int) -> torch.Tensor:
        if self._sampler is None:
            return torch.zeros((b, 0), dtype=torch.float32,
                               device=self.device)
        return torch.as_tensor(self._sampler.chunk(start, b),
                               device=self.device)

    def _prep(self, x, y, assignments):
        x = _as_input(x, self.device, self.n_features)
        y = torch.as_tensor(np.asarray(y).astype(np.int64),
                            device=self.device)
        a = np.atleast_2d(np.asarray(assignments)).astype(np.int32)
        if a.shape[1] != self.n_pairs:
            raise ValueError(
                f"assignments have {a.shape[1]} pairs, machine has "
                f"{self.n_pairs}")
        return x, y, torch.as_tensor(a, device=self.device)

    def _chunk_size(self, mesh=None) -> int:
        """Variants per chunk: ``mc_chunk``, rounded up to whole
        per-device slices under a mesh (the validity mask keeps the padded
        tail inert)."""
        b = self.mc_chunk
        if mesh is not None:
            nd = require_axis(mesh, VARIANTS_AXIS, "make_variant_mesh")
            b = -(-b // nd) * nd
        return b

    def _replica(self, device) -> "StreamingMCMachine":
        """This machine with its banks and draw constants on ``device``
        (itself where they are already), cached per device."""
        dev = device_key(device)
        if dev == device_key(self.device):
            return self
        if dev not in self._replicas:
            self._replicas[dev] = StreamingMCMachine(
                self.n_classes,
                [_to_device(b, dev) for b in self._linear_banks],
                [_to_device(b, dev) for b in self._kernel_banks],
                [None if c is None else _to_device(c, dev)
                 for c in self._stream_consts],
                method=self.method, mc_chunk=self.mc_chunk,
                sigma_scale=self.sigma_scale, is_scale=self.is_scale,
                key_data=self.key_data, device=dev)
        return self._replicas[dev]

    def _stream_sharded(self, x, y, assignments, n_variants: int,
                        floor: float, mesh):
        """The chunk loop over a variants mesh (one device: the unsharded
        stream): device ``i`` scores global variants ``[start + i*per,
        start + (i+1)*per)`` of each chunk on its replica; the slices'
        aggregates (centered on the one running mean) merge on the first
        device, as the reference's psum / pmin / pmax merge them."""
        b = self._chunk_size(mesh)
        per = b // mesh.size
        shards = [self._replica(dev) for dev in mesh.devices]
        inputs = [m._prep(x, y, assignments) for m in shards]
        home = shards[0].device
        n_s, n_val = int(inputs[0][2].shape[0]), int(inputs[0][0].shape[0])
        state = mcstream.init_stream(n_s, mcstream.hist_bins(n_val), home)
        n_bins = state.hist.shape[1]
        for start in range(0, n_variants, b):
            u = None if self._sampler is None else \
                self._sampler.chunk(start, b)
            aggs = []
            for i, (m, (xd, yd, ad)) in enumerate(zip(shards, inputs)):
                dev, lo = m.device, start + i * per
                with _device_context(dev):
                    v_idx = torch.arange(lo, lo + per, device=dev)
                    valid = (v_idx < n_variants).to(torch.float32)
                    ud = torch.zeros((per, 0), dtype=torch.float32,
                                     device=dev) if u is None else \
                        torch.as_tensor(u[i * per:(i + 1) * per], device=dev)
                    acc, w, log_ref = m._chunk_acc(xd, v_idx, ad, yd, ud)
                    agg = mcstream.chunk_aggregates(
                        state.mean.to(dev), acc, w, valid, floor, n_bins,
                        log_ref=log_ref)
                aggs.append(_to_device(agg, home))
            state = mcstream.merge_stream(state,
                                          mcstream.merge_aggregates(aggs))
        return state

    def stream(self, x, y, assignments, n_variants: int,
               accuracy_floor: float, mesh=None,
               confidence: float = mcstream.DEFAULT_CONFIDENCE,
               ci: str = "wilson") -> dict:
        """Stream ``n_variants`` mismatch instances chunk by chunk and
        return ``mcstream.finalize``'s statistics dict (per-assignment mean
        / std / worst / yield + binomial bounds, and the raw histogram
        sketch under ``"hist"``).

        ``mesh``: a ``make_variant_mesh`` mesh splits each chunk's variants
        across its devices (the chunk rounds up to whole per-device slices;
        the validity mask keeps the padded tail inert).  Without one the
        machine's own device streams every chunk alone.
        """
        if n_variants < 1:
            raise ValueError(f"n_variants must be >= 1, got {n_variants}")
        if mesh is None:
            mesh = make_variant_mesh(devices=[self.device])
        state = self._stream_sharded(x, y, assignments, n_variants,
                                     float(accuracy_floor), mesh)
        out = mcstream.finalize(state, confidence, ci)
        out["hist"] = state.hist.cpu().numpy().astype(np.float64)
        out["n_variants"] = int(n_variants)
        out["method"] = self.method
        out["accuracy_floor"] = float(accuracy_floor)
        return out

    def _indexed(self, v_idx):
        v_idx = np.asarray(v_idx, np.int64)
        if self._sampler is not None and not np.array_equal(
                v_idx, np.arange(v_idx[0], v_idx[0] + len(v_idx))):
            raise ValueError(
                "QMC methods need a contiguous v_idx range (the "
                "low-discrepancy stream is indexed, not keyed)")
        u = self._uniforms(int(v_idx[0]), len(v_idx))
        return torch.as_tensor(v_idx, device=self.device), u

    def pair_bits_dense(self, x, v_idx) -> np.ndarray:
        """Dense oracle: the bit tensor ``(B, n, P, 2)`` of the global
        variant indices ``v_idx``, the bits the streamed chunks fold away."""
        v, u = self._indexed(v_idx)
        x = _as_input(x, self.device, self.n_features)
        return self._chunk_bits(x, v, u)[0].cpu().numpy()

    def chunk_weights(self, v_idx) -> np.ndarray:
        """Absolute (mean-centered) sampling weights of the given global
        variants (1 unless ``method='is'``), the chunk's log-scale folded
        back in on the host in f64."""
        v, u = self._indexed(v_idx)
        _, w, log_ref = self._chunk_banks(v, u)
        return w.cpu().numpy().astype(np.float64) * np.exp(float(log_ref))


def compile_mc_stream(
    candidates: Sequence,
    n_classes: int,
    key=0,
    method: str = "iid",
    mc_chunk: int = MC_STREAM_CHUNK,
    sigma_scale: float = 1.0,
    is_scale: float = 2.0,
    device=None,
) -> StreamingMCMachine:
    """Lower per-pair candidates to a flat-memory streaming MC machine.

    ``candidates`` / ``n_classes`` / ``key`` as :func:`compile_variants`;
    variant ``v`` of pair ``i`` draws from ``(stream_key(seed, i), v)``, so
    the stream is chunk-size invariant and restartable.  ``method``:
    ``'iid'`` normal draws, ``'sobol'`` scrambled Sobol' / ``'stratified'``
    Latin hypercube over the reduced mismatch space (seeded from the key
    data as the reference seeds them), or ``'is'`` importance sampling with
    draws widened by ``is_scale``.  Streaming samples without the nominal
    row.
    """
    dev = resolve_device(device)
    specs = _candidate_specs(candidates, n_classes)
    p = len(candidates)
    seed = _seed_of(key)
    analog = {p + i: (i, rbf) for i, (_, rbf) in enumerate(candidates)
              if isinstance(rbf, AnalogBinaryClassifier)}
    linear_banks, kernel_banks, per_bank = _variant_banks(specs, analog, dev)
    stream_consts, u_offset = [], 0
    for bank, members in zip(kernel_banks, per_bank):
        if members is None:
            stream_consts.append(None)
            continue
        bc = _stream_bank_const(members, seed, int(bank.sv.shape[1]),
                                int(bank.sv.shape[2]), u_offset, dev)
        u_offset += bc.u_width
        stream_consts.append(bc)
    return StreamingMCMachine(
        n_classes, linear_banks, kernel_banks, stream_consts,
        method=method, mc_chunk=mc_chunk, sigma_scale=sigma_scale,
        is_scale=is_scale, key_data=_key_data(key), device=dev)


def _stream_bank_const(members, seed: int, m_max: int, d: int,
                       u_offset: int, device) -> _StreamBankConst:
    """One bank's generation constants from its ``(pair row, classifier)``
    members."""
    n_pairs_bank = len(members)
    dva = np.zeros((n_pairs_bank, m_max), np.float32)
    pos = np.zeros((n_pairs_bank, m_max), np.float32)
    neg = np.zeros((n_pairs_bank, m_max), np.float32)
    valid = np.zeros((n_pairs_bank, m_max), np.float32)
    grids, curves, keys = [], [], []
    params = None
    true_dim = 0
    for j, (row, clf) in enumerate(members):
        if params is None:
            params = clf.hw.params
        elif clf.hw.params != params:
            raise ValueError(
                "analog candidates in one bank carry different "
                "CircuitParams; the streaming generator assumes one "
                "process corner per bank")
        m = clf.n_support
        dva[j, :m] = clf.hw.alpha_control_voltage(torch.as_tensor(
            clf.alpha_hw, dtype=torch.float32)).numpy()
        pos[j, :m] = (clf.support_y > 0).astype(np.float32)
        neg[j, :m] = (clf.support_y <= 0).astype(np.float32)
        valid[j, :m] = 1.0
        order = np.argsort(clf.hw.dva_grid, kind="stable")
        grids.append(np.asarray(clf.hw.dva_grid, np.float32)[order])
        curves.append(np.asarray(clf.hw.alpha_curve, np.float32)[order])
        keys.append(stream_key(seed, row))
        true_dim += variant_dim(m, clf.n_features)
    if len({g.shape[0] for g in grids}) != 1:
        raise ValueError("analog alpha sweeps in one bank differ in length")
    return _StreamBankConst(
        pair_keys=torch.as_tensor(keys, dtype=torch.int64, device=device),
        dva=_t(dva, device), pos_mask=_t(pos, device),
        neg_mask=_t(neg, device), slot_valid=_t(valid, device),
        alpha_grid=_t(np.stack(grids), device),
        alpha_curve=_t(np.stack(curves), device),
        alpha_left=[float(c[0]) for c in curves],
        alpha_right=[float(c[-1]) for c in curves],
        params=params, u_offset=u_offset,
        u_width=n_pairs_bank * variant_dim(m_max, d), true_dim=true_dim)
