"""One-vs-One multiclass SVM with encoder decision logic (paper Sec. II-A, III-C).

The port of ``repro.core.ovo``.  A K-class problem decomposes into
K(K-1)/2 binary classifiers, one per class pair (c_i, c_j), i < j, each
producing one bit (1: c_i wins).  The decision is an encoder: the bit
vector indexes a truth table that realises vote counting with a
lowest-index tiebreak.  ``decide_dag`` is the O(K) DDAG elimination
front's host reference, ``condorcet_mask`` where it must equal the votes.

The deployed digital classifiers are the bespoke fixed-point datapaths
whose bits feed the encoder; analog RBF classifiers
(``repro_torch.core.analog.AnalogBinaryClassifier``) plug in through the
same ``predict_bits`` protocol.  The object path computes on ``device``
(None: the card) and returns host numpy; the batched path is
``repro_torch.api.compiled``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Protocol, Sequence

import numpy as np
import torch

from repro_torch.core import kernels as kern
from repro_torch.core import quant
from repro_torch.core import svm as svm_mod
from repro_torch.core.svm import SVMModel
from repro_torch.device import resolve_device


def class_pairs(n_classes: int) -> list[tuple[int, int]]:
    """All OvO pairs (i, j), i < j — line 1 of Algorithm 1."""
    return list(itertools.combinations(range(n_classes), 2))


# ---------------------------------------------------------------------------
# Decision logic
# ---------------------------------------------------------------------------


def votes_from_bits(bits: np.ndarray, n_classes: int) -> np.ndarray:
    """bits (..., P) -> votes (..., K).  Pure counting semantics."""
    votes = np.zeros(bits.shape[:-1] + (n_classes,), np.int32)
    for p, (i, j) in enumerate(class_pairs(n_classes)):
        votes[..., i] += bits[..., p]
        votes[..., j] += 1 - bits[..., p]
    return votes


def decide_votes(bits: np.ndarray, n_classes: int) -> np.ndarray:
    """Majority vote with lowest-index tiebreak (the encoder's semantics)."""
    return np.argmax(votes_from_bits(bits, n_classes), axis=-1)


def build_encoder_table(n_classes: int) -> np.ndarray:
    """Explicit truth table of the decision encoder: 2^P entries -> class id.

    Entry index packs the pair bits little-endian (pair p is bit p).
    """
    n_bits = len(class_pairs(n_classes))
    table = np.zeros((1 << n_bits,), np.int32)
    for code in range(1 << n_bits):
        bits = np.array([(code >> p) & 1 for p in range(n_bits)], np.int32)
        table[code] = decide_votes(bits, n_classes)
    return table


def decide_encoder(bits: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Run the hardware encoder: pack bits -> index the truth table."""
    weights = (1 << np.arange(bits.shape[-1])).astype(np.int64)
    return table[bits.astype(np.int64) @ weights]


#: Packed-encoder regime bound: past P pair bits the 2^P truth table is
#: unbuildable and decisions go through vote counting instead.
MAX_TABLE_BITS = 12


def pair_index_matrix(n_classes: int) -> np.ndarray:
    """(K, K) int32: ``[i, j] -> p`` with ``class_pairs(K)[p] == (i, j)``
    for i < j (symmetric; the diagonal stays 0)."""
    k = int(n_classes)
    m = np.zeros((k, k), np.int32)
    for p, (i, j) in enumerate(class_pairs(k)):
        m[i, j] = p
        m[j, i] = p
    return m


def decide_dag(bits: np.ndarray, n_classes: int) -> np.ndarray:
    """DDAG elimination decision (Platt et al.): host-side reference.

    Maintains a candidate interval ``[lo, hi]`` (initially the full class
    range) and, for exactly K-1 steps, consults the single pair classifier
    ``(lo, hi)``: bit == 1 means the pair's FIRST class (``lo``) wins, so
    ``hi`` is eliminated (``hi -= 1``); bit == 0 eliminates ``lo``
    (``lo += 1``).  After K-1 steps ``lo == hi`` is the label — only
    O(K) of the P = K(K-1)/2 bits are ever consulted.

    Wherever some class wins ALL K-1 of its pairs (a Condorcet winner) the
    DAG returns exactly ``decide_votes``'s answer: that class is never
    eliminated, and it is the unique vote argmax.  Without a Condorcet
    winner (vote cycles, ties) the two fronts may differ.
    """
    bits = np.asarray(bits)
    k = int(n_classes)
    pm = pair_index_matrix(k)
    lead = bits.shape[:-1]
    lo = np.zeros(lead, np.int64)
    hi = np.full(lead, k - 1, np.int64)
    for _ in range(k - 1):
        b = np.take_along_axis(bits, pm[lo, hi][..., None], axis=-1)[..., 0]
        hi = np.where(b == 1, hi - 1, hi)
        lo = np.where(b == 1, lo, lo + 1)
    return lo


def condorcet_mask(bits: np.ndarray, n_classes: int) -> np.ndarray:
    """Boolean mask of samples whose vote winner is unambiguous (some class
    won all K-1 of its pairs) — exactly where votes == DAG is guaranteed."""
    votes = votes_from_bits(bits, n_classes)
    return votes.max(axis=-1) == n_classes - 1


# ---------------------------------------------------------------------------
# Deployed digital classifiers (bit-producing, quantized datapaths)
# ---------------------------------------------------------------------------


class BitClassifier(Protocol):
    def predict_bits(self, x: np.ndarray, device=None) -> np.ndarray: ...


def _quantized_input(x: np.ndarray, bits: int, device) -> torch.Tensor:
    xt = torch.as_tensor(np.asarray(x), dtype=torch.float32,
                         device=resolve_device(device))
    return quant.quantize_unit(xt, bits)


class FloatBitClassifier:
    """Adapter: float SVMModel -> 1-bit OvO output (c_i wins iff f >= 0)."""

    def __init__(self, model: SVMModel):
        self.model = model

    def predict_bits(self, x: np.ndarray, device=None) -> np.ndarray:
        return (svm_mod.decision_function(self.model, x, device)
                >= 0.0).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class DigitalLinearClassifier:
    """Bespoke fully-parallel linear datapath (paper Fig. 3).

    ``w_q``/``b_q`` are the dequantized fixed-point constants hardwired in
    the multipliers; inputs pass through the ``input_bits`` ADC model.
    """

    w_q: np.ndarray          # (d,)
    b_q: float
    w_fp: quant.FixedPoint   # weight fixed-point format
    input_bits: int = 4

    @classmethod
    def deploy(cls, model: SVMModel, weight_bits: int = 8,
               input_bits: int = 4) -> "DigitalLinearClassifier":
        if model.kind != "linear" or model.w is None:
            raise ValueError("only linear classifiers are deployed digitally")
        wb = np.concatenate([model.w, [model.bias]])
        wq, fp = quant.quantize_tensor(wb, weight_bits)
        return cls(w_q=wq[:-1], b_q=float(wq[-1]), w_fp=fp,
                   input_bits=input_bits)

    def decision(self, x: np.ndarray, device=None) -> np.ndarray:
        xq = _quantized_input(x, self.input_bits, device).cpu().numpy()
        return xq @ self.w_q + self.b_q

    def predict_bits(self, x: np.ndarray, device=None) -> np.ndarray:
        return (self.decision(x, device) >= 0.0).astype(np.int32)

    # -- hooks for the hardware cost model ---------------------------------
    def weight_codes(self) -> np.ndarray:
        return self.w_fp.codes(np.append(self.w_q, self.b_q)).numpy()

    @property
    def n_features(self) -> int:
        return int(self.w_q.shape[0])


@dataclasses.dataclass(frozen=True)
class DigitalRBFClassifier:
    """All-digital RBF baseline (paper Table II 'RBF (digital)').

    Support vectors and dual coefficients quantized to 8 bit, inputs 4 bit;
    distance, exp and MACs exact in fixed point.
    """

    support_x: np.ndarray    # (m, d) quantized
    coef: np.ndarray         # (m,) quantized alpha_j * y_j
    bias: float
    gamma: float
    sv_fp: quant.FixedPoint
    coef_fp: quant.FixedPoint
    input_bits: int = 4

    @classmethod
    def deploy(cls, model: SVMModel, sv_bits: int = 8, coef_bits: int = 8,
               input_bits: int = 4) -> "DigitalRBFClassifier":
        if model.kind != "rbf":
            raise ValueError("expected an RBF model")
        svq, sv_fp = quant.quantize_tensor(model.support_x, sv_bits)
        coef = model.alpha * model.support_y
        coefq, coef_fp = quant.quantize_tensor(
            np.concatenate([coef, [model.bias]]), coef_bits)
        return cls(
            support_x=svq, coef=coefq[:-1], bias=float(coefq[-1]),
            gamma=model.gamma, sv_fp=sv_fp, coef_fp=coef_fp,
            input_bits=input_bits,
        )

    def decision(self, x: np.ndarray, device=None) -> np.ndarray:
        xq = _quantized_input(x, self.input_bits, device)
        f32 = dict(dtype=torch.float32, device=xq.device)
        k = kern.rbf_kernel(xq, torch.as_tensor(self.support_x, **f32),
                            self.gamma)
        return (k @ torch.as_tensor(self.coef, **f32)).cpu().numpy() \
            + self.bias

    def predict_bits(self, x: np.ndarray, device=None) -> np.ndarray:
        return (self.decision(x, device) >= 0.0).astype(np.int32)

    @property
    def n_support(self) -> int:
        return int(self.support_x.shape[0])

    @property
    def n_features(self) -> int:
        return int(self.support_x.shape[1])


# ---------------------------------------------------------------------------
# The full multiclass machine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MulticlassSVM:
    """K-class OvO SVM: a bank of bit classifiers + the decision encoder."""

    n_classes: int
    classifiers: Sequence[BitClassifier]   # one per class_pairs(n_classes)
    kernel_map: Sequence[str]              # 'linear' | 'rbf' per pair

    def __post_init__(self):
        if len(self.classifiers) != len(class_pairs(self.n_classes)):
            raise ValueError(
                f"{len(self.classifiers)} classifiers for "
                f"{self.n_classes} classes")
        self._table = (build_encoder_table(self.n_classes)
                       if len(class_pairs(self.n_classes)) <= MAX_TABLE_BITS
                       else None)

    def predict_bits(self, x: np.ndarray, device=None) -> np.ndarray:
        return np.stack([c.predict_bits(x, device) for c in self.classifiers],
                        axis=-1)

    def predict(self, x: np.ndarray, device=None) -> np.ndarray:
        bits = self.predict_bits(x, device)
        if self._table is None:
            return decide_votes(bits, self.n_classes)
        return decide_encoder(bits, self._table)

    def accuracy(self, x: np.ndarray, y: np.ndarray, device=None) -> float:
        return float(np.mean(self.predict(x, device) == np.asarray(y)))

    @property
    def n_rbf(self) -> int:
        return sum(k == "rbf" for k in self.kernel_map)

    @property
    def n_linear(self) -> int:
        return sum(k == "linear" for k in self.kernel_map)
