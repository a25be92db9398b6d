"""Separation-driven mixed-kernel exploration — Algorithm 1 of the paper.

The port of ``repro.core.selection``.  For every OvO pair: extract the
binary subset, train a linear and an RBF SVM (each with its own CV'd
(C, gamma)), and keep RBF only if it is strictly more accurate (line 8).
The selected float classifiers are then deployed to hardware (linear ->
``DigitalLinearClassifier``, rbf -> ``AnalogBinaryClassifier``) and wrapped
in a ``MulticlassSVM`` with the encoder decision logic.

  * ``train_pairs``  — the Algorithm-1 training entry point (the batched
                       engine of ``repro_torch.core.trainer``),
  * ``build_banks``  — every Table-II design point as an object bank.

``PairResult``, ``binary_subset``, ``default_hw`` and ``hw_gamma_grid``
live in ``repro_torch.core.trainer`` and are re-exported here.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import trainer as trainer_mod
from repro_torch.core.analog import AnalogBinaryClassifier, AnalogRBFModel
from repro_torch.core.ovo import (
    DigitalLinearClassifier,
    DigitalRBFClassifier,
    FloatBitClassifier,
    MulticlassSVM,
)
from repro_torch.core.trainer import (  # noqa: F401  (re-exported)
    PairResult,
    binary_subset,
    default_hw,
    hw_gamma_grid,
)

#: Design points produced by ``build_banks``: mixed float/circuit plus the
#: all-linear and all-RBF baselines of Table II (both float and deployed).
BANK_TARGETS = ("float", "circuit", "linear", "rbf", "linear_float",
                "rbf_float")


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
    """Run Algorithm 1: one PairResult per OvO pair (batched engine).

    ``tie_margin`` realizes line 8's "RBF only when strictly better" under
    finite-sample CV accuracy.  RBF-assigned pairs are co-optimized for the
    hardware: trained with the calibrated measured-curve kernel on a
    realizable gamma grid, so the deployed analog classifier computes with
    the kernel it was trained with.
    """
    return trainer_mod.train_pairs(
        x_train, y_train, n_classes, hw=hw, n_epochs=n_epochs, seed=seed,
        tie_margin=tie_margin, cv_epochs=cv_epochs, n_folds=n_folds,
        hw_all=hw_all, device=device)


def build_banks(
    pairs: list[PairResult],
    n_classes: int,
    hw: Optional[AnalogRBFModel] = None,
    weight_bits: int = 8,
    input_bits: int = 4,
    seed: int = 0,
    alpha_floor_rel: float = 1.0 / 256.0,
) -> dict[str, MulticlassSVM]:
    """Deploy every design point of Table II as an object bank.

      float        mixed, software float models (Algorithm-1 selection)
      circuit      mixed, deployed: digital linear + ANALOG rbf
      linear       all-linear, deployed digital
      rbf          all-RBF, deployed DIGITAL (the costly baseline)
      linear_float / rbf_float   float counterparts of the baselines
    """
    if hw is None:
        hw = default_hw(seed)
    kmap = [p.kernel for p in pairs]

    def multi(classifiers, kernel_map):
        return MulticlassSVM(n_classes=n_classes, classifiers=classifiers,
                             kernel_map=kernel_map)

    def deploy_linear(m):
        return DigitalLinearClassifier.deploy(m, weight_bits, input_bits)

    def deploy_analog_rbf(m):
        return AnalogBinaryClassifier.deploy(m, hw,
                                             alpha_floor_rel=alpha_floor_rel)

    return {
        "float": multi([FloatBitClassifier(p.model) for p in pairs], kmap),
        "linear_float": multi(
            [FloatBitClassifier(p.model_linear) for p in pairs],
            ["linear"] * len(pairs)),
        "rbf_float": multi(
            [FloatBitClassifier(p.model_rbf) for p in pairs],
            ["rbf"] * len(pairs)),
        "circuit": multi(
            [deploy_analog_rbf(p.model) if p.kernel == "rbf"
             else deploy_linear(p.model) for p in pairs],
            kmap),
        "linear": multi([deploy_linear(p.model_linear) for p in pairs],
                        ["linear"] * len(pairs)),
        "rbf": multi([DigitalRBFClassifier.deploy(p.model_rbf,
                                                  input_bits=input_bits)
                      for p in pairs],
                     ["rbf"] * len(pairs)),
    }
