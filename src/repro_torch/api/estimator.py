"""MixedKernelSVM: the sklearn-style estimator wrapping Algorithm 1.

The port of ``repro.api.estimator`` (this slice: fit, deploy without
budgets, predict, score, save, load):

    est = MixedKernelSVM(n_epochs=120).fit(x_train, y_train)   # on the card
    est.score(x_test, y_test)                    # float (software) accuracy
    machine = est.deploy("circuit")              # CompiledMachine
    machine.predict(x)                           # batched labels
    est.save("models/balance")                   # npz + json, no retraining
    est2 = MixedKernelSVM.load("models/balance")

``fit`` runs Algorithm 1 (``selection.train_pairs``) with
hardware-in-the-loop co-optimization of the analog-bound classifiers, then
assembles every Table-II design point (``selection.build_banks``).
``bank(target)`` returns the object bank the cost model walks;
``deploy(target)`` lowers it to a ``CompiledMachine`` (cached per target).

Targets: ``'float'``, ``'circuit'``, ``'linear'``, ``'rbf'``,
``'linear_float'``, ``'rbf_float'``.  Saves are the reference's format
(version 3): each reads the other's.  The design-space front, budgeted and
yield deploys and Monte-Carlo wait for later slices.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np

from repro_torch.api.compiled import CompiledMachine, _strip_ext, compile_machine
from repro_torch.core import selection
from repro_torch.core.analog import AnalogRBFModel, CircuitParams
from repro_torch.core.ovo import MulticlassSVM
from repro_torch.core.svm import SVMModel
from repro_torch.device import resolve_device

_FORMAT_VERSION = 3
_FORMAT = "repro.api.MixedKernelSVM"

_MODEL_SLOTS = ("model_linear", "model_rbf", "model_hw")
_MODEL_ARRAYS = ("support_x", "support_y", "alpha", "w")


class MixedKernelSVM:
    """Mixed-kernel mixed-signal OvO SVM (paper Algorithm 1 + deployment).

    ``hw`` may be a pre-calibrated :class:`AnalogRBFModel`; by default one is
    calibrated from the circuit surrogate with ``seed`` (deterministic, and
    therefore serializable).  ``hw_offsets = (gauss (4,), alpha (2,))``
    gives that default core's mismatch draws explicitly (see
    ``trainer.default_hw``).  ``device`` (None: the card) runs training and
    the deployed machines.
    """

    def __init__(
        self,
        weight_bits: int = 8,
        input_bits: int = 4,
        n_epochs: int = 200,
        seed: int = 0,
        tie_margin: float = 0.005,
        alpha_floor_rel: float = 1.0 / 256.0,
        cv_epochs: Optional[int] = None,
        hw: Optional[AnalogRBFModel] = None,
        hw_all: bool = True,
        circuit: Optional[CircuitParams] = None,
        hw_offsets=None,
        device=None,
    ):
        self.weight_bits = weight_bits
        self.input_bits = input_bits
        self.n_epochs = n_epochs
        self.seed = seed
        self.tie_margin = tie_margin
        self.alpha_floor_rel = alpha_floor_rel
        # Epochs used when training CV folds; None = max(60, n_epochs // 2).
        self.cv_epochs = cv_epochs
        # Keep the hardware co-optimized candidate for EVERY pair.
        self.hw_all = hw_all
        # Circuit-parameter overrides for the analog behavioral model.
        self.circuit = circuit
        self.hw_offsets = hw_offsets
        self.device = resolve_device(device)
        self._custom_hw = hw is not None
        self.hw_ = hw
        self.pairs_: Optional[list[selection.PairResult]] = None
        self.n_classes_: Optional[int] = None
        self._banks: Optional[dict[str, MulticlassSVM]] = None
        self._compiled: dict[str, CompiledMachine] = {}

    def _default_hw(self) -> AnalogRBFModel:
        return selection.default_hw(self.seed, self.circuit, self.hw_offsets)

    # -- fitting --------------------------------------------------------------

    def fit(self, x: np.ndarray, y: np.ndarray) -> "MixedKernelSVM":
        """Run Algorithm 1 and deploy every design point.

        Labels must be contiguous integers 0..K-1 with every class present.
        """
        y = np.asarray(y)
        classes = np.unique(y)
        if classes.size < 2 or not np.array_equal(
                classes, np.arange(classes.size)):
            raise ValueError(
                "labels must be contiguous integers 0..K-1 with K >= 2 and "
                f"every class present; got classes {classes.tolist()}")
        self.n_classes_ = int(classes.size)
        if self.hw_ is None:
            self.hw_ = self._default_hw()
        self.pairs_ = selection.train_pairs(
            np.asarray(x), y, self.n_classes_, hw=self.hw_,
            n_epochs=self.n_epochs, seed=self.seed,
            tie_margin=self.tie_margin, cv_epochs=self.cv_epochs,
            hw_all=self.hw_all, device=self.device)
        self._build()
        return self

    def _build(self) -> None:
        """(Re)assemble the object banks from trained pairs."""
        self._banks = selection.build_banks(
            self.pairs_, self.n_classes_, hw=self.hw_,
            weight_bits=self.weight_bits, input_bits=self.input_bits,
            seed=self.seed, alpha_floor_rel=self.alpha_floor_rel)
        self._compiled = {}

    def _check_fitted(self) -> None:
        if self._banks is None:
            raise RuntimeError("MixedKernelSVM is not fitted; call fit(x, y)")

    # -- introspection ---------------------------------------------------------

    @property
    def kernel_map_(self) -> list[str]:
        self._check_fitted()
        return [p.kernel for p in self.pairs_]

    @property
    def n_rbf_(self) -> int:
        return sum(k == "rbf" for k in self.kernel_map_)

    @property
    def targets(self) -> tuple[str, ...]:
        return selection.BANK_TARGETS

    # -- deployment ------------------------------------------------------------

    def bank(self, target: str = "float") -> MulticlassSVM:
        """The per-classifier object bank for ``target`` (walked by the
        hardware cost model)."""
        self._check_fitted()
        if target not in self._banks:
            raise KeyError(
                f"unknown target {target!r}; one of {selection.BANK_TARGETS}")
        return self._banks[target]

    def deploy(self, target: str = "float") -> CompiledMachine:
        """Lower ``target``'s bank to one batched inference path on the
        estimator's device (cached per target)."""
        if target not in self._compiled:
            self._compiled[target] = compile_machine(self.bank(target),
                                                     device=self.device)
        return self._compiled[target]

    # -- prediction ------------------------------------------------------------

    def predict(self, x: np.ndarray, target: str = "float") -> np.ndarray:
        return self.deploy(target).predict(x)

    def predict_bits(self, x: np.ndarray, target: str = "float") -> np.ndarray:
        return self.deploy(target).predict_bits(x)

    def score(self, x: np.ndarray, y: np.ndarray,
              target: str = "float") -> float:
        return float(np.mean(self.predict(x, target) == np.asarray(y)))

    # -- serialization (npz arrays + json structure) ----------------------------

    def save(self, path: str) -> None:
        """Write ``<path>.npz`` + ``<path>.json``; round-trips without
        retraining (deployments are rebuilt deterministically on load)."""
        self._check_fitted()
        if self._custom_hw:
            raise ValueError(
                "cannot serialize an estimator built around a user-supplied "
                "AnalogRBFModel; use the default hw (calibrated from `seed`)")
        path = _strip_ext(path)
        arrays: dict[str, np.ndarray] = {}
        meta_pairs = []
        for i, p in enumerate(self.pairs_):
            entry = {"pair": list(p.pair), "kernel": p.kernel,
                     "acc_linear": p.acc_linear, "acc_rbf": p.acc_rbf,
                     "models": {}}
            for slot in _MODEL_SLOTS:
                m: Optional[SVMModel] = getattr(p, slot)
                if m is None:
                    continue
                entry["models"][slot] = {
                    "kind": m.kind, "bias": m.bias, "gamma": m.gamma,
                    "c": m.c, "has_w": m.w is not None,
                }
                for name in _MODEL_ARRAYS:
                    a = getattr(m, name)
                    if a is not None:
                        arrays[f"p{i}.{slot}.{name}"] = np.asarray(a)
            meta_pairs.append(entry)
        meta = {
            "format": _FORMAT,
            "version": _FORMAT_VERSION,
            "n_classes": self.n_classes_,
            "config": {
                "weight_bits": self.weight_bits,
                "input_bits": self.input_bits,
                "n_epochs": self.n_epochs,
                "seed": self.seed,
                "tie_margin": self.tie_margin,
                "alpha_floor_rel": self.alpha_floor_rel,
                "cv_epochs": self.cv_epochs,
                "hw_all": self.hw_all,
                "circuit": (None if self.circuit is None
                            else dataclasses.asdict(self.circuit)),
            },
            "assignment": None,
            "monte_carlo": None,
            "pairs": meta_pairs,
        }
        np.savez(path + ".npz", **arrays)
        with open(path + ".json", "w") as f:
            json.dump(meta, f, indent=2)

    @classmethod
    def load(cls, path: str, device=None, hw_offsets=None,
             hw: Optional[AnalogRBFModel] = None) -> "MixedKernelSVM":
        """Load a save of either package.

        The hardware model is recalibrated from ``(seed, circuit)``, with
        ``hw_offsets`` as the core's mismatch draws (those of the saving
        package, e.g. the reference's); or ``hw`` gives the calibrated model
        itself (the estimator then counts as built around a custom model).
        """
        path = _strip_ext(path)
        with open(path + ".json") as f:
            meta = json.load(f)
        with np.load(path + ".npz") as npz:
            arrays = {k: npz[k] for k in npz.files}
        return estimator_from_arrays(meta, arrays, device=device,
                                     hw_offsets=hw_offsets, hw=hw)


def estimator_from_arrays(meta: dict, arrays: dict, device=None,
                          hw_offsets=None,
                          hw: Optional[AnalogRBFModel] = None
                          ) -> MixedKernelSVM:
    """An estimator from a save's JSON structure and its npz arrays."""
    if meta.get("format") != _FORMAT:
        raise ValueError("not a MixedKernelSVM save")
    if int(meta.get("version", 0)) > _FORMAT_VERSION:
        raise ValueError(
            f"MixedKernelSVM save version {meta['version']}; this build "
            f"reads up to version {_FORMAT_VERSION}")
    if meta.get("assignment") or meta.get("monte_carlo"):
        raise ValueError("budgeted / Monte-Carlo estimator state is not "
                         "supported by this build")
    config = dict(meta["config"])
    if config.get("circuit"):
        config["circuit"] = CircuitParams(**config["circuit"])
    est = MixedKernelSVM(device=device, hw_offsets=hw_offsets, hw=hw,
                         **config)
    est.n_classes_ = int(meta["n_classes"])
    if est.hw_ is None:
        est.hw_ = est._default_hw()

    def rebuild(i: int, slot: str, m_meta: dict) -> SVMModel:
        def arr(name):
            return arrays.get(f"p{i}.{slot}.{name}")

        kind = m_meta["kind"]
        return SVMModel(
            kind=kind,
            support_x=arr("support_x"), support_y=arr("support_y"),
            alpha=arr("alpha"), bias=float(m_meta["bias"]),
            gamma=float(m_meta["gamma"]), c=float(m_meta["c"]),
            w=arr("w") if m_meta["has_w"] else None,
            # hardware-in-the-loop models carry the calibrated kernel
            kernel_fn=est.hw_.kernel_response if kind == "hw" else None,
        )

    pairs = []
    for i, entry in enumerate(meta["pairs"]):
        models = {slot: rebuild(i, slot, m_meta)
                  for slot, m_meta in entry["models"].items()}
        kernel = entry["kernel"]
        m_hw = models.get("model_hw")
        pairs.append(selection.PairResult(
            pair=tuple(entry["pair"]), kernel=kernel,
            model=m_hw if kernel == "rbf" else models["model_linear"],
            acc_linear=float(entry["acc_linear"]),
            acc_rbf=float(entry["acc_rbf"]),
            model_linear=models["model_linear"],
            model_rbf=models["model_rbf"], model_hw=m_hw,
        ))
    est.pairs_ = pairs
    est._build()
    return est
