"""MixedKernelSVM: the sklearn-style estimator wrapping Algorithm 1.

The port of ``repro.api.estimator``:

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
``deploy(target)`` lowers it to a ``CompiledMachine`` (cached per target;
``decider="dag"`` for the O(K) DDAG decision front).

Targets: ``'float'``, ``'circuit'``, ``'linear'``, ``'rbf'``,
``'linear_float'``, ``'rbf_float'``.

Beyond Algorithm 1's single design point, the estimator fronts the
kernel-assignment design space (``repro_torch.core.dse``) and process
variation:

    front = est.pareto(x_val, y_val)             # accuracy/area/power front
    machine = est.deploy("circuit", area_budget=0.1, power_budget=0.05)
    est.assignment_                              # chosen per-pair kernel map
    mc = est.monte_carlo(x_val, y_val, n_variants=64, key=7)
    front = est.pareto(x_val, y_val, n_variants=64)    # robust sweep
    machine = est.deploy("circuit", yield_floor=0.95)  # cheapest in-spec
    est.monte_carlo(x_val, y_val, n_variants=10**6, method="sobol")

``deploy("circuit")`` with no budget stays the Algorithm-1 machine.  A
Monte-Carlo ``key`` is an integer seed (or the reference's key data
``[0, seed]``); the mismatch draws are the port's own (see
``core.analog.counter_normals``).  Saves are the reference's format
(version 3), ``assignment`` and ``monte_carlo`` state included: each
package reads the other's.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np

from repro_torch.api.compiled import (
    MC_STREAM_CHUNK,
    CompiledMachine,
    MonteCarloMachine,
    StreamingMCMachine,
    _key_data,
    _strip_ext,
    compile_candidates,
    compile_machine,
    compile_mc_stream,
    compile_variants,
)
from repro_torch.core import dse as dse_mod
from repro_torch.core import hwcost, mcstream, selection
from repro_torch.core.analog import (
    AnalogBinaryClassifier,
    AnalogRBFModel,
    CircuitParams,
)
from repro_torch.core.ovo import DigitalLinearClassifier, MulticlassSVM
from repro_torch.core.svm import SVMModel
from repro_torch.device import mesh_device

_FORMAT_VERSION = 3
_FORMAT = "repro.api.MixedKernelSVM"

_MODEL_SLOTS = ("model_linear", "model_rbf", "model_hw")
_MODEL_ARRAYS = ("support_x", "support_y", "alpha", "w")


@dataclasses.dataclass(frozen=True)
class MonteCarloResult:
    """Per-variant accuracy of one deployed assignment.

    ``accuracy[0]`` is the nominal (zero-offset) instance; the other rows
    are sampled fabricated instances.  ``key_data`` is the seed the
    mismatch was drawn from, as key data ``[0, seed]``.
    """

    accuracy: np.ndarray      # (V,) per-variant validation accuracy
    assignment: list          # per-pair kernel map evaluated
    n_variants: int
    sigma_scale: float
    key_data: list

    @property
    def nominal(self) -> float:
        return float(self.accuracy[0])

    @property
    def mean(self) -> float:
        return float(np.mean(self.accuracy))

    @property
    def std(self) -> float:
        return float(np.std(self.accuracy))

    @property
    def worst(self) -> float:
        return float(np.min(self.accuracy))

    def yield_at(self, accuracy_floor: float) -> float:
        """Fraction of instances at or above the accuracy floor."""
        return float(np.mean(self.accuracy >= accuracy_floor))


#: Dense Monte-Carlo above this many variants switches to the flat-memory
#: streaming engine.
STREAM_AUTO_VARIANTS = 4096


@dataclasses.dataclass(frozen=True)
class StreamingMCResult:
    """Streamed tail-yield statistics of one assignment.

    Produced by :meth:`MixedKernelSVM.monte_carlo` when the streaming
    engine runs (``method=`` given, or ``n_variants`` above
    :data:`STREAM_AUTO_VARIANTS`): streamed moments, a ``(yield_lo,
    yield_hi)`` confidence interval and a histogram sketch (exact on the
    validation set's accuracy lattice) for quantiles.
    """

    mean: float
    std: float
    worst: float              # streamed min over sampled variants
    best: float
    yield_: float             # point estimate (IS: self-normalized)
    yield_lo: float           # lower/upper confidence bound at `confidence`
    yield_hi: float
    n_eff: float              # effective sample size (== V unless IS)
    accuracy_floor: float
    confidence: float
    ci: str                   # "wilson" | "clopper-pearson"
    n_variants: int
    method: str               # "iid" | "sobol" | "stratified" | "is"
    sigma_scale: float
    is_scale: float
    assignment: list
    key_data: list
    hist: np.ndarray          # (n_bins,) weighted accuracy histogram

    def quantile(self, q) -> np.ndarray:
        """Accuracy quantile(s) from the streamed histogram sketch."""
        qs = np.atleast_1d(np.asarray(q, np.float64))
        out = mcstream.hist_quantiles(self.hist[None, :], qs)[:, 0]
        return out if np.ndim(q) else out[0]


def _kernel_map(assignment) -> list[str]:
    return [k if isinstance(k, str) else ("rbf" if k else "linear")
            for k in list(assignment)]


class MixedKernelSVM:
    """Mixed-kernel mixed-signal OvO SVM (paper Algorithm 1 + deployment).

    ``hw`` may be a pre-calibrated :class:`AnalogRBFModel`; by default one is
    calibrated from the circuit surrogate with ``seed`` (deterministic, and
    therefore serializable).  ``hw_offsets = (gauss (4,), alpha (2,))``
    gives that default core's mismatch draws explicitly (see
    ``trainer.default_hw``).  ``device`` (None: the card, or the first
    device of ``mesh``) runs training and the deployed machines.  ``mesh``
    (``launch.mesh.make_trainer_mesh``) splits the fit's CV grids over its
    devices; like ``hw`` it is runtime-only and not saved.
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
        mesh=None,
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
        self.mesh = mesh
        self.device = mesh_device(device, mesh)
        self._custom_hw = hw is not None
        self.hw_ = hw
        self.pairs_: Optional[list[selection.PairResult]] = None
        self.n_classes_: Optional[int] = None
        self._banks: Optional[dict[str, MulticlassSVM]] = None
        self._reset_caches()
        # Design-space state: the chosen per-pair kernel map of a budgeted
        # or yield deploy (serialized) and the last sweep (not).
        self.assignment_: Optional[list[str]] = None
        self.pareto_: Optional[dse_mod.SweepResult] = None
        # The MC config of the last variation-aware sweep (serialized).
        self.mc_state_: Optional[dict] = None

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
            hw_all=self.hw_all, device=self.device, mesh=self.mesh)
        self.assignment_ = None
        self.pareto_ = None
        self.mc_state_ = None
        self._build()
        return self

    def _build(self) -> None:
        """(Re)assemble the object banks from trained pairs."""
        self._banks = selection.build_banks(
            self.pairs_, self.n_classes_, hw=self.hw_,
            weight_bits=self.weight_bits, input_bits=self.input_bits,
            seed=self.seed, alpha_floor_rel=self.alpha_floor_rel)
        self._reset_caches()

    def _reset_caches(self) -> None:
        """Drop every machine compiled from the previous fit."""
        self._compiled: dict[str, CompiledMachine] = {}
        self._dse: Optional[dse_mod.DesignSpace] = None
        self._dse_cm: Optional[hwcost.CostModel] = None
        self._candidate_cache = None
        self._candidate_machine = None
        self._mc_machines: dict[tuple, MonteCarloMachine] = {}
        self._stream_machines: dict[tuple, StreamingMCMachine] = {}

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

    def deploy(
        self,
        target: str = "float",
        area_budget: Optional[float] = None,
        power_budget: Optional[float] = None,
        yield_floor: Optional[float] = None,
        yield_confidence: Optional[float] = 0.95,
        decider: str = "votes",
    ) -> CompiledMachine:
        """Lower ``target``'s bank to one batched inference path on the
        estimator's device (cached per target and decider).

        ``decider="dag"`` builds the O(K) DDAG decision front instead of
        the dense votes path — same banks, K-1 pair evaluations per sample
        at predict time.

        With an ``area_budget`` (mm^2) and/or ``power_budget`` (mW) —
        ``'circuit'`` only — the deployment is instead the most accurate
        Pareto point of the kernel-assignment space within budget (after a
        :meth:`pareto` sweep); its kernel map goes to ``assignment_``
        (serialized by ``save``).  ``yield_floor`` (after a Monte-Carlo
        sweep, ``pareto(..., n_variants=...)``) picks the cheapest
        budget-feasible design whose yield meets the floor, gated on the
        Wilson lower bound at ``yield_confidence`` (None: the point
        estimate).  With no budget the Algorithm-1 machine is returned.
        """
        if area_budget is None and power_budget is None \
                and yield_floor is None:
            key = target if decider == "votes" else f"{target}@{decider}"
            if key not in self._compiled:
                self._compiled[key] = compile_machine(
                    self.bank(target), decider=decider, device=self.device)
            return self._compiled[key]
        if target != "circuit":
            raise ValueError(
                "budget-constrained deployment explores the circuit design "
                f"space; got target {target!r}")
        if self.pareto_ is None:
            raise RuntimeError(
                "no Pareto front available: call est.pareto(x_val, y_val) "
                "before deploying against a budget")
        i = self.pareto_.select(area_budget=area_budget,
                                power_budget=power_budget,
                                yield_floor=yield_floor,
                                confidence=yield_confidence)
        self.assignment_ = self.pareto_.kernel_map(i)
        if yield_floor is not None and self.mc_state_ is not None:
            self.mc_state_["yield_floor"] = float(yield_floor)
            self.mc_state_["yield_confidence"] = (
                None if yield_confidence is None else float(yield_confidence))
        return self.deploy_assignment(self.assignment_, decider=decider)

    # -- kernel-assignment design space ------------------------------------------

    def _candidates(self) -> list[tuple]:
        """Per-pair (linear-digital, RBF-analog) deployed candidates — the
        constructions of ``build_banks``, so the Algorithm-1 assignment
        reproduces the ``'circuit'`` bank classifier for classifier.
        Cached per fit."""
        self._check_fitted()
        if self._candidate_cache is None:
            missing = [p.pair for p in self.pairs_ if p.model_hw is None]
            if missing:
                raise RuntimeError(
                    f"pairs {missing} have no hardware co-optimized "
                    "candidate; fit with hw_all=True (the default) to "
                    "explore the assignment space")
            self._candidate_cache = [
                (DigitalLinearClassifier.deploy(
                    p.model_linear, self.weight_bits, self.input_bits),
                 AnalogBinaryClassifier.deploy(
                    p.model_hw, self.hw_,
                    alpha_floor_rel=self.alpha_floor_rel))
                for p in self.pairs_]
        return self._candidate_cache

    def design_space(self, cm: Optional[hwcost.CostModel] = None
                     ) -> dse_mod.DesignSpace:
        """The design space over per-pair kernel assignments on the
        estimator's device; the candidate machine is cached per fit, only
        the (numpy) cost table follows ``cm``."""
        cm = cm or hwcost.CostModel()
        if self._dse is None or self._dse_cm != cm:
            if self._candidate_machine is None:
                self._candidate_machine = compile_candidates(
                    self._candidates(), self.n_classes_, device=self.device)
            table = hwcost.pair_cost_table(self._candidates(), cm,
                                           n_classes=self.n_classes_)
            self._dse = dse_mod.DesignSpace(
                self._candidate_machine, table, self.n_classes_,
                device=self.device)
            self._dse_cm = cm
        return self._dse

    def pareto(
        self,
        x_val: np.ndarray,
        y_val: np.ndarray,
        cm: Optional[hwcost.CostModel] = None,
        n_variants: Optional[int] = None,
        key=None,
        sigma_scale: float = 1.0,
        accuracy_floor: Optional[float] = None,
        **sweep_kwargs,
    ) -> dse_mod.SweepResult:
        """Sweep the kernel-assignment space on validation data and return
        the accuracy / area / power Pareto front (kept in ``pareto_``).

        Exhaustive ``2^P`` for ``P <= 12``; the seeded portfolio beyond,
        seeded with the Algorithm-1 assignment.  Monte-Carlo mode
        (``n_variants=``): every assignment also gets mean / std /
        worst-case accuracy and yield over ``n_variants`` sampled
        instances, and the result carries the robust front.  ``key`` is
        the mismatch seed (default ``self.seed``); ``accuracy_floor``
        defaults to two points below the Algorithm-1 circuit's accuracy on
        the given data.  The MC config goes to ``mc_state_`` (saved).
        """
        space = self.design_space(cm)
        seeds = sweep_kwargs.pop("seeds", dse_mod.assignment_from_kernel_map(
            self.kernel_map_)[None, :])
        mc_machine = None
        if n_variants is not None:
            if key is None:
                key = self.seed
            if accuracy_floor is None:
                accuracy_floor = self.score(x_val, y_val,
                                            target="circuit") - 0.02
            mc_machine = self.monte_carlo_machine(
                n_variants, key, sigma_scale=sigma_scale)
        elif accuracy_floor is not None:
            raise ValueError(
                "accuracy_floor only applies to Monte-Carlo sweeps; pass "
                "n_variants=... as well")
        self.pareto_ = space.sweep(np.asarray(x_val), np.asarray(y_val),
                                   seeds=seeds, mc_machine=mc_machine,
                                   accuracy_floor=accuracy_floor,
                                   **sweep_kwargs)
        if mc_machine is not None:
            self.mc_state_ = {
                "key_data": np.asarray(mc_machine.key_data).tolist(),
                "n_variants": int(n_variants),
                "sigma_scale": float(sigma_scale),
                "accuracy_floor": float(accuracy_floor),
            }
        return self.pareto_

    # -- Monte-Carlo variation ---------------------------------------------------

    def monte_carlo_machine(self, n_variants: int, key,
                            sigma_scale: float = 1.0) -> MonteCarloMachine:
        """The variant machine of this estimator's candidates:
        ``pair_bits(x) -> (V, n, P, 2)``, variant 0 nominal.  Cached per
        ``(n_variants, key, sigma_scale)``."""
        self._check_fitted()
        cache_key = (int(n_variants), _key_data(key).tobytes(),
                     float(sigma_scale))
        if cache_key not in self._mc_machines:
            self._mc_machines[cache_key] = compile_variants(
                self._candidates(), self.n_classes_, key=key,
                n_variants=n_variants, sigma_scale=sigma_scale,
                device=self.device)
        return self._mc_machines[cache_key]

    def stream_machine(self, key, method: str = "iid",
                       mc_chunk: int = MC_STREAM_CHUNK,
                       sigma_scale: float = 1.0,
                       is_scale: float = 2.0) -> StreamingMCMachine:
        """The flat-memory streaming MC engine of this estimator's
        candidates, cached per sampling config."""
        self._check_fitted()
        cache_key = (_key_data(key).tobytes(), str(method), int(mc_chunk),
                     float(sigma_scale), float(is_scale))
        if cache_key not in self._stream_machines:
            self._stream_machines[cache_key] = compile_mc_stream(
                self._candidates(), self.n_classes_, key=key,
                method=method, mc_chunk=mc_chunk, sigma_scale=sigma_scale,
                is_scale=is_scale, device=self.device)
        return self._stream_machines[cache_key]

    def monte_carlo(
        self,
        x: np.ndarray,
        y: np.ndarray,
        n_variants: int = 64,
        key=None,
        sigma_scale: float = 1.0,
        assignment: Optional[list] = None,
        method: Optional[str] = None,
        mc_chunk: Optional[int] = None,
        accuracy_floor: Optional[float] = None,
        is_scale: float = 2.0,
        confidence: float = 0.95,
        ci: str = "wilson",
        mesh=None,
    ):
        """Accuracy of ONE deployed assignment under sampled process
        variation (default: ``assignment_`` if set, else the Algorithm-1
        kernel map; ``key`` default ``self.seed``).

        Dense engine (default for small ``n_variants``): every variant's
        pair bits at once, a :class:`MonteCarloResult` with the ``(V,)``
        accuracies (variant 0 nominal).  Streaming engine (``method=`` /
        ``mc_chunk=`` given, or ``n_variants`` above
        :data:`STREAM_AUTO_VARIANTS`): chunks of ``mc_chunk`` variants
        folded into fixed-size accumulators, a :class:`StreamingMCResult`
        with yield bounds against ``accuracy_floor`` (default two points
        below the nominal circuit accuracy).  ``mesh`` (from
        :func:`repro_torch.launch.mesh.make_variant_mesh`) shards each
        chunk's variants across its devices (streaming engine).
        """
        self._check_fitted()
        if key is None:
            key = self.seed
        if assignment is None:
            assignment = self.assignment_ or self.kernel_map_
        kmap = _kernel_map(assignment)
        a = dse_mod.assignment_from_kernel_map(kmap)
        streaming = (method is not None or mc_chunk is not None
                     or mesh is not None
                     or int(n_variants) > STREAM_AUTO_VARIANTS)
        if not streaming:
            machine = self.monte_carlo_machine(n_variants, key,
                                               sigma_scale=sigma_scale)
            bits3 = machine.pair_bits(np.asarray(x))
            acc = dse_mod.assignment_accuracies_mc(
                bits3, a[None, :], np.asarray(y), self.n_classes_,
                device=self.device)[:, 0]
            return MonteCarloResult(
                accuracy=acc, assignment=kmap, n_variants=int(n_variants),
                sigma_scale=float(sigma_scale),
                key_data=np.asarray(machine.key_data).tolist())
        else:
            if accuracy_floor is None:
                accuracy_floor = self.score(x, y, target="circuit") - 0.02
            sm = self.stream_machine(
                key, method=method or "iid",
                mc_chunk=MC_STREAM_CHUNK if mc_chunk is None else mc_chunk,
                sigma_scale=sigma_scale, is_scale=is_scale)
        out = sm.stream(np.asarray(x), np.asarray(y), a[None, :],
                        n_variants=int(n_variants),
                        accuracy_floor=float(accuracy_floor),
                        mesh=mesh, confidence=confidence, ci=ci)
        return StreamingMCResult(
            mean=float(out["mean"][0]), std=float(out["std"][0]),
            worst=float(out["worst"][0]), best=float(out["best"][0]),
            yield_=float(out["yield"][0]),
            yield_lo=float(out["yield_lo"][0]),
            yield_hi=float(out["yield_hi"][0]),
            n_eff=float(out["n_eff"]),
            accuracy_floor=float(accuracy_floor),
            confidence=float(confidence), ci=str(out["ci"]),
            n_variants=int(n_variants), method=sm.method,
            sigma_scale=float(sigma_scale), is_scale=float(is_scale),
            assignment=kmap, key_data=np.asarray(sm.key_data).tolist(),
            hist=np.asarray(out["hist"][0]))

    def deploy_assignment(self, assignment: Optional[list] = None,
                          decider: str = "votes") -> CompiledMachine:
        """Compile the machine of an explicit per-pair kernel assignment
        (default: ``assignment_`` of a budgeted deploy), cached per
        assignment and decider."""
        self._check_fitted()
        if assignment is None:
            assignment = self.assignment_
        if assignment is None:
            raise RuntimeError(
                "no assignment chosen yet: pass one explicitly or deploy "
                "with a budget after est.pareto(...)")
        kmap = _kernel_map(assignment)
        key = "assignment:" + "".join("r" if k == "rbf" else "l"
                                      for k in kmap)
        if decider != "votes":
            key += f"@{decider}"
        if key not in self._compiled:
            self._compiled[key] = compile_machine(
                self._assignment_bank(kmap), decider=decider,
                device=self.device)
        return self._compiled[key]

    def _assignment_bank(self, kmap: list[str]) -> MulticlassSVM:
        if len(kmap) != len(self.pairs_):
            raise ValueError(
                f"assignment has {len(kmap)} pairs, machine has "
                f"{len(self.pairs_)}")
        classifiers = [c[1] if k == "rbf" else c[0]
                       for c, k in zip(self._candidates(), kmap)]
        return MulticlassSVM(n_classes=self.n_classes_,
                             classifiers=classifiers, kernel_map=kmap)

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
            "assignment": self.assignment_,
            "monte_carlo": self.mc_state_,
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
    assignment = meta.get("assignment")
    est.assignment_ = list(assignment) if assignment else None
    mc = meta.get("monte_carlo")
    est.mc_state_ = dict(mc) if mc else None
    est._build()
    return est
