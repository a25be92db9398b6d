"""repro_torch.api — the estimator + compiled-machine API of the port.

* :class:`MixedKernelSVM` — ``fit`` runs the paper's Algorithm 1 with
  hardware-in-the-loop co-optimization, ``deploy(target)`` lowers any
  Table-II design point, ``save``/``load`` read and write the reference's
  format.
* :class:`CompiledMachine` — a bank of OvO bit-classifiers lowered by
  :func:`compile_machine` into padded, stacked tensors with one batched
  ``predict``: linear pairs in one matmul, RBF/sech2 pairs through the
  kernel-matrix hand kernel, analog pairs through the calibrated
  measured-curve kernel, and the packed decision encoder.

The kernel-assignment design space is exposed through
:meth:`MixedKernelSVM.pareto` and budgeted ``deploy``, with the building
blocks re-exported: :func:`compile_candidates` / :class:`CandidateMachine`
(the ``(n, P, 2)`` pair-bit tensor) and :class:`DesignSpace` /
:class:`SweepResult`.  Process variation rides the same lowering:
:func:`compile_variants` / :class:`MonteCarloMachine` (``(V, n, P, 2)``,
variant 0 nominal) and the flat-memory :func:`compile_mc_stream` /
:class:`StreamingMCMachine`; :meth:`MixedKernelSVM.monte_carlo` returns a
:class:`MonteCarloResult` or :class:`StreamingMCResult`.

Serving: :func:`compile_fleet` co-batches compiled machines into one
:class:`FleetMachine` (one forward for rows of any mix of members, each
member's scores bit for bit), and :class:`ShardedFleetForward` splits its
labels over a ``launch.mesh.make_serving_mesh`` mesh.
"""
from repro_torch.api.compiled import (
    CandidateMachine,
    CompiledMachine,
    MonteCarloMachine,
    StreamingMCMachine,
    compile_candidates,
    compile_machine,
    compile_mc_stream,
    compile_variants,
    machine_from_arrays,
)
from repro_torch.api.estimator import (
    MixedKernelSVM,
    MonteCarloResult,
    StreamingMCResult,
    estimator_from_arrays,
)
from repro_torch.api.fleet import (
    FleetMachine,
    ShardedFleetForward,
    compile_fleet,
)
from repro_torch.core.analog import CircuitParams, VariantSet
from repro_torch.core.dse import DesignSpace, SweepResult
from repro_torch.core.trainer import PaddedPairs, PairResult, pad_pairs, train_pairs

__all__ = [
    "CandidateMachine", "CircuitParams", "CompiledMachine", "DesignSpace",
    "FleetMachine", "MixedKernelSVM", "MonteCarloMachine", "MonteCarloResult",
    "PaddedPairs", "PairResult", "ShardedFleetForward", "StreamingMCMachine",
    "StreamingMCResult", "SweepResult", "VariantSet", "compile_candidates",
    "compile_fleet", "compile_machine",
    "compile_mc_stream", "compile_variants", "estimator_from_arrays",
    "machine_from_arrays", "pad_pairs", "train_pairs",
]
