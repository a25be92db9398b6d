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
"""
from repro_torch.api.compiled import (
    CompiledMachine,
    compile_machine,
    machine_from_arrays,
)
from repro_torch.api.estimator import MixedKernelSVM, estimator_from_arrays
from repro_torch.core.analog import CircuitParams
from repro_torch.core.trainer import PaddedPairs, PairResult, pad_pairs, train_pairs

__all__ = [
    "CircuitParams", "CompiledMachine", "MixedKernelSVM", "PaddedPairs",
    "PairResult", "compile_machine", "estimator_from_arrays",
    "machine_from_arrays", "pad_pairs", "train_pairs",
]
