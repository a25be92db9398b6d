"""repro_torch — the PyTorch/CUDA port of ``repro`` for an NVIDIA H100.

A second package beside the JAX reference ``repro``, which stays unchanged
and is what this port is tested against.  It imports ``torch`` and
``numpy``, never ``jax`` and nothing of ``repro``.  This slice carries the
paper's Algorithm 1 end to end: ``data.datasets.load`` ->
``api.MixedKernelSVM.fit`` -> ``deploy(target)`` -> ``predict`` ->
``score`` and ``core.hwcost.system_cost``.

  repro_torch.api      MixedKernelSVM, CompiledMachine, compile_machine
  repro_torch.core     SVM solver, analog model, OvO, trainer, cost model
  repro_torch.data     the paper's datasets (byte-identical copies)
  repro_torch.kernels  hand-written CUDA kernels K1-K4, K3-bwd + plain versions
  repro_torch.models   the LM families (serving and training forward)
  repro_torch.training AdamW (8-bit moments) and the train step
  repro_torch.checkpoint  atomic checkpoints in the reference's layout

Entry points take ``device=None``, meaning the card; pass ``device="cpu"``
to run the plain PyTorch versions.
"""

__version__ = "0.1.0"
