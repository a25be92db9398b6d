"""repro_torch — the PyTorch/CUDA port of ``repro`` for an NVIDIA H100.

A second package beside the JAX reference ``repro``, which stays unchanged
and is what this port is tested against.  It imports ``torch`` and
``numpy``, never ``jax`` and nothing of ``repro``.  Every module of
``repro`` has a twin here, at the same relative path: the paper's
Algorithm 1 end to end (``data.datasets.load`` ->
``api.MixedKernelSVM.fit`` -> ``deploy(target)`` -> ``predict`` ->
``score`` and ``core.hwcost.system_cost``), its design space,
Monte-Carlo yield and fleet serving, and the LM substrate's serving,
training and distribution.

  repro_torch.api      MixedKernelSVM, CompiledMachine, compile_machine, fleets
  repro_torch.core     SVM solver, analog model, OvO, trainer, cost model,
                       design space, Monte-Carlo, mixed-precision domains
  repro_torch.data     the paper's datasets (byte-identical copies), tokens
  repro_torch.kernels  hand-written CUDA kernels K1-K4, K3-bwd, K4-bwd +
                       plain versions
  repro_torch.models   the LM families (serving and training forward)
  repro_torch.serving  the SVM fleet engine, LM prefill / decode
  repro_torch.training AdamW (8-bit moments) and the train step (mesh leg)
  repro_torch.checkpoint  atomic checkpoints in the reference's layout
  repro_torch.distributed partition rules, compressed all-reduce, pipeline,
                       elastic resharding (single-process meshes)
  repro_torch.launch   meshes, step builders, the dry run, the CLIs
  repro_torch.analysis the static analyzer

Entry points take ``device=None``, meaning the card; pass ``device="cpu"``
to run the plain PyTorch versions.
"""

__version__ = "0.1.0"
