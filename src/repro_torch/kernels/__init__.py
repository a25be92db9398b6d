"""Hand-written Hopper kernels for the SVM hot spots (+ plain versions).

  rbf.py     K1: tiled RBF / sech2 kernel matrix of a bank (CUDA C++)
  solver.py  K2: fused dual-coordinate-ascent solver over lanes (CUDA C++)
  csrc/      the CUDA sources; tiles.cuh holds the shared tile bodies
  build.py   nvcc build at first use, ctypes binding
  ops.py     device dispatch: CUDA tensor -> kernel, CPU tensor -> plain
  ref.py     plain PyTorch versions (ground truth for tests)
"""
from repro_torch.kernels import ops, ref  # noqa: F401
