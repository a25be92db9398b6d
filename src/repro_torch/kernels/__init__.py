"""Hand-written Hopper kernels (+ plain versions).

  rbf.py              K1: tiled RBF / sech2 kernel matrix of a bank (CUDA C++)
  solver.py           K2: fused dual-coordinate-ascent solver over lanes (CUDA C++)
  flash_attention.py  K3: online-softmax GQA attention (CUDA C++)
  flash_attention_bwd.py  K3-bwd: K3's gradient in q, k, v (CUDA C++)
  ssd.py              K4: chunked Mamba2 SSD scan (CUDA C++)
  csrc/               the CUDA sources; tiles.cuh holds the shared tile bodies
  build.py            nvcc build at first use, ctypes binding
  ops.py              device dispatch: CUDA tensor -> kernel, CPU tensor -> plain
  ref.py              plain PyTorch versions (ground truth for tests)
"""
from repro_torch.kernels import ops, ref  # noqa: F401
