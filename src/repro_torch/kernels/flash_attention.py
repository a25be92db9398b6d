"""K3: online-softmax GQA attention (causal / sliding window, ``q_offset``),
hand-written in CUDA C++ for Hopper (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention`` (body
``_flash_kernel``).  ``q (b, hq, sq, dh)`` against ``k, v (b, hkv, skv,
dh)``, f32 or bf16, ``dh`` in {32, 64, 128} -> ``(b, hq, sq, dh)`` in q's
dtype.  The kv head of q head h is ``h // (hq // hkv)``; kv blocks that no
query row of a q block can see are skipped (O(S * W) for a window).

What bounds it on the card: at the prefill shapes, the 4 * dh flops per live
(query, key) pair, against the tensor-core peak; this first kernel runs on
the CUDA cores in IEEE f32 (one block of 256 threads per 64 query rows,
tiles in shared memory).

Beside it: the plain version ``ref.flash_attention`` and the launch counter
``LAUNCHES``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)

LAUNCHES = build.LaunchCounter("flash_attention")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int | None = None,
                         q_offset: int = 0) -> torch.Tensor:
    """Launch K3 on the current stream."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"no flash attention kernel for {q.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    if hkv <= 0 or hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    build.check_tensor(q, "q", (b, hq, sq, dh), q.dtype)
    build.check_tensor(k, "k", (b, hkv, skv, dh), q.dtype)
    build.check_tensor(v, "v", (b, hkv, skv, dh), q.dtype)
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    out = torch.empty_like(q)
    lib = build.library("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.k3_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPES[q.dtype], b, hq, hkv, sq, skv, dh, int(causal),
            -1 if window is None else int(window), int(q_offset), stream)
    build.check(lib, "k3", rc)
    LAUNCHES.count += 1
    return out
