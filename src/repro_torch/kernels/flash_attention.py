"""K3: online-softmax GQA attention (causal / sliding window, ``q_offset``),
hand-written in CUDA C++ for Hopper (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention`` (body
``_flash_kernel``).  ``q (b, hq, sq, dh)`` against ``k, v (b, hkv, skv,
dh)``, ``dh`` in {32, 64, 96, 112, 128} -> ``(b, hq, sq, dh)`` in q's
dtype (96: phi-3-vision, 112: kimi-k2).  ``sq`` and ``skv`` may differ, as
in whisper's cross-attention (non-causal, ``skv`` any length).  The kv
head of q head h is ``h // (hq // hkv)``; kv blocks that no query row of a q
block can see are never loaded (O(S * W) for a window).

What bounds it on the card: at the prefill shapes, the 4 * dh flops per live
(query, key) pair, against the tensor-core peak.  The dtype picks the
kernel:

* bf16 (the served model): ``flash_wgmma_kernel``, on the tensor cores.
  TMA loads k / v tiles into a ring of shared-memory stages guarded by
  mbarriers; two consumer warpgroups of 64 query rows run ``wgmma`` for
  ``q k^T`` and ``p v`` with the online softmax on the accumulator
  fragments, p rounded to bf16 in registers.
* f32: ``flash_kernel``, IEEE f32 on the CUDA cores (no TF32).

For training, ``return_lse=True`` also returns each row's log-sum-exp of
the scaled logits, ``lse (b, hq, sq)`` in f32, which both kernels store in
their epilogue when given the pointer (serving passes none; in bf16 a
second instance of the tensor-core kernel stores it, launch variant 2 of
the plan query, so the serving instance is unchanged); the
backward (``flash_attention_bwd.py``, K3-bwd) reads it.  The gradient is
``ops.FlashAttention``, a ``torch.autograd.Function`` whose forward calls
this wrapper (or the plain version on the CPU) and whose backward calls
K3-bwd (or its plain twin); ``ops.flash_attention`` takes it whenever an
input requires a gradient.

Beside it: the plain version ``ref.flash_attention`` and the launch
counters: ``LAUNCHES`` counts every launch, ``LAUNCHES_TC`` and
``LAUNCHES_F32`` each variant.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.tracing import LaunchCounter

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 96, 112, 128)
#: TMA reads a tile from a 16-byte aligned base address.
TMA_ALIGN = 16

LAUNCHES = LaunchCounter("flash_attention")
LAUNCHES_TC = LaunchCounter("flash_attention_bf16_wgmma")
LAUNCHES_F32 = LaunchCounter("flash_attention_f32_cuda_cores")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int | None = None,
                         q_offset: int = 0, return_lse: bool = False):
    """Launch K3 on the current stream: the tensor-core kernel for bf16,
    the CUDA-core kernel for f32; anything else raises.  Returns the output,
    and with ``return_lse`` the pair ``(out, lse)``."""
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
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % TMA_ALIGN:
                raise ValueError(
                    f"{name} starts at an address that is not {TMA_ALIGN} B "
                    "aligned, which TMA needs; pass an aligned tensor")
    build.check_tensor(q, "q", (b, hq, sq, dh), q.dtype)
    build.check_tensor(k, "k", (b, hkv, skv, dh), q.dtype)
    build.check_tensor(v, "v", (b, hkv, skv, dh), q.dtype)
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = build.library("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.k3_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), DTYPES[q.dtype], b, hq,
            hkv, sq, skv, dh, int(causal),
            -1 if window is None else int(window), int(q_offset), stream)
    build.check(lib, "k3", rc)
    variant = 2 if lse is not None and q.dtype == torch.bfloat16 \
        else DTYPES[q.dtype]
    LAUNCHES.launched((variant, b, hq, hkv, sq, skv, dh))
    (LAUNCHES_TC if q.dtype == torch.bfloat16 else LAUNCHES_F32).count += 1
    return out if lse is None else (out, lse)
