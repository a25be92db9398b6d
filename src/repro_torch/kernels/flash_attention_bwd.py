"""K3-bwd: the gradient of K3 in q, k and v, hand-written in CUDA C++ for
Hopper (``csrc/flash_attention_bwd.cu``).

Replaces no TPU kernel: the reference trains through its jnp attention
(``repro/models/attention.py``) and wraps no Pallas kernel in a
``custom_vjp``.  The port's training path runs K3 on the card, and a kernel
launched through ``ctypes`` has no gradient of its own, so
``ops.FlashAttention`` calls this from its backward.

``q (b, hq, sq, dh)``, ``k, v (b, hkv, skv, dh)``, the forward's output
``o`` and row log-sum-exp ``lse (b, hq, sq)`` (f32), and ``do`` like ``o``
-> ``(dq, dk, dv)`` in the inputs' dtype (f32 or bf16), ``dh`` in {32, 64},
with the forward's masks (causal, window, ``q_offset``, ``sq != skv``).

What bounds it on the card: 10 dh operations per visible (query, key)
pair and q head.  This first kernel computes them in f32 on the CUDA cores
in three launches (``D = rowsum(dO * O)``, then dK / dV per kv block over
the group's q heads, then dQ per q block), with no atomics, so two calls
on the same inputs agree bit for bit.

Beside it: the plain twin ``ref.flash_attention_bwd`` and the launch
counter ``LAUNCHES`` (one per call; three device launches).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPES

HEAD_DIMS = (32, 64)

#: ``fault`` codes of the C entry point, planted only by the checks that
#: must catch them: every q block drops its last visible kv block.
FAULT_DROP_LAST_KV_BLOCK = 1

LAUNCHES = build.LaunchCounter("flash_attention_bwd")


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor,
                             causal: bool = True, window: int | None = None,
                             q_offset: int = 0, fault: int = 0
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Launch K3-bwd on the current stream -> ``(dq, dk, dv)``."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"no flash attention backward kernel for {q.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"the flash attention backward kernel takes head "
                         f"dims {HEAD_DIMS}, not {dh} (ROADMAP.md A12)")
    if hkv <= 0 or hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    for name, t, shape in (("q", q, (b, hq, sq, dh)), ("o", o, q.shape),
                           ("do", do, q.shape), ("k", k, (b, hkv, skv, dh)),
                           ("v", v, k.shape)):
        build.check_tensor(t, name, tuple(shape), q.dtype)
    build.check_tensor(lse, "lse", (b, hq, sq), torch.float32)
    if any(t.device != q.device for t in (k, v, o, lse, do)):
        raise ValueError("the backward's inputs must be on one device")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dd = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    lib = build.library("flash_attention_bwd")
    rc = build.launch(
        lib.k3b_flash_attention_bwd, q.device, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dd.data_ptr(),
        DTYPES[q.dtype], b, hq, hkv, sq, skv, dh, int(causal),
        -1 if window is None else int(window), int(q_offset), int(fault))
    build.check(lib, "k3b", rc)
    LAUNCHES.launched((DTYPES[q.dtype], b, hq, hkv, sq, skv, dh))
    return dq, dk, dv
