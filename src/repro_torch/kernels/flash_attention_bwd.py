"""K3-bwd: the gradient of K3 in q, k and v, hand-written in CUDA C++ for
Hopper (``csrc/flash_attention_bwd.cu``).

Replaces no TPU kernel: the reference trains through its jnp attention
(``repro/models/attention.py``) and wraps no Pallas kernel in a
``custom_vjp``.  The port's training path runs K3 on the card, and a kernel
launched through ``ctypes`` has no gradient of its own, so
``ops.FlashAttention`` calls this from its backward.

``q (b, hq, sq, dh)``, ``k, v (b, hkv, skv, dh)``, the forward's output
``o`` and row log-sum-exp ``lse (b, hq, sq)`` (f32), and ``do`` like ``o``
-> ``(dq, dk, dv)`` in the inputs' dtype (f32 or bf16), ``dh`` in {32, 64,
96, 112, 128} (96: phi-3-vision, 112: kimi-k2, 128: starcoder2,
command-r, qwen2.5, granite-20b), with the forward's masks (causal,
window, ``q_offset``, ``sq != skv``).

What bounds it on the card: 10 dh operations per visible (query, key)
pair and q head, against the bf16 tensor-core peak.  Three device
launches per call (four with a split group, below), no atomics, so two
calls on the same inputs agree bit for bit.  The dtype picks the
kernels:

* bf16 (training): the tensor-core design.  A pre-pass writes D =
  rowsum(dO * O) and lse * log2(e) per 64-row q block; the dK / dV kernel
  (a CTA per 128 keys, two consumer warpgroups and a producer warpgroup
  that streams q / dO tiles by TMA) and the dQ kernel (a CTA per 128
  query rows, k / v streamed) run every product on ``wgmma``.  dQ in its
  own pass recomputes S and dP, so the kernels do 14 dh operations per
  pair: their ceiling is 10/14 of the bound.  Where the kv heads' blocks
  would not fill the card (MQA: one kv head), the group's q heads are
  split over more CTAs, and a fourth launch adds their partial dK / dV in
  a fixed order.
* f32: IEEE f32 on the CUDA cores, D, then dK / dV per kv block over the
  group's q heads, then dQ per q block.

Beside it: the plain twin ``ref.flash_attention_bwd`` and the launch
counters: ``LAUNCHES`` counts every call, ``LAUNCHES_TC`` and
``LAUNCHES_F32`` each dtype's kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPES, TMA_ALIGN
from repro_torch.tracing import LaunchCounter

HEAD_DIMS = (32, 64, 96, 112, 128)

#: ``fault`` codes of the C entry point, planted only by the checks that
#: must catch them: every q block drops its last visible kv block.
FAULT_DROP_LAST_KV_BLOCK = 1

LAUNCHES = LaunchCounter("flash_attention_bwd")
LAUNCHES_TC = LaunchCounter("flash_attention_bwd_bf16_wgmma")
LAUNCHES_F32 = LaunchCounter("flash_attention_bwd_f32_cuda_cores")


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor,
                             causal: bool = True, window: int | None = None,
                             q_offset: int = 0, fault: int = 0
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Launch K3-bwd on the current stream -> ``(dq, dk, dv)``: the
    tensor-core kernels for bf16, the CUDA-core kernels for f32; any other
    dtype or head dim raises."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"no flash attention backward kernel for {q.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"the flash attention backward kernel takes head "
                         f"dims {HEAD_DIMS}, not {dh}")
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
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
            if t.data_ptr() % TMA_ALIGN:
                raise ValueError(
                    f"{name} starts at an address that is not {TMA_ALIGN} B "
                    "aligned, which TMA needs; pass an aligned tensor")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = build.library("flash_attention_bwd")
    # D (f32), or the bf16 kernels' padded lse / D blocks and the split
    # group's partial dK / dV: the library says how many floats.
    dd = torch.empty(lib.k3b_scratch_floats(DTYPES[q.dtype], b, hq, hkv, sq,
                                            skv, dh),
                     dtype=torch.float32, device=q.device)
    rc = build.launch(
        lib.k3b_flash_attention_bwd, q.device, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dd.data_ptr(),
        DTYPES[q.dtype], b, hq, hkv, sq, skv, dh, int(causal),
        -1 if window is None else int(window), int(q_offset), int(fault))
    build.check(lib, "k3b", rc)
    LAUNCHES.launched((DTYPES[q.dtype], b, hq, hkv, sq, skv, dh))
    (LAUNCHES_TC if q.dtype == torch.bfloat16 else LAUNCHES_F32).count += 1
    return dq, dk, dv
