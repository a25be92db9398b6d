"""``k3bwd_roofline.train`` (%): the attention backward's least time on the
chip over the device time of K3-bwd's kernels
(``csrc/flash_attention_bwd.cu``).

One call's operations are 10 dh per live pair per query head (p again,
dp, dv, dq, dk), against the tensor-core peak of its dtype; its bytes q,
k, v, o and do read, dq, dk, dv written once, and the f32 row
log-sum-exp read.  The work is one backward per attention layer per
training pass."""
from __future__ import annotations

from bench.harness.peaks import bound_s
from bench.harness.work import layer_windows, live_pairs
from bench.metrics.k3_roofline import elt_bytes

PREFIXES = ("bwd_prep_kernel", "bwd_dkv_wgmma_kernel", "bwd_dq_wgmma_kernel",
            "bwd_dkv_sum_kernel", "bwd_dot_kernel", "bwd_dkv_kernel",
            "bwd_dq_kernel")


def call_bound_s(b: int, hq: int, hkv: int, sq: int, skv: int, dh: int,
                 window, elt: int, peaks: dict, causal: bool = True,
                 q_offset: int = 0) -> float:
    ops = 10 * dh * live_pairs(sq, skv, causal, window, q_offset) * b * hq
    q, k = b * hq * sq * dh, b * hkv * skv * dh
    n_bytes = elt * 2 * (3 * q + 2 * k) + 4 * b * hq * sq
    return bound_s(n_bytes, ops, peaks["bf16" if elt == 2 else "f32"], peaks)


def read(ctx):
    t = ctx.trace.prefix_seconds(PREFIXES) if ctx.trace else 0.0
    if t <= 0 or ctx.peaks is None:
        return None
    cfg = ctx.config
    bound = sum(call_bound_s(p.b, cfg["n_heads"], cfg["n_kv_heads"], p.s,
                             p.s, cfg["d_head"], w, elt_bytes(cfg),
                             ctx.peaks)
                for p in ctx.traced if p.backward
                for w in layer_windows(cfg))
    return 100.0 * bound / t
