"""``k3_roofline.<kind>`` (%): the attention forward's least time on the
chip over the device time of K3's kernels (``csrc/flash_attention.cu``).

The least time of one call is the larger of its operations, 4 dh per live
(query, key) pair per query head (q k^T and p v, the causal half, the
layer's window), over the tensor-core peak of its dtype, and its bytes,
q, k, v read and the output written once, over HBM's rate.  The work is
one forward per attention layer per pass, whatever kernel computes it: a
training step's remat recompute runs K3 again and is time, not work.
"""
from __future__ import annotations

from bench.harness.peaks import bound_s
from bench.harness.work import layer_windows, live_pairs

PREFIXES = ("flash_wgmma_kernel", "flash_kernel")


def call_bound_s(b: int, hq: int, hkv: int, sq: int, skv: int, dh: int,
                 window, elt: int, peaks: dict, causal: bool = True) -> float:
    ops = 4 * dh * live_pairs(sq, skv, causal, window) * b * hq
    n_bytes = elt * (2 * b * hq * sq * dh + 2 * b * hkv * skv * dh)
    return bound_s(n_bytes, ops, peaks["bf16" if elt == 2 else "f32"], peaks)


def elt_bytes(cfg: dict) -> int:
    return 2 if cfg["dtype"] == "bfloat16" else 4


def read(ctx):
    t = ctx.trace.prefix_seconds(PREFIXES) if ctx.trace else 0.0
    if t <= 0 or ctx.peaks is None:
        return None
    cfg = ctx.config
    bound = sum(call_bound_s(p.b, cfg["n_heads"], cfg["n_kv_heads"], p.s,
                             p.s, cfg["d_head"], w, elt_bytes(cfg),
                             ctx.peaks)
                for p in ctx.traced for w in layer_windows(cfg))
    return 100.0 * bound / t
