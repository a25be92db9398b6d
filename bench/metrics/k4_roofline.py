"""``k4_roofline.<kind>`` (%): the SSD scan's least time on the chip over
the device time of K4's kernels (``csrc/ssd.cu``).

One call's operations are the chunked scan's f32 operations over the
causal half (``work.ssd_ops``, C B^T once per group) as f32-accurate
products on the tensor cores, three TF32 products each (a third of 495
TFLOP/s), as K4-bwd is bounded; its bytes x, a, B, C read and y and the
final state written once, in f32.  The work is one scan per SSM layer
per pass: a training step's remat recompute runs K4 again and is time,
not work."""
from __future__ import annotations

from bench.harness.peaks import bound_s
from bench.harness.work import ssd_dims, ssd_ops


def call_bound_s(b: int, s: int, nh: int, dh: int, ds: int, g: int,
                 peaks: dict) -> float:
    x = b * s * nh * dh
    n_bytes = 4 * (2 * x + b * s * nh + 2 * b * s * g * ds + b * nh * dh * ds)
    return bound_s(n_bytes, ssd_ops(b, s, nh, dh, ds, g), peaks["f32_tc"],
                   peaks)


PREFIXES = ("ssd_chunk_state_kernel", "ssd_state_pass_kernel",
            "ssd_chunk_scan_kernel")


def read(ctx):
    dims = ssd_dims(ctx.config)
    t = ctx.trace.prefix_seconds(PREFIXES) if ctx.trace else 0.0
    if dims is None or t <= 0 or ctx.peaks is None:
        return None
    nh, dh, ds, g = dims
    bound = ctx.config["n_layers"] * sum(
        call_bound_s(p.b, p.s, nh, dh, ds, g, ctx.peaks) for p in ctx.traced)
    return 100.0 * bound / t
