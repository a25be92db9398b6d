"""``k4bwd_roofline.train`` (%): the SSD scan's gradient's least time on
the chip over the device time of K4-bwd's kernels (``csrc/ssd_bwd.cu``).

One call's operations are ``work.ssd_bwd_ops`` (G, dB and dC once per
group) as f32-accurate products on the tensor cores, three TF32 products
each (a third of 495 TFLOP/s); its bytes x, dy and dx, a and da, B, C, dB
and dC, the forward's chunk states and the final state and its gradient,
each once, in f32.  The work is one backward per SSM layer per training
pass."""
from __future__ import annotations

from bench.harness.peaks import bound_s
from bench.harness.work import SSD_CHUNK, ssd_bwd_ops, ssd_dims

PREFIXES = ("ssd_bwd_",)


def call_bound_s(b: int, s: int, nh: int, dh: int, ds: int, g: int,
                 peaks: dict) -> float:
    x = b * s * nh * dh
    chunks = -(-s // SSD_CHUNK)
    n_bytes = 4 * (3 * x + 2 * b * nh * s + 4 * b * s * g * ds
                   + b * nh * chunks * dh * ds + 2 * b * nh * dh * ds)
    return bound_s(n_bytes, ssd_bwd_ops(b, s, nh, dh, ds, g),
                   peaks["f32_tc"], peaks)


def read(ctx):
    dims = ssd_dims(ctx.config)
    t = ctx.trace.prefix_seconds(PREFIXES) if ctx.trace else 0.0
    if dims is None or t <= 0 or ctx.peaks is None:
        return None
    nh, dh, ds, g = dims
    bound = ctx.config["n_layers"] * sum(
        call_bound_s(p.b, p.s, nh, dh, ds, g, ctx.peaks)
        for p in ctx.traced if p.backward)
    return 100.0 * bound / t
