"""``device_idle.<kind>`` (%): the share of the traced sub-window in which
no operation ran on the card (kernels, copies and sets of every stream
merged), from ``torch.profiler``'s CUDA activity."""
from __future__ import annotations


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
