"""``mfu.<kind>`` (%): the whole step's or request's share of the chip's
bf16 peak: the configuration's model FLOPs (``bench/configs/model_flops``:
three times the forward in training, no remat recompute and no padding)
of every pass the measured window completed, over the window's wall time,
against 989 TFLOP/s.  The card's power limit is printed beside it."""
from __future__ import annotations

from bench.configs.model_flops import model_flops


def read(ctx):
    if ctx.peaks is None or not ctx.window_units or ctx.window_s <= 0:
        return None
    flops = sum(model_flops(ctx.config, p) for p in ctx.window_units)
    return 100.0 * flops / ctx.window_s / ctx.peaks["bf16"]
