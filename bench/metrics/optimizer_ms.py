"""``optimizer_ms.<kind>`` (ms per step): the busy device time of the
operations launched inside the program's ``train.optimizer`` spans, the
gradients' average and clip, the AdamW leaves and the gradient reset
(``bench/harness/spans.py``); none where the program marks no such span."""
from __future__ import annotations

from bench.harness.spans import phase_ms


def read(ctx):
    return phase_ms(ctx, "train.optimizer")
