"""``ssm_mixer_ms.<kind>`` (ms per step): the busy device time of the
operations launched inside the program's ``ssm.mixer`` spans, the Mamba2
mixer of ``models/ssm.py`` (in_proj, the conv, K4, the gated norm,
out_proj) in the forward and, under remat, in the backward's recompute
(``bench/harness/named_spans.py``); the mixer's own backward is not in
it.  None where the program marks no such span."""
from __future__ import annotations

from bench.harness.named_spans import span_ms


def read(ctx):
    return span_ms(ctx, "ssm.mixer")
