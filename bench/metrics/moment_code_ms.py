"""``moment_code_ms.<kind>`` (ms per step): the busy device time of the
operations launched inside the program's ``optimizer.moments`` spans, the
decode and encode of AdamW's 8-bit moments (``training/optimizer.py``,
``Quant8``), chunk by chunk of every leaf (``bench/harness/
named_spans.py``).  None where the program marks no such span: f32
moments mark none."""
from __future__ import annotations

from bench.harness.named_spans import span_ms


def read(ctx):
    return span_ms(ctx, "optimizer.moments")
